"""The port's numerics core against the JAX reference, elementwise in f64.

Each function of ``aiyagari_hark_tpu_torch.ops`` (grids, Tauchen,
stationary distribution, interpolation, lottery location, utility), the
firm closed forms and the solver-health codes get the same inputs, made
with numpy from a fixed seed, as their JAX twins; values agree to
``atol=1e-13`` (f64 rounding of a handful of operations).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiyagari_hark_tpu import solver_health as jsh
from aiyagari_hark_tpu.models import firm as jfirm
from aiyagari_hark_tpu.ops import grids as jgrids
from aiyagari_hark_tpu.ops import interp as jinterp
from aiyagari_hark_tpu.ops import markov as jmarkov
from aiyagari_hark_tpu.ops import utility as jutil
from aiyagari_hark_tpu_torch import solver_health as tsh
from aiyagari_hark_tpu_torch.models import firm as tfirm
from aiyagari_hark_tpu_torch.ops import grids as tgrids
from aiyagari_hark_tpu_torch.ops import interp as tinterp
from aiyagari_hark_tpu_torch.ops import markov as tmarkov
from aiyagari_hark_tpu_torch.ops import utility as tutil

torch.set_num_threads(1)
ATOL = 1e-13
F64 = torch.float64


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


# -- grids -------------------------------------------------------------------

@pytest.mark.parametrize("args", [(0.001, 50.0, 32, 2), (0.001, 50.0, 499, 2),
                                  (0.01, 10.0, 7, 0), (0.5, 3.0, 12, 3)])
def test_grid_exp_mult_matches_jax(args):
    ref = jgrids.make_grid_exp_mult(*args)
    out = tgrids.make_grid_exp_mult(*args, dtype=F64)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("bad", [(0.0, 1.0, 5, 0), (-1.0, 1.0, 5, 2),
                                 (1.0, 1.0, 5, 2), (0.1, 1.0, 1, 2)])
def test_grid_exp_mult_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        jgrids.make_grid_exp_mult(*bad)
    with pytest.raises(ValueError):
        tgrids.make_grid_exp_mult(*bad, dtype=F64)


@pytest.mark.parametrize("borrow_limit", [0.0, -1.5])
def test_reference_asset_grids_match_jax(borrow_limit):
    ja, jd, jk = jgrids.build_asset_grids("reference", 0.001, 50.0, 24, 2,
                                          150, borrow_limit=borrow_limit)
    ta, td, tk = tgrids.build_asset_grids("reference", 0.001, 50.0, 24, 2,
                                          150, borrow_limit=borrow_limit,
                                          dtype=F64)
    assert jk is None and tk is None
    np.testing.assert_allclose(_np(ta), np.asarray(ja), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_np(td), np.asarray(jd), rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        _np(tgrids.make_asset_grid(0.001, 50.0, 32, dtype=F64)),
        np.asarray(jgrids.make_asset_grid(0.001, 50.0, 32)), rtol=0,
        atol=ATOL)


def test_compact_grids_name_their_roadmap_item():
    """The compact grids build (``tests/test_torch_fused.py`` holds them
    to the JAX points); the grid ladder that the JAX package runs on them
    outside the fused kernel is not ported and names its item."""
    from aiyagari_hark_tpu_torch.models import household as th

    a, d, knee = tgrids.build_asset_grids("compact", 0.001, 50.0, 24, 2,
                                          150, dtype=F64)
    assert knee is not None and len(a) < 24 and len(d) < 150
    model = th.build_simple_model(labor_states=3, a_count=12, dist_count=48,
                                  grid="compact", dtype=F64, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        th.solve_household(1.02, 1.0, model, 0.96, 2.0, grid="compact",
                           kernel="fused")


# -- Markov ------------------------------------------------------------------

@pytest.mark.parametrize("n,ar,sd", [(7, 0.0, 0.2), (7, 0.3, 0.2),
                                     (7, 0.9, 0.4), (3, 0.6, 0.2),
                                     (15, 0.6, 0.2)])
def test_tauchen_and_labor_states_match_jax(n, ar, sd):
    jt = jmarkov.tauchen_labor_process(n, ar, sd)
    tt = tmarkov.tauchen_labor_process(n, ar, sd, dtype=F64)
    np.testing.assert_allclose(_np(tt.grid), np.asarray(jt.grid), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(_np(tt.transition), np.asarray(jt.transition),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        _np(tmarkov.normalized_labor_states(tt.grid)),
        np.asarray(jmarkov.normalized_labor_states(jt.grid)), rtol=0,
        atol=ATOL)
    np.testing.assert_allclose(
        _np(tmarkov.stationary_distribution(tt.transition)),
        np.asarray(jmarkov.stationary_distribution(jt.transition)), rtol=0,
        atol=ATOL)


def test_tauchen_degenerate_chain_and_direct_call():
    one = tmarkov.tauchen_ar1(1, 0.1, 0.5, dtype=F64)
    assert one.grid.tolist() == [0.0] and one.transition.tolist() == [[1.0]]
    jt = jmarkov.tauchen_ar1(5, 0.13, 0.7, bound=2.5)
    tt = tmarkov.tauchen_ar1(5, 0.13, 0.7, bound=2.5, dtype=F64)
    np.testing.assert_allclose(_np(tt.transition), np.asarray(jt.transition),
                               rtol=0, atol=ATOL)


def test_stationary_distribution_of_a_random_chain():
    rng = np.random.default_rng(0)
    P = rng.random((6, 6)) + 0.05
    P /= P.sum(axis=1, keepdims=True)
    np.testing.assert_allclose(
        _np(tmarkov.stationary_distribution(_t(P))),
        np.asarray(jmarkov.stationary_distribution(jnp.asarray(P))), rtol=0,
        atol=ATOL)
    with pytest.raises(NotImplementedError, match="item 6"):
        tmarkov.stationary_distribution(_t(P), precision="mixed")


# -- interpolation -----------------------------------------------------------

def _knots(rng, rows, k):
    xp = np.cumsum(rng.random((rows, k)) + 0.01, axis=1) - 0.5
    fp = rng.standard_normal((rows, k))
    return xp, fp


def test_interp1d_matches_jax_inside_and_beyond_the_knots():
    rng = np.random.default_rng(1)
    xp, fp = _knots(rng, 1, 9)
    x = rng.uniform(-3.0, 8.0, size=(4, 25))
    x[0, :9] = xp[0]                       # exact knot hits
    ref = jinterp.interp1d(jnp.asarray(x), jnp.asarray(xp[0]),
                           jnp.asarray(fp[0]))
    out = tinterp.interp1d(_t(x), _t(xp[0]), _t(fp[0]))
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=ATOL)


def test_interp1d_rowwise_matches_jax():
    rng = np.random.default_rng(2)
    xp, fp = _knots(rng, 5, 13)
    x = rng.uniform(-2.0, 12.0, size=(5, 40))
    ref = jinterp.interp1d_rowwise(jnp.asarray(x), jnp.asarray(xp),
                                   jnp.asarray(fp))
    out = tinterp.interp1d_rowwise(_t(x), _t(xp), _t(fp))
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=ATOL)


def test_locate_in_grid_matches_jax_and_clips():
    rng = np.random.default_rng(3)
    grid = np.sort(rng.uniform(0.0, 10.0, 30))
    x = rng.uniform(-1.0, 11.0, size=(30, 7))
    x[0, 0], x[1, 1] = grid[0], grid[-1]
    ji, jw = jinterp.locate_in_grid(jnp.asarray(x), jnp.asarray(grid))
    ti, tw = tinterp.locate_in_grid(_t(x), _t(grid))
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=0, atol=ATOL)
    assert float(tw.min()) >= 0.0 and float(tw.max()) <= 1.0
    # one grid per row: the lane-batched form
    ti2, tw2 = tinterp.locate_in_grid(_t(x.T), _t(grid)[None].expand(7, 30))
    np.testing.assert_array_equal(_np(ti2), np.asarray(ji).T)
    np.testing.assert_allclose(_np(tw2), np.asarray(jw).T, rtol=0, atol=ATOL)


# -- utility and firm --------------------------------------------------------

@pytest.mark.parametrize("crra", [1.0, 2.0, 5.0])
def test_utility_family_matches_jax(crra):
    rng = np.random.default_rng(4)
    c = rng.uniform(0.05, 4.0, size=50)
    for jf, tf in ((jutil.crra_utility, tutil.crra_utility),
                   (jutil.marginal_utility, tutil.marginal_utility),
                   (jutil.inverse_marginal_utility,
                    tutil.inverse_marginal_utility)):
        np.testing.assert_allclose(_np(tf(_t(c), crra)),
                                   np.asarray(jf(jnp.asarray(c), crra)),
                                   rtol=1e-14, atol=ATOL)


def test_crra_utility_with_a_per_lane_crra():
    rng = np.random.default_rng(5)
    c = rng.uniform(0.05, 4.0, size=(3, 10))
    crra = np.array([[1.0], [3.0], [5.0]])
    ref = np.stack([np.asarray(jutil.crra_utility(jnp.asarray(c[i]),
                                                  float(crra[i, 0])))
                    for i in range(3)])
    out = tutil.crra_utility(_t(c), _t(crra))
    np.testing.assert_allclose(_np(out), ref, rtol=1e-14, atol=ATOL)


def test_firm_closed_forms_match_jax():
    r = np.linspace(-0.05, 0.04, 11)
    for args in ((0.36, 0.08), (0.3, 0.1)):
        kl_j = jfirm.k_to_l_from_r(jnp.asarray(r), *args)
        kl_t = tfirm.k_to_l_from_r(_t(r), *args)
        np.testing.assert_allclose(_np(kl_t), np.asarray(kl_j), rtol=1e-14)
        np.testing.assert_allclose(
            _np(tfirm.wage_rate(kl_t, args[0])),
            np.asarray(jfirm.wage_rate(kl_j, args[0])), rtol=1e-14)
        np.testing.assert_allclose(
            _np(tfirm.interest_factor(kl_t, *args)),
            np.asarray(jfirm.interest_factor(kl_j, *args)), rtol=1e-14)
        np.testing.assert_allclose(
            _np(tfirm.output(kl_t, 0.9, args[0])),
            np.asarray(jfirm.output(kl_j, 0.9, args[0])), rtol=1e-14)
        np.testing.assert_allclose(
            _np(tfirm.aggregate_resources(kl_t, 0.9, *args)),
            np.asarray(jfirm.aggregate_resources(kl_j, 0.9, *args)),
            rtol=1e-14)


# -- solver health -----------------------------------------------------------

def test_status_codes_and_names_match_jax():
    for name in ("CONVERGED", "STALLED", "MAX_ITER", "NONFINITE"):
        assert getattr(tsh, name) == getattr(jsh, name)
        assert tsh.status_name(getattr(tsh, name)) == name
    assert tsh.status_name(42) == "UNKNOWN(42)"


def test_classify_combine_and_failure_match_jax():
    diff = np.array([1e-9, 1e-3, 1e-3, np.nan, np.inf, 5e-7])
    it = np.array([10, 50, 100, 3, 4, 100])
    ref = jsh.classify_fixed_point_exit(jnp.asarray(diff), 1e-6,
                                        jnp.asarray(it), 100)
    out = tsh.classify_fixed_point_exit(_t(diff), 1e-6, torch.tensor(it),
                                        100)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(_np(out), np.asarray(ref))
    a, b = np.array([0, 1, 3, 2]), np.array([2, 0, 1, 2])
    np.testing.assert_array_equal(
        _np(tsh.combine_status(torch.tensor(a), torch.tensor(b), 1)),
        np.asarray(jsh.combine_status(jnp.asarray(a), jnp.asarray(b), 1)))
    np.testing.assert_array_equal(_np(tsh.is_failure(torch.tensor(a))),
                                  np.asarray(jsh.is_failure(a)))
