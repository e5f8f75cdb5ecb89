"""The fused path (``kernel="fused"``, reference and compact grids) against
the JAX package, and the repairs that came with it.

CPU, f64.  Models are carried across with ``carry.model_from_numpy``, so
both packages start from the same bits.  The JAX fused kernels run in
interpret mode, as ``tests/test_pallas_parity.py`` runs them; the port's
wrapper runs ``fused_cell_grid_plain`` for CPU tensors (the CUDA kernel is
held to that plain version on the card by ``chip_smoke.py``).

Tolerances: kernel level, step counts equal and knots and distribution
``rtol=1e-9, atol=1e-8`` (the JAX kernel-parity tolerance; the TPU kernel
mixes labor states inside its tiled matrix product, the port after the
lottery, the reference order).  Supply level: steps and statuses equal,
supply ``rtol=1e-9``.  Equilibrium level: trips, statuses and summed EGM
steps equal, summed distribution steps within ``DIST_STEPS_RTOL`` (the
pairwise Aitken sums, ``tests/test_torch_equilibrium.py``), r* within
``2 r_tol``, the JAX package's own fused budget
(``tests/test_kernel_policy.py``).  The compact grids equal the JAX
points bitwise; the tail functions agree elementwise to f64 rounding.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aiyagari_hark_tpu.models.equilibrium as je
import aiyagari_hark_tpu.models.household as jh
import aiyagari_hark_tpu_torch.models.equilibrium as te
import aiyagari_hark_tpu_torch.models.household as th
from aiyagari_hark_tpu.ops import grids as jgrids
from aiyagari_hark_tpu.ops import interp as jinterp
from aiyagari_hark_tpu.ops import utility as jutil
from aiyagari_hark_tpu.ops.pallas_kernels import (fused_cell_pallas,
                                                  fused_cell_pallas_grid)
from aiyagari_hark_tpu.utils import config as jconfig
from aiyagari_hark_tpu_torch.carry import model_from_numpy
from aiyagari_hark_tpu_torch.ops import grids as tgrids
from aiyagari_hark_tpu_torch.ops import interp as tinterp
from aiyagari_hark_tpu_torch.ops import kernels as K
from aiyagari_hark_tpu_torch.ops import utility as tutil
from aiyagari_hark_tpu_torch.parallel.sweep import run_table2_sweep
from aiyagari_hark_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)
F64 = torch.float64
TOL_KW = dict(rtol=1e-9, atol=1e-8)
SMALL = dict(labor_states=3, a_count=12, dist_count=48)
KW = dict(a_count=10, dist_count=32, labor_states=3, r_tol=1e-5,
          max_bisect=24)
CELLS = [(3.0, 0.3), (5.0, 0.6)]
DIST_STEPS_RTOL = 2e-3
# (R, W, crra) of the kernel-level lanes; beta 0.96, b 0
LANES = [(1.02, 1.0, 2.0), (1.03, 1.1, 3.0)]
DATA = os.path.join(os.path.dirname(__file__), "data")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _carry(jm):
    return model_from_numpy([np.asarray(f) for f in jm], device="cpu")


def _build(grid="reference", **kw):
    jm = jh.build_simple_model(grid=grid, **kw)
    return jm, _carry(jm)


@pytest.fixture(scope="module")
def small():
    return {g: _build(g, **SMALL) for g in ("reference", "compact")}


def _kernel_inputs(jm, tail, lanes):
    """Per lane: the JAX kernel's arguments as numpy arrays."""
    out = []
    for R, W, crra in lanes:
        p0 = jh.initial_policy(jm, analytic_tail=tail)
        h = (jh.perfect_foresight_human_wealth(jnp.asarray(R), jnp.asarray(W),
                                               jm.labor_levels,
                                               jm.transition)
             if tail else jnp.zeros_like(jm.labor_levels))
        out.append([np.asarray(x) for x in (
            p0.m_knots, p0.c_knots, jm.a_grid, jm.dist_grid, jm.labor_levels,
            jm.transition, jnp.asarray([R, W, 0.96, crra, 0.0]), h,
            jh.initial_distribution(jm))])
    return out


KERNEL_TOLS = (1e-6, 3000, 32, 1e-10, 5000, 64)


# -- kernel level ------------------------------------------------------------

@pytest.mark.parametrize("tail", [False, True])
def test_fused_plain_matches_single_lane_pallas(small, tail):
    jm, _ = small["compact" if tail else "reference"]
    args = _kernel_inputs(jm, tail, LANES[:1])[0]
    ref = fused_cell_pallas(*(jnp.asarray(a) for a in args), *KERNEL_TOLS,
                            tail=tail, interpret=True)
    out = K.fused_cell_grid_plain(*(torch.tensor(a)[None] for a in args),
                                  *KERNEL_TOLS, tail=tail)
    assert int(out[3][0]) == int(ref[3]) and int(out[5][0]) == int(ref[5])
    n, a = jm.labor_levels.shape[0], jm.a_grid.shape[0]
    assert tuple(out[0].shape[1:]) == (n, a + (3 if tail else 1))
    for x, y in zip(out[:3], ref[:3]):
        np.testing.assert_allclose(_np(x[0]), np.asarray(y), **TOL_KW)


@pytest.mark.parametrize("tail", [False, True])
def test_fused_plain_matches_pallas_lane_grid(small, tail):
    jm, _ = small["compact" if tail else "reference"]
    lanes = _kernel_inputs(jm, tail, LANES)
    stacked = [np.stack(f) for f in zip(*lanes)]
    ref = fused_cell_pallas_grid(*(jnp.asarray(a) for a in stacked),
                                 *KERNEL_TOLS, tail=tail, interpret=True)
    out = K.fused_cell_grid(*(torch.tensor(a) for a in stacked),
                            *KERNEL_TOLS, tail=tail)
    assert out[3].tolist() == np.asarray(ref[3]).tolist()
    assert out[5].tolist() == np.asarray(ref[5]).tolist()
    for x, y in zip(out[:3], ref[:3]):
        np.testing.assert_allclose(_np(x), np.asarray(y), **TOL_KW)


def test_fused_wrapper_validates_the_knot_count(small):
    args = [torch.tensor(a)[None]
            for a in _kernel_inputs(small["reference"][0], False, LANES)[0]]
    with pytest.raises(ValueError, match="do not agree"):
        K.fused_cell_grid(*args, 1e-6, tail=True)


# -- supply and equilibrium level --------------------------------------------

@pytest.mark.parametrize("grid", ["reference", "compact"])
def test_fused_supply_matches_jax(small, grid):
    jm, tm = small[grid]
    ref = je.household_capital_supply(0.03, jm, 0.96, 3.0, 0.36, 0.08,
                                      kernel="fused", grid=grid)
    out = te.household_capital_supply(torch.tensor(0.03, dtype=F64), tm,
                                      0.96, 3.0, 0.36, 0.08, kernel="fused",
                                      grid=grid)
    assert int(out.egm_iters) == int(ref.egm_iters)
    assert int(out.dist_iters) == int(ref.dist_iters)
    assert int(out.status) == int(ref.status) == 0
    assert float(out.supply) == pytest.approx(float(ref.supply), rel=1e-9)
    np.testing.assert_allclose(_np(out.policy.c_knots),
                               np.asarray(ref.policy.c_knots), **TOL_KW)


@pytest.fixture(scope="module", params=["reference", "compact"])
def lean_pair(request):
    """(grid, solver kwargs, the carried models, JAX fused lean per cell,
    the port's batched fused lean)."""
    grid = request.param
    kw = dict(KW)
    r_tol, max_bisect = kw.pop("r_tol"), kw.pop("max_bisect")
    models = [_build(grid, labor_ar=rho, **kw) for _, rho in CELLS]
    solve = dict(r_tol=r_tol, max_bisect=max_bisect, kernel="fused",
                 grid=grid)
    ref = [je.solve_equilibrium_lean(jm, 0.96, crra, 0.36, 0.08, **solve)
           for (crra, _), (jm, _) in zip(CELLS, models)]
    out = te.solve_equilibrium_lean(
        th.stack_models([tm for _, tm in models]), 0.96,
        torch.tensor([c for c, _ in CELLS], dtype=F64), 0.36, 0.08, **solve)
    return grid, solve, [tm for _, tm in models], ref, out


@pytest.mark.parametrize("cell", [0, 1])
def test_fused_lean_equilibrium_matches_jax(lean_pair, cell):
    _, _, _, ref, out = lean_pair
    ref = ref[cell]
    lane = type(out)(*(f[cell] for f in out))
    assert int(lane.status) == int(ref.status) == 0
    assert int(lane.bisect_iters) == int(ref.bisect_iters)
    assert int(lane.egm_iters) == int(ref.egm_iters)
    assert abs(int(lane.dist_iters) - int(ref.dist_iters)) <= (
        DIST_STEPS_RTOL * int(ref.dist_iters))
    assert abs(float(lane.r_star) - float(ref.r_star)) <= 2 * KW["r_tol"]


def test_fused_lanes_equal_single_cell_solves(lean_pair):
    _, solve, models, _, out = lean_pair
    one = te.solve_equilibrium_lean(models[1], 0.96, CELLS[1][0], 0.36, 0.08,
                                    **solve)
    for f, b in zip(one, out):
        assert torch.equal(f, b[1])


def test_fused_supply_matches_the_port_reference_path(small):
    """Same iteration code, so the same step counts and statuses; the
    values agree to rounding (the kernel order is the reference order)."""
    _, tm = small["reference"]
    r = torch.tensor(0.02, dtype=F64)
    ref = te.household_capital_supply(r, tm, 0.96, 2.0, 0.36, 0.08)
    fus = te.household_capital_supply(r, tm, 0.96, 2.0, 0.36, 0.08,
                                      kernel="fused")
    assert int(ref.egm_iters) == int(fus.egm_iters)
    assert int(ref.dist_iters) == int(fus.dist_iters)
    assert int(ref.status) == int(fus.status) == 0
    assert torch.equal(ref.policy.c_knots, fus.policy.c_knots)
    assert torch.equal(ref.distribution, fus.distribution)


def test_fused_full_equilibrium_objects_and_single_lane_entry():
    tiny = dict(labor_states=2, a_count=6, dist_count=20, r_tol=1e-7)
    ref = te.solve_calibration(3.0, 0.6, dtype=F64, device="cpu", **tiny)
    fus = te.solve_calibration(3.0, 0.6, dtype=F64, device="cpu",
                               kernel="fused", **tiny)
    assert int(fus.status) == 0
    assert int(fus.bisect_iters) == int(ref.bisect_iters)
    assert torch.equal(fus.r_star, ref.r_star)
    assert torch.equal(fus.distribution, ref.distribution)
    cmp = te.solve_calibration(3.0, 0.6, dtype=F64, device="cpu",
                               kernel="fused", grid="compact", **tiny)
    assert int(cmp.status) == 0
    assert tuple(cmp.policy.m_knots.shape) == (2, int(
        tgrids.grid_point_counts("compact", 6, 20)[0]) + 3)


# -- compact grids and the analytic tail -------------------------------------

@pytest.mark.parametrize("grid", ["compact", "adaptive"])
@pytest.mark.parametrize("a_count,dist_count,borrow_limit,tail", [
    (32, 500, 0.0, "analytic"), (24, 150, -1.5, "analytic"),
    (12, 48, 0.0, "anchors"), (1000, 1000, 0.0, "analytic")])
def test_compact_grids_equal_the_jax_points(grid, a_count, dist_count,
                                            borrow_limit, tail):
    ja, jd, jk = jgrids.build_asset_grids(grid, 0.001, 50.0, a_count, 2,
                                          dist_count,
                                          borrow_limit=borrow_limit,
                                          tail=tail)
    ta, td, tk = tgrids.build_asset_grids(grid, 0.001, 50.0, a_count, 2,
                                          dist_count,
                                          borrow_limit=borrow_limit,
                                          dtype=F64, tail=tail)
    assert tk == jk
    np.testing.assert_array_equal(_np(ta), np.asarray(ja))
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    assert tgrids.grid_point_counts(
        grid, a_count, dist_count, borrow_limit=borrow_limit,
        tail=tail) == jgrids.grid_point_counts(
            grid, a_count, dist_count, borrow_limit=borrow_limit, tail=tail)
    assert (len(ta), len(td)) == tgrids.grid_point_counts(
        grid, a_count, dist_count, borrow_limit=borrow_limit, tail=tail)


def test_grid_and_kernel_specs_are_the_jax_ones():
    for name in tconfig.GRID_POLICIES:
        assert (tconfig.resolve_grid(name).__dict__
                == jconfig.resolve_grid(name).__dict__)
    for name in tconfig.KERNEL_POLICIES:
        assert (tconfig.resolve_kernel(name).__dict__
                == jconfig.resolve_kernel(name).__dict__)
    with pytest.raises(ValueError, match="grid policy"):
        tconfig.resolve_grid("coarse")
    with pytest.raises(ValueError, match="kernel policy"):
        tconfig.resolve_kernel("megakernel")


def test_tail_ingredients_match_jax():
    rng = np.random.default_rng(7)
    R = np.array([0.98, 1.0, 1.02, 1.04])
    W = np.array([0.9, 1.0, 1.1, 1.2])
    beta, crra = 0.96, np.array([1.0, 2.0, 3.0, 5.0])
    np.testing.assert_allclose(
        _np(tutil.asymptotic_mpc(torch.tensor(R), beta, torch.tensor(crra))),
        np.asarray(jutil.asymptotic_mpc(jnp.asarray(R), beta,
                                        jnp.asarray(crra))),
        rtol=0, atol=1e-15)
    P = rng.random((4, 5, 5)) + 0.05
    P /= P.sum(axis=2, keepdims=True)
    lvl = rng.random((4, 5)) + 0.5
    ref = [np.asarray(jh.perfect_foresight_human_wealth(
        jnp.asarray(R[i]), jnp.asarray(W[i]), jnp.asarray(lvl[i]),
        jnp.asarray(P[i]))) for i in range(4)]
    out = th.perfect_foresight_human_wealth(torch.tensor(R), torch.tensor(W),
                                            torch.tensor(lvl),
                                            torch.tensor(P))
    np.testing.assert_allclose(_np(out), np.stack(ref), rtol=1e-12)
    # one cell, Python-float prices
    one = th.perfect_foresight_human_wealth(R[2], W[2], torch.tensor(lvl[2]),
                                            torch.tensor(P[2]))
    np.testing.assert_allclose(_np(one), ref[2], rtol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_analytic_tail_knots_match_jax(dtype):
    rng = np.random.default_rng(11)
    m = np.sort(rng.random((4, 9)) * 20, axis=1).astype(dtype)
    c = np.sort(rng.random((4, 9)) * 5, axis=1).astype(dtype)
    # a flat top segment (dm = dc = 0): the slope guard decides.  It is
    # finfo(float64).tiny cast to the dtype -- 0 in float32, so 0/0 is NaN
    # there, as in the JAX package; in float64 the slope is 0
    m[1, -1], c[1, -1] = m[1, -2], c[1, -2]
    # and a kappa outside [1e-3, 0.999], clipped
    kappa, h = np.float64(1.5), (rng.random(4) * 30).astype(dtype)
    ref = jh._append_analytic_tail_knots(jnp.asarray(m), jnp.asarray(c),
                                         kappa, jnp.asarray(h))
    out = th._append_analytic_tail_knots(torch.tensor(m), torch.tensor(c),
                                         kappa, torch.tensor(h))
    for x, y in zip(out, ref):
        assert x.dtype == getattr(torch, dtype)
        rtol = 1e-15 if dtype == "float64" else 1e-6
        np.testing.assert_allclose(_np(x), np.asarray(y), rtol=rtol,
                                   equal_nan=True)
    assert bool(torch.isnan(out[1][1, -1])) == (dtype == "float32")


def test_append_tail_knot_and_initial_policy_match_jax(small):
    jm, tm = small["compact"]
    ref = jh.initial_policy(jm, analytic_tail=True)
    out = th.initial_policy(tm, analytic_tail=True)
    for x, y in zip(out, ref):
        np.testing.assert_array_equal(_np(x), np.asarray(y))
    m, c = np.asarray(ref.m_knots), np.asarray(ref.c_knots)
    for x, y in zip(tinterp.append_tail_knot(torch.tensor(m),
                                             torch.tensor(c), 0.3),
                    jinterp.append_tail_knot(jnp.asarray(m), jnp.asarray(c),
                                             0.3)):
        np.testing.assert_array_equal(_np(x), np.asarray(y))


def test_tail_closed_egm_step_matches_jax(small):
    jm, tm = small["compact"]
    p = jh.initial_policy(jm, analytic_tail=True)
    ref = jh.egm_step(p, 1.02, 1.0, jm, 0.96, 2.0, analytic_tail=True)
    out = th.egm_step(th.initial_policy(tm, analytic_tail=True), 1.02, 1.0,
                      tm, 0.96, 2.0, analytic_tail=True)
    for x, y in zip(out, ref):
        np.testing.assert_allclose(_np(x), np.asarray(y), rtol=1e-12)


# -- policies ------------------------------------------------------------------

def test_policy_checks(small):
    _, tm = small["reference"]
    th.check_policies(kernel="fused")
    th.check_policies(kernel="fused", grid="compact")
    th.solve_household(1.02, 1.0, tm, 0.96, 2.0, kernel="fused")
    th.stationary_wealth(th.initial_policy(tm), 1.02, 1.0, tm,
                         kernel="fused", max_iter=5)
    for grid in ("compact", "adaptive"):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 item 7"):
            te.household_capital_supply(0.02, tm, 0.96, 2.0, 0.36, 0.08,
                                        grid=grid)
    with pytest.raises(ValueError, match="kernel policy"):
        th.check_policies(kernel="megakernel")
    with pytest.raises(ValueError, match="shapes differ"):
        th.stack_models([tm, small["compact"][1]])


def test_sweep_passes_the_grid_to_the_solver():
    kw = dict(KW)
    r_tol, max_bisect = kw.pop("r_tol"), kw.pop("max_bisect")
    res = run_table2_sweep(cells=[(3.0, 0.3, 0.2)], dtype=F64, device="cpu",
                           grid="compact", kernel="fused", r_tol=r_tol,
                           max_bisect=max_bisect, **kw)
    one = te.solve_calibration_lean(3.0, 0.3, dtype=F64, device="cpu",
                                    grid="compact", kernel="fused",
                                    r_tol=r_tol, max_bisect=max_bisect, **kw)
    assert res.r_star_pct[0] == 100.0 * float(one.r_star)
    assert res.egm_iters[0] == int(one.egm_iters)
    assert res.status.tolist() == [0]


# -- the fixed-order scatter (repair) ----------------------------------------

def _index_add_push(dist, idx, weight, P):
    """The plain push-forward as the port had it: ``index_add_`` in
    contribution order, which the CPU follows."""
    C, D, N = dist.shape
    tgt, src, coef = K.lottery_targets(idx, weight)
    lane = torch.arange(C)[:, None, None]
    state = torch.arange(N)[None, :, None]
    vals = (dist.reshape(-1)[((lane * D + src) * N + state).reshape(-1)]
            * coef.reshape(-1))
    moved = torch.zeros(C * D * N, dtype=dist.dtype)
    moved.index_add_(0, ((lane * D + tgt) * N + state).reshape(-1), vals)
    moved = moved.reshape(C, D, N)
    out = moved[:, :, 0, None] * P[:, None, 0, :]
    for n in range(1, N):
        out = out + moved[:, :, n, None] * P[:, None, n, :]
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fixed_order_push_forward_equals_the_index_add_result(small, dtype):
    jm, _ = small["reference"]
    trans = [jh.wealth_transition(jh.solve_household(R, W, jm, 0.96, s)[0],
                                  R, W, jm) for R, W, s in LANES]
    idx = torch.tensor(np.stack([np.asarray(t.idx) for t in trans]))
    w = torch.tensor(np.stack([np.asarray(t.weight) for t in trans]),
                     dtype=dtype)
    P = torch.tensor(np.stack([np.asarray(jm.transition)] * 2), dtype=dtype)
    src, coef = K.lottery_gather(idx, w)
    rng = np.random.default_rng(5)
    for _ in range(3):
        d = torch.tensor(rng.random(tuple(idx.shape)), dtype=dtype)
        assert torch.equal(K.push_forward_lanes(d, src, coef, P),
                           _index_add_push(d, idx, w, P))
    # a non-finite lane stays its own: padding reads the lane's own mass
    d = torch.tensor(rng.random(tuple(idx.shape)), dtype=dtype)
    d[0] = float("nan")
    out = K.push_forward_lanes(d, src, coef, P)
    assert bool(torch.isfinite(out[1]).all())


# -- the 12 golden cells --------------------------------------------------------

@pytest.mark.slow
def test_all_twelve_golden_cells_under_the_fused_kernel():
    with open(os.path.join(DATA, "table2_golden_test.json")) as f:
        golden = json.load(f)
    res = run_table2_sweep(dtype=F64, device="cpu", kernel="fused",
                           **golden["config"])
    dr = np.abs(res.r_star_pct - np.asarray(golden["r_star_pct"]))
    assert dr.max() < 1e-3                       # 0.1 bp
    assert res.status.tolist() == [0] * 12
