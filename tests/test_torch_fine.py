"""The fine configuration (BASELINE.json config 2: 1000 assets, 15 labor
states, 1000 wealth points), config 1 (7 labor states, 100 assets, 500
wealth points) and a many-state cell (17 labor states) through the port
on the CPU, against the JAX package: the port's twin of
``tests/test_equilibrium.py::test_named_benchmark_configs``.

* ``solve_calibration_lean(**fine_grid_kwargs())`` against
  ``tests/data/torch_fine_golden.json`` (the JAX package's solve, written
  by ``scripts/make_torch_fine_golden.py``).  Float64: r* within 1e-6 pct
  (ROADMAP's slice rule), trips, EGM and distribution steps equal,
  CONVERGED.  Float32: r* within 1 bp (the JAX accelerator path's
  contract), trips equal, steps within 2 + 30 % (the float32 bound of
  ``tests/test_torch_ladders.py``: the Aitken sums round in another order
  than JAX's).
* Config 1 (``baseline_cell_kwargs()``) and the 17-state cell (CRRA 3, rho
  0.6, 32 assets, 500 wealth points; the card's distribution kernels
  took at most 16 states before) under the same rule, each against its
  JAX golden; then JAX's own bounds on the two BASELINE configurations,
  solved in float32 as the JAX test solves them: each r* in (3.0, 4.17)
  pct, the two within 0.1 pct of each other.
* The fine cell on the compact grids (``grid="compact"`` and
  ``"adaptive"``: every policy closed by the analytic tail, the
  coarse-to-fine ladder on the EGM kernel's tail mode) under the
  reference kernels, against the golden's ``grids`` records: float64 r*
  within 1e-6 pct with the trips, EGM, distribution, descent and polish
  steps equal and CONVERGED; compact float32 within 1 bp with the trips
  equal.
* The fused kernel's plain version with the tail at the fine compact
  width (A=851, D=926), at a price and a start drawn with numpy from a
  seed: bitwise the chain of the tailed EGM plain loop, the savings
  policy and the lottery's plain version (the chain ``chip_smoke.py``
  phase 7 holds the card's tailed cluster layouts to, bitwise), its
  policy against JAX's compact ``egm_step`` loop within the parity
  tolerance, with equal steps.
* The distribution kernel's plain version at the fine width, on a lottery
  and a Markov chain made with numpy from a seed, against JAX's scatter
  push under its accelerated loop: values within the JAX kernel-parity
  tolerance (rtol 1e-9, atol 1e-8; float32 1e-5), step counts equal
  (float32: within the bound above).  On
  the CPU ``stationary_lottery_grid`` runs its plain version; the card
  runs the cluster layout, which ``chip_smoke.py`` phase 7 holds bitwise
  to it.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aiyagari_hark_tpu.models.household as jh
from aiyagari_hark_tpu_torch.models.equilibrium import solve_calibration_lean
from aiyagari_hark_tpu_torch.ops import kernels as K
from aiyagari_hark_tpu_torch.solver_health import status_name
from aiyagari_hark_tpu_torch.utils.config import (baseline_cell_kwargs,
                                                  fine_grid_kwargs)

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_fine_golden.json")
DTYPES = {"float64": torch.float64, "float32": torch.float32}
R_STAR_PCT = {"float64": 1e-6, "float32": 1e-2}


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


# The port's solves, once each: (cell, dtype) -> LeanEquilibrium.
_SOLVES = {}


def _cell_kwargs(cell):
    if cell == "fine":
        return fine_grid_kwargs()
    if cell == "baseline":
        return baseline_cell_kwargs()
    n = int(cell.rsplit("_", 1)[-1])           # "labor_states_17"
    return dict(crra=3.0, labor_ar=0.6, labor_states=n, a_count=32,
                dist_count=500)


def _solve(cell, dtype, grid="reference"):
    if (cell, dtype, grid) not in _SOLVES:
        kw = _cell_kwargs(cell)
        crra, rho = kw.pop("crra"), kw.pop("labor_ar")
        _SOLVES[cell, dtype, grid] = solve_calibration_lean(
            crra, rho, dtype=DTYPES[dtype], device="cpu", grid=grid, **kw)
    return _SOLVES[cell, dtype, grid]


def _golden_cell(golden, cell, dtype):
    if cell in ("fine", "baseline"):
        return golden[cell][dtype]
    n = int(cell.rsplit("_", 1)[-1])
    return next(g for g in golden["many_states"]
                if g["labor_states"] == n and g["dtype"] == dtype)


def _steps_close(port, ref):
    """A float32 step count against JAX's: within 2 + 30 %."""
    return abs(int(port) - int(ref)) <= 2 + 0.3 * int(ref)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fine_cell_matches_the_jax_golden(golden, dtype):
    kw = fine_grid_kwargs()
    crra, rho = kw.pop("crra"), kw.pop("labor_ar")
    assert kw == golden["width"]
    res = _solve("fine", dtype)
    g = golden["fine"][dtype]
    assert abs(100.0 * float(res.r_star) - g["r_star_pct"]) \
        <= R_STAR_PCT[dtype]
    assert int(res.bisect_iters) == g["bisect_iters"]
    if dtype == "float64":
        assert int(res.egm_iters) == g["egm_iters"]
        assert int(res.dist_iters) == g["dist_iters"]
        assert status_name(int(res.status)) == g["status_name"] \
            == "CONVERGED"
        np.testing.assert_allclose(float(res.capital), g["capital"],
                                   rtol=1e-6)
        np.testing.assert_allclose(float(res.labor), g["labor"],
                                   rtol=1e-12)
    else:
        assert _steps_close(res.egm_iters, g["egm_iters"])
        assert _steps_close(res.dist_iters, g["dist_iters"])


@pytest.mark.parametrize("cell", ["baseline", "labor_states_17"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_named_cell_matches_the_jax_golden(golden, cell, dtype):
    """The slice rule: float64 r* within 1e-6 pct with the trips, EGM and
    distribution steps equal and CONVERGED; float32 within 1 bp with the
    trips equal."""
    kw = _cell_kwargs(cell)
    g = _golden_cell(golden, cell, dtype)
    if cell == "baseline":
        assert {k: kw[k] for k in golden["baseline"]["width"]} \
            == golden["baseline"]["width"]
    else:
        assert all(g[k] == kw[k] for k in ("labor_states", "a_count",
                                           "dist_count"))
    assert (g["crra"], g["labor_ar"]) == (kw["crra"], kw["labor_ar"])
    res = _solve(cell, dtype)
    assert abs(100.0 * float(res.r_star) - g["r_star_pct"]) \
        <= R_STAR_PCT[dtype]
    assert int(res.bisect_iters) == g["bisect_iters"]
    if dtype == "float64":
        assert int(res.egm_iters) == g["egm_iters"]
        assert int(res.dist_iters) == g["dist_iters"]
        assert status_name(int(res.status)) == g["status_name"] \
            == "CONVERGED"


def test_named_benchmark_configs_keep_jax_bounds(golden):
    """JAX's ``test_named_benchmark_configs`` on the port: configs 1 and 2
    solved in float32, each r* in (3.0, 4.17) pct, the two within 0.1 pct
    of each other; the JAX goldens keep the same bounds."""
    got = {cell: 100.0 * float(_solve(cell, "float32").r_star)
           for cell in ("baseline", "fine")}
    for cell, r_pct in got.items():
        assert 3.0 < r_pct < 4.17, (cell, r_pct)
        assert 3.0 < golden[cell]["float32"]["r_star_pct"] < 4.17
    assert abs(got["baseline"] - got["fine"]) < 0.1
    assert abs(golden["baseline"]["float32"]["r_star_pct"]
               - golden["fine"]["float32"]["r_star_pct"]) < 0.1


@pytest.mark.parametrize("grid, dtype", [
    ("compact", "float64"), ("adaptive", "float64"), ("compact", "float32"),
])
def test_fine_compact_grids_match_the_jax_golden(golden, grid, dtype):
    """The slice rule on the compact grids: float64 r* within 1e-6 pct
    with the six counts equal (trips, EGM, distribution, descent and
    polish steps, CONVERGED); float32 within 1 bp with the trips
    equal."""
    from aiyagari_hark_tpu.ops.grids import grid_point_counts

    g = golden["grids"][grid]
    kw = fine_grid_kwargs()
    assert (g["a_points"], g["dist_points"]) == grid_point_counts(
        grid, kw["a_count"], kw["dist_count"])
    res = _solve("fine", dtype, grid)
    rec = g[dtype]
    assert rec["kernel"] == "reference"
    assert abs(100.0 * float(res.r_star) - rec["r_star_pct"]) \
        <= R_STAR_PCT[dtype]
    assert int(res.bisect_iters) == rec["bisect_iters"]
    if dtype == "float64":
        for k in ("egm_iters", "dist_iters", "descent_steps",
                  "polish_steps"):
            assert int(getattr(res, k)) == rec[k], k
        assert status_name(int(res.status)) == rec["status_name"] \
            == "CONVERGED"


def test_fine_compact_fused_plain_is_bitwise_the_tailed_chain():
    """At the fine compact width, one price and a start drawn from a
    numpy seed: ``fused_cell_grid_plain(tail=True)`` is bitwise the
    tailed EGM plain loop, ``wealth_transition`` and the lottery's plain
    version in turn; its policy is JAX's compact ``egm_step`` loop within
    the parity tolerance, in as many steps."""
    import aiyagari_hark_tpu_torch.models.household as th
    from aiyagari_hark_tpu_torch.models import firm

    rng = np.random.default_rng(17)
    r = float(rng.uniform(0.03, 0.045))
    kw = fine_grid_kwargs()
    crra = kw.pop("crra")
    dt = torch.float64
    model = th.stack_models([th.build_simple_model(
        dtype=dt, device="cpu", grid="compact", **kw)])
    C, N = model.labor_levels.shape
    A, D = model.a_grid.shape[1], model.dist_grid.shape[1]
    assert (A, D) == (851, 926)
    rt = torch.tensor([r], dtype=dt)
    R = 1.0 + rt
    W = firm.wage_rate(firm.k_to_l_from_r(rt, 0.36, 0.08), 0.36)
    sc = th._scalars(R, W, model, 0.96, crra)
    h = th.perfect_foresight_human_wealth(R, W, model.labor_levels,
                                          model.transition)
    p0 = th.initial_policy(model, analytic_tail=True)
    d0 = rng.dirichlet(np.ones(D * N)).reshape(1, D, N)
    d0 = torch.tensor(d0, dtype=dt)
    egm_tol, dist_tol = 1e-6, 1e-11
    fused = K.fused_cell_grid_plain(
        p0.m_knots, p0.c_knots, model.a_grid, model.dist_grid,
        model.labor_levels, model.transition, sc, h, d0, egm_tol,
        dist_tol=dist_tol, tail=True)
    m, c, eit, ediff = K.egm_policy_grid_plain(
        p0.m_knots, p0.c_knots, model.a_grid, model.labor_levels,
        model.transition, sc, egm_tol, h=h, tail=True)
    tr = th.wealth_transition(th.HouseholdPolicy(m, c), R, W, model)
    dist, dit, ddiff = K.stationary_lottery_grid_plain(
        tr.idx, tr.weight, model.transition, d0, dist_tol)
    for a, b in zip(fused, (m, c, dist, eit, ediff, dit, ddiff)):
        assert torch.equal(a, b)
    assert m.shape == (1, N, A + 3)
    jm = jh.build_simple_model(labor_states=N, labor_ar=kw["labor_ar"],
                               a_count=kw["a_count"],
                               dist_count=kw["dist_count"], grid="compact")
    jp, jit_, _, _ = jax.jit(lambda Rj, Wj: jh.accelerated_policy_fixed_point(
        lambda p: jh.egm_step(p, Rj, Wj, jm, 0.96, crra,
                              analytic_tail=True),
        jh.initial_policy(jm, analytic_tail=True), egm_tol, 3000, 32))(
        float(R[0]), float(W[0]))
    assert int(eit[0]) == int(jit_)
    np.testing.assert_allclose(m[0].numpy(), np.asarray(jp.m_knots),
                               rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(c[0].numpy(), np.asarray(jp.c_knots),
                               rtol=1e-9, atol=1e-8)


def _numpy_lottery(seed, D, N):
    """A fine-width lottery and Markov chain from a seed: each source saves
    a near-diagonal share of its row (a 0.9-0.99 slope per state, a
    jitter of a few rows), a uniform right-neighbour weight, a random
    row-stochastic P, a uniform start."""
    rng = np.random.default_rng(seed)
    slope = rng.uniform(0.9, 0.99, size=N)
    jitter = rng.integers(-3, 4, size=(D, N))
    idx = np.clip(np.floor(np.arange(D)[:, None] * slope) + jitter, 0,
                  D - 2).astype(np.int32)
    weight = rng.random((D, N))
    P = rng.dirichlet(np.full(N, 2.0), size=N)
    d0 = np.full((D, N), 1.0 / (D * N))
    return idx, weight, P, d0


@pytest.mark.parametrize("dtype, tol, atol", [
    ("float64", 1e-11, 1e-8),
    ("float32", 1e-8, 1e-5),
])
def test_fine_lottery_matches_jax_on_numpy_inputs(dtype, tol, atol):
    kw = fine_grid_kwargs()
    D, N = kw["dist_count"], kw["labor_states"]
    idx, weight, P, d0 = _numpy_lottery(15, D, N)
    jd = getattr(jnp, dtype)
    trans = jh.WealthTransition(jnp.asarray(idx), jnp.asarray(weight, jd),
                                jnp.zeros((D, N), jd))
    Pj = jnp.asarray(P, jd)
    ref, rit, rdiff, _ = jax.jit(
        lambda d: jh.accelerated_distribution_fixed_point(
            lambda x: jh._push_forward(x, trans, Pj), d, tol, 20000, 64))(
        jnp.asarray(d0, jd))
    dt = DTYPES[dtype]
    out, it, diff = K.stationary_lottery_grid(
        torch.tensor(idx, dtype=torch.int64)[None],
        torch.tensor(weight, dtype=dt)[None], torch.tensor(P, dtype=dt)[None],
        torch.tensor(d0, dtype=dt)[None], tol)
    if dtype == "float64":
        assert it.tolist() == [int(rit)]
    else:
        assert _steps_close(it[0], rit)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), rtol=1e-9,
                               atol=atol)
    np.testing.assert_allclose(float(diff[0]), float(rdiff), rtol=1e-3,
                               atol=tol)
