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


def _solve(cell, dtype):
    if (cell, dtype) not in _SOLVES:
        kw = _cell_kwargs(cell)
        crra, rho = kw.pop("crra"), kw.pop("labor_ar")
        _SOLVES[cell, dtype] = solve_calibration_lean(
            crra, rho, dtype=DTYPES[dtype], device="cpu", **kw)
    return _SOLVES[cell, dtype]


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
