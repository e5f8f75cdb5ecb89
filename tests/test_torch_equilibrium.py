"""The port's equilibrium solvers against the JAX reference and the goldens.

f64 on the CPU.  On the small model (``labor_states=3, a_count=12,
dist_count=48``) both packages start from bit-identical models (carried
across with ``carry.model_from_numpy``): bisection trips, summed EGM steps
and statuses must be equal, summed distribution steps agree within the
stated bound, and r* within 1e-9.
JAX is compared one cell at a time (its batch-packing bit-identity is not
assumed); the port's batched lanes must equal its own single-cell solves.
Two cells of the reduced golden config run in the fast profile; all 12
cells and the full-width golden run under the ``slow`` marker, as the JAX
suite's own Table II tests do.
"""

import json
import os

import numpy as np
import pytest
import torch

import aiyagari_hark_tpu.models.equilibrium as je
import aiyagari_hark_tpu.models.household as jh
import aiyagari_hark_tpu_torch.models.equilibrium as te
import aiyagari_hark_tpu_torch.models.household as th
from aiyagari_hark_tpu_torch.carry import model_from_numpy
from aiyagari_hark_tpu_torch.parallel.sweep import (run_table2_sweep,
                                                    sweep_cells)

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(__file__), "data")
SMALL = dict(labor_states=3, a_count=12, dist_count=48)
CELLS = [(3.0, 0.6), (5.0, 0.3)]
# The distribution loop's Aitken step sums over the whole histogram, and
# the port sums in the pairwise tree its CUDA kernel uses, JAX in its own
# order.  That alone moves a few stall or convergence exits by some steps
# over a whole bisection (measured: 49742 vs 49775 summed steps on the
# (1, 0.9) cell; with a plain torch.sum the counts are equal), so the
# summed distribution steps are held to 0.2%; every other count exactly.
DIST_STEPS_RTOL = 2e-3


def _golden(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def small():
    """Per cell: the JAX model and the port's carried copy."""
    out = []
    for crra, rho in CELLS:
        jm = jh.build_simple_model(labor_ar=rho, **SMALL)
        out.append((crra, jm, model_from_numpy([np.asarray(f) for f in jm],
                                               device="cpu")))
    return out


@pytest.fixture(scope="module")
def jax_lean(small):
    return [je.solve_equilibrium_lean(jm, 0.96, crra, 0.36, 0.08)
            for crra, jm, _ in small]


@pytest.fixture(scope="module")
def port_lean(small):
    model = th.stack_models([tm for _, _, tm in small])
    crra = torch.tensor([c for c, _, _ in small], dtype=torch.float64)
    return te.solve_equilibrium_lean(model, 0.96, crra, 0.36, 0.08)


def _check_lean(lean, ref):
    assert int(lean.bisect_iters) == int(ref.bisect_iters)
    assert int(lean.egm_iters) == int(ref.egm_iters)
    assert abs(int(lean.dist_iters) - int(ref.dist_iters)) <= (
        DIST_STEPS_RTOL * int(ref.dist_iters))
    assert int(lean.status) == int(ref.status) == 0
    assert abs(float(lean.r_star) - float(ref.r_star)) <= 1e-9
    assert float(lean.capital) == pytest.approx(float(ref.capital),
                                                rel=1e-8)
    assert float(lean.labor) == pytest.approx(float(ref.labor), rel=1e-14)


@pytest.mark.parametrize("cell", [0, 1])
def test_lean_equilibrium_batched_lanes_match_jax(port_lean, jax_lean, cell):
    _check_lean(type(port_lean)(*(f[cell] for f in port_lean)),
                jax_lean[cell])


def test_lean_equilibrium_single_cell_equals_its_batched_lane(small,
                                                              port_lean):
    crra, _, tm = small[0]
    one = te.solve_equilibrium_lean(tm, 0.96, crra, 0.36, 0.08)
    for f, b in zip(one, port_lean):
        assert torch.equal(f, b[0])


def test_household_capital_supply_matches_jax(small):
    crra, jm, tm = small[0]
    ref = je.household_capital_supply(0.03, jm, 0.96, crra, 0.36, 0.08)
    out = te.household_capital_supply(
        torch.tensor(0.03, dtype=torch.float64), tm, 0.96, crra, 0.36, 0.08)
    assert int(out.egm_iters) == int(ref.egm_iters)
    assert int(out.dist_iters) == int(ref.dist_iters)
    assert int(out.status) == int(ref.status)
    assert float(out.supply) == pytest.approx(float(ref.supply), rel=1e-9)
    assert float(out.wage) == pytest.approx(float(ref.wage), rel=1e-14)
    np.testing.assert_allclose(out.distribution.numpy(),
                               np.asarray(ref.distribution), rtol=1e-9,
                               atol=1e-8)


def test_bisection_equilibrium_matches_jax_batched_and_single(small):
    model = th.stack_models([tm for _, _, tm in small])
    crra = torch.tensor([c for c, _, _ in small], dtype=torch.float64)
    batch = te.solve_bisection_equilibrium(model, 0.96, crra, 0.36, 0.08,
                                           r_tol=1e-7)
    for c, (s, jm, tm) in enumerate(small):
        ref = je.solve_bisection_equilibrium(jm, 0.96, s, 0.36, 0.08,
                                             r_tol=1e-7)
        lane = batch._replace(policy=th.HouseholdPolicy(
            *(f[c] for f in batch.policy)))
        lane = type(lane)(*(f[c] if isinstance(f, torch.Tensor) else f
                            for f in lane))
        assert int(lane.bisect_iters) == int(ref.bisect_iters)
        assert int(lane.status) == int(ref.status) == 0
        assert abs(float(lane.r_star) - float(ref.r_star)) <= 1e-9
        for f in ("wage", "capital", "labor", "saving_rate"):
            assert float(getattr(lane, f)) == pytest.approx(
                float(getattr(ref, f)), rel=1e-8), f
        assert abs(float(lane.excess) - float(ref.excess)) <= 1e-8
        np.testing.assert_allclose(lane.policy.c_knots.numpy(),
                                   np.asarray(ref.policy.c_knots), rtol=1e-9,
                                   atol=1e-8)
        np.testing.assert_allclose(lane.distribution.numpy(),
                                   np.asarray(ref.distribution), rtol=1e-9,
                                   atol=1e-8)
        if c == 0:
            one = te.solve_bisection_equilibrium(tm, 0.96, s, 0.36, 0.08,
                                                 r_tol=1e-7)
            assert torch.equal(one.r_star, lane.r_star)
            assert torch.equal(one.distribution, lane.distribution)


def test_solve_calibration_entry_points_build_on_the_requested_device():
    tiny = dict(labor_states=2, a_count=6, dist_count=20, r_tol=1e-7)
    lean = te.solve_calibration_lean(3.0, 0.6, dtype=torch.float64,
                                     device="cpu", **tiny)
    eq = te.solve_calibration(3.0, 0.6, dtype=torch.float64, device="cpu",
                              **tiny)
    assert lean.r_star.device.type == "cpu" and int(lean.status) == 0
    assert tuple(eq.policy.m_knots.shape) == (2, 7)
    assert tuple(eq.distribution.shape) == (20, 2)
    assert abs(float(eq.r_star) - float(lean.r_star)) < 1e-6
    with pytest.raises(NotImplementedError, match="illinois"):
        te.solve_calibration_lean(3.0, 0.6, root_method="illinois",
                                  dtype=torch.float64, device="cpu", **tiny)


def test_sweep_cells_match_the_sweep_config():
    from aiyagari_hark_tpu.utils.config import SweepConfig

    assert sweep_cells() == SweepConfig().cells()
    assert sweep_cells(labor_sd=(0.2, 0.4)) == SweepConfig(
        labor_sd=(0.2, 0.4)).cells()


def _check_golden(res, golden, idx):
    np.testing.assert_allclose(res.r_star_pct,
                               np.asarray(golden["r_star_pct"])[idx],
                               atol=1e-6)
    np.testing.assert_allclose(res.saving_rate_pct,
                               np.asarray(golden["saving_rate_pct"])[idx],
                               atol=1e-4)
    assert res.status.tolist() == [0] * len(idx)


def test_two_reduced_golden_cells():
    """(sigma=1, rho=0.3) and (sigma=5, rho=0.9) of the reduced golden,
    batched, within the JAX suite's golden tolerances."""
    golden = _golden("table2_golden_test.json")
    idx = [1, 11]
    cells = [(golden["crra"][i], golden["labor_ar"][i], golden["labor_sd"])
             for i in idx]
    res = run_table2_sweep(cells=cells, dtype=torch.float64, device="cpu",
                           **golden["config"])
    _check_golden(res, golden, idx)
    assert res.bisect_iters.tolist() == [31, 31]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["table2_golden_test.json",
                                  "table2_golden.json"])
def test_all_twelve_golden_cells(name):
    golden = _golden(name)
    res = run_table2_sweep(dtype=torch.float64, device="cpu",
                           **golden["config"])
    _check_golden(res, golden, list(range(12)))
