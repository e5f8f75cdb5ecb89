"""The port's integrity layer against the JAX package's, on the CPU in f64:
the packed-row corruption drills, the certificate vocabulary and
thresholds, the certifier's residuals, the direct stationary solve it
recomputes with, the perturbed policies that only certification catches,
the SDC sample and recheck, and certification inside a sweep.  Size: the JAX verify tests' (``tests/test_verify.py``).

Stated tolerances of the certifier's residuals against JAX's on the same
rows (both re-solve the policy to ``egm_tol`` and the distribution to
``dist_tol``, by the same algorithms in other summation orders): the
Euler residual to 1e-6 relative; market clearing and capital to 1e-8
absolute (they are relative residuals of order 1e-3); stationarity and
mass, both roundoff, to 1e-14 absolute; shape, Lorenz and recompute
exactly.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import aiyagari_hark_tpu.models.household as jh
import aiyagari_hark_tpu.parallel.sweep as jsw
import aiyagari_hark_tpu.utils.config as jcfg
import aiyagari_hark_tpu.verify as jv
import aiyagari_hark_tpu_torch.models.household as th
import aiyagari_hark_tpu_torch.parallel.sweep as tsw
import aiyagari_hark_tpu_torch.utils.config as tcfg
import aiyagari_hark_tpu_torch.verify as tv
from aiyagari_hark_tpu_torch.carry import model_from_numpy, policy_from_numpy
from aiyagari_hark_tpu_torch.models.equilibrium import (
    solve_calibration, solve_calibration_lean)
from aiyagari_hark_tpu_torch.solver_health import (CONVERGED, MAX_ITER,
                                                   NONFINITE, STALLED)
from aiyagari_hark_tpu_torch.utils.debug import validate_policy
from aiyagari_hark_tpu_torch.utils.fingerprint import hashable_kwargs

torch.set_num_threads(1)
F64 = torch.float64
KW = dict(a_count=12, dist_count=48, labor_states=4, r_tol=1e-5,
          max_bisect=30)
SMALL = dict(crra_values=(1.0, 3.0), rho_values=(0.3, 0.6))
CPU = dict(dtype=F64, device="cpu")


def _port(sweep=None, **kw):
    return tsw.run_table2_sweep(sweep or tcfg.SweepConfig(**SMALL), **CPU,
                                **kw, **KW)


# -- drills and vocabulary ----------------------------------------------------

def test_row_drills_match_jax():
    row = np.linspace(-1.0, 2.0, 10)
    for field, bit in ((0, 30), (1, 0), (6, 52), (9, 63)):
        assert (tv.flip_row_bit(row, field, bit).tobytes()
                == jv.flip_row_bit(row, field, bit).tobytes())
    assert np.array_equal(tv.perturb_row(row, 3, 1e-6),
                          jv.inject.perturb_row(row, 3, 1e-6))
    assert tv.flip_row_bit(row, 0, 30)[0] != row[0]
    assert np.array_equal(tv.flip_row_bit(tv.flip_row_bit(row)), row)


def test_certificate_vocabulary_and_grades_match_jax():
    assert tv.CERT_CHECKS == jv.CERT_CHECKS
    assert tv.CERT_LEVEL_NAMES == jv.CERT_LEVEL_NAMES
    assert (tv.CERTIFIED, tv.MARGINAL, tv.FAILED, tv.UNCERTIFIED) == (
        jv.CERTIFIED, jv.certificate.MARGINAL, jv.FAILED, jv.UNCERTIFIED)
    assert dataclasses.asdict(tv.CertThresholds()) == dataclasses.asdict(
        jv.CertThresholds())
    thr, jthr = tv.CertThresholds(), jv.CertThresholds()
    for name in tv.CERT_CHECKS:
        for r in (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 1e-9, 5e-3, 0.3, np.nan,
                  np.inf):
            assert tuple(thr.grade(name, r)) == tuple(jthr.grade(name, r))
    assert thr.grade("recompute", float(STALLED)).level == tv.MARGINAL
    assert thr.grade("recompute", float(MAX_ITER)).level == tv.FAILED
    cert = thr.certificate([0.1, 0, 0, 0, 0, 0, 0, CONVERGED])
    assert cert.level == tv.MARGINAL and cert.worst().name == "euler"
    assert cert.summary().startswith("MARGINAL (worst: euler")


@pytest.mark.parametrize("kw", [
    {}, dict(r_tol=1e-4), dict(r_tol=1e-10, precision="mixed"),
    dict(egm_tol=1e-8, dist_tol=1e-12, grid="compact"),
    dict(precision="fast", grid="adaptive", euler=0.5)])
@pytest.mark.parametrize("tdt,jdt", [(F64, np.float64),
                                     (torch.float32, np.float32)])
def test_thresholds_for_solver_match_jax(kw, tdt, jdt):
    assert dataclasses.asdict(tv.CertThresholds.for_solver(
        dtype=tdt, **kw)) == dataclasses.asdict(
            jv.CertThresholds.for_solver(dtype=jdt, **kw))


# -- the certifier's recompute ------------------------------------------------

def test_stationary_solve_matches_jax():
    """The direct bordered solve (library LU, refinement, continuation
    through the lottery kernel's plain version) against JAX's
    ``_stationary_solve`` on the same carried model and policy."""
    jm = jh.build_simple_model(labor_states=4, labor_ar=0.6, a_count=12,
                               dist_count=48)
    R, W = 1.03, 1.2
    jpol = jh.solve_household(R, W, jm, 0.96, 3.0)[0]
    jtrans = jh.wealth_transition(jpol, R, W, jm)
    S = jh.dense_wealth_operator(jtrans, 48)
    jd, jit, jdiff, jst = jh._stationary_solve(
        S, jm.transition, jh.initial_distribution(jm), 1e-11)
    tm = model_from_numpy([np.asarray(f) for f in jm], device="cpu")
    tpol = policy_from_numpy(np.asarray(jpol.m_knots),
                             np.asarray(jpol.c_knots), device="cpu")
    d, it, diff, st = th.stationary_solve(tpol, R, W, tm, tol=1e-11)
    assert int(st) == int(jst) == CONVERGED
    assert float(diff) <= 1e-11 and float(jdiff) <= 1e-11
    assert abs(int(it) - int(jit)) <= 2 and int(it) >= 3
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-12)
    assert abs(float(d.sum()) - 1.0) < 1e-13
    # batched lanes equal their single cells
    two = th.stack_models([tm, tm])
    db, itb, _, _ = th.stationary_solve(
        th.HouseholdPolicy(*(torch.stack([f, f]) for f in tpol)),
        torch.tensor([R, R], dtype=F64), torch.tensor([W, W], dtype=F64),
        two, tol=1e-11)
    assert torch.equal(db[1], d) and itb.tolist() == [int(it)] * 2


@pytest.fixture(scope="module")
def small_clean():
    return tsw.run_sweep("aiyagari", tcfg.SweepConfig(**SMALL), **CPU,
                         **KW)


def test_certify_packed_rows_residuals_match_jax(small_clean):
    rows, cells = small_clean.rows, small_clean.cells
    items = hashable_kwargs(dict(KW))
    certs = tv.certify_packed_rows(rows, cells, F64, items, device="cpu")
    jcerts = jv.certify_packed_rows(rows, cells, np.float64, items)
    for a, b in zip(certs, jcerts):
        assert a.level == b.level == tv.CERTIFIED
        ra, rb = a.residuals(), b.residuals()
        np.testing.assert_allclose(ra["euler"], rb["euler"], rtol=1e-6)
        for k in ("market_clearing", "capital"):
            assert abs(ra[k] - rb[k]) <= 1e-8, k
        for k in ("stationarity", "mass"):
            assert abs(ra[k] - rb[k]) <= 1e-14, k
        for k in ("shape", "lorenz", "recompute"):
            assert ra[k] == rb[k], k


def test_failed_rows_certify_failed_without_recompute():
    row = np.asarray([np.nan, np.nan, 1.0, 5, 100, 100, NONFINITE, 0, 200,
                      0], dtype=np.float64)
    good = np.asarray([0.0, 5.0, 1.0, 14, 100, 100, 0, 0, 200, 0],
                      dtype=np.float64)
    items = hashable_kwargs(dict(KW))
    for certify, kw in ((tv.certify_packed_rows, dict(dtype=F64,
                                                      device="cpu")),
                        (jv.certify_packed_rows, dict(dtype=np.float64))):
        c = certify([row, good], [(3.0, 0.6, 0.2)] * 2,
                    kwargs_items=items, **kw)
        by = {x.name: x for x in c[0].checks}
        assert c[0].failed and by["recompute"].residual == float(NONFINITE)
        assert np.isnan(by["euler"].residual)
        assert tuple(x.name for x in c[0].checks) == tv.CERT_CHECKS
        # a plausible-looking r* far from the root fails market clearing
        assert c[1].failed


@pytest.fixture(scope="module")
def solved_cell():
    return solve_calibration(3.0, 0.6, **CPU, **KW)


def test_certify_equilibrium_objects_lean_and_bare(solved_cell):
    eq = solved_cell
    cert = tv.certify_equilibrium(eq, crra=3.0, labor_ar=0.6, **CPU, **KW)
    assert cert.certified, cert.summary()
    lean = solve_calibration_lean(3.0, 0.6, **CPU, **KW)
    assert tv.certify_equilibrium(lean, crra=3.0, labor_ar=0.6, **CPU,
                                  **KW).certified
    bare = tv.certify_equilibrium(float(lean.r_star), crra=3.0,
                                  labor_ar=0.6, **CPU, **KW)
    assert bare.certified and bare.residuals()["capital"] == 0.0
    off = tv.certify_equilibrium(float(lean.r_star) + 3e-3, crra=3.0,
                                 labor_ar=0.6, **CPU, **KW)
    assert off.failed and off.worst().name in ("market_clearing",
                                               "capital")
    with pytest.raises(TypeError, match="crra"):
        tv.certify_equilibrium(lean, **CPU)


@pytest.mark.parametrize("mode,amplitude", [("shift", 0.0),
                                            ("noise", 1e-6)])
def test_perturbed_policy_is_jaxs_and_certifies_failed(solved_cell, mode,
                                                       amplitude):
    """A one-gridpoint shift or 1e-6 noise on the consumption knots: the
    JAX package's bits from the same knots, the shift passing every
    structural check, and certification FAILED
    (``tests/test_verify.py``)."""
    import jax.numpy as jnp

    pol = solved_cell.policy
    jpol = jh.HouseholdPolicy(jnp.asarray(pol.m_knots.numpy()),
                              jnp.asarray(pol.c_knots.numpy()))
    bad = tv.perturbed_policy(pol, mode=mode, amplitude=amplitude, seed=3)
    jbad = jv.perturbed_policy(jpol, mode=mode, amplitude=amplitude,
                               seed=3)
    assert (bad.c_knots.numpy().tobytes()
            == np.asarray(jbad.c_knots).tobytes())
    assert bad.m_knots is pol.m_knots
    assert not torch.equal(bad.c_knots, pol.c_knots)
    if mode == "shift":   # noise can take the constraint knot's c below 0
        validate_policy(bad)
    cert = tv.certify_equilibrium(solved_cell._replace(policy=bad),
                                  crra=3.0, labor_ar=0.6, **CPU, **KW)
    assert cert.failed, cert.summary()


def test_perturbed_policy_rejects_an_unknown_mode(solved_cell):
    with pytest.raises(ValueError, match="'shift' or 'noise'"):
        tv.perturbed_policy(solved_cell.policy, mode="flip")


# -- SDC sample and recheck ---------------------------------------------------

def test_sdc_sample_is_deterministic_scaled_and_jaxs():
    cells = np.asarray(tcfg.SweepConfig().cells())
    items = hashable_kwargs(dict(KW))
    s1 = tsw.sdc_sample(cells, items, F64, 0.25)
    assert len(s1) == 3
    assert np.array_equal(s1, tsw.sdc_sample(cells, items, F64, 0.25))
    assert np.array_equal(s1, jsw.sdc_sample(cells, items, np.float64,
                                             0.25))
    assert len(tsw.sdc_sample(cells, items, F64, 1.0)) == 12
    assert len(tsw.sdc_sample(cells, items, F64, 0.0)) == 0
    other = hashable_kwargs({**KW, "a_count": 13})
    assert not np.array_equal(s1, tsw.sdc_sample(cells, other, F64, 0.25))


def test_clean_recheck_finds_no_suspect(small_clean):
    res = _port(tcfg.SweepConfig(recheck_fraction=1.0, **SMALL))
    assert res.sdc_suspected is not None and not res.sdc_suspected.any()
    assert res.recheck_wall_seconds > 0.0
    assert np.array_equal(res.r_star_pct, small_clean.col("r_star") * 100)


def test_a_bit_flip_is_detected_quarantined_and_recovered(small_clean):
    """A bit flip in the one cell a quarter recheck samples: detected,
    re-solved by the first rung, the other cells untouched; without a
    recheck unseen; without quarantine the suspect keeps nothing."""
    sweep = tcfg.SweepConfig(recheck_fraction=0.25, **SMALL)
    (ci,) = tsw.sdc_sample(small_clean.cells, hashable_kwargs(dict(KW)),
                           F64, 0.25)
    flip = {"cell": int(ci), "bit": 30}
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        bad = _port(sweep, inject_sdc=flip)
    assert any("silent data corruption" in str(x.message) for x in w)
    assert np.nonzero(bad.sdc_suspected)[0].tolist() == [ci]
    assert np.nonzero(bad.retries)[0].tolist() == [ci]
    assert bad.retries[ci] == 1 and bad.status.tolist() == [0] * 4
    clean_r = small_clean.col("r_star") * 100.0
    assert bad.r_star_pct[ci] == clean_r[ci]         # rung 1: the same bits
    others = [i for i in range(4) if i != ci]
    assert np.array_equal(bad.r_star_pct[others], clean_r[others])
    assert np.array_equal(bad.status[others], small_clean.status[others])
    # the flipped cell alone (a lane's bits do not depend on its batch)
    crra, rho, _ = small_clean.cells[ci]
    alone = tcfg.SweepConfig(crra_values=(crra,), rho_values=(rho,))
    one = {"cell": 0, "bit": 30}
    blind = _port(alone, inject_sdc=one)
    assert blind.sdc_suspected is None
    assert blind.r_star_pct[0] == tv.flip_row_bit(
        small_clean.rows[ci], 0, 30)[0] * 100.0 != clean_r[ci]
    held = _port(alone.replace(recheck_fraction=1.0), inject_sdc=one,
                 quarantine=False)
    assert held.sdc_suspected.tolist() == [True]
    assert held.status[0] == NONFINITE and held.egm_iters[0] == 0
    assert np.isnan(held.r_star_pct[0]) and np.isnan(held.capital[0])


def test_sweep_certifies_every_cell_as_jax_does():
    ref = _port(tcfg.SweepConfig(certify=True, schedule="locked", **SMALL))
    assert ref.cert_level.tolist() == [tv.CERTIFIED] * 4
    assert ref.certify_wall_seconds > 0.0
    jres = jsw.run_table2_sweep(jcfg.SweepConfig(certify=True, **SMALL),
                                **KW)
    assert np.array_equal(ref.cert_level, jres.cert_level)
