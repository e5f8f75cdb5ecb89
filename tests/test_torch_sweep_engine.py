"""The port's sweep engine against the JAX engine, on the CPU in f64.

The size is the JAX scheduler tests' (``tests/test_sweep_scheduler.py``):
``a_count=12, dist_count=48, labor_states=4, r_tol=1e-5, max_bisect=30``.
Host-side pieces (``SweepConfig``, fingerprints, the work model, the
bucket plan, dyadic brackets, neighbour seeds, the retry rungs) must equal
JAX's exactly.  Sweeps: the locked schedule against JAX (statuses and
bisection trips equal, r* within ``r_tol``); the balanced schedule against
the port's locked one, bitwise; warm brackets against locked as the JAX
suite holds them (r* and status bitwise, capital to 1e-6) and against
JAX's own warm sweep (the same trips and work); quarantine recovering an
injected cell with the others bitwise unchanged.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import aiyagari_hark_tpu.obs as jobs
import aiyagari_hark_tpu.parallel.sweep as jsw
import aiyagari_hark_tpu.utils.config as jcfg
import aiyagari_hark_tpu.utils.fingerprint as jfp
import aiyagari_hark_tpu_torch.obs as tobs
import aiyagari_hark_tpu_torch.parallel.sweep as tsw
import aiyagari_hark_tpu_torch.utils.config as tcfg
import aiyagari_hark_tpu_torch.utils.fingerprint as tfp
from aiyagari_hark_tpu.scenarios.aiyagari import \
    AIYAGARI_SCHEMA as JAX_SCHEMA
from aiyagari_hark_tpu_torch import scenarios as tscn
from aiyagari_hark_tpu_torch.carry import sweep_config_from_fields
from aiyagari_hark_tpu_torch.scenarios.aiyagari import AIYAGARI_SCHEMA
from aiyagari_hark_tpu_torch.solver_health import MAX_ITER

torch.set_num_threads(1)
F64 = torch.float64
KW = dict(a_count=12, dist_count=48, labor_states=4, r_tol=1e-5,
          max_bisect=30)
TWO_PANEL = dict(crra_values=(1.0, 5.0), rho_values=(0.0, 0.9),
                 labor_sd=(0.2, 0.4))
SMALL = dict(crra_values=(1.0, 3.0), rho_values=(0.3, 0.6))


def _port(sweep=None, **kw):
    return tsw.run_table2_sweep(sweep or tcfg.SweepConfig(**TWO_PANEL),
                                dtype=F64, device="cpu", **kw, **KW)


def _jax(sweep=None, **kw):
    return jsw.run_table2_sweep(sweep or jcfg.SweepConfig(**TWO_PANEL),
                                **kw, **KW)


# -- host-side pieces, against JAX -------------------------------------------

def test_sweep_config_fields_defaults_and_cells_match_jax():
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.SweepConfig)]
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.SweepConfig)]
    assert len(tf) == 17 and tf == jf
    for kw in ({}, TWO_PANEL, SMALL, dict(labor_sd=[0.2, 0.4])):
        t, j = tcfg.SweepConfig(**kw), jcfg.SweepConfig(**kw)
        assert t.cells() == j.cells() and t.sd_values() == j.sd_values()
        assert sweep_config_from_fields(dataclasses.asdict(j)) == t
        # the same fields hash alike
        assert tfp.config_fingerprint(t) == jfp.config_fingerprint(j)
    assert tcfg.SweepConfig().replace(n_buckets=3).n_buckets == 3
    # a JAX ObsConfig's fields carry into the port's ObsConfig
    jobs_cfg = jobs.ObsConfig(enabled=True, journal_path="j.jsonl",
                              profile=True, flight_limit=8)
    carried = sweep_config_from_fields(dataclasses.asdict(
        jcfg.SweepConfig(obs=jobs_cfg)))
    assert isinstance(carried.obs, tobs.ObsConfig)
    assert dataclasses.asdict(carried.obs) == dataclasses.asdict(jobs_cfg)


def test_packed_row_layout_and_state_policies_match_jax():
    assert tcfg.PACKED_ROW_FIELDS == jcfg.PACKED_ROW_FIELDS
    assert tcfg.PACKED_ROW_WIDTH == jcfg.PACKED_ROW_WIDTH == 10
    assert tcfg.STATE_POLICIES == jcfg.STATE_POLICIES
    for p in jcfg.STATE_POLICIES:
        assert tcfg.resolve_state(p).sharded == jcfg.resolve_state(p).sharded
    with pytest.raises(ValueError, match="state policy"):
        tcfg.resolve_state("diagonal")
    assert AIYAGARI_SCHEMA.fields == JAX_SCHEMA.fields
    assert AIYAGARI_SCHEMA.checksum() == JAX_SCHEMA.checksum()


@pytest.mark.parametrize("kwargs", [
    {}, dict(KW), dict(KW, precision="reference", grid="reference",
                       kernel="reference", state="replicated"),
    dict(KW, precision="mixed", grid="compact", kernel="fused"),
    dict(a_count=[1, 2], disc_fac=np.float64(0.95), bracket_pad=10.0,
         root_method="bisect", accel_every=0)])
def test_hashable_kwargs_and_fingerprints_match_jax(kwargs):
    items = tfp.hashable_kwargs(kwargs)
    assert items == jfp.hashable_kwargs(kwargs)
    for tdt, jdt in ((F64, np.float64), (torch.float32, np.float32)):
        assert str(tfp.canonical_dtype(tdt)) == str(np.dtype(jdt))
        for scn in ("aiyagari", "huggett"):
            assert (tfp.work_fingerprint(items, tdt, scenario=scn)
                    == jfp.work_fingerprint(items, jdt, scenario=scn))
            for cell in ((1.0, 0.3, 0.2), (5.0, 0.9, 0.4)):
                assert (tfp.solution_fingerprint(*cell, items, tdt,
                                                 scenario=scn)
                        == jfp.solution_fingerprint(*cell, items, jdt,
                                                    scenario=scn))


def test_hashable_kwargs_rejects_what_jax_rejects():
    for bad, err in ((dict(precision="half"), ValueError),
                     (dict(state="diagonal"), ValueError),
                     (dict(a_count=np.zeros((2, 2))), TypeError),
                     (dict(a_count={"x": 1}), TypeError)):
        with pytest.raises(err):
            tfp.hashable_kwargs(bad)
        with pytest.raises(err):
            jfp.hashable_kwargs(bad)


def test_work_model_and_bucket_plan_match_jax():
    cells = np.asarray([(s, r, sd) for s in (1.0, 3.0, 5.0)
                        for r in (0.0, 0.3, 0.6, 0.9) for sd in (0.2, 0.4)])
    assert np.array_equal(tsw.heuristic_cell_work(cells),
                          jsw.heuristic_cell_work(cells))
    for n in (1, 4, 8, 10, 12, 24, 30):
        order = np.argsort(tsw.heuristic_cell_work(cells[:n]),
                           kind="stable")
        for nb in (0, 1, 2, 3, 5, 8):
            tb, ts = tsw._plan_buckets(order, nb)
            jb, js = jsw._plan_buckets(order, nb)
            assert ts == js and len(tb) == len(jb)
            assert all(np.array_equal(a, b) for a, b in zip(tb, jb))


@pytest.mark.parametrize("tdt,jdt", [(F64, np.float64),
                                     (torch.float32, np.float32)])
def test_dyadic_bracket_is_jaxs_and_replays_the_solvers_midpoints(tdt, jdt):
    import aiyagari_hark_tpu_torch.models.equilibrium as te
    from aiyagari_hark_tpu_torch.models.household import build_simple_model

    for kw in ({}, dict(disc_fac=0.95, depr_fac=0.1, bracket_pad=10.0)):
        lo, hi = tsw._host_bracket(kw, tdt)
        assert (lo, hi) == jsw._host_bracket(kw, jdt)
        assert type(lo) is np.dtype(jdt).type
        # the solver's own endpoints, cast once to the dtype
        model = build_simple_model(labor_states=3, a_count=6, dist_count=8,
                                   dtype=tdt, device="cpu")
        *_, r_lo, r_hi = te._bisection_setup(
            model, kw.get("disc_fac", 0.96), kw.get("depr_fac", 0.08),
            None, None, None, kw.get("bracket_pad", 1.0))
        assert torch.tensor(r_lo, dtype=tdt).item() == float(lo)
        assert torch.tensor(r_hi, dtype=tdt).item() == float(hi)
        assert tsw._host_r_tol(kw, tdt) == jsw._host_r_tol(kw, jdt)
        for target, margin in ((0.0299, 1e-4), (0.04, 1e-6),
                               (-0.05, 3e-3), (0.0, 0.2)):
            got = tsw.dyadic_bracket(lo, hi, target, margin, 40, tdt)
            assert got == jsw.dyadic_bracket(lo, hi, target, margin, 40,
                                             jdt)
            # torch's halving (the solver's mid = 0.5 (lo + hi)) reaches
            # the same endpoints
            clo, chi = (torch.tensor(float(v), dtype=tdt) for v in (lo, hi))
            for _ in range(got[2]):
                mid = 0.5 * (clo + chi)
                if target + margin < float(mid):
                    chi = mid
                else:
                    clo = mid
            assert (clo.item(), chi.item()) == (float(got[0]),
                                                float(got[1]))
    assert tsw._host_r_tol({}, F64) == 1e-10
    assert tsw._host_r_tol({}, torch.float32) == 1e-6


def test_neighbor_distance_and_seed_match_jax():
    cells = np.asarray(tcfg.SweepConfig(**TWO_PANEL).cells())
    r = np.linspace(0.03, 0.04, len(cells))
    assert tsw.NEIGHBOR_CELL_SCALE == jsw.NEIGHBOR_CELL_SCALE
    for i, cell in enumerate(cells):
        assert np.array_equal(tsw.neighbor_distance(cell, cells),
                              jsw.neighbor_distance(cell, cells))
        for ok in (np.zeros(8, bool), np.arange(8) < 3, np.arange(8) != i):
            for wm in (0.0, 1e-4):
                assert (tsw._neighbor_seed(cell, cells, r, ok, 0.12, 1e-5,
                                           wm)
                        == jsw._neighbor_seed(cell, cells, r, ok, 0.12,
                                              1e-5, wm))
    for spread in (None, 0.0, 0.01):
        assert (tsw.donor_margin(spread, 0.12, 1e-5)
                == jsw.donor_margin(spread, 0.12, 1e-5))


@pytest.mark.parametrize("kwargs", [
    {}, dict(precision="mixed"), dict(grid="compact"), dict(kernel="fused"),
    dict(precision="fast", grid="adaptive", kernel="fused")])
def test_retry_rungs_are_jaxs_without_the_engine_keys(kwargs):
    """The same rungs in the same order, less ``dist_method`` and
    ``egm_method`` (the port has one engine of each loop)."""
    jax_rungs = [{k: v for k, v in r.items()
                  if k not in ("dist_method", "egm_method")}
                 for r in jsw._retry_ladder(kwargs)]
    assert list(tsw._retry_ladder(kwargs)) == jax_rungs
    assert list(tscn.get_scenario("aiyagari").retry_rungs(kwargs)) == \
        jax_rungs
    assert len(jax_rungs) == 3


def test_the_registry_holds_the_jax_builtins():
    assert tscn.scenario_names() == ("aiyagari", "epstein_zin", "huggett")
    scn = tscn.get_scenario("aiyagari")
    assert tscn.get_scenario(scn) is scn and scn.warm_mode == "bracket"
    assert tscn.get_scenario("huggett").warm_mode == "bracket"
    assert tscn.get_scenario("epstein_zin").warm_mode == "cold-only"
    with pytest.raises(tscn.UnknownScenarioError, match="bewley"):
        tscn.get_scenario("bewley")
    with pytest.raises(tscn.DuplicateScenarioError):
        tscn.register(scn)
    assert scn.prepare_kwargs({}) == {
        "kernel": "reference", "egm_engine": "egm_policy_grid",
        "dist_engine": "stationary_lottery_grid"}
    fused = {"kernel": "fused"}
    assert scn.prepare_kwargs(fused)["dist_engine"] == "fused_cell_grid"
    assert fused == {"kernel": "fused"}      # no engine keys invented
    assert scn.prepare_kwargs({"kernel": "fused", "precision": "mixed"})[
        "egm_engine"] == "egm_policy_grid"


# -- sweeps ------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_locked_config():
    return jcfg.SweepConfig(schedule="locked", **TWO_PANEL)


@pytest.fixture(scope="module")
def locked(jax_locked_config):
    """The port's locked sweep of the JAX configuration, carried over."""
    return _port(sweep_config_from_fields(
        dataclasses.asdict(jax_locked_config)))


@pytest.fixture(scope="module")
def jax_locked(jax_locked_config):
    return _jax(jax_locked_config)


def test_locked_sweep_matches_jax(locked, jax_locked):
    assert locked.bucket is None and locked.status.tolist() == [0] * 8
    assert np.array_equal(locked.status, jax_locked.status)
    assert np.array_equal(locked.bisect_iters, jax_locked.bisect_iters)
    assert np.array_equal(locked.egm_iters, jax_locked.egm_iters)
    np.testing.assert_allclose(locked.r_star_pct, jax_locked.r_star_pct,
                               rtol=0, atol=100 * KW["r_tol"])
    np.testing.assert_allclose(locked.capital, jax_locked.capital,
                               rtol=1e-6)
    assert np.array_equal(locked.crra, jax_locked.crra)
    assert np.array_equal(locked.labor_sd, jax_locked.labor_sd)
    assert locked.retries.tolist() == [0] * 8
    assert locked.sdc_suspected is None and locked.cert_level is None
    assert locked.device == "cpu" and locked.wall_seconds > 0.0
    assert locked.scheduled_iteration_skew() == locked.iteration_skew() > 1


def test_balanced_sweep_is_bitwise_the_locked_one(locked):
    """"auto" takes "balanced" on the CPU for 8 cells; the buckets
    un-permute to the locked rows bit for bit."""
    walls = []
    bal = _port(tcfg.SweepConfig(**TWO_PANEL), timer=walls.append)
    assert bal.bucket is not None and len(np.unique(bal.bucket)) == 2
    assert walls == [bal.wall_seconds]
    for f in ("r_star_pct", "capital", "saving_rate_pct", "status",
              "bisect_iters", "egm_iters", "dist_iters", "descent_steps",
              "polish_steps"):
        a, b = getattr(bal, f), getattr(locked, f)
        assert np.array_equal(np.isnan(a.astype(float)),
                              np.isnan(b.astype(float)))
        assert a.tobytes() == b.tobytes(), f
    np.testing.assert_array_equal(
        bal.predicted_work,
        tsw.heuristic_cell_work(np.asarray(
            tcfg.SweepConfig(**TWO_PANEL).cells())))
    assert bal.scheduled_iteration_skew() <= bal.iteration_skew()


def test_run_sweep_solves_a_cell_alone_as_in_its_batch(locked):
    """The generic engine on one cell of the lattice: its own launch
    (C=1) gives the row the cell had as a lane of the locked sweep."""
    cell = tcfg.SweepConfig(**TWO_PANEL).cells()[5]
    res = tsw.run_sweep("aiyagari", cells=[cell], dtype=F64, device="cpu",
                        **KW)
    assert res.scenario == "aiyagari" and res.rows.shape == (1, 10)
    assert res.col("r_star")[0] * 100.0 == locked.r_star_pct[5]
    assert res.col("capital")[0] == locked.capital[5]
    for f in ("bisect_iters", "egm_iters", "dist_iters"):
        assert res.icol(f)[0] == getattr(locked, f)[5]
    assert res.methods["dist_engine"] == "stationary_lottery_grid"


def test_warm_brackets_keep_the_locked_bits_and_jaxs_work(locked):
    """Warm brackets seeded by solved neighbours: r* and status bitwise
    the locked sweep's, capital to 1e-6 (as the JAX suite holds them);
    the trips and the work JAX's own warm sweep takes, and no more work
    than the locked sweep.  (The JAX suite's <= 0.80x work comes from
    sidecar seeds of the same cells, which the port does not have.)"""
    cfg = dict(TWO_PANEL, schedule="balanced", n_buckets=4,
               warm_brackets=True)
    warm = _port(tcfg.SweepConfig(**cfg))
    assert np.array_equal(warm.r_star_pct, locked.r_star_pct)
    assert np.array_equal(warm.status, locked.status)
    np.testing.assert_allclose(warm.capital, locked.capital, rtol=1e-6)
    jwarm = _jax(jcfg.SweepConfig(**cfg))
    assert np.array_equal(warm.bisect_iters, jwarm.bisect_iters)
    assert np.array_equal(warm.egm_iters, jwarm.egm_iters)
    assert np.array_equal(warm.bucket, jwarm.bucket)
    assert int(warm.total_work().sum()) <= int(locked.total_work().sum())
    first = warm.bucket == 0
    assert np.array_equal(warm.bisect_iters[first],
                          locked.bisect_iters[first])    # cold bucket
    assert (warm.bisect_iters[~first] != locked.bisect_iters[~first]).any()


@pytest.fixture(scope="module")
def small_clean():
    return _port(tcfg.SweepConfig(**SMALL))


def test_quarantine_recovers_an_injected_nan_cell(small_clean):
    fault = {"cell": 2, "at_iter": 1, "mode": "nan"}
    res = _port(tcfg.SweepConfig(**SMALL), inject_fault=fault)
    jres = _jax(jcfg.SweepConfig(**SMALL), inject_fault=fault)
    assert res.retries.tolist() == jres.retries.tolist() == [0, 0, 1, 0]
    assert res.status.tolist() == jres.status.tolist() == [0] * 4
    others = [0, 1, 3]
    for f in ("r_star_pct", "capital", "bisect_iters", "egm_iters",
              "dist_iters"):
        assert np.array_equal(getattr(res, f)[others],
                              getattr(small_clean, f)[others]), f
    # the recovered cell is the first rung's serial solve, by bisection as
    # the clean lane: the same bits
    assert res.r_star_pct[2] == small_clean.r_star_pct[2]
    assert res.dist_iters[2] == small_clean.dist_iters[2]
    assert abs(res.r_star_pct[2] - jres.r_star_pct[2]) <= 100 * KW["r_tol"]
    assert res.bisect_iters[2] == jres.bisect_iters[2]


def test_stall_without_retries_ends_max_iter_nan_masked():
    fault = {"cell": 2, "at_iter": 2, "mode": "stall"}
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = _port(tcfg.SweepConfig(**SMALL), inject_fault=fault,
                    max_retries=0)
    assert any("failed every quarantine retry" in str(x.message) for x in w)
    jres = _jax(jcfg.SweepConfig(**SMALL), inject_fault=fault,
                max_retries=0)
    assert res.status.tolist() == jres.status.tolist()
    assert res.status[2] == MAX_ITER and res.retries.tolist() == [0] * 4
    assert res.failed_cells().tolist() == [2]
    assert np.isnan(res.r_star_pct[2]) and np.isnan(res.capital[2])
    assert np.isnan(jres.r_star_pct[2])
    assert res.bisect_iters[2] == jres.bisect_iters[2] == KW["max_bisect"]
    assert np.isfinite(res.r_star_pct[[0, 1, 3]]).all()


# -- what is not ported raises ------------------------------------------------

@pytest.mark.parametrize("sweep_kw,call_kw,item", [
    ({}, dict(mesh="auto"), "item 6"),
    (dict(state_shards=2), {}, "item 6")])
def test_unported_knobs_raise_naming_their_roadmap_item(sweep_kw, call_kw,
                                                        item):
    with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
        tsw.run_table2_sweep(tcfg.SweepConfig(**SMALL, **sweep_kw),
                             dtype=F64, device="cpu", **call_kw, **KW)


def test_bad_knobs_and_no_card_raise(monkeypatch):
    with pytest.raises(ValueError, match="schedule"):
        _port(tcfg.SweepConfig(schedule="eager", **SMALL))
    with pytest.raises(ValueError, match="work_model"):
        _port(tcfg.SweepConfig(work_model="oracle", **SMALL))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tsw.run_table2_sweep(**KW),
                 lambda: tsw.run_sweep("aiyagari", **KW),
                 lambda: tsw.run_sweep("huggett", **KW),
                 lambda: tsw.run_sweep("epstein_zin", ez_rho=3.0, **KW)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
