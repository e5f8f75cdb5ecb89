"""The port's observability against the JAX package's, on the same sweeps.

Each drill of ``tests/test_obs.py`` (quarantine, SDC bit flip, transient
fault, precision escalation, interrupt then resume past a corrupted
ledger row) and a clean sweep run through JAX's and the port's
``run_table2_sweep`` with the journal and the trace on, on the CPU in
float64 at ``test_obs.py``'s size (``KW``, ``SMALL``, ``LOCKSTEP``).
They must agree on:

* the sequence of journal event types, with their ``cell``, ``bucket``,
  ``cells``, ``scenario``, ``attempt`` and ``recovered`` attributes (the
  timestamps, walls and run ids differ by nature);
* the set of metric names;
* the counters ``cells_total``, ``quarantined_cells_total``,
  ``quarantine_retries_total``, ``sdc_suspected_total`` and
  ``cert_failed_total`` exactly, ``inner_steps_total`` within 0.1 % (the
  port's summation order moves the distribution steps by up to 0.07 %,
  ROADMAP Queue 3 item 4);
* the multiset of span names in the exported trace.

And obs on against off moves no bit of the port's rows.  Each drill also
holds the one-typed-event contract of ``test_obs.py``.  The precision
escalation drill runs on one cell (its stalled descent takes ~45 000 EGM
steps a cell on the CPU).  The serve-side drills of ``test_obs.py``
(deadline, store eviction, serve certification) wait for the serving
tier (ROADMAP Queue 1 items 8b and 8c).
"""

import collections
import json
import warnings

import numpy as np
import pytest
import torch

import aiyagari_hark_tpu.obs as jobs
import aiyagari_hark_tpu.parallel.sweep as jsw
import aiyagari_hark_tpu.utils.config as jcfg
import aiyagari_hark_tpu.utils.resilience as jres
import aiyagari_hark_tpu.verify as jverify
import aiyagari_hark_tpu_torch.obs as tobs
import aiyagari_hark_tpu_torch.parallel.sweep as tsw
import aiyagari_hark_tpu_torch.utils.config as tcfg
import aiyagari_hark_tpu_torch.utils.resilience as tres
import aiyagari_hark_tpu_torch.verify as tverify

torch.set_num_threads(1)
KW = dict(a_count=12, dist_count=48, labor_states=4, r_tol=1e-5,
          max_bisect=30)
SMALL = dict(crra_values=(1.0, 5.0), rho_values=(0.0, 0.9),
             schedule="balanced", n_buckets=2)
LOCKSTEP = dict(crra_values=(1.0, 3.0), rho_values=(0.3, 0.6))
ONE_CELL = dict(crra_values=(1.0,), rho_values=(0.6,))
EVENT_ATTRS = ("cell", "bucket", "cells", "scenario", "attempt",
               "recovered")
EXACT_COUNTERS = ("cells_total", "quarantined_cells_total",
                  "quarantine_retries_total", "sdc_suspected_total",
                  "cert_failed_total")
PKG = {"jax": (jsw, jcfg, jobs, jres), "port": (tsw, tcfg, tobs, tres)}

# name -> (config fields, sweep kwargs, the drill's typed event and its
# attributes; None for the clean sweep)
DRILLS = {
    "clean": (SMALL, {}, None),
    "quarantine_fault": (
        SMALL, dict(inject_fault={"cell": 1, "at_iter": 1, "mode": "nan"},
                    max_retries=2),
        ("QUARANTINE", {"cell": 1, "recovered": True})),
    "sdc_bit_flip": (
        {**SMALL, "recheck_fraction": 1.0},
        dict(inject_sdc={"cell": 1, "bit": 30}, quarantine=False),
        ("SDC_SUSPECTED", {"cell": 1})),
    "transient_fault": (
        SMALL, dict(inject_transient={"at_call": 0, "times": 1},
                    retry="no_sleep"),
        ("RETRY_TRANSIENT", {"attempt": 1})),
    "precision_escalation": (
        ONE_CELL, dict(precision="mixed", descent_fault_iter=0,
                       descent_fault_mode="stall"),
        ("PRECISION_ESCALATED", {"cell": 0})),
}


def _run(pkg, fields, tmp, name, **kwargs):
    """One journaled, traced sweep of ``pkg``: (result, journal records,
    trace, metrics snapshot)."""
    sw, cfg, obs_mod, res_mod = PKG[pkg]
    jp, tp = str(tmp / f"{pkg}_{name}.jsonl"), str(tmp / f"{pkg}_{name}.json")
    if kwargs.get("retry") == "no_sleep":
        kwargs["retry"] = res_mod.RetryPolicy(sleep=lambda s: None)
    obs = obs_mod.build_obs(obs_mod.ObsConfig(
        enabled=True, journal_path=jp, trace_path=tp))
    extra = {"dtype": torch.float64, "device": "cpu"} if pkg == "port" \
        else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = sw.run_table2_sweep(cfg.SweepConfig(**fields), obs=obs,
                                  **extra, **{**KW, **kwargs})
    obs.close()
    with open(tp) as f:
        trace = json.load(f)
    return res, obs_mod.read_journal(jp), trace, obs.registry.snapshot()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs_parity")
    out = {}
    for name, (fields, kwargs, _) in DRILLS.items():
        for pkg in ("jax", "port"):
            out[pkg, name] = _run(pkg, fields, tmp, name, **dict(kwargs))
    return out


def _events(recs):
    return [(r["event"],) + tuple((k, r[k]) for k in EVENT_ATTRS if k in r)
            for r in recs]


def _spans(trace):
    return collections.Counter(e["name"] for e in trace["traceEvents"]
                               if e["ph"] == "X")


def _counter(snap, name):
    entry = snap.get(f"aiyagari_sweep_{name}")
    return None if entry is None else entry["value"]


@pytest.mark.parametrize("name", list(DRILLS))
def test_journal_events_match_jax(runs, name):
    _, jrecs, _, _ = runs["jax", name]
    _, precs, _, _ = runs["port", name]
    assert _events(precs) == _events(jrecs)


@pytest.mark.parametrize("name", list(DRILLS))
def test_metric_names_and_counters_match_jax(runs, name):
    jsnap, psnap = runs["jax", name][3], runs["port", name][3]
    assert set(psnap) == set(jsnap)
    for c in EXACT_COUNTERS:
        assert _counter(psnap, c) == _counter(jsnap, c), c
    j, p = (_counter(s, "inner_steps_total") for s in (jsnap, psnap))
    assert abs(p - j) <= 1e-3 * j


@pytest.mark.parametrize("name", list(DRILLS))
def test_span_names_match_jax(runs, name):
    assert _spans(runs["port", name][2]) == _spans(runs["jax", name][2])
    assert tobs.trace_nesting_ok(runs["port", name][2])


@pytest.mark.parametrize("name", [n for n, d in DRILLS.items() if d[2]])
def test_each_drill_yields_exactly_one_typed_event(runs, name):
    etype, attrs = DRILLS[name][2]
    _, recs, _, _ = runs["port", name]
    matches = [r for r in recs if r["event"] == etype]
    assert len(matches) == 1, (etype, recs)
    for k, v in attrs.items():
        assert matches[0][k] == v, (k, matches[0])
    assert len({r["run_id"] for r in recs}) == 1
    events = [r["event"] for r in recs]
    assert events[0] == "RUN_START" and events[-1] == "RUN_END"


def test_clean_sweep_journals_only_lifecycle_events(runs):
    res, recs, trace, _ = runs["port", "clean"]
    assert not np.isnan(res.r_star_pct).any()
    assert {r["event"] for r in recs} == {"RUN_START", "BUCKET_LAUNCH",
                                          "RUN_END"}
    cells = sorted(c for r in recs if r["event"] == "BUCKET_LAUNCH"
                   for c in r["cells"])
    assert cells == list(range(4))
    names = set(_spans(trace))
    assert {"sweep/run", "sweep/bucket", "sweep/phase/polish"} <= names


def test_obs_on_and_off_give_the_same_rows(runs):
    """The journaled, traced run against ObsConfig(enabled=False) on the
    config: every row bitwise (obs=None, the default, is the resume
    test's clean run below)."""
    on = runs["port", "clean"][0]
    off = tsw.run_table2_sweep(
        tcfg.SweepConfig(**SMALL, obs=tobs.ObsConfig(enabled=False)),
        dtype=torch.float64, device="cpu", **KW)
    for f in ("r_star_pct", "saving_rate_pct", "capital", "excess",
              "bisect_iters", "egm_iters", "dist_iters", "status",
              "retries", "bucket", "descent_steps", "polish_steps",
              "precision_escalations"):
        a, b = np.asarray(getattr(on, f)), np.asarray(getattr(off, f))
        assert a.tobytes() == b.tobytes(), f


def _interrupt_resume(pkg, tmp):
    """The resilience seams end to end: an injected preemption, a ledger
    row corrupted, the resume.  Returns (first run's records, the
    resumed run's records, the resumed result)."""
    sw, cfg, obs_mod, res_mod = PKG[pkg]
    ledger, jp = str(tmp / f"{pkg}_ledger.npz"), str(tmp / f"{pkg}_ev.jsonl")
    extra = {"dtype": torch.float64, "device": "cpu"} if pkg == "port" \
        else {}
    try:
        with pytest.raises(res_mod.Interrupted):
            sw.run_table2_sweep(
                cfg.SweepConfig(**LOCKSTEP), resume_path=ledger,
                obs=obs_mod.ObsConfig(enabled=True, journal_path=jp),
                inject_preempt={"after_bucket": 0, "mode": "flag"},
                **extra, **KW)
    finally:
        res_mod.clear_interrupt()
    first = obs_mod.read_journal(jp)
    (jverify if pkg == "jax" else tverify).corrupt_ledger_row(
        ledger, cell=1, bit=21)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        resumed = sw.run_table2_sweep(
            cfg.SweepConfig(**LOCKSTEP), resume_path=ledger,
            obs=obs_mod.ObsConfig(enabled=True, journal_path=jp),
            **extra, **KW)
    run1 = first[0]["run_id"]
    second = [r for r in obs_mod.read_journal(jp) if r["run_id"] != run1]
    return first, second, resumed


def test_interrupt_resume_and_ledger_corruption_events(tmp_path):
    jfirst, jsecond, _ = _interrupt_resume("jax", tmp_path)
    first, second, resumed = _interrupt_resume("port", tmp_path)
    assert _events(first) == _events(jfirst)
    assert _events(second) == _events(jsecond)
    ints = [r for r in first if r["event"] == "INTERRUPTED"]
    assert len(ints) == 1 and ints[0]["resume_path"] == str(
        tmp_path / "port_ledger.npz")
    assert first[-1]["event"] == "RUN_END"     # the owned bundle closed
    integ = [r for r in second if r["event"] == "INTEGRITY_FAILED"]
    assert len(integ) == 1
    assert integ[0]["boundary"] == "ledger" and integ[0]["cells"] == [1]
    restores = [r for r in second if r["event"] == "RESUME_RESTORE"]
    assert len(restores) == 1 and restores[0]["corrupt_cells"] == [1]
    assert restores[0]["cells_restored"] >= 1
    # the recomputed result is the uninterrupted run's, bit for bit
    clean = tsw.run_table2_sweep(tcfg.SweepConfig(**LOCKSTEP),
                                 dtype=torch.float64, device="cpu", **KW)
    assert clean.r_star_pct.tobytes() == resumed.r_star_pct.tobytes()
    assert clean.status.tolist() == resumed.status.tolist()
