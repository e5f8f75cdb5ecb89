"""The port's observability layer (``aiyagari_hark_tpu_torch.obs``) on the
CPU: the counterparts of ``tests/test_obs.py``'s tracer, registry,
journal and runtime tests, of ``tests/test_profile.py``'s ledger,
roofline, telemetry, flight-recorder and FLOP tests (the XLA capture test
replaced by the kernels' work model), and of ``tests/test_regress.py``.

Where a function is pure (``classify_roofline``, ``trace_nesting_ok``,
the Chrome-trace layout, Prometheus text, the journal's line layout,
``model_flops``, ``evaluate_history``, ``flatten_record``,
``direction_of_goodness``) the same inputs go through both packages and
the outputs must be equal.  The sweep drills, held against the JAX
package's events, are in ``tests/test_torch_obs_parity.py``; the serve
drills wait for the serving tier.
"""

import dataclasses
import json
import os
import threading
import warnings

import numpy as np
import pytest
import torch

import aiyagari_hark_tpu.obs as jobs
import aiyagari_hark_tpu.obs.profile as jprof
import aiyagari_hark_tpu.obs.regress as jreg
import aiyagari_hark_tpu.utils.timing as jtiming
import aiyagari_hark_tpu_torch.obs as tobs
import aiyagari_hark_tpu_torch.obs.profile as tprof
import aiyagari_hark_tpu_torch.obs.regress as treg
import aiyagari_hark_tpu_torch.utils.timing as ttiming
from aiyagari_hark_tpu_torch.obs import (EVENT_TYPES, NULL_OBS, NULL_SPAN_CM,
                                         EventJournal, MetricsRegistry,
                                         ObsConfig, Tracer, build_obs,
                                         default_registry, emit_event,
                                         new_run_id, read_journal,
                                         reset_default_registry, resolve_obs,
                                         trace_nesting_ok)
from aiyagari_hark_tpu_torch.parallel.sweep import run_table2_sweep
from aiyagari_hark_tpu_torch.utils.config import SweepConfig

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
KW = dict(a_count=12, dist_count=48, labor_states=4, r_tol=1e-5,
          max_bisect=30)
SMALL = SweepConfig(crra_values=(1.0, 5.0), rho_values=(0.0, 0.9),
                    schedule="balanced", n_buckets=2)
LOCKSTEP = SweepConfig(crra_values=(1.0, 3.0), rho_values=(0.3, 0.6))
DRILL_KW = dict(a_count=10, dist_count=32, labor_states=3, r_tol=1e-5,
                max_bisect=24)
H100 = (34e12, 3.35e12)            # FP64 peak, HBM3 bytes/s


def _sweep(sweep, **kw):
    return run_table2_sweep(sweep, dtype=F64, device="cpu", **kw)


class _Clock:
    """A deterministic clock: 0, 1, 2, ... seconds per read."""

    def __init__(self):
        self.t = -1.0

    def __call__(self):
        self.t += 1.0
        return self.t


# ---------------------------------------------------------------------------
# The tracer.
# ---------------------------------------------------------------------------

def test_new_run_id_sortable_and_unique():
    a, b = new_run_id(), new_run_id()
    assert a != b and a.startswith("run-")
    assert all(c.isalnum() or c == "-" for c in a)


def test_tracer_nested_spans_export_chrome_trace():
    tr = Tracer(run_id="run-test")
    with tr.span("outer", cells=4) as sp:
        sp.annotate(extra="x")
        with tr.span("inner"):
            pass
    trace = tr.chrome_trace()
    events = trace["traceEvents"]
    assert {e["name"] for e in events} == {"outer", "inner"}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert all(e["args"]["run_id"] == "run-test" for e in events)
    assert trace["metadata"]["run_id"] == "run-test"
    outer = next(e for e in events if e["name"] == "outer")
    assert outer["args"]["cells"] == 4 and outer["args"]["extra"] == "x"
    assert trace_nesting_ok(trace)


def test_span_subdivide_materializes_synthetic_children():
    tr = Tracer()
    with tr.span("bucket") as sp:
        pass
    sp.subdivide({"descent": 3.0, "polish": 1.0, "zero": 0.0},
                 prefix="phase/")
    events = tr.chrome_trace()["traceEvents"]
    names = [e["name"] for e in events]
    assert "phase/descent" in names and "phase/polish" in names
    assert "phase/zero" not in names
    parent = next(e for e in events if e["name"] == "bucket")
    kids = [e for e in events if e["name"].startswith("phase/")]
    assert all(e["args"]["synthetic"] for e in kids)
    for e in kids:
        assert e["ts"] >= parent["ts"] - 1e-6
        assert e["ts"] + e["dur"] <= parent["ts"] + parent["dur"] + 1e-6
    assert trace_nesting_ok(tr.chrome_trace())


def test_tracer_is_thread_safe_with_per_thread_rows():
    tr = Tracer()
    gate = threading.Barrier(4)

    def work():
        with tr.span("t"):
            with tr.span("u"):
                gate.wait(timeout=10)

    threads = [threading.Thread(target=work) for _ in range(4)]
    with tr.span("main"):
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    trace = tr.chrome_trace()
    assert len(trace["traceEvents"]) == 9
    assert len({e["tid"] for e in trace["traceEvents"]}) == 5
    assert trace_nesting_ok(trace)


def _drive_tracer(mod):
    tr = mod.Tracer(run_id="run-same", clock=_Clock())
    with tr.span("run", cells=4, warm=False) as sp:
        with tr.span("bucket", bucket=0) as b:
            pass
        b.subdivide({"descent": 1.0, "polish": 3.0}, prefix="phase/")
        tr.counter("profile/x/launch_wall_s", value=0.5)
        tr.record("external", 0.25, query=[3.0, 0.6])
        sp.annotate(wall_s=1.5, arr=np.asarray([1.0, 2.0]))
    return tr.chrome_trace()


def test_chrome_trace_layout_matches_jax():
    """The same spans, counters and external records on the same clock
    export the same Chrome trace in both packages."""
    port, jax_ = _drive_tracer(tobs), _drive_tracer(jobs)
    assert port == jax_
    assert {e["ph"] for e in port["traceEvents"]} == {"X", "C", "b", "e"}


@pytest.mark.parametrize("events", [
    [{"name": "a", "ph": "X", "ts": 0.0, "dur": 10.0, "tid": 0},
     {"name": "b", "ph": "X", "ts": 5.0, "dur": 10.0, "tid": 0}],
    [{"name": "a", "ph": "X", "ts": 0.0, "dur": -1.0, "tid": 0}],
    [{"name": "a", "ph": "X", "ts": 0.0, "dur": 10.0, "tid": 0},
     {"name": "b", "ph": "X", "ts": 0.0, "dur": 10.0, "tid": 0},
     {"name": "c", "ph": "X", "ts": 2.0, "dur": 3.0, "tid": 0}],
    [{"name": "a", "ph": "X", "ts": 0.0, "dur": 10.0, "tid": 0},
     {"name": "b", "ph": "X", "ts": 5.0, "dur": 10.0, "tid": 1},
     {"name": "x", "ph": "b", "ts": 1.0, "tid": 0}],
], ids=["overlap", "negative", "nested", "two_rows"])
def test_trace_nesting_ok_matches_jax(events):
    trace = {"traceEvents": events}
    assert trace_nesting_ok(trace) == jobs.trace_nesting_ok(trace)


def test_save_chrome_trace_is_atomic_and_loadable(tmp_path):
    tr = Tracer()
    with tr.span("a"):
        pass
    path = str(tmp_path / "trace.json")
    tr.save_chrome_trace(path)
    with open(path) as f:
        assert len(json.load(f)["traceEvents"]) == 1
    assert not list(tmp_path.glob("*.tmp"))


def test_device_profile_span_writes_one_profiler_trace(tmp_path):
    """A device_profile span runs under torch.profiler and exports a
    Chrome trace; a nested one does not start a second profiler."""
    d = str(tmp_path / "dev")
    tr = Tracer(device_trace_dir=d)
    with tr.span("outer", device_profile=True) as sp:
        with tr.span("inner", device_profile=True):
            torch.ones(4).sum()
    files = os.listdir(d)
    assert len(files) == 1 and files[0].startswith("device_trace_")
    with open(os.path.join(d, files[0])) as f:
        assert "traceEvents" in json.load(f)
    assert sp.attrs["device_trace_dir"] == d
    with tr.span("no_dir_no_profile"):
        pass
    assert len(os.listdir(d)) == 1


# ---------------------------------------------------------------------------
# The metrics registry.
# ---------------------------------------------------------------------------

def test_registry_instruments_record_and_type_check():
    reg = MetricsRegistry()
    c = reg.counter("aiyagari_test_total", "help text")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1.0)
    g = reg.gauge("aiyagari_test_depth")
    g.set(7.0)
    g.inc(-2.0)
    assert g.value == 5.0
    h = reg.histogram("aiyagari_test_seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    assert h.count == 3 and h.sum == pytest.approx(5.55)
    assert h.cumulative_counts() == [1, 2, 3]
    assert reg.counter("aiyagari_test_total") is c
    with pytest.raises(ValueError):
        reg.gauge("aiyagari_test_total")
    with pytest.raises(ValueError):
        reg.counter("bad name!")


def _fill(reg):
    reg.counter("aiyagari_events_total", "events").inc(4)
    reg.gauge("aiyagari_wall_seconds").set(1.25)
    h = reg.histogram("aiyagari_lat_seconds", buckets=(0.001, 0.1))
    h.observe(0.0005)
    h.observe(0.05)
    return reg


def test_registry_snapshot_roundtrip_and_prometheus_text_match_jax():
    reg = _fill(MetricsRegistry())
    snap = reg.snapshot()
    assert MetricsRegistry.restore(snap).snapshot() == snap
    jreg_ = _fill(jobs.MetricsRegistry())
    assert snap == jreg_.snapshot()
    assert reg.prometheus_text() == jreg_.prometheus_text()
    text = reg.prometheus_text()
    assert "# TYPE aiyagari_events_total counter" in text
    assert 'aiyagari_lat_seconds_bucket{le="+Inf"} 2' in text
    # a snapshot of either package restores in the other
    assert jobs.MetricsRegistry.restore(snap).snapshot() == snap


def test_default_registry_is_process_global_and_resettable():
    reset_default_registry()
    try:
        a = default_registry()
        assert default_registry() is a
        reset_default_registry()
        assert default_registry() is not a
    finally:
        reset_default_registry()


# ---------------------------------------------------------------------------
# The event journal.
# ---------------------------------------------------------------------------

def test_journal_lines_match_jax(tmp_path):
    """Typed lines, filtered reads, and JAX's line layout byte for byte."""
    paths = {}
    for name, mod in (("port", tobs), ("jax", jobs)):
        path = paths[name] = str(tmp_path / f"{name}.jsonl")
        j = mod.EventJournal(path, "run-a", clock=lambda: 12.0)
        j.emit("QUARANTINE", cell=3, crra=5.0, cells=np.asarray([1, 2]),
               attrs={"k": (1, 2)})
        j.emit("BUCKET_LAUNCH", bucket=0)
        mod.EventJournal(path, "run-b", clock=lambda: 13.0).emit(
            "QUARANTINE", cell=1)
        assert j.emitted == 2
    with open(paths["port"]) as a, open(paths["jax"]) as b:
        assert a.read() == b.read()
    mine = read_journal(paths["port"], run_id="run-a")
    assert [r["event"] for r in mine] == ["QUARANTINE", "BUCKET_LAUNCH"]
    assert mine[0] == {"ts": 12.0, "run_id": "run-a", "event": "QUARANTINE",
                       "cell": 3, "crra": 5.0, "cells": [1, 2],
                       "attrs": {"k": [1, 2]}}
    q = read_journal(paths["port"], event="QUARANTINE")
    assert {r["run_id"] for r in q} == {"run-a", "run-b"}


def test_journal_vocabulary_is_jax_and_closed(tmp_path):
    assert EVENT_TYPES == jobs.EVENT_TYPES
    j = EventJournal(str(tmp_path / "e.jsonl"), "run-x")
    with pytest.raises(ValueError, match="unknown journal event type"):
        j.emit("TOTALLY_NEW_THING")


def test_journal_torn_tail_skipped_with_warning(tmp_path):
    path = str(tmp_path / "e.jsonl")
    EventJournal(path, "run-a").emit("RUN_START")
    with open(path, "ab") as f:  # atomic-ok: test simulates the torn tail
        f.write(b'{"ts": 1, "run_id": "run-a", "event": "RUN_')
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        recs = read_journal(path)
    assert [r["event"] for r in recs] == ["RUN_START"]
    assert any("unparseable" in str(x.message) for x in w)
    assert read_journal(str(tmp_path / "missing.jsonl")) == []


def test_injected_disk_fault_journals_once_and_raises(tmp_path):
    """The writers' injection hook journals DISK_FAULT into the active
    scope (the journal's own append is not re-faulted), then raises."""
    from aiyagari_hark_tpu_torch.utils.checkpoint import (
        arm_disk_fault, atomic_write_json, disarm_disk_faults)

    jp = str(tmp_path / "j.jsonl")
    obs = build_obs(ObsConfig(enabled=True, journal_path=jp))
    arm_disk_fault("append_jsonl", kind="ENOSPC", count=1)
    arm_disk_fault("atomic_write_json", kind="EIO", count=1)
    try:
        with obs.activate():
            with pytest.raises(OSError):
                atomic_write_json(str(tmp_path / "x.json"), {"a": 1})
    finally:
        disarm_disk_faults()
    obs.close()
    faults = read_journal(jp, event="DISK_FAULT")
    assert len(faults) == 1
    assert faults[0]["op"] == "atomic_write_json"
    assert faults[0]["kind"] == "EIO" and faults[0]["injected"] is True


# ---------------------------------------------------------------------------
# The runtime bundle.
# ---------------------------------------------------------------------------

def test_obs_config_fields_match_jax():
    t = [(f.name, f.default) for f in dataclasses.fields(ObsConfig)]
    j = [(f.name, f.default) for f in dataclasses.fields(jobs.ObsConfig)]
    assert len(t) == 10 and t == j


def test_disabled_path_is_one_cached_null_context_manager():
    assert NULL_OBS.span("sweep/bucket", bucket=1) is NULL_SPAN_CM
    assert NULL_OBS.span("anything") is NULL_SPAN_CM
    with NULL_OBS.span("x") as sp:
        sp.annotate(a=1)
        sp.subdivide({"descent": 3})
    NULL_OBS.event("QUARANTINE", cell=1)
    NULL_OBS.counter("aiyagari_x_total").inc()
    assert NULL_OBS.counter("aiyagari_x_total").value == 0.0
    assert NULL_OBS.sample_devices() == 0 and NULL_OBS.dump_flight("x") is None
    NULL_OBS.close()


def test_build_and_resolve_obs_contract(tmp_path):
    assert build_obs(None) is NULL_OBS
    assert build_obs(ObsConfig(enabled=False)) is NULL_OBS
    assert resolve_obs(None) == (NULL_OBS, False)
    obs, owned = resolve_obs(ObsConfig(
        enabled=True, journal_path=str(tmp_path / "j.jsonl")))
    assert obs is not NULL_OBS and owned
    passed, owned2 = resolve_obs(obs)
    assert passed is obs and not owned2
    with pytest.raises(TypeError):
        resolve_obs("yes please")
    with pytest.raises(TypeError):
        resolve_obs(jobs.ObsConfig(enabled=True))   # the other package's
    obs.close()


def test_run_lifecycle_events_and_idempotent_close(tmp_path):
    jp, tp = str(tmp_path / "j.jsonl"), str(tmp_path / "t.json")
    obs = build_obs(ObsConfig(enabled=True, run_id="run-lc",
                              journal_path=jp, trace_path=tp))
    with obs.span("work"):
        pass
    obs.close()
    obs.close()
    assert [r["event"] for r in read_journal(jp, run_id="run-lc")] == [
        "RUN_START", "RUN_END"]
    with open(tp) as f:
        trace = json.load(f)
    assert trace["metadata"]["run_id"] == "run-lc"
    assert len(trace["traceEvents"]) == 1


def test_emit_event_without_active_scope_is_a_noop(tmp_path):
    emit_event("QUARANTINE", cell=0)
    jp = str(tmp_path / "j.jsonl")
    obs = build_obs(ObsConfig(enabled=True, journal_path=jp))
    with obs.activate():
        emit_event("QUARANTINE", cell=7)
    emit_event("QUARANTINE", cell=8)
    assert [r["cell"] for r in read_journal(jp, event="QUARANTINE")] == [7]
    obs.close()


def test_active_scope_is_per_thread(tmp_path):
    jp = str(tmp_path / "j.jsonl")
    obs = build_obs(ObsConfig(enabled=True, journal_path=jp))
    with obs.activate():
        t = threading.Thread(target=lambda: emit_event("QUARANTINE",
                                                       cell=9))
        t.start()
        t.join()
        emit_event("QUARANTINE", cell=1)
    obs.close()
    assert [r["cell"] for r in read_journal(jp, event="QUARANTINE")] == [1]


# ---------------------------------------------------------------------------
# The roofline, the peaks and the cost ledger.
# ---------------------------------------------------------------------------

V5E = (197e12, 819e9)


@pytest.mark.parametrize("flops,bytes_,wall,launches,peaks,expect", [
    (None, 1e6, 1.0, 1, V5E, tprof.ROOFLINE_UNKNOWN),
    (1e9, None, 1.0, 1, V5E, tprof.ROOFLINE_UNKNOWN),
    (1e9, 1e6, 1.0, 0, V5E, tprof.ROOFLINE_UNKNOWN),
    (1e9, 1e6, 0.0, 1, V5E, tprof.ROOFLINE_UNKNOWN),
    (1e8, 1e6, 1.0, 1, V5E, tprof.ROOFLINE_LATENCY),
    (1.2e14, 1e9, 1.0, 1, V5E, tprof.ROOFLINE_COMPUTE),
    (5e11, 1e12, 1.0, 1, V5E, tprof.ROOFLINE_MEMORY),
    (1e6, 1e6, 5e-4, 1, (None, None), tprof.ROOFLINE_LATENCY),
    (1e9, 1e6, 1.0, 1, (None, None), tprof.ROOFLINE_COMPUTE),
    (2e5, 1e6, 1.0, 1, (None, None), tprof.ROOFLINE_MEMORY),
    (3e12, 1e12, 1.0, 1, H100, tprof.ROOFLINE_MEMORY),
    (1e9, 1e5, 1e-3, 1, H100, tprof.ROOFLINE_COMPUTE),
])
def test_roofline_classification_table_matches_jax(flops, bytes_, wall,
                                                   launches, peaks, expect):
    kw = dict(peak_flops=peaks[0], peak_bytes_per_s=peaks[1])
    got = tprof.classify_roofline(flops, bytes_, wall, launches, **kw)
    assert got == expect
    assert got == jprof.classify_roofline(flops, bytes_, wall, launches,
                                          **kw)
    assert tprof.ROOFLINE_CLASSES == jprof.ROOFLINE_CLASSES


def _fake_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: name)


def test_peaks_are_the_cards_own(monkeypatch):
    assert tprof.peak_membw_per_chip("cpu") == (None, False)
    assert ttiming.peak_flops_per_chip("cpu") == (None, False)
    _fake_card(monkeypatch, "NVIDIA H100 80GB HBM3")
    assert ttiming.peak_flops_per_chip("cuda", F64) == (34e12, False)
    assert ttiming.peak_flops_per_chip("cuda", torch.float32) == (67e12,
                                                                   False)
    assert tprof.peak_membw_per_chip("cuda") == (3.35e12, False)
    _fake_card(monkeypatch, "NVIDIA H100 PCIe")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert ttiming.peak_flops_per_chip("cuda", F64).assumed
    assert tprof.peak_membw_per_chip("cuda")[1] is True


def test_work_model_terms():
    """The kernels' work model at a hand-checked size (N=2, A=3, D=4,
    float64): bytes read and written once, operations per step times
    the steps taken."""
    nbytes, ops = tprof.egm_work(8, 1, 2, 3, steps=10)
    # K = 4 knots: inputs 8*(16 + 3 + 2 + 4 + 5), outputs 8*16, the
    # iteration count 4 and the status 8
    assert nbytes == 8 * (16 + 3 + 2 + 4 + 5) + 8 * 16 + 4 + 8
    assert ops == pytest.approx(10 * (2 * 3 * (3 + 2 + 5 + 1 + 3 + 3)
                                      + 4 * 8 + 8 * 8 / 32))
    nbytes, ops = tprof.dist_work(8, 2, 2, 4, steps=64)
    assert nbytes == 2 * (8 * 8 + 8 * 8 + 8 * 4 + 8 * 8 + 8 * 8 + 4 + 8)
    assert ops == pytest.approx(64 * (8 * (4 + 3 + 2) + 10 * 8 / 64))
    fb, fo = tprof.fused_work(8, 1, 2, 3, 4, 10, 64, tail=False)
    assert fo > tprof.egm_work(8, 1, 2, 3, 10)[1] + tprof.dist_work(
        8, 1, 2, 4, 64)[1]
    engines = {"egm_engine": "fused_cell_grid",
               "dist_engine": "fused_cell_grid"}
    assert tprof.launch_work(engines, 8, 1, 2, 3, 4, 10, 64) == (fb, fo)
    ref = {"egm_engine": "egm_policy_grid",
           "dist_engine": "stationary_lottery_grid"}
    both = tprof.launch_work(ref, 8, 1, 2, 3, 4, 10, 64)
    assert both[1] == pytest.approx(tprof.egm_work(8, 1, 2, 3, 10)[1]
                                    + tprof.dist_work(8, 1, 2, 4, 64)[1])
    ez = {"egm_engine": "egm_step_ez",
          "dist_engine": "stationary_lottery_grid"}
    assert tprof.launch_work(ez, 8, 1, 2, 3, 4, 10, 64) == \
        tprof.dist_work(8, 1, 2, 4, 64)


def test_cost_ledger_aggregates_the_work_model():
    ledger = tprof.CostLedger(peak_flops=H100[0], peak_bytes_per_s=H100[1])
    key = ("sweep", "aiyagari", 1, "cold", 4, None, 1)
    entry = ledger.capture(key, label="sweep/aiyagari/cold4",
                           device="cpu", dtype=F64)
    assert ledger.capture(key) is entry
    assert entry.cost_source == "uncaptured" and entry.flops is None
    ledger.record_launch(key, 0.25, work=(2e9, 1e6))
    ledger.record_launch(key, 0.25, work=(4e9, 3e6))
    assert entry.cost_source == tprof.WORK_MODEL
    assert entry.launches == 2 and entry.launch_wall_s == 0.5
    assert entry.flops == 3e9 and entry.bytes_accessed == 2e6
    assert entry.lowering_s is None and entry.compile_s is None
    assert entry.achieved_flops_per_sec() == pytest.approx(6e9 / 0.5)
    snap = ledger.snapshot()
    json.dumps(snap)
    assert set(snap) == {
        "executables", "launches", "launch_wall_s", "lowering_wall_s",
        "compile_wall_s", "measured_flops_total", "bytes_accessed_total",
        "achieved_flops_per_sec", "arithmetic_intensity", "roofline",
        "mfu_pct", "peak_flops_per_chip", "peak_flops_assumed",
        "peak_bytes_per_s_per_chip", "peak_bytes_assumed", "cost_sources",
        "entries"}
    assert snap["measured_flops_total"] == 6e9
    assert snap["bytes_accessed_total"] == 4e6
    assert snap["cost_sources"] == {"kernel_work_model": 1}
    assert snap["mfu_pct"] == pytest.approx(100 * 1.2e10 / H100[0])
    assert snap["roofline"] == tprof.ROOFLINE_LATENCY
    # a ratio of the work model to itself would check nothing
    assert ledger.flops_model_vs_measured_ratio(1e9) is None


def test_cost_ledger_without_work_keeps_nones():
    ledger = tprof.CostLedger()
    entry = ledger.capture(("k",), label="broken")
    ledger.record_launch(("k",), 1.0)
    assert entry.launches == 1 and entry.achieved_flops_per_sec() is None
    snap = ledger.snapshot()
    assert snap["measured_flops_total"] is None
    assert snap["roofline"] == tprof.ROOFLINE_UNKNOWN
    assert snap["cost_sources"] == {"uncaptured": 1}
    assert snap["peak_flops_per_chip"] is None       # bound to no device


def test_snapshot_roofline_not_inflated_by_launch_count():
    ledger = tprof.CostLedger(peak_flops=V5E[0], peak_bytes_per_s=V5E[1])
    ledger.capture(("k",))
    for _ in range(100):
        ledger.record_launch(("k",), 0.01, work=(1e9, 1e7))
    assert ledger.snapshot()["roofline"] == tprof.ROOFLINE_LATENCY
    assert ledger.snapshot()["achieved_flops_per_sec"] == pytest.approx(
        1e11)


def test_snapshot_slug_collision_and_publish():
    ledger = tprof.CostLedger()
    ledger.capture(("a", None), label="sweep/cold4")
    ledger.capture(("a", "nan"), label="sweep/cold4")
    ledger.record_launch(("a", None), 0.1, work=(1.0, 1.0))
    ledger.record_launch(("a", "nan"), 0.2, work=(1.0, 1.0))
    snap = ledger.snapshot()
    assert set(snap["entries"]) == {"sweep_cold4", "sweep_cold4_2"}
    reg = MetricsRegistry()
    ledger.publish(reg)
    assert "aiyagari_profile_launch_wall_s_sweep_cold4_2" in reg.names()
    assert reg.gauge("aiyagari_profile_launches").value == 2.0


def test_profiled_sweep_bit_identical_and_snapshotted(tmp_path):
    jp, tp = str(tmp_path / "events.jsonl"), str(tmp_path / "trace.json")
    obs = build_obs(ObsConfig(enabled=True, profile=True, journal_path=jp,
                              trace_path=tp))
    on = _sweep(SMALL, obs=obs, **KW)
    off = _sweep(SMALL, **KW)
    for f in ("r_star_pct", "saving_rate_pct", "status", "egm_iters",
              "dist_iters"):
        assert getattr(on, f).tobytes() == getattr(off, f).tobytes(), f
    snap = obs.cost_ledger.snapshot()
    assert snap["launches"] == 2 and snap["executables"] == 1
    assert snap["cost_sources"] == {"kernel_work_model": 1}
    # the ledger's operations are the work model of the rows' own steps
    expect = sum(tprof.launch_work(
        {"egm_engine": "egm_policy_grid",
         "dist_engine": "stationary_lottery_grid"}, 8, int((on.bucket == b)
                                                           .sum()), 4, 12, 48,
        float(on.egm_iters[on.bucket == b].sum()),
        float(on.dist_iters[on.bucket == b].sum()))[1]
        for b in (0, 1))
    assert snap["measured_flops_total"] == pytest.approx(expect, rel=1e-12)
    assert obs.cost_ledger.flops_model_vs_measured_ratio(1e12) is None
    obs.close()
    snaps = read_journal(jp, run_id=obs.run_id, event="PROFILE_SNAPSHOT")
    assert len(snaps) == 1 and snaps[0]["launches"] == 2
    with open(tp) as f:
        trace = json.load(f)
    counters = [e for e in trace["traceEvents"] if e.get("ph") == "C"]
    assert len(counters) >= snap["launches"]
    names = obs.registry.names()
    assert "aiyagari_profile_executables" in names
    assert "aiyagari_sweep_bucket_lane_occupancy" in names


# ---------------------------------------------------------------------------
# Device telemetry.
# ---------------------------------------------------------------------------

def test_device_telemetry_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jp = str(tmp_path / "events.jsonl")
    obs = build_obs(ObsConfig(enabled=True, profile=True, journal_path=jp))
    assert obs.sample_devices(where="test") == 0
    assert obs.telemetry.samples == 1
    assert obs.telemetry.devices_without_stats == 0
    assert not [n for n in obs.registry.names() if "_mem_" in n]
    obs.close()
    assert read_journal(jp, event="DEVICE_MEM_HIGH_WATER") == []


def test_device_telemetry_high_water_events_monotone(tmp_path, monkeypatch):
    stats = {"allocated_bytes.all.current": 100,
             "allocated_bytes.all.peak": 100}
    limit_reads = []

    def mem_get_info(i):
        limit_reads.append(i)
        return (10, 1000)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: dict(stats))
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    jp = str(tmp_path / "events.jsonl")
    obs = build_obs(ObsConfig(enabled=True, journal_path=jp))
    tel = tprof.DeviceTelemetry()
    assert tel.sample(obs, where="a") == 1
    assert tel.sample(obs, where="b") == 1
    stats.update({"allocated_bytes.all.current": 500,
                  "allocated_bytes.all.peak": 500})
    tel.sample(obs, where="c")
    events = read_journal(jp, event="DEVICE_MEM_HIGH_WATER")
    assert [e["where"] for e in events] == ["a", "c"]
    assert events[-1]["bytes"] == 500 and events[-1]["bytes_limit"] == 1000
    assert tel.high_water() == {0: 500.0}
    assert limit_reads == [0]                     # the limit is read once
    snap = obs.registry.snapshot()
    assert snap["aiyagari_device0_mem_bytes_limit"]["value"] == 1000
    obs.close()


# ---------------------------------------------------------------------------
# The flight recorder.
# ---------------------------------------------------------------------------

def test_flight_recorder_dumps_on_quarantine_exhaustion(tmp_path):
    jp, fp = str(tmp_path / "events.jsonl"), str(tmp_path / "flight.json")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = _sweep(LOCKSTEP,
                     obs=ObsConfig(enabled=True, journal_path=jp,
                                   flight_path=fp),
                     inject_fault={"cell": 1, "at_iter": 1, "mode": "nan"},
                     max_retries=0, **DRILL_KW)
    assert list(res.failed_cells()) == [1]
    with open(fp) as f:
        dump = json.load(f)
    assert dump["reason"].startswith("aiyagari sweep: 1 cell(s)")
    assert dump["attrs"]["cells"] == [1]
    assert any(e.get("event") == "BUCKET_LAUNCH" for e in dump["entries"])
    assert dump["metrics"] is not None and dump["entries_dropped"] == 0
    dumps = read_journal(jp, event="FLIGHT_RECORD_DUMP")
    assert len(dumps) == 1 and dumps[0]["path"] == fp
    quarantine = read_journal(jp, event="QUARANTINE")
    assert len(quarantine) == 1 and quarantine[0]["recovered"] is False


def test_no_dump_without_quarantine_exhaustion(tmp_path):
    jp, fp = str(tmp_path / "events.jsonl"), str(tmp_path / "flight.json")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = _sweep(LOCKSTEP,
                     obs=ObsConfig(enabled=True, journal_path=jp,
                                   flight_path=fp),
                     inject_fault={"cell": 1, "at_iter": 1, "mode": "nan"},
                     max_retries=2, **DRILL_KW)
    assert len(res.failed_cells()) == 0
    assert not os.path.exists(fp)
    assert read_journal(jp, event="FLIGHT_RECORD_DUMP") == []


def test_flight_recorder_ring_is_bounded(tmp_path):
    obs = build_obs(ObsConfig(enabled=True, flight_limit=4,
                              journal_path=str(tmp_path / "j.jsonl"),
                              flight_path=str(tmp_path / "f.json")))
    for i in range(10):
        obs.event("RUN_START", i=i)
    assert len(obs.flight.entries()) == 4
    assert obs.flight.dropped == 7
    with open(obs.dump_flight("test")) as f:
        assert json.load(f)["entries_dropped"] >= 7
    obs.close()


# ---------------------------------------------------------------------------
# FLOP accounting and the stopwatch.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dense", [False, True])
def test_model_flops_matches_jax(dense):
    args = (120.0, 3400.0, 32, 7, 500, dense)
    assert ttiming.model_flops(*args) == jtiming.model_flops(*args)


def test_flop_report_provenance_analytic_vs_work_model():
    analytic = ttiming.flop_report(100, 1000, 2.0, 32, 7, 500,
                                   dense_dist=False, backend="cpu")
    assert analytic == jtiming.flop_report(100, 1000, 2.0, 32, 7, 500,
                                           dense_dist=False, backend="cpu")
    assert analytic["flops_provenance"] == "analytic"
    measured = ttiming.flop_report(100, 1000, 2.0, 32, 7, 500,
                                   dense_dist=False, backend="cpu",
                                   measured_flops=4.0e9)
    assert measured["flops_provenance"] == "kernel_work_model"
    assert measured["flops_per_sec"] == round(4.0e9 / 2.0)
    assert ttiming.flop_report(1, 1, None, 32, 7, 500, False, "cpu") == {
        "flops_per_sec": None, "mfu_pct": None,
        "peak_flops_assumed": False, "flops_provenance": None}


def test_record_flop_fields_stamps_prefix(monkeypatch):
    rec = {}
    out = ttiming.record_flop_fields(rec, "phase_", 100, 1000, 2.0, 32, 7,
                                     500, dense_dist=False, backend="cpu",
                                     measured_flops=2.0e9)
    assert out is rec and rec["phase_flops_per_sec"] == round(1.0e9)
    assert rec["phase_mfu_pct"] is None
    _fake_card(monkeypatch, "NVIDIA H100 80GB HBM3")
    ttiming.record_flop_fields(rec, "card_", 0, 0, 2.0, 32, 7, 500, False,
                               "cuda", measured_flops=6.7e12,
                               dtype=torch.float32)
    assert rec["card_mfu_pct"] == pytest.approx(5.0)
    assert rec["card_peak_flops_assumed"] is False


def test_stopwatch_fills_on_exit_and_elapsed_runs():
    with ttiming.stopwatch() as sw:
        inner = sw.elapsed()
    assert np.isfinite(sw.seconds) and sw.seconds >= inner >= 0.0
    assert np.isnan(ttiming.Stopwatch().seconds)


# ---------------------------------------------------------------------------
# The bench-regression sentinel, against the JAX package's.
# ---------------------------------------------------------------------------

def _history():
    history = treg.load_bench_history(REPO)
    assert history == jreg.load_bench_history(REPO)
    assert len(history) >= 2
    return history


def _report(mod, history):
    rep = mod.evaluate_history(history)
    return (rep.worst, [dataclasses.asdict(f) for f in rep.findings],
            rep.unknown_fields)


def test_committed_history_grades_as_in_jax():
    history = _history()
    got = _report(treg, history)
    assert got == _report(jreg, history)
    assert got[0] < treg.REGRESSED and got[2] == []


@pytest.mark.parametrize("factor,severity", [(1.2, "REGRESSED"),
                                             (1.06, "NOISE")])
def test_injected_slowdown_grades_as_in_jax(factor, severity):
    history = _history()
    history[-1] = (history[-1][0], dict(history[-1][1]))
    history[-1][1]["iteration_skew"] *= factor
    got = _report(treg, history)
    assert got == _report(jreg, history)
    assert treg.SEVERITY_NAMES[got[0]] == severity


def test_regression_flagged_event_journaled(tmp_path):
    jp = str(tmp_path / "events.jsonl")
    obs = build_obs(ObsConfig(enabled=True, journal_path=jp))
    history = _history()
    history[-1] = (history[-1][0], dict(history[-1][1]))
    history[-1][1]["iteration_skew"] *= 1.3
    with obs.activate():
        treg.evaluate_history(history)
    obs.close()
    events = read_journal(jp, event="REGRESSION_FLAGGED")
    assert len(events) == 1 and events[0]["metric"] == "iteration_skew"
    assert events[0]["direction"] == treg.DOWN


def test_grade_metric_rules_match_jax():
    priors = [10.0, 10.2, 9.9, 10.1]
    for metric, value, pri in (
            ("x_wall_s", 10.3, priors), ("x_wall_s", 10.9, priors + [11.5]),
            ("x_wall_s", 12.0, priors), ("x_wall_s", 10.8, priors),
            ("x_per_sec", 8.0, priors), ("n_devices", 99.0, priors),
            ("x_wall_s", 99.0, [10.0])):
        t = treg.grade_metric(metric, value, pri)
        assert dataclasses.asdict(t) == dataclasses.asdict(
            jreg.grade_metric(metric, value, pri))
    assert treg.OK < treg.NOISE < treg.REGRESSED


def test_direction_table_and_flatten_match_jax():
    seen = 0
    for _, record in _history():
        flat = treg.flatten_record(record)
        assert flat == jreg.flatten_record(record)
        for field in flat:
            assert treg.direction_of_goodness(field, strict=True) == \
                jreg.direction_of_goodness(field, strict=True)
            seen += 1
    assert seen > 20
    with pytest.raises(treg.UnknownMetricError):
        treg.direction_of_goodness("utterly_unclassifiable_thing")
    assert treg.flatten_record({"a": 1, "b": True, "c": "x", "d": [1, 2],
                                "e": {"f": 2.5}, "g": None}) == {
        "a": 1.0, "e.f": 2.5}
