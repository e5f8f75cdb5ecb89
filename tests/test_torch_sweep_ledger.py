"""The port's sweep resume ledger on the CPU in float64: its drills
(the counterparts of ``tests/test_resilience.py``'s stale-ledger and
locked-schedule tests and ``tests/test_verify.py``'s ledger and recheck
tests) and its cross-package behaviour.

Size: the JAX tests' ``KW``; a 4-cell lattice in 2 balanced buckets.  One
run interrupted after bucket 0 leaves a ledger that each test copies:
resumed as it is, the result is bitwise the uninterrupted run and the
file is gone; with one row's bit flipped (``corrupt_ledger_row``), that
cell alone is recomputed, bitwise again; written under another
configuration, or by the JAX package (whose key lacks the port's
package token), it warns "different run" and everything is recomputed;
a row marked as a quarantine outcome is skipped by the SDC recheck with
a warning.  The locked schedule is one bucket to the ledger: an
interrupt between its launch and the quarantine resumes without
relaunching.  The ledger state alone: the JAX package's 8-leaf layout, a
disk fault skipping a flush, an unreadable file starting afresh.
"""

import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import aiyagari_hark_tpu_torch.parallel.sweep as tsw
from aiyagari_hark_tpu_torch.utils import checkpoint as tck
from aiyagari_hark_tpu_torch.utils.config import SweepConfig
from aiyagari_hark_tpu_torch.utils.fingerprint import hashable_kwargs
from aiyagari_hark_tpu_torch.utils.resilience import (Interrupted,
                                                      LedgerState,
                                                      SweepLedger,
                                                      clear_interrupt,
                                                      request_interrupt)
from aiyagari_hark_tpu_torch.verify import corrupt_ledger_row
from aiyagari_hark_tpu_torch.verify.inject import _rewrite_npz_leaf

torch.set_num_threads(1)
F64 = torch.float64
KW = dict(a_count=12, dist_count=48, labor_states=4, r_tol=1e-5,
          max_bisect=30)
FAULT = {"cell": 2, "at_iter": 2, "mode": "stall"}
SMALL = SweepConfig(crra_values=(1.0, 5.0), rho_values=(0.0, 0.9),
                    schedule="balanced", n_buckets=2)


def run(sweep, **kw):
    return tsw.run_table2_sweep(sweep, dtype=F64, device="cpu", **kw, **KW)


def recorded(fn):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(x.message) for x in w]


@pytest.fixture(scope="module")
def clean():
    return run(SMALL)


@pytest.fixture(scope="module")
def interrupted_ledger(tmp_path_factory):
    """The ledger of a run stopped after bucket 0 by the flag drill."""
    path = str(tmp_path_factory.mktemp("ledger") / "ledger.npz")
    try:
        with pytest.raises(Interrupted) as ei:
            run(SMALL, resume_path=path,
                inject_preempt={"after_bucket": 0, "mode": "flag"})
    finally:
        clear_interrupt()
    assert ei.value.resume_path == path
    return path


def _copy(src, tmp_path):
    dst = str(tmp_path / "ledger.npz")
    shutil.copy(src, dst)
    return dst


def assert_rows_equal(a, b):
    for f in ("r_star_pct", "capital", "status", "bisect_iters",
              "egm_iters", "dist_iters", "retries", "bucket",
              "predicted_work"):
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f)), equal_nan=True), f


def test_uncorrupted_resume_is_bit_identical(interrupted_ledger, clean,
                                             tmp_path):
    ledger = _copy(interrupted_ledger, tmp_path)
    resumed, msgs = recorded(lambda: run(SMALL, resume_path=ledger))
    assert not any("ledger" in m for m in msgs), msgs
    assert not os.path.exists(ledger)
    assert_rows_equal(resumed, clean)


def test_ledger_row_corruption_recomputed_on_resume(interrupted_ledger,
                                                    clean, tmp_path):
    ledger = _copy(interrupted_ledger, tmp_path)
    with np.load(ledger) as raw:
        cell = int(np.nonzero(raw["leaf_000001"])[0][0])   # solved
    corrupt_ledger_row(ledger, cell=cell, bit=21)
    resumed, msgs = recorded(lambda: run(SMALL, resume_path=ledger))
    assert any(f"checksum verification failed for cell(s) [{cell}]" in m
               for m in msgs), msgs
    assert not os.path.exists(ledger)
    assert_rows_equal(resumed, clean)


def test_stale_ledger_warns_and_recomputes(interrupted_ledger, tmp_path):
    ledger = _copy(interrupted_ledger, tmp_path)
    other = dict(KW, r_tol=2e-5)
    with pytest.warns(UserWarning, match="different run"):
        res = tsw.run_table2_sweep(SMALL, dtype=F64, device="cpu",
                                   resume_path=ledger, **other)
    assert np.isfinite(res.r_star_pct).all()
    assert not os.path.exists(ledger)


def test_jax_written_ledger_is_refused_and_recomputed(clean, tmp_path):
    """A ledger the JAX package wrote for the same sweep (its own
    fingerprint, its rows) loads in the port's layout but fails the
    port's key: the port warns and recomputes its own bits."""
    from aiyagari_hark_tpu.scenarios.aiyagari import AIYAGARI_SCHEMA
    from aiyagari_hark_tpu.utils.fingerprint import ledger_fingerprint
    from aiyagari_hark_tpu.utils.resilience import LedgerState as JLedger

    cells = np.asarray(SMALL.cells(), dtype=np.float64)
    fp = ledger_fingerprint(cells, hashable_kwargs(dict(KW)), np.float64,
                            "balanced", 2, False, 0.0, None, None, 3, True,
                            None, row_fields=AIYAGARI_SCHEMA.fields)
    path = str(tmp_path / "jax_ledger.npz")
    jl = JLedger(path, fp, len(cells), width=AIYAGARI_SCHEMA.width)
    rows = np.full((len(cells), AIYAGARI_SCHEMA.width), 0.5)  # not the bits
    jl.record_bucket(np.arange(len(cells)), rows, 0)
    jl.flush()
    # the layout loads in the port; the key does not match
    with pytest.warns(UserWarning, match="different run"):
        res = run(SMALL, resume_path=path)
    assert not os.path.exists(path)
    assert_rows_equal(res, clean)


def test_locked_schedule_resumes_through_quarantine(tmp_path):
    """The locked launch is one bucket to the ledger: an interrupt
    between it and the quarantine rungs resumes without relaunching, bit
    for bit."""
    cfg = SMALL.replace(schedule="locked")
    clean = run(cfg, inject_fault=FAULT, max_retries=1)
    assert clean.retries[FAULT["cell"]] == 1
    ledger = str(tmp_path / "locked_ledger.npz")
    try:
        request_interrupt()           # honoured right after the launch
        with pytest.raises(Interrupted):
            run(cfg, inject_fault=FAULT, max_retries=1, resume_path=ledger)
    finally:
        clear_interrupt()
    assert os.path.exists(ledger)
    resumed = run(cfg, inject_fault=FAULT, max_retries=1,
                  resume_path=ledger)
    assert resumed.wall_seconds == 0.0      # the batch was not relaunched
    for f in ("r_star_pct", "capital"):
        assert np.array_equal(getattr(resumed, f), getattr(clean, f),
                              equal_nan=True), f
    for f in ("bisect_iters", "egm_iters", "dist_iters", "status",
              "retries"):
        assert np.array_equal(getattr(resumed, f), getattr(clean, f)), f
    assert not os.path.exists(ledger)


def test_recheck_skips_resumed_quarantine_outcomes(interrupted_ledger,
                                                   tmp_path):
    """A restored row marked as a quarantine outcome cannot match a fresh
    batched launch bitwise: the recheck skips it, with a warning, instead
    of raising a false alarm."""
    ledger = _copy(interrupted_ledger, tmp_path)
    with np.load(ledger) as raw:
        cell = int(np.nonzero(raw["leaf_000001"])[0][0])

    def mark(arr, value):
        arr = np.array(arr)
        arr[cell] = value
        return arr

    _rewrite_npz_leaf(ledger, SweepLedger._fields.index("retried"),
                      lambda a: mark(a, True))
    _rewrite_npz_leaf(ledger, SweepLedger._fields.index("retries"),
                      lambda a: mark(a, 1))
    resumed, msgs = recorded(lambda: run(
        SMALL.replace(recheck_fraction=1.0), resume_path=ledger))
    assert not resumed.sdc_suspected.any(), msgs
    assert any(f"skipping ledger-restored cell(s) [{cell}]" in m
               for m in msgs), msgs
    assert resumed.retries[cell] == 1


def test_ledger_state_layout_disk_fault_and_unreadable_file(tmp_path):
    path = str(tmp_path / "ledger.npz")
    st = LedgerState.resume(path, 7, 3, width=4)
    assert not st.resumed
    rows = np.arange(8.0).reshape(2, 4)
    st.record_bucket(np.asarray([0, 2]), rows, 0)
    st.flush()
    with np.load(path) as raw:
        assert str(raw["__treedef__"]) == (
            "PyTreeDef(CustomNode(namedtuple[SweepLedger], "
            "[*, *, *, *, *, *, *, *]))")
    back = LedgerState.resume(path, 7, 3, width=4)
    assert back.resumed and back.solved.tolist() == [True, False, True]
    assert np.array_equal(back.packed[[0, 2]], rows)
    # a full disk skips the flush with a warning; the run goes on
    tck.arm_disk_fault("save_pytree", kind="ENOSPC")
    try:
        with pytest.warns(UserWarning, match="skipping this flush"):
            back.record_retry(1, np.ones(4), 2)
            back.flush()
    finally:
        tck.disarm_disk_faults()
    assert LedgerState.resume(path, 7, 3, width=4).retried.tolist() == [
        False, False, False]
    # a trashed file starts afresh
    with open(path, "wb") as f:
        f.write(b"not an npz")
    with pytest.warns(UserWarning, match="unreadable"):
        assert not LedgerState.resume(path, 7, 3, width=4).resumed
    back.complete()
    back.complete()               # idempotent
    assert not os.path.exists(path)
