"""The port's sweep durability on the CPU in float64: transient retry, the
preemption drill and the resume ledger's kill-and-resume contract (the
counterparts of ``tests/test_resilience.py``'s sweep tests), and the
integrity primitives against the JAX package's.

Size: the JAX tests' ``KW`` (``a_count=12, dist_count=48, labor_states=4,
r_tol=1e-5, max_bisect=30``).  The load-bearing assertion is the JAX
suite's: the 12-cell balanced sweep (3 buckets, a stall-injected cell
that the quarantine ladder retries) interrupted after bucket 0, by a
SIGTERM and by a transient fault that exhausts its retries, resumes
through ``resume_path`` to a result bitwise the uninterrupted run's:
values, NaN masks, statuses, counters, retries, buckets and the work
model.  A transient fault that does not exhaust the policy is replayed
in place, bitwise; a NONFINITE goes to quarantine, never to the retry.
The ledger's own drills are in ``tests/test_torch_sweep_ledger.py``, the
sidecar's in ``tests/test_torch_sweep_sidecar.py``.
"""

import os
import signal

import numpy as np
import pytest
import torch

import aiyagari_hark_tpu.utils.fingerprint as jfp
import aiyagari_hark_tpu_torch.parallel.sweep as tsw
import aiyagari_hark_tpu_torch.utils.fingerprint as tfp
from aiyagari_hark_tpu_torch.solver_health import is_failure
from aiyagari_hark_tpu_torch.utils.config import SweepConfig
from aiyagari_hark_tpu_torch.utils.resilience import (InjectedTransientError,
                                                      Interrupted,
                                                      RetryPolicy,
                                                      preemption_guard)
from aiyagari_hark_tpu_torch.verify import flip_row_bit

torch.set_num_threads(1)
F64 = torch.float64
KW = dict(a_count=12, dist_count=48, labor_states=4, r_tol=1e-5,
          max_bisect=30)
FAULT = {"cell": 2, "at_iter": 2, "mode": "stall"}
TWELVE = SweepConfig(schedule="balanced", n_buckets=3)
SMALL = SweepConfig(crra_values=(1.0, 5.0), rho_values=(0.0, 0.9),
                    schedule="balanced", n_buckets=2)


def run(sweep, **kw):
    return tsw.run_table2_sweep(sweep, dtype=F64, device="cpu", **kw, **KW)


def spy_policy(**kw):
    """A RetryPolicy whose sleeps are recorded, not slept."""
    slept = []
    kw.setdefault("base_delay", 0.25)
    return RetryPolicy(sleep=slept.append, **kw), slept


def assert_sweep_identical(a, b):
    """Bitwise equality of every per-cell field of two SweepResults."""
    for f in ("r_star_pct", "saving_rate_pct", "capital", "excess",
              "predicted_work"):
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f)), equal_nan=True), f
    for f in ("bisect_iters", "egm_iters", "dist_iters", "status",
              "retries", "bucket"):
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f


# -- the integrity primitives, against JAX -----------------------------------

def test_checksums_and_hex_match_jax():
    row = np.asarray([0.035, 5.0, 0.9, 11, 500, 4000, 0, 0, 4500, 0],
                     dtype=np.float64)
    rows = np.stack([row, np.full(10, np.nan), flip_row_bit(row)])
    assert tfp.packed_row_checksum(row) == jfp.packed_row_checksum(row)
    assert tfp.packed_row_checksum(row) != tfp.packed_row_checksum(
        flip_row_bit(row))
    assert np.array_equal(tfp.packed_row_checksums(rows),
                          jfp.packed_row_checksums(rows))
    for arrays in ((np.zeros((2, 3)),), (np.zeros(6),),
                   (row, np.arange(4), np.float32(0.1))):
        assert tfp.content_checksum(*arrays) == jfp.content_checksum(*arrays)
    assert (tfp.content_checksum(np.zeros((2, 3)))
            != tfp.content_checksum(np.zeros(6)))
    for key in (0, -1, 2 ** 62, -12345):
        assert tfp.fingerprint_hex(key) == jfp.fingerprint_hex(key)
    tfp.verify_packed_row(row, tfp.packed_row_checksum(row), "ledger")
    with pytest.raises(tfp.IntegrityError) as ei:
        tfp.verify_packed_row(flip_row_bit(row),
                              tfp.packed_row_checksum(row), "ledger", key=3)
    assert ei.value.boundary == "ledger" and ei.value.key == 3
    assert not isinstance(ei.value, (ValueError, OSError))


def test_ledger_fingerprint_is_jax_fields_plus_the_package():
    cells = np.asarray(SMALL.cells())
    items = tfp.hashable_kwargs(dict(KW))
    args = (cells, items, F64, "balanced", 2, False, 0.0, None, None, 3,
            True, None)
    from aiyagari_hark_tpu.scenarios.aiyagari import AIYAGARI_SCHEMA

    fields = AIYAGARI_SCHEMA.fields
    port = tfp.ledger_fingerprint(*args, row_fields=fields)
    jax_fp = jfp.ledger_fingerprint(cells, items, np.float64,
                                    *args[3:], row_fields=fields)
    assert port != jax_fp
    # the JAX key's inputs with the package token in front
    assert port == tfp.config_fingerprint(
        tfp.PACKAGE_TOKEN, "scenario:aiyagari", repr(tuple(fields)), cells,
        repr(items), "float64", "balanced", 2, False, 0.0, "None", "none",
        3, True, (1, 1), "no-sidecar")
    assert tfp.ledger_fingerprint(*args) == port   # the registered schema
    for i, other in ((3, "locked"), (4, 3), (9, 2), (10, False)):
        changed = list(args)
        changed[i] = other
        assert tfp.ledger_fingerprint(*changed) != port


# -- the kill-and-resume acceptance (12 cells, 3 buckets) --------------------

@pytest.fixture(scope="module")
def uninterrupted():
    res = run(TWELVE, inject_fault=FAULT, max_retries=1)
    assert int(res.retries[FAULT["cell"]]) >= 1     # quarantine ran
    assert len(np.unique(res.bucket)) == 3
    return res


def test_sigterm_after_bucket_k_resumes_bit_identical(tmp_path,
                                                      uninterrupted):
    """A SIGTERM after bucket 0: the ledger is flushed, ``Interrupted``
    raised; the rerun restores bucket 0 and assembles the uninterrupted
    result bit for bit, then removes the ledger."""
    ledger = str(tmp_path / "sweep_ledger.npz")
    with preemption_guard():
        with pytest.raises(Interrupted) as ei:
            run(TWELVE, inject_fault=FAULT, max_retries=1,
                resume_path=ledger,
                inject_preempt={"after_bucket": 0, "mode": "signal"})
    assert ei.value.signum == signal.SIGTERM
    assert ei.value.resume_path == ledger
    assert ei.value.progress == {"completed_buckets": 1, "n_buckets": 3}
    assert os.path.exists(ledger)
    with np.load(ledger) as raw:          # the JAX package's 8-leaf layout
        assert len([k for k in raw.files if k.startswith("leaf_")]) == 8
        solved = raw["leaf_000001"]
    assert 0 < solved.sum() < 12
    resumed = run(TWELVE, inject_fault=FAULT, max_retries=1,
                  resume_path=ledger)
    assert not os.path.exists(ledger)
    assert_sweep_identical(resumed, uninterrupted)


def test_transient_fault_mid_sweep_resumes_bit_identical(tmp_path,
                                                         uninterrupted):
    """A transient fault at call 1 (bucket 1's launch) that uses up
    ``max_attempts=2`` escapes after one backoff; the ledger holds bucket
    0 and the rerun resumes bit for bit."""
    ledger = str(tmp_path / "sweep_ledger.npz")
    policy, slept = spy_policy(max_attempts=2)
    with pytest.warns(UserWarning, match="transient fault in sweep bucket"):
        with pytest.raises(InjectedTransientError):
            run(TWELVE, inject_fault=FAULT, max_retries=1,
                resume_path=ledger, retry=policy,
                inject_transient={"at_call": 1, "times": 2})
    assert slept == [policy.delay(0)]
    assert os.path.exists(ledger)
    resumed = run(TWELVE, inject_fault=FAULT, max_retries=1,
                  resume_path=ledger)
    assert not os.path.exists(ledger)
    assert_sweep_identical(resumed, uninterrupted)


# -- transient retry in place; NONFINITE is quarantine's ----------------------

@pytest.fixture(scope="module")
def small_clean():
    return run(SMALL)


def test_transient_fault_retried_in_place_same_bits(small_clean):
    policy, slept = spy_policy(max_attempts=3)
    with pytest.warns(UserWarning, match="transient fault in sweep"):
        faulted = run(SMALL, retry=policy,
                      inject_transient={"at_call": 0, "times": 1})
    assert slept == [policy.delay(0)]
    assert_sweep_identical(faulted, small_clean)


def test_nonfinite_goes_to_quarantine_not_transient_retry():
    policy, slept = spy_policy(max_attempts=5)
    res = run(SMALL, inject_fault={"cell": 1, "at_iter": 1, "mode": "nan"},
              max_retries=1, retry=policy)
    assert slept == []
    assert int(res.retries[1]) >= 1
    assert not is_failure(int(res.status[1]))
    assert np.isfinite(res.r_star_pct[1])


def test_flag_preemption_without_a_ledger_raises_typed():
    """The drill's flag mode needs no signal handler; without a ledger
    the interrupt names no resume path."""
    from aiyagari_hark_tpu_torch.utils.resilience import clear_interrupt

    try:
        with pytest.raises(Interrupted) as ei:
            run(SweepConfig(crra_values=(1.0,), rho_values=(0.0, 0.9),
                            schedule="balanced", n_buckets=2),
                inject_preempt={"after_bucket": 0, "mode": "flag"})
    finally:
        clear_interrupt()
    assert ei.value.resume_path is None
    assert ei.value.progress["completed_buckets"] == 1
