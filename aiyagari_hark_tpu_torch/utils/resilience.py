"""Durable sweep resume, graceful shutdown and transient-fault retry (port
of ``aiyagari_hark_tpu/utils/resilience.py``).

* **Durable sweep resume** (``SweepLedger`` / ``LedgerState``): the sweep
  engine writes a fingerprinted ledger of every finished bucket's packed
  rows and every final quarantine outcome, atomically, after each bucket
  and each quarantine walk.  A rerun with the same ``resume_path``
  restores them and solves only the rest; the result is bitwise the
  uninterrupted run's.  Each row carries its solve-time checksum, and a
  row that no longer hashes to it is recomputed.

* **Graceful shutdown** (``preemption_guard``): SIGTERM/SIGINT handlers
  that set a flag (``interrupt_requested``) which long loops poll at safe
  boundaries (the KS outer iterations).  The loop flushes its checkpoint,
  then raises the typed ``Interrupted`` instead of dying mid-write.  A
  second signal escalates to ``KeyboardInterrupt``.
* **Transient-fault retry** (``retry_transient``): deterministic
  exponential backoff around device calls, gated by ``classify_transient``
  (CUDA's transient errors are retried; ``SolverDivergenceError`` never
  is).  ``TransientInjector`` (raise at call k) drives every retry path on
  the CPU.

Host-side only.  Each seam journals its typed event into the active obs
scope (``obs.runtime.emit_event``, a no-op with none), where the JAX
package journals it: ``INTERRUPTED`` at the poll, ``RETRY_TRANSIENT`` per
retry, ``RESUME_RESTORE`` and ``INTEGRITY_FAILED`` at the ledger's
restore, ``DISK_FAULT`` at a failed flush.  The ledger's resume and the
guard's exit (``gc_paths``) remove orphaned temp files of the atomic
writers (``checkpoint.gc_orphaned_tmp``).
"""

from __future__ import annotations

import os
import signal
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

import numpy as np

from ..obs.runtime import emit_event
from ..solver_health import INTERRUPTED, SolverDivergenceError
from .checkpoint import (CORRUPT_NPZ_ERRORS, gc_orphaned_tmp, load_pytree,
                         save_pytree)
from .fingerprint import packed_row_checksum, packed_row_checksums


class Interrupted(BaseException):
    """A long-running solve stopped at a safe boundary on a shutdown
    request (SIGTERM/SIGINT or ``request_interrupt``), after flushing its
    checkpoint.  A ``BaseException``, like ``KeyboardInterrupt``, so a
    broad ``except Exception`` does not swallow it.

    Fields: ``status`` (``solver_health.INTERRUPTED``), ``resume_path``
    (where the flushed state lives, or None), ``signum`` (the signal, if
    any), ``progress`` (a small dict of where the run stopped)."""

    def __init__(self, message: str, resume_path: Optional[str] = None,
                 signum: Optional[int] = None,
                 progress: Optional[dict] = None):
        super().__init__(message)
        self.status = INTERRUPTED
        self.resume_path = resume_path
        self.signum = signum
        self.progress = dict(progress) if progress else {}


# Module-level so loops can poll without threading a token through every
# call.  Set by the guard's handler or ``request_interrupt``; cleared when
# the outermost guard exits (or by ``clear_interrupt``).
_INTERRUPT = {"flag": False, "signum": None}
_GUARD_DEPTH = 0


def interrupt_requested() -> bool:
    """True once a shutdown has been requested."""
    return _INTERRUPT["flag"]


def request_interrupt(signum: Optional[int] = None) -> None:
    """Set the shutdown flag programmatically (the deterministic
    injection of the polling paths)."""
    _INTERRUPT["flag"] = True
    _INTERRUPT["signum"] = signum


def clear_interrupt() -> None:
    """Reset the shutdown flag."""
    _INTERRUPT["flag"] = False
    _INTERRUPT["signum"] = None


def raise_if_interrupted(what: str, resume_path: Optional[str] = None,
                         progress: Optional[dict] = None) -> None:
    """The poll at loop boundaries: raise ``Interrupted`` when a shutdown
    was requested.  Callers flush their checkpoint before polling."""
    if _INTERRUPT["flag"]:
        sig = _INTERRUPT["signum"]
        name = "" if sig is None else f" ({signal.Signals(sig).name})"
        emit_event("INTERRUPTED", what=what, signum=sig,
                   resume_path=resume_path, progress=progress or {})
        raise Interrupted(
            f"{what} interrupted at a safe boundary{name}"
            + (f"; resume from {resume_path}" if resume_path else ""),
            resume_path=resume_path, signum=sig, progress=progress)


class preemption_guard:
    """Context manager installing SIGTERM/SIGINT handlers that request a
    graceful shutdown.  The first signal sets the flag; a second raises
    ``KeyboardInterrupt`` at once.  Handlers are restored on exit, and
    the outermost guard's exit clears the flag.  Guards nest; outside the
    main thread the guard is flag-only.  ``gc_paths``: checkpoint or ledger
    paths whose directories are swept at exit for the atomic writers'
    temp files older than ``max_tmp_age_s`` (``checkpoint.
    gc_orphaned_tmp``: a hard kill between a write and its rename strands
    one)."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT),
                 gc_paths=(), max_tmp_age_s: float = 3600.0):
        self._signals = tuple(signals)
        self._previous: dict = {}
        self._gc_paths = tuple(gc_paths)
        self._max_tmp_age_s = max_tmp_age_s

    def _handler(self, signum, frame):
        if _INTERRUPT["flag"]:
            raise KeyboardInterrupt(
                f"second {signal.Signals(signum).name} during graceful "
                f"shutdown")
        request_interrupt(signum)

    def __enter__(self):
        global _GUARD_DEPTH
        for s in self._signals:
            try:
                self._previous[s] = signal.signal(s, self._handler)
            except ValueError:
                break          # not the main thread: flag-only mode
        _GUARD_DEPTH += 1
        return self

    def __exit__(self, exc_type, exc, tb):
        global _GUARD_DEPTH
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        self._previous.clear()
        _GUARD_DEPTH = max(0, _GUARD_DEPTH - 1)
        if _GUARD_DEPTH == 0:
            clear_interrupt()
        for p in self._gc_paths:
            gc_orphaned_tmp(p, max_age_s=self._max_tmp_age_s)
        return False


def fire_preemption(mode: str = "signal") -> None:
    """Deterministic preemption injection: ``"signal"`` sends SIGTERM to
    this process (needs an active ``preemption_guard``), ``"flag"`` sets
    the flag directly."""
    if mode == "signal":
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0)      # cross a bytecode boundary: the handler runs
    elif mode == "flag":
        request_interrupt()
    else:
        raise ValueError(f"fire_preemption mode must be 'signal' or "
                         f"'flag', got {mode!r}")


# ---------------------------------------------------------------------------
# Transient-fault retry with deterministic backoff.
# ---------------------------------------------------------------------------

# CUDA runtime messages (``cudaGetErrorString``, as PyTorch raises them in a
# RuntimeError) of faults that a replay can outlive: the device was busy or
# not yet ready, or the display watchdog killed a launch.  Matched
# lowercase.  Deliberately short: an unknown error is not retried.
TRANSIENT_CUDA_PATTERNS = (
    "busy or unavailable",            # cudaErrorDevicesUnavailable
    "launch timed out",               # cudaErrorLaunchTimeout
    "system not yet initialized",     # cudaErrorSystemNotReady
    "temporarily unavailable",
)
# Host-side transport failures (a remote filesystem, a socket).
TRANSIENT_MESSAGE_PATTERNS = (
    "connection reset",
    "broken pipe",
    "failed to connect",
    "preempted",
    "transient",
)
# CUDA faults that leave the context unusable or repeat on every replay:
# never retried, whatever else the message says.
FATAL_CUDA_PATTERNS = (
    "out of memory",
    "illegal memory access",
    "illegal instruction",
    "misaligned address",
    "device-side assert",
    "unspecified launch failure",
    "ecc error",
    "too many resources requested",
    "no kernel image",
)


class InjectedTransientError(RuntimeError):
    """The deterministic stand-in for a transient device fault
    (``TransientInjector``); the classifier retries it by type."""


def classify_transient(exc: BaseException) -> bool:
    """True when ``exc`` is worth retrying.

    Never: ``SolverDivergenceError`` (numeric divergence is deterministic
    and belongs to the solver-health layer), ``Interrupted``, anything that
    is not an ``Exception``, programming errors (``ValueError``,
    ``TypeError``, ``KeyError``, ``AttributeError``), CUDA's out of memory
    (``torch.cuda.OutOfMemoryError``) and the CUDA faults of
    ``FATAL_CUDA_PATTERNS``.  Always: ``InjectedTransientError`` and
    ``ConnectionError``.  Otherwise a ``RuntimeError`` whose message
    carries one of ``TRANSIENT_CUDA_PATTERNS`` (a device busy or not
    ready, a watchdog-killed launch) or ``TRANSIENT_MESSAGE_PATTERNS``."""
    if isinstance(exc, (SolverDivergenceError, Interrupted)):
        return False
    if not isinstance(exc, Exception):
        return False
    if isinstance(exc, (InjectedTransientError, ConnectionError)):
        return True
    if isinstance(exc, (ValueError, TypeError, KeyError, AttributeError)):
        return False
    msg = str(exc).lower()
    if (type(exc).__name__ == "OutOfMemoryError"
            or any(p in msg for p in FATAL_CUDA_PATTERNS)):
        return False
    return (any(p in msg for p in TRANSIENT_CUDA_PATTERNS)
            or any(p in msg for p in TRANSIENT_MESSAGE_PATTERNS))


@dataclass
class RetryPolicy:
    """Deterministic exponential backoff: a transient failure of attempt
    ``i`` (0-based) sleeps ``min(base_delay * multiplier**i, max_delay)``
    before attempt ``i+1``; at most ``max_attempts`` attempts.  No jitter.
    ``sleep`` is injectable so tests capture the delays."""

    max_attempts: int = 3
    base_delay: float = 0.5
    multiplier: float = 2.0
    max_delay: float = 30.0
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)

    def delay(self, attempt: int) -> float:
        return float(min(self.base_delay * self.multiplier ** attempt,
                         self.max_delay))


class TransientInjector:
    """Raise-at-call-k fault injection: the k-th guarded call (0-based,
    counted across every ``retry_transient`` sharing this injector,
    retries included) raises ``InjectedTransientError``, ``times`` times
    in a row.  ``times=1`` exercises retry-then-succeed; ``times >=
    max_attempts`` exhausts the policy."""

    def __init__(self, at_call: int = 0, times: int = 1,
                 message: str = "CUDA error: all CUDA-capable devices are "
                                "busy or unavailable (injected)"):
        self.at_call = int(at_call)
        self.remaining = int(times)
        self.message = message
        self.calls = 0

    def before_call(self) -> None:
        k = self.calls
        self.calls += 1
        if self.remaining > 0 and k >= self.at_call:
            self.remaining -= 1
            raise InjectedTransientError(f"{self.message} (call {k})")


def retry_transient(fn: Callable[[], object],
                    policy: Optional[RetryPolicy] = None,
                    classify: Callable[[BaseException], bool] = None,
                    inject: Optional[TransientInjector] = None,
                    label: str = "device call"):
    """Call ``fn()`` with transient-fault retry under ``policy``: a
    failure ``classify`` calls transient is retried after the policy's
    backoff, with a warning; any other failure re-raises at once, and the
    last transient one re-raises when the attempts are spent.  The
    guarded calls are pure functions of immutable inputs (their random
    draws come from generators seeded inside them), so a replay computes
    the same bits."""
    policy = policy or RetryPolicy()
    classify = classify or classify_transient
    attempts = max(1, int(policy.max_attempts))
    for attempt in range(attempts):
        try:
            if inject is not None:
                inject.before_call()
            return fn()
        except BaseException as e:   # noqa: BLE001 — the classifier decides
            if not classify(e) or attempt == attempts - 1:
                raise
            d = policy.delay(attempt)
            emit_event("RETRY_TRANSIENT", label=label,
                       attempt=attempt + 1, max_attempts=attempts,
                       delay_s=d,
                       error=f"{type(e).__name__}: {str(e)[:160]}")
            warnings.warn(
                f"transient fault in {label} (attempt {attempt + 1}/"
                f"{attempts}): {type(e).__name__}: {str(e)[:200]} — "
                f"retrying in {d:g}s", stacklevel=2)
            policy.sleep(d)
    raise AssertionError("unreachable")


# ---------------------------------------------------------------------------
# Durable sweep resume: the per-bucket ledger.
# ---------------------------------------------------------------------------

class SweepLedger(NamedTuple):
    """A sweep in progress on disk (one atomic npz, the JAX package's
    eight-leaf layout): the packed rows in the original cell order and
    the bookkeeping the resume needs.

    ``packed`` rows are the batched solver's rows as they reached the
    host (float64 round-trips npz bit for bit), so a resumed assembly is
    bitwise an uninterrupted one.  ``fingerprint`` (``fingerprint.
    ledger_fingerprint``) covers everything that shapes those bits; a
    mismatch starts the sweep afresh, with a warning.  ``checksums`` are
    per-row ``packed_row_checksum`` values taken at solve time, before
    the first flush: a row that no longer hashes to its checksum is
    cleared and recomputed, the others restored."""

    packed: np.ndarray       # [C, W] float64; NaN rows = not yet solved
    solved: np.ndarray       # [C] bool: batched result present
    bucket: np.ndarray       # [C] int64 launch group (-1 = unassigned)
    pred: np.ndarray         # [C] float64 scheduler work model
    retries: np.ndarray      # [C] int64 quarantine rungs consumed
    retried: np.ndarray      # [C] bool: the quarantine outcome is final
    checksums: np.ndarray    # [C] int64 solve-time row checksums (0 unset)
    fingerprint: np.ndarray  # scalar int64


def _ledger_template(n: int, width: int) -> SweepLedger:
    return SweepLedger(
        packed=np.full((n, int(width)), np.nan),
        solved=np.zeros(n, dtype=bool),
        bucket=np.full(n, -1, dtype=np.int64),
        pred=np.full(n, np.nan),
        retries=np.zeros(n, dtype=np.int64),
        retried=np.zeros(n, dtype=bool),
        checksums=np.zeros(n, dtype=np.int64),
        fingerprint=np.zeros((), np.int64))


class LedgerState:
    """The host-side, mutable ledger: the sweep records progress here and
    ``flush()``es after every bucket and every quarantine walk, each flush
    one atomic replace (a kill leaves the previous or the new ledger,
    never a torn one).  ``complete()`` removes the file: a finished run
    must not satisfy the next run's launches."""

    def __init__(self, path: str, fingerprint: int, n_cells: int,
                 width: int = 10):
        self.path = path
        self.fingerprint = int(fingerprint)
        self.width = int(width)
        t = _ledger_template(n_cells, width)
        self.packed = t.packed
        self.solved = t.solved
        self.bucket = t.bucket
        self.pred = t.pred
        self.retries = t.retries
        self.retried = t.retried
        self.checksums = t.checksums
        self.resumed = False       # a prior run's progress was restored
        self.corrupt_cells = []    # cells whose row failed its checksum

    @classmethod
    def resume(cls, path: str, fingerprint: int, n_cells: int,
               width: int = 10) -> "LedgerState":
        """A fresh state, or the prior run's when ``path`` holds a ledger
        of the same run (equal fingerprint).  A missing file is the first
        run; an unreadable or foreign one warns and starts fresh (the
        first flush overwrites it)."""
        self = cls(path, fingerprint, n_cells, width=width)
        gc_orphaned_tmp(path)     # a prior hard kill may have stranded tmps
        if not os.path.exists(path):
            return self
        try:
            led = load_pytree(path, _ledger_template(n_cells, width))
        except CORRUPT_NPZ_ERRORS as e:
            warnings.warn(f"sweep resume ledger {path} unreadable ({e}); "
                          f"starting fresh", stacklevel=2)
            return self
        if int(led.fingerprint) != int(fingerprint):
            warnings.warn(
                f"sweep resume ledger {path} was written by a different "
                f"run (fingerprint {int(led.fingerprint)} vs "
                f"{int(fingerprint)}); starting fresh", stacklevel=2)
            return self
        self.packed = np.array(led.packed)
        self.solved = np.array(led.solved)
        self.bucket = np.array(led.bucket)
        self.pred = np.array(led.pred)
        self.retries = np.array(led.retries)
        self.retried = np.array(led.retried)
        self.checksums = np.array(led.checksums)
        self._verify_rows()
        self.resumed = bool(self.solved.any() or self.retried.any())
        if self.resumed:
            emit_event("RESUME_RESTORE", path=path,
                       cells_restored=int(self.solved.sum()),
                       cells_retried=int(self.retried.sum()),
                       corrupt_cells=list(self.corrupt_cells))
        return self

    def _verify_rows(self) -> None:
        """Every row the ledger claims solved or retried must still hash
        to its solve-time checksum; a row that does not is cleared (the
        sweep recomputes it and its bucket) and named in a warning.  The
        other rows are restored untouched."""
        claimed = self.solved | self.retried
        bad = [int(i) for i in np.nonzero(claimed)[0]
               if packed_row_checksum(self.packed[i])
               != int(self.checksums[i])]
        if not bad:
            return
        for i in bad:
            self.packed[i] = np.nan
            self.solved[i] = False
            self.retried[i] = False
            self.retries[i] = 0
            self.bucket[i] = -1
            self.checksums[i] = 0
        self.corrupt_cells = bad
        emit_event("INTEGRITY_FAILED", boundary="ledger",
                   path=self.path, cells=bad)
        warnings.warn(
            f"sweep resume ledger {self.path}: row checksum verification "
            f"failed for cell(s) {bad} — silent corruption; those cells "
            "are quarantined and will be recomputed", stacklevel=3)

    def record_bucket(self, cells: np.ndarray, rows: np.ndarray,
                      bucket_id: int) -> None:
        """A bucket's launch finished: store its rows, with their
        checksums taken now, before any flush."""
        self.packed[cells] = rows
        self.solved[cells] = True
        self.bucket[cells] = bucket_id
        self.checksums[cells] = packed_row_checksums(rows)

    def record_retry(self, cell: int, row: np.ndarray,
                     attempts: int) -> None:
        """A quarantined cell's ladder walk finished (recovered or not):
        its outcome is final for this run."""
        self.packed[cell] = row
        self.retries[cell] = attempts
        self.retried[cell] = True
        self.checksums[cell] = packed_row_checksum(row)

    def flush(self) -> None:
        """Write the ledger.  A disk fault (ENOSPC, EIO; injected or real)
        skips this flush with a warning: the sweep goes on from memory and
        only its resume coverage lags until a flush lands."""
        try:
            save_pytree(self.path, SweepLedger(
                packed=self.packed, solved=self.solved, bucket=self.bucket,
                pred=self.pred, retries=self.retries, retried=self.retried,
                checksums=self.checksums,
                fingerprint=np.asarray(self.fingerprint, np.int64)))
        except OSError as e:
            emit_event("DISK_FAULT", op="ledger_flush", path=self.path,
                       error=str(e), injected=False)
            warnings.warn(
                f"sweep ledger flush to {self.path} failed ({e}); "
                "skipping this flush — the sweep continues from memory "
                "and resume coverage lags until a flush lands",
                stacklevel=3)

    def complete(self) -> None:
        try:
            os.remove(self.path)
        except OSError:
            pass
