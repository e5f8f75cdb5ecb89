"""Graceful shutdown and transient-fault retry (port of the parts of
``aiyagari_hark_tpu/utils/resilience.py`` the Krusell-Smith outer loop
uses).

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

Host-side only.  Not ported yet: the sweep's resume ledger
(``SweepLedger`` / ``LedgerState``, ROADMAP Queue 1 item 3), the guard's
sweep of orphaned temp files (``gc_orphaned_tmp``, item 8), and the
``INTERRUPTED`` / ``RETRY_TRANSIENT`` event journal (item 8).
"""

from __future__ import annotations

import os
import signal
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..solver_health import INTERRUPTED, SolverDivergenceError


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
        raise Interrupted(
            f"{what} interrupted at a safe boundary{name}"
            + (f"; resume from {resume_path}" if resume_path else ""),
            resume_path=resume_path, signum=sig, progress=progress)


class preemption_guard:
    """Context manager installing SIGTERM/SIGINT handlers that request a
    graceful shutdown.  The first signal sets the flag; a second raises
    ``KeyboardInterrupt`` at once.  Handlers are restored on exit, and
    the outermost guard's exit clears the flag.  Guards nest; outside the
    main thread the guard is flag-only."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._previous: dict = {}

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
            warnings.warn(
                f"transient fault in {label} (attempt {attempt + 1}/"
                f"{attempts}): {type(e).__name__}: {str(e)[:200]} — "
                f"retrying in {d:g}s", stacklevel=2)
            policy.sleep(d)
    raise AssertionError("unreachable")
