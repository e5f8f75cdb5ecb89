"""Solver-health status codes for every fixed point of the port.

Counterpart of ``aiyagari_hark_tpu/solver_health.py``: the same codes,
ordered by severity so the worst status of a composite solve is the
elementwise maximum (``combine_status``).

    CONVERGED (0) < STALLED (1) < MAX_ITER (2) < NONFINITE (3)
    < INTERRUPTED (4, process-level: a run stopped on a shutdown request)

and the serving tier's process-level outcomes, which no loop returns:
DEADLINE_EXCEEDED (5), OVERLOADED (6), LOAD_SHED (7), CIRCUIT_OPEN (8)
and BACKEND_FAULT (9).

``classify_fixed_point_exit`` rebuilds a loop's status from its exit
state ``(diff, iters)``; the CUDA kernels return only that pair, exactly
as the TPU kernels do.

``inject_fault`` wraps a fixed-point step so that it misbehaves from a
given step on: the deterministic drill of the NONFINITE, MAX_ITER and
STALLED exits and of the ladders' escalation.  Only the plain loops take
a step function, so the drills run on CPU tensors.
"""

from __future__ import annotations

import torch

CONVERGED = 0
STALLED = 1
MAX_ITER = 2
NONFINITE = 3
# Process-level, never returned by a loop: a run stopped at a safe
# boundary on a shutdown request (``utils.resilience.Interrupted``); no
# numbers were produced, so it sits on the failure side of ``is_failure``.
INTERRUPTED = 4
# Process-level serving outcomes (``serve.service``'s typed errors).  No
# numbers were produced for any of them, so all sit on the failure side
# of ``is_failure``; they never enter ``combine_status``.
# DEADLINE_EXCEEDED: a query's deadline expired before its batch launched.
DEADLINE_EXCEEDED = 5
# OVERLOADED: admission control rejected the query fail-fast (class
# budget, unmeetable deadline or a full queue).
OVERLOADED = 6
# LOAD_SHED: a queued lower-priority query was displaced by a
# higher-priority arrival.
LOAD_SHED = 7
# CIRCUIT_OPEN: the query's (sigma, rho, sd) region has an open circuit
# breaker after repeated failures.
CIRCUIT_OPEN = 8
# BACKEND_FAULT: a lease-backend or store operation failed or degraded
# (journaled as ``LEASE_BACKEND_FAULT``).
BACKEND_FAULT = 9

STATUS_NAMES = ("CONVERGED", "STALLED", "MAX_ITER", "NONFINITE",
                "INTERRUPTED", "DEADLINE_EXCEEDED", "OVERLOADED",
                "LOAD_SHED", "CIRCUIT_OPEN", "BACKEND_FAULT")

# Notes, not status codes (they never enter ``combine_status``): a ladder's
# cheap phase exited NONFINITE or STALLED and the polish restarted from
# the caller's initial iterate, a pure reference solve.  The precision
# ladder's descent (PRECISION_ESCALATED) and the grid ladder's coarse
# phase (GRID_ESCALATED) count in the same ``PrecisionPhases.escalated``
# slot.
PRECISION_ESCALATED = "PRECISION_ESCALATED"
GRID_ESCALATED = "GRID_ESCALATED"


def status_name(code) -> str:
    """Host-side name of one integer status code."""
    code = int(code)
    if 0 <= code < len(STATUS_NAMES):
        return STATUS_NAMES[code]
    return f"UNKNOWN({code})"


def combine_status(*codes) -> torch.Tensor:
    """Worst of several status codes, elementwise (int32 tensors or
    ints; ints broadcast against the first tensor argument)."""
    ref = next((c for c in codes if isinstance(c, torch.Tensor)), None)
    device = None if ref is None else ref.device
    out = torch.as_tensor(codes[0], dtype=torch.int32, device=device)
    for c in codes[1:]:
        out = torch.maximum(out, torch.as_tensor(c, dtype=torch.int32,
                                                 device=device))
    return out


def classify_fixed_point_exit(diff, tol, it, max_iter) -> torch.Tensor:
    """Status from a fixed-point loop's exit state, elementwise.

    ``diff`` is the loop's last certified residual (non-finite iff the
    tripwire fired) and ``it`` the steps taken.  A finite ``diff > tol``
    that exits before ``max_iter`` can only be a stall window."""
    diff = torch.as_tensor(diff)
    it = torch.as_tensor(it, device=diff.device)

    def code(c):
        return torch.full(diff.shape, c, dtype=torch.int32,
                          device=diff.device)

    return torch.where(
        ~torch.isfinite(diff), code(NONFINITE),
        torch.where(diff <= tol, code(CONVERGED),
                    torch.where(it >= max_iter, code(MAX_ITER),
                                code(STALLED))))


def is_failure(status):
    """True where a status means the result is uncertified or garbage
    (``MAX_ITER`` or ``NONFINITE``); ``STALLED`` is benign."""
    return status >= MAX_ITER


class SolverDivergenceError(RuntimeError):
    """A solve produced an uncertified or non-finite result.  Carries
    ``status`` (the worst status code observed) and ``trail`` (a list of
    per-stage or per-iteration dicts of what was tried and how each
    attempt exited)."""

    def __init__(self, message: str, status=None, trail=None):
        super().__init__(message)
        self.status = None if status is None else int(status)
        self.trail = list(trail) if trail is not None else []


def _map_fields(fn, x):
    """``fn`` on a tensor, or on every field of a NamedTuple of tensors."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    return type(x)(*(fn(f) for f in x))


def inject_fault(step_fn, mode: str = "nan", at_iter: int = 0,
                 amplitude: float = 1e-3):
    """Wrap a step ``x -> x'`` into one that takes the step index (the
    loops see ``takes_iteration`` and pass it) and misbehaves from step
    ``at_iter`` on: ``"nan"`` makes every field NaN (the NONFINITE
    tripwire); ``"stall"`` adds ``+amplitude`` on even and ``-amplitude``
    on odd steps to every element, pinning the sup-norm diff near
    ``2 amplitude`` (the MAX_ITER exit of the policy loop, the STALLED
    exit of the distribution loop; pick ``amplitude > tol``).  The offset
    is uniform, so increasing knots stay increasing."""
    if mode not in ("nan", "stall"):
        raise ValueError(f"inject_fault mode must be 'nan' or 'stall', "
                         f"got {mode!r}")

    def wrapped(x, it: int):
        out = step_fn(x)
        if it < at_iter:
            return out
        if mode == "nan":
            return _map_fields(lambda t: torch.full_like(t, float("nan")),
                               out)
        off = amplitude if it % 2 == 0 else -amplitude
        return _map_fields(
            lambda t: t + torch.tensor(off, dtype=t.dtype, device=t.device),
            out)

    wrapped.takes_iteration = True
    return wrapped


def call_step(step_fn, x, it: int):
    """Call a fixed-point step, passing the step index ``it`` only if the
    step has ``takes_iteration`` (``inject_fault``'s wrapper does)."""
    if getattr(step_fn, "takes_iteration", False):
        return step_fn(x, it)
    return step_fn(x)
