"""Solver-health status codes for every fixed point of the port.

Counterpart of ``aiyagari_hark_tpu/solver_health.py``: the same codes,
ordered by severity so the worst status of a composite solve is the
elementwise maximum (``combine_status``).

    CONVERGED (0) < STALLED (1) < MAX_ITER (2) < NONFINITE (3)

``classify_fixed_point_exit`` rebuilds a loop's status from its exit
state ``(diff, iters)``; the CUDA kernels return only that pair, exactly
as the TPU kernels do.
"""

from __future__ import annotations

import torch

CONVERGED = 0
STALLED = 1
MAX_ITER = 2
NONFINITE = 3

STATUS_NAMES = ("CONVERGED", "STALLED", "MAX_ITER", "NONFINITE")


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
