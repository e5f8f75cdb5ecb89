"""Sanitizers: NaN/Inf detection inside a computation and host-side
invariant checks (port of ``aiyagari_hark_tpu/utils/debug.py``).

* ``checked_call`` runs a computation with every PyTorch operator's
  floating output checked for NaN and Inf, so a NaN born inside a
  fixed-point loop raises at the operator that made it, named, instead of
  propagating into the fixed point.  It is the counterpart of the JAX
  package's ``checkify`` float checks, built on a dispatch mode: each
  checked output costs a host sync, so it is a debugging tool.  The CUDA
  kernels of ``ops.kernels`` write into tensors PyTorch allocated and are
  not operators of the dispatcher: a NaN they make surfaces at the first
  operator that reads it.
* ``nan_guard`` is the same check as a context manager (the JAX
  package's ``jax_debug_nans`` toggle).
* ``validate_policy`` / ``validate_distribution``: host-side invariants
  (finite, monotone knots, positive consumption; mass one, non-negative)
  for phase boundaries.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _float_check_mode():
    """A dispatch mode raising ``FloatingPointError`` at the first
    operator whose floating output holds a NaN or an Inf (the mode is
    off inside its own handler, so the check itself is not checked)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class FloatCheck(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for leaf in tree_leaves(out):
                if (isinstance(leaf, torch.Tensor)
                        and leaf.is_floating_point() and leaf.numel()
                        and not bool(torch.isfinite(leaf).all())):
                    kind = "nan" if bool(torch.isnan(leaf).any()) else "inf"
                    raise FloatingPointError(
                        f"{kind} generated by {func} (output shape "
                        f"{tuple(leaf.shape)})")
            return out

    return FloatCheck()


@contextlib.contextmanager
def nan_guard():
    """Within the block, every PyTorch operator's floating output is
    checked and the first NaN or Inf raises ``FloatingPointError``."""
    with _float_check_mode():
        yield


def checked_call(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under ``nan_guard``: a NaN, Inf or
    division by zero made anywhere inside, loops included, raises
    ``FloatingPointError`` naming the operator.  Returns ``fn``'s outputs
    unchanged on success.  Slow (a host sync per operator): run it on a
    failing configuration, not in production."""
    with nan_guard():
        return fn(*args, **kwargs)


def validate_policy(policy, name: str = "policy") -> None:
    """Host-side invariants of a consumption policy (a ``HouseholdPolicy``,
    a KS policy per state, or the consumption part of a
    ``PortfolioPolicy``): finite knots, strictly increasing endogenous
    m-knots (EGM's output must be sortable), positive consumption."""
    m = _host(policy.m_knots)
    c = _host(policy.c_knots)
    if not np.isfinite(m).all() or not np.isfinite(c).all():
        raise ValueError(f"{name}: non-finite knots "
                         f"(m finite={np.isfinite(m).all()}, "
                         f"c finite={np.isfinite(c).all()})")
    if not (c > 0).all():
        raise ValueError(f"{name}: non-positive consumption knots "
                         f"(min={c.min()})")
    dm = np.diff(m, axis=-1)
    if not (dm > 0).all():
        bad = int((dm <= 0).sum())
        raise ValueError(f"{name}: {bad} non-increasing m-knot segments — "
                         f"EGM grid not sortable (crossing policy update)")


def validate_distribution(dist, name: str = "distribution",
                          atol: float = 1e-8) -> None:
    """Host-side invariants of a wealth histogram: non-negative, total mass
    one (the lottery conserves mass; a violation means a corrupted
    transition or an unnormalised extrapolation)."""
    d = _host(dist)
    if not np.isfinite(d).all():
        raise ValueError(f"{name}: non-finite mass entries")
    if (d < -atol).any():
        raise ValueError(f"{name}: negative mass (min={d.min()})")
    total = float(d.sum())
    if abs(total - 1.0) > atol:
        raise ValueError(f"{name}: total mass {total} != 1")
