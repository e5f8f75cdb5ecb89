"""Carry state across from the JAX package: its arrays, as NumPy, become
the port's tensors bit for bit (the counterpart of a weight loader).

The caller converts each JAX field with ``np.asarray``; nothing here
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.household import HouseholdPolicy, SimpleModel


def _tensor(x, device, dtype) -> torch.Tensor:
    arr = np.array(x)   # a writable copy: JAX hands out read-only views
    dt = dtype if dtype is not None else torch.from_numpy(
        np.zeros((), dtype=arr.dtype)).dtype
    return torch.as_tensor(arr, dtype=dt, device=resolve_device(device))


def model_from_numpy(fields, device=None, dtype=None) -> SimpleModel:
    """The port's ``SimpleModel`` from the JAX ``SimpleModel``'s arrays in
    field order (``a_grid, labor_levels, transition, labor_stationary,
    dist_grid, borrow_limit``); the JAX model itself is such a sequence.
    ``dtype=None`` keeps the arrays' own dtype."""
    fields = list(fields)
    if len(fields) != len(SimpleModel._fields):
        raise ValueError(f"model_from_numpy: expected the "
                         f"{len(SimpleModel._fields)} fields "
                         f"{SimpleModel._fields}, got {len(fields)}")
    return SimpleModel(*(_tensor(f, device, dtype) for f in fields))


def policy_from_numpy(m_knots, c_knots, device=None,
                      dtype=None) -> HouseholdPolicy:
    """The port's ``HouseholdPolicy`` from knot arrays [N, A+1] (or
    [C, N, A+1])."""
    return HouseholdPolicy(m_knots=_tensor(m_knots, device, dtype),
                           c_knots=_tensor(c_knots, device, dtype))


def dist_from_numpy(dist, device=None, dtype=None) -> torch.Tensor:
    """A wealth distribution [D, N] (or [C, D, N]) as a tensor."""
    return _tensor(dist, device, dtype)
