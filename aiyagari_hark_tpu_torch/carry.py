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
from .utils.config import SweepConfig


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


def ez_policy_from_numpy(m_knots, c_knots, v_knots, device=None,
                         dtype=None):
    """The port's ``EZPolicy`` from knot arrays [N, A+1] (or
    [C, N, A+1]): the Epstein-Zin consumption and value knots."""
    from .models.epstein_zin import EZPolicy

    return EZPolicy(*(_tensor(x, device, dtype)
                      for x in (m_knots, c_knots, v_knots)))


def labor_model_from_numpy(base_fields, frisch, labor_weight, device=None,
                           dtype=None):
    """The port's ``LaborModel`` from the JAX one's arrays: the base
    ``SimpleModel``'s fields (as ``model_from_numpy`` takes them), the
    Frisch elasticity and the disutility weight."""
    from .models.labor import LaborModel

    base = model_from_numpy(base_fields, device, dtype)
    return LaborModel(base=base, frisch=_tensor(frisch, device, dtype),
                      labor_weight=_tensor(labor_weight, device, dtype))


def labor_policy_from_numpy(a_knots, c_knots, n_knots, device=None,
                            dtype=None):
    """The port's ``LaborPolicy`` from knot arrays [N, A]."""
    from .models.labor import LaborPolicy

    return LaborPolicy(*(_tensor(x, device, dtype)
                         for x in (a_knots, c_knots, n_knots)))


def value_function_from_numpy(m_knots, vnvrs_knots, disc_fac, device=None,
                              dtype=None):
    """The port's ``ValueFunction`` from the JAX one's arrays (knots
    [N, K] and the scalar discount factor)."""
    from .models.value import ValueFunction

    return ValueFunction(*(_tensor(x, device, dtype)
                           for x in (m_knots, vnvrs_knots, disc_fac)))


def dist_from_numpy(dist, device=None, dtype=None) -> torch.Tensor:
    """A wealth distribution [D, N] (or [C, D, N]) as a tensor."""
    return _tensor(dist, device, dtype)


def sweep_config_from_fields(d: dict) -> SweepConfig:
    """The port's ``SweepConfig`` from the JAX one's fields
    (``dataclasses.asdict``): the same 17 names.  An ``obs`` given as the
    fields of the JAX ``ObsConfig`` (``asdict`` recurses into it) becomes
    the port's ``ObsConfig`` with the same 10 fields; an unknown or
    missing field raises ``TypeError``."""
    d = dict(d)
    if isinstance(d.get("obs"), dict):
        from .obs.runtime import ObsConfig

        d["obs"] = ObsConfig(**d["obs"])
    return SweepConfig(**d)


def portfolio_model_from_numpy(fields, device=None, dtype=None):
    """The port's ``PortfolioModel`` from the JAX one's arrays in field
    order (``a_grid, labor_levels, transition, labor_stationary,
    risky_returns, risky_probs, share_grid, dist_grid``; the JAX model
    itself is such a sequence); a missing or None ``dist_grid`` stays
    None."""
    from .models.portfolio import PortfolioModel

    fields = list(fields)
    n = len(PortfolioModel._fields)
    if len(fields) not in (n - 1, n):
        raise ValueError(f"portfolio_model_from_numpy: expected the {n} "
                         f"fields {PortfolioModel._fields}, got "
                         f"{len(fields)}")
    return PortfolioModel(*(None if f is None else _tensor(f, device, dtype)
                            for f in fields))


def portfolio_policy_from_numpy(m_knots, c_knots, share, device=None,
                                dtype=None):
    """The port's ``PortfolioPolicy`` from knot arrays [N, A+1] and the
    risky share [N, A]."""
    from .models.portfolio import PortfolioPolicy

    return PortfolioPolicy(*(_tensor(x, device, dtype)
                             for x in (m_knots, c_knots, share)))
