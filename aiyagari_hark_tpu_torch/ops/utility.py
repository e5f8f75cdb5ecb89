"""CRRA utility family (port of ``aiyagari_hark_tpu/ops/utility.py``).

Closed forms, elementwise.  ``crra`` may be a Python float or a tensor
that broadcasts against ``c`` (one value per sweep lane).
"""

from __future__ import annotations

import torch


def crra_utility(c: torch.Tensor, crra) -> torch.Tensor:
    """u(c); log utility at crra == 1 (elementwise when ``crra`` is a
    tensor: both limbs are evaluated and the power limb is guarded
    against the crra == 1 pole)."""
    if not isinstance(crra, torch.Tensor):
        crra = float(crra)
        if crra == 1.0:
            return torch.log(c)
        return c ** (1.0 - crra) / (1.0 - crra)
    is_log = crra == 1.0
    safe = torch.where(is_log, torch.full_like(crra, 2.0), crra)
    power = c ** (1.0 - safe) / (1.0 - safe)
    return torch.where(is_log, torch.log(c), power)


def marginal_utility(c: torch.Tensor, crra) -> torch.Tensor:
    """u'(c) = c^(-crra)."""
    return c ** (-crra)


def inverse_marginal_utility(vp: torch.Tensor, crra) -> torch.Tensor:
    """(u')^{-1}(x) = x^(-1/crra) -- the EGM first-order-condition
    inversion."""
    return vp ** (-1.0 / crra)


def asymptotic_mpc(R, disc_fac, crra):
    """The perfect-foresight limit of the marginal propensity to consume,
    ``kappa = 1 - (beta R)^(1/crra) / R`` (Ma-Stachurski-Toda): the slope
    of the analytic tail that closes a compact-grid policy.  Arguments
    may be tensors of one value per lane."""
    return 1.0 - (disc_fac * R) ** (1.0 / crra) / R
