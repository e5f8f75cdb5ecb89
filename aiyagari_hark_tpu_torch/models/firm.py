"""Cobb-Douglas production side (port of
``aiyagari_hark_tpu/models/firm.py``): closed forms, elementwise, and the
perfect-foresight steady state.

    R = 1 + Z a (K/L)^(a-1) - d,   W = Z (1-a) (K/L)^a
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def interest_factor(k_to_l, cap_share, depr_fac, prod=1.0):
    """Gross return on capital R = 1 + Z a (K/L)^(a-1) - d."""
    return 1.0 + prod * cap_share * k_to_l ** (cap_share - 1.0) - depr_fac


def wage_rate(k_to_l, cap_share, prod=1.0):
    """Wage W = Z (1-a) (K/L)^a."""
    return prod * (1.0 - cap_share) * k_to_l ** cap_share


def k_to_l_from_r(r, cap_share, depr_fac, prod=1.0):
    """The K/L ratio at which the net interest rate is ``r``: the firm's
    capital demand per unit labor."""
    return ((r + depr_fac) / (prod * cap_share)) ** (1.0 / (cap_share - 1.0))


def output(k, l, cap_share, prod=1.0):
    """Gross output Y = Z K^a L^(1-a)."""
    return prod * k ** cap_share * l ** (1.0 - cap_share)


def aggregate_resources(k, l, cap_share, depr_fac, prod=1.0):
    """M = (1-d) K + Z K^a L^(1-a)."""
    return (1.0 - depr_fac) * k + output(k, l, cap_share, prod)


class SteadyState(NamedTuple):
    k_to_l: torch.Tensor
    K: torch.Tensor
    W: torch.Tensor
    R: torch.Tensor
    M: torch.Tensor


def perfect_foresight_steady_state(disc_fac, cap_share, depr_fac,
                                   lbr_ind=1.0, device="cpu") -> SteadyState:
    """The representative-agent steady state that seeds the simulation
    and centres the M grid (``Aiyagari_Support.py:1606-1615``): R = 1/beta
    pins down K/L.  Computed in Python floats (float64), each field a 0-d
    float64 tensor, as the JAX package's weakly typed scalars."""
    k_to_l = ((1.0 / disc_fac - (1.0 - depr_fac)) / cap_share) ** (
        1.0 / (cap_share - 1.0))
    K = k_to_l * lbr_ind
    W = wage_rate(k_to_l, cap_share)
    R = interest_factor(k_to_l, cap_share, depr_fac)
    M = K * R + W * lbr_ind

    def t(x):
        return torch.tensor(float(x), dtype=torch.float64, device=device)

    return SteadyState(k_to_l=t(k_to_l), K=t(K), W=t(W), R=t(R), M=t(M))
