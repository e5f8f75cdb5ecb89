"""Cobb-Douglas production side (port of
``aiyagari_hark_tpu/models/firm.py``): closed forms, elementwise.

    R = 1 + Z a (K/L)^(a-1) - d,   W = Z (1-a) (K/L)^a
"""

from __future__ import annotations


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
