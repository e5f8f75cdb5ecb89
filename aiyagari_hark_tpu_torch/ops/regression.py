"""Closed-form OLS for the Krusell-Smith aggregate-law regression (port of
``aiyagari_hark_tpu/ops/regression.py``).

The reference calls ``scipy.stats.linregress(logM[these], logA[these])``
per aggregate state (``Aiyagari_Support.py:1931-1935``).  Here the mask
enters as 0/1 weights, so shapes stay fixed and nothing syncs with the
host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class OLSResult(NamedTuple):
    slope: torch.Tensor
    intercept: torch.Tensor
    r_squared: torch.Tensor


def masked_ols(x: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor) -> OLSResult:
    """Simple OLS of ``y`` on ``x`` over the entries where ``mask`` is
    true (all [T]).  An empty mask gives NaN slope and intercept;
    degenerate variance gives r_squared 0 (scipy's convention)."""
    w = mask.to(x.dtype)
    n = torch.sum(w)
    n_safe = torch.clamp_min(n, 1.0)
    xm = torch.sum(w * x) / n_safe
    ym = torch.sum(w * y) / n_safe
    sxx = torch.sum(w * (x - xm) ** 2)
    sxy = torch.sum(w * (x - xm) * (y - ym))
    syy = torch.sum(w * (y - ym) ** 2)
    nan = torch.full_like(xm, float("nan"))
    slope = torch.where(n > 0, sxy / sxx, nan)
    intercept = torch.where(n > 0, ym - slope * xm, nan)
    r_squared = torch.where((syy > 0) & (sxx > 0) & (n > 0),
                            sxy ** 2 / (sxx * syy), torch.zeros_like(syy))
    return OLSResult(slope=slope, intercept=intercept, r_squared=r_squared)
