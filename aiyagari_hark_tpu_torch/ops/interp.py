"""Piecewise-linear interpolation (port of
``aiyagari_hark_tpu/ops/interp.py``).

HARK ``LinearInterp`` semantics: linear between knots, linear
extrapolation beyond both ends along the terminal segments.  The bracket
index is ``clip(searchsorted(side="right") - 1, 0, K-2)``;
``torch.searchsorted(..., right=True)`` gives the same count.
"""

from __future__ import annotations

import torch


def _bracket(xp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    k = xp.shape[-1]
    return torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0, k - 2)


def _lerp(x, xp, fp, i):
    x0 = torch.gather(xp, -1, i)
    x1 = torch.gather(xp, -1, i + 1)
    f0 = torch.gather(fp, -1, i)
    f1 = torch.gather(fp, -1, i + 1)
    slope = (f1 - f0) / (x1 - x0)
    return f0 + slope * (x - x0)


def interp1d(x: torch.Tensor, xp: torch.Tensor,
             fp: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of queries ``x`` (any shape) on one knot
    vector ``xp`` [K] with values ``fp`` [K]."""
    i = _bracket(xp, x)
    flat = i.reshape(-1)
    out = _lerp(x.reshape(-1), xp, fp, flat)
    return out.reshape(x.shape)


def interp1d_rowwise(x: torch.Tensor, xp: torch.Tensor,
                     fp: torch.Tensor) -> torch.Tensor:
    """Each row of queries ``x`` [..., Q] on its own knots ``xp``/``fp``
    [..., K] (the per-state endogenous grid of EGM)."""
    xp = xp.contiguous()
    x = x.contiguous()
    return _lerp(x, xp, fp, _bracket(xp, x))


def append_tail_knot(m_knots: torch.Tensor, c_knots: torch.Tensor, slope):
    """Close knot arrays ``[..., N, K]`` with one linear tail knot per
    state, one span (the knots' width, floored at 1) past the last knot,
    on the line of ``slope``: every evaluation above the old top knot
    then rides ``c_top + slope (m - m_top)``.  Returns ``[..., N, K+1]``."""
    m_top = m_knots[..., -1:]
    span = torch.clamp_min(m_top - m_knots[..., :1], 1.0)
    return (torch.cat([m_knots, m_top + span], dim=-1),
            torch.cat([c_knots, c_knots[..., -1:] + slope * span], dim=-1))


def locate_in_grid(x: torch.Tensor, grid: torch.Tensor):
    """Young-lottery bracket index and right-neighbour weight of ``x`` on
    ``grid``; the weight is clipped to [0, 1] so mass never leaves the
    histogram.  ``grid`` is [G] (any shape of ``x``) or [..., G] with
    ``x`` [..., Q] (one grid per row).  Returns (int64 index, weight)."""
    x = x.contiguous()
    if grid.dim() == 1:
        i = _bracket(grid, x)
        g0, g1 = grid[i], grid[i + 1]
    else:
        grid = grid.contiguous()
        i = _bracket(grid, x)
        g0 = torch.gather(grid, -1, i)
        g1 = torch.gather(grid, -1, i + 1)
    w = (x - g0) / (g1 - g0)
    return i, torch.clamp(w, 0.0, 1.0)
