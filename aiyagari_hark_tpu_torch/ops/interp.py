"""Piecewise-linear interpolation (port of
``aiyagari_hark_tpu/ops/interp.py``).

HARK ``LinearInterp`` semantics: linear between knots, linear
extrapolation beyond both ends along the terminal segments; the two-level
evaluation of the Krusell-Smith policies (``interp_on_interp``,
``eval_policy_agents``) interpolates in ``m`` within the two bracketing
M-columns, then linearly in ``M``.  The bracket index is
``clip(searchsorted(side="right") - 1, 0, K-2)``;
``torch.searchsorted(..., right=True)`` gives the same count.
"""

from __future__ import annotations

import torch


def _bracket(xp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    k = xp.shape[-1]
    return torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0, k - 2)


def _lerp(x, xp, fp, i):
    i1 = i + 1
    x0 = torch.gather(xp, -1, i)
    x1 = torch.gather(xp, -1, i1)
    f0 = torch.gather(fp, -1, i)
    f1 = torch.gather(fp, -1, i1)
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


def m_bracket(M, Mgrid: torch.Tensor):
    """The two bracketing M-columns ``[j, j+1]`` of aggregate states ``M``
    (a tensor of any shape, on the device: no host sync) and the weight
    of column ``j+1``: ``cols`` [..., 2], ``w`` [...]; linear
    extrapolation beyond both ends."""
    M = torch.as_tensor(M, dtype=Mgrid.dtype, device=Mgrid.device)
    j = _bracket(Mgrid, M.reshape(-1)).reshape(M.shape)
    cols = j[..., None] + torch.arange(2, device=j.device)
    g = Mgrid[cols]
    w = (M - g[..., 0]) / (g[..., 1] - g[..., 0])
    return cols, w


def interp_on_interp(m: torch.Tensor, M, Mgrid: torch.Tensor,
                     m_knots: torch.Tensor,
                     f_knots: torch.Tensor) -> torch.Tensor:
    """Two-level policy evaluation at one aggregate state ``M``: ``m``
    [...] queries, ``Mgrid`` [Mc], knots [Mc, K].  Interpolates in ``m``
    within the two bracketing M-columns, then linearly in ``M`` (the
    reference's ``LinearInterpOnInterp1D``, ``Aiyagari_Support.py:
    1512-1513``)."""
    m = torch.as_tensor(m, dtype=m_knots.dtype, device=m_knots.device)
    cols, w = m_bracket(M, Mgrid)
    x = m.reshape(1, -1).expand(2, -1)
    v = interp1d_rowwise(x, m_knots[cols], f_knots[cols])
    return (v[0] + w * (v[1] - v[0])).reshape(m.shape)


def eval_policy_columns(m: torch.Tensor, state_idx: torch.Tensor,
                        cols: torch.Tensor, w, m_knots: torch.Tensor,
                        f_knots: torch.Tensor) -> torch.Tensor:
    """``eval_policy_agents`` with the M-bracket ``(cols, w)`` of
    ``m_bracket`` already taken: both bracketing columns of every
    agent's state are gathered and interpolated in one pass."""
    xp = m_knots[state_idx[:, None], cols[None, :]]          # [N, 2, K]
    fp = f_knots[state_idx[:, None], cols[None, :]]
    v = interp1d_rowwise(m[:, None, None].expand(-1, 2, 1), xp, fp)[..., 0]
    return v[:, 0] + w * (v[:, 1] - v[:, 0])


def eval_policy_agents(m: torch.Tensor, state_idx: torch.Tensor, M,
                       Mgrid: torch.Tensor, m_knots: torch.Tensor,
                       f_knots: torch.Tensor) -> torch.Tensor:
    """A state-indexed policy for a whole agent panel: ``m`` [N]
    resources, ``state_idx`` [N] discrete states, ``M`` one aggregate
    state (0-d tensor), knots [S, Mc, K]."""
    cols, w = m_bracket(M, Mgrid)
    return eval_policy_columns(m, state_idx, cols, w, m_knots, f_knots)


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
