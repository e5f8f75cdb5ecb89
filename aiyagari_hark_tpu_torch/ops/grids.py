"""Grid construction (port of the reference branch of
``aiyagari_hark_tpu/ops/grids.py``).

The multi-exponential grid is HARK's ``make_grid_exp_mult``: push the
endpoints through ``x -> log(1+x)`` ``timestonest`` times, space linearly
in that coordinate, invert.  Grids are calibration constants: they are
built once on the host in NumPy float64 (so the nested log/exp round trip
does not erode the endpoints) and cast to the requested dtype at the end.
"""

from __future__ import annotations

import numpy as np
import torch


def _exp_mult_host(ming: float, maxg: float, ng: int,
                   timestonest: int) -> np.ndarray:
    """The host-side float64 exp-mult grid."""
    ming = np.float64(ming)
    maxg = np.float64(maxg)
    if timestonest > 0:
        lo, hi = ming, maxg
        for _ in range(timestonest):
            lo = np.log(lo + 1.0)
            hi = np.log(hi + 1.0)
        grid = np.linspace(lo, hi, ng)
        for _ in range(timestonest):
            grid = np.exp(grid) - 1.0
    else:
        grid = np.exp(np.linspace(np.log(ming), np.log(maxg), ng))
    return grid


def make_grid_exp_mult(ming: float, maxg: float, ng: int,
                       timestonest: int = 20, dtype=torch.float32,
                       device="cpu") -> torch.Tensor:
    """Multi-exponentially spaced grid on [ming, maxg] with ``ng`` points;
    ``timestonest == 0`` gives a log-linear grid.  Raises ``ValueError``
    for endpoints whose logarithms do not exist."""
    if ng < 2:
        raise ValueError("need at least two grid points")
    if maxg <= ming:
        raise ValueError(
            f"grid endpoints must be ordered: ming={ming!r} >= maxg={maxg!r}")
    if timestonest > 0:
        if ming <= -1.0:
            raise ValueError(
                f"make_grid_exp_mult needs ming > -1 (log(1+x) nesting), "
                f"got ming={ming!r}")
    elif ming <= 0.0:
        raise ValueError(
            f"make_grid_exp_mult with timestonest=0 needs ming > 0 "
            f"(log-linear spacing takes log(ming)), got ming={ming!r}")
    return torch.as_tensor(_exp_mult_host(ming, maxg, ng, timestonest),
                           dtype=dtype, device=device)


def make_asset_grid(a_min: float, a_max: float, a_count: int,
                    nest_fac: int = 2, dtype=torch.float32,
                    device="cpu") -> torch.Tensor:
    """End-of-period asset grid, reference defaults (0.001, 50, 32, 2)."""
    return make_grid_exp_mult(a_min, a_max, a_count, nest_fac, dtype=dtype,
                              device=device)


def build_asset_grids(grid, a_min: float, a_max: float, a_count: int,
                      nest_fac: int, dist_count: int,
                      borrow_limit: float = 0.0, dtype=torch.float32,
                      device="cpu"):
    """(end-of-period asset grid [A], wealth-histogram support [D], knee)
    for one model build.  Only ``grid="reference"`` is ported; the knee is
    then ``None``.  ``borrow_limit`` b <= 0 shifts both grids."""
    if grid != "reference":
        raise NotImplementedError(
            f"grid={grid!r} is not ported yet: the compact grids are "
            f"ROADMAP Queue 1 item 7 (grid compaction)")
    span = a_max - borrow_limit
    a_grid = borrow_limit + make_asset_grid(a_min, span, a_count, nest_fac,
                                            dtype=dtype, device=device)
    inner = make_grid_exp_mult(a_min, span, dist_count - 1, nest_fac,
                               dtype=dtype, device=device)
    dist_grid = borrow_limit + torch.cat(
        [torch.zeros((1,), dtype=inner.dtype, device=device), inner])
    return a_grid, dist_grid, None
