"""Grid construction (port of ``aiyagari_hark_tpu/ops/grids.py``).

The multi-exponential grid is HARK's ``make_grid_exp_mult``: push the
endpoints through ``x -> log(1+x)`` ``timestonest`` times, space linearly
in that coordinate, invert.  Grids are calibration constants: they are
built once on the host in NumPy float64 (so the nested log/exp round trip
does not erode the endpoints) and cast to the requested dtype at the end.

The compact grids (``grid="compact"``/``"adaptive"``) truncate the
reference grids: the kept points are bitwise members of them.  The solver
grid stops at a knee ``a_hat``; the histogram keeps its reference density
below the knee and crosses the tail on an evenly thinned subset.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import GridSpec, resolve_grid


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


def compact_knee(spec: GridSpec, a_min: float, span: float, a_count: int,
                 nest_fac: int) -> float:
    """The knee ``a_hat`` between the curved low-wealth region and the
    asymptotically linear tail, on the unshifted span ``[a_min, a_min +
    span]``: at ``knee_frac`` of the span, or (``knee_frac=None``) at the
    reference grid's point below which ``knee_density`` of its points
    lie; kept inside [5 %, 80 %] of the span."""
    a_max = float(a_min) + float(span)
    if spec.knee_frac is not None:
        a_hat = float(a_min) + float(spec.knee_frac) * float(span)
    else:
        ref = _exp_mult_host(a_min, a_max, max(int(a_count), 2), nest_fac)
        j = int(np.ceil(spec.knee_density * (len(ref) - 1)))
        a_hat = float(ref[min(j, len(ref) - 2)])
    lo = float(a_min) + 0.05 * float(span)
    hi = float(a_min) + 0.8 * float(span)
    return float(min(max(a_hat, lo), hi))


def _thin_tail(tail_ref: np.ndarray, n_keep: int) -> np.ndarray:
    """An evenly thinned subset of the reference tail points, the first
    and the last always kept (the last is the support's top)."""
    n_keep = max(2, min(int(n_keep), len(tail_ref)))
    idx = np.unique(np.round(
        np.linspace(0, len(tail_ref) - 1, n_keep)).astype(int))
    return tail_ref[idx]


def _compact_host_grids(spec: GridSpec, a_min: float, span: float,
                        a_count: int, nest_fac: int, dist_count: int,
                        tail: str):
    """Host float64 (solver points, histogram inner points, knee) of a
    compact grid policy."""
    a_hat = compact_knee(spec, a_min, span, a_count, nest_fac)
    ref_a = _exp_mult_host(a_min, span, a_count, nest_fac)
    curved = ref_a[ref_a <= a_hat]
    if len(curved) < 4:
        curved = ref_a[:4]
    if tail == "anchors":
        tail_a = ref_a[len(curved):]
        if len(tail_a):
            curved = np.concatenate(
                [curved, _thin_tail(tail_a, spec.tail_points)])
    ref_d = _exp_mult_host(a_min, span, dist_count - 1, nest_fac)
    low = ref_d[ref_d <= a_hat]
    tail_d = ref_d[len(low):]
    if len(tail_d):
        n_keep = max(spec.tail_points,
                     int(np.ceil(spec.dist_tail_frac * len(tail_d))))
        inner = np.concatenate([low, _thin_tail(tail_d, n_keep)])
    else:
        inner = low
    return curved, inner, a_hat


def build_asset_grids(grid, a_min: float, a_max: float, a_count: int,
                      nest_fac: int, dist_count: int,
                      borrow_limit: float = 0.0, dtype=torch.float32,
                      device="cpu", tail: str = "analytic"):
    """(end-of-period asset grid [A], wealth-histogram support [D], knee)
    for one model build; the knee is ``None`` under ``grid="reference"``.
    Under a compact policy the solver grid keeps the reference points
    below the knee: ``tail="analytic"`` leaves the top to the solver's
    analytic tail, ``tail="anchors"`` appends a thinned subset of the
    reference tail points.  ``borrow_limit`` b <= 0 shifts both grids."""
    spec = resolve_grid(grid)
    span = a_max - borrow_limit
    if not spec.compact:
        a_grid = borrow_limit + make_asset_grid(a_min, span, a_count,
                                                nest_fac, dtype=dtype,
                                                device=device)
        inner = make_grid_exp_mult(a_min, span, dist_count - 1, nest_fac,
                                   dtype=dtype, device=device)
        dist_grid = borrow_limit + torch.cat(
            [torch.zeros((1,), dtype=inner.dtype, device=device), inner])
        return a_grid, dist_grid, None
    if tail not in ("analytic", "anchors"):
        raise ValueError(f"tail must be 'analytic' or 'anchors', "
                         f"got {tail!r}")
    curved, inner, a_hat = _compact_host_grids(
        spec, a_min, span, a_count, nest_fac, dist_count, tail)
    a_grid = borrow_limit + torch.as_tensor(curved, dtype=dtype,
                                            device=device)
    inner = torch.as_tensor(inner, dtype=dtype, device=device)
    dist_grid = borrow_limit + torch.cat(
        [torch.zeros((1,), dtype=inner.dtype, device=device), inner])
    return a_grid, dist_grid, float(a_hat)


def grid_point_counts(grid, a_count: int, dist_count: int,
                      a_min: float = 0.001, a_max: float = 50.0,
                      nest_fac: int = 2, borrow_limit: float = 0.0,
                      tail: str = "analytic") -> tuple:
    """(solver points, histogram points) a model build under ``grid``
    uses, computed on the host without building it."""
    spec = resolve_grid(grid)
    if not spec.compact:
        return int(a_count), int(dist_count)
    curved, inner, _ = _compact_host_grids(
        spec, a_min, a_max - borrow_limit, a_count, nest_fac, dist_count,
        tail)
    return int(len(curved)), int(len(inner)) + 1
