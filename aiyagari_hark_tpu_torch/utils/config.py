"""Solver policies the port runs (port of the grid and kernel policies of
``aiyagari_hark_tpu/utils/config.py``; a copy, not an import).

Grid policy: ``"reference"`` builds the historical grids; ``"compact"``
and ``"adaptive"`` keep the reference points below a knee and close the
top with the analytic linear tail (``ops.grids.build_asset_grids``,
``models.household._append_analytic_tail_knots``).

Kernel policy: ``"reference"`` runs the two inner fixed points as two
kernel launches per supply evaluation; ``"fused"`` runs both in one
launch of ``ops.kernels.fused_cell_grid``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

GRID_POLICIES = ("reference", "compact", "adaptive")


@dataclass(frozen=True)
class GridSpec:
    """Resolved knobs for one grid policy.

    ``compact``: the solver grid is truncated at the knee and closed with
    the analytic tail; the histogram keeps its reference density below
    the knee and crosses the tail on a thinned subset.  ``ladder``: the
    coarse-to-fine policy ladder runs (not ported: ROADMAP Queue 1 item
    7).  ``knee_frac``: static knee as a fraction of the span (None = the
    density knee at the ``knee_density`` quantile of the reference
    points).  ``dist_tail_frac``: share of the reference histogram tail
    points kept.  ``tail_points``: least tail points, and the anchor
    count of the ``"anchors"`` tail.  ``coarse_tol_factor``: the ladder's
    descent-tolerance relaxation."""

    policy: str
    compact: bool
    ladder: bool
    knee_frac: Optional[float] = None
    knee_density: float = 0.85
    dist_tail_frac: float = 0.5
    tail_points: int = 6
    coarse_tol_factor: float = 50.0


_GRID_SPECS = {
    "reference": GridSpec("reference", compact=False, ladder=False),
    "compact": GridSpec("compact", compact=True, ladder=True,
                        knee_frac=None, knee_density=0.85,
                        dist_tail_frac=0.5, tail_points=6,
                        coarse_tol_factor=50.0),
    "adaptive": GridSpec("adaptive", compact=True, ladder=True,
                         knee_frac=None, knee_density=0.75,
                         dist_tail_frac=0.34, tail_points=6,
                         coarse_tol_factor=50.0),
}


def resolve_grid(policy) -> GridSpec:
    """A grid policy name (or a spec, passed through) as its spec; an
    unknown name raises ``ValueError``."""
    if isinstance(policy, GridSpec):
        return policy
    try:
        return _GRID_SPECS[policy]
    except (KeyError, TypeError):
        raise ValueError(f"grid policy must be one of {GRID_POLICIES}, "
                         f"got {policy!r}") from None


KERNEL_POLICIES = ("reference", "fused")


@dataclass(frozen=True)
class KernelSpec:
    """Resolved knobs for one kernel policy.  ``fused``: one launch runs
    both inner fixed points of a supply evaluation.  ``bf16_descent``:
    under a two-phase precision policy the descent ladder gains a bf16
    rung (with the precision ladder, not ported: ROADMAP Queue 1 items 6
    and 8)."""

    policy: str
    fused: bool
    bf16_descent: bool


_KERNEL_SPECS = {
    "reference": KernelSpec("reference", fused=False, bf16_descent=False),
    "fused": KernelSpec("fused", fused=True, bf16_descent=True),
}


def resolve_kernel(policy) -> KernelSpec:
    """A kernel policy name (or a spec, passed through) as its spec; an
    unknown name raises ``ValueError``."""
    if isinstance(policy, KernelSpec):
        return policy
    try:
        return _KERNEL_SPECS[policy]
    except (KeyError, TypeError):
        raise ValueError(f"kernel policy must be one of {KERNEL_POLICIES}, "
                         f"got {policy!r}") from None
