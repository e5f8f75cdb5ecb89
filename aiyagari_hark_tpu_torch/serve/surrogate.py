"""Certified surrogate serving tier: interpolate answers OFF the lattice
(port of ``aiyagari_hark_tpu/serve/surrogate.py``, host code, copied).

Production traffic is a continuous distribution over (σ, ρ, sd); the
store only has solved lattice points.  The solution manifold over
parameters is smooth and asymptotically linear (PAPERS 2002.09108's
consumption-function linearity, 1905.13045's wealth-evolution structure
— the same facts the analytic tail exploits pointwise in asset space),
so an off-lattice query can be answered in microseconds by a LOCAL
WEIGHTED-LINEAR FIT over the k nearest CERTIFIED stored solutions in
normalized CellSpace coordinates, with a model-implied error bound —
the ``donor_margin`` two-donor machinery generalized to k donors
(DESIGN §15).

``SurrogatePolicy`` rides ``EquilibriumService(surrogate=...)`` exactly
like ``AdmissionPolicy``/``PrecisionPolicy``/``GridPolicy``: ``None``
(the default) disables the tier and every served bit is identical to
the pre-surrogate engine.  A surrogate answer is served as
``ServedResult(quality="surrogate", surrogate_error_bound=...,
donor_keys=...)`` — NEVER cached, never untagged; when its bound
exceeds ``max_error_bound`` (or the donors are too few / too far, or a
seeded ``audit_fraction`` draw selects it for a posteriori
certification) the query ESCALATES to a genuine cold solve whose
published result densifies the lattice exactly where the surrogate
failed (``LATTICE_REFINED``).

The fit: donors at normalized offsets ``dz_j`` with distances ``d_j``
get weights ``w_j = 1/(d_j + eps)``; a weighted least-squares plane
``r ≈ β₀ + β·dz`` is solved and evaluated AT the query point (``β₀``).
Because WLS is linear in the observations, the prediction is an
equivalent-kernel row ``a`` with ``r̂ = a·r`` — the same kernel applied
to every packed-row column interpolates the full served row (affine
weights reproduce constant columns exactly, so schema/status columns
survive).  Fewer than ``dim+2`` donors, or an ill-conditioned plane
(coplanar donors), fall back to the distance-weighted mean — the same
kernel contract, zero slope.  Offset columns the donor set does not
actually span (zero peak-to-peak — e.g. donors from a 2-D (σ, ρ)
lattice slice at a single sd) are dropped before the fit: the plane
lives in the spanned subspace, where its β are identifiable, instead
of tripping the condition gate into the mean fallback.

The bound: ``max(inflation * max-fit-residual, spread-term, floor)``
— the residual term measures observed local curvature over the donor
neighborhood (zero iff the donors are exactly coplanar, so an exactly
linear manifold certifies down to the floor); the spread term
(``donor_margin``'s donor-disagreement ball ``max-min donor r*``,
scaled by ``d₁/d̄``, how close the query sits relative to the
neighborhood radius) applies only to the WEIGHTED-MEAN fallback,
whose constant model leaves the whole local variation unexplained —
charging it to the plane fit would bill the plane's own slope as
error; ``floor`` is the caller's solver-tolerance floor (the service
passes ``64·r_tol``, ``donor_margin``'s own floor rung)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np


@dataclass(frozen=True)
class SurrogatePolicy:
    """Continuous-parameter surrogate serving (DESIGN §15).

    * ``k`` — donors in the local fit (the ``donor_margin`` pair,
      generalized).
    * ``max_error_bound`` — r*-units budget: a fit whose model-implied
      bound exceeds this escalates to a real solve.
    * ``max_distance`` — normalized (``neighbor_distance`` units)
      budget on the NEAREST donor: past it the local fit is an
      extrapolation, not an interpolation, and the query escalates.
    * ``min_donors`` — fewer usable donors than this escalates (the
      self-densifying case: sparse regions earn lattice points).
    * ``require_certified`` — only CERTIFIED/MARGINAL donors may enter
      the fit (the certifier is the tier's foundation; disable
      only in uncertified-store tests).
    * ``audit_fraction`` / ``audit_seed`` — seeded fraction of
      surrogate-eligible answers escalated to a REAL solve and
      certified a posteriori: the solve is served and published, and
      the surrogate's prediction is checked against it (within its own
      reported bound or the audit fails loudly in metrics/journal).
    * ``bound_inflation`` — conservatism multiplier on the residual
      term of the bound model.
    * ``refine`` — journal escalated publishes as ``LATTICE_REFINED``
      parameter-space refinement points."""

    k: int = 6
    max_error_bound: float = 2e-4
    max_distance: float = 0.5
    min_donors: int = 4
    require_certified: bool = True
    audit_fraction: float = 0.0
    audit_seed: int = 0
    bound_inflation: float = 2.0
    refine: bool = True

    def replace(self, **kwargs) -> "SurrogatePolicy":
        return dataclasses.replace(self, **kwargs)


class SurrogateFit(NamedTuple):
    """One local fit: the prediction, its model-implied error bound,
    and the equivalent kernel that produced it (apply ``kernel`` to any
    donor column to interpolate it consistently)."""

    r_star: float       # fitted r* at the query point
    bound: float        # model-implied |error| bound (r* units)
    kernel: np.ndarray  # [k] equivalent-kernel weights, sum == 1
    resid: float        # max |fit - donor| over the donor set
    spread: float       # max - min donor r*
    linear: bool        # True = plane fit, False = weighted-mean fallback


def fit_surrogate(cell, donor_cells, donor_r, distances, scale,
                  floor: float = 0.0,
                  inflation: float = 2.0) -> Optional[SurrogateFit]:
    """Distance-weighted local-linear fit of r* at ``cell`` over the
    donors (rows of ``donor_cells``), in normalized coordinates
    (``cell[i]/scale[i]``).  Returns None only for an empty donor set;
    degenerate geometries fall back to the weighted mean."""
    donor_cells = np.asarray(donor_cells, dtype=np.float64)
    donor_r = np.asarray(donor_r, dtype=np.float64)
    d = np.asarray(distances, dtype=np.float64)
    n = donor_cells.shape[0]
    if n == 0:
        return None
    scale_a = np.asarray(scale, dtype=np.float64)
    dz = donor_cells / scale_a - np.asarray(
        cell, dtype=np.float64) / scale_a
    w = 1.0 / (d + 1e-6)
    w = w / w.max()
    # fit only the offset columns the donors actually span: a column
    # with zero peak-to-peak (a lattice slice, or a constant query
    # offset along an unswept axis) is collinear with the intercept,
    # and keeping it would push cond(A) to infinity and needlessly
    # degrade the whole fit to the weighted mean
    live = np.ptp(dz, axis=0) > 1e-12
    dz_fit = dz[:, live]
    dim_eff = int(live.sum())
    kernel = None
    linear = False
    if dim_eff and n >= dim_eff + 2:
        X = np.concatenate([np.ones((n, 1)), dz_fit], axis=1)
        XtW = X.T * w
        A = XtW @ X
        # equivalent kernel: r_hat = e0' A^{-1} X'W r = K[0] . r.  ONE
        # SVD of the tiny normal matrix yields both the condition check
        # and the inverse (the serve path is latency-critical: a
        # cond()+solve()+solve() chain triples the LAPACK dispatches)
        try:
            U, s, Vt = np.linalg.svd(A, hermitian=True)
            if s[-1] > 0.0 and s[0] / s[-1] < 1e10:
                K = (Vt.T / s) @ (U.T @ XtW)
                kernel = K[0]
                linear = True
        except np.linalg.LinAlgError:
            kernel = None
    if kernel is None:
        kernel = w / w.sum()
    r_hat = float(kernel @ donor_r)
    if linear:
        fitted = X @ (K @ donor_r)
    else:
        fitted = np.full(n, r_hat)
    resid = float(np.max(np.abs(fitted - donor_r)))
    spread = float(donor_r.max() - donor_r.min())
    d_near = float(d.min())
    d_bar = float(d.mean())
    # the spread term bills the mean fallback for the variation its
    # constant model cannot explain; the plane fit's unexplained part
    # IS its residual (billing raw spread would charge the plane's own
    # slope as error and no smooth region could ever certify)
    bound = float(max(inflation * resid,
                      (0.0 if linear
                       else spread * d_near / max(d_bar, 1e-12)),
                      floor))
    return SurrogateFit(r_star=r_hat, bound=bound, kernel=kernel,
                        resid=resid, spread=spread, linear=linear)
