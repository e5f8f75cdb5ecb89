"""A posteriori equilibrium certification (port of
``aiyagari_hark_tpu/verify/certificate.py``).

A bit-flipped packed row or a lane computed subtly wrong gives finite,
plausible numbers that no solver exit code flags.  An Aiyagari
equilibrium is characterised by the Euler equation of the policy and the
stationarity and market clearing of the distribution, so a solution is
certified after the fact by evaluations that did not produce it:

* **euler** -- the relative Euler residual of the policy at the
  midpoints of its endogenous knots (EGM holds it at the knots by
  construction), where the borrowing constraint is slack;
* **stationarity / mass** -- ``max |push(mu) - mu|`` under one fresh
  push-forward of the lottery, and ``|sum mu - 1|``;
* **market_clearing** -- ``|K_supply(r*) - K_demand(r*)| / K`` with the
  supply re-evaluated at r* (policy solve, stationary distribution);
* **capital** -- the reported capital against that supply;
* **shape / lorenz** -- increasing knots, positive nondecreasing
  consumption, nonnegative masses and a monotone cumulative wealth;
* **recompute** -- the status of the certifier's own inner solves.

Each residual is graded against ``CertThresholds``:
CERTIFIED (0) < MARGINAL (1) < FAILED (2), combined by ``max``.

The recompute runs on the card as the solver does: the policy through
``egm_policy_grid``; the distribution by the direct bordered solve
(``models.household.stationary_solve``, a library LU, then a
continuation through ``stationary_lottery_grid``) when ``D N <= 4096``,
else through ``stationary_wealth`` (the lottery kernel alone) -- the
JAX certifier's "solve" and "scatter" choice.  The residual evaluations
themselves are plain PyTorch, as JAX's are plain XLA.  Every function
takes one cell or a lane-batched block.  The Huggett and Epstein-Zin
scenarios pass their own recompute to ``certify_packed_rows`` (market
clearing against the gross bond position; no Euler oracle for the
recursive preferences), built from the same pieces.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device, resolve_dtype
from ..solver_health import is_failure
from ..utils.fingerprint import canonical_dtype, hashable_kwargs

# Severity-ordered certificate levels; combine with max().
CERTIFIED = 0
MARGINAL = 1
FAILED = 2
# No certificate was computed.
UNCERTIFIED = -1

CERT_LEVEL_NAMES = ("CERTIFIED", "MARGINAL", "FAILED")

# The residual vector's layout; the order is the JAX package's.
CERT_CHECKS = ("euler", "stationarity", "mass", "market_clearing",
               "capital", "shape", "lorenz", "recompute")


def cert_level_name(level: int) -> str:
    level = int(level)
    if level == UNCERTIFIED:
        return "UNCERTIFIED"
    if 0 <= level < len(CERT_LEVEL_NAMES):
        return CERT_LEVEL_NAMES[level]
    return f"UNKNOWN({level})"


class CheckResult(NamedTuple):
    """One check's outcome."""

    name: str
    residual: float
    threshold: float      # CERTIFIED bound; MARGINAL up to marginal_factor x
    level: int

    def __repr__(self) -> str:
        return (f"CheckResult({self.name}: {cert_level_name(self.level)}, "
                f"residual={self.residual:.3e} vs tol={self.threshold:.3e})")


class Certificate(NamedTuple):
    """Severity-ordered certificate of one equilibrium."""

    level: int                 # worst check level (max)
    checks: tuple              # of CheckResult, CERT_CHECKS order

    @property
    def certified(self) -> bool:
        return self.level == CERTIFIED

    @property
    def failed(self) -> bool:
        return self.level >= FAILED

    def residuals(self) -> dict:
        return {c.name: c.residual for c in self.checks}

    def worst(self) -> CheckResult:
        return max(self.checks, key=lambda c: (c.level,
                                               c.residual / max(c.threshold,
                                                                1e-300)))

    def summary(self) -> str:
        w = self.worst()
        return (f"{cert_level_name(self.level)}"
                + ("" if self.level == CERTIFIED
                   else f" (worst: {w.name} residual {w.residual:.3e} "
                        f"vs tol {w.threshold:.3e})"))


@dataclass(frozen=True)
class CertThresholds:
    """CERTIFIED bound per check; a residual within ``marginal_factor``
    times its bound is MARGINAL, beyond it FAILED.  The defaults are the
    JAX package's, for the float64 solver tolerances (r_tol=1e-10,
    egm_tol=1e-6, dist_tol=1e-11); ``for_solver`` scales the
    tolerance-coupled bounds to another configuration."""

    euler: float = 0.08
    stationarity: float = 1e-8
    mass: float = 5e-10
    market_clearing: float = 1e-2
    capital: float = 1e-2
    shape: float = 0.0
    lorenz: float = 1e-12
    recompute: float = 0.5
    marginal_factor: float = 8.0

    @classmethod
    def for_solver(cls, dtype=None, r_tol: Optional[float] = None,
                   egm_tol: Optional[float] = None,
                   dist_tol: Optional[float] = None,
                   precision: str = "reference",
                   grid="reference",
                   **overrides) -> "CertThresholds":
        """Thresholds matched to a solver configuration (the JAX rule, the
        same numbers): tolerances default by dtype as
        ``equilibrium._bisection_setup`` does (``dtype=None`` is the
        port's float32); the market bounds take the worse of the inner
        solves' noise (``1e4 egm_tol``) and the bracket's (``1500
        r_tol``), widened 4x under a two-phase precision; a compact grid
        widens the Euler bound 4x and the market bounds 2x."""
        from ..utils.config import resolve_grid, resolve_precision

        f64 = canonical_dtype(dtype) == np.float64
        if r_tol is None:
            r_tol = 1e-10 if f64 else 1e-6
        if dist_tol is None:
            dist_tol = 1e-11 if f64 else 1e-8
        if egm_tol is None:
            egm_tol = 1e-6 if f64 else 1e-5
        eps = float(np.finfo(np.float64 if f64 else np.float32).eps)
        market = max(1e4 * float(egm_tol), 1500.0 * float(r_tol))
        if resolve_precision(precision).two_phase:
            market *= 4.0
        euler = max(0.08, 20.0 * float(egm_tol))
        if resolve_grid(grid).compact:
            euler *= 4.0
            market *= 2.0
        return cls(
            euler=euler,
            stationarity=max(300.0 * float(dist_tol), 200.0 * eps),
            mass=max(5e-10 if f64 else 5e-5, 2e5 * eps),
            market_clearing=market,
            capital=market,
        ).replace(**overrides)

    def replace(self, **kw) -> "CertThresholds":
        return replace(self, **kw)

    def bound(self, name: str) -> float:
        return float(getattr(self, name))

    def grade(self, name: str, residual: float) -> CheckResult:
        """One residual as a graded ``CheckResult``; a non-finite residual
        fails.  ``recompute`` carries a ``solver_health`` code: CONVERGED
        certifies, STALLED is marginal, MAX_ITER and NONFINITE fail."""
        tol = self.bound(name)
        r = float(residual)
        if name == "recompute":
            marginal_bound = 1.5      # STALLED (1) and nothing above
        else:
            marginal_bound = self.marginal_factor * tol
        if not np.isfinite(r):
            level = FAILED
        elif r <= tol:
            level = CERTIFIED
        elif r <= marginal_bound:
            level = MARGINAL
        else:
            level = FAILED
        return CheckResult(name=name, residual=r, threshold=tol, level=level)

    def certificate(self, residuals) -> Certificate:
        """Grade a CERT_CHECKS-ordered residual vector."""
        checks = tuple(self.grade(name, r)
                       for name, r in zip(CERT_CHECKS, residuals))
        return Certificate(level=max(c.level for c in checks),
                           checks=checks)


# ---------------------------------------------------------------------------
# The residual evaluations: plain PyTorch, one cell or [C, ...] lanes.
# ---------------------------------------------------------------------------

def _batched(policy, model):
    """(policy, model, single): the lane-batched forms of one cell's."""
    from ..models.household import _lift, is_batched

    if is_batched(model):
        return policy, model, False
    return _lift(policy), _lift(model), True


def _per_lane(x, like: torch.Tensor) -> torch.Tensor:
    """A scalar or [C] value as a [C] tensor of ``like``'s dtype."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x.expand(like.shape[0]) if x.dim() == 0 else x.reshape(-1)


def _tiny(dt, dev) -> torch.Tensor:
    # finfo(float64).tiny in the working dtype, as the JAX package casts
    # it (0 in float32)
    return torch.tensor(np.finfo(np.float64).tiny, dtype=dt, device=dev)


def euler_residual_midpoints(policy, R, W, model, disc_fac, crra):
    """Max relative Euler residual of ``policy`` at the midpoints of its
    endogenous knots, where the constraint is slack at the midpoint and
    at the Euler-implied optimum: interpolate consumption, push savings
    through the budget, take expected marginal utility with a plain
    contraction, invert the first-order condition (never the EGM
    update)."""
    from ..ops.interp import interp1d_rowwise
    from ..ops.utility import inverse_marginal_utility, marginal_utility

    policy, model, single = _batched(policy, model)
    m_k, c_k = policy.m_knots, policy.c_knots                # [C, N, K]
    C, n, _ = m_k.shape
    like = m_k[:, 0, 0]
    R, W = _per_lane(R, like), _per_lane(W, like)
    crra = _per_lane(crra, like)[:, None, None]
    m_mid = 0.5 * (m_k[..., 1:-1] + m_k[..., 2:])            # [C, N, J]
    J = m_mid.shape[-1]
    c_mid = interp1d_rowwise(m_mid, m_k, c_k)
    a_end = m_mid - c_mid
    m_next = (R[:, None, None, None] * a_end[..., None]
              + W[:, None, None, None]
              * model.labor_levels[:, None, None, :])         # [C, N, J, N']
    mq = m_next.permute(0, 3, 1, 2).reshape(C, n, n * J)     # [C, N', N J]
    vp = marginal_utility(interp1d_rowwise(mq, m_k, c_k), crra)
    vp = vp.reshape(C, n, n, J)                              # [C, N', N, J]
    evp = torch.einsum("cnk,cknj->cnj", model.transition, vp)
    c_star = inverse_marginal_utility(
        disc_fac * R[:, None, None] * evp, crra)
    floor = model.a_grid[:, 0, None, None]
    slack = (a_end > floor) & ((m_mid - c_star) > floor)
    rel = (torch.abs(c_mid - c_star)
           / torch.maximum(c_mid, _tiny(c_mid.dtype, c_mid.device)))
    out = torch.where(slack, rel, torch.zeros_like(rel)).amax(dim=(1, 2))
    return out[0] if single else out


def stationarity_residuals(policy, dist, R, W, model):
    """(``max |push(mu) - mu|``, ``|sum mu - 1|``): one fresh push-forward
    of the lottery ``policy`` implies, applied to ``dist``, whichever
    engine produced it."""
    from ..models.household import wealth_transition
    from ..ops.kernels import lottery_gather, push_forward_lanes

    policy, model, single = _batched(policy, model)
    dist = dist[None] if single else dist
    like = dist[:, 0, 0]
    trans = wealth_transition(policy, _per_lane(R, like),
                              _per_lane(W, like), model)
    src, coef = lottery_gather(trans.idx, trans.weight)
    pushed = push_forward_lanes(dist, src, coef, model.transition)
    station = torch.abs(pushed - dist).amax(dim=(1, 2))
    mass = torch.abs(dist.sum(dim=(1, 2)) - 1.0)
    return (station[0], mass[0]) if single else (station, mass)


def shape_residual(policy):
    """Violation of the policy's shape: knots strictly increasing,
    consumption positive and nondecreasing (0.0 for a healthy policy);
    knots [N, K] or [C, N, K]."""
    m_k, c_k = policy.m_knots, policy.c_knots
    dims = tuple(range(-2, 0))
    zero = torch.zeros((), dtype=c_k.dtype, device=c_k.device)
    return (torch.maximum((-torch.diff(m_k, dim=-1)).amax(dim=dims), zero)
            + torch.maximum((-torch.diff(c_k, dim=-1)).amax(dim=dims), zero)
            + torch.maximum((-c_k).amax(dim=dims), zero))


def lorenz_residual(dist, model):
    """Lorenz monotonicity of the wealth histogram: nonnegative masses
    and a nondecreasing cumulative wealth over the nonnegative-wealth
    support, as a relative violation; ``dist`` [D, N] or [C, D, N]."""
    grid = model.dist_grid
    m = dist.sum(dim=-1)                                     # [..., D]
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    neg_mass = torch.maximum((-m).amax(dim=-1), zero)
    cw = torch.cumsum(torch.clamp(m, min=0.0) * grid, dim=-1)
    ok_region = grid[..., 1:] >= 0
    dec = torch.where(ok_region, -torch.diff(cw, dim=-1),
                      torch.zeros_like(cw[..., 1:]))
    dec = torch.maximum(dec.amax(dim=-1), zero)
    return neg_mass + dec / torch.maximum(cw[..., -1], _tiny(m.dtype,
                                                             m.device))


# The certifier needs the model structure, prices and inner tolerances;
# the solver's method knobs (root_method, accel_every, bracket_pad,
# max_bisect, precision, kernel, warm seeds, fault hooks) are ignored, so
# a solution is certified by the same evaluations however it was made.
_MODEL_KEYS = ("labor_states", "labor_bound", "a_min", "a_max", "a_count",
               "a_nest_fac", "dist_count", "borrow_limit", "grid")
_PRICE_DEFAULTS = {"disc_fac": 0.96, "cap_share": 0.36, "depr_fac": 0.08,
                   "prod": 1.0}


def _split_kwargs(model_kwargs: dict, f64: bool, **build_defaults):
    """(model build kwargs, prices, egm_tol, dist_tol) of a configuration:
    ``build_defaults`` fill the build keys it leaves out (the Huggett
    family's ``borrow_limit=-2.0``)."""
    build = {k: model_kwargs[k] for k in _MODEL_KEYS if k in model_kwargs}
    for k, v in build_defaults.items():
        build.setdefault(k, v)
    price = {k: float(model_kwargs.get(k, v))
             for k, v in _PRICE_DEFAULTS.items()}
    egm_tol = model_kwargs.get("egm_tol") or (1e-6 if f64 else 1e-5)
    dist_tol = model_kwargs.get("dist_tol") or (1e-11 if f64 else 1e-8)
    return build, price, float(egm_tol), float(dist_tol)


def _cert_dist_method(build: dict) -> str:
    """The certifier's distribution engine: the direct solve when the
    bordered matrix is small enough, the iterative kernel beyond."""
    d = int(build.get("dist_count", 500))
    n = int(build.get("labor_states", 7))
    return "solve" if d * n <= 4096 else "scatter"


def cert_distribution(policy, R, W, model, build: dict, dist_tol: float):
    """The certifier's stationary distribution of ``policy``, never the
    solver's carry: ``stationary_solve`` (library LU, then the lottery
    kernel's continuation) or ``stationary_wealth`` by
    ``_cert_dist_method``.  Returns (dist, n_iter, diff, status)."""
    from ..models.household import stationary_solve, stationary_wealth

    if _cert_dist_method(build) == "solve":
        return stationary_solve(policy, R, W, model, tol=dist_tol)
    return stationary_wealth(policy, R, W, model, tol=dist_tol)


def _recompute_residuals(cells, r_star, capital, dtype, device,
                         model_kwargs: dict) -> np.ndarray:
    """Rebuild the lanes' models, re-solve the policy and the stationary
    distribution at ``r_star`` (never the lean carry) and return the
    ``[C, len(CERT_CHECKS)]`` float64 residuals."""
    from ..models import firm
    from ..models.household import (aggregate_capital, aggregate_labor,
                                    build_cell_models, solve_household)
    from ..solver_health import combine_status

    build, price, egm_tol, dist_tol = _split_kwargs(
        model_kwargs, dtype == torch.float64)
    model = build_cell_models(cells, dtype=dtype, device=device, **build)
    like = model.borrow_limit
    crra = torch.as_tensor(np.asarray(cells)[:, 0], dtype=dtype,
                           device=device)
    r = torch.as_tensor(np.asarray(r_star), dtype=dtype, device=device)
    cap = torch.as_tensor(np.asarray(capital), dtype=dtype, device=device)
    k_to_l = firm.k_to_l_from_r(r, price["cap_share"], price["depr_fac"],
                                price["prod"])
    W = firm.wage_rate(k_to_l, price["cap_share"], price["prod"])
    R = 1.0 + r
    policy, _, _, egm_status = solve_household(
        R, W, model, price["disc_fac"], crra, tol=egm_tol,
        precision="reference", grid=build.get("grid", "reference"))
    dist, _, _, dist_status = cert_distribution(policy, R, W, model, build,
                                                dist_tol)
    supply = aggregate_capital(dist, model)
    demand = k_to_l * aggregate_labor(model)
    denom = torch.maximum(torch.abs(supply), _tiny(like.dtype, like.device))
    station, mass = stationarity_residuals(policy, dist, R, W, model)
    return residual_rows(
        euler_residual_midpoints(policy, R, W, model, price["disc_fac"],
                                 crra),
        station, mass, torch.abs(supply - demand) / denom,
        torch.abs(cap - supply) / denom, shape_residual(policy),
        lorenz_residual(dist, model),
        combine_status(egm_status, dist_status).to(dtype))


def residual_rows(*checks) -> np.ndarray:
    """The per-lane residuals of the eight ``CERT_CHECKS``, in that order
    (each [C]), as [C, 8] float64 on the host."""
    if len(checks) != len(CERT_CHECKS):
        raise ValueError(f"expected the {len(CERT_CHECKS)} residuals "
                         f"{CERT_CHECKS}, got {len(checks)}")
    return torch.stack(checks, dim=1).cpu().numpy().astype(np.float64)


def _thresholds_from_kwargs(thresholds, dtype, model_kwargs: dict):
    if thresholds is not None:
        return thresholds
    return CertThresholds.for_solver(
        dtype=dtype, r_tol=model_kwargs.get("r_tol"),
        egm_tol=model_kwargs.get("egm_tol"),
        dist_tol=model_kwargs.get("dist_tol"),
        precision=model_kwargs.get("precision", "reference"),
        grid=model_kwargs.get("grid", "reference"))


def certify_packed_rows(rows, cells, dtype, kwargs_items,
                        thresholds: Optional[CertThresholds] = None,
                        schema=None, device=None, recompute=None,
                        claim: str = "capital"):
    """Certify a block of packed rows of ``cells``: one batched recompute
    of the healthy rows on ``device`` (default: the card) in ``dtype``; a
    row whose status is a failure certifies FAILED with NaN residuals
    (only ``recompute`` carries its status).  ``schema`` is the row
    layout (default: the Aiyagari one); ``recompute(cells, r_star,
    claimed, dtype, device, model_kwargs) -> [C, 8]`` the family's
    residuals (default: the Aiyagari recompute), ``claimed`` the row's
    ``claim`` column (the root where the schema has none).  Returns a
    list of ``Certificate``."""
    if schema is None:
        from ..scenarios.aiyagari import AIYAGARI_SCHEMA as schema
    if recompute is None:
        recompute = _recompute_residuals
    dt = resolve_dtype(dtype)
    dev = resolve_device(device)
    status_col = schema.idx(schema.status)
    root_col = schema.idx(schema.root)
    claim_col = schema.idx(claim) if schema.has(claim) else root_col
    rows = np.asarray(rows, dtype=np.float64)
    cells = np.asarray(cells, dtype=np.float64)
    model_kwargs = dict(kwargs_items)
    thr = _thresholds_from_kwargs(thresholds, dt, model_kwargs)
    healthy = ~is_failure(np.rint(rows[:, status_col]).astype(np.int64))
    out: list = [None] * len(rows)
    if healthy.any():
        idx = np.nonzero(healthy)[0]
        resids = recompute(cells[idx], rows[idx, root_col],
                           rows[idx, claim_col], dt, dev, model_kwargs)
        for j, i in enumerate(idx):
            out[int(i)] = thr.certificate(resids[j])
    for i in np.nonzero(~healthy)[0]:
        resids = np.full(len(CERT_CHECKS), np.nan)
        resids[CERT_CHECKS.index("recompute")] = float(
            np.rint(rows[i, status_col]))
        out[int(i)] = thr.certificate(resids)
    return out


def certify_equilibrium(result, crra=None, labor_ar=None, labor_sd=0.2,
                        thresholds: Optional[CertThresholds] = None,
                        dtype=None, device=None,
                        **model_kwargs) -> Certificate:
    """Certificate of one solved equilibrium.  ``result`` is a full
    ``EquilibriumResult`` (its own policy and distribution are
    certified, no inner solve), an object with ``r_star`` and
    ``capital`` (a ``LeanEquilibrium``: the policy and distribution are
    re-solved at r*), or a bare r*.  ``crra``/``labor_ar``/``labor_sd``
    locate the cell; ``model_kwargs`` are ``solve_calibration``'s (grid
    sizes, tolerances, prices; method knobs ignored).  A FAILED
    certificate journals ``CERT_FAILED`` (``where="certify"``) into the
    active obs scope; the sweep attributes its own at the call site."""
    from ..obs.runtime import active_span, emit_event

    if crra is None or labor_ar is None:
        raise TypeError("certify_equilibrium needs the calibration cell: "
                        "pass crra= and labor_ar= (and labor_sd=)")
    dt = resolve_dtype(dtype)
    dev = resolve_device(device)
    thr = _thresholds_from_kwargs(thresholds, dt, model_kwargs)
    policy = getattr(result, "policy", None)
    distribution = getattr(result, "distribution", None)
    scalar = np.isscalar(result) or isinstance(result, float)
    r_star = float(result if scalar else result.r_star)
    capital = None if scalar else getattr(result, "capital", None)

    def _graded(cert: Certificate) -> Certificate:
        if cert.failed:
            emit_event("CERT_FAILED",
                       cell=(float(crra), float(labor_ar),
                             float(labor_sd)),
                       summary=cert.summary(), where="certify")
        return cert

    if policy is not None and distribution is not None:
        with active_span("verify/certify", form="objects"):
            resids = _object_residuals(
                r_star, policy, distribution, float(crra), float(labor_ar),
                float(labor_sd), dt, dev, model_kwargs)
        return _graded(thr.certificate(resids))
    cap = r_star if capital is None else float(capital)
    with active_span("verify/certify", form="recompute"):
        resids = _recompute_residuals(
            [(float(crra), float(labor_ar), float(labor_sd))], [r_star],
            [cap], dt, dev, dict(hashable_kwargs(model_kwargs)))[0]
    if capital is None:
        # a bare r* makes no capital claim
        resids[CERT_CHECKS.index("capital")] = 0.0
    return _graded(thr.certificate(resids))


def _object_residuals(r_star, policy, distribution, crra, labor_ar,
                      labor_sd, dtype, device, model_kwargs: dict):
    """Certify given solution objects against the model directly: no
    inner solve, so ``recompute`` is clean and the supply is the
    distribution's own (``capital`` 0)."""
    from ..models import firm
    from ..models.household import (aggregate_capital, aggregate_labor,
                                    build_simple_model)

    build, price, _, _ = _split_kwargs(model_kwargs,
                                       dtype == torch.float64)
    model = build_simple_model(labor_ar=labor_ar, labor_sd=labor_sd,
                               dtype=dtype, device=device, **build)
    k_to_l = firm.k_to_l_from_r(r_star, price["cap_share"],
                                price["depr_fac"], price["prod"])
    W = firm.wage_rate(k_to_l, price["cap_share"], price["prod"])
    R = 1.0 + r_star
    supply = float(aggregate_capital(distribution, model))
    demand = float(k_to_l * aggregate_labor(model))
    denom = max(abs(supply), np.finfo(np.float64).tiny)
    station, mass = stationarity_residuals(policy, distribution, R, W,
                                           model)
    return np.asarray([
        float(euler_residual_midpoints(policy, R, W, model,
                                       price["disc_fac"], crra)),
        float(station),
        float(mass),
        abs(supply - demand) / denom,
        0.0,
        float(shape_residual(policy)),
        float(lorenz_residual(distribution, model)),
        0.0,
    ], dtype=np.float64)
