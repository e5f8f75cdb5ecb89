"""General-equilibrium solvers: capital-market bisection on the interest
rate (port of ``aiyagari_hark_tpu/models/equilibrium.py``, root method
"bisect", no warm-started bracket, no fault hooks; kernel policies
"reference" and "fused", grid policies "reference" and, under "fused",
"compact"/"adaptive").

    r  ->  household capital supply A(r)  vs  firm capital demand K(r)

The bracket is economic: r lies below (1-beta)/beta (supply diverges)
and above -delta (demand diverges); excess supply is increasing in r.

Batching replaces ``vmap``: the bisection is a host loop over trips in
which each lane keeps its own bracket, warm-start policy, distribution
and counters.  A lane whose loop condition has gone false is frozen, as
under ``vmap`` of a ``while_loop``; each trip evaluates the supply of the
active lanes only, gathered by index and scattered back.  The host syncs
once per trip, to find the active lanes; the inner fixed points run in
the kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import firm
from ..solver_health import CONVERGED, MAX_ITER, NONFINITE, combine_status
from ..utils.config import resolve_grid, resolve_kernel
from .household import (
    HouseholdPolicy,
    SimpleModel,
    _lift,
    aggregate_capital,
    aggregate_labor,
    build_simple_model,
    check_policies,
    fused_supply_phases,
    initial_distribution,
    initial_policy,
    is_batched,
    select_lanes,
    solve_household,
    stationary_wealth,
)


class EquilibriumResult(NamedTuple):
    r_star: torch.Tensor         # equilibrium net interest rate
    wage: torch.Tensor
    capital: torch.Tensor        # K = household asset supply at r_star
    labor: torch.Tensor          # effective aggregate labor
    saving_rate: torch.Tensor    # delta*K / Y
    excess: torch.Tensor         # residual excess supply at r_star
    policy: HouseholdPolicy
    distribution: torch.Tensor   # [D, N] stationary wealth distribution
    bisect_iters: torch.Tensor
    status: torch.Tensor         # worst solver_health code observed


class SupplyEval(NamedTuple):
    """One household-side evaluation A(r) with its work counters."""

    supply: torch.Tensor
    policy: HouseholdPolicy
    distribution: torch.Tensor
    wage: torch.Tensor
    k_to_l: torch.Tensor
    egm_iters: torch.Tensor      # EGM backward steps to the fixed point
    dist_iters: torch.Tensor     # distribution-iteration steps
    status: torch.Tensor         # worst of the two inner loops' codes


class LeanEquilibrium(NamedTuple):
    """Scalar-only equilibrium outputs for sweeps; ``egm_iters`` and
    ``dist_iters`` are summed over all bisection midpoints."""

    r_star: torch.Tensor
    capital: torch.Tensor        # supply at the last evaluated midpoint
    labor: torch.Tensor
    bisect_iters: torch.Tensor
    egm_iters: torch.Tensor
    dist_iters: torch.Tensor
    status: torch.Tensor


def household_capital_supply(r, model: SimpleModel, disc_fac, crra,
                             cap_share, depr_fac, prod=1.0,
                             egm_tol=1e-6, dist_tol=1e-11,
                             init_policy=None, init_dist=None,
                             precision: str = "reference",
                             grid="reference", kernel="reference",
                             state="replicated") -> SupplyEval:
    """A(r): solve the household at the prices implied by ``r`` and
    return stationary capital, the policy and distribution, the wage, the
    inner step counts and the worst inner status.  ``init_policy`` /
    ``init_dist`` warm-start the two inner fixed points.  One cell, or
    every lane of a batch.

    ``kernel="fused"`` runs both inner fixed points in one launch
    (``household.fused_supply_phases``), with the JAX package's fused
    budgets (EGM: 3000 steps, Aitken every 32; distribution: 20000 steps,
    every 64); under a compact ``grid`` the kernel closes the policy with
    the analytic tail."""
    check_policies(precision=precision, grid=grid, kernel=kernel,
                   state=state)
    k_to_l = firm.k_to_l_from_r(r, cap_share, depr_fac, prod)
    W = firm.wage_rate(k_to_l, cap_share, prod)
    R = 1.0 + r
    if resolve_kernel(kernel).fused:
        policy, dist, egm_it, dist_it, egm_status, dist_status = \
            fused_supply_phases(R, W, model, disc_fac, crra, egm_tol,
                                dist_tol, init_policy_knots=init_policy,
                                init_dist=init_dist, egm_max_iter=3000,
                                egm_accel=32, dist_max_iter=20000,
                                dist_accel=64, grid=grid)
        return SupplyEval(aggregate_capital(dist, model), policy, dist, W,
                          k_to_l, egm_it, dist_it,
                          combine_status(egm_status, dist_status))
    policy, egm_it, _, egm_status = solve_household(
        R, W, model, disc_fac, crra, tol=egm_tol, init_policy=init_policy)
    dist, dist_it, _, dist_status = stationary_wealth(
        policy, R, W, model, tol=dist_tol, init_dist=init_dist)
    return SupplyEval(aggregate_capital(dist, model), policy, dist, W,
                      k_to_l, egm_it, dist_it,
                      combine_status(egm_status, dist_status))


def _bisection_setup(model: SimpleModel, disc_fac, depr_fac, r_tol, egm_tol,
                     dist_tol):
    """Dtype-aware tolerance defaults (the f64 ones are unreachable in f32)
    and the economic bracket [-delta+eps, (1-beta)/beta-eps]."""
    f64 = model.a_grid.dtype == torch.float64
    if r_tol is None:
        r_tol = 1e-10 if f64 else 1e-6
    if egm_tol is None:
        egm_tol = 1e-6 if f64 else 1e-5
    if dist_tol is None:
        dist_tol = 1e-11 if f64 else 1e-8
    r_hi = 1.0 / disc_fac - 1.0 - 1e-4
    r_lo = -depr_fac + 1e-3
    return r_tol, egm_tol, dist_tol, r_lo, r_hi


def _lanes(model: SimpleModel, crra):
    """(lane-batched model, per-lane crra [C], whether to drop the lane
    axis on return)."""
    if is_batched(model):
        like = model.borrow_limit
        crra = torch.as_tensor(crra, dtype=like.dtype, device=like.device)
        return model, crra.expand(like.shape[0]) if crra.dim() == 0 \
            else crra, False
    model = _lift(model)
    like = model.borrow_limit
    crra = torch.as_tensor(crra, dtype=like.dtype,
                           device=like.device).reshape(1)
    return model, crra, True


def _bisect(excess_fn, r_lo: torch.Tensor, r_hi: torch.Tensor, r_tol: float,
            max_bisect: int):
    """Bisection of every lane's bracket on an excess map that is
    increasing in r.  ``excess_fn(mid, lanes)`` evaluates the active
    lanes ``lanes`` at ``mid``.  A non-finite excess freezes the lane's
    bracket and exits it NONFINITE; a bracket still wider than ``r_tol``
    at the trip cap is MAX_ITER.  Returns (r_star, iterations, status)."""
    lo, hi = r_lo.clone(), r_hi.clone()
    it = torch.zeros(lo.shape, dtype=torch.int32, device=lo.device)
    ok = torch.ones(lo.shape, dtype=torch.bool, device=lo.device)
    while True:
        lanes = torch.nonzero(((hi - lo) > r_tol) & (it < max_bisect) & ok)
        lanes = lanes[:, 0]
        if lanes.numel() == 0:
            break
        mid = 0.5 * (lo[lanes] + hi[lanes])
        ex = excess_fn(mid, lanes)
        fin = torch.isfinite(ex)
        up = ex > 0
        lo[lanes] = torch.where(fin & ~up, mid, lo[lanes])
        hi[lanes] = torch.where(fin & up, mid, hi[lanes])
        it[lanes] += 1
        ok[lanes] = fin
    status = combine_status(
        torch.where(~ok, NONFINITE, CONVERGED),
        torch.where((hi - lo) > r_tol, MAX_ITER, CONVERGED))
    return 0.5 * (lo + hi), it, status


def solve_bisection_equilibrium(model: SimpleModel, disc_fac, crra,
                                cap_share, depr_fac, prod=1.0,
                                r_tol: float | None = None,
                                max_bisect: int = 60,
                                egm_tol: float | None = None,
                                dist_tol: float | None = None,
                                precision: str = "reference",
                                grid="reference", kernel="reference",
                                state="replicated") -> EquilibriumResult:
    """Bisect r until the capital market clears (each midpoint solved
    cold), then re-solve at r* for the full equilibrium objects."""
    check_policies(precision=precision, grid=grid, kernel=kernel,
                   state=state)
    model, crra, single = _lanes(model, crra)
    r_tol, egm_tol, dist_tol, r_lo, r_hi = _bisection_setup(
        model, disc_fac, depr_fac, r_tol, egm_tol, dist_tol)
    labor = aggregate_labor(model)
    like = model.borrow_limit

    def excess(mid, lanes):
        sub = select_lanes(model, lanes)
        supply = household_capital_supply(
            mid, sub, disc_fac, crra[lanes], cap_share, depr_fac, prod,
            egm_tol=egm_tol, dist_tol=dist_tol, grid=grid,
            kernel=kernel).supply
        return supply - firm.k_to_l_from_r(mid, cap_share, depr_fac,
                                           prod) * labor[lanes]

    r_star, iters, bisect_status = _bisect(
        excess, torch.full_like(like, r_lo), torch.full_like(like, r_hi),
        r_tol, max_bisect)
    ev = household_capital_supply(r_star, model, disc_fac, crra, cap_share,
                                  depr_fac, prod, egm_tol=egm_tol,
                                  dist_tol=dist_tol, grid=grid, kernel=kernel)
    supply = ev.supply
    output = firm.output(supply, labor, cap_share, prod)
    out = EquilibriumResult(
        r_star=r_star, wage=ev.wage, capital=supply, labor=labor,
        saving_rate=depr_fac * supply / output,
        excess=supply - ev.k_to_l * labor, policy=ev.policy,
        distribution=ev.distribution, bisect_iters=iters,
        status=combine_status(bisect_status, ev.status))
    if single:
        out = out._replace(policy=HouseholdPolicy(*(f[0] for f in out.policy)))
        out = type(out)(*(f[0] if isinstance(f, torch.Tensor) else f
                          for f in out))
    return out


def solve_equilibrium_lean(model: SimpleModel, disc_fac, crra, cap_share,
                           depr_fac, prod=1.0, r_tol: float | None = None,
                           max_bisect: int = 60,
                           egm_tol: float | None = None,
                           dist_tol: float | None = None,
                           root_method: str = "bisect",
                           precision: str = "reference", grid="reference",
                           kernel="reference",
                           state="replicated") -> LeanEquilibrium:
    """Bisection equilibrium that carries the supply evaluation through
    the loop instead of re-solving at r*: each midpoint warm-starts its
    two inner fixed points from the previous midpoint's policy and
    distribution, and every midpoint solves to the full inner
    tolerances.  ``capital`` is the supply at the last midpoint, within
    one bracket width of supply at r*.

    Status: the worst of the non-finite tripwire, the bracket exit
    (MAX_ITER when the trip cap leaves the bracket wider than ``r_tol``)
    and the last midpoint's inner statuses.  One cell, or every lane of a
    batch (``crra`` then a scalar or [C]).  Under a compact ``grid`` the
    carried policy has the tail-closed shape [N, A+3] from the start."""
    check_policies(precision=precision, grid=grid, kernel=kernel,
                   state=state)
    if root_method != "bisect":
        raise NotImplementedError(
            f"root_method={root_method!r} is not ported yet: only 'bisect' "
            f"runs in this slice (ROADMAP Queue 1 item 3)")
    model, crra, single = _lanes(model, crra)
    r_tol, egm_tol, dist_tol, r_lo, r_hi = _bisection_setup(
        model, disc_fac, depr_fac, r_tol, egm_tol, dist_tol)
    labor = aggregate_labor(model)
    like = model.borrow_limit
    dev = like.device
    C = like.shape[0]
    lo = torch.full_like(like, r_lo)
    hi = torch.full_like(like, r_hi)
    it = torch.zeros((C,), dtype=torch.int32, device=dev)
    supply = torch.zeros_like(like)
    egm_acc = torch.zeros((C,), dtype=torch.int32, device=dev)
    dist_acc = torch.zeros((C,), dtype=torch.int32, device=dev)
    inner = torch.full((C,), CONVERGED, dtype=torch.int32, device=dev)
    ok = torch.ones((C,), dtype=torch.bool, device=dev)
    policy = initial_policy(model,
                            analytic_tail=resolve_grid(grid).compact)
    dist = initial_distribution(model)
    while True:
        lanes = torch.nonzero(((hi - lo) > r_tol) & (it < max_bisect)
                              & ok)[:, 0]
        if lanes.numel() == 0:
            break
        mid = 0.5 * (lo[lanes] + hi[lanes])
        ev = household_capital_supply(
            mid, select_lanes(model, lanes), disc_fac, crra[lanes],
            cap_share, depr_fac, prod, egm_tol=egm_tol, dist_tol=dist_tol,
            init_policy=select_lanes(policy, lanes), init_dist=dist[lanes],
            grid=grid, kernel=kernel)
        ex = ev.supply - firm.k_to_l_from_r(mid, cap_share, depr_fac,
                                            prod) * labor[lanes]
        fin = torch.isfinite(ex)
        up = ex > 0
        lo[lanes] = torch.where(fin & ~up, mid, lo[lanes])
        hi[lanes] = torch.where(fin & up, mid, hi[lanes])
        it[lanes] += 1
        supply[lanes] = ev.supply
        egm_acc[lanes] += ev.egm_iters
        dist_acc[lanes] += ev.dist_iters
        policy.m_knots[lanes] = ev.policy.m_knots
        policy.c_knots[lanes] = ev.policy.c_knots
        dist[lanes] = ev.distribution
        inner[lanes] = ev.status
        ok[lanes] = fin
    status = combine_status(
        torch.where(~ok, NONFINITE, CONVERGED),
        torch.where((hi - lo) > r_tol, MAX_ITER, CONVERGED), inner)
    out = LeanEquilibrium(r_star=0.5 * (lo + hi), capital=supply,
                          labor=labor, bisect_iters=it, egm_iters=egm_acc,
                          dist_iters=dist_acc, status=status)
    return type(out)(*(f[0] for f in out)) if single else out


def _solve_cell(solver, crra, labor_ar, labor_sd=0.2, labor_states=7,
                disc_fac=0.96, cap_share=0.36, depr_fac=0.08,
                a_min=0.001, a_max=50.0, a_count=32, a_nest_fac=2,
                dist_count=500, grid="reference", dtype=None, device=None,
                **solver_kwargs):
    """Build the model for one (crra, rho, sd) cell on ``device`` (default:
    the card) and run ``solver`` on it."""
    model = build_simple_model(
        labor_states=labor_states, labor_ar=labor_ar, labor_sd=labor_sd,
        a_min=a_min, a_max=a_max, a_count=a_count, a_nest_fac=a_nest_fac,
        dist_count=dist_count, grid=grid, dtype=dtype, device=device)
    return solver(model, disc_fac, crra, cap_share, depr_fac, grid=grid,
                  **solver_kwargs)


def solve_calibration(crra: float, labor_ar: float,
                      **kwargs) -> EquilibriumResult:
    """One Table II cell with the full equilibrium objects."""
    return _solve_cell(solve_bisection_equilibrium, crra, labor_ar, **kwargs)


def solve_calibration_lean(crra: float, labor_ar: float,
                           **kwargs) -> LeanEquilibrium:
    """One Table II cell, scalars only: the sweep path."""
    return _solve_cell(solve_equilibrium_lean, crra, labor_ar, **kwargs)


__all__ = [
    "EquilibriumResult", "SupplyEval", "LeanEquilibrium",
    "household_capital_supply", "solve_bisection_equilibrium",
    "solve_equilibrium_lean", "solve_calibration", "solve_calibration_lean",
]
