"""Huggett (1993): the pure-exchange bond economy (port of
``aiyagari_hark_tpu/models/huggett.py``).  Households trade a bond in
zero net supply under idiosyncratic endowment risk and a debt limit
``b < 0``; the interest rate clears the credit market, ``E[a] = 0``.

The household machinery is Aiyagari's -- the EGM kernel and the lottery
kernel, both run at the model's negative ``borrow_limit`` -- with labor
income an endowment (no firm: ``R = 1 + r``, ``W = 1``).

Net demand rises in r and diverges as r nears the discount rate, so the
upper bracket end always holds; the lower end is validated and widened
toward -90 % for up to ``WIDEN_PROBES`` probes (a tight debt limit can
keep net demand positive at ``r_lo``).  Every lane of a batch widens
and bisects on its own, and each probe or trip launches the kernels on
the lanes still active.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..solver_health import CONVERGED, MAX_ITER, NONFINITE, combine_status
from ..utils.config import resolve_grid
from .equilibrium import _bisect_trips, _lanes
from .household import (HouseholdPolicy, SimpleModel, aggregate_capital,
                        anderson_rate, check_policies, egm_step,
                        initial_distribution, initial_policy, pairwise_sum,
                        select_lanes, solve_household, stationary_wealth)

# The lower bracket end widens toward this rate, at most WIDEN_PROBES
# times, each step twice the last (0.1, 0.2, 0.4, ...).
R_LO_FLOOR = -0.9
WIDEN_PROBES = 6


class HuggettEquilibrium(NamedTuple):
    r_star: torch.Tensor          # equilibrium net bond rate
    net_demand: torch.Tensor      # E[a] at r_star (~0)
    policy: HouseholdPolicy       # at r_star
    distribution: torch.Tensor    # [D, N] stationary wealth distribution
    borrower_share: torch.Tensor  # stationary mass with a < 0
    bisect_iters: torch.Tensor
    bracketed: torch.Tensor       # net demand <= 0 at the (widened) low
    # end; False means r_star is not an equilibrium (check net_demand)


class HuggettLanes(NamedTuple):
    """Every lane's outcome of ``solve_huggett_lanes``."""

    r_star: torch.Tensor
    net_demand: torch.Tensor
    borrower_share: torch.Tensor
    policy: HouseholdPolicy
    distribution: torch.Tensor
    bracketed: torch.Tensor
    trips: torch.Tensor          # bisection trips (a warm seed's levels not
    #                              counted)
    evaluations: torch.Tensor    # net-demand evaluations before the last
    egm_iters: torch.Tensor      # summed over every evaluation
    dist_iters: torch.Tensor
    status: torch.Tensor


def borrower_share(dist: torch.Tensor, model: SimpleModel) -> torch.Tensor:
    """The stationary mass below zero wealth, summed by ``pairwise_sum``
    (a lane's sum must not depend on its batch-mates on the card)."""
    x = torch.where(model.dist_grid[..., :, None] < 0, dist,
                    torch.zeros_like(dist))
    lead = x.shape[:-2]
    return pairwise_sum(x.reshape(-1, x.shape[-2] * x.shape[-1])).reshape(
        lead)


def bond_demand(r, model: SimpleModel, disc_fac, crra, egm_tol=1e-6,
                dist_tol=1e-11, init_policy_=None, init_dist=None,
                accel_every: int = 32, precision: str = "reference",
                grid="reference", kernel="reference", state="replicated"):
    """One net-demand evaluation at rate ``r`` through the EGM and
    lottery kernels (endowment economy: ``R = 1 + r``, ``W = 1``):
    (E[a], policy, distribution, the steps [2, ...] of the two fixed
    points, status).  The status adds NONFINITE where E[a] is not
    finite."""
    pol, e_it, _, e_st = solve_household(
        1.0 + r, 1.0, model, disc_fac, crra, tol=egm_tol,
        init_policy=init_policy_, accel_every=accel_every,
        precision=precision, grid=grid, kernel=kernel, state=state)
    dist, d_it, _, d_st = stationary_wealth(
        pol, 1.0 + r, 1.0, model, tol=dist_tol, init_dist=init_dist,
        precision=precision, kernel=kernel, state=state)
    ex = aggregate_capital(dist, model)
    st = combine_status(e_st, d_st, torch.where(torch.isfinite(ex),
                                                CONVERGED, NONFINITE))
    return ex, pol, dist, torch.stack([e_it, d_it]), st


def net_bond_demand(r, model: SimpleModel, disc_fac, crra,
                    egm_tol=1e-6, dist_tol=1e-11, init_policy_=None,
                    init_dist=None, precision: str = "reference"):
    """E[a] at rate ``r`` (positive: net savers), the policy and the
    distribution: the first three items of ``bond_demand``, the
    evaluation every Huggett solve runs.  The JAX ``dist_method`` has no
    counterpart: the port has one engine of each fixed point."""
    return bond_demand(r, model, disc_fac, crra, egm_tol=egm_tol,
                       dist_tol=dist_tol, init_policy_=init_policy_,
                       init_dist=init_dist, precision=precision)[:3]


def widen_lower_end(lo: torch.Tensor, ex: torch.Tensor, probe) -> None:
    """Walk each lane's ``lo`` down toward ``R_LO_FLOOR`` while its net
    demand ``ex`` is positive, in place: probe k moves it by 0.1 * 2^k in
    the lanes' dtype, at most ``WIDEN_PROBES`` times.  ``probe(r,
    lanes)`` evaluates the active lanes cold and returns their net
    demand."""
    k = torch.zeros(lo.shape, dtype=torch.int32, device=lo.device)
    while True:
        lanes = torch.nonzero((ex > 0) & (k < WIDEN_PROBES)
                              & (lo > R_LO_FLOOR))[:, 0]
        if lanes.numel() == 0:
            return
        step = 0.1 * torch.pow(2.0, k[lanes].to(torch.float64))
        new = torch.clamp_min(lo[lanes] - step.to(lo.dtype), R_LO_FLOOR)
        ex[lanes] = probe(new, lanes)
        lo[lanes] = new
        k[lanes] += 1


def solve_huggett_lanes(model: SimpleModel, disc_fac, crra, r_tol=None,
                        max_bisect: int = 60, egm_tol=None, dist_tol=None,
                        r_lo: float = -0.10, accel_every: int = 32,
                        precision: str = "reference", grid="reference",
                        kernel="reference", state="replicated",
                        bracket_init=None, fault_iter=None,
                        fault_mode=None) -> HuggettLanes:
    """The bracketed bisection of every lane of a batched ``model``
    (``crra`` a scalar or [C]), shared by ``solve_huggett_equilibrium``
    and the lean scenario solver.

    Establishment: one cold evaluation at ``r_lo``, or with
    ``bracket_init=(lo, hi, levels)`` two cold evaluations at the seed's
    ends; a lane whose seed verifies (net demand <= 0 at ``lo``, > 0 at
    ``hi``) keeps it and counts ``levels`` trips as spent, any other lane
    keeps the seed's low end against the full upper end.  Then
    ``widen_lower_end``; the lane is ``bracketed`` where net demand at
    its low end is <= 0.  The bisection trips warm-start each lane's two
    fixed points from its previous midpoint (the first from the cold
    start) and a final evaluation at r* (warm) gives the net demand, the
    policy and the distribution.

    A non-finite net demand keeps the bracket and a lane whose summed
    status reaches NONFINITE stops (the JAX lean solver's tripwire).
    ``fault_iter``: a NaN net demand at exactly that trip (any
    ``fault_mode``), the quarantine drill.  ``accel_every`` is the EGM
    loop's cadence; the distribution loop keeps its own, as in JAX."""
    check_policies(precision=precision, grid=grid, kernel=kernel,
                   state=state)
    like = model.borrow_limit
    dt, dev = like.dtype, like.device
    f64 = dt == torch.float64
    if r_tol is None:
        r_tol = 1e-10 if f64 else 1e-6
    if egm_tol is None:
        egm_tol = 1e-6 if f64 else 1e-5
    if dist_tol is None:
        dist_tol = 1e-11 if f64 else 1e-8
    C = like.shape[0]
    every = torch.arange(C, device=dev)
    hi_full = torch.full_like(like, 1.0 / disc_fac - 1.0 - 1e-4)
    p0 = initial_policy(model, analytic_tail=resolve_grid(grid).compact)
    d0 = initial_distribution(model)

    def demand(r, lanes, policy=None, dist=None):
        return bond_demand(r, select_lanes(model, lanes), disc_fac,
                           crra[lanes], egm_tol=egm_tol, dist_tol=dist_tol,
                           init_policy_=policy, init_dist=dist,
                           accel_every=accel_every, precision=precision,
                           grid=grid, kernel=kernel, state=state)

    def ints(x=0):
        return torch.as_tensor(x, dtype=torch.int32,
                               device=dev).expand(C).clone()

    if bracket_init is None:
        lo = torch.full_like(like, r_lo)
        ex_lo, _, _, work, status = demand(lo, every)
        hi, it0, n_eval = hi_full.clone(), ints(), ints(1)
    else:
        lo = torch.as_tensor(bracket_init[0], dtype=dt,
                             device=dev).expand(C).clone()
        hi_s = torch.as_tensor(bracket_init[1], dtype=dt,
                               device=dev).expand(C)
        ex_lo, _, _, w1, s1 = demand(lo, every)
        ex_hi, _, _, w2, s2 = demand(hi_s, every)
        ok = (ex_lo <= 0) & (ex_hi > 0)
        hi = torch.where(ok, hi_s, hi_full)
        it0 = torch.where(ok, ints(bracket_init[2]), ints())
        work, status, n_eval = w1 + w2, combine_status(s1, s2), ints(2)

    def probe(r, lanes):
        ex, _, _, w, st = demand(r, lanes)
        work[:, lanes] += w
        status[lanes] = combine_status(status[lanes], st)
        n_eval[lanes] += 1
        return ex

    widen_lower_end(lo, ex_lo, probe)
    bracketed = ex_lo <= 0

    policy = HouseholdPolicy(*(f.clone() for f in p0))
    dist = d0.clone()

    def trip(mid, lanes):
        ex, pol, d, w, st = demand(mid, lanes, select_lanes(policy, lanes),
                                   dist[lanes])
        policy.m_knots[lanes] = pol.m_knots
        policy.c_knots[lanes] = pol.c_knots
        dist[lanes] = d
        return ex, w, st

    it = it0.clone()
    _bisect_trips(trip, lo, hi, it, status, work, r_tol, max_bisect,
                  fault_at=(None if fault_mode is None else
                            ints(-1 if fault_iter is None else fault_iter)))
    st_exit = torch.where((hi - lo) <= r_tol, CONVERGED, MAX_ITER)
    st_brk = torch.where(bracketed, CONVERGED, MAX_ITER)
    r_star = 0.5 * (lo + hi)
    ex, pol, d, w, st = demand(r_star, every, policy, dist)
    work = work + w
    return HuggettLanes(
        r_star=r_star, net_demand=ex, borrower_share=borrower_share(d, model),
        policy=pol, distribution=d, bracketed=bracketed, trips=it - it0,
        evaluations=n_eval + (it - it0), egm_iters=work[0],
        dist_iters=work[1],
        status=combine_status(status, st, st_exit, st_brk))


def solve_huggett_equilibrium(model: SimpleModel, disc_fac, crra,
                              r_tol: float | None = None,
                              max_bisect: int = 60,
                              egm_tol: float | None = None,
                              dist_tol: float | None = None,
                              r_lo: float = -0.10,
                              precision: str = "reference"
                              ) -> HuggettEquilibrium:
    """Bisect the bond rate until the credit market clears (E[a] = 0), one
    cell or every lane of a batch (``crra`` then a scalar or [C]).  The
    lower end is validated and widened (``widen_lower_end``); if it never
    turns negative, ``bracketed`` is False and ``r_star`` is not an
    equilibrium.  The midpoints warm-start the two fixed points as the
    Aiyagari lean bisection does.  ``bisect_iters`` counts the bisection
    trips.  A non-finite net demand stops the lane with its bracket, as
    every bisection of the port does (JAX's ``where`` moves the low
    end)."""
    model, crra, single = _lanes(model, crra)
    out = solve_huggett_lanes(model, disc_fac, crra, r_tol=r_tol,
                              max_bisect=max_bisect, egm_tol=egm_tol,
                              dist_tol=dist_tol, r_lo=r_lo,
                              precision=precision)
    eq = HuggettEquilibrium(
        r_star=out.r_star, net_demand=out.net_demand, policy=out.policy,
        distribution=out.distribution, borrower_share=out.borrower_share,
        bisect_iters=out.trips, bracketed=out.bracketed)
    if single:
        eq = eq._replace(policy=HouseholdPolicy(*(f[0] for f in eq.policy)))
        eq = type(eq)(*(f[0] if isinstance(f, torch.Tensor) else f
                        for f in eq))
    return eq


class CreditCrunchResult(NamedTuple):
    """Perfect-foresight deleveraging path after a foreseen tightening of
    the debt limit (Guerrieri-Lorenzoni 2017)."""

    r_path: torch.Tensor               # [T] bond rate clearing each market
    excess_path: torch.Tensor          # [T] residual net bond demand E[a_t]
    c_agg_path: torch.Tensor           # [T] aggregate consumption
    borrower_share_path: torch.Tensor  # [T] mass with assets < 0
    debt_path: torch.Tensor            # [T] gross debt E[max(-a, 0)]
    converged: bool
    iterations: int
    max_excess: torch.Tensor


def solve_credit_crunch(model_loose: SimpleModel, disc_fac, crra, b_path,
                        init_dist: torch.Tensor, terminal_policy, r_pre,
                        r_terminal, a_nest_fac: int = 2,
                        damping: float = 0.02, tol: float | None = None,
                        max_iter: int = 4000) -> CreditCrunchResult:
    """The credit crunch: from the loose-limit stationary equilibrium the
    debt limit tightens along the foreseen path ``b_path`` [T], and the
    bond market clears at every date of the deleveraging.  The unknown is
    the rate path: bonds bought at t pay ``r_{t+1}``, so ``E[a_t] = 0``
    pairs with ``r_{t+1}`` (``r_0 = r_pre``; beyond the horizon
    ``r_terminal``).

    A damped tatonnement ``r_{t+1} -= damping E[a_t]`` on the host, with
    an Anderson(1) jump every 32 steps and the best iterate carried (the
    result is the iterate its max excess certifies).  Each iteration is a
    backward loop of ``egm_step`` with the date's debt limit and grid
    (per-date grids built on the host as ``build_simple_model`` builds
    them), and the forward pass of ``transition`` on the loose-limit
    support: the T dates' lotteries in one gather.  Two host syncs per
    iteration (the exit test and the gather's padding).  ``damping`` must
    be small: savings at t respond to the whole future rate path (0.02
    converges on the 0.5 tightening phased in over 24 periods, 0.05
    diverges)."""
    # the per-date grids keep model_loose's reference layout
    from ..ops.grids import make_asset_grid  # grid-ok
    from .transition import _row_sums, device_scalars, forward_pass

    like = model_loose.a_grid
    dt, dev = like.dtype, like.device
    if tol is None:
        tol = 1e-7 if dt == torch.float64 else 1e-5
    b_path = np.asarray(b_path, dtype=np.float64)
    T = b_path.shape[0]
    a_host = model_loose.a_grid.cpu().numpy().astype(np.float64)
    a_count, a_max = a_host.shape[0], float(a_host[-1])
    b_loose = float(model_loose.borrow_limit)
    a_min = float(a_host[0]) - b_loose
    a_grids = torch.as_tensor(np.stack([
        b + make_asset_grid(  # grid-ok
            a_min, a_max - b, a_count, a_nest_fac,
            dtype=torch.float64).numpy()
        for b in b_path]), dtype=dt, device=dev)
    if np.isclose(b_path[0], b_loose) and not np.allclose(
            a_grids[0].cpu().numpy(), a_host, rtol=1e-6):
        raise ValueError(
            "date-0 asset grid does not reproduce model_loose.a_grid: "
            "model_loose was built with a non-default a_nest_fac; pass the "
            "same value to solve_credit_crunch(a_nest_fac=...)")
    b_arr = torch.as_tensor(b_path, dtype=dt, device=dev)
    r_pre = torch.as_tensor(r_pre, dtype=dt, device=dev)
    r_term = torch.as_tensor(r_terminal, dtype=dt, device=dev)
    grid = model_loose.dist_grid
    neg = torch.where(grid < 0, -grid, torch.zeros_like(grid))
    frac = torch.linspace(0.0, 1.0, T, dtype=dt, device=dev)
    r_guess = (1.0 - frac) * r_pre + frac * r_term
    r_guess[0] = r_pre
    r_cap = 1.0 / disc_fac - 1.0 - 1e-4
    beta, crra_t, one = device_scalars(model_loose, disc_fac, crra, 1.0)

    def implied(r_path):
        r_next = torch.cat([r_path[1:], r_term[None]])
        pols = [None] * T
        pol = terminal_policy
        for t in range(T - 1, -1, -1):
            pol = egm_step(pol, 1.0 + r_next[t], one, model_loose._replace(
                a_grid=a_grids[t], borrow_limit=b_arr[t]), beta, crra_t)
            pols[t] = pol
        pols = HouseholdPolicy(*(torch.stack(f) for f in zip(*pols)))
        dists, _, c_agg, a_agg = forward_pass(
            pols, 1.0 + r_path, torch.ones_like(r_path), model_loose,
            init_dist)
        borrowers = _row_sums(torch.where(grid[None, :, None] < 0, dists,
                                          torch.zeros_like(dists)))
        debt = _row_sums(dists * neg[None, :, None])
        return a_agg, c_agg, borrowers, debt

    with torch.no_grad():
        r_path, r_prev, r_best = r_guess, r_guess, r_guess
        ex_best = torch.tensor(float("inf"), dtype=dt, device=dev)
        it = 0
        while it < max_iter and bool(ex_best > tol):
            a_agg = implied(r_path)[0]
            ex_max = torch.max(torch.abs(a_agg[:-1]))
            r_best = torch.where(ex_max < ex_best, r_path, r_best)
            ex_best = torch.minimum(ex_best, ex_max)
            # r_{t+1} clears E[a_t]; the last market closes by the
            # terminal condition
            r_new = r_path.clone()
            r_new[1:] -= damping * a_agg[:-1]
            r_new = torch.clamp(r_new, -0.5, r_cap)
            r_new[0] = r_pre
            if (it + 1) % 32 == 0:
                # Anderson(1) along the dominant mode, clipped and pinned,
                # never returned directly (the best-iterate carry)
                lam = anderson_rate((r_path - r_prev)[None],
                                    (r_new - r_path)[None])[0]
                r_x = torch.clamp(r_new + lam / (1.0 - lam) * (r_new - r_path),
                                  -0.5, r_cap)
                r_x[0] = r_pre
                r_new = torch.where(ex_max > tol, r_x, r_new)
            r_prev, r_path = r_path, r_new
            it += 1
        a_agg, c_agg, borrowers, debt = implied(r_best)
    return CreditCrunchResult(
        r_path=r_best, excess_path=a_agg, c_agg_path=c_agg,
        borrower_share_path=borrowers, debt_path=debt,
        converged=bool(ex_best <= tol), iterations=it, max_excess=ex_best)


__all__ = ["CreditCrunchResult", "HuggettEquilibrium", "HuggettLanes", "R_LO_FLOOR",
           "WIDEN_PROBES", "bond_demand", "borrower_share",
           "net_bond_demand", "solve_credit_crunch",
           "solve_huggett_equilibrium", "solve_huggett_lanes",
           "widen_lower_end"]
