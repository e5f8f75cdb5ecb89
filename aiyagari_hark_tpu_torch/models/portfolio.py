"""Two-asset (safe + risky) portfolio-choice household and its general
equilibrium (port of ``aiyagari_hark_tpu/models/portfolio.py``).

Model: at the end of a period the household holds assets ``a`` split
between a safe asset returning ``R_f`` and a risky asset returning a
discrete draw ``R_k`` (probability ``p_k``), the risky share ``omega`` in
[0, 1]; labor income follows the Aiyagari model's Tauchen process.

    FOC(share):  f(omega; a, s) = E_{k, s'} [ (R_k - R_f) u'(c'(m')) ] = 0
                 m' = (R_f + omega (R_k - R_f)) a + W l_{s'}
    f falls in omega, so the optimum is the sign change of f on a share
    grid, refined linearly and clamped to [0, 1].
    EGM:         EndOfPrdvP(a, s) = beta E_{k, s'} [ R_p(omega*) u'(c'(m')) ]
                 c = EndOfPrdvP^(-1/gamma);  m = a + c  (+ constraint knot)

No Pallas kernel runs on this path in the JAX package (its EGM step and
push-forward are XLA), so here every step is plain PyTorch on the
model's device: the household loop one host sync a step (its sup-norm
test), the distribution one lane of ``household.
accelerated_distribution_fixed_point``, which reads its exit every
``household.SYNC_EVERY["cuda"]`` = 16 steps on the card (every step on
the CPU; the steps after a lane stops change no bit).  The two
``einsum`` contractions run in the model dtype; ``device.resolve_device``
keeps TF32 off on the card.

The push-forward sums without atomics: each transition sorts its
contributions by target once (``PortfolioPush``), and every step sums
each target's contributions by a fixed pairwise tree over them in the JAX
package's source order (see ``PortfolioPush``), bitwise the same from run
to run on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device, resolve_dtype
# the portfolio family predates the grid policy
from ..ops.grids import make_asset_grid, make_grid_exp_mult  # grid-ok
from ..ops.interp import clip, interp1d, interp1d_rowwise, locate_in_grid
from ..ops.markov import (normalized_labor_states, stationary_distribution,
                          tauchen_labor_process)
from ..ops.utility import inverse_marginal_utility, marginal_utility
from ..solver_health import combine_status
from .household import (CONSTRAINT_EPS, HouseholdPolicy,
                        accelerated_distribution_fixed_point,
                        initial_distribution, pairwise_sum)
from .transition import device_scalars


class PortfolioModel(NamedTuple):
    """Static calibration of the two-asset household."""

    a_grid: torch.Tensor            # [A] end-of-period total assets
    labor_levels: torch.Tensor      # [N]
    transition: torch.Tensor        # [N, N]
    labor_stationary: torch.Tensor  # [N]
    risky_returns: torch.Tensor     # [K] gross return draws
    risky_probs: torch.Tensor       # [K]
    share_grid: torch.Tensor        # [S] candidate risky shares in [0, 1]
    dist_grid: torch.Tensor = None  # [D] wealth-histogram support (GE path)


class PortfolioPolicy(NamedTuple):
    """Consumption knots per labor state and the risky share on the
    end-of-period asset grid."""

    m_knots: torch.Tensor   # [N, A+1]
    c_knots: torch.Tensor   # [N, A+1]
    share: torch.Tensor     # [N, A] omega*(a_i, s)


def _host_linspace(n: int, dt: torch.dtype) -> np.ndarray:
    """``jnp.linspace(0, 1, n)`` bit for bit: ``i * (1 / (n - 1))`` in the
    dtype, the last point 1 exactly (``torch.linspace`` fills its upper
    half from the far end, which rounds other points)."""
    ft = np.float64 if dt == torch.float64 else np.float32
    if n == 1:
        return np.zeros(1, dtype=ft)
    out = np.arange(n - 1, dtype=ft) * (ft(1.0) / ft(n - 1))
    return np.concatenate([out, np.ones(1, dtype=ft)])


def lognormal_risky_returns(mean: float, std: float, n: int = 7,
                            dtype=None, device=None):
    """Equiprobable lognormal discretization of the gross risky return:
    the ``n`` conditional means of equal-probability slices (HARK's
    ``Lognormal.discretize``), matching ``mean``/``std``.  Computed on the
    host in float64, then cast.  Returns (values [n], probabilities
    [n])."""
    from scipy.stats import norm as scipy_norm

    dev, dt = resolve_device(device), resolve_dtype(dtype)
    sigma2 = np.log(1.0 + (std / mean) ** 2)
    sigma = np.sqrt(sigma2)
    mu = np.log(mean) - 0.5 * sigma2
    edges = scipy_norm.ppf(np.linspace(0.0, 1.0, n + 1))
    # E[X | z in (a, b)] = e^{mu + s^2/2} (Phi(b - s) - Phi(a - s))
    #                      / (Phi(b) - Phi(a))
    cdf = scipy_norm.cdf
    num = cdf(edges[1:] - sigma) - cdf(edges[:-1] - sigma)
    den = cdf(edges[1:]) - cdf(edges[:-1])
    vals = np.exp(mu + 0.5 * sigma2) * num / den
    probs = np.full(n, 1.0 / n)
    return (torch.as_tensor(vals, dtype=dt, device=dev),
            torch.as_tensor(probs, dtype=dt, device=dev))


def build_portfolio_model(labor_states: int = 7, labor_ar: float = 0.6,
                          labor_sd: float = 0.2, labor_bound: float = 3.0,
                          a_min: float = 0.001, a_max: float = 50.0,
                          a_count: int = 48, a_nest_fac: int = 2,
                          risky_mean: float = 1.08, risky_std: float = 0.20,
                          risky_count: int = 7, share_count: int = 25,
                          dist_count: int = 300, dtype=None,
                          device=None) -> PortfolioModel:
    """The calibration arrays on ``device`` (default: the card) in
    ``dtype`` (default float32).  The histogram support is the
    single-asset model's: a zero point for the borrowing limit, then
    exp-mult spacing."""
    dev, dt = resolve_device(device), resolve_dtype(dtype)
    a_grid = make_asset_grid(  # grid-ok
        a_min, a_max, a_count, a_nest_fac, dtype=dt, device=dev)
    tauchen = tauchen_labor_process(labor_states, labor_ar, labor_sd,
                                    bound=labor_bound, dtype=dt, device=dev)
    returns, probs = lognormal_risky_returns(risky_mean, risky_std,
                                             risky_count, dtype=dt,
                                             device=dev)
    inner = make_grid_exp_mult(  # grid-ok
        a_min, a_max, dist_count - 1, a_nest_fac, dtype=dt, device=dev)
    return PortfolioModel(
        a_grid=a_grid,
        labor_levels=normalized_labor_states(tauchen.grid),
        transition=tauchen.transition,
        labor_stationary=stationary_distribution(tauchen.transition),
        risky_returns=returns, risky_probs=probs,
        share_grid=torch.as_tensor(_host_linspace(share_count, dt),
                                   device=dev),
        dist_grid=torch.cat([inner.new_zeros(1), inner]))


def initial_portfolio_policy(model: PortfolioModel) -> PortfolioPolicy:
    """Terminal guess: consume everything (knots of slope 1), share 0."""
    a = model.a_grid
    n = model.labor_levels.shape[0]
    eps = torch.tensor(CONSTRAINT_EPS, dtype=a.dtype, device=a.device)
    m_row = torch.cat([eps[None], a + eps])
    knots = m_row[None, :].expand(n, -1).clone()
    return PortfolioPolicy(m_knots=knots, c_knots=knots.clone(),
                           share=torch.zeros((n, a.shape[0]), dtype=a.dtype,
                                             device=a.device))


def _optimal_share(gap_foc: torch.Tensor,
                   share_grid: torch.Tensor) -> torch.Tensor:
    """Zero crossing of the (decreasing in omega) excess-return FOC on the
    share grid, refined linearly; corners without a sign change.
    ``gap_foc`` [..., S] holds f(omega_j); returns omega* [...]."""
    s = share_grid.shape[0]
    pos = gap_foc >= 0
    # the last gridpoint with f >= 0 (f falls); 0 if none
    idx = torch.clamp(pos.to(torch.int64).sum(dim=-1) - 1, 0, s - 2)
    f0 = torch.gather(gap_foc, -1, idx[..., None])[..., 0]
    f1 = torch.gather(gap_foc, -1, idx[..., None] + 1)[..., 0]
    w0, w1 = share_grid[idx], share_grid[idx + 1]
    t = torch.where(torch.abs(f1 - f0) > 1e-30, f0 / (f0 - f1),
                    torch.zeros_like(f0))
    omega = w0 + clip(t, t.new_zeros(()), t.new_ones(())) * (w1 - w0)
    omega = torch.where(~pos[..., 0], share_grid[0], omega)   # f(0) < 0
    return torch.where(pos[..., -1], share_grid[-1], omega)   # f(1) >= 0


def _next_marginal_value(r_port, policy: PortfolioPolicy, wage,
                         model: PortfolioModel, crra):
    """u'(c'(m')) at ``m' = R_p a + W l'`` for portfolio returns ``r_port``
    [A, X, K]: [A, X, K, N']."""
    a = model.a_grid
    n = model.labor_levels.shape[0]
    m_next = (r_port[..., None] * a[:, None, None, None]
              + wage * model.labor_levels[None, None, None, :])
    c_next = interp1d_rowwise(m_next.reshape(-1, n).T, policy.m_knots,
                              policy.c_knots)
    return marginal_utility(c_next.T.reshape(m_next.shape), crra)


def egm_step_portfolio(policy: PortfolioPolicy, r_free, wage,
                       model: PortfolioModel, disc_fac,
                       crra) -> PortfolioPolicy:
    """One backward step: the share FOC on the [A, S, K, N'] tensor, then
    EGM on consumption at the optimal share."""
    a = model.a_grid
    n = model.labor_levels.shape[0]
    excess = model.risky_returns - r_free                          # [K]
    r_port = r_free + model.share_grid[:, None] * excess[None, :]  # [S, K]
    vp = _next_marginal_value(r_port[None].expand(a.shape[0], -1, -1),
                              policy, wage, model, crra)           # [A,S,K,N']
    # f[A, j, S] = sum_{k, n'} p_k P[j, n'] (R_k - R_f) u'
    foc = torch.einsum("askn,k,jn->ajs", vp, excess * model.risky_probs,
                       model.transition)
    omega = _optimal_share(foc, model.share_grid)                  # [A, j]
    # the marginal value at omega*: m' re-derived at the refined share
    r_opt = r_free + omega[:, :, None] * excess[None, None, :]     # [A, s, K]
    vp_opt = _next_marginal_value(r_opt, policy, wage, model, crra)
    end_vp = disc_fac * torch.einsum("ajkn,k,jn->aj",
                                     r_opt[..., None] * vp_opt,
                                     model.risky_probs, model.transition)
    c_now = inverse_marginal_utility(end_vp, crra)                 # [A, s]
    m_now = a[:, None] + c_now
    eps = torch.full((1, n), CONSTRAINT_EPS, dtype=c_now.dtype,
                     device=c_now.device)
    return PortfolioPolicy(m_knots=torch.cat([eps, m_now], dim=0).T,
                           c_knots=torch.cat([eps, c_now], dim=0).T,
                           share=omega.T)                          # [N, A]


def solve_portfolio_household(r_free, wage, model: PortfolioModel, disc_fac,
                              crra, tol: float = 1e-6, max_iter: int = 3000,
                              init_policy: PortfolioPolicy | None = None):
    """The infinite-horizon fixed point (sup-norm on the consumption
    knots, no extrapolation), one host sync a step for the test.
    ``init_policy`` warm-starts it (the previous bisection midpoint's
    policy).  Returns (PortfolioPolicy, n_iter, final_diff)."""
    policy = (initial_portfolio_policy(model) if init_policy is None
              else init_policy)
    r_free, wage, disc_fac, crra = device_scalars(model, r_free, wage,
                                                  disc_fac, crra)
    diff = torch.tensor(float("inf"), dtype=model.a_grid.dtype,
                        device=model.a_grid.device)
    it = 0
    while it < max_iter and bool(diff > tol):
        new = egm_step_portfolio(policy, r_free, wage, model, disc_fac,
                                 crra)
        diff = torch.max(torch.abs(new.c_knots - policy.c_knots))
        policy = new
        it += 1
    return policy, it, diff


def consumption_policy(policy: PortfolioPolicy) -> HouseholdPolicy:
    """The consumption part as a plain ``HouseholdPolicy``, so the
    single-asset readouts apply."""
    return HouseholdPolicy(m_knots=policy.m_knots, c_knots=policy.c_knots)


def share_at(policy: PortfolioPolicy, a, model: PortfolioModel,
             state_idx=None):
    """The risky share omega*(a) per labor state (interpolated on the
    end-of-period asset grid), or of one state ``state_idx``."""
    grid = model.a_grid
    a = torch.as_tensor(a, dtype=grid.dtype, device=grid.device)
    if state_idx is None:
        n = policy.share.shape[0]
        queries = a.reshape(1, -1).expand(n, -1)
        out = interp1d_rowwise(queries, grid[None].expand(n, -1),
                               policy.share)
        return out.reshape((n,) + tuple(a.shape))
    return interp1d(a, grid, policy.share[state_idx])


# ---------------------------------------------------------------------------
# General equilibrium: the stationary distribution and the capital-market
# bisection.  The closure is the JAX package's: productive capital is the
# risky asset, its mean gross return (1 + r) with mean-one shocks eps_k,
# R_k = (1 + r) eps_k; the safe asset is supplied elastically at
# R_f = 1 + r - premium.  Only the capital market clears:
# E[omega(a, s) a] = K_demand(r).  With no return risk (risky_std -> 0)
# and a positive premium the share is 1 and the economy is the
# single-asset one.
# ---------------------------------------------------------------------------

class PortfolioTransition(NamedTuple):
    """Young-method lottery of the two-asset model: where the next-period
    savings of each end-of-period (asset gridpoint d, labor state n)
    land, per (risky draw k, next labor state n')."""

    idx: torch.Tensor     # [D, N, K, N'] left-neighbour index into dist_grid
    weight: torch.Tensor  # [D, N, K, N'] mass share on the right neighbour
    omega: torch.Tensor   # [D, N] risky share at each histogram point


def _require_dist_grid(model: PortfolioModel) -> None:
    if model.dist_grid is None:
        raise ValueError(
            "PortfolioModel.dist_grid is required for the distribution/GE "
            "path — construct the model via build_portfolio_model("
            "dist_count=...) or _replace(dist_grid=...)")


def _share_on_dist_grid(policy: PortfolioPolicy,
                        model: PortfolioModel) -> torch.Tensor:
    """omega(a, s) interpolated onto the histogram support, [D, N]."""
    n = model.labor_levels.shape[0]
    queries = model.dist_grid[None].expand(n, -1)
    grids = model.a_grid[None].expand(n, -1)
    return interp1d_rowwise(queries, grids, policy.share).T


def portfolio_wealth_transition(policy: PortfolioPolicy, r_free, wage,
                                model: PortfolioModel) -> PortfolioTransition:
    """The state is the END-of-period (assets a, labor state s), where the
    share ``omega(a, s)`` is chosen.  From (a, s), with probability
    ``p_k P[s, s']``: ``m' = (R_f + omega (R_k - R_f)) a + W l_{s'}`` and
    ``a' = m' - c(m', s')``, a lottery onto ``dist_grid``."""
    _require_dist_grid(model)
    x = model.dist_grid
    n = model.labor_levels.shape[0]
    omega = _share_on_dist_grid(policy, model)                  # [D, N]
    excess = model.risky_returns - r_free                       # [K]
    r_port = r_free + omega[..., None] * excess                 # [D, N, K]
    m_next = (r_port[..., None] * x[:, None, None, None]
              + wage * model.labor_levels)                      # [D,N,K,N']
    c_next = interp1d_rowwise(m_next.reshape(-1, n).T, policy.m_knots,
                              policy.c_knots)
    a_next = clip(m_next - c_next.T.reshape(m_next.shape), x.new_zeros(()),
                  x[-1])
    idx, w = locate_in_grid(a_next, x)
    return PortfolioTransition(idx=idx, weight=w, omega=omega)


class PortfolioPush(NamedTuple):
    """The push-forward of one ``PortfolioTransition`` as a segmented sum,
    built once per transition (``portfolio_push``).

    The contributions of column n' are the JAX package's, in its order:
    every left share ``mass (1 - w)`` in ravel order over [D, N, K], then
    every right share ``mass w``.  Stably sorted by target (column n',
    gridpoint), each target's contributions keep that order, and a step
    sums them by a fixed pairwise tree over the sorted vector: at level j
    the element at position p of its target's run takes the one at
    p + 2^j when p is a multiple of 2^(j+1) (``household.pairwise_sum``'s
    tree, unpadded).  Up to three contributions this is the JAX package's
    left-to-right sum bit for bit; beyond, it rounds differently.  Every
    level is elementwise, so the bits do not depend on the device's
    scheduling (no atomics), and a step's launches grow with the log of
    the in-degree, not with the in-degree: the constrained sources all
    land on gridpoints 0 and 1, up to D N K contributions each.  The tree
    is as deep as the transition's longest run needs, ceil(log2(run))
    levels, read once when the push is built: a deeper level adds only
    zeros."""

    source: torch.Tensor   # [M] index into mass [N', D, N, K], sorted order
    coef: torch.Tensor     # [M] (1 - w) or w of each sorted contribution
    masks: tuple           # per level j: [M - 2^j] bool, receives p + 2^j
    first: torch.Tensor    # [N' D] first sorted position of each target
    filled: torch.Tensor   # [N' D] bool: the target has a contribution
    shape: tuple           # (D, N')


def portfolio_push(trans: PortfolioTransition) -> PortfolioPush:
    """Sort a transition's contributions by target and lay out the
    pairwise tree (``PortfolioPush``); one host sync, which reads the
    longest run to size the tree."""
    d_size, n, k, n_next = trans.idx.shape
    dev = trans.idx.device
    per_col = d_size * n * k
    idx = trans.idx.permute(3, 0, 1, 2).reshape(n_next, per_col)
    w = trans.weight.permute(3, 0, 1, 2).reshape(n_next, per_col)
    col = torch.arange(n_next, device=dev)[:, None] * d_size
    # [N', 2, D N K]: column-major targets, left shares then right shares
    target = torch.stack([idx + col, idx + 1 + col], dim=1).reshape(-1)
    coef = torch.stack([1.0 - w, w], dim=1).reshape(-1)
    src = (torch.arange(per_col, device=dev)[None, None, :]
           + torch.arange(n_next, device=dev)[:, None, None] * per_col
           ).expand(n_next, 2, per_col).reshape(-1)
    target, order = torch.sort(target, stable=True)
    m = target.numel()
    pos = torch.arange(m, device=dev)
    head = torch.ones(m, dtype=torch.bool, device=dev)
    head[1:] = target[1:] != target[:-1]
    start = torch.cummax(torch.where(head, pos, torch.zeros_like(pos)),
                         dim=0).values
    rank = pos - start                                # place in its run
    n_targets = n_next * d_size
    count = torch.bincount(target, minlength=n_targets)
    length = count[target]
    longest = int(count.max())        # at most 2 D N K shares
    masks = []
    step = 1
    while step < longest:
        masks.append(((rank % (2 * step)) == 0)[:m - step]
                     & (rank[:m - step] + step < length[:m - step]))
        step *= 2
    first = torch.searchsorted(target, torch.arange(n_targets, device=dev))
    return PortfolioPush(source=src[order], coef=coef[order],
                         masks=tuple(masks), first=first.clamp(max=m - 1),
                         filled=count > 0, shape=(d_size, n_next))


def _push_forward_portfolio(dist, trans: PortfolioTransition,
                            model: PortfolioModel,
                            push: PortfolioPush | None = None):
    """One distribution step: the mass of (d, n) splits over (k, n') with
    weight ``p_k P[n, n']`` and moves along the asset lottery into column
    n'.  ``push`` is the transition's ``portfolio_push`` (built here when
    not given)."""
    if push is None:
        push = portfolio_push(trans)
    d_size, n_next = push.shape
    # mass[n', d, n, k] = dist[d, n] p_k P[n, n']
    mass = ((dist[:, :, None, None] * model.risky_probs[None, None, :, None])
            * model.transition[None, :, None, :]).permute(3, 0, 1, 2)
    x = mass.reshape(-1)[push.source] * push.coef
    step = 1
    for mask in push.masks:
        x[:-step] += torch.where(mask, x[step:], x.new_zeros(()))
        step *= 2
    out = torch.where(push.filled, x[push.first], x.new_zeros(()))
    return out.reshape(n_next, d_size).T


def stationary_portfolio_wealth(policy: PortfolioPolicy, r_free, wage,
                                model: PortfolioModel, tol: float = 1e-10,
                                max_iter: int = 20000, init_dist=None,
                                accel_every: int = 64):
    """The stationary joint distribution over (end-of-period assets, labor
    state), [D, N], by the shared accelerated iteration (one lane of
    ``household.accelerated_distribution_fixed_point``; ``accel_every=0``
    disables extrapolation); ``init_dist`` warm-starts it.  Returns
    (dist, n_iter, final_diff, status)."""
    trans = portfolio_wealth_transition(policy, r_free, wage, model)
    push = portfolio_push(trans)
    dist0 = initial_distribution(model) if init_dist is None else init_dist
    dist, it, diff, status = accelerated_distribution_fixed_point(
        lambda d: _push_forward_portfolio(d[0], trans, model, push)[None],
        dist0[None], tol, max_iter, accel_every)
    return dist[0], it[0], diff[0], status[0]


class PortfolioEquilibrium(NamedTuple):
    """The JAX package's fields, then the port's counters: the EGM and
    distribution steps of every household solve of the equilibrium (the
    trips and the re-solve at r*) and the worst status of the bisection
    and the inner loops."""

    r_star: torch.Tensor        # net expected return on capital
    r_free: torch.Tensor        # net safe rate (r_star - premium)
    wage: torch.Tensor
    capital: torch.Tensor       # E[omega a] = risky holdings = K
    total_assets: torch.Tensor  # E[a] (risky + safe holdings)
    risky_share_mean: torch.Tensor  # capital / total_assets
    labor: torch.Tensor
    saving_rate: torch.Tensor   # delta K / Y
    excess: torch.Tensor        # K - K_demand at r_star
    policy: PortfolioPolicy
    distribution: torch.Tensor  # [D, N]
    bisect_iters: torch.Tensor
    egm_iters: int = 0
    dist_iters: int = 0
    status: torch.Tensor = None


def _portfolio_supply(r, base: PortfolioModel, eps_draws, premium, disc_fac,
                      crra, cap_share, depr_fac, prod, egm_tol, dist_tol,
                      init_policy=None, init_dist=None):
    """The household side at candidate rate r: (K supply, total assets,
    policy, distribution, model at r, gross R_f, wage, K/L, EGM steps,
    distribution steps, status).  ``init_policy``/``init_dist`` warm-start
    the inner fixed points from the previous midpoint."""
    from . import firm

    r_free = 1.0 + r - premium
    model = base._replace(risky_returns=(1.0 + r) * eps_draws)
    k_to_l = firm.k_to_l_from_r(r, cap_share, depr_fac, prod)
    wage = firm.wage_rate(k_to_l, cap_share, prod)
    policy, n_egm, _ = solve_portfolio_household(
        r_free, wage, model, disc_fac, crra, tol=egm_tol,
        init_policy=init_policy)
    dist, n_dist, _, status = stationary_portfolio_wealth(
        policy, r_free, wage, model, tol=dist_tol, init_dist=init_dist)
    omega = _share_on_dist_grid(policy, model)
    x = model.dist_grid[:, None]
    total, risky = pairwise_sum(torch.stack([(dist * x).reshape(-1),
                                             (dist * omega * x).reshape(-1)]))
    return (risky, total, policy, dist, model, r_free, wage, k_to_l, n_egm,
            n_dist, status)


def solve_portfolio_equilibrium(model: PortfolioModel, disc_fac, crra,
                                cap_share, depr_fac, prod=1.0,
                                premium: float = 0.04,
                                r_tol: float | None = None,
                                max_bisect: int = 40,
                                egm_tol: float | None = None,
                                dist_tol: float | None = None
                                ) -> PortfolioEquilibrium:
    """Bisect the expected capital return r until the capital market
    clears: household risky holdings E[omega a] = firm demand K(r).

    ``model.risky_returns`` are read as mean-one multiplicative return
    shocks scaled to (1 + r) at each candidate rate; build the model with
    ``risky_mean=1.0``.  The bracket is economic: supply diverges at
    (1 - beta)/beta, and the safe rate must stay above -delta, so the
    premium lifts the lower end; an empty bracket raises ``ValueError``.
    Each trip warm-starts from the previous midpoint's policy and
    distribution; r* is re-solved cold.  The trips run through the port's
    one bisection loop (``equilibrium._bisect``): a non-finite excess
    stops the lane NONFINITE, where the JAX package's ``where(ex > 0,
    ...)`` moves the low end and bisects on."""
    from . import firm
    from .equilibrium import _bisect

    dtype = model.a_grid.dtype
    f64 = dtype == torch.float64
    if r_tol is None:
        r_tol = 1e-9 if f64 else 1e-5
    if egm_tol is None:
        egm_tol = 1e-6 if f64 else 1e-5
    if dist_tol is None:
        dist_tol = 1e-10 if f64 else 1e-8
    _require_dist_grid(model)
    eps_draws = model.risky_returns / torch.sum(model.risky_returns
                                                * model.risky_probs)
    labor = torch.sum(model.labor_stationary * model.labor_levels)
    # The bracket can invert here (e.g. beta=0.99, delta=0.025,
    # premium=0.04): fail loudly rather than return a non-equilibrium.
    r_hi_f = 1.0 / disc_fac - 1.0 - 1e-4
    r_lo_f = -depr_fac + premium + 1e-3
    if r_lo_f >= r_hi_f:
        raise ValueError(
            f"empty bisection bracket [{r_lo_f:.4f}, {r_hi_f:.4f}]: "
            f"premium={premium} is too large relative to the discount "
            f"rate bound (1-beta)/beta={1.0 / disc_fac - 1.0:.4f} and "
            f"depreciation {depr_fac}")
    like = model.a_grid.new_zeros(1)
    args = (model, eps_draws, premium, disc_fac, crra, cap_share, depr_fac,
            prod, egm_tol, dist_tol)
    carry = dict(policy=initial_portfolio_policy(model),
                 dist=initial_distribution(model), egm=0, dist_steps=0,
                 status=torch.zeros((), dtype=torch.int32,
                                    device=like.device))

    def excess(mid, lanes):
        (risky, _, pol, dst, *_, k_to_l, n_egm, n_dist,
         status) = _portfolio_supply(mid[0], *args,
                                     init_policy=carry["policy"],
                                     init_dist=carry["dist"])
        carry.update(policy=pol, dist=dst, egm=carry["egm"] + n_egm,
                     dist_steps=carry["dist_steps"] + n_dist,
                     status=combine_status(carry["status"], status))
        return (risky - k_to_l * labor).reshape(1)

    r_star, iters, bisect_status = _bisect(
        excess, torch.full_like(like, r_lo_f), torch.full_like(like, r_hi_f),
        r_tol, max_bisect)
    r_star = r_star[0]
    (risky, total, policy, dist, _, r_free, wage, k_to_l, n_egm, n_dist,
     status) = _portfolio_supply(r_star, *args)
    demand = k_to_l * labor
    output = prod * risky ** cap_share * labor ** (1.0 - cap_share)
    return PortfolioEquilibrium(
        r_star=r_star, r_free=r_free - 1.0, wage=wage, capital=risky,
        total_assets=total, risky_share_mean=risky / total, labor=labor,
        saving_rate=depr_fac * risky / output, excess=risky - demand,
        policy=policy, distribution=dist, bisect_iters=iters[0],
        egm_iters=carry["egm"] + n_egm,
        dist_iters=int(carry["dist_steps"]) + int(n_dist),
        status=combine_status(bisect_status[0], carry["status"], status))
