"""Simulators of the Krusell-Smith path (port of
``aiyagari_hark_tpu/models/simulate.py``): the aggregate Markov chain,
the Monte-Carlo agent panel and the deterministic wealth histogram.

Timing follows HARK's ``Market.make_history`` (sow -> cultivate -> reap
-> mill -> store): agents act at period t on the prices milled at t-1;
the mill at t consumes ``mrkv_hist[t]`` and the just-saved assets.

Each history is a Python loop over periods, every period a fixed
sequence of small device ops with no host sync inside the loop: indices
stay device tensors, the per-period aggregates are stacked once at the
end.  Random draws cannot match ``jax.random``: they come from a
``torch.Generator`` on the device, seeded by the caller, all of a
history's uniforms drawn in one call before its loop.  A categorical
draw is an inverse CDF (the count of the row's cumulative sums at or
below a uniform).  What does carry over from the JAX package is every
deterministic count: the exact-count employment draw moves ``round(n *
p)`` agents, so a panel's ``urate`` history equals JAX's for the same
aggregate chain.

The histogram's savings lottery is a scatter; ``index_add_`` on the card
adds with float atomics in an order that changes from run to run.  Here
each (labor state, employment) column's shares go through one batched
product with a one-hot target matrix of fixed shape ``[D, D]`` (the
left-neighbour shares, then the right-neighbour shares shifted one node
up and added last, as in the JAX scatter), so two runs on one device
give the same bits.  At fixed prices (the slope-pinned engine) a
period's savings and lottery depend on the previous aggregate state
alone and are computed once per state, before the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.interp import eval_policy_columns, locate_in_grid, m_bracket
from . import firm
from .ks_model import KSCalibration, KSPolicy


def _pick(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table.reshape(-1)[idx]`` for an int64 device index of any shape
    (0-d included), without a host sync."""
    return table.reshape(-1).index_select(0, idx.reshape(-1)).reshape(
        idx.shape)


def _index(x, device) -> torch.Tensor:
    """An int or int tensor as an int64 tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def simulate_markov_history(transition: torch.Tensor, init_state: int,
                            length: int,
                            generator: torch.Generator) -> torch.Tensor:
    """The aggregate Bad/Good chain (``make_Mrkv_history``,
    ``Aiyagari_Support.py:1793-1805``): ``hist[0] = init_state``, then one
    inverse-CDF draw per period, int64 [length] on ``transition``'s
    device.  No loop over periods: each draw is a map state -> next state
    (a row per state), and the prefix compositions of those maps come
    from a doubling scan of log2(length) gathers."""
    dev = transition.device
    steps = max(length - 1, 0)
    u = torch.rand(steps, generator=generator, dtype=torch.float64,
                   device=dev)
    cdf = torch.cumsum(transition.to(torch.float64), dim=1)[:, :-1]
    maps = (cdf[None, :, :] <= u[:, None, None]).sum(-1)     # [steps, K]
    d = 1
    while d < steps:
        nxt = maps.clone()
        nxt[d:] = torch.gather(maps[d:], 1, maps[:-d])
        maps = nxt
        d *= 2
    init = torch.full((1,), int(init_state), dtype=torch.int64, device=dev)
    return torch.cat([init, maps[:, int(init_state)]])[:length]


class PanelState(NamedTuple):
    assets: torch.Tensor       # [Nag] end-of-period assets
    labor_state: torch.Tensor  # [Nag] int64 labor-supply state
    employed: torch.Tensor     # [Nag] bool
    M_now: torch.Tensor        # aggregate resources agents see next period
    R_now: torch.Tensor
    W_now: torch.Tensor
    mrkv: torch.Tensor         # aggregate state agents see next period (int64)


class PanelHistory(NamedTuple):
    """The economy's ``track_vars`` (``Aiyagari_Support.py:1587``)."""

    mrkv: torch.Tensor    # [T] aggregate state consumed by the mill at t
    A_prev: torch.Tensor  # [T] mean end-of-period assets at t
    M_now: torch.Tensor   # [T] aggregate resources computed by the mill at t
    urate: torch.Tensor   # [T] realized unemployment rate at t


def initial_panel(cal: KSCalibration, agent_count: int, mrkv_init,
                  generator: torch.Generator) -> PanelState:
    """Birth the panel at the steady state (``sim_birth``,
    ``Aiyagari_Support.py:1173-1214``): assets at KSS, labor states spread
    evenly then shuffled, employment at the initial state's unemployment
    rate (rounded count, shuffled)."""
    dev, dt = cal.a_grid.device, cal.a_grid.dtype
    n = cal.labor_levels.shape[0]
    z0 = _index(mrkv_init, dev)
    ls = torch.arange(agent_count, device=dev) % n
    ls = ls[torch.randperm(agent_count, generator=generator, device=dev)]
    urate = _pick(cal.urate_by_agg, z0)
    unemp_n = torch.round(urate * agent_count).to(torch.int64)
    emp = torch.arange(agent_count, device=dev) >= unemp_n
    emp = emp[torch.randperm(agent_count, generator=generator, device=dev)]
    ss = cal.steady_state
    return PanelState(
        assets=torch.full((agent_count,), float(ss.K), dtype=dt, device=dev),
        labor_state=ls, employed=emp, M_now=ss.M.to(dt), R_now=ss.R.to(dt),
        W_now=ss.W.to(dt), mrkv=z0)


def _mill(cal: KSCalibration, A, prod, agg_l):
    """R, W and M from aggregate capital ``A``, productivity ``prod`` and
    aggregate labor ``agg_l``: the one formula of ``mill_aggregates`` and
    the period loops."""
    k_to_l = A / agg_l
    R = firm.interest_factor(k_to_l, cal.cap_share, cal.depr_fac, prod)
    W = firm.wage_rate(k_to_l, cal.cap_share, prod)
    return R, W, R * A + W * agg_l


def mill_aggregates(cal: KSCalibration, A, z):
    """The factor-pricing "mill" (``calc_R_and_W``,
    ``Aiyagari_Support.py:1839-1894``): aggregate capital ``A`` and
    aggregate state ``z`` (an int, or an int tensor of any shape on the
    device) -> (R, W, M).  Shared by the panel step, the histogram step
    and the den Haan forecast (the period loops read ``prod`` and
    ``agg_l`` of each period from ``_ChainTables``)."""
    z = _index(z, cal.a_grid.device)
    return _mill(cal, A, _pick(cal.prod_by_agg, z),
                 (1.0 - _pick(cal.urate_by_agg, z)) * cal.lbr_ind)


def _conditional_emp_probs(mrkv_prev, mrkv_now, cal: KSCalibration):
    """Employment switch probabilities conditional on the aggregate move
    (int tensors of any shape), from the 4x4 joint (BU, BE, GU, GE)
    matrix: ``P(emp'|emp, z->z') = M[2z+emp, 2z'+emp'] / P_agg[z, z']``.
    Shared by the exact-count panel draw and the histogram flow."""
    p_agg = _pick(cal.agg_transition, 2 * mrkv_prev + mrkv_now)
    p_u_to_e = _pick(cal.empl_transition,
                     (2 * mrkv_prev) * 4 + 2 * mrkv_now + 1) / p_agg
    p_e_to_u = _pick(cal.empl_transition,
                     (2 * mrkv_prev + 1) * 4 + 2 * mrkv_now) / p_agg
    return p_u_to_e, p_e_to_u


class _ChainTables(NamedTuple):
    """Everything a period needs that depends on the aggregate chain
    alone, for every period at once (built before the loop; a period
    reads row ``t``, a view)."""

    z_prev: torch.Tensor     # [T] the state agents saw (init's, then z_{t-1})
    s_off: torch.Tensor      # [T] 2 z_prev: the state index's aggregate part
    emp_mix: torch.Tensor    # [T, 2, 2] P(e' | e): rows e = (unemp, emp)
    emp_probs: torch.Tensor  # [T, 2] (p_e->u, p_u->e)
    prod: torch.Tensor       # [T] productivity at z_t
    agg_l: torch.Tensor      # [T] aggregate labor at z_t


def _chain_tables(cal: KSCalibration, mrkv_hist: torch.Tensor,
                  z0: torch.Tensor) -> _ChainTables:
    z_prev = torch.cat([z0.reshape(1), mrkv_hist[:-1]])
    p_ue, p_eu = _conditional_emp_probs(z_prev, mrkv_hist, cal)
    emp_mix = torch.stack([torch.stack([1.0 - p_ue, p_ue], -1),
                           torch.stack([p_eu, 1.0 - p_eu], -1)], -2)
    return _ChainTables(
        z_prev=z_prev, s_off=2 * z_prev, emp_mix=emp_mix,
        emp_probs=torch.stack([p_eu, p_ue], -1),
        prod=_pick(cal.prod_by_agg, mrkv_hist),
        agg_l=(1.0 - _pick(cal.urate_by_agg, mrkv_hist)) * cal.lbr_ind)


def _transition_employment_exact(u: torch.Tensor, u_late: torch.Tensor,
                                 employed: torch.Tensor,
                                 probs: torch.Tensor, dtype):
    """Exact-count employment transitions: ``round(n_emp p_e->u)`` of the
    employed lose their job and ``round(n_unemp p_u->e)`` of the
    unemployed find one (``probs`` = (p_e->u, p_u->e)), the counts staying
    device integers; which agents switch is a uniform choice by rank of
    ``u`` [Nag] (float64) within each group, as the JAX package's double
    argsort ranks them.  One stable double argsort ranks both groups: the
    key puts every employed agent (by ``u``) before every unemployed one
    (by ``u + 2``).  So the employed hold ranks ``[0, n_emp)``: the first
    ``n_fire`` of them are fired, and the first ``n_hire`` unemployed,
    ranks ``[n_emp, n_emp + n_hire)``, hired; the employed after the move
    are exactly the ranks in ``[n_fire, n_emp + n_hire)``.  ``u_late`` is
    ``u + 2``."""
    n_emp = torch.sum(employed)
    counts = torch.stack([n_emp, employed.shape[0] - n_emp])
    n_fire, n_hire = torch.round(counts.to(dtype) * probs).to(torch.int64)
    key = torch.where(employed, u, u_late)
    rank = torch.argsort(torch.argsort(key, stable=True), stable=True)
    return (rank >= n_fire) & (rank < n_emp + n_hire)


def simulate_panel(policy: KSPolicy, cal: KSCalibration,
                   mrkv_hist: torch.Tensor, init: PanelState,
                   generator: torch.Generator):
    """Run the full panel history (``act_T`` periods; the reference's
    period, SURVEY.md §3.3): labor and employment shocks -> market
    resources -> consumption by the state-indexed policy -> savings ->
    mill (prices from mean assets and ``mrkv_hist[t]``).  Every uniform
    of the history is drawn from ``generator`` before the loop.  Returns
    ``(PanelHistory, final PanelState)``.  (The JAX package can also shard
    the agents over a mesh axis; the port runs one device.)"""
    dev, dt = cal.a_grid.device, cal.a_grid.dtype
    mrkv_hist = mrkv_hist.to(device=dev, dtype=torch.int64)
    T = mrkv_hist.shape[0]
    nag = init.assets.shape[0]
    u_labor = torch.rand((T, nag, 1), generator=generator,
                         dtype=torch.float64, device=dev)
    u_emp = torch.rand((T, nag), generator=generator, dtype=torch.float64,
                       device=dev)
    u_emp_late = u_emp + 2.0
    cdf = torch.cumsum(cal.tauchen_transition.to(torch.float64),
                       dim=1)[:, :-1]                        # [N, N-1]
    tab = _chain_tables(cal, mrkv_hist, _index(init.mrkv, dev))
    state = init
    A_list, M_list, U_list = [], [], []
    for t in range(T):
        # shocks (get_shocks, :1217-1256): the labor draw by inverse CDF,
        # the employment move by exact counts
        ls_new = (cdf[state.labor_state] <= u_labor[t]).sum(-1)
        emp_new = _transition_employment_exact(
            u_emp[t], u_emp_late[t], state.employed, tab.emp_probs[t], dt)
        eff_labor = cal.labor_levels[ls_new]
        if cal.ks_employment:
            eff_labor = eff_labor * emp_new
        # states (get_states, :1259-1283)
        m = state.R_now * state.assets + state.W_now * eff_labor
        # controls (get_controls, :1286-1409): state 4*ls + 2*z + emp
        s_idx = 4 * ls_new + tab.s_off[t] + emp_new
        cols, w = m_bracket(state.M_now, cal.m_grid)
        c = eval_policy_columns(m, s_idx, cols, w, policy.m_knots,
                                policy.c_knots)
        # poststates (get_poststates, :1411-1415)
        a_new = m - c
        # mill (calc_R_and_W, :1839-1894) consuming mrkv_hist[t]; sum / n,
        # as jnp.mean divides (torch.mean multiplies by 1/n)
        A_prev = torch.sum(a_new) / nag
        urate_real = 1.0 - torch.sum(emp_new.to(dt)) / nag
        R_new, W_new, M_new = _mill(cal, A_prev, tab.prod[t], tab.agg_l[t])
        A_list.append(A_prev)
        M_list.append(M_new)
        U_list.append(urate_real)
        state = PanelState(assets=a_new, labor_state=ls_new,
                           employed=emp_new, M_now=M_new, R_now=R_new,
                           W_now=W_new, mrkv=mrkv_hist[t])
    hist = PanelHistory(mrkv=mrkv_hist, A_prev=torch.stack(A_list),
                        M_now=torch.stack(M_list), urate=torch.stack(U_list))
    return hist, state


# --------------------------------------------------------------------------
# The deterministic histogram simulator: push a wealth histogram through
# the policy and the transition operator instead of sampling a panel.
# Same per-period timing and mill as ``simulate_panel``, no sampling noise.
# --------------------------------------------------------------------------


class DistPanelState(NamedTuple):
    """Histogram analog of ``PanelState``: mass over (end-of-period assets,
    labor state, employment status)."""

    dist: torch.Tensor        # [D, N, 2]
    M_now: torch.Tensor
    R_now: torch.Tensor
    W_now: torch.Tensor
    mrkv: torch.Tensor        # int64


def make_sim_dist_grid(cal: KSCalibration, dist_count: int = 500,
                       top_factor: float = 2.0) -> torch.Tensor:
    """Histogram support: 0 (the borrowing limit), then an exp-mult grid
    up to ``top_factor`` times the policy grid's top."""
    from ..ops.grids import make_grid_exp_mult

    inner = make_grid_exp_mult(1e-3, top_factor * float(cal.a_grid[-1]),
                               dist_count - 1, 2, dtype=cal.a_grid.dtype,
                               device=cal.a_grid.device)
    return torch.cat([torch.zeros((1,), dtype=inner.dtype,
                                  device=inner.device), inner])


def initial_distribution_panel(cal: KSCalibration, dist_grid: torch.Tensor,
                               mrkv_init, k0=None) -> DistPanelState:
    """Histogram analog of ``initial_panel``: all mass at capital ``k0``
    (default: the steady state; a two-point lottery onto the grid), labor
    states uniform, employment at the initial state's unemployment rate,
    prices milled from ``k0``."""
    dev, dt = dist_grid.device, dist_grid.dtype
    n = cal.labor_levels.shape[0]
    d_size = dist_grid.shape[0]
    z0 = _index(mrkv_init, dev)
    k0 = (cal.steady_state.K if k0 is None
          else torch.as_tensor(k0, device=dev)).to(dt)
    urate = _pick(cal.urate_by_agg, z0)
    r0, w0, m0 = mill_aggregates(cal, k0, z0)
    idx, w = locate_in_grid(k0.reshape(1), dist_grid)
    nodes = torch.arange(d_size, device=dev)
    asset_col = (torch.where(nodes == idx, 1.0 - w, 0.0)
                 + torch.where(nodes == idx + 1, w, 0.0))
    emp_w = torch.stack([urate, 1.0 - urate]).to(dt)
    dist = asset_col[:, None, None] * (1.0 / n) * emp_w[None, None, :]
    dist = dist.expand(d_size, n, 2).contiguous()
    return DistPanelState(dist=dist, M_now=m0.to(dt), R_now=r0.to(dt),
                          W_now=w0.to(dt), mrkv=z0)


def stack_states(states) -> DistPanelState:
    """Stack histogram states on a leading fan axis ``[F, ...]``."""
    return DistPanelState(*(torch.stack(f) for f in zip(*states)))


def unstack_state(state: DistPanelState, i: int) -> DistPanelState:
    """Member ``i`` of a fan-stacked state."""
    return DistPanelState(*(f[i] for f in state))


def initial_distribution_fan(cal: KSCalibration, dist_grid: torch.Tensor,
                             mrkv_init, fan: int,
                             spread: float = 0.75) -> DistPanelState:
    """A fan of ``fan`` histogram initial states, initial capital spread
    geometrically over ``[spread, 1/spread] x KSS``, stacked on a leading
    axis.  With the aggregate shock switched off, one deterministic path
    sits at its fixed point after the transient and the ``log A on log
    M`` regression cannot identify the slope; the fan's transients trace
    the aggregate map through a neighbourhood of the fixed point."""
    factors = (np.geomspace(spread, 1.0 / spread, fan) if fan > 1
               else np.ones((1,)))
    K = cal.steady_state.K
    return stack_states([initial_distribution_panel(
        cal, dist_grid, mrkv_init, k0=float(f) * K) for f in factors])


def _savings_lottery(policy: KSPolicy, cal: KSCalibration,
                     dist_grid: torch.Tensor, R, W, cols, w, s_off,
                     eff: torch.Tensor, base_idx: torch.Tensor):
    """One period's savings and their lottery onto the histogram support,
    at prices (R, W), M-bracket ``(cols, w)`` and state offset ``s_off``:
    ``a'`` [D, N, 2], the one-hot target matrices ``[2N, D, D]`` (entry
    ``[c, idx[i, c], i]`` is 1, each written once by ``scatter_``) and the
    (left, right) weights ``[D, 2N, 2]`` of each source."""
    d_size = dist_grid.shape[0]
    m = R * dist_grid[:, None, None] + W * eff
    c = eval_policy_columns(m.reshape(-1), base_idx + s_off, cols, w,
                            policy.m_knots, policy.c_knots)
    a_new = torch.clamp(m - c.reshape(m.shape), dist_grid[0], dist_grid[-1])
    idx, w_lot = locate_in_grid(a_new, dist_grid)
    idx, w_lot = idx.reshape(d_size, -1), w_lot.reshape(d_size, -1)
    onehot = torch.zeros((idx.shape[1], d_size, d_size), dtype=m.dtype,
                         device=m.device).scatter_(1, idx.T[:, None, :], 1.0)
    return a_new, onehot, torch.stack([1.0 - w_lot, w_lot], dim=-1)


def _push_lottery(dist_le: torch.Tensor, onehot: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Scatter the masses ``dist_le`` [D, N, 2] by the lottery of
    ``_savings_lottery``: each column's left and right shares go through
    one product with its one-hot matrix (no atomics); the right shares,
    shifted one node up, are added last."""
    d_size = dist_le.shape[0]
    shares = dist_le.reshape(d_size, -1)[..., None] * weights   # [D, 2N, 2]
    parts = torch.bmm(onehot, shares.transpose(0, 1))           # [2N, D, 2]
    right = torch.nn.functional.pad(parts[:, :-1, 1], (1, 0))
    return (parts[:, :, 0] + right).T.reshape(dist_le.shape)


def simulate_distribution_history(policy: KSPolicy, cal: KSCalibration,
                                  mrkv_hist: torch.Tensor,
                                  dist_grid: torch.Tensor,
                                  init: DistPanelState | None = None,
                                  fixed_K=None):
    """Run the full history by pushing the histogram through each period:
    labor mixing (the Tauchen rows), the employment flows conditional on
    the aggregate move (expected mass instead of exact counts),
    consumption at state ``4 ls + 2 z_prev + e``, the same mill.
    Deterministic.  Returns ``(PanelHistory, final DistPanelState)``.

    ``fixed_K``: mill the prices from this capital stock instead of the
    realized ``A_prev``: the fixed-price relaxation of the slope-pinned
    secant (the simulated path is then the household supply curve
    A(r(K)); with realized-price feedback, truncation at the histogram's
    top stabilizes a pseudo-equilibrium above the 1/beta - 1 cap).
    ``history`` still records the realized ``A_prev``."""
    dev, dt = dist_grid.device, dist_grid.dtype
    mrkv_hist = mrkv_hist.to(device=dev, dtype=torch.int64)
    if init is None:
        init = initial_distribution_panel(cal, dist_grid, mrkv_hist[0])
    n = cal.labor_levels.shape[0]
    tab = _chain_tables(cal, mrkv_hist, _index(init.mrkv, dev))
    eff = cal.labor_levels[None, :, None].expand(1, n, 2)
    if cal.ks_employment:
        eff = eff * torch.tensor([0.0, 1.0], dtype=dt, device=dev)
    base_idx = (4 * torch.arange(n, device=dev)[:, None]
                + torch.arange(2, device=dev)[None, :]).expand(
        dist_grid.shape[0], n, 2).reshape(-1)
    if fixed_K is not None:
        # At fixed prices a period's prices, M-bracket, savings and lottery
        # depend on the previous aggregate state alone: one of each per
        # state, computed before the loop and picked by z_{t-1}.
        fixed_K = torch.as_tensor(fixed_K, device=dev)
        R2, W2, M2 = (x.to(dt) for x in mill_aggregates(
            cal, fixed_K, torch.arange(2, device=dev)))
        cols2, w2 = m_bracket(M2, cal.m_grid)
        by_state = [torch.stack(x) for x in zip(*(
            _savings_lottery(policy, cal, dist_grid, R2[z], W2[z],
                             cols2[z], w2[z], 2 * z, eff, base_idx)
            for z in range(2)))]
        init = init._replace(R_now=_pick(R2, init.mrkv),
                             W_now=_pick(W2, init.mrkv),
                             M_now=_pick(M2, init.mrkv))
        R_out, W_out, M_out = (_pick(x, mrkv_hist) for x in (R2, W2, M2))
    P = cal.tauchen_transition[None, :, :, None]
    state = init
    A_list, M_list, U_list = [], [], []
    for t in range(mrkv_hist.shape[0]):
        # labor transition (the panel's categorical draw -> a row mix)
        dist_l = (state.dist[:, :, None, :] * P).sum(1)
        # employment flows conditional on the aggregate move: each new
        # mass is the two-term sum of the JAX package's
        # ``unemp * (1 - p_ue) + emp * p_eu`` / ``emp * (1 - p_eu) +
        # unemp * p_ue``
        dist_le = (dist_l[..., :, None] * tab.emp_mix[t]).sum(-2)
        # savings at the panel's state index, and their lottery
        if fixed_K is None:
            cols, w = m_bracket(state.M_now, cal.m_grid)
            a_new, onehot, weights = _savings_lottery(
                policy, cal, dist_grid, state.R_now, state.W_now, cols, w,
                tab.s_off[t], eff, base_idx)
        else:
            a_new, onehot, weights = (x.index_select(0, tab.z_prev[t:t + 1])[0]
                                      for x in by_state)
        # aggregates (exact expectations, before the scatter)
        A_prev = torch.sum(dist_le * a_new)
        urate_real = torch.sum(dist_le[:, :, 0])
        new_dist = _push_lottery(dist_le, onehot, weights)
        if fixed_K is None:
            R_new, W_new, M_new = _mill(cal, A_prev, tab.prod[t],
                                        tab.agg_l[t])
        else:
            R_new, W_new, M_new = R_out[t], W_out[t], M_out[t]
        A_list.append(A_prev)
        M_list.append(M_new)
        U_list.append(urate_real)
        state = DistPanelState(dist=new_dist, M_now=M_new, R_now=R_new,
                               W_now=W_new, mrkv=mrkv_hist[t])
    hist = PanelHistory(mrkv=mrkv_hist, A_prev=torch.stack(A_list),
                        M_now=torch.stack(M_list), urate=torch.stack(U_list))
    return hist, state
