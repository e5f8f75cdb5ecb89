"""Household problem on the (asset x labor-state) space: the EGM step,
its infinite-horizon fixed point, and the stationary wealth distribution
(port of the reference and fused paths of
``aiyagari_hark_tpu/models/household.py``).

Math contract:
    vP'(a_i, s') = u'(c_next(R a_i + W l_{s'}))
    EndOfPrdvP(a_i, s) = beta * R * sum_{s'} P[s,s'] vP'(a_i, s')
    c = EndOfPrdvP^(-1/crra);  m = a + c;  prepend the constraint knot
iterated to the infinite-horizon fixed point.  A policy is a pair of knot
arrays [N, A+1]; on a compact grid the analytic tail appends two knots,
[N, A+3].

Batching: every function takes either one cell (the JAX layouts: knots
[N, A+1], distribution [D, N]) or a lane-batched one with a leading axis
``C`` on every field.  The two fixed points run through the CUDA kernel
wrappers of ``ops.kernels`` (their plain versions for CPU tensors); the
loops below are the accelerated iterations both share, written for a
lane axis with per-lane active masks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device, resolve_dtype
from ..ops.grids import build_asset_grids
from ..ops.interp import append_tail_knot, interp1d_rowwise, locate_in_grid
from ..ops.kernels import (egm_policy_grid, egm_step_lanes, fused_cell_grid,
                           lottery_gather, push_forward_lanes,
                           stationary_lottery_grid)
from ..ops.markov import (normalized_labor_states, stationary_distribution,
                          tauchen_labor_process)
from ..ops.utility import asymptotic_mpc
from ..solver_health import NONFINITE, classify_fixed_point_exit
from ..utils.config import resolve_grid, resolve_kernel

# The reference's borrowing-constraint knot value.
CONSTRAINT_EPS = 1e-7
# Stall window of the distribution loop (steps without a new best).
STALL_WINDOW = 512
# Cap on the Anderson/Aitken rate, so lam / (1 - lam) stays finite.
LAM_MAX = 0.995
# First tail segment's slope: kappa + TAIL_SLOPE_BLEND (s_local - kappa).
# Both pure endpoints are biased by concavity (the JAX package measured
# -0.65 bp of r* for kappa alone and +0.31 bp for the local slope at the
# worst golden cell); 3/4 centres the drift.
TAIL_SLOPE_BLEND = 0.75


class HouseholdPolicy(NamedTuple):
    """Consumption policy as data: per-state endogenous knots [N, A+1]."""

    m_knots: torch.Tensor
    c_knots: torch.Tensor


class SimpleModel(NamedTuple):
    """Static calibration arrays for the household problem."""

    a_grid: torch.Tensor            # [A] end-of-period asset grid
    labor_levels: torch.Tensor      # [N] normalized labor supply per state
    transition: torch.Tensor        # [N, N] labor-state Markov matrix
    labor_stationary: torch.Tensor  # [N] stationary labor distribution
    dist_grid: torch.Tensor         # [D] wealth-histogram support
    borrow_limit: torch.Tensor      # scalar b <= 0: a >= b each period


class WealthTransition(NamedTuple):
    """Young-method lottery: where each (wealth gridpoint, state) cell's
    savings land on the histogram support."""

    idx: torch.Tensor     # [D, N] left-neighbour index into dist_grid
    weight: torch.Tensor  # [D, N] mass share on the right neighbour
    a_next: torch.Tensor  # [D, N] savings policy on the distribution grid


_LADDER = ("the coarse-to-fine grid ladder is not ported yet: ROADMAP "
           "Queue 1 item 7 (grid compaction); compact grids run only "
           "under kernel='fused'")


def check_policies(precision="reference", grid="reference",
                   kernel="reference", state="replicated") -> None:
    """Raise for any solver policy the port does not run: an unknown grid
    or kernel name raises ``ValueError``; a policy not ported yet raises
    ``NotImplementedError`` naming the ROADMAP item that will port it.
    ``kernel`` is "reference" or "fused"; a compact ``grid`` runs only
    under ``kernel="fused"`` (elsewhere the JAX package runs the grid
    ladder)."""
    gspec, kspec = resolve_grid(grid), resolve_kernel(kernel)
    if precision != "reference":
        rung = (" and, under kernel='fused', item 8 (bf16 descent rung)"
                if kspec.fused else "")
        raise NotImplementedError(
            f"precision={precision!r} is not ported yet: ROADMAP Queue 1 "
            f"item 6 (precision ladder){rung}; only 'reference' runs")
    if state != "replicated":
        raise NotImplementedError(
            f"state={state!r} is not ported yet: ROADMAP Queue 1 item 13 "
            f"(sharding); only 'replicated' runs")
    if gspec.compact and not kspec.fused:
        raise NotImplementedError(f"grid={grid!r} under kernel={kernel!r}: "
                                  f"{_LADDER}")


# ---------------------------------------------------------------------------
# Model build and lanes.
# ---------------------------------------------------------------------------

def build_simple_model(labor_states: int = 7, labor_ar: float = 0.6,
                       labor_sd: float = 0.2, labor_bound: float = 3.0,
                       a_min: float = 0.001, a_max: float = 50.0,
                       a_count: int = 32, a_nest_fac: int = 2,
                       dist_count: int = 500, borrow_limit: float = 0.0,
                       grid="reference", grid_tail: str = "analytic",
                       dtype=None, device=None) -> SimpleModel:
    """Assemble one cell's calibration arrays on ``device`` (default: the
    card) in ``dtype`` (default float32).  ``grid``/``grid_tail`` pick the
    grids (``ops.grids.build_asset_grids``): under a compact ``grid`` the
    solver closes the top with the analytic tail ("analytic") or the
    grid carries sparse tail anchors ("anchors")."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    a_grid, dist_grid, _ = build_asset_grids(
        grid, a_min, a_max, a_count, a_nest_fac, dist_count,
        borrow_limit=borrow_limit, dtype=dt, device=dev, tail=grid_tail)
    tauchen = tauchen_labor_process(labor_states, labor_ar, labor_sd,
                                    bound=labor_bound, dtype=dt, device=dev)
    levels = normalized_labor_states(tauchen.grid)
    pi = stationary_distribution(tauchen.transition)
    return SimpleModel(a_grid=a_grid, labor_levels=levels,
                       transition=tauchen.transition, labor_stationary=pi,
                       dist_grid=dist_grid,
                       borrow_limit=torch.tensor(borrow_limit, dtype=dt,
                                                 device=dev))


def is_batched(model: SimpleModel) -> bool:
    return model.a_grid.dim() == 2


def stack_models(models) -> SimpleModel:
    """Lane-batched model from one-cell models of equal shapes (a compact
    grid's sizes depend on the grid settings only, not on the labor
    process, so the cells of one sweep stack)."""
    models = list(models)
    shapes = {tuple(tuple(f.shape) for f in m) for m in models}
    if len(shapes) > 1:
        raise ValueError(f"stack_models: the cells' shapes differ: "
                         f"{sorted(shapes)}")
    return SimpleModel(*(torch.stack(f) for f in zip(*models)))


def select_lanes(tree, lanes: torch.Tensor):
    """The given lanes of a lane-batched NamedTuple of tensors."""
    return type(tree)(*(f[lanes] for f in tree))


def _lift(tree):
    return type(tree)(*(f.unsqueeze(0) for f in tree))


def _drop(tree):
    return type(tree)(*(f.squeeze(0) for f in tree))


def _lift_scalar(x):
    return x.reshape(1) if isinstance(x, torch.Tensor) else x


def _lane_scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A per-lane scalar as a [C] tensor in ``like``'s dtype and device."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x.expand(like.shape[0]) if x.dim() == 0 else x


def initial_policy(model: SimpleModel,
                   analytic_tail: bool = False) -> HouseholdPolicy:
    """Terminal guess c(m) = m - b (consume everything above the debt
    limit) as knots of slope 1.  ``analytic_tail`` appends the two tail
    knots (slope 1), so the guess has the compact policy's shape
    [N, A+3]."""
    n = model.labor_levels.shape[-1]
    a = model.a_grid
    eps = torch.tensor(CONSTRAINT_EPS, dtype=a.dtype, device=a.device)
    b = model.borrow_limit
    m_row = torch.cat([(b + eps)[..., None], a + eps], dim=-1)
    m_knots = m_row[..., None, :].expand(
        *m_row.shape[:-1], n, m_row.shape[-1]).clone()
    c_knots = m_knots - b[..., None, None]
    if analytic_tail:
        one = torch.ones((), dtype=a.dtype, device=a.device)
        for _ in range(2):
            m_knots, c_knots = append_tail_knot(m_knots, c_knots, one)
    return HouseholdPolicy(m_knots=m_knots, c_knots=c_knots)


def initial_distribution(model: SimpleModel) -> torch.Tensor:
    """Cold-start histogram: all mass at the borrowing limit, labor states
    at their ergodic weights."""
    g = model.dist_grid
    n = model.labor_stationary.shape[-1]
    d = torch.zeros(*g.shape, n, dtype=g.dtype, device=g.device)
    d[..., 0, :] = model.labor_stationary
    return d


def _scalars(R, W, model: SimpleModel, disc_fac, crra) -> torch.Tensor:
    """[C, 5] packed (R, W, beta, crra, borrow_limit) of a batched model."""
    like = model.borrow_limit
    return torch.stack([_lane_scalar(v, like)
                        for v in (R, W, disc_fac, crra, model.borrow_limit)],
                       dim=1)


# ---------------------------------------------------------------------------
# The analytic tail of a compact-grid policy.
# ---------------------------------------------------------------------------

def perfect_foresight_human_wealth(R, W, labor_levels: torch.Tensor,
                                   transition: torch.Tensor) -> torch.Tensor:
    """Per-state present value of future labor income, ``h = P (y + h) /
    R`` with ``y = W l``: the intercept of the consumption asymptote
    ``c = kappa (m + h)``.  ``R`` is floored at 1 + 1e-3 (a bisection
    probe at a negative rate has no convergent value; the tail then only
    needs a finite surrogate).  ``labor_levels`` [..., N], ``transition``
    [..., N, N], ``R``/``W`` scalars or [...]."""
    dt, dev = labor_levels.dtype, labor_levels.device
    R = torch.as_tensor(R, dtype=dt, device=dev)
    W = torch.as_tensor(W, dtype=dt, device=dev)
    y = W[..., None] * labor_levels
    R_eff = torch.clamp_min(R, 1.0 + 1e-3)[..., None]
    n = labor_levels.shape[-1]
    rhs = torch.matmul(transition, y[..., None])[..., 0] / R_eff
    eye = torch.eye(n, dtype=dt, device=dev)
    return torch.linalg.solve(eye - transition / R_eff[..., None], rhs)


def _append_analytic_tail_knots(m_knots, c_knots, kappa, h):
    """Close knots ``[..., N, A+1]`` with the two-knot analytic tail, given
    the raw asymptotic MPC ``kappa`` (scalar or [...]; clipped here to
    [1e-3, 0.999]) and the human wealth ``h`` [..., N].  The first knot
    lies one span (the knots' width, floored at 1) past the top, on the
    blended slope ``kappa + TAIL_SLOPE_BLEND (s_local - kappa)`` clipped
    to [kappa, 1] and capped by the asymptote ``kappa (m + h)``; the
    second one span further on slope ``kappa``, which governs
    extrapolation.  Returns ``[..., N, A+3]``.

    The slope guard is ``finfo(float64).tiny`` cast to the knots' dtype,
    as in the JAX package: in float32 that cast underflows to 0."""
    dt, dev = m_knots.dtype, m_knots.device
    tiny = torch.tensor(torch.finfo(torch.float64).tiny, dtype=dt,
                        device=dev)
    kappa = torch.clamp(torch.as_tensor(kappa, dtype=dt, device=dev), 1e-3,
                        0.999)[..., None]
    m_top = m_knots[..., -1]
    c_top = c_knots[..., -1]
    span = torch.clamp_min(m_top - m_knots[..., 0], 1.0)
    s_loc = ((c_knots[..., -1] - c_knots[..., -2])
             / torch.maximum(m_knots[..., -1] - m_knots[..., -2], tiny))
    s_bar = torch.minimum(
        torch.maximum(kappa + TAIL_SLOPE_BLEND * (s_loc - kappa), kappa),
        torch.ones((), dtype=dt, device=dev))
    m1 = m_top + span
    c1 = torch.minimum(c_top + s_bar * span, kappa * (m1 + h))
    c1 = torch.maximum(c1, c_top + kappa * span)   # monotone floor
    m2 = m1 + span
    c2 = c1 + kappa * span
    return (torch.cat([m_knots, m1[..., None], m2[..., None]], dim=-1),
            torch.cat([c_knots, c1[..., None], c2[..., None]], dim=-1))


def _append_analytic_tail(m_knots, c_knots, R, W, disc_fac, crra,
                          labor_levels, transition):
    """The analytic tail from the model: slope ``asymptotic_mpc(R, beta,
    crra)``, intercept ``perfect_foresight_human_wealth``."""
    return _append_analytic_tail_knots(
        m_knots, c_knots, asymptotic_mpc(R, disc_fac, crra),
        perfect_foresight_human_wealth(R, W, labor_levels, transition))


# ---------------------------------------------------------------------------
# Policy fixed point.
# ---------------------------------------------------------------------------

def egm_step(policy: HouseholdPolicy, R, W, model: SimpleModel, disc_fac,
             crra, analytic_tail: bool = False) -> HouseholdPolicy:
    """One EGM backward step (one cell, or every lane of a batch).
    ``analytic_tail`` closes the new knots with the analytic tail
    ([N, A+3]): the plain reference of the fused kernel's compact-grid
    step."""
    if not is_batched(model):
        return _drop(egm_step(_lift(policy), _lift_scalar(R),
                              _lift_scalar(W), _lift(model), disc_fac,
                              _lift_scalar(crra), analytic_tail))
    sc = _scalars(R, W, model, disc_fac, crra)
    m, c = egm_step_lanes(policy.m_knots, policy.c_knots, model.a_grid,
                          model.labor_levels, model.transition, sc)
    if analytic_tail:
        m, c = _append_analytic_tail(m, c, sc[:, 0], sc[:, 1], sc[:, 2],
                                     sc[:, 3], model.labor_levels,
                                     model.transition)
    return HouseholdPolicy(m, c)


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Per-lane sum of ``x`` [C, M] by a fixed pairwise tree: pad with
    zeros to a power of two, then halve by adding neighbours.  The CUDA
    kernels sum in the same tree (``csrc/common.cuh``), so the two engines
    round every partial sum alike."""
    m = x.shape[1]
    p = 1 << max(m - 1, 0).bit_length()
    if p > m:
        x = torch.cat([x, x.new_zeros(x.shape[0], p - m)], dim=1)
    while x.shape[1] > 1:
        x = x[:, 0::2] + x[:, 1::2]
    return x[:, 0]


def anderson_rate(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Per-lane Anderson(1)/Aitken rate ``<d2,d1> / max(<d1,d1>, tiny)``
    clipped to [0, LAM_MAX]; ``d1``/``d2`` are [C, M]."""
    tiny = torch.finfo(d2.dtype).tiny
    den = torch.clamp_min(pairwise_sum(d1 * d1), tiny)
    return torch.clamp(pairwise_sum(d2 * d1) / den, 0.0, LAM_MAX)


def _lane_max_abs(x: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(x).flatten(1), dim=1)


def accelerated_policy_fixed_point(step_fn, p0, tol: float, max_iter: int,
                                   accel_every: int = 32):
    """EGM fixed point with certified Anderson(1) acceleration, for every
    lane of a batch (fields of ``p0`` are [C, ...] knot arrays with
    ``m_knots`` first).

    Convergence is the sup-norm over all fields.  Every ``accel_every``
    steps one extrapolation along the dominant mode is applied to every
    field, rejected if it breaks the strict monotonicity of ``m_knots``
    or the positivity of another field.  The loop returns the last plain
    iterate its diff certifies.  A non-finite diff exits at once.  A lane
    whose loop has exited is frozen; all active lanes share one step
    counter, so the extrapolation cadence is decided on the host.
    Returns (policy, n_iter [C] int32, final_diff [C], status [C])."""
    fields = p0._fields
    C = p0[0].shape[0]
    dev, dt = p0[0].device, p0[0].dtype
    pol, prv, cert = p0, p0, p0
    diff = torch.full((C,), torch.finfo(dt).max, dtype=dt, device=dev)
    it = torch.zeros((C,), dtype=torch.int32, device=dev)
    finite = torch.ones((C,), dtype=torch.bool, device=dev)
    k = 0
    while True:
        active = (diff > tol) & (it < max_iter) & finite
        if not bool(active.any()):
            break
        new = step_fn(pol)
        d = _lane_max_abs(new[0] - pol[0])
        for f in range(1, len(fields)):
            d = torch.maximum(d, _lane_max_abs(new[f] - pol[f]))
        if accel_every > 0 and (k + 1) % accel_every == 0:
            d1 = torch.cat([(pol[f] - prv[f]).flatten(1)
                            for f in range(len(fields))], dim=1)
            d2 = torch.cat([(new[f] - pol[f]).flatten(1)
                            for f in range(len(fields))], dim=1)
            lam = anderson_rate(d1, d2)
            fac = lam / (1.0 - lam)
            ext = [new[f] + fac.reshape((C,) + (1,) * (new[f].dim() - 1))
                   * (new[f] - pol[f]) for f in range(len(fields))]
            ok = (torch.diff(ext[0], dim=-1) > 0).flatten(1).all(dim=1)
            for e in ext[1:]:
                ok = ok & (e > 0).flatten(1).all(dim=1)
            ok = ok & (d > tol)
            out = type(p0)(*(_where_lanes(ok, e, n)
                             for e, n in zip(ext, new)))
            nprv = new
        else:
            out, nprv = new, pol
        prv = type(p0)(*(_where_lanes(active, a, b)
                         for a, b in zip(nprv, prv)))
        pol = type(p0)(*(_where_lanes(active, a, b)
                         for a, b in zip(out, pol)))
        cert = type(p0)(*(_where_lanes(active, a, b)
                          for a, b in zip(new, cert)))
        diff = torch.where(active, d, diff)
        it = it + active.to(torch.int32)
        finite = torch.where(active, torch.isfinite(d), finite)
        k += 1
    return cert, it, diff, classify_fixed_point_exit(diff, tol, it,
                                                     max_iter)


def _where_lanes(mask: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


def solve_household(R, W, model: SimpleModel, disc_fac, crra,
                    tol: float = 1e-6, max_iter: int = 3000,
                    init_policy: HouseholdPolicy | None = None,
                    accel_every: int = 32, precision: str = "reference",
                    grid="reference", kernel="reference",
                    state="replicated"):
    """Infinite-horizon EGM fixed point through the ``egm_policy_grid``
    kernel (its plain version for CPU tensors): one cell, or every lane
    of a batch (``R``/``W``/``crra`` then scalars or [C]).  Returns
    (policy, n_iter, final_diff, status); the status is rebuilt from
    (n_iter, final_diff), exact because this loop has no stall exit.
    ``kernel="fused"`` runs the same kernel, as the JAX package runs its
    EGM kernel there; a compact ``grid`` would run the grid ladder, which
    is not ported."""
    check_policies(precision=precision, grid=grid, kernel=kernel,
                   state=state)
    if resolve_grid(grid).compact:
        raise NotImplementedError(f"solve_household(grid={grid!r}): "
                                  f"{_LADDER}")
    if not is_batched(model):
        p0 = None if init_policy is None else _lift(init_policy)
        pol, it, diff, status = solve_household(
            _lift_scalar(R), _lift_scalar(W), _lift(model), disc_fac,
            _lift_scalar(crra), tol, max_iter, p0, accel_every)
        return _drop(pol), it[0], diff[0], status[0]
    p0 = initial_policy(model) if init_policy is None else init_policy
    m, c, it, diff = egm_policy_grid(
        p0.m_knots, p0.c_knots, model.a_grid, model.labor_levels,
        model.transition, _scalars(R, W, model, disc_fac, crra), tol,
        max_iter, accel_every)
    return (HouseholdPolicy(m_knots=m, c_knots=c), it, diff,
            classify_fixed_point_exit(diff, tol, it, max_iter))


# ---------------------------------------------------------------------------
# Stationary distribution.
# ---------------------------------------------------------------------------

def wealth_transition(policy: HouseholdPolicy, R, W,
                      model: SimpleModel) -> WealthTransition:
    """Savings policy on the histogram support, split into Young lottery
    weights (one cell, or every lane of a batch)."""
    x = model.dist_grid
    if not is_batched(model):
        m = R * x[:, None] + W * model.labor_levels[None, :]      # [D, N]
        c = interp1d_rowwise(m.T, policy.m_knots, policy.c_knots).T
        a_next = torch.clamp(m - c, model.borrow_limit, x[-1])
        idx, w = locate_in_grid(a_next, x)
        return WealthTransition(idx=idx, weight=w, a_next=a_next)
    C, D = x.shape
    n = model.labor_levels.shape[1]
    R = _lane_scalar(R, x[:, 0])[:, None, None]
    W = _lane_scalar(W, x[:, 0])[:, None, None]
    m = R * x[:, :, None] + W * model.labor_levels[:, None, :]    # [C, D, N]
    c = interp1d_rowwise(m.transpose(1, 2), policy.m_knots,
                         policy.c_knots).transpose(1, 2)
    a_next = torch.clamp(m - c, model.borrow_limit[:, None, None],
                         x[:, -1, None, None])
    idx, w = locate_in_grid(a_next.transpose(1, 2),
                            x[:, None, :].expand(C, n, D))
    return WealthTransition(idx=idx.transpose(1, 2), weight=w.transpose(1, 2),
                            a_next=a_next)


def dense_wealth_operator(trans: WealthTransition,
                          d_size: int) -> torch.Tensor:
    """One cell's lottery as the dense per-state operator ``S [N, D, D]``
    (column d of ``S[n]`` carries source d's two-point lottery) -- the
    operator the TPU kernels iterate; here for tests."""
    n = trans.idx.shape[1]
    S = torch.zeros((n, d_size, d_size), dtype=trans.weight.dtype,
                    device=trans.weight.device)
    rows = torch.arange(n, device=S.device)[:, None]
    cols = torch.arange(d_size, device=S.device)[None, :]
    S.index_put_((rows.expand(n, d_size), trans.idx.T, cols.expand(n, d_size)),
                 1.0 - trans.weight.T, accumulate=True)
    S.index_put_((rows.expand(n, d_size), trans.idx.T + 1,
                  cols.expand(n, d_size)), trans.weight.T, accumulate=True)
    return S


def _push_forward(dist: torch.Tensor, trans: WealthTransition,
                  transition_matrix: torch.Tensor) -> torch.Tensor:
    """One cell's push-forward step: move the mass along the lottery,
    then mix labor states."""
    src, coef = lottery_gather(trans.idx[None], trans.weight[None])
    return push_forward_lanes(dist[None], src, coef,
                              transition_matrix[None])[0]


def distribution_loop(push, dist0: torch.Tensor, tol: float, max_iter: int,
                      accel_every: int = 64):
    """The accelerated push-forward iteration for every lane of a batch
    (``dist0`` [C, D, N]).  Returns (best_dist, n_iter [C] int32,
    best_diff [C], last_diff [C])."""
    C = dist0.shape[0]
    dev, dt = dist0.device, dist0.dtype
    big = torch.finfo(dt).max
    dist, prev, best_dist = dist0, dist0, dist0
    diff = torch.full((C,), big, dtype=dt, device=dev)
    best = diff.clone()
    it = torch.zeros((C,), dtype=torch.int32, device=dev)
    since = torch.zeros((C,), dtype=torch.int32, device=dev)
    finite = torch.ones((C,), dtype=torch.bool, device=dev)
    k = 0
    while True:
        active = ((diff > tol) & (it < max_iter) & (since < STALL_WINDOW)
                  & finite)
        if not bool(active.any()):
            break
        new = push(dist)
        d = _lane_max_abs(new - dist)
        if accel_every > 0 and (k + 1) % accel_every == 0:
            d2 = new - dist
            lam = anderson_rate((dist - prev).flatten(1), d2.flatten(1))
            ext = torch.clamp(new + (lam / (1.0 - lam))[:, None, None] * d2,
                              min=0.0)
            ext = ext / pairwise_sum(ext.flatten(1))[:, None, None]
            # a converged plain step exits now: carry the certified iterate
            out = _where_lanes(d <= tol, new, ext)
            nprev = new
        else:
            out, nprev = new, dist
        improved = d < best
        best_dist = _where_lanes(active & improved, new, best_dist)
        best = torch.where(active, torch.minimum(best, d), best)
        since = torch.where(active & improved, torch.zeros_like(since),
                            since + active.to(torch.int32))
        prev = _where_lanes(active, nprev, prev)
        dist = _where_lanes(active, out, dist)
        diff = torch.where(active, d, diff)
        it = it + active.to(torch.int32)
        finite = torch.where(active, torch.isfinite(d), finite)
        k += 1
    return best_dist, it, best, diff


def accelerated_distribution_fixed_point(push, dist0: torch.Tensor,
                                         tol: float, max_iter: int,
                                         accel_every: int = 64):
    """Iterate ``dist <- push(dist)`` to its fixed point for every lane,
    with an Aitken extrapolation every ``accel_every`` steps (clipped at
    0, renormalised), a 512-step stall exit, and the best certified
    iterate as the result.  Returns (dist, n_iter, best_diff, status):
    NONFINITE if the last step was non-finite, else the class of the
    best residual."""
    best_dist, it, best, last = distribution_loop(
        push, dist0, tol, max_iter, accel_every)
    status = torch.where(
        ~torch.isfinite(last),
        torch.full_like(it, NONFINITE),
        classify_fixed_point_exit(best, tol, it, max_iter))
    return best_dist, it, best, status


def stationary_wealth(policy: HouseholdPolicy, R, W, model: SimpleModel,
                      tol: float = 1e-11, max_iter: int = 20000,
                      init_dist=None, accel_every: int = 64,
                      precision: str = "reference", kernel="reference",
                      state="replicated"):
    """Stationary joint distribution over (wealth, labor state), [D, N]
    (or [C, D, N]), through the ``stationary_lottery_grid`` kernel (its
    plain version for CPU tensors), under ``kernel="fused"`` too.
    Returns (dist, n_iter, diff, status) with ``diff`` the best certified
    residual; the status is rebuilt from (n_iter, diff)."""
    check_policies(precision=precision, kernel=kernel, state=state)
    if not is_batched(model):
        d0 = None if init_dist is None else init_dist[None]
        dist, it, diff, status = stationary_wealth(
            _lift(policy), _lift_scalar(R), _lift_scalar(W), _lift(model),
            tol, max_iter, d0, accel_every)
        return dist[0], it[0], diff[0], status[0]
    trans = wealth_transition(policy, R, W, model)
    dist0 = initial_distribution(model) if init_dist is None else init_dist
    dist, it, diff = stationary_lottery_grid(
        trans.idx, trans.weight, model.transition, dist0, tol, max_iter,
        accel_every)
    return dist, it, diff, classify_fixed_point_exit(diff, tol, it,
                                                     max_iter)


# ---------------------------------------------------------------------------
# Both fixed points in one launch.
# ---------------------------------------------------------------------------

def fused_supply_phases(R, W, model: SimpleModel, disc_fac, crra,
                        egm_tol: float, dist_tol: float,
                        init_policy_knots: HouseholdPolicy | None = None,
                        init_dist=None, egm_max_iter: int = 3000,
                        egm_accel: int = 32, dist_max_iter: int = 20000,
                        dist_accel: int = 64, grid="reference"):
    """One supply evaluation's two inner fixed points (EGM policy, then
    the stationary distribution under it) as one launch of the
    ``fused_cell_grid`` kernel (its plain version for CPU tensors).  Under
    a compact ``grid`` the kernel closes every policy iterate with the
    analytic tail; the human-wealth intercept is computed here (an
    [N, N] solve that depends only on R, W and P).  One cell, or every
    lane of a batch.

    Returns ``(policy, dist, egm_iters, dist_iters, egm_status,
    dist_status)``, both statuses rebuilt from the kernel's (iters, diff)
    pairs."""
    if not is_batched(model):
        p0 = None if init_policy_knots is None else _lift(init_policy_knots)
        d0 = None if init_dist is None else init_dist[None]
        out = fused_supply_phases(
            _lift_scalar(R), _lift_scalar(W), _lift(model), disc_fac,
            _lift_scalar(crra), egm_tol, dist_tol, p0, d0, egm_max_iter,
            egm_accel, dist_max_iter, dist_accel, grid)
        return (_drop(out[0]),) + tuple(x[0] for x in out[1:])
    tail = resolve_grid(grid).compact
    p0 = (initial_policy(model, analytic_tail=tail)
          if init_policy_knots is None else init_policy_knots)
    d0 = initial_distribution(model) if init_dist is None else init_dist
    sc = _scalars(R, W, model, disc_fac, crra)
    if tail:
        h = perfect_foresight_human_wealth(sc[:, 0], sc[:, 1],
                                           model.labor_levels,
                                           model.transition)
    else:
        h = torch.zeros_like(model.labor_levels)
    m, c, dist, egm_it, egm_diff, dist_it, dist_diff = fused_cell_grid(
        p0.m_knots, p0.c_knots, model.a_grid, model.dist_grid,
        model.labor_levels, model.transition, sc, h, d0, egm_tol,
        egm_max_iter, egm_accel, dist_tol, dist_max_iter, dist_accel, tail)
    return (HouseholdPolicy(m_knots=m, c_knots=c), dist, egm_it, dist_it,
            classify_fixed_point_exit(egm_diff, egm_tol, egm_it,
                                      egm_max_iter),
            classify_fixed_point_exit(dist_diff, dist_tol, dist_it,
                                      dist_max_iter))


def aggregate_capital(dist: torch.Tensor, model: SimpleModel) -> torch.Tensor:
    """E[a] under the stationary distribution: household capital supply."""
    return torch.sum(dist * model.dist_grid[..., :, None], dim=(-2, -1))


def aggregate_labor(model: SimpleModel) -> torch.Tensor:
    """Effective labor supply E[l] under the stationary labor
    distribution."""
    return torch.sum(model.labor_stationary * model.labor_levels, dim=-1)
