"""The Krusell-Smith machinery of the notebook-parity path (port of
``aiyagari_hark_tpu/models/ks_model.py``).

The 4N-state space (2 aggregate x 2 employment x N labor states, ordered
``s = 4*labor + (2*agg + employed)`` as the reference's ``MrkvIndArray``),
the aggregate-resource grid M, the perceived saving rule ``A =
exp(intercept + slope log M)``, and the EGM step over ``[A, Mc, S]``.  A
policy is a pair of knot arrays ``[S, Mc, A+1]``.  The step is plain
PyTorch: the two-level interpolation of every (M-gridpoint, next state)
column at once, then one ``einsum`` against the composite transition
matrix in full precision (TF32 is off, ``device.resolve_device``).  The
fixed point runs the port's ``household.accelerated_policy_fixed_point``
(and, under ``precision="mixed"`` / ``"fast"``, its
``ladder_policy_fixed_point``) on a one-lane batch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..device import resolve_device, resolve_dtype
# the KS path keeps the reference grid: no grid policy
from ..ops.grids import make_asset_grid  # grid-ok
from ..ops.interp import interp1d_rowwise, m_bracket
from ..ops.markov import (
    aggregate_markov_matrix,
    employment_markov_matrix,
    full_idiosyncratic_matrix,
    normalized_labor_states,
    tauchen_labor_process,
)
from ..ops.utility import inverse_marginal_utility, marginal_utility
from ..utils.config import AgentConfig, EconomyConfig, resolve_precision
from . import firm
from .household import (
    CONSTRAINT_EPS,
    POLICY_DESCENT_TOL_SCALE,
    accelerated_policy_fixed_point,
    descent_dtype,
    descent_tolerance,
    ladder_policy_fixed_point,
)


class KSCalibration(NamedTuple):
    """Calibration arrays and scalars of the 4N-state model.  Columns
    indexed by the next state s' carry the aggregate objects:
    ``agg_of_state`` maps s' to 0/1 (Bad/Good), ``emp_of_state`` to 0/1."""

    a_grid: torch.Tensor           # [A]
    m_grid: torch.Tensor           # [Mc] aggregate resources, MSS * MgridBase
    labor_levels: torch.Tensor     # [N]
    ind_transition: torch.Tensor   # [S, S] composite idiosyncratic matrix
    tauchen_transition: torch.Tensor  # [N, N]
    empl_transition: torch.Tensor  # [4, 4]
    agg_transition: torch.Tensor   # [2, 2]
    agg_of_state: torch.Tensor     # [S] int64 0/1
    emp_of_state: torch.Tensor     # [S] int64 0/1
    labor_of_state: torch.Tensor   # [S] int64 0..N-1
    prod_by_agg: torch.Tensor      # [2] (ProdB, ProdG)
    urate_by_agg: torch.Tensor     # [2] (UrateB, UrateG)
    disc_fac: torch.Tensor
    crra: torch.Tensor
    lbr_ind: torch.Tensor
    cap_share: torch.Tensor
    depr_fac: torch.Tensor
    steady_state: firm.SteadyState
    ks_employment: bool            # True: the unemployed earn 0 (true KS);
    #                                False: the reference's Aiyagari mode
    #                                (the labor level regardless of
    #                                employment, Aiyagari_Support.py:991-1018)


class KSPolicy(NamedTuple):
    """Per-state consumption policy over (m, M): knots ``[S, Mc, A+1]``."""

    m_knots: torch.Tensor
    c_knots: torch.Tensor


class AFuncParams(NamedTuple):
    """The perceived log-linear aggregate saving rules, one per aggregate
    state (``AggregateSavingRule``, ``Aiyagari_Support.py:1991-2005``)."""

    intercept: torch.Tensor  # [2]
    slope: torch.Tensor      # [2]

    def __call__(self, M, agg_idx):
        return torch.exp(self.intercept[agg_idx]
                         + self.slope[agg_idx] * torch.log(M))


def build_ks_calibration(agent: AgentConfig, econ: EconomyConfig,
                         ks_employment: bool = False, dtype=None,
                         device=None) -> KSCalibration:
    """Assemble every calibration array from the two configs (the work the
    reference spreads across ``update`` / ``make_MrkvArray`` /
    ``get_economy_data``, ``Aiyagari_Support.py:1593-1791, 817-873``), on
    ``device`` (default: the card) in ``dtype`` (default float32)."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    n = agent.labor_states
    s_count = 4 * n
    a_grid = make_asset_grid(  # grid-ok: KS reference parity
        agent.a_min, agent.a_max, agent.a_count, agent.a_nest_fac,
        dtype=dt, device=dev)
    tauchen = tauchen_labor_process(n, econ.labor_ar, econ.labor_sd,
                                    bound=agent.labor_bound, dtype=dt,
                                    device=dev)
    levels = normalized_labor_states(tauchen.grid)
    empl = employment_markov_matrix(
        econ.dur_mean_b, econ.dur_mean_g, econ.spell_mean_b, econ.spell_mean_g,
        econ.urate_b, econ.urate_g, econ.rel_prob_bg, econ.rel_prob_gb,
        dtype=dt, device=dev)
    agg = aggregate_markov_matrix(econ.dur_mean_b, econ.dur_mean_g,
                                  dtype=dt, device=dev)
    ind = full_idiosyncratic_matrix(tauchen.transition, empl)
    ss = firm.perfect_foresight_steady_state(
        econ.disc_fac, econ.cap_share, econ.depr_fac, econ.lbr_ind,
        device=dev)
    m_grid = ss.M * torch.tensor(agent.mgrid_base, dtype=dt, device=dev)
    states = torch.arange(s_count, device=dev)
    k = states % 4

    def scalar(x):
        return torch.tensor(x, dtype=dt, device=dev)

    return KSCalibration(
        a_grid=a_grid, m_grid=m_grid, labor_levels=levels,
        ind_transition=ind, tauchen_transition=tauchen.transition,
        empl_transition=empl, agg_transition=agg,
        agg_of_state=k // 2, emp_of_state=k % 2, labor_of_state=states // 4,
        prod_by_agg=torch.tensor([econ.prod_b, econ.prod_g], dtype=dt,
                                 device=dev),
        urate_by_agg=torch.tensor([econ.urate_b, econ.urate_g], dtype=dt,
                                  device=dev),
        disc_fac=scalar(econ.disc_fac), crra=scalar(econ.crra),
        lbr_ind=scalar(econ.lbr_ind), cap_share=scalar(econ.cap_share),
        depr_fac=scalar(econ.depr_fac),
        steady_state=ss, ks_employment=bool(ks_employment))


def cast_calibration(cal: KSCalibration, dtype) -> KSCalibration:
    """``cal`` with every floating array in ``dtype`` (the steady state,
    float64 by construction, is kept)."""
    def cast(t):
        return (t.to(dtype) if isinstance(t, torch.Tensor)
                and t.is_floating_point() else t)

    return cal._replace(**{f: cast(getattr(cal, f)) for f in cal._fields
                           if f != "steady_state"})


class PrecomputedArrays(NamedTuple):
    """Everything the one-period solver consumes, a function of the AFunc
    parameters (the reference's ``precompute_arrays``,
    ``Aiyagari_Support.py:906-1037``)."""

    m_next: torch.Tensor   # [A, Mc, S'] idiosyncratic resources next period
    M_next: torch.Tensor   # [Mc, S'] aggregate resources next period
    R_next: torch.Tensor   # [Mc, S'] interest factor next period


def precompute(afunc: AFuncParams, cal: KSCalibration) -> PrecomputedArrays:
    """K' = AFunc[agg(s')](M); prices and resources next period per
    (M-gridpoint, next state)."""
    agg_idx = cal.agg_of_state                               # [S']
    K_next = afunc(cal.m_grid[:, None], agg_idx[None, :])    # [Mc, S']
    L_next = (1.0 - cal.urate_by_agg[agg_idx]) * cal.lbr_ind  # [S']
    Z_next = cal.prod_by_agg[agg_idx]                        # [S']
    k_to_l = K_next / L_next[None, :]
    R_next = firm.interest_factor(k_to_l, cal.cap_share, cal.depr_fac, Z_next)
    W_next = firm.wage_rate(k_to_l, cal.cap_share, Z_next)
    M_next = firm.aggregate_resources(K_next, L_next[None, :], cal.cap_share,
                                      cal.depr_fac, Z_next)
    # effective labor next period: the labor level of s', times the
    # employment indicator only in true-KS mode
    l_next = cal.labor_levels[cal.labor_of_state]            # [S']
    if cal.ks_employment:
        l_next = l_next * cal.emp_of_state
    m_next = (R_next[None, :, :] * cal.a_grid[:, None, None]
              + W_next[None, :, :] * l_next[None, None, :])
    return PrecomputedArrays(m_next=m_next, M_next=M_next, R_next=R_next)


def initial_ks_policy(cal: KSCalibration) -> KSPolicy:
    """c(m, M) = m per state, the reference's ``IdentityFunction`` terminal
    guess (``Aiyagari_Support.py:898``)."""
    s_count = cal.ind_transition.shape[0]
    mc = cal.m_grid.shape[0]
    eps = torch.full((1,), CONSTRAINT_EPS, dtype=cal.a_grid.dtype,
                     device=cal.a_grid.device)
    row = torch.cat([eps, cal.a_grid + eps])
    knots = row.expand(s_count, mc, -1).contiguous()
    return KSPolicy(m_knots=knots, c_knots=knots)


def egm_step_ks(policy: KSPolicy, pre: PrecomputedArrays,
                cal: KSCalibration) -> KSPolicy:
    """One EGM backward step over the ``[A, Mc, S]`` block (``solve_Aiyagari``,
    ``Aiyagari_Support.py:1423-1520``): c'(m', M') for every (M-gridpoint,
    next state) column by the two-level interpolation, then the expected
    marginal value as one ``einsum`` over the composite transition."""
    # the bracketing M-columns of every (mc, s') column's M'
    cols, w = m_bracket(pre.M_next, cal.m_grid)               # [Mc, S', 2]
    sp = torch.arange(cols.shape[1], device=cols.device)[None, :, None]
    xp = policy.m_knots[sp, cols]                             # [Mc, S', 2, K]
    fp = policy.c_knots[sp, cols]
    x = pre.m_next.permute(1, 2, 0)[:, :, None, :].expand(-1, -1, 2, -1)
    v = interp1d_rowwise(x, xp, fp)                           # [Mc, S', 2, A]
    c_next = (v[:, :, 0] + w[..., None] * (v[:, :, 1] - v[:, :, 0])
              ).permute(2, 0, 1)
    vp_next = marginal_utility(c_next, cal.crra)
    weighted = pre.R_next[None, :, :] * vp_next               # [A, Mc, S']
    # EndOfPrdvP[a, mc, s] = beta * sum_{s'} P[s, s'] weighted[a, mc, s']
    end_vp = cal.disc_fac * torch.einsum("ams,ks->amk", weighted,
                                         cal.ind_transition)
    c_now = inverse_marginal_utility(end_vp, cal.crra)       # [A, Mc, S]
    m_now = cal.a_grid[:, None, None] + c_now
    eps = torch.full((1,) + c_now.shape[1:], CONSTRAINT_EPS,
                     dtype=c_now.dtype, device=c_now.device)
    # [A+1, Mc, S] -> [S, Mc, A+1]
    c_knots = torch.cat([eps, c_now], dim=0).permute(2, 1, 0).contiguous()
    m_knots = torch.cat([eps, m_now], dim=0).permute(2, 1, 0).contiguous()
    return KSPolicy(m_knots=m_knots, c_knots=c_knots)


def _lane(policy: KSPolicy) -> KSPolicy:
    return KSPolicy(*(t[None] for t in policy))


def _one_lane_solver(pre: PrecomputedArrays, cal: KSCalibration):
    """The fixed point of ``egm_step_ks`` as ``(p0, tol, max_iter,
    accel_every) -> (policy, iters, diff, status)`` on a one-lane batch
    (fields ``[1, S, Mc, K]``), the form the ladder composes."""
    def step(p):
        return _lane(egm_step_ks(KSPolicy(p.m_knots[0], p.c_knots[0]),
                                 pre, cal))

    return functools.partial(accelerated_policy_fixed_point, step)


def solve_ks_household(afunc: AFuncParams, cal: KSCalibration,
                       tol: float = 1e-6, max_iter: int = 2000,
                       init_policy: KSPolicy | None = None,
                       accel_every: int = 32,
                       precision: str = "reference"):
    """Infinite-horizon fixed point of the 4N-state EGM step under the
    perceived aggregate law: sup-norm convergence over the knots, with
    the certified Anderson(1)/Aitken extrapolation every ``accel_every``
    steps (0 disables).  ``init_policy`` warm-starts the iteration (the
    KS outer loop passes the previous outer iteration's policy).
    ``precision``: "reference" is the single-phase solve; "mixed" /
    "fast" run the cheap-dtype descent (and the reference polish) of
    ``household.ladder_policy_fixed_point``.  Returns (policy, iters,
    diff, status), the last three 0-d tensors on the device (status a
    ``solver_health`` code)."""
    spec = resolve_precision(precision)
    pre = precompute(afunc, cal)
    p0 = initial_ks_policy(cal) if init_policy is None else init_policy
    solve_ref = _one_lane_solver(pre, cal)
    if not spec.two_phase:
        pol, it, diff, status = solve_ref(_lane(p0), tol, max_iter,
                                          accel_every)
    else:
        cheap = descent_dtype(cal.a_grid.dtype)
        cal_c = cast_calibration(cal, cheap)
        pre_c = PrecomputedArrays(*(t.to(cheap) for t in pre))
        pol, it, diff, status, _ = ladder_policy_fixed_point(
            _one_lane_solver(pre_c, cal_c), solve_ref, _lane(p0), tol,
            descent_tolerance(tol, cheap, POLICY_DESCENT_TOL_SCALE),
            max_iter, accel_every, polish=spec.polish, cheap_dtype=cheap)
    return (KSPolicy(pol.m_knots[0], pol.c_knots[0]), it[0], diff[0],
            status[0])
