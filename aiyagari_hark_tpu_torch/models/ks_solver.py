"""The Krusell-Smith outer fixed point: simulate -> regress -> damp ->
repeat (port of ``aiyagari_hark_tpu/models/ks_solver.py``).

Reference: ``Market.solve`` drives solve_agents / make_history /
update_dynamics until the aggregate saving rule stops moving; the
regression and damping live in ``calc_AFunc`` (``Aiyagari_Support.py:
1896-1964``).  The outer loop is host Python; each outer iteration runs
the 4N-state EGM fixed point, one simulated history and the per-state
masked regression on the device.  The convergence metric is HARK's
distance on the rule parameters, ``max_i max(|d slope_i|, |d
intercept_i|)``, against ``EconomyConfig.tolerance``.

Host syncs: the EGM loop reads its active flag once a step
(``household.accelerated_policy_fixed_point``); a simulated history syncs
nowhere inside its period loop; each outer iteration then reads its
results in one transfer (the rule, r-squared, the EGM counters, and in
slope-pinned mode the residual), and a phase ends with a synchronize.
"""

from __future__ import annotations

import dataclasses
import math
import os
import warnings
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from ..device import resolve_device, resolve_dtype
from ..ops.regression import masked_ols
from ..solver_health import (
    CONVERGED,
    MAX_ITER,
    NONFINITE,
    SolverDivergenceError,
    status_name,
)
from ..utils.config import AgentConfig, EconomyConfig
from .ks_model import (
    AFuncParams,
    KSCalibration,
    KSPolicy,
    build_ks_calibration,
    initial_ks_policy,
    solve_ks_household,
)
from .simulate import (
    PanelHistory,
    initial_distribution_fan,
    initial_panel,
    make_sim_dist_grid,
    simulate_distribution_history,
    simulate_markov_history,
    simulate_panel,
    stack_states,
    unstack_state,
)


def calc_afunc_update(history: PanelHistory, mrkv_hist: torch.Tensor,
                      afunc: AFuncParams, t_discard: int, damping: float):
    """New saving-rule parameters from a simulated history (``calc_AFunc``):
    per aggregate state, OLS of log A_t on log M_{t-1}, then a damped merge
    with the previous parameters.  Returns (new_params, r_squared[2]).
    ``history`` arrays may carry a leading fan axis ``[F, T]``: the
    per-path (log M, log A) pairs are pooled into one sample."""
    a_prev = torch.atleast_2d(history.A_prev)   # [F, T]
    m_now = torch.atleast_2d(history.M_now)
    log_a = torch.log(a_prev[:, t_discard:]).reshape(-1)
    log_m = torch.log(m_now[:, t_discard - 1:-1]).reshape(-1)
    states = mrkv_hist[t_discard - 1:-1].to(a_prev.device).expand(
        a_prev.shape[0], m_now.shape[1] - t_discard).reshape(-1)
    w = 1.0 - damping
    intercepts, slopes, rsqs = [], [], []
    for i in range(2):
        res = masked_ols(log_m, log_a, states == i)
        intercepts.append(w * res.intercept + damping * afunc.intercept[i])
        slopes.append(w * res.slope + damping * afunc.slope[i])
        rsqs.append(res.r_squared)
    return (AFuncParams(intercept=torch.stack(intercepts),
                        slope=torch.stack(slopes)), torch.stack(rsqs))


class _PinnedSecant:
    """Safeguarded secant iteration on the scalar residual ``g(i) = mean
    log A_settled(i) - i`` of the slope-pinned saving rule (host floats).

    Plain damped iteration diverges here: the notebook calibration sits at
    Aiyagari's knife edge (r* just below 1/beta - 1), where ergodic asset
    supply is extremely elastic in the perceived return (d log A / d
    intercept ~ -3), so the damped map has modulus > 1 for any damping
    < 0.75.  The secant step handles the steep monotone residual; a
    bracket on the sign change plus a step clamp keeps it safe."""

    def __init__(self, max_step: float = 0.10, probe: float = 0.25):
        self.i_prev = None
        self.g_prev = None
        self.lo = None    # highest intercept seen with g > 0
        self.hi = None    # lowest intercept seen with g < 0
        self.max_step = max_step
        self.probe = probe

    def step(self, i: float, g: float) -> float:
        # Early evaluations with carried simulation state are
        # transient-biased: a fresh evaluation that contradicts a stored
        # bound evicts it.  A bracket pinched below 1e-6 around a point
        # whose |g| exceeds 10x what the local slope allows is stale.
        if self.lo is not None and self.hi is not None:
            width = self.hi - self.lo
            slope_est = 200.0
            if (self.g_prev is not None and self.i_prev is not None
                    and abs(i - self.i_prev) > 1e-12):
                slope_est = max(
                    abs((g - self.g_prev) / (i - self.i_prev)), 1.0)
            if (width < 1e-6
                    and abs(g) > 10.0 * slope_est * max(width, 1e-12)):
                self.lo = self.hi = None
        if g > 0:
            if self.hi is not None and i >= self.hi:
                self.hi = None   # stale: g>0 cannot sit at/above the hi bound
            self.lo = i if self.lo is None else max(self.lo, i)
        else:
            if self.lo is not None and i <= self.lo:
                self.lo = None
            self.hi = i if self.hi is None else min(self.hi, i)
        if (self.g_prev is not None and abs(g - self.g_prev) > 1e-14
                and abs(i - self.i_prev) > 1e-12):
            cand = i - g * (i - self.i_prev) / (g - self.g_prev)
        else:
            # seed the secant, or recover from a frozen iterate
            cand = i + self.probe * g
        cand = min(max(cand, i - self.max_step), i + self.max_step)
        if self.lo is not None and self.hi is not None and not (
                self.lo < cand < self.hi):
            cand = 0.5 * (self.lo + self.hi)   # bisect when secant escapes
        self.i_prev, self.g_prev = i, g
        return cand

    def to_array(self):
        """(i_prev, g_prev, lo, hi) with NaN for unset (checkpoint form)."""
        return np.asarray([np.nan if v is None else v for v in
                           (self.i_prev, self.g_prev, self.lo, self.hi)])

    def restore(self, arr) -> None:
        vals = [None if np.isnan(v) else float(v) for v in np.asarray(arr)]
        self.i_prev, self.g_prev, self.lo, self.hi = vals


@dataclass
class KSIterationRecord:
    """Per outer iteration (the reference's ``verbose`` print,
    ``Aiyagari_Support.py:1954-1962``)."""

    iteration: int
    intercept: List[float]
    slope: List[float]
    r_squared: List[float]
    distance: float
    egm_iters: int
    wall_seconds: float
    egm_status: int = CONVERGED   # solver_health code of the EGM solve


@dataclass
class KSSolution:
    afunc: AFuncParams
    policy: KSPolicy
    calibration: KSCalibration
    history: PanelHistory
    mrkv_hist: object = None     # [T] aggregate-state chain used
    final_panel: object = None   # PanelState at the last simulated period
    # (``DistPanelState`` under sim_method="distribution")
    dist_grid: object = None     # [D] histogram support (distribution mode)
    records: List[KSIterationRecord] = field(default_factory=list)
    converged: bool = False
    status: int = CONVERGED      # worst-of-run solver_health code

    @property
    def equilibrium_r_pct(self) -> float:
        """(R-1)*100 at the final simulated period, the notebook's
        equilibrium-return readout (``Aiyagari-HARK.py:257``)."""
        from . import firm

        cal = self.calibration
        A = float(self.history.A_prev[-1])
        z = int(self.history.mrkv[-1])
        agg_l = float((1.0 - cal.urate_by_agg[z]) * cal.lbr_ind)
        R = firm.interest_factor(A / agg_l, float(cal.cap_share),
                                 float(cal.depr_fac),
                                 float(cal.prod_by_agg[z]))
        return (float(R) - 1.0) * 100.0


def stream_seeds(seed: int):
    """The three generator seeds of a solve (aggregate chain, birth panel,
    panel shocks), derived from ``seed`` by NumPy's ``SeedSequence``."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(
        3, dtype=np.uint32)]


def iteration_seed(panel_seed: int, iteration: int) -> int:
    """The panel-shock seed of outer iteration ``iteration`` under
    ``resample_each_iteration=True``: a fresh, reproducible stream."""
    return int(np.random.SeedSequence([int(panel_seed), int(iteration)])
               .generate_state(1, dtype=np.uint32)[0])


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def solve_ks_economy(agent: AgentConfig, econ: EconomyConfig,
                     seed: int = 0, ks_employment: bool = False,
                     dtype=None, egm_tol: float = 1e-6,
                     resample_each_iteration: bool = False,
                     mrkv_hist=None, callback=None,
                     checkpoint_path=None, timer=None,
                     sim_method: str = "panel",
                     dist_count: int = 500,
                     dist_fan: int | None = None,
                     dist_discard: int | None = None,
                     dist_pin_slope: bool | None = None,
                     retry=None, device=None) -> KSSolution:
    """The Krusell-Smith fixed point over the aggregate saving rule, on
    ``device`` (default: the card; ``device="cpu"`` runs on the host) in
    ``dtype`` (default float32).

    ``resample_each_iteration=False`` holds the shock panel fixed across
    outer iterations (a deterministic fixed point); True draws a fresh,
    reproducible stream per iteration (``iteration_seed``).  ``mrkv_hist``
    injects a pre-drawn aggregate chain (the facade's
    ``make_Mrkv_history``, or JAX's); the default draws one from ``seed``.
    Draws come from ``torch.Generator`` streams seeded from ``seed``
    (``stream_seeds``); they cannot match ``jax.random``.

    ``checkpoint_path``: save the outer-loop state there every iteration;
    a file that exists and matches ``seed`` and the configuration
    fingerprint is resumed from.  The carried histogram rides in
    ``checkpoint_path + ".dist.npz"`` (the JAX package's sidecar, same
    layout, so a checkpoint pair written by either package resumes in the
    other).  The port also stores the EGM warm start (the last policy) in
    ``checkpoint_path + ".policy.npz"``: with it a resume continues the
    uninterrupted run bit for bit.  Without it (a JAX-written pair) the
    EGM restarts from the identity guess, as the JAX package's resume
    does, and the trajectory agrees only to the EGM tolerance.  Both
    sidecars are written before the main checkpoint, which is the commit
    point; a sidecar whose iteration tag disagrees with the checkpoint's
    (a kill between the writes) degrades to a loud approximate resume.
    ``timer``: a ``utils.timing.PhaseTimer`` accumulating the solve,
    simulate and regress phases (each ends with a device synchronize).

    Resilience (``utils.resilience``): inside a ``preemption_guard()`` a
    SIGTERM/SIGINT is honored at the next outer-iteration boundary, after
    the checkpoint is written, by raising ``Interrupted``.  The household
    solve and the simulation run under ``retry_transient`` with the
    backoff of ``retry`` (default ``RetryPolicy()``); a replay draws from
    generators re-seeded inside it, so it computes the same bits.
    ``SolverDivergenceError`` is never retried.

    ``sim_method``: "panel" (``agent_count`` Monte-Carlo agents) or
    "distribution" (push a ``dist_count``-point wealth histogram through
    the same per-period operator; ``final_panel`` is then a
    ``DistPanelState``).  ``dist_pin_slope`` (default: True exactly when
    the calibration has no aggregate shock, ProdB=ProdG and UrateB=UrateG)
    pins the perceived rule to a constant ``K' = exp(intercept)`` and
    solves the intercept by a safeguarded secant (``_PinnedSecant``) on
    histories simulated at the fixed prices ``R(K')``.  ``dist_fan``:
    initial-condition paths of the unpinned regression (default 1).
    ``dist_discard``: periods dropped per path before the regression
    (default ``econ.t_discard`` for one path, else a short window).

    A non-finite saving rule journals ``SOLVER_DIVERGED`` (``where=
    "ks_outer"``) into the active obs scope before it raises.
    """
    from ..utils.checkpoint import (
        CORRUPT_NPZ_ERRORS,
        CheckpointMismatchError,
        config_fingerprint,
        load_ks_checkpoint,
        load_pytree,
        save_ks_checkpoint,
        save_pytree,
    )
    from ..utils.resilience import (
        RetryPolicy,
        raise_if_interrupted,
        retry_transient,
    )
    from ..utils.timing import PhaseTimer, Stopwatch

    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    if timer is None:
        timer = PhaseTimer()
    retry_policy = retry if retry is not None else RetryPolicy()

    def _device(label, f):
        """Transient-retry wrapper around one device phase."""
        return retry_transient(f, retry_policy, label=label)

    cal = build_ks_calibration(agent, econ, ks_employment=ks_employment,
                               dtype=dt, device=dev)
    hist_seed, birth_seed, panel_seed = stream_seeds(seed)
    if mrkv_hist is None:
        mrkv_hist = simulate_markov_history(
            cal.agg_transition, econ.mrkv_now_init, econ.act_T,
            _generator(hist_seed, dev))
    if isinstance(mrkv_hist, torch.Tensor):
        mrkv_hist = mrkv_hist.cpu()
    mrkv_host = np.array(mrkv_hist)
    mrkv_hist = torch.as_tensor(mrkv_host, device=dev)
    policy_seed = initial_ks_policy(cal)
    dist_grid = None
    if sim_method == "panel":
        init = initial_panel(cal, agent.agent_count, econ.mrkv_now_init,
                             _generator(birth_seed, dev))

        def run_panel(pol, it_seed, i0, kbar):   # realized prices: no kbar
            return simulate_panel(pol, cal, mrkv_hist, i0,
                                  _generator(it_seed, dev))

        carry_init = False    # reference parity: fresh birth panel per loop
    elif sim_method == "distribution":
        degenerate = (bool((cal.prod_by_agg == cal.prod_by_agg[0]).all())
                      and bool((cal.urate_by_agg
                                == cal.urate_by_agg[0]).all()))
        if dist_pin_slope is None:
            dist_pin_slope = degenerate
        dist_pin_slope = bool(dist_pin_slope)
        if dist_fan is None:
            dist_fan = 1
        dist_grid = make_sim_dist_grid(cal, dist_count)
        init = initial_distribution_fan(cal, dist_grid, econ.mrkv_now_init,
                                        dist_fan)
        # Pinned mode simulates under the FIXED prices R(K-bar): the path
        # is the household supply curve, so the secant root is the
        # market-clearing condition of the bisection engine.
        fixed_prices = dist_pin_slope

        def run_panel(pol, it_seed, i0, kbar):    # no draws: it_seed unused
            runs = [simulate_distribution_history(
                pol, cal, mrkv_hist, dist_grid, unstack_state(i0, f),
                fixed_K=(kbar if fixed_prices else None))
                for f in range(i0.dist.shape[0])]
            return (PanelHistory(*(torch.stack(x)
                                   for x in zip(*(r[0] for r in runs)))),
                    stack_states([r[1] for r in runs]))

        # Carry each outer iteration's final distribution into the next
        # one's initial condition: from the point mass at the steady state
        # one act_T window never reaches the ergodic distribution, so the
        # effective chain grows with the outer iteration count.  Not in
        # fan mode: its spread initial conditions are the identification.
        carry_init = dist_fan == 1
    else:
        raise ValueError(f"sim_method must be 'panel' or 'distribution', "
                         f"got {sim_method!r}")
    sim_init = init
    if dist_discard is None:
        dist_discard = (econ.t_discard if dist_fan in (None, 1)
                        else min(25, econ.act_T // 4))
    discard = (dist_discard if sim_method == "distribution"
               else econ.t_discard)
    # fingerprint after parameter resolution (a checkpoint of another
    # simulation mode is refused); run-control fields and the initial
    # guess are excluded: a resume may extend or tighten the same run.
    econ_fp = tuple(sorted(
        (k, v) for k, v in dataclasses.asdict(econ).items()
        if k not in ("max_loops", "verbose", "tolerance",
                     "intercept_prev", "slope_prev")))
    fingerprint = config_fingerprint(agent, econ_fp, mrkv_host,
                                     ks_employment, egm_tol, sim_method,
                                     dist_count, dist_fan, dist_discard,
                                     dist_pin_slope)
    pinned = sim_method == "distribution" and bool(dist_pin_slope)
    last_residual = [float("inf")]   # pinned mode's |g| at the last update
    if pinned:
        secant = _PinnedSecant()

        def update(hist, af):
            """The secant step on the host: one transfer of the measured
            settled mean and the current intercept."""
            measured, i_cur = torch.stack([
                torch.log(hist.A_prev[..., discard:]).mean(),
                af.intercept[0].to(hist.A_prev.dtype)]).tolist()
            g = measured - i_cur
            last_residual[0] = abs(g)
            i_new = secant.step(i_cur, g)
            new = AFuncParams(
                intercept=torch.full((2,), i_new, dtype=dt, device=dev),
                slope=torch.zeros((2,), dtype=dt, device=dev))
            # no regression ran: NaN, so records never claim a fit quality
            return new, torch.full((2,), float("nan"), dtype=dt,
                                   device=dev)
    else:
        def update(hist, af):
            return calc_afunc_update(hist, mrkv_hist, af, discard,
                                     econ.damping_fac)

    def finalize(history, final_panel):
        """Collapse the fan axis to the central path (the single-path
        contract of ``KSSolution``) and flag histogram-top truncation."""
        if sim_method == "distribution":
            c = dist_fan // 2
            history = PanelHistory(*(x[c] for x in history))
            final_panel = unstack_state(final_panel, c)
            top_mass = float(final_panel.dist[-1].sum())
            if top_mass > 1e-6:
                warnings.warn(
                    f"histogram top node holds {top_mass:.2e} mass — the "
                    f"ergodic wealth tail is being truncated at "
                    f"dist_grid[-1] and the reported equilibrium may be a "
                    f"clip artifact (check r* < 1/beta - 1; raise "
                    f"make_sim_dist_grid's top_factor or refine the "
                    f"solution grids)", stacklevel=3)
        return history, final_panel

    afunc = AFuncParams(
        intercept=torch.tensor(econ.intercept_prev, dtype=dt, device=dev),
        slope=torch.tensor(econ.slope_prev, dtype=dt, device=dev))
    if pinned:
        # start inside the rule class the secant iterates in (a constant
        # perceived capital): a configured guess of slope 0 is honored,
        # anything else falls back to the analytic steady state
        if all(abs(float(s)) < 1e-12 for s in econ.slope_prev):
            start = torch.tensor(econ.intercept_prev, dtype=dt, device=dev)
        else:
            start = torch.full((2,), math.log(float(cal.steady_state.K)),
                               dtype=dt, device=dev)
        afunc = AFuncParams(intercept=start,
                            slope=torch.zeros((2,), dtype=dt, device=dev))
    it_start = 0
    resumed_converged = False
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        ck = load_ks_checkpoint(checkpoint_path)
        if int(ck.seed) != seed or int(ck.fingerprint) != fingerprint:
            raise CheckpointMismatchError(
                f"checkpoint {checkpoint_path} was written by a different "
                f"run (seed {int(ck.seed)} vs {seed}, config fingerprint "
                f"mismatch: {int(ck.fingerprint) != fingerprint}) — delete "
                f"it or use a different checkpoint_path; refusing to "
                f"silently overwrite")
        afunc = AFuncParams(
            intercept=torch.as_tensor(ck.intercept).to(dev, dt),
            slope=torch.as_tensor(ck.slope).to(dev, dt))
        if pinned:
            secant.restore(ck.secant)
        # "converged" only relative to the tolerance the file was written
        # under: re-check against the current one (and |g| when pinned)
        resumed_converged = bool(ck.converged) and (
            float(ck.last_distance) < econ.tolerance) and (
            not pinned or float(ck.last_residual) < econ.tolerance)
        # always leave at least one pass to regenerate the policy/history
        it_start = max(0, min(int(ck.iteration), econ.max_loops - 1))
        sidecar = checkpoint_path + ".dist.npz"
        if carry_init:
            if os.path.exists(sidecar):
                tag = None
                try:
                    tag, state = load_pytree(  # integrity-ok
                        sidecar, (np.zeros((), np.int64), sim_init))
                except ValueError as e:
                    warnings.warn(
                        f"checkpoint sidecar {sidecar} does not match the "
                        f"current panel-state structure ({e}) — resuming "
                        f"from a fresh initial distribution; the continued "
                        f"trajectory is approximate, not exact",
                        stacklevel=2)
                if tag is not None and int(tag) == int(ck.iteration):
                    sim_init = type(sim_init)(*(
                        torch.as_tensor(leaf).to(like.device, like.dtype)
                        for leaf, like in zip(state, sim_init)))
                elif tag is not None:
                    warnings.warn(
                        f"checkpoint sidecar {sidecar} is tagged for "
                        f"iteration {int(tag)} but the checkpoint is at "
                        f"{int(ck.iteration)} (interrupted between the "
                        f"two writes?) — resuming from a fresh initial "
                        f"distribution; the continued trajectory is "
                        f"approximate, not exact", stacklevel=2)
            elif int(ck.iteration) > 0:
                warnings.warn(
                    f"no {sidecar} next to the checkpoint — resuming from "
                    f"a fresh initial distribution; the continued "
                    f"trajectory is approximate, not exact", stacklevel=2)
        policy_file = checkpoint_path + ".policy.npz"
        if os.path.exists(policy_file):
            tag = None
            try:
                # only a warm start: the npz's CRC-32 rejects a damaged
                # file (caught below), and the solve re-converges from
                # the identity guess
                tag, pol = load_pytree(policy_file,  # integrity-ok
                                       (np.zeros((), np.int64),
                                        policy_seed))
            except CORRUPT_NPZ_ERRORS as e:
                warnings.warn(
                    f"policy sidecar {policy_file} is unreadable ({e}) — "
                    f"the household solve restarts from the identity "
                    f"guess; the continued trajectory is approximate, "
                    f"not exact", stacklevel=2)
            if tag is not None and int(tag) == int(ck.iteration):
                policy_seed = KSPolicy(*(torch.as_tensor(x).to(dev, dt)
                                         for x in pol))
            elif tag is not None:
                warnings.warn(
                    f"policy sidecar {policy_file} is tagged for iteration "
                    f"{int(tag)} but the checkpoint is at "
                    f"{int(ck.iteration)} — the household solve restarts "
                    f"from the identity guess; the continued trajectory "
                    f"is approximate, not exact", stacklevel=2)
        if econ.verbose:
            print(f"[ks] resumed from {checkpoint_path} at outer "
                  f"iteration {it_start}"
                  + (" (already converged)" if resumed_converged else ""))

    def solve_hh(af, p0):
        out = solve_ks_household(af, cal, tol=egm_tol, init_policy=p0)
        _synchronize(dev)
        return out

    def simulate(pol, it_seed, i0, af):
        out = run_panel(pol, it_seed, i0, torch.exp(af.intercept[0]))
        _synchronize(dev)
        return out

    if resumed_converged:
        # idempotent reload: rebuild the policy/history the checkpoint
        # does not carry, leave the converged rule (and the file) alone
        with timer.phase("solve"):
            policy, _, _, egm_status = solve_hh(afunc, policy_seed)
        with timer.phase("simulate"):
            history, final_panel = simulate(policy, panel_seed, sim_init,
                                            afunc)
        history, final_panel = finalize(history, final_panel)
        return KSSolution(afunc=afunc, policy=policy, calibration=cal,
                          history=history, mrkv_hist=mrkv_hist,
                          final_panel=final_panel, dist_grid=dist_grid,
                          records=[], converged=True,
                          status=int(egm_status))

    records: List[KSIterationRecord] = []
    history = None
    final_panel = None
    policy = None
    converged = False
    for it in range(it_start, econ.max_loops):
        iter_sw = Stopwatch()
        with timer.phase("solve"):
            policy, egm_iters, _, egm_status = _device(
                f"KS household solve (iter {it})",
                lambda: solve_hh(afunc, policy_seed))
            policy_seed = policy
        it_seed = (iteration_seed(panel_seed, it) if resample_each_iteration
                   else panel_seed)
        with timer.phase("simulate"):
            history, final_panel = _device(
                f"KS panel simulation (iter {it})",
                lambda: simulate(policy, it_seed, sim_init, afunc))
            if carry_init:
                sim_init = final_panel
        with timer.phase("regress"):
            new_afunc, rsq = update(history, afunc)
            # one transfer: the old and new rule, r-squared, EGM counters
            host = torch.cat([
                afunc.intercept.double(), afunc.slope.double(),
                new_afunc.intercept.double(), new_afunc.slope.double(),
                rsq.double(), egm_iters.double().reshape(1),
                egm_status.double().reshape(1)]).tolist()
        old_i, old_s = host[0:2], host[2:4]
        new_i, new_s, rsq_h = host[4:6], host[6:8], host[8:10]
        egm_iters, egm_status = int(host[10]), int(host[11])
        if not all(math.isfinite(x) for x in new_i + new_s):
            from ..obs.runtime import emit_event

            emit_event("SOLVER_DIVERGED", where="ks_outer", iteration=it,
                       status="NONFINITE")
            raise SolverDivergenceError(
                f"KS outer iteration {it}: saving-rule regression produced "
                f"non-finite parameters (intercept={new_i}, slope={new_s}). "
                f"Usually an aggregate state never appears in the "
                f"post-discard window — increase act_T or decrease "
                f"t_discard.",
                status=NONFINITE,
                trail=[dataclasses.asdict(r) for r in records] + [{
                    "iteration": it, "intercept": new_i, "slope": new_s,
                    "egm_status": egm_status,
                    "egm_status_name": status_name(egm_status),
                }])
        # the distance in the rule's dtype, as the JAX package takes it
        np_dt = np.float64 if dt == torch.float64 else np.float32
        distance = float(np.max(np.maximum(
            np.abs(np.asarray(new_i, np_dt) - np.asarray(old_i, np_dt)),
            np.abs(np.asarray(new_s, np_dt) - np.asarray(old_s, np_dt)))))
        afunc = new_afunc
        rec = KSIterationRecord(
            iteration=it, intercept=new_i, slope=new_s, r_squared=rsq_h,
            distance=distance, egm_iters=egm_iters,
            wall_seconds=iter_sw.elapsed(), egm_status=egm_status)
        records.append(rec)
        if econ.verbose:
            print(f"[ks] iter {it}: intercept={rec.intercept} "
                  f"slope={rec.slope} r2={rec.r_squared} dist={distance:.5f}")
        if callback is not None:
            callback(rec)
        # pinned mode must also clear the fixed-point residual |g|: near
        # the 1/beta - 1 cap a small secant step does not imply a small
        # residual
        if distance < econ.tolerance and (
                not pinned or last_residual[0] < econ.tolerance):
            converged = True
        if checkpoint_path is not None:
            # sidecars first: the main checkpoint is the commit point
            if carry_init:
                save_pytree(checkpoint_path + ".dist.npz",
                            (np.asarray(it + 1, np.int64), sim_init))
            save_pytree(checkpoint_path + ".policy.npz",
                        (np.asarray(it + 1, np.int64), policy))
            save_ks_checkpoint(checkpoint_path, afunc, it + 1, seed,
                               converged, fingerprint,
                               secant=secant.to_array() if pinned else None,
                               last_distance=distance,
                               last_residual=last_residual[0])
        if converged:
            break
        # outer-iteration boundary: the checkpoint (when configured) was
        # just written, so a shutdown request exits here with resumable
        # state
        raise_if_interrupted("KS outer loop", checkpoint_path,
                             progress={"iteration": it + 1,
                                       "max_loops": econ.max_loops,
                                       "distance": distance})

    history, final_panel = finalize(history, final_panel)
    last_egm = records[-1].egm_status if records else CONVERGED
    status = max(CONVERGED if converged else MAX_ITER, last_egm)
    return KSSolution(afunc=afunc, policy=policy, calibration=cal,
                      history=history, mrkv_hist=mrkv_hist,
                      final_panel=final_panel, dist_grid=dist_grid,
                      records=records, converged=converged, status=status)
