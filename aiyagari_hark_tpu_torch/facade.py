"""Notebook-compatible facade (port of ``aiyagari_hark_tpu/facade.py``):
``AiyagariType`` / ``AiyagariEconomy`` with the reference notebook's
interface, on the port's Krusell-Smith solver.

The reference notebook drives the model as (``Aiyagari-HARK.py:234-258``):

    economy = AiyagariEconomy(**econ_dict); economy.verbose = False
    agent = AiyagariType(**agent_dict); agent.cycles = 0
    agent.get_economy_data(economy)
    economy.agents = [agent]
    economy.make_Mrkv_history()
    economy.solve()
    economy.sow_state['Rnow'|'Mnow']; economy.reap_state['aNow']
    economy.AFunc[j](M); agent.solution[0].cFunc[s](m, M)
    agent.solution[0].cFunc[s].xInterpolators   # per-M 1D plots

The same attribute names, the same parameter-dict spelling
(``init_Aiyagari_agents`` / ``init_Aiyagari_economy``,
``Aiyagari_Support.py:752-757, 1525-1551``) and the same steady-state
attributes (``KtoLSS/KSS/WSS/RSS/MSS``, ``Aiyagari_Support.py:1606-1615``).
The JAX facade's ``backend=`` picks a platform; the port's counterpart is
``device=`` (default: the card; ``device="cpu"`` runs on the host).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .device import resolve_device
from .models import firm
from .models.ks_solver import KSSolution, solve_ks_economy
from .models.simulate import simulate_markov_history
from .ops.interp import interp1d, interp_on_interp
from .ops.markov import aggregate_markov_matrix
from .solver_health import NONFINITE, SolverDivergenceError, status_name
from .utils.config import (
    _ECONOMY_KEY_MAP,
    MGRID_BASE_DEFAULT,
    AgentConfig,
    EconomyConfig,
)


def quantile_resample(grid, weights, n_agents: int) -> np.ndarray:
    """Equal-weight agent panel from an exact histogram, notebook-style:
    a midpoint-CDF quantile draw over the zero-mass-trimmed support (the
    trailing bins holding less than half an agent's share, 0.5/n, in
    total are trimmed first), the top agent pinned to the trimmed
    support's maximum."""
    grid = np.asarray(grid)
    weights = np.asarray(weights)
    pos = weights > 0
    w_pos = weights[pos] / weights.sum()
    tail = np.cumsum(w_pos[::-1])[::-1]          # mass at & above each point
    keep = tail >= 0.5 / n_agents                # nonempty: tail[0] == 1
    g = grid[pos][keep]
    w = w_pos[keep] / w_pos[keep].sum()
    cdf = np.cumsum(w) - 0.5 * w
    q = (np.arange(n_agents) + 0.5) / n_agents
    a_now = np.interp(q, cdf, g)
    a_now[-1] = g[-1]                            # midpoints top out at
    return a_now                                 # (n-0.5)/n; pin support max


def init_aiyagari_agents() -> dict:
    """The reference's agent parameter dict, reference spelling
    (``init_Aiyagari_agents``, ``Aiyagari_Support.py:752-757``)."""
    a = AgentConfig()
    return {
        "LaborStatesNo": a.labor_states, "aMin": a.a_min, "aMax": a.a_max,
        "aCount": a.a_count, "aNestFac": a.a_nest_fac,
        "AgentCount": a.agent_count, "MgridBase": np.array(MGRID_BASE_DEFAULT),
    }


def init_aiyagari_economy() -> dict:
    """The reference's economy parameter dict, reference spelling
    (``init_Aiyagari_economy``, ``Aiyagari_Support.py:1525-1551``)."""
    e = EconomyConfig()
    return {
        "verbose": e.verbose, "LaborStatesNo": e.labor_states,
        "LaborAR": e.labor_ar, "LaborSD": e.labor_sd, "act_T": e.act_T,
        "T_discard": e.t_discard, "DampingFac": e.damping_fac,
        "intercept_prev": list(e.intercept_prev),
        "slope_prev": list(e.slope_prev),
        "DiscFac": e.disc_fac, "CRRA": e.crra, "LbrInd": e.lbr_ind,
        "ProdB": e.prod_b, "ProdG": e.prod_g, "CapShare": e.cap_share,
        "DeprFac": e.depr_fac, "DurMeanB": e.dur_mean_b,
        "DurMeanG": e.dur_mean_g, "SpellMeanB": e.spell_mean_b,
        "SpellMeanG": e.spell_mean_g, "UrateB": e.urate_b,
        "UrateG": e.urate_g, "RelProbBG": e.rel_prob_bg,
        "RelProbGB": e.rel_prob_gb, "MrkvNow_init": e.mrkv_now_init,
    }


class AggregateSavingRule:
    """The perceived aggregate law of motion ``A = exp(i + s log M)``
    (``AggregateSavingRule.__call__``, ``Aiyagari_Support.py:1991-2005``)."""

    distance_criteria = ["slope", "intercept"]

    def __init__(self, intercept: float, slope: float):
        self.intercept = float(intercept)
        self.slope = float(slope)

    def __call__(self, Mnow):
        return np.exp(self.intercept + self.slope * np.log(Mnow))

    def distance(self, other: "AggregateSavingRule") -> float:
        """HARK MetricObject distance: max over the criteria attributes."""
        return max(abs(self.slope - other.slope),
                   abs(self.intercept - other.intercept))


class StatePolicy:
    """One discrete state's consumption function c(m, M): the facade over
    a ``[Mcount, A+1]`` knot block (the reference's
    ``LinearInterpOnInterp1D`` of 15 ``LinearInterp`` columns,
    ``Aiyagari_Support.py:1509-1516``), evaluated on the host in float64."""

    def __init__(self, m_knots, c_knots, m_grid):
        def host(x):
            return torch.as_tensor(np.asarray(
                x.cpu() if isinstance(x, torch.Tensor) else x),
                dtype=torch.float64)

        self._m_knots = host(m_knots)
        self._c_knots = host(c_knots)
        self._m_grid = host(m_grid)

    def __call__(self, m, M):
        m = np.asarray(m, dtype=np.float64)
        M = np.asarray(M, dtype=np.float64)
        if M.ndim == 0:
            return interp_on_interp(torch.as_tensor(m), torch.as_tensor(M),
                                    self._m_grid, self._m_knots,
                                    self._c_knots).numpy()
        # array-valued M (paired (m, M) arrays, as HARK's interpolators
        # take them): evaluate point by point
        m_b, M_b = np.broadcast_arrays(m, M)
        out = [float(interp_on_interp(torch.as_tensor(mi),
                                      torch.as_tensor(Mi), self._m_grid,
                                      self._m_knots, self._c_knots))
               for mi, Mi in zip(m_b.ravel(), M_b.ravel())]
        return np.asarray(out).reshape(m_b.shape)

    @property
    def xInterpolators(self) -> List:
        """Per-M-gridpoint 1D functions m -> c, as the notebook plots them
        (``Aiyagari-HARK.py:275``)."""
        def make(k):
            def f(m):
                return interp1d(torch.as_tensor(np.asarray(
                    m, dtype=np.float64)), self._m_knots[k],
                    self._c_knots[k]).numpy()
            return f
        return [make(k) for k in range(self._m_grid.shape[0])]


class AiyagariSolution:
    """``type.solution[0]`` facade: per-state consumption policies."""

    def __init__(self, cFunc: List[StatePolicy]):
        self.cFunc = cFunc


class AiyagariType:
    """Household-type facade (reference ``AiyagariType``,
    ``Aiyagari_Support.py:759-804``): a parameter bag plus, after the
    economy solves, ``solution[0].cFunc``."""

    def __init__(self, **kwds):
        params = init_aiyagari_agents()
        params.update(kwds)
        self.parameters = params
        self._explicit = set(kwds)   # keys the caller actually set
        for k, v in params.items():
            setattr(self, k, v)
        self.cycles = 0          # infinite horizon (Aiyagari-HARK.py:237)
        self.solution: Optional[List[AiyagariSolution]] = None
        self.economy: Optional["AiyagariEconomy"] = None

    def get_economy_data(self, economy: "AiyagariEconomy") -> None:
        """Link the economy (the reference copies KSS, Mgrid, AFunc and
        the transition matrices onto the agent,
        ``Aiyagari_Support.py:817-873``)."""
        self.economy = economy
        self.Mgrid = economy.MSS * np.asarray(self.MgridBase)
        self.kInit = economy.KSS

    def agent_config(self) -> AgentConfig:
        return AgentConfig.from_reference_dict(self.parameters)


class AiyagariEconomy:
    """Economy/market facade (reference ``AiyagariEconomy``,
    ``Aiyagari_Support.py:1555-1964``): construct -> ``make_Mrkv_history``
    -> ``solve`` -> read ``sow_state``/``reap_state``/``AFunc``/``history``.

    ``device``: where ``make_Mrkv_history`` draws and ``solve`` runs
    (default: the card, raising without one; ``device="cpu"`` for the
    host).  It takes the place of the JAX facade's ``backend=``."""

    sow_vars = ["Mnow", "Aprev", "Mrkv", "Rnow", "Wnow"]
    reap_vars = ["aNow", "EmpNow"]
    track_vars = ["Mrkv", "Aprev", "Mnow", "Urate"]
    dyn_vars = ["AFunc"]

    def __init__(self, agents=None, tolerance: float = 0.01,
                 device=None, **kwds):
        params = init_aiyagari_economy()
        params.update(kwds)
        self.parameters = params
        self._explicit = set(kwds)   # keys the caller actually set
        self.device = device
        for k, v in params.items():
            setattr(self, k, v)
        self.agents = list(agents) if agents is not None else []
        self.tolerance = tolerance
        self.max_loops = int(kwds.get("max_loops", 40))
        self.seed = int(kwds.get("seed", 0))
        self.sow_state: dict = {}
        self.reap_state: dict = {}
        self.history: dict = {}
        self.MrkvNow_hist: Optional[np.ndarray] = None
        self.solution: Optional[KSSolution] = None
        self.update()

    # -- construction ------------------------------------------------------
    def update(self) -> None:
        """Steady-state objects and initial saving-rule guesses
        (``Aiyagari_Support.py:1593-1629``)."""
        self.AFunc = [AggregateSavingRule(self.intercept_prev[j],
                                          self.slope_prev[j])
                      for j in range(2)]
        ss = firm.perfect_foresight_steady_state(
            self.DiscFac, self.CapShare, self.DeprFac, self.LbrInd)
        self.KtoLSS = float(ss.k_to_l)
        self.KSS = float(ss.K)
        self.WSS = float(ss.W)
        self.RSS = float(ss.R)
        self.MSS = float(ss.M)
        self.KtoYSS = self.KtoLSS ** (1.0 - self.CapShare)
        self.sow_init = {"KtoLnow": self.KtoLSS, "Mnow": self.MSS,
                         "Aprev": self.KSS, "Rnow": self.RSS,
                         "Wnow": self.WSS, "Mrkv": self.MrkvNow_init}

    # Preference/process parameters a user may set on either the agent or
    # the economy dict (HARK's solver reads them off the agent).
    _SHARED_KEYS = ("CRRA", "DiscFac", "LaborAR", "LaborSD", "LaborStatesNo")

    def economy_config(self) -> EconomyConfig:
        cfg = EconomyConfig.from_reference_dict(self.parameters)
        return cfg.replace(tolerance=float(self.tolerance),
                           verbose=bool(self.verbose),
                           max_loops=self.max_loops)

    def _economy_config_for(self, agent: AiyagariType) -> EconomyConfig:
        """Economy config with agent-level overrides honored: a key set
        explicitly on ``AiyagariType(...)`` wins over the economy default;
        an explicit conflict between the two dicts raises."""
        cfg = self.economy_config()
        for key in self._SHARED_KEYS:
            if key not in agent._explicit:
                continue
            agent_val = agent.parameters[key]
            if key in self._explicit and self.parameters[key] != agent_val:
                raise ValueError(
                    f"{key} set explicitly on both AiyagariType "
                    f"({agent_val!r}) and AiyagariEconomy "
                    f"({self.parameters[key]!r}); set it in one place")
            cfg = cfg.replace(**{_ECONOMY_KEY_MAP[key]: agent_val})
        return cfg

    def make_Mrkv_history(self, seed: Optional[int] = None) -> np.ndarray:
        """Draw the aggregate Bad/Good chain (``make_Mrkv_history``,
        ``Aiyagari_Support.py:1793-1805``) on the economy's device, from a
        generator seeded by ``seed`` (default: the economy's)."""
        seed = self.seed if seed is None else seed
        dev = resolve_device(self.device)
        agg = aggregate_markov_matrix(self.DurMeanB, self.DurMeanG,
                                      dtype=torch.float64, device=dev)
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
        hist = simulate_markov_history(agg, self.MrkvNow_init, self.act_T, g)
        self.MrkvNow_hist = hist.cpu().numpy()
        return self.MrkvNow_hist

    # -- solve -------------------------------------------------------------
    def solve(self, ks_employment: bool = False, dtype=None,
              **solve_kwargs) -> KSSolution:
        """Run the Krusell-Smith fixed point (``solve_ks_economy`` on the
        economy's device) and populate the reference's result surface.

        A diverged solve raises ``SolverDivergenceError`` with the
        per-iteration status trail: from inside ``solve_ks_economy`` (a
        non-finite rule) or here, when the final history or prices are
        non-finite.  An unconverged solve (``max_loops`` spent) returns
        with ``solution.converged=False``.

        Extra keyword arguments go to ``solve_ks_economy``; under
        ``sim_method="distribution"`` ``reap_state["aNow"]`` holds an
        equal-weight quantile resample of the exact histogram (so
        unweighted notebook consumers keep working), the histogram itself
        under ``reap_state["aNowGrid"]`` / ``["aNowWeights"]``."""
        if not self.agents:
            raise ValueError("economy.agents is empty — assign "
                             "[AiyagariType(...)] before solve()")
        agent = self.agents[0]
        solve_kwargs.setdefault("device", self.device)
        sol = solve_ks_economy(
            agent.agent_config(), self._economy_config_for(agent),
            seed=self.seed, ks_employment=ks_employment, dtype=dtype,
            mrkv_hist=self.MrkvNow_hist, **solve_kwargs)
        final_vals = np.asarray([float(sol.history.A_prev[-1]),
                                 float(sol.history.M_now[-1])])
        if sol.status == NONFINITE or not np.isfinite(final_vals).all():
            from .obs.runtime import emit_event

            emit_event("SOLVER_DIVERGED", where="facade",
                       status=status_name(sol.status))
            raise SolverDivergenceError(
                f"economy.solve() produced non-finite results "
                f"(status={status_name(sol.status)}, final A/M="
                f"{final_vals.tolist()}); the status trail is attached — "
                f"refusing to populate sow_state/reap_state with garbage",
                status=NONFINITE,
                trail=[{"iteration": r.iteration, "distance": r.distance,
                        "egm_status": r.egm_status,
                        "egm_status_name": status_name(r.egm_status)}
                       for r in sol.records])
        self.solution = sol
        self._populate_results(sol, agent)
        return sol

    def _populate_results(self, sol: KSSolution, agent: AiyagariType) -> None:
        hist = sol.history
        final = sol.final_panel
        intercept = sol.afunc.intercept.cpu().tolist()
        slope = sol.afunc.slope.cpu().tolist()
        self.AFunc = [AggregateSavingRule(intercept[j], slope[j])
                      for j in range(2)]
        # the final parameters become the next run's initial guesses (the
        # reference's in-place intercept_prev/slope_prev update,
        # Aiyagari_Support.py:1949-1951): a repeat solve() warm-starts
        self.intercept_prev = [float(x) for x in intercept]
        self.slope_prev = [float(x) for x in slope]
        self.parameters["intercept_prev"] = self.intercept_prev
        self.parameters["slope_prev"] = self.slope_prev
        self.sow_state = {
            "Mnow": float(final.M_now), "Aprev": float(hist.A_prev[-1]),
            "Mrkv": int(final.mrkv), "Rnow": float(final.R_now),
            "Wnow": float(final.W_now),
        }
        if hasattr(final, "assets"):      # Monte-Carlo panel (PanelState)
            self.reap_state = {
                "aNow": [final.assets.cpu().numpy()],
                "EmpNow": [final.employed.cpu().numpy()],
            }
        else:                             # DistPanelState histogram
            masses = final.dist.cpu().numpy()          # [D, N, 2]
            grid = sol.dist_grid.cpu().numpy()
            weights = masses.sum(axis=(1, 2))
            n_agents = int(agent.parameters["AgentCount"])
            a_now = quantile_resample(grid, weights, n_agents)
            self.reap_state = {
                "aNow": [a_now],
                "aNowGrid": [grid],
                "aNowWeights": [weights],
                "EmpNow": [masses[:, :, 1].sum()],   # employed mass share
            }
        self.history = {k: v.cpu().numpy() for k, v in (
            ("Mrkv", hist.mrkv), ("Aprev", hist.A_prev),
            ("Mnow", hist.M_now), ("Urate", hist.urate))}
        m_grid = sol.calibration.m_grid.cpu()
        m_knots = sol.policy.m_knots.cpu()
        c_knots = sol.policy.c_knots.cpu()
        agent.solution = [AiyagariSolution(cFunc=[
            StatePolicy(m_knots[s], c_knots[s], m_grid)
            for s in range(m_knots.shape[0])])]
