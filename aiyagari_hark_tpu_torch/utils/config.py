"""Configurations and solver policies the port runs (port of
``aiyagari_hark_tpu/utils/config.py``; a copy, not an import): the
Krusell-Smith path's ``AgentConfig`` / ``EconomyConfig`` (reference key
spelling through ``from_reference_dict``), the precision, grid, kernel
and state policies, the packed row layout, ``SweepConfig`` and the
serving tier's ``AdmissionPolicy``.

Precision policy: ``"reference"`` runs every fixed point in the model
dtype; ``"mixed"`` runs a descent in the cheap dtype (float32 for a
float64 model) to a coarse tolerance, then a polish in the model dtype
to the caller's tolerance, with a descent that exits NONFINITE or
STALLED escalated to a pure reference solve; ``"fast"`` runs the descent
only (tolerance relaxed to the cheap dtype's floor).  On the card each
phase is one launch of a CUDA kernel, in its ``float`` or ``double``
instantiation (``models.household.ladder_policy_fixed_point``).

Grid policy: ``"reference"`` builds the historical grids; ``"compact"``
and ``"adaptive"`` keep the reference points below a knee and close the
top with the analytic linear tail (``ops.grids.build_asset_grids``,
``models.household._append_analytic_tail_knots``), and the policy fixed
point runs the coarse-to-fine grid ladder.

Kernel policy: ``"reference"`` runs the two inner fixed points as two
kernel launches per supply evaluation; ``"fused"`` runs both in one
launch of ``ops.kernels.fused_cell_grid`` under a single-phase precision
policy (under a two-phase one the reference engines run the ladder).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# The reference's MgridBase (Aiyagari_Support.py:755-756): multiples of the
# steady-state aggregate market resources at which the aggregate state is
# gridded, clustered around 1.0.
MGRID_BASE_DEFAULT: Tuple[float, ...] = (
    0.1, 0.3, 0.6, 0.8, 0.9, 0.95, 0.98, 1.0, 1.02, 1.05, 1.1, 1.2, 1.6, 2.0,
    3.0,
)

# The reference's parameter-dict spelling -> the dataclass fields.
_AGENT_KEY_MAP = {
    "LaborStatesNo": "labor_states",
    "LaborAR": "labor_ar",
    "LaborSD": "labor_sd",
    "DiscFac": "disc_fac",
    "CRRA": "crra",
    "LbrInd": "lbr_ind",
    "aMin": "a_min",
    "aMax": "a_max",
    "aCount": "a_count",
    "aNestFac": "a_nest_fac",
    "AgentCount": "agent_count",
    "MgridBase": "mgrid_base",
}

_ECONOMY_KEY_MAP = {
    "verbose": "verbose",
    "LaborStatesNo": "labor_states",
    "LaborAR": "labor_ar",
    "LaborSD": "labor_sd",
    "act_T": "act_T",
    "T_discard": "t_discard",
    "DampingFac": "damping_fac",
    "intercept_prev": "intercept_prev",
    "slope_prev": "slope_prev",
    "DiscFac": "disc_fac",
    "CRRA": "crra",
    "LbrInd": "lbr_ind",
    "ProdB": "prod_b",
    "ProdG": "prod_g",
    "CapShare": "cap_share",
    "DeprFac": "depr_fac",
    "DurMeanB": "dur_mean_b",
    "DurMeanG": "dur_mean_g",
    "SpellMeanB": "spell_mean_b",
    "SpellMeanG": "spell_mean_g",
    "UrateB": "urate_b",
    "UrateG": "urate_g",
    "RelProbBG": "rel_prob_bg",
    "RelProbGB": "rel_prob_gb",
    "MrkvNow_init": "mrkv_now_init",
    "tolerance": "tolerance",
}


@dataclass(frozen=True)
class AgentConfig:
    """Household-side parameters of the Krusell-Smith path.  Defaults
    mirror ``init_Aiyagari_agents`` (``Aiyagari_Support.py:752-757``)."""

    labor_states: int = 7
    labor_ar: float = 0.6
    labor_sd: float = 0.2
    labor_bound: float = 3.0
    disc_fac: float = 0.96
    crra: float = 1.0
    lbr_ind: float = 1.0
    a_min: float = 0.001
    a_max: float = 50.0
    a_count: int = 32
    a_nest_fac: int = 2
    agent_count: int = 140
    mgrid_base: Tuple[float, ...] = MGRID_BASE_DEFAULT

    @classmethod
    def from_reference_dict(cls, d: dict) -> "AgentConfig":
        kwargs = {}
        for ref_key, our_key in _AGENT_KEY_MAP.items():
            if ref_key in d:
                v = d[ref_key]
                if our_key == "mgrid_base":
                    v = tuple(float(x) for x in v)
                kwargs[our_key] = v
        return cls(**kwargs)

    def replace(self, **kwargs) -> "AgentConfig":
        return dataclasses.replace(self, **kwargs)


@dataclass(frozen=True)
class EconomyConfig:
    """Economy-side parameters.  Defaults mirror ``init_Aiyagari_economy``
    (``Aiyagari_Support.py:1525-1551``) plus the ``tolerance`` ctor kwarg
    (``Aiyagari_Support.py:1574``)."""

    verbose: bool = True
    labor_states: int = 7
    labor_ar: float = 0.6
    labor_sd: float = 0.2
    labor_bound: float = 3.0
    act_T: int = 11000
    t_discard: int = 1000
    damping_fac: float = 0.5
    intercept_prev: Tuple[float, float] = (0.0, 0.0)
    slope_prev: Tuple[float, float] = (1.0, 1.0)
    disc_fac: float = 0.96
    crra: float = 1.0
    lbr_ind: float = 1.0
    prod_b: float = 1.0
    prod_g: float = 1.0
    cap_share: float = 0.36
    depr_fac: float = 0.08
    dur_mean_b: float = 8.0
    dur_mean_g: float = 8.0
    spell_mean_b: float = 2.5
    spell_mean_g: float = 1.5
    urate_b: float = 0.0
    urate_g: float = 0.0
    rel_prob_bg: float = 0.75
    rel_prob_gb: float = 1.25
    mrkv_now_init: int = 0
    tolerance: float = 0.01
    max_loops: int = 40

    @classmethod
    def from_reference_dict(cls, d: dict) -> "EconomyConfig":
        kwargs = {}
        for ref_key, our_key in _ECONOMY_KEY_MAP.items():
            if ref_key in d:
                v = d[ref_key]
                if our_key in ("intercept_prev", "slope_prev"):
                    v = tuple(float(x) for x in v)
                kwargs[our_key] = v
        return cls(**kwargs)

    def replace(self, **kwargs) -> "EconomyConfig":
        return dataclasses.replace(self, **kwargs)


def notebook_run_configs() -> Tuple[AgentConfig, EconomyConfig]:
    """The configuration of the reference's executed notebook run (cells
    16-17): LaborAR=0.3, LaborSD=0.2, CRRA=1.0, AgentCount=350."""
    agent = AgentConfig(labor_ar=0.3, labor_sd=0.2, crra=1.0, agent_count=350)
    econ = EconomyConfig(labor_ar=0.3, labor_sd=0.2, crra=1.0)
    return agent, econ


PRECISION_POLICIES = ("reference", "mixed", "fast")

# Relative cost of one descent step against one reference step, where the
# phase counters are collapsed into one work number (the JAX package's
# conservative weight: f32 halves a CPU step).
DESCENT_STEP_COST = 0.5


@dataclass(frozen=True)
class PrecisionSpec:
    """Resolved ladder knobs for one precision policy: ``two_phase`` (a
    cheap-dtype descent runs), ``polish`` (the reference-dtype polish
    runs), ``descent_step_cost`` (a descent step's cost relative to a
    reference step)."""

    policy: str
    two_phase: bool
    polish: bool
    descent_step_cost: float


_PRECISION_SPECS = {
    "reference": PrecisionSpec("reference", two_phase=False, polish=True,
                               descent_step_cost=1.0),
    "mixed": PrecisionSpec("mixed", two_phase=True, polish=True,
                           descent_step_cost=DESCENT_STEP_COST),
    "fast": PrecisionSpec("fast", two_phase=True, polish=False,
                          descent_step_cost=DESCENT_STEP_COST),
}


def resolve_precision(policy) -> PrecisionSpec:
    """A precision policy name (or a spec, passed through) as its spec; an
    unknown name raises ``ValueError``."""
    if isinstance(policy, PrecisionSpec):
        return policy
    try:
        return _PRECISION_SPECS[policy]
    except (KeyError, TypeError):
        raise ValueError(f"precision policy must be one of "
                         f"{PRECISION_POLICIES}, got {policy!r}") from None


GRID_POLICIES = ("reference", "compact", "adaptive")


@dataclass(frozen=True)
class GridSpec:
    """Resolved knobs for one grid policy.

    ``compact``: the solver grid is truncated at the knee and closed with
    the analytic tail; the histogram keeps its reference density below
    the knee and crosses the tail on a thinned subset.  ``ladder``: the
    coarse-to-fine policy ladder runs (``models.household.
    solve_household``).  ``knee_frac``: static knee as a fraction of the
    span (None = the density knee at the ``knee_density`` quantile of the
    reference points).  ``dist_tail_frac``: share of the reference histogram tail
    points kept.  ``tail_points``: least tail points, and the anchor
    count of the ``"anchors"`` tail.  ``coarse_tol_factor``: the ladder's
    descent-tolerance relaxation."""

    policy: str
    compact: bool
    ladder: bool
    knee_frac: Optional[float] = None
    knee_density: float = 0.85
    dist_tail_frac: float = 0.5
    tail_points: int = 6
    coarse_tol_factor: float = 50.0


_GRID_SPECS = {
    "reference": GridSpec("reference", compact=False, ladder=False),
    "compact": GridSpec("compact", compact=True, ladder=True,
                        knee_frac=None, knee_density=0.85,
                        dist_tail_frac=0.5, tail_points=6,
                        coarse_tol_factor=50.0),
    "adaptive": GridSpec("adaptive", compact=True, ladder=True,
                         knee_frac=None, knee_density=0.75,
                         dist_tail_frac=0.34, tail_points=6,
                         coarse_tol_factor=50.0),
}


def resolve_grid(policy) -> GridSpec:
    """A grid policy name (or a spec, passed through) as its spec; an
    unknown name raises ``ValueError``."""
    if isinstance(policy, GridSpec):
        return policy
    try:
        return _GRID_SPECS[policy]
    except (KeyError, TypeError):
        raise ValueError(f"grid policy must be one of {GRID_POLICIES}, "
                         f"got {policy!r}") from None


KERNEL_POLICIES = ("reference", "fused")


@dataclass(frozen=True)
class KernelSpec:
    """Resolved knobs for one kernel policy.  ``fused``: one launch runs
    both inner fixed points of a supply evaluation, under a single-phase
    precision policy.  ``bf16_descent``: under a two-phase precision
    policy the descent ladder would gain a bf16 rung; as in the JAX
    package the rung runs only on a TPU backend, so never in the port
    (``models.household.bf16_rung_active``)."""

    policy: str
    fused: bool
    bf16_descent: bool


_KERNEL_SPECS = {
    "reference": KernelSpec("reference", fused=False, bf16_descent=False),
    "fused": KernelSpec("fused", fused=True, bf16_descent=True),
}


def resolve_kernel(policy) -> KernelSpec:
    """A kernel policy name (or a spec, passed through) as its spec; an
    unknown name raises ``ValueError``."""
    if isinstance(policy, KernelSpec):
        return policy
    try:
        return _KERNEL_SPECS[policy]
    except (KeyError, TypeError):
        raise ValueError(f"kernel policy must be one of {KERNEL_POLICIES}, "
                         f"got {policy!r}") from None


# State policy: the layout of one cell's distribution and wealth operator.
# "replicated" keeps a cell's state on one device; "sharded" splits it over
# a second mesh axis, which the port has not ported yet (ROADMAP Queue 1
# item 6): the solvers raise for it (``models.household.check_policies``).
STATE_POLICIES = ("replicated", "sharded")


@dataclass(frozen=True)
class StateSpec:
    """Resolved knobs for one state policy: ``sharded`` splits a cell's
    state over the "state" mesh axis."""

    policy: str
    sharded: bool


_STATE_SPECS = {
    "replicated": StateSpec("replicated", sharded=False),
    "sharded": StateSpec("sharded", sharded=True),
}


def resolve_state(policy) -> StateSpec:
    """A state policy name (or a spec, passed through) as its spec; an
    unknown name raises ``ValueError``."""
    if isinstance(policy, StateSpec):
        return policy
    try:
        return _STATE_SPECS[policy]
    except (KeyError, TypeError):
        raise ValueError(f"state policy must be one of {STATE_POLICIES}, "
                         f"got {policy!r}") from None


# Packed row of the Aiyagari batched cell solver: one float row per cell,
# so a launch's results reach the host in one transfer.  The counters and
# the status ride in the float dtype exactly (values far below 2^24).
PACKED_ROW_FIELDS = ("r_star", "capital", "labor", "bisect_iters",
                     "egm_iters", "dist_iters", "status",
                     "descent_steps", "polish_steps",
                     "precision_escalations")
PACKED_ROW_WIDTH = len(PACKED_ROW_FIELDS)


@dataclass(frozen=True)
class SweepConfig:
    """A calibration sweep over (CRRA sigma, labor AR rho, labor sd) cells:
    Aiyagari's Table II by default; ``labor_sd`` as a tuple adds the
    stationary-s.d. panels (``labor_sd=(0.2, 0.4)``: 24 cells).  The same
    17 fields, names and defaults as the JAX package's ``SweepConfig``.

    Scheduler (``parallel.sweep``): ``schedule`` "locked" solves every
    cell as a lane of one batched solve; "balanced" sorts the cells by
    predicted work into ``n_buckets`` buckets (0: about C/3, at most 8)
    solved one after another and un-permuted; "auto" takes "balanced"
    for 8 or more cells on the CPU and "locked" on the card.
    ``warm_brackets`` seeds each cell's bracket by dyadic descent toward
    the nearest solved neighbour's root (verified in the solve; a bad
    seed falls back to the cold bracket), ``warm_margin`` the ball kept
    around the seed root (0.0: automatic).  ``work_model`` "heuristic"
    uses the (sigma, rho, sd) heuristic; "auto" and "sidecar" read the
    measured counters of ``sidecar_path`` where it has the cell (and, with
    ``warm_brackets``, its roots as same-cell seeds), "sidecar" warning
    when no valid sidecar is there.  A sweep with a ``sidecar_path``
    writes one after it solves.  ``resume_path`` keeps the resume ledger
    (``utils.resilience.LedgerState``).

    Integrity: ``recheck_fraction`` re-solves a fingerprint-sampled
    ``ceil(fraction C)`` cells in other lane positions and compares the
    packed rows bitwise (a mismatch is routed through quarantine);
    ``certify`` grades every cell a posteriori (``verify.certificate``).
    ``grid`` and ``kernel`` are model-kwarg defaults of every cell.

    ``obs`` is None, an ``obs.ObsConfig`` (a bundle built and closed by
    the sweep) or an ``obs.Obs`` (the caller's, left open): spans,
    metrics, the event journal and the cost ledger of the run.  Not
    ported: ``state_shards > 1`` raises ``NotImplementedError`` in
    ``run_sweep`` (ROADMAP Queue 1 item 6).  ``compilation_cache`` has
    nothing to enable under PyTorch (the kernels are built once per
    process and nothing else is compiled) and is ignored."""

    crra_values: Tuple[float, ...] = (1.0, 3.0, 5.0)
    rho_values: Tuple[float, ...] = (0.0, 0.3, 0.6, 0.9)
    labor_sd: float | Tuple[float, ...] = 0.2
    schedule: str = "auto"
    n_buckets: int = 0
    warm_brackets: bool = False
    warm_margin: float = 0.0
    work_model: str = "auto"
    sidecar_path: str | None = None
    compilation_cache: bool = True
    resume_path: str | None = None
    recheck_fraction: float = 0.0
    certify: bool = False
    grid: str = "reference"
    kernel: str = "reference"
    state_shards: int = 1
    obs: Optional[object] = None

    def replace(self, **kwargs) -> "SweepConfig":
        return dataclasses.replace(self, **kwargs)

    def sd_values(self) -> Tuple[float, ...]:
        if isinstance(self.labor_sd, (tuple, list)):
            return tuple(float(s) for s in self.labor_sd)
        return (float(self.labor_sd),)

    def cells(self):
        """The (crra, rho, sd) cells: sd-major, then crra, then rho."""
        return [(s, r, sd) for sd in self.sd_values()
                for s in self.crra_values for r in self.rho_values]


@dataclass(frozen=True)
class AdmissionPolicy:
    """Overload management for the serving engine (DESIGN §11).

    ``EquilibriumService(admission=AdmissionPolicy(...))`` turns
    saturation into a typed state: fail-fast admission instead of
    unbounded queueing, priority load shedding, degraded nearest-neighbor
    answers, and per-region circuit breakers.  ``None`` (the service
    default) disables the whole layer: behavior, and every served bit,
    is that of the engine without it.

    Admission (``serve.service.Overloaded``):

    * ``max_work``: total queue-occupancy budget in predicted-work units
      (``serve.overload.predicted_work``; a baseline sigma=1, rho=0 cell
      weighs ~1.0).  Weighted occupancy over budget rejects fail-fast
      with depth and estimated wait (retry-after).
    * ``class_shares``: nested per-priority-class budgets, indexed by
      ``serve.Priority`` (INTERACTIVE=0 > BATCH=1 > SPECULATIVE=2):
      classes >= c together may hold at most
      ``max_work * class_shares[c]``.
    * ``shed``: when a class budget rejects an arrival, displace the
      least important, youngest queued pending instead (its future fails
      with the typed ``LoadShed``); strictly lower classes only.
    * ``deadline_aware``: reject at submit any query whose ``deadline``
      is shorter than the estimated wait (queued batches ahead x recent
      batch latency).
    * ``est_batch_s``: a fixed modeled batch latency for the wait
      estimate; ``None`` uses a measured EWMA.
    * ``work_unit_s``: modeled seconds of batch wall per predicted-work
      unit, the EWMA's cold-start seed: before the first flush the first
      admission-checked submit seeds it with ``weight * work_unit_s``.

    Degraded answers (consumption functions are asymptotically linear,
    so a near neighbor is a principled brown-out response):

    * ``degraded_pressure``: occupancy fraction past which an opt-in
      ``degraded_ok`` query is answered from the store's nearest
      neighbor instead of queueing a cold solve.
    * ``degraded_distance``: normalized (sigma, rho, sd) distance budget
      (``parallel.sweep.neighbor_distance`` units) beyond which the
      degraded path declines.
    * ``degraded_require_certified``: only donors with a
      CERTIFIED/MARGINAL certificate may answer.

    Regional circuit breakers (``serve.overload.CircuitBreaker``):

    * ``breaker_failures``: consecutive failures (NONFINITE/MAX_ITER
      solves, failed certifications) in one region that open its
      breaker (typed ``CircuitOpen`` fast-fail until a probe succeeds).
    * ``breaker_cooldown_s``: open -> half-open probe delay in clock
      units, doubling per reopen up to ``breaker_backoff_cap`` x.
    * ``breaker_region_scale``: quantization of (sigma, rho, sd) into
      breaker regions.
    """

    max_work: float = 64.0
    class_shares: Tuple[float, ...] = (1.0, 0.5, 0.25)
    shed: bool = True
    deadline_aware: bool = True
    est_batch_s: Optional[float] = None
    work_unit_s: float = 0.25
    degraded_pressure: float = 0.7
    degraded_distance: float = 0.25
    degraded_require_certified: bool = False
    breaker_failures: int = 3
    breaker_cooldown_s: float = 1.0
    breaker_backoff_cap: int = 8
    breaker_region_scale: Tuple[float, float, float] = (2.0, 0.3, 0.1)

    def replace(self, **kwargs) -> "AdmissionPolicy":
        return dataclasses.replace(self, **kwargs)
