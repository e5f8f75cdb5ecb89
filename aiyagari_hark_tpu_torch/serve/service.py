"""EquilibriumService: the in-process inference engine for equilibrium
queries — the serving analogue of the batch sweep (DESIGN §8; port of
``aiyagari_hark_tpu/serve/service.py``, with the same names, typed
errors, metric names and journal events).

Request path per query (``submit`` / ``query``):

1. **exact hit** — the query's key (``_query_key``: the
   ``solution_fingerprint`` with the port's package token folded in) is
   in the ``SolutionStore``: the future resolves immediately from the
   cached row.  No device launch — microseconds.
2. **near hit** — the store nominates the nearest solved neighbor in the
   same solver group; the service descends the economic bracket toward
   the donor's root (``dyadic_bracket``) and the lane launches with that
   verified-on-device seed (``solve_cells_lean(bracket_init=)``) —
   a wrong donor costs two cheap-end evaluations and falls back to the
   exact cold trajectory in-program.
3. **cold miss** — the lane launches with the pseudo-cold seed
   ``(r_lo, r_hi, 0)``, which the in-program verifier rejects by
   construction (``it0 = 0``), replaying the exact cold midpoint
   sequence.

Misses are micro-batched (``MicroBatcher``): flush on ``max_batch`` or
the ``max_wait_s`` deadline, padded to a fixed shape ladder (padding
lanes repeat the last real lane).  A flush is one launch of the
scenario's batched cell solver (``scn.batched_solver``, the sweep's),
on tensors on the service's ``device``: on the card every cold or near
flush runs the hand-written lane kernels (``egm_policy_grid`` and
``stationary_lottery_grid``, or ``fused_cell_grid`` under
``kernel="fused"``), and no plain version runs on a CUDA tensor.

Correctness contract (``tests/test_torch_serve.py``): the kernels are
lane-independent, so a served lane equals a batch-of-1 launch of the
same solver with the same seed in every packed field, bit for bit,
whatever its batchmates and padding.  A failed (NONFINITE/MAX_ITER)
cell raises a typed ``EquilibriumSolveFailed`` on its own future and is
never cached; its batchmates' bits are untouched.  Against the JAX
service the answers agree to the solver's tolerance, not bitwise.

The store's keys fold in the port's ``PACKAGE_TOKEN``: an entry written
by the JAX package (same directory layout, same work-fingerprint group)
is never served as an exact hit here; it can only donate a warm seed,
which the port's kernels verify on the device.

Resilience: every launch runs under ``retry_transient`` (transient
device/RPC faults retried on the deterministic backoff schedule; numeric
failure never retried here), and the worker polls
``resilience.interrupt_requested`` at batch seams — inside a
``preemption_guard`` a SIGTERM drains by *failing* pending futures with
the typed ``Interrupted`` instead of leaving callers hung.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from concurrent.futures import Future
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..obs.runtime import resolve_obs
from ..solver_health import (
    CIRCUIT_OPEN,
    DEADLINE_EXCEEDED,
    LOAD_SHED,
    OVERLOADED,
    SolverDivergenceError,
    is_failure,
    status_name,
)
from ..utils.fingerprint import (
    PACKAGE_TOKEN,
    canonical_dtype,
    config_fingerprint,
    hashable_kwargs,
    solution_fingerprint,
    work_fingerprint,
)
from ..utils.resilience import (
    Interrupted,
    RetryPolicy,
    interrupt_requested,
    retry_transient,
)
from .batcher import MicroBatcher, ServeQueueFull  # noqa: F401  (re-export)
from .metrics import ServeMetrics
from .overload import CircuitBreaker, Priority, predicted_work
from .store import UNCERTIFIED, SolutionStore, make_solution
from .surrogate import SurrogatePolicy, fit_surrogate

# Queue-depth histogram buckets for the obs registry:
# powers of two spanning "empty" to the default max_queue.
_DEPTH_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                  256.0, 512.0, 1024.0)


def _torch_dtype(dtype) -> torch.dtype:
    """The torch dtype a query's canonical numpy dtype launches in."""
    return torch.float64 if np.dtype(dtype) == np.float64 else torch.float32


def _scenario_of(name: str):
    """Resolve a query's scenario bundle (registry dict lookup — cheap
    enough for the submit hot path; ``make_query`` already validated)."""
    from ..scenarios.registry import get_scenario

    return get_scenario(name)


class ServeError(RuntimeError):
    """Base of the serving layer's typed errors."""


class ServiceClosed(ServeError):
    """submit() after close(): the service no longer accepts queries."""


class EquilibriumSolveFailed(SolverDivergenceError):
    """One query's solve exited with a failure status (NONFINITE /
    MAX_ITER).  Raised on that query's future only — batchmates are
    unaffected.  Subclasses ``SolverDivergenceError`` so the resilience
    layer's never-retry-numeric-failure rule applies to it by type."""

    def __init__(self, cell, status: int, key: int):
        super().__init__(
            f"equilibrium query (σ={cell[0]:g}, ρ={cell[1]:g}, "
            f"sd={cell[2]:g}) failed with status "
            f"{status_name(status)}", status=status)
        self.cell = tuple(cell)
        self.key = int(key)


class DeadlineExceeded(ServeError):
    """A query's deadline expired before its batch launched: the pending
    future fails typed at the next batch seam instead of waiting
    indefinitely.  ``status`` is the
    process-level ``solver_health.DEADLINE_EXCEEDED`` code; counted in
    ``ServeMetrics`` as ``serve_deadline_expirations``."""

    def __init__(self, cell, key: int, waited_s: float):
        super().__init__(
            f"equilibrium query (σ={cell[0]:g}, ρ={cell[1]:g}, "
            f"sd={cell[2]:g}) missed its deadline after waiting "
            f"{waited_s:.3f}s")
        self.status = DEADLINE_EXCEEDED
        self.cell = tuple(cell)
        self.key = int(key)
        self.waited_s = float(waited_s)


class Overloaded(ServeError):
    """Admission control rejected this query FAIL-FAST at submit
    (DESIGN §11): the weighted queue occupancy exceeded the
    ``AdmissionPolicy`` budget for its priority class
    (``reason="class_budget"``), the query's deadline could not be met
    given the estimated wait (``reason="deadline_unmeetable"``), or the
    bounded queue itself was full (``reason="queue_full"``).

    Carries the retry-after payload: ``depth`` (queued requests),
    ``max_queue``, and ``est_wait_s`` (queued batches ahead x recent
    batch latency — also aliased ``retry_after_s``).  ``status`` is the
    process-level ``solver_health.OVERLOADED`` code."""

    def __init__(self, cell, key: int, depth: int, max_queue: int,
                 est_wait_s: float, reason: str, priority: int = 0):
        super().__init__(
            f"equilibrium query (σ={cell[0]:g}, ρ={cell[1]:g}, "
            f"sd={cell[2]:g}) rejected: service overloaded ({reason}; "
            f"depth {depth}/{max_queue}, estimated wait "
            f"{est_wait_s:.3f}s)")
        self.status = OVERLOADED
        self.cell = tuple(cell)
        self.key = int(key)
        self.depth = int(depth)
        self.max_queue = int(max_queue)
        self.est_wait_s = float(est_wait_s)
        self.retry_after_s = float(est_wait_s)
        self.reason = str(reason)
        self.priority = int(priority)


class LoadShed(ServeError):
    """A queued pending was displaced by a higher-priority arrival under
    pressure: its future fails with this typed error instead
    of silently losing its slot.  ``priority`` is the shed query's own
    class, ``waited_s`` how long it sat queued, ``displaced_by`` the
    displacing query's solution fingerprint.  ``status`` is the
    process-level ``solver_health.LOAD_SHED`` code."""

    def __init__(self, cell, key: int, priority: int, waited_s: float,
                 displaced_by: Optional[int] = None):
        super().__init__(
            f"equilibrium query (σ={cell[0]:g}, ρ={cell[1]:g}, "
            f"sd={cell[2]:g}) shed from the queue after {waited_s:.3f}s "
            f"by a higher-priority arrival")
        self.status = LOAD_SHED
        self.cell = tuple(cell)
        self.key = int(key)
        self.priority = int(priority)
        self.waited_s = float(waited_s)
        self.displaced_by = displaced_by


class CircuitOpen(ServeError):
    """This query's (σ, ρ, sd) region has an OPEN circuit breaker after
    repeated solve/certification failures: fast-failed at
    submit without occupying a queue slot or burning a solve.
    ``region`` is the quantized breaker key, ``retry_after_s`` the clock
    time until the region's next half-open probe window.  ``status`` is
    the process-level ``solver_health.CIRCUIT_OPEN`` code."""

    def __init__(self, cell, key: int, region: tuple,
                 retry_after_s: float):
        super().__init__(
            f"equilibrium query (σ={cell[0]:g}, ρ={cell[1]:g}, "
            f"sd={cell[2]:g}) fast-failed: circuit open for region "
            f"{region} (probe in {retry_after_s:.3f}s)")
        self.status = CIRCUIT_OPEN
        self.cell = tuple(cell)
        self.key = int(key)
        self.region = tuple(region)
        self.retry_after_s = float(retry_after_s)


class CertificationFailed(ServeError):
    """A cold-miss solution FAILED a posteriori certification under
    ``certify_before_cache`` (DESIGN §9): the future fails typed with the
    full ``verify.Certificate`` attached, and the solution is NEVER
    written to the store — an uncertifiable answer must not become a
    cache hit."""

    def __init__(self, cell, key: int, certificate):
        super().__init__(
            f"equilibrium query (σ={cell[0]:g}, ρ={cell[1]:g}, "
            f"sd={cell[2]:g}) failed certification: "
            f"{certificate.summary()}")
        self.cell = tuple(cell)
        self.key = int(key)
        self.certificate = certificate


class EquilibriumQuery(NamedTuple):
    """One canonicalized equilibrium request.

    Build with ``make_query`` (which canonicalizes dtype and kwargs);
    equality of two queries' ``key()`` is exactly "every input that can
    move a bit of the answer matches" — the SCENARIO (model family)
    included: a huggett query can never address an aiyagari
    entry at numerically identical parameters.  ``fault_iter`` is the
    deterministic fault-injection hook (tests only; requires the service
    to be constructed with ``inject_fault_mode``): faulted queries bypass
    the cache on both read and write."""

    crra: float
    labor_ar: float
    labor_sd: float
    dtype: np.dtype             # canonical numpy twin of the torch dtype
    kwargs: tuple
    fault_iter: Optional[int] = None
    # overload layer: the priority class (serve.Priority —
    # INTERACTIVE=0 > BATCH=1 > SPECULATIVE=2) admission budgets and
    # shedding key on, and the opt-in degraded-answer consent.  Neither
    # enters key()/group(): the same calibration at any priority
    # addresses the same cached solution.
    priority: int = Priority.INTERACTIVE
    degraded_ok: bool = False
    # the registered model family: part of key() AND group(),
    # so launches, store entries, donor groups, and breaker regions
    # are all per-scenario.  The field names above keep their historical
    # Aiyagari spellings; for another family read them as the scenario's
    # first/second/third cell coordinates.
    scenario: str = "aiyagari"
    # surrogate opt-out: ``False`` forces a genuine solve on
    # a service running with a SurrogatePolicy — lattice warmup and
    # golden replays must not be answered by interpolation over the
    # cells they are trying to solve.  Never enters key()/group().
    surrogate_ok: bool = True

    def cell(self) -> Tuple[float, float, float]:
        return (self.crra, self.labor_ar, self.labor_sd)

    def key(self) -> int:
        return _query_key(self.crra, self.labor_ar, self.labor_sd,
                          self.kwargs, self.dtype, self.scenario)

    def group(self) -> int:
        return _query_group(self.kwargs, self.dtype, self.scenario)


@functools.lru_cache(maxsize=65536)
def _query_key(crra, labor_ar, labor_sd, kwargs, dtype, scenario) -> int:
    """Memoized ``EquilibriumQuery.key()``: the ``solution_fingerprint``
    with ``PACKAGE_TOKEN`` folded in, so an entry the JAX package wrote
    under its own key is never an exact hit here (it stays a donor: the
    group, ``work_fingerprint``, is shared).  Memoized because the serve
    path asks for it several times per submit (store probe, surrogate
    tag, journal attrs)."""
    return config_fingerprint(
        PACKAGE_TOKEN, solution_fingerprint(crra, labor_ar, labor_sd,
                                            kwargs, dtype,
                                            scenario=scenario))


@functools.lru_cache(maxsize=4096)
def _query_group(kwargs, dtype, scenario) -> int:
    return work_fingerprint(kwargs, dtype, scenario=scenario)


def make_query(crra: float, labor_ar: float, labor_sd: float = 0.2,
               dtype=None, fault_iter: Optional[int] = None,
               priority: int = Priority.INTERACTIVE,
               degraded_ok: bool = False, scenario: str = "aiyagari",
               surrogate_ok: bool = True,
               **model_kwargs) -> EquilibriumQuery:
    """Canonicalize one request: dtype to the concrete compute dtype
    (``dtype=None`` and the explicit default address the same solution),
    kwargs to the sorted hashable items every fingerprint hashes.
    ``priority``/``degraded_ok`` are the overload-layer knobs;
    they shape admission, never the answer's bits.  ``scenario`` names
    the registered model family — validated HERE, so a typo
    raises the typed ``scenarios.UnknownScenarioError`` at build time
    instead of silently addressing a fresh cache namespace.

    ``precision`` and ``grid`` policy kwargs ride ``model_kwargs`` and
    are validated/canonicalized by ``hashable_kwargs`` (explicit
    defaults dropped — the no-drift pin; unknown policies raise here at
    build time): a ``grid="compact"`` query therefore keys its OWN
    store entries and donor groups — a compacted solution can never be
    served for a reference query or vice versa (DESIGN §5b).

    ``dtype`` is a torch or numpy float dtype, held as its numpy twin
    (``utils.fingerprint.canonical_dtype``); ``None`` is the port's
    default, float32 (``device.resolve_dtype``)."""
    from ..scenarios.registry import get_scenario

    priority = int(priority)
    if not 0 <= priority <= Priority.SPECULATIVE:
        raise ValueError(
            f"priority must be one of serve.Priority "
            f"(0..{Priority.SPECULATIVE}), got {priority}")
    scn = get_scenario(scenario)
    dt = canonical_dtype(dtype)
    if dt not in (np.float32, np.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype!r}")
    return EquilibriumQuery(
        crra=float(crra), labor_ar=float(labor_ar),
        labor_sd=float(labor_sd), dtype=dt,
        kwargs=hashable_kwargs(model_kwargs),
        fault_iter=None if fault_iter is None else int(fault_iter),
        priority=priority, degraded_ok=bool(degraded_ok),
        scenario=scn.name, surrogate_ok=bool(surrogate_ok))


class ServedResult(NamedTuple):
    """One resolved query.  Scalars are host Python numbers (float64
    holds every compute dtype exactly; counters exact — values ≪ 2^24).

    ``bracket_init`` is the exact ``(lo, hi, levels)`` seed the lane
    launched with (``None`` for a cache hit) — passing it to a direct
    ``solve_cells_lean(bracket_init=)`` call reproduces the served
    bits; ``path`` records which serving path produced the numbers."""

    r_star: float
    capital: float
    labor: float
    bisect_iters: int
    egm_iters: int
    dist_iters: int
    status: int
    path: str                       # "hit" | "near" | "cold"
    bracket_init: Optional[tuple]   # (lo, hi, levels) launched with
    key: int                        # solution_fingerprint
    descent_steps: int = 0          # precision-ladder cheap-phase steps
    polish_steps: int = 0           # reference-phase steps (== the total
    #                                 under precision="reference")
    precision_escalations: int = 0  # ladder descent→reference fallbacks
    #                                 (solver_health.PRECISION_ESCALATED)
    cert_level: Optional[int] = None  # verify certificate verdict
    #   (CERTIFIED/MARGINAL; None = this solution was never certified —
    #   FAILED certificates raise CertificationFailed instead)
    quality: str = "exact"          # "exact" | "degraded_neighbor"
    #   a degraded answer is ALWAYS tagged — the numbers are
    #   a nearby calibration's, served under pressure, never cached as
    #   this query's exact solution
    degraded_distance: Optional[float] = None  # normalized (σ,ρ,sd)
    #   distance to the donor (degraded answers only)
    donor_key: Optional[int] = None  # the donor's solution fingerprint
    #   (degraded answers only)
    # scenario layer: which model family answered, plus the
    # FULL packed row under its named fields — the Aiyagari-shaped
    # accessors above stay (NaN/0 where a family lacks the field), and
    # ``value("net_demand")`` reads any scenario-specific column.
    scenario: str = "aiyagari"
    fields: tuple = ()
    values: tuple = ()
    # surrogate tier (DESIGN §15): an off-lattice answer
    # interpolated over the k nearest certified stored solutions is
    # ALWAYS tagged ``quality="surrogate"`` with its model-implied
    # |error| bound (r* units) and the donor fingerprints — never
    # cached, never served untagged
    surrogate_error_bound: Optional[float] = None
    donor_keys: Optional[tuple] = None

    def value(self, name: str) -> float:
        """One named packed-row field of the answering scenario."""
        return self.values[self.fields.index(name)]


def _result_from_row(schema, row: np.ndarray, path: str, bracket_init,
                     key: int, cert_level=None,
                     scenario: str = "aiyagari") -> ServedResult:
    def g(name):
        return (float(row[schema.idx(name)]) if schema.has(name)
                else float("nan"))

    def gi(name):
        return (int(np.rint(row[schema.idx(name)])) if schema.has(name)
                else 0)

    c_bisect, c_egm, c_dist = schema.counters
    ph = schema.phases
    return ServedResult(
        r_star=float(row[schema.idx(schema.root)]),
        capital=g("capital"), labor=g("labor"),
        bisect_iters=gi(c_bisect), egm_iters=gi(c_egm),
        dist_iters=gi(c_dist),
        status=int(np.rint(row[schema.idx(schema.status)])),
        path=path, bracket_init=bracket_init, key=int(key),
        descent_steps=gi(ph[0]) if ph else 0,
        polish_steps=gi(ph[1]) if ph else 0,
        precision_escalations=gi(ph[2]) if ph else 0,
        cert_level=cert_level, scenario=scenario,
        fields=tuple(schema.fields),
        values=tuple(float(v) for v in np.asarray(row)))


class _Pending(NamedTuple):
    query: EquilibriumQuery
    future: Future
    t_submit: float
    deadline: Optional[float] = None   # absolute clock-units expiry
    weight: float = 0.0                # predicted-work occupancy units
    region: Optional[tuple] = None     # breaker region (admission on)
    probe: bool = False                # this pending IS a half-open probe
    refine: str = ""                   # surrogate-escalation reason
    #   non-empty marks this cold solve as a parameter-space
    #   refinement point — journaled LATTICE_REFINED after publish


class EquilibriumService:
    """Micro-batched equilibrium query engine over a content-addressed
    solution store (module docstring for the architecture).

    ``start_worker=True`` (default) runs a daemon worker thread draining
    the batcher — production mode; ``submit`` returns immediately and
    futures resolve asynchronously.  ``start_worker=False`` is the
    deterministic test mode: nothing launches until ``pump()`` (due
    batches at the injected clock) or ``flush()`` (everything, now).

    ``inject_fault_mode`` ("nan"/"stall") arms the deterministic
    fault-injection hook of the service's launches (tests only);
    per-query ``fault_iter`` then selects the poisoned lanes, exactly as
    ``run_table2_sweep(inject_fault=)`` does for the batch path.

    Integrity (DESIGN §9): ``certify_before_cache=True`` runs a
    posteriori certification (``verify.certify_equilibrium`` recompute
    path, thresholds from ``cert_thresholds`` or the configuration-scaled
    defaults) on every solved cold miss BEFORE the store sees it — a
    FAILED certificate raises ``CertificationFailed`` on that future and
    the solution is never cached; CERTIFIED/MARGINAL verdicts ride
    ``ServedResult.cert_level`` and the store entry.
    ``inject_corrupt_lane={"at_launch": k, "lane": j, "field": f,
    "amplitude": a}`` deterministically corrupts one solved lane of the
    k-th launch post-solve, pre-certification (tests only) — the serve
    path's silent-data-corruption drill.

    ``device``: where every launch runs (``device.resolve_device``:
    ``None`` is the card, and raises without one unless ``"cpu"`` is
    asked for).  A CUDA device without an index is pinned here to the
    device current in the constructing thread, so the worker thread
    launches on that card, whatever device is current in its own thread.

    Not ported (the JAX service's multi-chip serving): a ``mesh`` other
    than ``None`` and ``state_shards > 1`` raise ``NotImplementedError``
    (ROADMAP Queue 1 item 6) before the constructor takes any resource;
    JAX's ``mesh_axis`` lands with them."""

    def __init__(self, store: Optional[SolutionStore] = None,
                 capacity: int = 256, disk_path: Optional[str] = None,
                 donor_cutoff: float = float("inf"),
                 max_batch: int = 8, max_wait_s: float = 0.002,
                 max_queue: int = 1024,
                 ladder: Optional[Tuple[int, ...]] = None,
                 retry: Optional[RetryPolicy] = None,
                 inject_fault_mode: Optional[str] = None,
                 clock=time.monotonic, start_worker: bool = True,
                 metrics: Optional[ServeMetrics] = None,
                 certify_before_cache: bool = False,
                 cert_thresholds=None,
                 inject_corrupt_lane: Optional[dict] = None,
                 obs=None, admission=None,
                 mesh=None, state_shards: int = 1,
                 prefetch_k: int = 0, prefetch_cells=None,
                 fleet_poll_s: float = 0.005,
                 surrogate=None, device=None):
        # The unported multi-chip arguments are refused FIRST, before
        # this constructor acquires anything that needs closing (an
        # owned obs bundle, the store's disk handle).
        if mesh is not None:
            raise NotImplementedError(
                f"EquilibriumService(mesh={mesh!r}): multi-device serving "
                "is not ported yet (ROADMAP Queue 1 item 6); serve with "
                "mesh=None")
        if int(state_shards) > 1:
            raise NotImplementedError(
                f"EquilibriumService(state_shards={int(state_shards)}): "
                "state-axis sharding is not ported yet (ROADMAP Queue 1 "
                "item 6); serve with state_shards=1")
        self._device = resolve_device(device)
        if self._device.type == "cuda" and self._device.index is None:
            self._device = torch.device("cuda",
                                        torch.cuda.current_device())
        # Observability (DESIGN §10): an ObsConfig builds a
        # bundle owned (and closed) by this service; a shared Obs
        # correlates serving with a caller's wider run.  The store
        # adopts the same scope so eviction events land in one journal.
        # NOTE: resolve BEFORE the store so a store built here sees it.
        self._obs, self._obs_owned = resolve_obs(obs)
        self.store = (store if store is not None
                      else SolutionStore(capacity=capacity,
                                         disk_path=disk_path,
                                         donor_cutoff=donor_cutoff,
                                         obs=self._obs))
        self.store.attach_obs(self._obs)
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.metrics.attach_store(self.store.integrity_counts)
        self.metrics.attach_fleet(self.store.fleet_counts)
        # Fleet tier (DESIGN §14): a SHARED store turns every
        # cold-miss launch into a claim/publish election — N worker
        # processes over one disk directory solve each distinct
        # fingerprint exactly once; claim losers poll for the winner's
        # publish (``fleet_poll_s`` real-time cadence — the peer is
        # another PROCESS, no injected clock crosses that boundary).
        self._fleet = bool(getattr(self.store, "shared", False))
        self._fleet_poll_s = float(fleet_poll_s)
        # Speculative neighbor prefetch: on a miss, enqueue
        # up to ``prefetch_k`` nearest UNSOLVED lattice neighbors (from
        # ``prefetch_cells``, normalized CellSpace distance, same solver
        # group) at Priority.SPECULATIVE — sheddable by construction
        # under load, so prefetch can never displace interactive
        # work.  Conversion accounting: keys whose stored solution came
        # from a speculative solve convert to "prefetch hits" when a
        # later exact hit addresses them.
        self._prefetch_k = int(prefetch_k)
        self._prefetch_cells = (None if prefetch_cells is None else
                                [tuple(float(x) for x in c)
                                 for c in prefetch_cells])
        if self._prefetch_k > 0 and not self._prefetch_cells:
            raise ValueError(
                "prefetch_k > 0 requires prefetch_cells: the prefetcher "
                "needs a lattice to pick neighbors from")
        self._prefetch_lock = threading.Lock()
        self._prefetch_issued_keys: set = set()
        self._prefetch_stored: set = set()
        # Lattice-neighbor enumeration rides the SAME CellIndex seam the
        # store's donor search uses: the prefetch lattice is
        # indexed once here, and _maybe_prefetch asks it for the nearest
        # ring instead of re-ranking the whole lattice per miss.
        self._prefetch_index = None
        if self._prefetch_cells:
            from .cellindex import CellIndex

            self._prefetch_index = CellIndex()
            for i, c in enumerate(self._prefetch_cells):
                self._prefetch_index.add(i, c, group=0, r_star=0.0,
                                         cert_level=UNCERTIFIED)
        # Surrogate tier (DESIGN §15): a SurrogatePolicy
        # answers off-lattice misses by local interpolation over the k
        # nearest CERTIFIED stored solutions; None (default) disables
        # the tier — behavior and served bits identical to the
        # pre-surrogate engine.  The audit rng is the policy's seeded
        # escalation sampler; _audit_pending maps an escalated key to
        # the surrogate prediction the real solve must be checked
        # against (resolved in _launch_impl, a-posteriori).
        if surrogate is not None and not isinstance(surrogate,
                                                    SurrogatePolicy):
            raise TypeError(
                f"surrogate must be a serve.SurrogatePolicy or None, "
                f"got {type(surrogate).__name__}")
        self._surrogate = surrogate
        self._audit_lock = threading.Lock()
        self._audit_rng = (np.random.default_rng(surrogate.audit_seed)
                           if surrogate is not None else None)
        self._audit_pending: dict = {}
        self._certify = bool(certify_before_cache)
        self._cert_thresholds = cert_thresholds
        self._corrupt_lane = (dict(inject_corrupt_lane)
                              if inject_corrupt_lane is not None else None)
        self._launch_count = 0
        self.batcher = MicroBatcher(max_batch=max_batch,
                                    max_wait_s=max_wait_s,
                                    max_queue=max_queue, ladder=ladder,
                                    clock=clock,
                                    priority_of=lambda p: p.query.priority)
        # Overload layer (DESIGN §11): an AdmissionPolicy turns
        # saturation into typed, observable behavior — weighted
        # per-class occupancy with fail-fast Overloaded rejection,
        # priority shedding, degraded neighbor answers past the pressure
        # threshold, and per-region circuit breakers.  None (default)
        # disables the whole layer: behavior and served bits are
        # identical to the pre-overload engine.
        self._admission = admission
        self.breaker = (CircuitBreaker.from_policy(admission)
                        if admission is not None else None)
        self._occ_lock = threading.Lock()
        self._occupancy: dict = {}       # priority class -> queued work
        self._batch_ewma_s: Optional[float] = None   # recent batch wall
        self._retry = retry if retry is not None else RetryPolicy()
        self._fault_mode = inject_fault_mode
        self._clock = clock
        self._closed = False
        self._drain_on_close = True
        self._launch_lock = threading.Lock()
        # serializes submit's closed-check+enqueue against close's
        # closed-set+drain, so a request can never slip into the batcher
        # after the final drain (its future would hang forever)
        self._gate = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        if start_worker:
            self._worker = threading.Thread(target=self._worker_loop,
                                            name="equilibrium-serve",
                                            daemon=True)
            self._worker.start()

    # -- client surface -----------------------------------------------------

    def submit(self, q: EquilibriumQuery,
               deadline: Optional[float] = None,
               _prefetch: bool = False) -> Future:
        """Enqueue one query; returns a future resolving to a
        ``ServedResult`` (or raising ``EquilibriumSolveFailed`` /
        ``DeadlineExceeded`` / ``LoadShed`` / ``Interrupted``).  Exact
        cache hits resolve before returning — and BYPASS the overload
        layer entirely: a hit is a dict lookup, it must stay
        microseconds even at 100% cold-miss saturation.

        ``deadline`` (seconds from now, clock units): an
        already-expired deadline (<= 0) rejects IMMEDIATELY with the
        typed ``DeadlineExceeded`` (it never wastes
        a queue slot; counted apart from seam expirations); a pending
        whose deadline expires before its batch launches fails at the
        next batch seam — the SLO primitive.

        With an ``AdmissionPolicy`` a miss additionally runs
        the overload gauntlet fail-fast, in order: regional circuit
        breaker (``CircuitOpen``), degraded answer for opted-in queries
        past the pressure threshold, deadline-aware admission and
        per-class weighted occupancy (``Overloaded`` with retry-after,
        possibly displacing a lower-priority pending with ``LoadShed``)."""
        if self._closed:
            raise ServiceClosed("EquilibriumService is closed")
        if q.fault_iter is not None and self._fault_mode is None:
            raise ValueError(
                "query carries fault_iter but the service was built "
                "without inject_fault_mode")
        t0 = self._clock()
        fut: Future = Future()
        scn = _scenario_of(q.scenario)
        if q.fault_iter is None:
            sol = self.store.get(q.key(),
                                 schema_ck=scn.schema.checksum())
            if sol is not None:
                lvl = int(sol.cert_level)
                res = _result_from_row(
                    scn.schema, np.asarray(sol.packed), "hit", None,
                    q.key(), cert_level=None if lvl == UNCERTIFIED
                    else lvl, scenario=scn.name)
                latency = self._clock() - t0
                self.metrics.record_served("hit", latency,
                                           scenario=scn.name)
                self._note_prefetch_hit(q.key())
                self._obs.record_span("serve/query", latency,
                                      path="hit", cell=q.cell(),
                                      scenario=scn.name)
                fut.set_result(res)
                return fut
        if deadline is not None and float(deadline) <= 0.0:
            self.metrics.record_deadline_reject()
            self._obs.event("DEADLINE_EXCEEDED", cell=q.cell(),
                            scenario=q.scenario,
                            key=q.key(), waited_s=0.0, where="submit")
            self._obs.counter(
                "aiyagari_serve_deadline_rejects_total",
                "queries rejected at submit on an expired or "
                "unmeetable deadline").inc()
            raise DeadlineExceeded(q.cell(), q.key(), 0.0)
        # Surrogate tier: a miss with a SurrogatePolicy is
        # answered by local interpolation over stored certified
        # neighbors — microseconds, before the overload gauntlet, like
        # the exact hit above.  A None return with a reason ESCALATES:
        # the query falls through to a genuine cold solve whose publish
        # is journaled as a lattice refinement point.
        esc_reason = ""
        if (self._surrogate is not None and q.surrogate_ok
                and not _prefetch and q.fault_iter is None
                and q.priority != Priority.SPECULATIVE):
            res, esc_reason = self._surrogate_answer(q, t0)
            if res is not None:
                fut.set_result(res)
                return fut
        adm = self._admission
        region = None
        probe = False
        weight = 0.0
        if adm is not None:
            region = self.breaker.region_key(q.cell(), q.group())
            verdict = self.breaker.admit(region, t0)
            if verdict == "open":
                retry_after = self.breaker.retry_after(region, t0)
                self.metrics.record_circuit_reject()
                self._obs.event("CIRCUIT_REJECT", cell=q.cell(),
                                scenario=q.scenario,
                                key=q.key(), region=list(region),
                                retry_after_s=round(retry_after, 6))
                self._obs.counter(
                    "aiyagari_serve_circuit_rejects_total",
                    "queries fast-failed on an open regional "
                    "breaker").inc()
                raise CircuitOpen(q.cell(), q.key(), region, retry_after)
            if verdict == "probe":
                probe = True
                self.metrics.record_breaker("probe")
                self._obs.event("CIRCUIT_PROBE", cell=q.cell(),
                                scenario=q.scenario,
                                key=q.key(), region=list(region))
        acquired = False
        try:
            if adm is not None:
                if (q.degraded_ok and not probe
                        and self._pressure() >= adm.degraded_pressure):
                    res = self._degraded_answer(q, t0)
                    if res is not None:
                        fut.set_result(res)
                        return fut
                weight = predicted_work(q.cell(), scenario=q.scenario)
                # EWMA cold start: before the first
                # flush there is no measured batch latency, so seed from
                # this query's own predicted wall — the first rejection's
                # retry-after is finite and solve-scaled instead of
                # collapsing to the batcher's millisecond max_wait_s
                if adm.est_batch_s is None and self._batch_ewma_s is None:
                    self._batch_ewma_s = max(self.batcher.max_wait_s,
                                             weight * adm.work_unit_s)
                est_wait = self._estimate_wait()
                if (adm.deadline_aware and deadline is not None
                        and float(deadline) < est_wait):
                    self._reject_overloaded(q, "deadline_unmeetable",
                                            est_wait)
                # Check + acquire under ONE lock hold, and BEFORE the
                # offer makes the pending visible to the worker:
                # concurrent submits cannot jointly overshoot the
                # budget, and a fast worker pop cannot release (clamped
                # at zero) ahead of the acquire and leak the weight.
                if not self._try_acquire(q.priority, weight):
                    if adm.shed:
                        self._shed_for(q, t0, weight)
                    if not self._try_acquire(q.priority, weight):
                        self._reject_overloaded(q, "class_budget",
                                                est_wait)
                acquired = True
            expiry = None if deadline is None else t0 + float(deadline)
            pending = _Pending(q, fut, t0, expiry, weight=weight,
                               region=region, probe=probe,
                               refine=esc_reason)
            # Enqueue under the gate: without it a close() between the
            # closed-check above and the offer could run its final drain
            # first, stranding this future.  The worker drains the
            # batcher without taking the gate, so a blocking offer (full
            # queue) cannot deadlock close().  Admission mode never
            # blocks: the bounded queue translates to the typed
            # fail-fast Overloaded.
            with self._gate:
                if self._closed:
                    raise ServiceClosed("EquilibriumService is closed")
                try:
                    # batch groups are per (scenario, dtype, kwargs):
                    # one executable family per model family;
                    # a prefetch submit never blocks — best-effort by
                    # construction, a full queue suppresses it
                    self.batcher.offer(
                        (q.scenario, q.dtype, q.kwargs), pending,
                        block=(self._worker is not None and adm is None
                               and not _prefetch))
                except ServeQueueFull:
                    if adm is None:
                        raise
                    self._reject_overloaded(q, "queue_full",
                                            self._estimate_wait())
        except BaseException:
            # No rejection path may leak overload state: acquired weight
            # is returned, and a half-open probe's region goes back to
            # OPEN — a stuck probing flag would pin the breaker open
            # forever (every admit short-circuits on it).
            if acquired:
                self._release(q.priority, weight)
            if probe:
                self.breaker.abort_probe(region)
            raise
        self._observe_depth(self.batcher.depth())
        if (self._prefetch_k > 0 and not _prefetch
                and q.priority != Priority.SPECULATIVE
                and q.fault_iter is None):
            self._maybe_prefetch(q)
        return fut

    # -- speculative neighbor prefetch ---------------------------

    def _maybe_prefetch(self, q: EquilibriumQuery) -> None:
        """Enqueue the K nearest UNSOLVED lattice neighbors of a missed
        query as Priority.SPECULATIVE submits (asymptotic linearity in
        (σ, ρ, sd)-space makes neighbor locality real — PAPERS
        2002.09108): a hot region's surroundings get solved before they
        are asked for, converting future cold misses into exact hits.
        Best-effort by construction: an overloaded/full-queue rejection
        suppresses the issue (counted) and NEVER surfaces to the
        triggering caller — and SPECULATIVE pendings are the first shed
        under pressure, so prefetch cannot displace interactive work."""
        scn = _scenario_of(q.scenario)
        if self._prefetch_index is None:
            return
        # nearest ring from the CellIndex — the same seam
        # the store's donor search answers through, so prefetch stops
        # re-ranking the whole lattice per miss; keys/fingerprints stay
        # LAZY and only for the nearest few (hashing a key per lattice
        # cell per miss would make prefetch O(lattice) on the serving
        # path).  Ties and ordering are bitwise the old linear scan's:
        # (normalized distance, lattice insertion order), with the
        # query's own cell skipped post-hoc.
        attempts = 0
        scanned = 0
        scan_cap = max(4 * self._prefetch_k, 16)
        with self._prefetch_lock:
            near = self._prefetch_index.nearest_k(
                q.cell(), 0, scan_cap + 1, scale=scn.cells.scale)
        for idx, dist in near:
            # K bounds ATTEMPTS, not successes: under pressure the
            # admission layer rejects the speculative class wholesale,
            # and probing the entire lattice about it helps nobody.
            # The scan cap bounds the already-solved skips the same way
            # — past the nearest handful, cells are not "neighbors".
            if attempts >= self._prefetch_k or scanned >= scan_cap:
                break
            cell = self._prefetch_cells[int(idx)]
            if cell == q.cell():
                continue
            scanned += 1
            nq = q._replace(crra=cell[0], labor_ar=cell[1],
                            labor_sd=cell[2],
                            priority=Priority.SPECULATIVE,
                            degraded_ok=False)
            key = nq.key()
            with self._prefetch_lock:
                if key in self._prefetch_issued_keys:
                    continue
                already = self.store.contains(key)
                if not already:
                    self._prefetch_issued_keys.add(key)
            if already:
                continue
            attempts += 1
            try:
                self.submit(nq, _prefetch=True)
            except (ServeError, ServeQueueFull):
                # best-effort: under pressure the speculative class is
                # exactly what admission exists to reject — allow a
                # later retrigger for this key
                with self._prefetch_lock:
                    self._prefetch_issued_keys.discard(key)
                self.metrics.record_prefetch_suppressed()
                continue
            self.metrics.record_prefetch_issued()
            self._obs.event("PREFETCH_ISSUED", cell=list(cell),
                            scenario=q.scenario, key=key,
                            parent_cell=list(q.cell()),
                            distance=round(float(dist), 6))
            self._obs.counter(
                "aiyagari_serve_prefetch_issued_total",
                "speculative neighbor queries issued around "
                "misses").inc()

    def _note_prefetch_stored(self, key: int) -> None:
        with self._prefetch_lock:
            self._prefetch_stored.add(int(key))

    def _note_prefetch_hit(self, key: int) -> None:
        """An exact hit addressed a key a prefetch solve stored: one
        would-be cold miss converted (counted once per stored key)."""
        with self._prefetch_lock:
            if int(key) not in self._prefetch_stored:
                return
            self._prefetch_stored.discard(int(key))
        self.metrics.record_prefetch_converted()

    def prefetch_keys(self) -> list:
        """Keys this service has issued speculative queries for (the
        fleet harness's attribution hook)."""
        with self._prefetch_lock:
            return sorted(self._prefetch_issued_keys)

    def _reject_overloaded(self, q: EquilibriumQuery, reason: str,
                           est_wait: float) -> None:
        """Fail-fast admission rejection: count, journal, raise typed."""
        depth = self.batcher.depth()
        self.metrics.record_overloaded()
        self._obs.event("OVERLOADED", cell=q.cell(), key=q.key(),
                        scenario=q.scenario,
                        reason=reason, depth=depth,
                        est_wait_s=round(est_wait, 6),
                        priority=q.priority)
        self._obs.counter(
            "aiyagari_serve_overloaded_total",
            "queries rejected fail-fast by admission control").inc()
        raise Overloaded(q.cell(), q.key(), depth,
                         self.batcher.max_queue, est_wait, reason,
                         priority=q.priority)

    def _shed_for(self, q: EquilibriumQuery, now: float,
                  weight: float) -> None:
        """Priority load shedding: displace queued pendings of
        STRICTLY lower classes — least important first, youngest within
        a class — until the arrival fits its class budget or nothing
        sheddable remains.  Each displaced future fails with the typed
        ``LoadShed``; an in-flight probe among them is aborted so its
        region can probe again.  Sheds nothing when even a FULL shed of
        every lower class could not admit the arrival — a victim must
        never be killed for a query that gets rejected anyway."""
        if not self._fits_after_full_shed(q.priority, weight):
            return
        while not self._admit_class(q.priority, weight):
            shed = self.batcher.shed_lowest(max_class=q.priority)
            if shed is None:
                return
            _, p = shed
            self._release_pending(p)
            if p.probe and p.region is not None:
                self.breaker.abort_probe(p.region)
            waited = now - p.t_submit
            if not p.future.done():
                p.future.set_exception(LoadShed(
                    p.query.cell(), p.query.key(), p.query.priority,
                    waited, displaced_by=q.key()))
            self.metrics.record_shed(waited)
            self._obs.event("LOAD_SHED", cell=p.query.cell(),
                            scenario=p.query.scenario,
                            key=p.query.key(),
                            priority=p.query.priority,
                            waited_s=round(waited, 6),
                            displaced_by=q.key())
            self._obs.counter(
                "aiyagari_serve_load_sheds_total",
                "queued pendings displaced by higher-priority "
                "arrivals").inc()

    def _degraded_answer(self, q: EquilibriumQuery,
                         t0: float) -> Optional[ServedResult]:
        """The brown-out path (DESIGN §11): past the pressure
        threshold an opt-in ``degraded_ok`` query is answered from the
        store's nearest neighbor within the normalized-distance budget —
        principled because policy/aggregate objects vary smoothly-to-
        linearly in the far field (PAPERS 2002.09108), and honest
        because the result is ALWAYS tagged ``degraded_neighbor`` with
        the distance and donor fingerprint, and is never cached as this
        query's exact answer.  None when no acceptable donor exists (the
        query falls through to normal admission)."""
        adm = self._admission
        scn = _scenario_of(q.scenario)
        near = self.store.nearest(
            q.cell(), q.group(),
            require_certified=adm.degraded_require_certified,
            scale=scn.cells.scale)
        if near is None:
            return None
        donor_key, dist = near
        if dist > adm.degraded_distance:
            return None
        sol = self.store.get(donor_key, schema_ck=scn.schema.checksum())
        if sol is None:     # evicted (LRU or corrupt) since indexing
            return None
        lvl = int(sol.cert_level)
        res = _result_from_row(
            scn.schema, np.asarray(sol.packed), "degraded", None,
            q.key(), cert_level=None if lvl == UNCERTIFIED else lvl,
            scenario=scn.name)
        res = res._replace(quality="degraded_neighbor",
                           degraded_distance=float(dist),
                           donor_key=int(donor_key))
        latency = self._clock() - t0
        self.metrics.record_served("degraded", latency,
                                   scenario=scn.name)
        self._obs.event("DEGRADED_ANSWER", cell=q.cell(), key=q.key(),
                        scenario=scn.name, donor_key=int(donor_key),
                        distance=round(float(dist), 6))
        self._obs.counter(
            "aiyagari_serve_degraded_answers_total",
            "queries answered by a tagged nearest-neighbor under "
            "pressure").inc()
        self._obs.record_span("serve/query", latency, path="degraded",
                              cell=q.cell(), scenario=scn.name)
        return res

    # -- surrogate tier (DESIGN §15) ------------------------------

    def _surrogate_escalate(self, q: EquilibriumQuery, reason: str,
                            **attrs) -> str:
        """The surrogate-escalation seam (covered by
        ``check_obs_events``): a surrogate-eligible query falls through
        to a genuine cold solve — too few / too distant donors, an
        error bound over budget, or the seeded audit draw.  Returns the
        reason so ``submit`` can mark the pending as a refinement
        point."""
        self.metrics.record_surrogate_escalated(reason)
        self._obs.event("SURROGATE_ESCALATED", cell=q.cell(),
                        key=q.key(), scenario=q.scenario,
                        reason=reason, **attrs)
        self._obs.counter(
            "aiyagari_serve_surrogate_escalations_total",
            "surrogate-eligible queries escalated to a real "
            "solve").inc()
        return reason

    def _surrogate_answer(self, q: EquilibriumQuery, t0: float):
        """Answer a miss by a distance-weighted local-linear fit over
        the k nearest CERTIFIED stored solutions in normalized CellSpace
        coordinates (``surrogate.fit_surrogate`` — the ``donor_margin``
        machinery generalized to k donors).  Returns ``(result, "")``
        on a served surrogate, ``(None, reason)`` on an escalation, and
        ``(None, "")`` when the group holds nothing interpolable (a
        plain cold miss, not an escalation).

        The answer is ALWAYS tagged ``quality="surrogate"`` with its
        model-implied error bound and donor fingerprints, and is NEVER
        cached: the store continues to hold only genuinely solved
        rows.  Solver-effort counters are zeroed (no solve ran) and the
        status column is the nearest donor's — only value columns are
        interpolated through the equivalent kernel."""
        pol = self._surrogate
        scn = _scenario_of(q.scenario)
        neigh = self.store.neighbors(
            q.cell(), q.group(), k=pol.k,
            require_certified=pol.require_certified,
            scale=scn.cells.scale)
        if not neigh:
            return None, ""
        if len(neigh) < pol.min_donors:
            return None, self._surrogate_escalate(
                q, "too_few_donors", donors=len(neigh))
        d0 = float(neigh[0][2])
        if d0 > pol.max_distance:
            return None, self._surrogate_escalate(
                q, "donor_too_far", distance=round(d0, 6))
        # fetch donor rows through get() — the checksum chain re-runs,
        # so a corrupt donor drops out (and may demote this answer to
        # an escalation) instead of poisoning the fit
        schema_ck = scn.schema.checksum()
        donors = []
        for key, meta, dist in neigh:
            sol = self.store.get(key, schema_ck=schema_ck)
            if sol is not None:
                donors.append((int(key),
                               np.asarray(sol.packed, dtype=np.float64),
                               float(dist), tuple(meta.cell)))
        if len(donors) < pol.min_donors:
            return None, self._surrogate_escalate(
                q, "too_few_donors", donors=len(donors))
        floor = 0.0
        if scn.warm is not None:
            floor = 64.0 * float(
                scn.warm.host_r_tol(dict(q.kwargs), q.dtype))
        schema = scn.schema
        rows = np.stack([r for _, r, _, _ in donors])
        fit = fit_surrogate(
            q.cell(), [c for _, _, _, c in donors],
            rows[:, schema.idx(schema.root)],
            [d for _, _, d, _ in donors],
            scn.cells.scale, floor=floor,
            inflation=pol.bound_inflation)
        donor_keys = tuple(k for k, _, _, _ in donors)
        if fit.bound > pol.max_error_bound:
            return None, self._surrogate_escalate(
                q, "bound_exceeded", bound=float(fit.bound),
                budget=float(pol.max_error_bound))
        if pol.audit_fraction > 0.0:
            # seeded a-posteriori audit: escalate to a REAL solve and
            # remember the prediction; _launch_impl checks the solved
            # r* against the surrogate's own reported bound
            with self._audit_lock:
                audited = (float(self._audit_rng.random())
                           < pol.audit_fraction)
                if audited:
                    self._audit_pending[q.key()] = (
                        float(fit.r_star), float(fit.bound), donor_keys)
            if audited:
                return None, self._surrogate_escalate(
                    q, "audit", bound=float(fit.bound))
        row = fit.kernel @ rows
        # interpolated solver-effort counters are fiction — no solve
        # ran; status is taken from the nearest donor (donors are all
        # healthy stored rows, so ties in status are the norm)
        for name in tuple(schema.counters) + tuple(schema.phases or ()):
            if schema.has(name):
                row[schema.idx(name)] = 0.0
        row[schema.idx(schema.status)] = donors[0][1][
            schema.idx(schema.status)]
        res = _result_from_row(schema, row, "surrogate", None, q.key(),
                               cert_level=None, scenario=scn.name)
        res = res._replace(quality="surrogate",
                           surrogate_error_bound=float(fit.bound),
                           donor_keys=donor_keys)
        latency = self._clock() - t0
        self.metrics.record_served("surrogate", latency,
                                   scenario=scn.name)
        self.metrics.record_surrogate_bound(fit.bound)
        self._obs.event("SURROGATE_SERVED", cell=q.cell(), key=q.key(),
                        scenario=scn.name,
                        bound=float(fit.bound), donors=len(donors),
                        distance=round(d0, 6),
                        linear=bool(fit.linear))
        self._obs.counter(
            "aiyagari_serve_surrogate_total",
            "off-lattice queries answered by the certified "
            "surrogate tier").inc()
        self._obs.record_span("serve/query", latency, path="surrogate",
                              cell=q.cell(), scenario=scn.name)
        return res, ""

    # -- occupancy accounting (admission enabled) ---------------------------

    def _fits_after_full_shed(self, pclass: int, weight: float) -> bool:
        """Could the arrival fit its nested budgets if EVERY
        strictly-lower-class pending were shed?  Shedding only removes
        classes > pclass, so the hypothetical keeps just the occupancy
        of classes c..pclass in each aggregate."""
        adm = self._admission
        shares = adm.class_shares
        with self._occ_lock:
            for c in range(0, min(pclass, len(shares) - 1) + 1):
                agg = sum(w for k, w in self._occupancy.items()
                          if c <= k <= pclass)
                if agg + weight > adm.max_work * shares[c]:
                    return False
        return True

    def _try_acquire(self, pclass: int, weight: float) -> bool:
        """Atomic admit-and-acquire: the nested budget check plus the
        occupancy increment under ONE lock hold, so concurrent submits
        cannot both pass the check and jointly overshoot the budget."""
        with self._occ_lock:
            if not self._admit_class_locked(pclass, weight):
                return False
            self._occupancy[pclass] = (self._occupancy.get(pclass, 0.0)
                                       + weight)
            return True

    def _release(self, pclass: int, weight: float) -> None:
        with self._occ_lock:
            self._occupancy[pclass] = max(0.0,
                                          self._occupancy.get(pclass, 0.0)
                                          - weight)

    def _release_pending(self, p: _Pending) -> None:
        if self._admission is None:
            return
        self._release(p.query.priority, p.weight)

    def _admit_class(self, pclass: int, weight: float) -> bool:
        with self._occ_lock:
            return self._admit_class_locked(pclass, weight)

    def _admit_class_locked(self, pclass: int, weight: float) -> bool:
        """Nested per-class budgets (``_occ_lock`` held): admitting
        ``weight`` at class ``pclass`` must keep, for every class
        c <= pclass, the total occupancy of classes >= c within
        ``max_work * class_shares[c]`` — so less-important classes can
        never consume the headroom reserved for more-important ones."""
        adm = self._admission
        shares = adm.class_shares
        for c in range(0, min(pclass, len(shares) - 1) + 1):
            agg = sum(w for k, w in self._occupancy.items()
                      if k >= c)
            if agg + weight > adm.max_work * shares[c]:
                return False
        return True

    def _pressure(self) -> float:
        """Total weighted queue occupancy as a fraction of the admission
        budget — the shed/degraded trigger."""
        with self._occ_lock:
            total = sum(self._occupancy.values())
        return total / max(self._admission.max_work, 1e-12)

    def _estimate_wait(self) -> float:
        """Estimated queueing delay for a new arrival: queued batches
        ahead x recent batch latency (policy ``est_batch_s`` when
        pinned — the load harness's deterministic mode — else a
        measured EWMA, else ``max_wait_s`` before any batch ran).  The
        ``Overloaded`` retry-after and the deadline-aware admission
        bound."""
        depth = self.batcher.depth()
        if depth == 0:
            return 0.0
        adm = self._admission
        batch_s = adm.est_batch_s if adm is not None else None
        if batch_s is None:
            batch_s = (self._batch_ewma_s
                       if self._batch_ewma_s is not None
                       else self.batcher.max_wait_s)
        batches_ahead = -(-depth // self.batcher.max_batch)
        return batches_ahead * float(batch_s)

    def _observe_depth(self, depth: int) -> None:
        """Queue-depth sample (submit and pre-pop): metrics histogram +
        peak, mirrored into the obs registry histogram when enabled."""
        self.metrics.note_queue_depth(depth)
        if self._obs.enabled:
            self._obs.histogram(
                "aiyagari_serve_queue_depth",
                "queued queries sampled at submit and at batch pop",
                buckets=_DEPTH_BUCKETS).observe(float(depth))

    def query(self, crra: float, labor_ar: float, labor_sd: float = 0.2,
              dtype=None, timeout: Optional[float] = None,
              deadline: Optional[float] = None,
              scenario: str = "aiyagari",
              **model_kwargs) -> ServedResult:
        """Synchronous convenience: build the query, submit, wait.  In
        manual (no-worker) mode pending batches are flushed immediately —
        a lone synchronous caller must not wait out ``max_wait_s``."""
        fut = self.submit(make_query(crra, labor_ar, labor_sd=labor_sd,
                                     dtype=dtype, scenario=scenario,
                                     **model_kwargs),
                          deadline=deadline)
        if self._worker is None and not fut.done():
            self.flush()
        return fut.result(timeout)

    # -- launch machinery ---------------------------------------------------

    def _plan_seed(self, scn, q: EquilibriumQuery,
                   host) -> Tuple[tuple, str]:
        """The lane's bracket seed and serving path: donor descent when
        the store nominates one, the pseudo-cold seed otherwise.  A
        cold-only scenario (``scn.warm is None``) has no seed at all —
        ``host`` is None and every miss is an honest "cold"."""
        from ..parallel.sweep import dyadic_bracket

        if host is None:
            return None, "cold"
        r_lo, r_hi, r_tol, max_levels = host
        nom = self.store.nominate(q.cell(), q.group(),
                                  float(r_hi) - float(r_lo), r_tol,
                                  scale=scn.cells.scale)
        if nom is not None:
            lo, hi, lev = dyadic_bracket(r_lo, r_hi, nom.target,
                                         nom.margin, max_levels, q.dtype)
            if lev > 0:
                return (lo, hi, lev), "near"
        return (r_lo, r_hi, 0), "cold"

    def _expire_due(self, pendings) -> list:
        """The batch-seam deadline gate: fail
        every pending whose deadline has passed with the typed
        ``DeadlineExceeded`` and return the still-live remainder.  Runs
        BEFORE the launch, so an expired query never pays for (or waits
        on) a solve its caller has already abandoned."""
        now = self._clock()
        live = []
        for p in pendings:
            if p.deadline is not None and now >= p.deadline:
                if p.probe and p.region is not None:
                    # the expired pending was a half-open probe: return
                    # its region to OPEN so the next due admit re-probes
                    self.breaker.abort_probe(p.region)
                if not p.future.done():
                    p.future.set_exception(DeadlineExceeded(
                        p.query.cell(), p.query.key(), now - p.t_submit))
                self.metrics.record_expired(now - p.t_submit)
                self._obs.event("DEADLINE_EXCEEDED",
                                cell=p.query.cell(),
                                scenario=p.query.scenario,
                                key=p.query.key(),
                                waited_s=now - p.t_submit)
                self._obs.counter(
                    "aiyagari_serve_deadline_expirations_total",
                    "queries expired at a batch seam").inc()
            else:
                live.append(p)
        return live

    # -- fleet claim / await (DESIGN §14) -------------------------

    def _serve_stored(self, p: _Pending, sol, scn,
                      remote: bool = False) -> None:
        """Resolve one pending from a stored entry at a launch seam (the
        fleet gate's re-probe or a peer's awaited publish): an exact hit
        in every respect — the store's checksum and ``schema_ck``
        contracts made these bytes verifiably safe to share across
        processes."""
        lvl = int(sol.cert_level)
        res = _result_from_row(
            scn.schema, np.asarray(sol.packed), "hit", None,
            p.query.key(),
            cert_level=None if lvl == UNCERTIFIED else lvl,
            scenario=scn.name)
        now = self._clock()
        if not p.future.done():
            p.future.set_result(res)
        self.metrics.record_served("hit", now - p.t_submit,
                                   scenario=scn.name)
        if remote:
            self.metrics.record_remote_hit()
        self._note_prefetch_hit(p.query.key())
        self._obs.record_span("serve/query", now - p.t_submit,
                              path="hit", cell=p.query.cell(),
                              scenario=scn.name)

    def _fleet_gate(self, group, pendings):
        """Partition one popped batch under the claim protocol: returns
        ``(winners, waiters, dups)`` — claim winners this process
        solves, claim losers that poll for a peer's publish, and
        same-fingerprint in-batch duplicates riding their winner's lane
        (``dups[id(winner)]``).  Pendings whose fingerprint turns out
        already published (a peer solved it since submit) are served
        here and appear in neither list."""
        scenario_name, _, _ = group
        scn = _scenario_of(scenario_name)
        winners, waiters, dups = [], [], {}
        owner_by_key = {}
        for p in pendings:
            if p.query.fault_iter is not None:
                # injection bypasses the cache on read AND write, so it
                # must bypass the election too (it never publishes)
                winners.append(p)
                continue
            key = p.query.key()
            if key in owner_by_key:
                dups.setdefault(id(owner_by_key[key]), []).append(p)
                continue
            sol = self.store.get(key, schema_ck=scn.schema.checksum())
            if sol is not None:
                self._serve_stored(p, sol, scn, remote=True)
                continue
            verdict = self.store.claim(key)
            if verdict == "published":
                sol = self.store.get(key,
                                     schema_ck=scn.schema.checksum())
                if sol is not None:
                    self._serve_stored(p, sol, scn, remote=True)
                    continue
                # published-but-unreadable (evicted as corrupt between
                # probe and load): solve it ourselves — claim again,
                # falling through to winner/waiter on the outcome
                verdict = self.store.claim(key)
            if verdict == "won":
                owner_by_key[key] = p
                winners.append(p)
            else:
                waiters.append(p)
        return winners, waiters, dups

    def _fleet_release_claims(self, pendings) -> None:
        """Return every claim a failed batch holds (launch error, drain,
        interrupt): an unpublishable fingerprint must become claimable
        again immediately, not after the TTL."""
        if not self._fleet:
            return
        for p in pendings:
            if p.query.fault_iter is None:
                self.store.release(p.query.key())

    def _fleet_await(self, group, waiters) -> None:
        """Block-or-poll for claim losers: each waiter's
        fingerprint is being solved by a PEER process — poll the shared
        disk for its publish (served as an exact hit, bit-identical to
        the winner's solve by the atomic-publish + checksum chain).  A
        lease that disappears without a publish (the winner's solve
        failed, or crashed and was TTL-reclaimed) re-enqueues the waiter
        for the next flush, where the claim gate re-runs the election —
        this process may win it and solve.  Polls the preemption flag
        (typed ``Interrupted`` at this seam, the sweep's protocol) and each
        waiter's deadline; real-time polling, because the peer is
        another process no injected clock reaches."""
        from ..utils.timing import Stopwatch

        scenario_name, _, _ = group
        scn = _scenario_of(scenario_name)
        pending = list(waiters)
        budget_s = 5.0 * self.store.lease_ttl_s + 30.0
        watch = Stopwatch()
        while pending:
            if interrupt_requested():
                self._obs.event("INTERRUPTED",
                                what="fleet publish wait",
                                waiters=len(pending))
                exc = Interrupted(
                    "equilibrium service interrupted while awaiting "
                    "peer publishes; waiting queries failed at the "
                    "fleet seam")
                self._fail_futures(pending, exc)
                raise exc
            now = self._clock()
            still = []
            for p in pending:
                key = p.query.key()
                if p.deadline is not None and now >= p.deadline:
                    if not p.future.done():
                        p.future.set_exception(DeadlineExceeded(
                            p.query.cell(), key, now - p.t_submit))
                    self.metrics.record_expired(now - p.t_submit)
                    self._obs.event("DEADLINE_EXCEEDED",
                                    cell=p.query.cell(),
                                    scenario=p.query.scenario,
                                    key=key, waited_s=now - p.t_submit,
                                    where="fleet_await")
                    continue
                sol = self.store.get(key,
                                     schema_ck=scn.schema.checksum())
                if sol is not None:
                    self._serve_stored(p, sol, scn, remote=True)
                    continue
                if (not self.store.lease_present(key)
                        or self.store.reclaim_if_stale(key)):
                    # winner abandoned (failure) or crashed (stale):
                    # take over — the next flush re-runs the election
                    try:
                        self.batcher.offer(
                            (p.query.scenario, p.query.dtype,
                             p.query.kwargs), p, block=False)
                    except ServeQueueFull:
                        if not p.future.done():
                            p.future.set_exception(ServeError(
                                "fleet re-election found the queue "
                                "full; retry the query"))
                        self.metrics.record_failure(now - p.t_submit)
                    continue
                still.append(p)
            pending = still
            if pending:
                if watch.elapsed() > budget_s:
                    # backstop against a pathological lease ping-pong:
                    # fail typed rather than wedge the worker thread
                    exc = ServeError(
                        f"fleet publish wait exceeded {budget_s:.0f}s; "
                        "retry the query")
                    self._fail_futures(pending, exc)
                    return
                time.sleep(self._fleet_poll_s)

    def _launch(self, group, pendings) -> None:
        # the batch worker is a different thread from whichever run
        # built the obs bundle, and the active-scope stack is
        # per-thread: re-activate this service's bundle here so deep
        # seams without a threaded handle (``retry_transient`` backoffs)
        # journal into THIS service's run, not the worker thread's
        # (empty) scope
        with self._obs.activate():
            pendings = self._expire_due(pendings)
            if not pendings:
                return
            waiters, dups = [], {}
            if self._fleet:
                # fleet claim gate: re-probe the shared disk
                # (a peer may have published since submit), elect one
                # solver per distinct fingerprint, and split the batch
                # into claim winners (solve here), in-batch duplicates
                # (ride the winner's lane), and claim losers (poll for
                # the peer's publish after the launch)
                pendings, waiters, dups = self._fleet_gate(group,
                                                           pendings)
            try:
                if pendings:
                    self._launch_impl(group, pendings, dups)
            except BaseException as e:
                # only Interrupted escapes _launch_impl (every other
                # failure is scattered onto the batch's own futures):
                # the waiters must fail typed too before the seam
                # protocol unwinds, or their callers hang
                self._fail_futures(waiters, e)
                raise
            if waiters:
                self._fleet_await(group, waiters)

    def _device_scope(self):
        """The service's device made current for a launch: the kernels
        launch on the current device's stream, and the worker thread's
        current device is not the service's by itself."""
        if self._device.type == "cuda":
            return torch.cuda.device(self._device)
        return contextlib.nullcontext()

    def _launch_impl(self, group, pendings, dups=None) -> None:
        """Solve one flushed batch: plan seeds, pad to the ladder shape,
        launch the scenario's batched solver on the service's device,
        certify (``certify_before_cache``), scatter rows to futures
        (deadline expiry and the fleet claim gate already ran in
        ``_launch``).  ``dups`` maps a pending's id to same-fingerprint
        batchmates that ride its lane (fleet dedup).  Any launch-level
        failure fails this batch's futures (typed), never the service;
        ``Interrupted`` re-raises after failing them so the worker can
        drain."""
        if not pendings:
            return
        dups = dups if dups is not None else {}
        scenario_name, dtype, kwargs_items = group
        scn = _scenario_of(scenario_name)
        schema = scn.schema
        model_kwargs = dict(kwargs_items)
        tdt = _torch_dtype(dtype)
        host = None
        if scn.warm is not None:
            r_lo, r_hi = scn.warm.host_bracket(model_kwargs, dtype)
            host = (r_lo, r_hi,
                    scn.warm.host_r_tol(model_kwargs, dtype),
                    scn.warm.max_levels(model_kwargs))

        plans = [self._plan_seed(scn, p.query, host) for p in pendings]
        n = len(pendings)
        shape = self.batcher.pad_to(n)
        # padding lanes repeat the last real lane (identical inputs; the
        # kernels are lane-independent, so no real lane's bits move)
        lanes = list(range(n)) + [n - 1] * (shape - n)
        cells = np.asarray([pendings[i].query.cell() for i in lanes],
                           dtype=np.float64)
        seeds = ([plans[i][0] for i in lanes] if host is not None
                 else None)
        fault = None
        if self._fault_mode is not None:
            fault = [(-1 if pendings[i].query.fault_iter is None
                      else pendings[i].query.fault_iter) for i in lanes]
        fn = scn.batched_solver(tdt, kwargs_items, self._fault_mode,
                                host is not None)

        # measured cost attribution: the JAX service's ledger key (one
        # entry per scenario, flavor and ladder shape, one shard) and
        # the kernels' work model per launch, as the sweep records it
        prof = self._obs.cost_ledger
        prof_key = None
        work_of = None
        if prof is not None:
            from ..parallel.sweep import _launch_work_model

            flavor = "warm" if host is not None else "cold"
            prof_key = ("serve", scn.name,
                        work_fingerprint(kwargs_items, dtype,
                                         scenario=scn.name),
                        flavor, shape, self._fault_mode, 1)
            prof.capture(prof_key, label=f"serve/{scn.name}/{flavor}{shape}",
                         device=self._device, dtype=tdt)
            work_of = _launch_work_model(
                scn, dict(scn.prepare_kwargs(model_kwargs) or {}),
                model_kwargs, tdt)

        t_launch = self._clock()
        try:
            with self._launch_lock, self.metrics.compile, \
                    self._device_scope(), \
                    self._obs.span("serve/batch_flush", lanes=n,
                                   shape=shape, scenario=scn.name,
                                   device_profile=True) as bsp:
                # the rows reach the host inside the call (one transfer),
                # so the wall ends with the device's work
                packed = retry_transient(
                    lambda: fn(cells, self._device, seeds, fault),
                    self._retry, label=f"serve batch [{shape}]")
                # phase split from the returned counters: real lanes
                # only — padding duplicates would double-count
                if schema.phases is not None:
                    bsp.subdivide(
                        {"descent": float(
                            packed[:n, schema.idx(schema.phases[0])]
                            .sum()),
                         "polish": float(
                             packed[:n, schema.idx(schema.phases[1])]
                             .sum())},
                        prefix="serve/phase/")
        except BaseException as e:
            self._fleet_release_claims(pendings)
            pendings = pendings + [d for ps in dups.values()
                                   for d in ps]
            self._abort_probes(pendings)
            for p in pendings:
                self._audit_forget(p)
                if not p.future.done():
                    p.future.set_exception(e)
                self.metrics.record_failure(self._clock() - p.t_submit)
            if isinstance(e, Interrupted):
                raise
            return
        # recent-batch-latency EWMA (clock units): the estimated-wait
        # model behind Overloaded retry-after and deadline-aware
        # admission (policy est_batch_s, when set, takes precedence)
        wall = self._clock() - t_launch
        self._batch_ewma_s = (wall if self._batch_ewma_s is None
                              else 0.25 * wall + 0.75 * self._batch_ewma_s)
        if prof is not None:
            prof.record_launch(prof_key, wall, tracer=self._obs.tracer,
                               work=work_of(packed))
        if self._obs.enabled:
            # per-flush lane telemetry: padding efficiency of
            # the ladder shape, plus the per-device memory sample
            self._obs.gauge("aiyagari_serve_batch_lane_occupancy",
                            "real lanes / ladder shape of the last "
                            "flush").set(n / float(shape))
            self._obs.sample_devices(where="serve/batch_flush")

        self.metrics.record_batch(n, shape)
        rows = np.array(np.asarray(packed), dtype=np.float64)
        launch_id = self._launch_count
        self._launch_count += 1
        if (self._corrupt_lane is not None
                and int(self._corrupt_lane.get("at_launch", 0))
                == launch_id):
            # deterministic post-solve lane corruption (tests): the bits
            # are wrong from here on — certification (or the store's
            # checksum chain) must stop them, not serve them
            lane = int(self._corrupt_lane.get("lane", 0))
            rows[lane, int(self._corrupt_lane.get("field", 0))] += float(
                self._corrupt_lane.get("amplitude", 1e-3))

        # certify_before_cache (DESIGN §9): one batched certification
        # launch over this batch's healthy, cacheable lanes — the store
        # never persists (and the futures never see) an uncertified
        # FAILED solution
        certs = [None] * len(pendings)
        if self._certify:
            status_col = schema.idx(schema.status)
            idx = [i for i, p in enumerate(pendings)
                   if p.query.fault_iter is None
                   and not is_failure(int(np.rint(rows[i][status_col])))]
            if idx:
                # padded to the ladder shape (last lane duplicated) like
                # the solve launch, as the JAX service pads it
                pad = self.batcher.pad_to(len(idx))
                pidx = idx + [idx[-1]] * (pad - len(idx))
                cells = np.asarray([pendings[i].query.cell()
                                    for i in pidx])
                try:
                    if scn.certify_rows is None:
                        raise ValueError(
                            f"scenario {scn.name!r} has no certify_rows "
                            "hook; run the service without "
                            "certify_before_cache")
                    with self._launch_lock, self.metrics.compile, \
                            self._device_scope():
                        graded = retry_transient(
                            lambda: scn.certify_rows(
                                rows[pidx], cells, tdt, kwargs_items,
                                thresholds=self._cert_thresholds,
                                device=self._device),
                            self._retry, label=f"serve certify [{pad}]")
                except BaseException as e:
                    # certification is a device launch too: a failure
                    # there fails THIS batch's futures typed — it must
                    # never escape _launch and kill the worker with the
                    # futures stranded unresolved
                    self._fleet_release_claims(pendings)
                    pendings = pendings + [d for ps in dups.values()
                                           for d in ps]
                    self._abort_probes(pendings)
                    for p in pendings:
                        self._audit_forget(p)
                        if not p.future.done():
                            p.future.set_exception(e)
                        self.metrics.record_failure(
                            self._clock() - p.t_submit)
                    if isinstance(e, Interrupted):
                        raise
                    return
                for i, cert in zip(idx, graded[:len(idx)]):
                    certs[i] = cert

        now = self._clock()
        status_col = schema.idx(schema.status)
        for i, p in enumerate(pendings):
            row = rows[i]
            status = int(np.rint(row[status_col]))
            seed, path = plans[i]
            lane_dups = dups.get(id(p), ())
            if is_failure(status):
                # a failed solve abandons the fleet claim (failures are
                # never cached/published): the fingerprint becomes
                # claimable again, and remote waiters re-elect
                if self._fleet and p.query.fault_iter is None:
                    self.store.release(p.query.key())
                exc = EquilibriumSolveFailed(
                    p.query.cell(), status, p.query.key())
                self._audit_forget(p)
                for pp in (p,) + tuple(lane_dups):
                    self._breaker_note(pp, ok=False, now=now)
                    pp.future.set_exception(exc)
                    self.metrics.record_failure(now - pp.t_submit)
                self._obs.event("SOLVER_DIVERGED",
                                cell=p.query.cell(),
                                scenario=scn.name,
                                status=status_name(status),
                                where="serve")
                continue
            cert = certs[i]
            if cert is not None:
                self.metrics.record_certificate(cert.level)
                if cert.failed:
                    if self._fleet and p.query.fault_iter is None:
                        self.store.release(p.query.key())
                    exc = CertificationFailed(
                        p.query.cell(), p.query.key(), cert)
                    self._audit_forget(p)
                    for pp in (p,) + tuple(lane_dups):
                        self._breaker_note(pp, ok=False, now=now)
                        pp.future.set_exception(exc)
                        self.metrics.record_failure(now - pp.t_submit)
                    self._obs.event("CERT_FAILED",
                                    cell=p.query.cell(),
                                    scenario=scn.name,
                                    key=p.query.key(),
                                    summary=cert.summary(),
                                    where="serve")
                    continue
            self._breaker_note(p, ok=True, now=now)
            lvl = None if cert is None else cert.level
            res = _result_from_row(schema, row, path, seed,
                                   p.query.key(), cert_level=lvl,
                                   scenario=scn.name)
            if p.query.fault_iter is None:
                entry = make_solution(
                    p.query.cell(), row, p.query.group(), p.query.key(),
                    cert_level=UNCERTIFIED if lvl is None else lvl,
                    schema=schema)
                if self._fleet:
                    # exactly-once completion: atomic publish + lease
                    # release (journaled FLEET_PUBLISH) — remote waiters
                    # polling this fingerprint serve these bits
                    self.store.publish(
                        entry, speculative=(p.query.priority
                                            == Priority.SPECULATIVE),
                        seed=seed)
                else:
                    self.store.put(entry)
                if p.query.priority == Priority.SPECULATIVE:
                    self._note_prefetch_stored(p.query.key())
                if p.refine:
                    self._note_refinement(p, res, lvl, now)
            for pp in (p,) + tuple(lane_dups):
                pp.future.set_result(res)
                self.metrics.record_served(path, now - pp.t_submit,
                                           scenario=scn.name)
                self._obs.record_span("serve/query", now - pp.t_submit,
                                      path=path, cell=pp.query.cell(),
                                      scenario=scn.name)
            self.metrics.record_phases(res.descent_steps, res.polish_steps,
                                       res.precision_escalations)

    def _note_refinement(self, p: _Pending, res: ServedResult, lvl,
                         now: float) -> None:
        """An escalated surrogate query's real solve was published
       : journal the parameter-space refinement point —
        the lattice densified exactly where the surrogate failed — and
        resolve a pending seeded audit: the solved r* must land inside
        the surrogate's own reported error bound, or the audit fails
        loudly in metrics and on the LATTICE_REFINED event."""
        pol = self._surrogate
        attrs: dict = {"reason": p.refine}
        with self._audit_lock:
            audit = self._audit_pending.pop(p.query.key(), None)
        if audit is not None:
            r_hat, bound, donor_keys = audit
            err = abs(float(res.r_star) - r_hat)
            ok = bool(err <= bound)
            self.metrics.record_audit(ok)
            attrs.update(audit_ok=ok, surrogate_err=err,
                         surrogate_bound=bound,
                         donors=[int(k) for k in donor_keys])
        if pol is not None and pol.refine:
            self.metrics.record_lattice_refined()
            self._obs.event("LATTICE_REFINED", cell=p.query.cell(),
                            key=p.query.key(),
                            scenario=p.query.scenario,
                            cert_level=lvl, **attrs)
            self._obs.counter(
                "aiyagari_serve_lattice_refinements_total",
                "escalated solves published as parameter-space "
                "refinement points").inc()

    def _audit_forget(self, p: _Pending) -> None:
        """A pending marked for a surrogate audit left the system
        without a published solve (solver failure, launch error): drop
        the stashed prediction so a LATER same-key solve cannot resolve
        a stale audit."""
        if self._surrogate is None or not p.refine:
            return
        with self._audit_lock:
            self._audit_pending.pop(p.query.key(), None)

    # -- pumping / lifecycle ------------------------------------------------

    def pump(self, now: Optional[float] = None) -> int:
        """Manual mode: launch the batches due at ``now`` (injected-clock
        units).  Returns the number of batches launched.  Polls the
        preemption flag first — at a requested shutdown, pending futures
        fail with the typed ``Interrupted`` and it re-raises (the sweep's
        seam protocol: callers see the typed exit, waiters are never left
        hung)."""
        return self._run_batches(self.batcher.pop_ready(now))

    def flush(self) -> int:
        """Launch everything queued regardless of deadlines."""
        return self._run_batches(self.batcher.pop_all())

    def _breaker_note(self, p: _Pending, ok: bool, now: float) -> None:
        """Feed one solved lane's outcome to its region breaker and
        journal/count any transition (open on K failures, close on a
        certified success — including a successful half-open probe)."""
        if self.breaker is None or p.region is None:
            return
        if ok:
            tr = self.breaker.record_success(p.region, now)
        else:
            tr = self.breaker.record_failure(p.region, now)
        if tr in ("opened", "reopened"):
            self.metrics.record_breaker(tr)
            self._obs.event("CIRCUIT_OPEN", region=list(p.region),
                            cell=p.query.cell(),
                            scenario=p.query.scenario, transition=tr)
            self._obs.counter(
                "aiyagari_serve_breaker_opens_total",
                "regional circuit breakers opened (incl. reopens)").inc()
        elif tr == "closed":
            self.metrics.record_breaker("closed")
            self._obs.event("CIRCUIT_CLOSE", region=list(p.region),
                            cell=p.query.cell(),
                            scenario=p.query.scenario)
            self._obs.counter(
                "aiyagari_serve_breaker_closes_total",
                "regional circuit breakers closed on certified "
                "success").inc()

    def _abort_probes(self, pendings) -> None:
        """Pendings leaving the system without a solve outcome (launch
        error, drain, interrupt): any half-open probe among them returns
        its region to OPEN so the next due admit can re-probe."""
        if self.breaker is None:
            return
        for p in pendings:
            if p.probe and p.region is not None:
                self.breaker.abort_probe(p.region)

    def _run_batches(self, batches) -> int:
        """Launch a popped batch list under the seam protocol.  On a
        shutdown request — the flag set before any launch, or an
        ``Interrupted`` escaping a launch — EVERY popped-but-unlaunched
        batch's futures AND everything still queued fail with the typed
        exception before it re-raises: a batch popped out of the batcher
        must never be silently abandoned (its waiters would hang)."""
        remaining = list(batches)
        if remaining:
            # queue-depth sample at the POP side:
            # the pre-pop depth, so drain-heavy loads don't understate
            # the peak; popped pendings release their admission
            # occupancy here — they no longer hold queue slots
            lanes = sum(len(p) for _, p in remaining)
            self._observe_depth(self.batcher.depth() + lanes)
            for _, pendings in remaining:
                for p in pendings:
                    self._release_pending(p)
        count = 0
        try:
            if interrupt_requested():
                self._obs.event("INTERRUPTED", what="equilibrium service",
                                pending_batches=len(remaining))
                raise Interrupted(
                    "equilibrium service interrupted; pending queries "
                    "failed at the batch seam")
            while remaining:
                group, pendings = remaining.pop(0)
                self._launch(group, pendings)
                count += 1
        except Interrupted as e:
            # _launch already failed its own batch's futures before
            # re-raising; fail the popped-but-unlaunched ones, then the
            # still-queued ones, and stop accepting queries
            for _, pendings in remaining:
                self._fail_futures(pendings, e)
            self._fail_pending(e)
            self._closed = True
            raise
        return count

    def _fail_futures(self, pendings, exc: BaseException) -> None:
        self._abort_probes(pendings)
        for p in pendings:
            if not p.future.done():
                p.future.set_exception(exc)
            self.metrics.record_failure(self._clock() - p.t_submit)

    def _fail_pending(self, exc: BaseException) -> None:
        for _, pendings in self.batcher.pop_all():
            for p in pendings:
                self._release_pending(p)
            self._fail_futures(pendings, exc)

    def _worker_loop(self) -> None:
        while True:
            try:
                self._run_batches(self.batcher.wait_ready(timeout=0.05))
                if self._closed:
                    if self._drain_on_close:
                        self._run_batches(self.batcher.pop_all())
                    else:
                        self._fail_pending(
                            ServiceClosed("service closed without drain"))
                    return
            except Interrupted:
                # _run_batches already failed every pending future and
                # closed the service at the seam
                return

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop accepting queries; by default drain what is queued (every
        pending future resolves), else fail pending with
        ``ServiceClosed``.  Idempotent.  A ``submit`` racing ``close`` is
        serialized by the gate: it either enqueues before the final drain
        (and resolves) or observes the closed flag and raises."""
        with self._gate:
            self._drain_on_close = drain
            self._closed = True
        if self._worker is not None:
            with self.batcher._cond:
                self.batcher._cond.notify_all()
            self._worker.join(timeout)
            self._worker = None
        elif drain and not interrupt_requested():
            self.flush()
        # belt-and-braces: nothing can be queued past the gate-serialized
        # close, but a stray entry must fail typed, never hang
        self._fail_pending(ServiceClosed("service closed"))
        # fleet hygiene: a CLEAN close returns any stray held leases (a
        # batch that errored between claim and release).  An INTERRUPTED
        # close deliberately does not — the preemption path must not add
        # disk I/O between the signal and exit, and the lease TTL is the
        # designed reclaim for a worker that stopped mid-claim
        if self._fleet and not interrupt_requested():
            for key in self.store.held_leases():
                self.store.release(key)
        # heartbeat hygiene: stop the store's lease-heartbeat
        # thread deterministically — no thread may outlive the service
        # that owns the store.  Leases were returned above on the clean
        # path; on the interrupted path close(release_leases=False)
        # leaves them for the TTL reclaim, by design.
        if self._fleet and hasattr(self.store, "close"):
            self.store.close(release_leases=False)
        # observability run-end: mirror the metrics snapshot
        # into the registry, then flush trace/journal iff this service
        # owns the bundle (an ObsConfig was passed; a shared Obs belongs
        # to the caller's wider run)
        if self._obs.enabled:
            self.metrics.publish(self._obs.registry)
        if self._obs_owned:
            self._obs.close()

    def __enter__(self) -> "EquilibriumService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)

    # -- verification helper ------------------------------------------------

    def reference_solve(self, q: EquilibriumQuery,
                        bracket_init: Optional[tuple] = None):
        """A direct single-cell solve through the SAME batched solver
        serving uses (a batch-of-1 launch, no store, no batching): the
        bit-identity contract's reference.  ``bracket_init=None`` solves
        cold (the un-seeded solver); passing a served result's
        ``bracket_init`` reproduces its bits."""
        scn = _scenario_of(q.scenario)
        warm = bracket_init is not None
        fn = scn.batched_solver(_torch_dtype(q.dtype), q.kwargs, None, warm)
        with self._launch_lock, self._device_scope():
            row = fn(np.asarray([q.cell()], dtype=np.float64),
                     self._device,
                     [tuple(bracket_init)] if warm else None, None)[0]
        return _result_from_row(scn.schema, row, "reference",
                                bracket_init, q.key(), scenario=scn.name)
