"""The sweep engine for one device (port of the scenario-generic engine of
``aiyagari_hark_tpu/parallel/sweep.py``): scheduling, quarantine, SDC
rechecks and a posteriori certification around the batched solve.

A batched launch solves its cells as lanes of one lean bisection
(``models.equilibrium.solve_cells_lean``): each lane runs its own
bracket and exits at its own convergence, the inner fixed points of all
active lanes run as one launch of each CUDA kernel per trip, and the
packed rows (``utils.config.PACKED_ROW_FIELDS``) reach the host in one
transfer.

* ``schedule="locked"``: every cell in one launch.  ``"balanced"``: the
  cells sorted by predicted work (``heuristic_cell_work``) into buckets
  launched one after another, cheapest first, un-permuted after;
  ``warm_brackets`` seeds each later bucket's brackets from its solved
  neighbours (``dyadic_bracket``, verified in the solve).
* quarantine: a failed cell (MAX_ITER, NONFINITE) is re-solved alone
  through the scenario's retry rungs; a cell that fails them all keeps
  its status and NaN values.
* SDC recheck: a fingerprint-sampled subset re-solved in other lane
  positions and compared bitwise; a mismatch is routed to quarantine.
* certification: every cell graded by ``verify.certificate``.
* durability: every launch, quarantine rung and the certification go
  through ``utils.resilience.retry_transient`` (a transient fault on the
  card is replayed after a backoff); with a ``resume_path`` each finished
  bucket and quarantine walk is flushed to a resume ledger
  (``utils.resilience.LedgerState``) before the next, and a rerun
  restores them bit for bit; a ``SweepConfig.sidecar_path`` records the
  run's counters and roots for the next run's work model and same-cell
  warm seeds.
* observability: with ``obs`` (an ``obs.ObsConfig`` or a shared
  ``obs.Obs``) the run is the active scope of its bundle: the root span
  "sweep/run", a span per bucket, recheck, quarantine rung and
  certification, the JAX package's journal events and metrics at each
  seam, the cost ledger and device telemetry under ``profile=True``.
  Every one is host-side, around calls whose rows are already on the
  host: it moves no bit and adds no device synchronisation.

Not ported, raising ``NotImplementedError`` naming the ROADMAP item:
``mesh`` and ``state_shards > 1`` (Queue 1 item 6).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device, resolve_dtype
from ..obs.runtime import NULL_OBS, resolve_obs
from ..solver_health import NONFINITE, is_failure, status_name
from ..utils.checkpoint import (CORRUPT_NPZ_ERRORS, CheckpointMismatchError,
                                load_sweep_sidecar, save_sweep_sidecar)
from ..utils.config import SweepConfig
from ..utils.fingerprint import (IntegrityError, canonical_dtype,
                                 hashable_kwargs, ledger_fingerprint,
                                 solution_fingerprint, work_fingerprint)
from ..utils.resilience import (LedgerState, RetryPolicy, TransientInjector,
                                fire_preemption, raise_if_interrupted,
                                retry_transient)
from ..utils.timing import stopwatch


@dataclass
class SweepResult:
    """Per-cell equilibrium objects of ``run_table2_sweep``, cell-major
    ([C]), host numpy, in ``SweepConfig.cells()`` order.

    ``excess`` mixes supply at the last bisection midpoint with demand at
    r*, a residual accurate to O(r_tol).  ``status`` is each cell's final
    ``solver_health`` code and ``retries`` the quarantine rungs it took
    (0: solved in the batched pass); a cell that failed every rung keeps
    its failing status and NaN ``r_star_pct``, ``capital`` and the values
    derived from them (``failed_cells()``).  ``descent_steps`` and
    ``polish_steps`` split the inner steps by ladder phase (all polish
    under ``precision="reference"``); ``precision_escalations`` counts
    inner loops whose cheap phase fell back to a reference solve.
    ``bucket`` is each cell's launch group under ``schedule="balanced"``
    (None: locked) and ``predicted_work`` the scheduler's work model.
    ``sdc_suspected`` marks the cells whose recheck mismatched bitwise
    (None: no recheck), ``cert_level`` the certificate levels (None: not
    certified).  ``wall_seconds`` covers the batched launches only, the
    rechecks and the certification have their own walls."""

    crra: np.ndarray
    labor_ar: np.ndarray
    labor_sd: np.ndarray
    r_star_pct: np.ndarray
    saving_rate_pct: np.ndarray
    capital: np.ndarray
    excess: np.ndarray
    bisect_iters: np.ndarray
    egm_iters: np.ndarray
    dist_iters: np.ndarray
    status: np.ndarray
    descent_steps: np.ndarray
    polish_steps: np.ndarray
    precision_escalations: np.ndarray
    wall_seconds: float = float("nan")
    device: str = ""
    retries: Optional[np.ndarray] = None
    bucket: Optional[np.ndarray] = None
    predicted_work: Optional[np.ndarray] = None
    sdc_suspected: Optional[np.ndarray] = None
    cert_level: Optional[np.ndarray] = None
    recheck_wall_seconds: float = 0.0
    certify_wall_seconds: float = 0.0

    def polish_frac(self) -> float:
        """Share of the inner steps that ran at reference precision (1.0
        under "reference")."""
        total = float(self.descent_steps.sum() + self.polish_steps.sum())
        return float(self.polish_steps.sum()) / max(total, 1.0)

    def failed_cells(self) -> np.ndarray:
        """Indices of the cells whose final status is a failure."""
        return np.nonzero(is_failure(self.status))[0]

    def total_work(self) -> np.ndarray:
        """Per-cell inner step count (EGM + distribution steps)."""
        return self.egm_iters + self.dist_iters

    def iteration_skew(self) -> float:
        """max/min of the per-cell work (1.0: balanced)."""
        return _skew(self.total_work())

    def scheduled_iteration_skew(self) -> float:
        """The worst max/min work within one launch group (the whole sweep
        under the locked schedule)."""
        return _scheduled_skew(self.total_work(), self.bucket)


def _skew(w: np.ndarray) -> float:
    return float(w.max() / max(w.min(), 1))


def _scheduled_skew(w: np.ndarray, bucket) -> float:
    if bucket is None:
        return _skew(w)
    worst = 1.0
    for b in np.unique(bucket[bucket >= 0]):
        worst = max(worst, _skew(w[bucket == b]))
    return worst


# ---------------------------------------------------------------------------
# The batched cell solver and the quarantine ladder.
# ---------------------------------------------------------------------------

def pack_rows(values) -> np.ndarray:
    """Per-lane outputs (each [C]) as [C, W] packed rows in the first
    one's dtype (counters and status exactly), moved to the host in one
    transfer, as float64."""
    f = values[0].dtype
    rows = torch.stack([v.to(f) for v in values], dim=-1)
    return rows.cpu().numpy().astype(np.float64)


def lane_solver(solve_cells, attrs, dtype, kwargs_items=(), fault_mode=None,
                warm=False):
    """A scenario's batched cell solver: ``solve(cells, device, seeds,
    fault_iters) -> [C, len(attrs)]`` float64 rows, the fields ``attrs``
    of ``solve_cells(cells, dtype=, device=, **kwargs)`` in the row
    schema's order.  ``cells`` is [C, 3] on the host; ``seeds`` (with
    ``warm``) each lane's ``(lo0, hi0, levels)`` bracket seed, passed as
    ``bracket_init``; ``fault_iters`` (with a ``fault_mode``) each
    lane's fault trip (negative: healthy), passed as ``fault_iter``.
    Nothing is compiled, so nothing is cached: the closure only binds the
    configuration."""
    model_kwargs = dict(kwargs_items)

    def solve(cells, device, seeds=None, fault_iters=None):
        extra = {}
        if warm:
            extra["bracket_init"] = tuple(
                torch.as_tensor(np.asarray([s[j] for s in seeds]),
                                dtype=dt, device=device)
                for j, dt in ((0, dtype), (1, dtype), (2, torch.int32)))
        if fault_mode is not None:
            extra.update(fault_iter=torch.as_tensor(
                np.asarray(fault_iters), dtype=torch.int32, device=device),
                fault_mode=fault_mode)
        out = solve_cells(np.asarray(cells), dtype=dtype, device=device,
                          **extra, **model_kwargs)
        return pack_rows([getattr(out, a) for a in attrs])

    return solve


# The Aiyagari row (utils.config.PACKED_ROW_FIELDS) as LeanEquilibrium
# fields.
LEAN_ROW_ATTRS = ("r_star", "capital", "labor", "bisect_iters", "egm_iters",
                  "dist_iters", "status", "descent_steps", "polish_steps",
                  "escalations")


def _batched_solver(dtype, kwargs_items=(), fault_mode=None, warm=False):
    """The Aiyagari batched cell solver (``lane_solver`` of
    ``solve_cells_lean``): [C, PACKED_ROW_WIDTH] rows of (crra, rho, sd)
    cells."""
    from ..models.equilibrium import solve_cells_lean

    return lane_solver(solve_cells_lean, LEAN_ROW_ATTRS, dtype, kwargs_items,
                       fault_mode, warm)


def _eager_row(cell, dtype, model_kwargs: dict, device) -> np.ndarray:
    """One serial solve (a quarantine rung): ``solve_calibration_lean`` of
    one cell, C=1 launches, its outputs as one packed row."""
    from ..models.equilibrium import solve_calibration_lean

    lean = solve_calibration_lean(float(cell[0]), float(cell[1]),
                                  labor_sd=float(cell[2]), dtype=dtype,
                                  device=device, **model_kwargs)
    return pack_rows([getattr(lean, a).reshape(1)
                      for a in LEAN_ROW_ATTRS])[0]


# The quarantine ladder, rung by rung: pure bisection (no Illinois secant
# jumps); then no Aitken extrapolation in the inner loops
# (``accel_every=0``, the main non-finite risk there); then a 10x padded
# bracket, away from the endpoints where the supply map loses
# contraction.  Every rung runs the reference precision, grid and kernel,
# the configuration the goldens certify.  The JAX rungs also switch the
# distribution method (``dist_method``) and the policy loop
# (``egm_method="xla"``), to escape a pathology of one engine in another;
# the port has one engine of each (the lottery and EGM kernels), and on a
# CUDA tensor no plain version may run, so those two keys are dropped.
def _retry_ladder(model_kwargs: dict) -> tuple:
    rungs = (
        {"root_method": "bisect"},
        {"root_method": "bisect", "accel_every": 0},
        {"root_method": "bisect", "accel_every": 0, "bracket_pad": 10.0},
    )
    for key, default in (("precision", "reference"), ("grid", "reference"),
                         ("kernel", "reference")):
        if model_kwargs.get(key, default) != default:
            rungs = tuple({**r, key: default} for r in rungs)
    return rungs


# ---------------------------------------------------------------------------
# Work-balanced scheduling.
# ---------------------------------------------------------------------------

def heuristic_cell_work(cells: np.ndarray) -> np.ndarray:
    """Relative inner-loop work of each (sigma, rho, sd) cell, the
    scheduler's cost model (the JAX package's fit): work falls in rho, in
    sd and mildly in sigma, so its inverse rises about affinely in each.
    Only the ranking matters."""
    cells = np.asarray(cells, dtype=np.float64)
    sig, rho, sd = cells[:, 0], cells[:, 1], cells[:, 2]
    inv = 1.0 + 0.81 * rho + 6.6 * (sd - 0.2) + 0.02 * (sig - 1.0)
    return 1.0 / np.maximum(inv, 0.05)


def _load_sidecar(path, fingerprint):
    """Best-effort sidecar read: a missing, corrupt, foreign or
    checksum-failing file falls back to the heuristic (with a warning for
    the last two), never stops a sweep."""
    if path is None:
        return None
    try:
        return load_sweep_sidecar(path, fingerprint)
    except CheckpointMismatchError as e:
        warnings.warn(f"sweep sidecar ignored: {e}", stacklevel=5)
        return None
    except IntegrityError as e:
        warnings.warn(f"sweep sidecar failed integrity verification: {e}",
                      stacklevel=5)
        return None
    except CORRUPT_NPZ_ERRORS:
        return None


def _predict_work(cells: np.ndarray, side=None,
                  heuristic=heuristic_cell_work) -> np.ndarray:
    """Per-cell predicted work: the sidecar's measured counters where it
    has the cell (the heuristic scaled into their units by the median
    ratio over the matched cells, so the two stay comparable), the
    scenario's heuristic elsewhere."""
    pred = heuristic(cells)
    if side is None:
        return pred
    measured = np.full(len(cells), np.nan)
    work = side.total_work()
    for i, cell in enumerate(cells):
        j = side.lookup(cell)
        if j is not None and work[j] > 0:
            measured[i] = float(work[j])
    have = np.isfinite(measured)
    if have.any():
        scale = float(np.median(measured[have] / pred[have]))
        pred = pred * max(scale, 1e-12)
        pred[have] = measured[have]
    return pred


def _host_bracket(model_kwargs: dict, dtype):
    """The economic bracket in host arithmetic, bit for bit
    ``equilibrium._bisection_setup``'s: the same Python-float expressions,
    one cast to ``dtype`` (numpy's twin of the solve's dtype)."""
    ft = canonical_dtype(dtype).type
    disc_fac = float(model_kwargs.get("disc_fac", 0.96))
    depr_fac = float(model_kwargs.get("depr_fac", 0.08))
    pad = float(model_kwargs.get("bracket_pad", 1.0))
    return (ft(-depr_fac + 1e-3 * pad),
            ft(1.0 / disc_fac - 1.0 - 1e-4 * pad))


def _host_r_tol(model_kwargs: dict, dtype) -> float:
    """The effective bracket tolerance (``_bisection_setup``'s
    defaults)."""
    rt = model_kwargs.get("r_tol")
    if rt is not None:
        return float(rt)
    return 1e-10 if canonical_dtype(dtype) == np.float64 else 1e-6


def _max_levels(model_kwargs: dict) -> int:
    """How deep a warm seed's dyadic descent may go: six trips short of
    the solver's ``max_bisect``."""
    return max(0, int(model_kwargs.get("max_bisect", 60)) - 6)


def dyadic_bracket(r_lo, r_hi, target: float, margin: float,
                   max_levels: int, dtype):
    """Descend the bisection's dyadic tree toward ``target`` in the
    arithmetic of the solve's ``_bisect`` (``mid = 0.5 (lo + hi)`` in
    ``dtype``), keeping a ball of ``margin`` around the target inside.
    Returns ``(lo, hi, levels)``: endpoints that are bitwise descendants
    of ``(r_lo, r_hi)``, so a continuation from them replays the cold
    bisection's remaining midpoints."""
    ft = canonical_dtype(dtype).type
    lo, hi, half = ft(r_lo), ft(r_hi), ft(0.5)
    levels = 0
    while levels < max_levels:
        mid = half * (lo + hi)
        if target + margin < mid:
            hi = mid
        elif target - margin > mid:
            lo = mid
        else:
            break
        levels += 1
    return lo, hi, levels


def _plan_buckets(order: np.ndarray, n_buckets: int):
    """Split the work-sorted cell order into equal-size contiguous buckets,
    cheapest first; ``n_buckets=0``: about C/3, at most 8 (the JAX plan on
    one device).  Returns (buckets, bucket size)."""
    n = len(order)
    k = n_buckets if n_buckets > 0 else max(1, min(8, n // 3))
    k = min(k, n)
    size = -(-n // k)
    return [order[i * size:(i + 1) * size]
            for i in range(k) if len(order[i * size:(i + 1) * size])], size


# The (sigma, rho, sd) scale of the neighbour distance: the Table II
# lattice's span.
NEIGHBOR_CELL_SCALE = (4.0, 0.9, 0.4)


def neighbor_distance(cell, cells, scale=NEIGHBOR_CELL_SCALE) -> np.ndarray:
    """Normalised L1 distance from ``cell`` to each row of ``cells``."""
    cell = np.asarray(cell, dtype=np.float64)
    cells = np.asarray(cells, dtype=np.float64)
    return sum(np.abs(cells[..., i] - cell[i]) / scale[i]
               for i in range(len(scale)))


def donor_margin(spread, width: float, r_tol: float) -> float:
    """Ball around a donated root: the r* spread of the two nearest donors
    (how far the root may have moved), floored; ``spread=None`` is the
    one-donor case."""
    if spread is None:
        return float(max(0.08 * width, 64.0 * r_tol))
    return float(max(spread, 0.03 * width, 64.0 * r_tol))


def _neighbor_seed(cell, cells, r_solved, solved_ok, width, r_tol,
                   warm_margin, scale=NEIGHBOR_CELL_SCALE):
    """Bracket seed of ``cell`` from its nearest solved neighbour: target
    the neighbour's root, margin ``warm_margin`` or ``donor_margin``.
    None while nothing is solved."""
    idx = np.nonzero(solved_ok)[0]
    if len(idx) == 0:
        return None
    d = neighbor_distance(cell, cells[idx], scale=scale)
    near = idx[np.argsort(d, kind="stable")]
    target = float(r_solved[near[0]])
    if warm_margin > 0.0:
        return target, float(warm_margin)
    spread = (abs(float(r_solved[near[0]]) - float(r_solved[near[1]]))
              if len(near) > 1 else None)
    return target, donor_margin(spread, width, r_tol)


def _resilience_seam(ledger, record, progress, inject_preempt=None,
                     bucket_id=None) -> None:
    """The one protocol of every safe boundary (a bucket, the locked
    launch, a quarantine walk): commit the finished work to the ledger
    first (``record`` mutates it; an interrupt must leave the work
    durable), then fire the preemption drill if it is armed for this
    bucket, then poll the shutdown flag."""
    if ledger is not None:
        record(ledger)
        ledger.flush()
    if (inject_preempt is not None and bucket_id is not None
            and int(inject_preempt.get("after_bucket", -1)) == bucket_id):
        fire_preemption(inject_preempt.get("mode", "signal"))
    raise_if_interrupted(
        "sweep", ledger.path if ledger is not None else None,
        progress=progress)


def _timed_launch(device_call, label, fn, *args):
    """One launch through ``device_call`` (the transient retry) and the
    wall of its successful attempt alone, ended by the rows' arrival on
    the host: a failed attempt and the backoff are not charged.  A retry
    replays the launch from its inputs (the batched solver is a pure
    function of the cells, seeds and fault trips), so its bits are the
    first attempt's; the launch counters of ``ops.kernels`` count every
    attempt."""
    t = [float("nan")]

    def timed():
        with stopwatch() as sw:
            out = fn(*args)
        t[0] = sw.seconds
        return out

    packed = device_call(label, timed)
    return packed, t[0]


def _launch_work_model(scn, methods: dict, model_kwargs: dict, dtype):
    """``work(packed) -> (flops, bytes)`` of one batched launch: the
    kernels' work model (``obs.profile.launch_work``) at this
    configuration's shapes (the grid's point counts, computed on the
    host) and the steps the launch's rows report.  Counted at the run's
    dtype (a two-phase precision's descent steps run narrower)."""
    from ..obs.profile import launch_work
    from ..ops.grids import grid_point_counts
    from ..utils.config import resolve_grid

    schema = scn.schema
    cols = [schema.idx(f) for f in schema.work]
    grid = model_kwargs.get("grid", "reference")
    tail = model_kwargs.get("grid_tail", "analytic")
    a_count, d_count = grid_point_counts(
        grid, int(model_kwargs.get("a_count", 32)),
        int(model_kwargs.get("dist_count", 500)),
        a_min=float(model_kwargs.get("a_min", 0.001)),
        a_max=float(model_kwargs.get("a_max", 50.0)),
        nest_fac=int(model_kwargs.get("a_nest_fac", 2)),
        borrow_limit=float(model_kwargs.get("borrow_limit", 0.0)),
        tail=tail)
    closed = resolve_grid(grid).compact and tail == "analytic"
    n_states = int(model_kwargs.get("labor_states", 7))
    itemsize = canonical_dtype(dtype).itemsize

    def work(packed):
        packed = np.asarray(packed, dtype=np.float64)
        egm_steps, dist_steps = (float(np.nansum(packed[:, c]))
                                 for c in cols)
        nbytes, ops = launch_work(methods, itemsize, len(packed), n_states,
                                  a_count, d_count, egm_steps, dist_steps,
                                  tail=closed)
        return ops, nbytes

    return work


def _bucket_seam(obs, scn, bsp, bi: int, cells, lanes: int, warm: bool,
                 wall: float, packed, prof=None, prof_key=None,
                 work_of=None, skew: Optional[float] = 1.0) -> None:
    """The observability of one finished launch (a bucket, or the locked
    launch as bucket 0), all from the rows already on the host: the
    ledger's launch, the span's wall and its descent/polish split from
    the returned counters, ``BUCKET_LAUNCH``, the bucket-wall histogram,
    the lane occupancy and device work skew gauges, a device-memory
    sample."""
    schema = scn.schema
    if prof is not None:
        prof.record_launch(prof_key, wall, tracer=obs.tracer,
                           work=None if work_of is None else work_of(packed))
    bsp.annotate(wall_s=wall)
    if schema.phases is not None:
        bsp.subdivide(
            {"descent": float(packed[:, schema.idx(schema.phases[0])].sum()),
             "polish": float(packed[:, schema.idx(schema.phases[1])].sum())},
            prefix="sweep/phase/")
    obs.event("BUCKET_LAUNCH", bucket=int(bi), scenario=scn.name,
              cells=[int(c) for c in cells], warm=warm, wall_s=wall)
    obs.histogram("aiyagari_sweep_bucket_wall_seconds",
                  "per-bucket launch wall").observe(wall)
    if obs.enabled:
        # a bucket launches exactly its cells on one device: occupancy 1,
        # skew 1 (the gauges keep the JAX package's names)
        obs.gauge("aiyagari_sweep_bucket_lane_occupancy",
                  "real cells / padded lanes of the last bucket"
                  ).set(len(cells) / float(lanes))
        if skew is not None:
            obs.gauge("aiyagari_sweep_bucket_device_work_skew",
                      "max/min per-device predicted work of the last "
                      "bucket").set(skew)
        obs.sample_devices(where=f"sweep/bucket{bi}")


def _ledger_key(obs, scn, kwargs_items, dtype, device, warm: bool,
                lanes: int, fault_mode):
    """The cost ledger's key and entry of one launch shape (None without
    a ledger): the JAX package's identity (work fingerprint, cold/warm,
    lane count, fault hook, one shard)."""
    prof = obs.cost_ledger
    if prof is None:
        return None, None
    flavor = "warm" if warm else "cold"
    key = ("sweep", scn.name,
           work_fingerprint(kwargs_items, dtype, scenario=scn.name), flavor,
           int(lanes), fault_mode, 1)
    prof.capture(key, label=f"sweep/{scn.name}/{flavor}{int(lanes)}",
                 device=device, dtype=dtype)
    return prof, key


def _solve_scheduled(scn, sweep: SweepConfig, cells_p, cells_nom,
                     fault_iters, fault_mode, dtype, device, kwargs_items,
                     model_kwargs, device_call, perturb=0.0, side=None,
                     ledger=None, inject_preempt=None, obs=NULL_OBS,
                     work_of=None):
    """The balanced solve: returns the packed rows ``[C, width]`` in the
    original cell order, the summed launch wall, the bucket of each cell,
    the predicted work, each cell's bracket seed (None: cold) and which
    cells the resume ledger restored.

    Per bucket, cheapest predicted first: warm seeds (with
    ``warm_brackets``) from the sidecar's root of the same cell or the
    nearest solved neighbour, one launch through ``device_call``, the
    rows put back in place, then the seam (``_resilience_seam``: the
    ledger flushed, the preemption drill, the shutdown poll).  A bucket
    the ledger holds is restored instead of launched, in loop order, so
    later buckets' neighbour seeds see what an uninterrupted run saw.
    The work model, sidecar lookups and distances use the nominal cells
    (a ``perturb`` nudge does not move them).  A bucket launches exactly
    its cells: the JAX engine pads every bucket to one shape to share one
    compiled executable, and nothing is compiled here."""
    n_orig = len(cells_p)
    schema = scn.schema
    root_col = schema.idx(schema.root)
    status_col = schema.idx(schema.status)
    cells = np.asarray(cells_nom, dtype=np.float64)
    pred = _predict_work(cells, side, heuristic=scn.cells.work)
    if ledger is not None:
        ledger.pred = np.asarray(pred, dtype=np.float64)
    order = np.argsort(pred, kind="stable")
    buckets, _ = _plan_buckets(order, sweep.n_buckets)

    warm_enabled = sweep.warm_brackets and scn.warm is not None
    if warm_enabled:
        r_lo, r_hi = scn.warm.host_bracket(model_kwargs, dtype)
        width = float(r_hi) - float(r_lo)
        r_tol = scn.warm.host_r_tol(model_kwargs, dtype)
        max_levels = scn.warm.max_levels(model_kwargs)
        # A same-cell sidecar root is exact to r_tol under the same
        # configuration, so its seed descends deep: 2 r_tol keeps the
        # root strictly inside, 4 |perturb| covers a perturbed rerun's
        # root shift (dr*/drho ~ 0.03 on the Table II lattice).
        margin_same = (float(sweep.warm_margin) if sweep.warm_margin > 0.0
                       else max(2.0 * r_tol, 4.0 * abs(float(perturb)),
                                16.0 * float(np.finfo(
                                    canonical_dtype(dtype)).eps) * width))

    results = np.full((n_orig, schema.width), np.nan)
    solved = np.zeros(n_orig, dtype=bool)
    bucket_of = np.full(n_orig, -1, dtype=np.int64)
    seeds_used: list = [None] * n_orig
    restored = np.zeros(n_orig, dtype=bool)
    wall_total = 0.0
    for bi, bucket in enumerate(buckets):
        bucket_of[bucket] = bi
        if ledger is not None and ledger.solved[bucket].all():
            results[bucket] = ledger.packed[bucket]
            solved[bucket] = True
            restored[bucket] = True
            continue
        lanes = np.asarray(bucket, dtype=np.int64)
        seeds = None
        if warm_enabled:
            status_so_far = np.rint(np.nan_to_num(
                results[:, status_col], nan=3.0)).astype(np.int64)
            solved_ok = (solved & np.isfinite(results[:, root_col])
                         & ~is_failure(status_so_far))
            targets = []
            for li in lanes:
                seed = None
                if side is not None:
                    j = side.lookup(cells[li])
                    if j is not None and np.isfinite(side.r_star[j]):
                        seed = (float(side.r_star[j]), margin_same)
                if seed is None:
                    seed = _neighbor_seed(cells[li], cells,
                                          results[:, root_col], solved_ok,
                                          width, r_tol,
                                          float(sweep.warm_margin),
                                          scale=scn.cells.scale)
                targets.append(seed)
            known = [t for t in targets if t is not None]
            if known:
                # a lane with no seed of its own (its sidecar root NaN,
                # nothing solved yet) takes a pseudo-seed at the median of
                # its bucket-mates' targets rather than forcing the bucket
                # cold; the solve verifies it, and a bad one falls back to
                # the cold trajectory
                med = float(np.median([t[0] for t in known]))
                pseudo = (med, max(0.125 * width, 64.0 * r_tol))
                seeds = [dyadic_bracket(r_lo, r_hi,
                                        *(t if t is not None else pseudo),
                                        max_levels, dtype)
                         for t in targets]
        warm = seeds is not None
        fn = scn.batched_solver(dtype, kwargs_items, fault_mode, warm)
        prof, prof_key = _ledger_key(obs, scn, kwargs_items, dtype, device,
                                     warm, len(lanes), fault_mode)
        with obs.span("sweep/bucket", bucket=int(bi), cells=len(bucket),
                      lanes=len(lanes), warm=warm,
                      device_profile=True) as bsp:
            packed, launch_wall = _timed_launch(
                device_call, f"sweep bucket {bi}", fn, cells_p[lanes],
                device, seeds,
                None if fault_iters is None else fault_iters[lanes])
        wall_total += launch_wall
        results[lanes] = packed
        solved[bucket] = True
        _bucket_seam(obs, scn, bsp, bi, bucket, len(lanes), warm,
                     launch_wall, packed, prof, prof_key, work_of)
        if warm:
            for pos, li in enumerate(lanes):
                seeds_used[li] = seeds[pos]
        _resilience_seam(
            ledger,
            lambda led: led.record_bucket(bucket, results[bucket], bi),
            progress={"completed_buckets": bi + 1,
                      "n_buckets": len(buckets)},
            inject_preempt=inject_preempt, bucket_id=bi)
    return results, wall_total, bucket_of, pred, seeds_used, restored


# ---------------------------------------------------------------------------
# SDC spot checks: a bitwise re-solve of a fingerprint-sampled subset.
# ---------------------------------------------------------------------------

def sdc_sample(cells: np.ndarray, kwargs_items: tuple, dtype,
               fraction: float, scenario: str = "aiyagari") -> np.ndarray:
    """The recheck subset: the ``ceil(fraction C)`` cells with the
    smallest ``solution_fingerprint`` (deterministic per configuration,
    uncorrelated with the cell's place in the lattice), sorted."""
    c = len(cells)
    k = int(np.ceil(float(fraction) * c))
    if k <= 0:
        return np.asarray([], dtype=np.int64)
    ranks = np.asarray(
        [solution_fingerprint(cell[0], cell[1], cell[2], kwargs_items,
                              dtype, scenario=scenario)
         for cell in np.asarray(cells)],
        dtype=np.int64)
    return np.sort(np.argsort(ranks, kind="stable")[:min(k, c)])


def _sdc_recheck(scn, rows, cells_p, sample, seeds_used, fault_iters,
                 fault_mode, dtype, device, kwargs_items, device_call):
    """Re-solve the sampled cells through the batched solver and compare
    the packed rows bitwise with ``rows``.  Each launch puts a duplicate
    of its first cell in lane 0, so every sampled cell solves at another
    lane index, in another batch than before: a lane's numbers must not
    depend on its position or its batch-mates, which makes a mismatch a
    corruption signal.  Warm cells replay their recorded seed.  Returns
    (mismatched cell indices, summed recheck wall)."""
    wall = 0.0
    suspect: list = []
    groups: dict = {}
    for i in sample:
        groups.setdefault(seeds_used[int(i)] is not None,
                          []).append(int(i))
    for warm, idx in sorted(groups.items()):
        lanes = np.asarray([idx[0]] + idx, dtype=np.int64)
        seeds = [seeds_used[i] for i in lanes] if warm else None
        fn = scn.batched_solver(dtype, kwargs_items, fault_mode, warm)
        packed, launch_wall = _timed_launch(
            device_call, f"sdc recheck [{len(lanes)}]", fn, cells_p[lanes],
            device, seeds,
            None if fault_iters is None else fault_iters[lanes])
        wall += launch_wall
        for pos, i in enumerate(idx):
            if (np.asarray(rows[i], dtype=np.float64).tobytes()
                    != packed[pos + 1].tobytes()):
                suspect.append(i)
    return suspect, wall


# ---------------------------------------------------------------------------
# The scenario-generic engine.
# ---------------------------------------------------------------------------

@dataclass
class ScenarioSweepResult:
    """Packed rows of one scenario sweep (``run_sweep``), in the original
    cell order: ``rows`` [C, W] float64 in the scenario's ``RowSchema``
    layout, quarantine outcomes applied, failed cells' ``mask_on_failure``
    columns NaN, the status column synced with ``status``.  Read columns
    by name (``col``, ``icol``).  The other fields mean what
    ``SweepResult``'s do; ``methods`` records the engines that ran."""

    scenario: str
    schema: object
    cells: np.ndarray
    rows: np.ndarray
    status: np.ndarray
    retries: np.ndarray
    wall_seconds: float
    methods: dict
    bucket: Optional[np.ndarray] = None
    predicted_work: Optional[np.ndarray] = None
    sdc_suspected: Optional[np.ndarray] = None
    cert_level: Optional[np.ndarray] = None
    recheck_wall_seconds: float = 0.0
    certify_wall_seconds: float = 0.0
    device: str = ""

    def col(self, name: str) -> np.ndarray:
        """One named column (float64)."""
        return self.rows[:, self.schema.idx(name)]

    def icol(self, name: str) -> np.ndarray:
        """One named counter or status column as int64."""
        return np.asarray(np.rint(self.col(name)), dtype=np.int64)

    def failed_cells(self) -> np.ndarray:
        return np.nonzero(is_failure(self.status))[0]

    def total_work(self) -> np.ndarray:
        """Per-cell inner step count (the schema's work counters)."""
        return sum(self.icol(f) for f in self.schema.work)

    def iteration_skew(self) -> float:
        return _skew(self.total_work())

    def scheduled_iteration_skew(self) -> float:
        return _scheduled_skew(self.total_work(), self.bucket)


def _check_unported(sweep: SweepConfig, mesh) -> None:
    """Raise for every knob whose machinery the port lacks."""
    for value, what, item in (
            (mesh, "mesh (the cell-sharded sweep)", "6"),
            (sweep.state_shards > 1, "state_shards > 1", "6")):
        if value:
            raise NotImplementedError(
                f"{what} is not ported yet: ROADMAP Queue 1 item {item}")
    if sweep.work_model not in ("auto", "heuristic", "sidecar"):
        raise ValueError(f"work_model must be 'auto', 'heuristic' or "
                         f"'sidecar', got {sweep.work_model!r}")


def run_sweep(scenario, sweep: SweepConfig = SweepConfig(), cells=None,
              dtype=None, device=None, mesh=None, axis: str = "cells",
              timer=None, perturb: float = 0.0, quarantine: bool = True,
              max_retries: int = 3, inject_fault: Optional[dict] = None,
              resume_path: Optional[str] = None, retry=None,
              inject_transient: Optional[dict] = None,
              inject_preempt: Optional[dict] = None,
              inject_sdc: Optional[dict] = None, cert_thresholds=None,
              obs=None, **model_kwargs) -> ScenarioSweepResult:
    """Solve a lattice of cells of a registered ``scenario`` (a name or a
    ``Scenario``) on ``device`` (default: the card) in ``dtype`` (default
    float32): the engine behind ``run_table2_sweep``, whose docstring
    holds the contract.  ``cells`` is [C, 3] in the scenario's
    ``CellSpace`` order (default ``sweep.cells()``).  ``axis`` names the
    lane axis of a ``mesh``, which is not ported."""
    from ..scenarios.registry import get_scenario

    scn = get_scenario(scenario)
    if cells is None:
        cells = sweep.cells()
    cells = np.asarray(cells, dtype=np.float64)
    return _run_sweep_shell(
        scn, sweep, cells, dtype, device, mesh, timer, perturb, quarantine,
        max_retries, inject_fault, resume_path, retry, inject_transient,
        inject_preempt, inject_sdc, cert_thresholds, obs, **model_kwargs)


def _run_sweep_shell(scn, sweep, cells, dtype, device, mesh, timer,
                     perturb, quarantine, max_retries, inject_fault,
                     resume_path, retry, inject_transient, inject_preempt,
                     inject_sdc, cert_thresholds, obs, **model_kwargs):
    """The observability shell around the solve: the ``obs`` argument
    (else ``sweep.obs``) resolved to a bundle, made the ACTIVE scope (so
    the deep seams -- retries, the ledger's restore and checksums -- land
    in this run's journal), the root span "sweep/run" around the whole
    run.  A bundle built here from an ``ObsConfig`` is closed here, even
    when the run leaves by ``Interrupted``; a caller's ``Obs`` stays
    open.  Both entry points call this directly, so a warning inside the
    impl is four frames below the user's call."""
    _check_unported(sweep, mesh)
    obs, owned = resolve_obs(obs if obs is not None else sweep.obs)
    try:
        with obs.activate(), obs.span(
                "sweep/run", schedule=sweep.schedule, cells=len(cells),
                scenario=scn.name) as sp:
            res = _run_sweep_impl(
                scn, sweep, cells, dtype, device, timer, perturb,
                quarantine, max_retries, inject_fault, resume_path, retry,
                inject_transient, inject_preempt, inject_sdc,
                cert_thresholds, obs, **model_kwargs)
            sp.annotate(wall_s=res.wall_seconds,
                        skew=res.scheduled_iteration_skew(),
                        failed_cells=len(res.failed_cells()))
            return res
    finally:
        if owned:
            obs.close()


def _run_sweep_impl(scn, sweep, cells_nom, dtype, device, timer, perturb,
                    quarantine, max_retries, inject_fault, resume_path,
                    retry, inject_transient, inject_preempt, inject_sdc,
                    cert_thresholds, obs,
                    **model_kwargs) -> ScenarioSweepResult:
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    schema = scn.schema
    status_col = schema.idx(schema.status)
    cells_p = np.array(cells_nom, dtype=np.float64)   # the solver's inputs
    if perturb:
        cells_p[:, scn.cells.perturb_axis] += perturb
    n_orig = cells_p.shape[0]

    def cell_attrs(i):
        # per-cell event attributes named by the scenario's axes
        return {name: float(cells_nom[i, j])
                for j, name in enumerate(scn.cells.names)}

    fault_mode = None
    fault_iters = None
    if inject_fault is not None:
        fault_mode = str(inject_fault.get("mode", "nan"))
        fault_iters = np.full(n_orig, -1, dtype=np.int32)
        fault_iters[int(inject_fault["cell"])] = int(
            inject_fault.get("at_iter", 0))

    # SweepConfig.grid and .kernel are model-kwarg defaults: an explicit
    # keyword wins, and the resolved spelling rides every fingerprint
    if sweep.grid != "reference":
        model_kwargs.setdefault("grid", sweep.grid)
    if sweep.kernel != "reference":
        model_kwargs.setdefault("kernel", sweep.kernel)
    methods = dict(scn.prepare_kwargs(model_kwargs) or {})
    kwargs_items = hashable_kwargs(model_kwargs)
    work_of = (_launch_work_model(scn, methods, model_kwargs, dt)
               if obs.cost_ledger is not None else None)

    schedule = sweep.schedule
    if schedule == "auto":
        # "balanced" only on the CPU, as the JAX engine keeps it off its
        # accelerator.  On the card every bisection trip already launches
        # only the active lanes (models.equilibrium.solve_equilibrium_lean),
        # so the per-lane kernels lose nothing to a straggler; buckets run
        # one after another add trips and launches and make no launch
        # shorter.
        schedule = ("balanced" if n_orig >= 8 and dev.type == "cpu"
                    else "locked")
    if schedule not in ("balanced", "locked"):
        raise ValueError(f"schedule must be 'auto', 'balanced' or "
                         f"'locked', got {sweep.schedule!r}")

    # -- durability: the sidecar comes first, because the resume ledger's
    # fingerprint covers its content (warm seeds read it, so a sidecar
    # swapped between an interrupt and the resume would change the
    # trajectories); every device call goes through the transient retry
    side = None
    if schedule == "balanced" and sweep.work_model in ("auto", "sidecar"):
        side = _load_sidecar(sweep.sidecar_path, work_fingerprint(
            kwargs_items, dt, scenario=scn.name))
        if sweep.work_model == "sidecar" and side is None:
            warnings.warn("work_model='sidecar' but no valid sidecar at "
                          f"{sweep.sidecar_path!r}; using the heuristic",
                          stacklevel=4)
    retry_policy = retry if retry is not None else RetryPolicy()
    injector = (TransientInjector(**inject_transient)
                if inject_transient is not None else None)

    def device_call(label, f):
        return retry_transient(f, retry_policy, inject=injector,
                               label=label)

    if resume_path is None:
        resume_path = sweep.resume_path
    ledger = None
    if resume_path is not None:
        ledger = LedgerState.resume(resume_path, ledger_fingerprint(
            cells_p, kwargs_items, dt, schedule, sweep.n_buckets,
            sweep.warm_brackets, sweep.warm_margin, fault_mode, fault_iters,
            max_retries, quarantine, side, scenario=scn.name,
            row_fields=schema.fields), n_orig, width=schema.width)

    bucket_of = None
    pred = None
    seeds_used: list = [None] * n_orig
    restored_mask = np.zeros(n_orig, dtype=bool)
    if schedule == "balanced":
        (rows, wall, bucket_of, pred, seeds_used,
         restored_mask) = _solve_scheduled(
            scn, sweep, cells_p, cells_nom, fault_iters, fault_mode, dt,
            dev, kwargs_items, model_kwargs, device_call, perturb=perturb,
            side=side, ledger=ledger, inject_preempt=inject_preempt,
            obs=obs, work_of=work_of)
    elif ledger is not None and ledger.solved.all():
        # the locked launch finished in the interrupted run: restore it
        # (its quarantine may still be pending)
        rows, wall = ledger.packed, 0.0
    else:
        fn = scn.batched_solver(dt, kwargs_items, fault_mode, False)
        prof, prof_key = _ledger_key(obs, scn, kwargs_items, dt, dev, False,
                                     n_orig, fault_mode)
        with obs.span("sweep/bucket", bucket=0, cells=n_orig, warm=False,
                      device_profile=True) as bsp:
            rows, wall = _timed_launch(device_call, "sweep launch", fn,
                                       cells_p, dev, None, fault_iters)
        _bucket_seam(obs, scn, bsp, 0, range(n_orig), n_orig, False, wall,
                     rows, prof, prof_key, work_of, skew=None)
        # the locked launch is bucket 0 of 1 to the seam protocol
        _resilience_seam(
            ledger,
            lambda led: led.record_bucket(np.arange(n_orig), rows, 0),
            progress={"completed_buckets": 1, "n_buckets": 1},
            inject_preempt=inject_preempt, bucket_id=0)
    if timer is not None:
        timer(wall)
    rows = np.array(rows, dtype=np.float64)

    # -- SDC drill and recheck: the drill corrupts the host copy after the
    # solve (finite numbers, a healthy status, wrong bits)
    if inject_sdc is not None:
        from ..verify.inject import flip_row_bit, perturb_row

        ci = int(inject_sdc["cell"])
        field = int(inject_sdc.get("field", 0))
        if "bit" in inject_sdc:
            rows[ci] = flip_row_bit(rows[ci], field=field,
                                    bit=int(inject_sdc["bit"]))
        else:
            rows[ci] = perturb_row(rows[ci], field=field,
                                   amplitude=float(inject_sdc.get(
                                       "amplitude", 1e-6)))
    sdc_suspected = None
    recheck_wall = 0.0
    if sweep.recheck_fraction > 0.0:
        sample = sdc_sample(cells_nom, kwargs_items, dt,
                            sweep.recheck_fraction, scenario=scn.name)
        # ledger-restored cells that a fresh batched launch cannot
        # reproduce are skipped, with a warning: warm cells whose seeds
        # were not recorded, and quarantine outcomes (a serial rung's row,
        # which the batched solver never writes)
        skipped = []
        if sweep.warm_brackets and restored_mask.any():
            skipped += [int(i) for i in sample if restored_mask[i]
                        and seeds_used[int(i)] is None]
        if ledger is not None and ledger.retried.any():
            skipped += [int(i) for i in sample
                        if ledger.retried[i] and int(i) not in skipped]
        if skipped:
            warnings.warn(
                f"sdc recheck: skipping ledger-restored cell(s) "
                f"{sorted(skipped)} (warm seeds unknown, or the row is a "
                f"serial quarantine outcome)", stacklevel=4)
            sample = np.asarray([i for i in sample
                                 if int(i) not in set(skipped)],
                                dtype=np.int64)
        with obs.span("sweep/sdc_recheck", sampled=len(sample)) as rsp:
            suspects, recheck_wall = _sdc_recheck(
                scn, rows, cells_p, sample, seeds_used, fault_iters,
                fault_mode, dt, dev, kwargs_items, device_call)
        rsp.annotate(wall_s=recheck_wall, suspects=len(suspects))
        sdc_suspected = np.zeros(n_orig, dtype=bool)
        sdc_suspected[suspects] = True
        for i in suspects:
            obs.event("SDC_SUSPECTED", cell=int(i), scenario=scn.name,
                      **cell_attrs(i))
        obs.counter("aiyagari_sweep_sdc_suspected_total",
                    "bitwise recheck mismatches").inc(len(suspects))
        if suspects:
            warnings.warn(
                "sdc recheck: bitwise mismatch for cell(s) "
                + ", ".join(str(i) for i in suspects)
                + "; silent data corruption suspected, routing through "
                "the quarantine ladder", stacklevel=4)

    # -- quarantine: the status column is the int64 authority from here on
    status = np.asarray(np.rint(rows[:, status_col]), dtype=np.int64)
    retries = np.zeros(n_orig, dtype=np.int64)
    # cells whose quarantine walk finished in the interrupted run: restore
    # the outcome and its rung count (a recovered cell's row holds a
    # healthy status, so it must not be walked again)
    restored_retry = np.zeros(n_orig, dtype=bool)
    if ledger is not None and quarantine:
        for i in np.nonzero(ledger.retried)[0]:
            rows[i] = ledger.packed[i]
            status[i] = int(np.rint(rows[i, status_col]))
            retries[i] = int(ledger.retries[i])
            restored_retry[i] = True
    demoted = np.zeros(n_orig, dtype=bool)
    if sdc_suspected is not None:
        # a suspect's numbers are untrusted however healthy its status:
        # demote it so the ladder re-solves it
        demoted = sdc_suspected & ~restored_retry
        status[demoted] = NONFINITE
    failed = is_failure(status) & ~restored_retry
    if quarantine and (failed.any() or restored_retry.any()):
        ladder = tuple(scn.retry_rungs(model_kwargs))[
            :max(0, int(max_retries))]
        for i in np.nonzero(failed)[0]:
            status_before = int(status[i])
            for attempt, overrides in enumerate(ladder, start=1):
                retries[i] = attempt
                with obs.span("sweep/quarantine", cell=int(i),
                              rung=attempt):
                    row_new = np.asarray(device_call(
                        f"quarantine retry cell {int(i)}",
                        lambda: scn.eager_row(
                            cells_p[i], dt, {**model_kwargs, **overrides},
                            dev)), dtype=np.float64)
                cell_status = int(np.rint(row_new[status_col]))
                if not is_failure(cell_status):
                    rows[i] = row_new
                    status[i] = cell_status
                    break
            obs.event("QUARANTINE", cell=int(i), scenario=scn.name,
                      **cell_attrs(i),
                      status_before=status_name(status_before),
                      status_after=status_name(int(status[i])),
                      recovered=not bool(is_failure(int(status[i]))),
                      retries=int(retries[i]))
            obs.counter("aiyagari_sweep_quarantined_cells_total",
                        "cells routed through the retry ladder").inc()
            # the outcome is final for this run: the launches' seam
            row_led = rows[i].copy()
            row_led[status_col] = float(status[i])
            _resilience_seam(
                ledger,
                lambda led: led.record_retry(int(i), row_led,
                                             int(retries[i])),
                progress={"retried_cell": int(i)})
        still = np.nonzero(is_failure(status))[0]
        for f in schema.mask_on_failure:
            rows[still, schema.idx(f)] = np.nan
        if len(still):
            warnings.warn(
                f"{scn.name} sweep: cells "
                + ", ".join(f"{int(i)} ({status_name(status[i])})"
                            for i in still)
                + " failed every quarantine retry; their values are "
                "NaN-masked in the result", stacklevel=4)
            # a typed failure past the ladder: the flight recorder's ring
            # (recent spans and events, the metrics snapshot) as the
            # post-mortem, journaled FLIGHT_RECORD_DUMP
            obs.dump_flight(
                f"{scn.name} sweep: {len(still)} cell(s) exhausted the "
                "quarantine ladder",
                cells=[int(i) for i in still],
                statuses=[status_name(int(status[i])) for i in still])
    # a known-corrupt cell that no rung recovered keeps nothing: every
    # value NaN, every counter 0
    zero_fields = tuple(schema.counters) + tuple(schema.phases or ())
    purge = demoted & is_failure(status)
    if purge.any():
        for f in schema.fields:
            if f != schema.status:
                rows[purge, schema.idx(f)] = (0.0 if f in zero_fields
                                              else np.nan)
    rows[:, status_col] = status.astype(np.float64)

    # the precision ladder's escalations, one event per escalated cell
    escal = None
    if schema.phases is not None:
        escal = np.asarray(np.rint(rows[:, schema.idx(schema.phases[2])]),
                           dtype=np.int64)
        for i in np.nonzero(escal > 0)[0]:
            obs.event("PRECISION_ESCALATED", cell=int(i),
                      scenario=scn.name, **cell_attrs(i),
                      escalations=int(escal[i]))

    if sweep.sidecar_path is not None:
        # this run's counters and roots for the next run's scheduler;
        # best-effort: an unwritable path must not cost a finished solve
        c0, c1, c2 = (np.asarray(np.rint(rows[:, schema.idx(c)]),
                                 dtype=np.int64) for c in schema.counters)
        phase_kw = {}
        if schema.phases is not None:
            phase_kw = {name: np.asarray(np.rint(rows[:, schema.idx(f)]),
                                         dtype=np.int64)
                        for name, f in zip(("descent_steps",
                                            "polish_steps"),
                                           schema.phases)}
        try:
            save_sweep_sidecar(
                sweep.sidecar_path, cells_nom,
                rows[:, schema.idx(schema.root)], c0, c1, c2, status,
                work_fingerprint(kwargs_items, dt, scenario=scn.name),
                **phase_kw)
        except OSError as e:
            warnings.warn(f"could not write sweep sidecar "
                          f"{sweep.sidecar_path!r}: {e}", stacklevel=4)

    # -- a posteriori certification of the final rows, before the ledger
    # is removed and through the transient retry: a fault here must not
    # cost a finished sweep its resume state
    cert_level = None
    certify_wall = 0.0
    if sweep.certify:
        if scn.certify_rows is None:
            raise ValueError(
                f"scenario {scn.name!r} has no certify_rows hook; "
                "run without SweepConfig(certify=True)")
        with stopwatch() as cert_sw:
            with obs.span("sweep/certify", cells=n_orig) as csp:
                certs = device_call(
                    "a posteriori certification",
                    lambda: scn.certify_rows(rows, cells_p, dt,
                                             kwargs_items,
                                             thresholds=cert_thresholds,
                                             device=dev))
        cert_level = np.asarray([c.level for c in certs], dtype=np.int64)
        certify_wall = cert_sw.seconds
        csp.annotate(wall_s=certify_wall,
                     failed=int((cert_level == 2).sum()))
        for i in np.nonzero(cert_level == 2)[0]:
            obs.event("CERT_FAILED", cell=int(i), scenario=scn.name,
                      **cell_attrs(i), summary=certs[int(i)].summary())
        obs.counter("aiyagari_sweep_cert_failed_total",
                    "cells whose certificate graded FAILED").inc(
            int((cert_level == 2).sum()))

    if ledger is not None:
        # the run is complete: a finished ledger must not satisfy the next
        # run's launches
        ledger.complete()

    # the run's counters in the metrics registry
    work_total = sum(
        np.asarray(np.rint(rows[:, schema.idx(f)]), dtype=np.int64)
        for f in schema.work)
    obs.counter("aiyagari_sweep_cells_total",
                "cells solved by sweeps this run").inc(n_orig)
    obs.counter("aiyagari_sweep_inner_steps_total",
                "EGM + distribution inner steps").inc(
        float(work_total.sum()))
    obs.counter("aiyagari_sweep_quarantine_retries_total",
                "quarantine ladder rungs consumed").inc(int(retries.sum()))
    if escal is not None:
        obs.counter("aiyagari_sweep_precision_escalations_total",
                    "ladder descent->reference fallbacks").inc(
            int(escal.sum()))
    obs.gauge("aiyagari_sweep_wall_seconds",
              "last sweep's honest batched wall").set(wall)

    return ScenarioSweepResult(
        scenario=scn.name, schema=schema,
        cells=np.asarray(cells_nom, dtype=np.float64), rows=rows,
        status=status, retries=retries, wall_seconds=wall,
        methods=methods, bucket=bucket_of, predicted_work=pred,
        sdc_suspected=sdc_suspected, cert_level=cert_level,
        recheck_wall_seconds=recheck_wall,
        certify_wall_seconds=certify_wall, device=str(dev))


def run_table2_sweep(sweep: SweepConfig = SweepConfig(), dtype=None,
                     device=None, mesh=None, axis: str = "cells",
                     timer=None, perturb: float = 0.0,
                     quarantine: bool = True, max_retries: int = 3,
                     inject_fault: Optional[dict] = None,
                     resume_path: Optional[str] = None, retry=None,
                     inject_transient: Optional[dict] = None,
                     inject_preempt: Optional[dict] = None,
                     inject_sdc: Optional[dict] = None,
                     cert_thresholds=None, obs=None,
                     **model_kwargs) -> SweepResult:
    """Solve every (sigma, rho, sd) cell of ``sweep`` on ``device``
    (default: the card) in ``dtype`` (default float32): the Aiyagari
    instance of ``run_sweep`` plus the Table II closed forms.
    ``model_kwargs`` go to the model build (``a_count``, ``dist_count``,
    ...) and to the solver (``disc_fac``, ``cap_share``, ``depr_fac``,
    ``prod``, tolerances, ``precision``, ``kernel``, ``root_method``,
    ...); ``grid`` goes to both.

    Scheduling: ``sweep.schedule`` "locked" solves every cell as a lane
    of one launch; "balanced" sorts the cells by predicted work into
    ``sweep.n_buckets`` buckets launched cheapest first and un-permutes
    the rows, bitwise equal to "locked" with cold brackets (a lane's
    numbers do not depend on its batch or position).  ``warm_brackets``
    seeds each later bucket's brackets by dyadic descent toward the
    nearest solved neighbour's root, verified in the solve (a bad seed
    falls back to the cold bracket): r* and status keep the locked bits
    where the excess margins allow, capital agrees to solver noise.
    "auto" is "balanced" for 8 or more cells on the CPU, "locked" on the
    card.

    Quarantine (``quarantine``, on by default): a cell that ends MAX_ITER
    or NONFINITE is re-solved alone, rung by rung, through at most
    ``max_retries`` rungs of ``_retry_ladder`` (C=1 launches on the
    card); a recovered cell takes the rung's row, a cell that fails every
    rung keeps its status, and its r* and capital are NaN.  The rungs
    never re-inject a fault or reuse a warm seed, and run after the
    timed launches.

    ``inject_fault={"cell": i, "at_iter": k, "mode": "nan"|"stall"}``
    poisons cell i from its k-th bisection trip (the solver's
    ``fault_iter``); the other lanes keep their bits.

    Integrity: ``sweep.recheck_fraction`` re-solves a fingerprint-sampled
    subset in other lane positions and compares the packed rows bitwise
    (``sdc_sample``, ``_sdc_recheck``); a mismatch sets
    ``sdc_suspected`` and sends the cell through quarantine (a suspect
    no rung recovers keeps no value and no counter).
    ``inject_sdc={"cell": i, "bit": b}`` flips bit b of the cell's
    packed field ``field`` (default 0, r*) after the solve, ``{"cell": i,
    "amplitude": a}`` adds ``a``: the corruption drills.  ``sweep.
    certify`` grades every final cell (``verify.certify_packed_rows``;
    ``cert_thresholds`` overrides the configuration's defaults) into
    ``cert_level``.  Rechecks and certification have their own walls.

    Resilience: every launch, quarantine rung and the certification run
    under ``retry_transient`` with ``retry`` (default ``RetryPolicy()``):
    a transient fault (``resilience.classify_transient``) is replayed
    after a deterministic backoff, with a warning; a retried launch
    re-runs its whole host loop of trips from its inputs, so its bits are
    the first attempt's, and the launch counters count both attempts.
    ``inject_transient={"at_call": k, "times": n}`` makes the k-th guarded
    call raise n times.  ``resume_path`` (or ``sweep.resume_path``) keeps
    a resume ledger: every finished bucket (the locked launch is bucket 0
    of 1) and every finished quarantine walk is flushed before the run
    goes on, the shutdown flag is polled at each such seam (``Interrupted``
    after the flush), and a rerun restores the ledger's rows and solves
    the rest, bitwise the uninterrupted run; a ledger of another
    configuration, or of the JAX package, warns and is recomputed, a row
    failing its checksum is recomputed alone, and a completed run removes
    the file.  ``inject_preempt={"after_bucket": b, "mode": "flag" |
    "signal"}`` fires a preemption at bucket b's seam ("signal" sends
    SIGTERM, which only a ``preemption_guard`` turns into the flag).
    ``sweep.sidecar_path`` writes the run's roots and counters after the
    sweep; a balanced rerun reads them (``work_model`` "auto" or
    "sidecar") as its work model and, with ``warm_brackets``, as
    same-cell seeds descended to within ``2 r_tol`` of the prior root.  A
    stale or corrupt sidecar warns and falls back to the heuristic.

    ``wall_seconds`` covers the batched launches (model build, solve, the
    rows' one transfer to the host), summed over buckets, each its
    successful attempt only; ``timer`` is called with it.  ``perturb`` is
    added to each cell's rho before the solve.  ``mesh`` raises
    ``NotImplementedError`` (see the module docstring).

    Observability: with ``obs`` (argument or ``sweep.obs``: an
    ``obs.ObsConfig`` or a shared ``obs.Obs``) the sweep records a
    ``sweep/run`` span holding a span per bucket launch (split into
    descent/polish children from the returned counters), per quarantine
    rung, recheck and certification; journals the typed events
    (BUCKET_LAUNCH, QUARANTINE, SDC_SUSPECTED, PRECISION_ESCALATED,
    CERT_FAILED, RETRY_TRANSIENT, INTERRUPTED, RESUME_RESTORE,
    INTEGRITY_FAILED) under one ``run_id``; mirrors the sweep's counters
    into the metrics registry; and under ``profile=True`` keeps the cost
    ledger (the kernels' work model per launch) and samples device
    memory at every bucket.  On or off, no bit of the result moves and
    no device synchronisation is added."""
    from ..scenarios.registry import get_scenario

    res = _run_sweep_shell(
        get_scenario("aiyagari"), sweep,
        np.asarray(sweep.cells(), dtype=np.float64), dtype, device, mesh,
        timer, perturb, quarantine, max_retries, inject_fault, resume_path,
        retry, inject_transient, inject_preempt, inject_sdc,
        cert_thresholds, obs, **model_kwargs)
    r = res.col("r_star")
    K = res.col("capital")
    L = res.col("labor")
    alpha = model_kwargs.get("cap_share", 0.36)
    delta = model_kwargs.get("depr_fac", 0.08)
    prod = model_kwargs.get("prod", 1.0)
    # host-side closed forms (firm identities): demand from the inverted
    # marginal product of capital, Y from Cobb-Douglas, s = delta K / Y
    demand = ((r + delta) / (prod * alpha)) ** (1.0 / (alpha - 1.0)) * L
    output = prod * K ** alpha * L ** (1.0 - alpha)
    return SweepResult(
        crra=res.cells[:, 0], labor_ar=res.cells[:, 1],
        labor_sd=res.cells[:, 2], r_star_pct=r * 100.0,
        saving_rate_pct=delta * K / output * 100.0, capital=K.copy(),
        excess=K - demand, bisect_iters=res.icol("bisect_iters"),
        egm_iters=res.icol("egm_iters"), dist_iters=res.icol("dist_iters"),
        status=res.status, descent_steps=res.icol("descent_steps"),
        polish_steps=res.icol("polish_steps"),
        precision_escalations=res.icol("precision_escalations"),
        wall_seconds=res.wall_seconds, device=res.device,
        retries=res.retries, bucket=res.bucket,
        predicted_work=res.predicted_work,
        sdc_suspected=res.sdc_suspected, cert_level=res.cert_level,
        recheck_wall_seconds=res.recheck_wall_seconds,
        certify_wall_seconds=res.certify_wall_seconds)
