"""Deterministic open-loop load harness for the serving engine (DESIGN
§11; port of the JAX package's ``serve/loadgen.py``, host code, copied).

Nothing in the repo could *generate* overload before this module: the
serve tests exercise saturation with hand-placed submits, and the bench
smoke replays fixed cell lists.  The harness closes that gap with a
seeded, replayable traffic model driven ENTIRELY by the injectable
clock:

* **open-loop arrivals** — inter-arrival times drawn from a seeded
  exponential stream at ``rate`` arrivals per clock second; an open
  loop keeps submitting on schedule regardless of how far the service
  has fallen behind (the regime where admission control earns its keep
  — a closed loop self-throttles and can never overload anything).
* **Zipf-mixed cells** — query popularity over the lattice follows a
  Zipf(``zipf_s``) rank distribution (the ROADMAP's
  millions-of-users traffic model): a few hot calibrations dominate
  (exact hits must stay µs), with a long cold tail.
* **mixed classes** — priorities, per-query deadlines, and
  ``degraded_ok`` consent drawn from seeded mixes, so every typed
  overload outcome is reachable in one run.
* **modeled service time** — the service runs in manual (no-worker)
  mode on a ``ManualClock``; each launched batch occupies the modeled
  server for ``batch_service_s`` clock units, so "capacity" is exactly
  ``max_batch / batch_service_s`` cold queries per clock second and a
  ``rate`` above it genuinely overloads the queue.  All admission
  decisions read the same clock (pin ``AdmissionPolicy.est_batch_s``
  for bit-reproducible decisions), which makes an entire overload run
  REPLAYABLE: same spec + same seed ⇒ the same per-arrival outcome
  sequence, fingerprinted in ``LoadReport.digest``.

The report records what the acceptance criteria need: every arrival's
typed outcome (zero unresolved futures is an invariant, checked), p50/
p99 clock latency per serving path, shed/reject/degrade counts, queue-
depth percentiles, and the breaker transition timeline.

Solves happen inside the service, on its device: ``run_load`` takes
``device=`` (default the card), and the fleet's workers take
``FleetSpec.device``.  Neither enters a digest, so a spec and seed give
the JAX package's ``LoadReport.digest`` and ``FleetReport.trace_digest``.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from ..utils.timing import Stopwatch, stopwatch
from .service import EquilibriumService, ServeError, make_query


class ManualClock:
    """The harness's injectable clock: a plain float the event loop
    advances.  Also handy as the deterministic fake clock in tests."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


class Arrival(NamedTuple):
    """One scheduled query of the open-loop trace."""

    t: float
    cell: Tuple[float, float, float]
    priority: int
    deadline: Optional[float]
    degraded_ok: bool


class LoadSpec(NamedTuple):
    """One replayable load scenario (everything the digest covers).

    ``cells`` is the query lattice in Zipf *rank order* (index 0 is the
    hottest); ``model_kwargs`` the solver configuration every query
    shares; ``warm_frac`` pre-solves the hottest fraction of the
    lattice into the store before the clock starts, so exact hits and
    degraded-answer donors exist.  Capacity is
    ``max_batch / batch_service_s`` cold queries per clock second —
    pick ``rate`` relative to it."""

    cells: Tuple[Tuple[float, float, float], ...]
    model_kwargs: dict
    n_queries: int = 200
    seed: int = 0
    rate: float = 400.0
    zipf_s: float = 1.1
    priority_mix: Tuple[float, float, float] = (0.6, 0.3, 0.1)
    deadline_frac: float = 0.0
    deadline_s: float = 0.05
    degraded_frac: float = 0.0
    batch_service_s: float = 0.01
    warm_frac: float = 0.0
    # continuous-parameter mix: this fraction of arrivals
    # queries a seeded uniform draw over the lattice's bounding hull
    # instead of a lattice point — the surrogate tier's traffic model.
    # The extra rng draws happen ONLY when the fraction is positive, so
    # every pre-surrogate spec's digest is bit-identical.
    offlattice_frac: float = 0.0


class LoadReport(NamedTuple):
    """One load run's record (see ``run_load``)."""

    arrivals: int
    outcomes: List[str]         # per arrival, in submission order
    counts: dict                # outcome -> count
    digest: str                 # fingerprint of the outcome sequence
    unresolved: int             # futures left unresolved (MUST be 0)
    p50_ms: dict                # clock-unit latency p50 per path
    p99_ms: dict                # clock-unit latency p99 per path
    queue_depth_p50: Optional[float]
    queue_depth_p99: Optional[float]
    queue_depth_peak: int
    breaker_transitions: List[tuple]
    hit_wall_ms: List[float]    # REAL-time exact-hit submit latencies
    snapshot: dict              # full ServeMetrics snapshot


def generate_arrivals(spec: LoadSpec) -> List[Arrival]:
    """The seeded open-loop trace: deterministic for a given spec (one
    ``default_rng(seed)`` stream drawn in a fixed order)."""
    if not spec.cells:
        raise ValueError("LoadSpec.cells must be non-empty")
    rng = np.random.default_rng(spec.seed)
    n_cells = len(spec.cells)
    ranks = np.arange(1, n_cells + 1, dtype=np.float64)
    p = ranks ** -float(spec.zipf_s)
    p /= p.sum()
    mix = np.asarray(spec.priority_mix, dtype=np.float64)
    mix = mix / mix.sum()
    # continuous-parameter hull: off-lattice arrivals sample
    # the lattice's axis-aligned bounding box.  Computed only when the
    # fraction is positive — the frac=0 stream must draw EXACTLY the
    # pre-surrogate sequence (digest bit-identity).
    off = float(spec.offlattice_frac)
    if off > 0.0:
        hull = np.asarray(spec.cells, dtype=np.float64)
        lo, hi = hull.min(axis=0), hull.max(axis=0)
    out = []
    t = 0.0
    for _ in range(int(spec.n_queries)):
        t += float(rng.exponential(1.0 / spec.rate))
        cell = spec.cells[int(rng.choice(n_cells, p=p))]
        if off > 0.0 and rng.random() < off:
            cell = tuple(float(c) for c in
                         lo + rng.random(lo.shape[0]) * (hi - lo))
        priority = int(rng.choice(len(mix), p=mix))
        deadline = (float(spec.deadline_s)
                    if rng.random() < spec.deadline_frac else None)
        degraded_ok = bool(rng.random() < spec.degraded_frac)
        out.append(Arrival(t=t, cell=tuple(float(c) for c in cell),
                           priority=priority, deadline=deadline,
                           degraded_ok=degraded_ok))
    return out


def _drain(svc: EquilibriumService, clk: ManualClock, busy_until: float,
           until: Optional[float], service_s: float) -> float:
    """Advance the modeled server up to ``until`` (None = run the queue
    dry): whenever the server is free and a batch is due, jump the
    clock there, pump, and occupy the server for ``launches x
    service_s``.  Returns the new busy-until instant."""
    for _ in range(1_000_000):
        if svc.batcher.depth() == 0:
            break
        t_free = max(clk.t, busy_until)
        if svc.batcher.ready(t_free):
            start = t_free
        else:
            nd = svc.batcher.next_deadline()
            if nd is None:
                break
            start = max(t_free, nd)
        if until is not None and start > until:
            break
        clk.t = start
        launched = svc.pump()
        if launched == 0:
            # modeling mismatch guard: nudge past the next deadline
            nd = svc.batcher.next_deadline()
            if nd is None or (until is not None and nd > until):
                break
            clk.t = max(clk.t, nd)
            continue
        busy_until = clk.t + launched * service_s
    else:
        raise RuntimeError("load harness failed to drain the queue")
    if until is not None and clk.t < until:
        clk.t = until
    return busy_until


def run_load(spec: LoadSpec, admission=None, obs=None,
             max_batch: int = 4, ladder: Optional[tuple] = (1, 2, 4),
             max_queue: int = 256, max_wait_s: float = 0.005,
             measure_hit_wall: bool = False,
             surrogate=None, device=None) -> LoadReport:
    """Replay one load scenario against a fresh manual-mode service and
    classify every arrival into a typed outcome.

    Outcome vocabulary (the digest input): ``served:<path>`` (hit /
    near / cold / the tagged ``degraded_neighbor``), ``reject:<Error>``
    (raised at submit: ``Overloaded`` / ``CircuitOpen`` /
    ``DeadlineExceeded``), ``fail:<Error>`` (the future failed:
    ``LoadShed`` / ``DeadlineExceeded`` at a seam /
    ``EquilibriumSolveFailed`` / ...), ``unresolved`` (a future left
    hanging — the invariant the soak pins to zero).

    Same spec (+ policy with a pinned ``est_batch_s``) ⇒ bit-identical
    ``digest``: every scheduling, admission, shedding, and breaker
    decision reads only the manual clock and seeded streams.
    ``device`` is the service's (default the card)."""
    clk = ManualClock()
    svc = EquilibriumService(start_worker=False, clock=clk,
                             admission=admission, obs=obs,
                             max_batch=max_batch, ladder=ladder,
                             max_queue=max_queue, max_wait_s=max_wait_s,
                             surrogate=surrogate, device=device)
    try:
        n_warm = int(round(spec.warm_frac * len(spec.cells)))
        for cell in spec.cells[:n_warm]:
            # warmup MUST solve (surrogate_ok=False): with a surrogate
            # policy the later lattice cells would otherwise be answered
            # by interpolation over the first few instead of populating
            # the store the run is warming
            fut = svc.submit(make_query(cell[0], cell[1],
                                        labor_sd=cell[2],
                                        surrogate_ok=False,
                                        **spec.model_kwargs))
            if not fut.done():
                svc.flush()
            fut.result()
        arrivals = generate_arrivals(spec)
        busy_until = clk.t
        slots: list = [None] * len(arrivals)
        hit_wall_ms: List[float] = []
        for i, a in enumerate(arrivals):
            busy_until = _drain(svc, clk, busy_until, a.t,
                                spec.batch_service_s)
            q = make_query(a.cell[0], a.cell[1], labor_sd=a.cell[2],
                           priority=a.priority,
                           degraded_ok=a.degraded_ok,
                           **spec.model_kwargs)
            try:
                with stopwatch() as sw:
                    fut = svc.submit(q, deadline=a.deadline)
                if measure_hit_wall and fut.done():
                    if (fut.exception() is None
                            and fut.result().path == "hit"):
                        hit_wall_ms.append(sw.seconds * 1e3)
                slots[i] = fut
            except ServeError as e:
                slots[i] = e
        _drain(svc, clk, busy_until, None, spec.batch_service_s)
    finally:
        svc.close()

    outcomes = []
    unresolved = 0
    for slot in slots:
        if isinstance(slot, ServeError):
            outcomes.append(f"reject:{type(slot).__name__}")
        elif not slot.done():
            unresolved += 1
            outcomes.append("unresolved")
        elif slot.exception() is not None:
            outcomes.append(f"fail:{type(slot.exception()).__name__}")
        else:
            res = slot.result()
            outcomes.append("served:" + (res.quality
                                         if res.quality != "exact"
                                         else res.path))
    counts: dict = {}
    for o in outcomes:
        counts[o] = counts.get(o, 0) + 1
    # digest over the scenario AND the per-arrival outcome sequence —
    # the replay-bit-reproducibility fingerprint (no wall times inside)
    trace = [[round(a.t, 9), list(a.cell), a.priority,
              a.deadline, a.degraded_ok] for a in arrivals]
    digest = hashlib.blake2b(
        json.dumps([trace, outcomes], sort_keys=True).encode(),
        digest_size=16).hexdigest()

    m = svc.metrics

    def _pct(hist, q):
        v = hist.percentile(q)
        return None if v is None else round(v * 1e3, 4)

    p50 = {p: _pct(m.latency[p], 50) for p in m.latency}
    p99 = {p: _pct(m.latency[p], 99) for p in m.latency}
    p50["all"] = _pct(m.latency_all, 50)
    p99["all"] = _pct(m.latency_all, 99)
    depth_p50 = m.depth_hist.percentile(50)
    depth_p99 = m.depth_hist.percentile(99)
    return LoadReport(
        arrivals=len(arrivals), outcomes=outcomes, counts=counts,
        digest=digest, unresolved=unresolved, p50_ms=p50, p99_ms=p99,
        queue_depth_p50=depth_p50, queue_depth_p99=depth_p99,
        queue_depth_peak=m.queue_depth_peak,
        breaker_transitions=(svc.breaker.transitions()
                             if svc.breaker is not None else []),
        hit_wall_ms=hit_wall_ms, snapshot=m.snapshot())


# -- fleet mode (DESIGN §14) ------------------------------------------------
#
# ``run_load`` models overload inside ONE process on an injected clock;
# ``run_fleet_load`` is its out-of-process sibling: N REAL worker
# processes (``serve.fleet`` workers over one shared disk store), each
# replayed a deterministic per-worker-seeded Zipf mix by its own client
# thread over HTTP, with fleet-wide aggregation — per-path p50/p99, the
# dedup ratio (cold solves / distinct cold fingerprints; 1.0 = the
# claim/lease election held exactly-once fleet-wide), prefetch
# hit-conversion, and the lease-leak audit.  Real wall time throughout:
# the subjects are separate processes no injected clock can reach, so
# outcome MIXES (not digests) are the replayable artifact — the arrival
# traces themselves are seed-deterministic and fingerprinted.


class FleetSpec(NamedTuple):
    """One fleet load scenario.

    ``cells`` is the query lattice in Zipf rank order; each of
    ``n_workers`` workers replays ``queries_per_worker`` arrivals drawn
    from ``Zipf(zipf_s)`` with stream seed ``seed + 1000 * worker``
    (deterministic per worker, different across workers).
    ``warm_count`` hottest cells are pre-published through worker 0
    before the replay.  ``sigterm_worker``/``sigterm_after`` drive the
    preemption drill: that worker receives SIGTERM after its client has
    dispatched that many arrivals (its remaining arrivals fail over to
    the survivors)."""

    cells: Tuple[Tuple[float, float, float], ...]
    model_kwargs: dict
    n_workers: int = 4
    queries_per_worker: int = 40
    seed: int = 0
    zipf_s: float = 0.9
    scenario: str = "aiyagari"
    priority_mix: Tuple[float, float] = (0.7, 0.3)  # INTERACTIVE, BATCH
    prefetch_k: int = 0
    lease_ttl_s: float = 2.0
    warm_count: int = 0
    max_batch: int = 4
    sigterm_worker: Optional[int] = None
    sigterm_after: Optional[int] = None
    # fraction of arrivals redrawn uniformly inside the
    # lattice's bounding hull (continuous-parameter queries for the
    # surrogate tier).  Extra RNG draws happen ONLY when positive, so
    # frac=0 traces stay bit-identical to pre-surrogate fleets.
    offlattice_frac: float = 0.0
    # SurrogatePolicy field overrides forwarded to every worker's
    # ``--surrogate`` flag (None = workers serve without a surrogate).
    surrogate: Optional[dict] = None
    # coordination backend spec forwarded to every worker's
    # ``--lease-backend`` flag (None = the shared-dir default).  The
    # harness's own lease audit uses the SAME spec, so a CAS-backed
    # fleet is audited against the CAS authority, not an empty dir.
    lease_backend: Optional[str] = None
    # the workers' ``--device`` (the card by default; "cpu" in the CPU
    # tests).  Left out of every digest.
    device: str = "cuda"


class FleetReport(NamedTuple):
    """One fleet run's record (``run_fleet_load``)."""

    workers: int
    arrivals: int
    counts: dict                # outcome -> count, fleet-wide
    outcomes_by_worker: list    # per client thread, in dispatch order
    unresolved: int             # arrivals without a terminal outcome
    p50_ms: dict                # real-wall latency p50 per path
    p99_ms: dict
    cold_solves: int            # FLEET_PUBLISH events fleet-wide
    distinct_published: int     # |union of published keys|
    dedup_ratio: Optional[float]  # cold_solves / distinct (1.0 = exact)
    prefetch_issued: int
    prefetch_converted: int     # speculative-published keys later HIT
    remote_hits: int            # hits served from a peer's publish
    claims_won: int
    claims_lost: int
    lease_reclaims: int
    leases_leaked: int          # lease files left after the TTL sweep
    interrupted_rcs: dict       # worker index -> return code (drilled)
    interrupted_journaled: bool  # the SIGTERMed worker journaled typed
    trace_digest: str           # fingerprint of the arrival traces
    worker_snapshots: list      # /metrics of workers alive at the end
    served_values: dict         # key -> first served value fields (the
    #                             bit-identity acceptance input)
    value_divergence: int       # keys whose served VALUE fields ever
    #                             disagreed across responses (MUST be 0:
    #                             loser-serves-winner bit-identity)
    chaos: Optional[dict] = None  # the chaos campaign's ledger when a
    #                             ChaosPlan ran: per-drill
    #                             records, injected/detected counts,
    #                             drilled dedup ratio, availability and
    #                             churn/hedge accounting
    worker_launches: Optional[dict] = None  # worker index -> the lane
    #                             kernels' launches its FLEET_EXIT line
    #                             reported (None: killed before it)


def generate_fleet_arrivals(spec: FleetSpec, worker: int) -> list:
    """Worker ``worker``'s deterministic Zipf trace: a list of
    ``(cell, priority)`` drawn from one ``default_rng(seed + 1000 *
    worker)`` stream in a fixed order."""
    if not spec.cells:
        raise ValueError("FleetSpec.cells must be non-empty")
    rng = np.random.default_rng(spec.seed + 1000 * int(worker))
    n = len(spec.cells)
    p = np.arange(1, n + 1, dtype=np.float64) ** -float(spec.zipf_s)
    p /= p.sum()
    mix = np.asarray(spec.priority_mix, dtype=np.float64)
    mix = mix / mix.sum()
    off = float(spec.offlattice_frac)
    if off > 0.0:
        hull = np.asarray(spec.cells, dtype=np.float64)
        lo, hi = hull.min(axis=0), hull.max(axis=0)
    out = []
    for _ in range(int(spec.queries_per_worker)):
        cell = spec.cells[int(rng.choice(n, p=p))]
        if off > 0.0 and rng.random() < off:
            cell = tuple(float(c)
                         for c in lo + rng.random(lo.shape[0]) * (hi - lo))
        priority = int(rng.choice(len(mix), p=mix))
        out.append((tuple(float(c) for c in cell), priority))
    return out


def _spawn_worker(spec: FleetSpec, store_dir: str, journal_path: str,
                  owner: str, chaos: bool = False):
    """Start ONE ``serve.fleet`` worker process over the shared store
    (does not wait for readiness — pair with ``_await_ready``)."""
    import json as _json
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "aiyagari_hark_tpu_torch.serve.fleet",
           "--store", store_dir, "--owner", owner,
           "--kwargs", _json.dumps(spec.model_kwargs),
           "--scenario", spec.scenario,
           "--lease-ttl", str(spec.lease_ttl_s),
           "--max-batch", str(spec.max_batch),
           "--journal", journal_path,
           "--max-seconds", "600", "--device", spec.device]
    if spec.prefetch_k > 0:
        cmd += ["--prefetch-k", str(spec.prefetch_k),
                "--prefetch-cells",
                _json.dumps([list(c) for c in spec.cells])]
    if spec.surrogate is not None:
        cmd += ["--surrogate", _json.dumps(spec.surrogate)]
    if spec.lease_backend is not None:
        cmd += ["--lease-backend", spec.lease_backend]
    if chaos:
        cmd += ["--chaos"]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)


def exit_launches(proc) -> Optional[dict]:
    """The lane kernels' launch counts an exited worker printed on its
    ``FLEET_EXIT`` line (the rest of its standard output is read here),
    or None when it printed none (killed, or died before the line)."""
    if proc.stdout is None or proc.stdout.closed:
        return None
    for line in proc.stdout.read().splitlines():
        if line.startswith("FLEET_EXIT") and "launches=" in line:
            return json.loads(line.split("launches=", 1)[1])
    return None


def _await_ready(proc, label, watch: Stopwatch,
                 ready_timeout_s: float) -> int:
    """Block until one worker prints FLEET_READY; returns its port.
    ``watch`` carries the shared budget across a whole pool spawn."""
    import selectors

    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    try:
        while True:
            # the timeout must bound the BLOCKED wait too: a
            # silent-but-alive worker (hung before its READY
            # print) would otherwise defeat it — readline alone
            # only returns on a line or on process exit
            left = ready_timeout_s - watch.elapsed()
            if left <= 0 or not sel.select(timeout=left):
                raise RuntimeError(
                    f"fleet worker {label} not ready in "
                    f"{ready_timeout_s:g}s")
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError(
                    f"fleet worker {label} exited before "
                    f"FLEET_READY (rc={proc.poll()})")
            if line.startswith("FLEET_READY"):
                return int(line.split("port=")[1].split()[0])
    finally:
        sel.close()


def _spawn_fleet(spec: FleetSpec, store_dir: str,
                 journal_paths: list, ready_timeout_s: float,
                 chaos: bool = False):
    """Start ``n_workers`` ``serve.fleet`` worker processes over one
    shared store; returns ``(procs, urls)`` once every worker printed
    FLEET_READY."""
    procs, urls = [], []
    for i in range(spec.n_workers):
        procs.append(_spawn_worker(spec, store_dir, journal_paths[i],
                                   f"w{i}", chaos=chaos))
    watch = Stopwatch()
    try:
        for i, proc in enumerate(procs):
            port = _await_ready(proc, i, watch, ready_timeout_s)
            urls.append(f"http://127.0.0.1:{port}")
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return procs, urls


class FleetCtl:
    """Live handle on a spawned worker pool: the interface the chaos
    drills (``serve.chaos.run_drills``) consume.  Everything goes
    through public surfaces — HTTP endpoints, process state, journal
    files — never through harness-private flags, so a drill's detection
    evidence is exactly what a postmortem would read."""

    def __init__(self, spec: FleetSpec, procs: list, urls: list,
                 journal_paths: list, store_dir: str,
                 timeout_s: float = 300.0):
        from .fleet import FleetClient

        self._spec = spec
        self.procs = procs
        self.urls = urls
        self.journal_paths = journal_paths
        self.store_dir = store_dir
        self.lease_ttl_s = float(spec.lease_ttl_s)
        # a BARE client (no retry/hedge): a drill's query must reach
        # exactly the worker it targets, with only connection failover
        self._client = FleetClient(list(urls), timeout=timeout_s)
        self._client.urls = urls   # live alias: joins become visible

    def alive(self, i: int) -> bool:
        return self.procs[i].poll() is None

    def returncode(self, i: int):
        return self.procs[i].poll()

    def kill(self, i: int, sig) -> None:
        self.procs[i].send_signal(sig)

    def two_live_workers(self):
        live = [i for i in range(len(self.procs)) if self.alive(i)]
        if len(live) < 2:
            from .chaos import DrillError

            raise DrillError(
                f"drill needs two live workers, have {len(live)}")
        return live[0], live[1]

    def query(self, cell, prefer=None) -> dict:
        return self._client.query(cell, self._spec.model_kwargs,
                                  scenario=self._spec.scenario,
                                  prefer=prefer)

    def post(self, worker: int, path: str, body: dict) -> dict:
        from urllib import request as _urlrequest

        data = json.dumps(body).encode("utf-8")
        req = _urlrequest.Request(
            self.urls[worker] + path, data=data,
            headers={"Content-Type": "application/json"})
        with _urlrequest.urlopen(req, timeout=30.0) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def fleet_info(self, worker: int):
        """The worker's ``/fleet`` introspection dict, or None when it
        is dead/unreachable (a drill polling a dying victim)."""
        if not self.alive(worker):
            return None
        try:
            return self._client.get(self.urls[worker], "/fleet")
        except Exception:
            return None


def _publish_counts(journal_paths: list) -> dict:
    """FLEET_PUBLISH count per key across the pool's journals — the
    before/after ledger of the chaos recovery phase."""
    from ..obs.journal import read_journal

    counts: dict = {}
    for jp in list(journal_paths):
        if not os.path.exists(jp):
            continue
        for ev in read_journal(jp, event="FLEET_PUBLISH"):
            k = int(ev["key"])
            counts[k] = counts.get(k, 0) + 1
    return counts


def run_fleet_load(spec: FleetSpec, store_dir: str,
                   ready_timeout_s: float = 180.0,
                   client_timeout_s: float = 300.0,
                   chaos=None) -> FleetReport:
    """Replay one fleet scenario against a freshly spawned worker pool
    sharing ``store_dir`` and aggregate the fleet-wide record.

    Outcome vocabulary per arrival: ``served:<path>`` (hit / near /
    cold / degraded_neighbor), ``reject:<Error>`` (a typed error payload
    from a live worker), ``error:disconnected`` (every worker
    unreachable — only possible mid-drill).  The invariant ``unresolved
    == 0`` (every arrival reaches a terminal outcome even with a worker
    SIGTERMed mid-load) is part of the fleet's acceptance.

    Dedup accounting comes from the workers' event journals (one
    FLEET_PUBLISH per completed claim, key attached) — journals survive
    the drilled worker's death, so the killed worker's solves still
    count.

    ``chaos``: a ``serve.chaos.ChaosPlan``.  Workers spawn
    with ``--chaos`` (the arm endpoint), the plan's churn schedule
    (join/leave) runs DURING the replay, the client gains the typed
    retry + hedging policies, and after the replay every drill runs
    sequentially against the live pool, followed by a recovery phase
    whose duplicate publishes are ledgered.  The campaign's record
    lands in ``FleetReport.chaos``; the headline ``dedup_ratio`` then
    covers NON-drill keys only (drill keys carry their own accounting,
    expected duplicates separated from violations)."""
    import signal

    from ..obs.journal import read_journal
    from .fleet import FleetClient, FleetHTTPError, HedgePolicy, RetryPolicy

    os.makedirs(store_dir, exist_ok=True)
    journal_paths = [os.path.join(store_dir, f"journal_w{i}.jsonl")
                     for i in range(spec.n_workers)]
    procs, urls = _spawn_fleet(spec, store_dir, journal_paths,
                               ready_timeout_s, chaos=chaos is not None)
    harness_obs = None
    if chaos is not None:
        from ..obs.runtime import ObsConfig, build_obs

        harness_obs = build_obs(ObsConfig(
            enabled=True,
            journal_path=os.path.join(store_dir,
                                      "journal_harness.jsonl")))
    client = (FleetClient(urls, timeout=client_timeout_s)
              if chaos is None else
              FleetClient(urls, timeout=client_timeout_s,
                          retry=RetryPolicy(), hedge=HedgePolicy(),
                          obs=harness_obs))
    traces = [generate_fleet_arrivals(spec, i)
              for i in range(spec.n_workers)]
    trace_digest = hashlib.blake2b(
        json.dumps([[list(c) + [pr] for c, pr in t] for t in traces],
                   sort_keys=True).encode(),
        digest_size=16).hexdigest()

    warm_keys: set = set()
    for cell in spec.cells[:spec.warm_count]:
        res = client.query(cell, spec.model_kwargs,
                           scenario=spec.scenario, prefer=0)
        warm_keys.add(int(res["key"]))

    if chaos is not None:
        client.urls = urls   # live alias: churn joins become visible

    outcomes_by_worker = [[] for _ in range(spec.n_workers)]
    walls_by_path: dict = {}
    hit_keys: set = set()
    served_values: dict = {}
    value_divergence = 0
    unresolved = 0
    dispatched = 0
    lock = threading.Lock()
    drill_fired = threading.Event()

    def _client_loop(i: int) -> None:
        nonlocal unresolved, value_divergence, dispatched
        for k, (cell, priority) in enumerate(traces[i]):
            with lock:
                dispatched += 1
            if (spec.sigterm_worker is not None
                    and i == spec.sigterm_worker
                    and k == spec.sigterm_after
                    and not drill_fired.is_set()):
                drill_fired.set()
                procs[spec.sigterm_worker].send_signal(signal.SIGTERM)
            try:
                with stopwatch() as sw:
                    res = client.query(cell, spec.model_kwargs,
                                       scenario=spec.scenario,
                                       priority=priority, prefer=i)
                path = (res["quality"] if res["quality"] != "exact"
                        else res["path"])
                outcome = f"served:{path}"
                with lock:
                    walls_by_path.setdefault(path, []).append(
                        sw.seconds * 1e3)
                    if path == "hit":
                        hit_keys.add(int(res["key"]))
                    # loser-serves-winner bit-identity: every response
                    # for one fingerprint must carry the SAME value
                    # fields (the exactly-once publish is the only
                    # source; counters ride the winner's solve too).
                    # Degraded answers are a DIFFERENT calibration's row
                    # served under that key on purpose — excluded.
                    # ``bracket_init`` is non-None exactly on the
                    # response that SOLVED the key (near/cold): keep it
                    # when seen, so the bit-identity acceptance can
                    # replay the same seed through reference_solve (the
                    # bit contract is same-seed, and a warm-solved
                    # capital is evaluated under the warm seed).
                    if res["quality"] == "exact":
                        vals = {"cell": list(cell),
                                "r_star": res["r_star"],
                                "capital": res["capital"],
                                "labor": res["labor"],
                                "status": res["status"]}
                        key = int(res["key"])
                        rec = served_values.setdefault(
                            key, dict(vals, bracket_init=None))
                        if {k: rec[k] for k in vals} != vals:
                            value_divergence += 1
                        if res.get("bracket_init") is not None:
                            rec["bracket_init"] = res["bracket_init"]
            except FleetHTTPError as e:
                outcome = f"reject:{e.payload.get('error')}"
            except ConnectionError:
                outcome = "error:disconnected"
            except BaseException as e:
                with lock:
                    unresolved += 1
                outcome = f"unresolved:{type(e).__name__}"
            with lock:
                outcomes_by_worker[i].append(outcome)

    # elasticity schedule: scripted joins/leaves applied
    # while the replay is live, keyed on the fleet-wide dispatch count.
    # A leave SIGTERMs (graceful, exit 75, leases TTL-reclaimed); a
    # join spawns a fresh --chaos worker into the pool (reachable via
    # failover and hedges).  Both are journaled to the harness journal.
    churn_counts = {"joins": 0, "leaves": 0}
    churn_left: set = set()
    churn_stop = threading.Event()
    churn_thread = None

    def _churn_loop() -> None:
        import time as _time

        for after, action, widx in sorted(chaos.churn):
            while not churn_stop.is_set():
                with lock:
                    if dispatched >= int(after):
                        break
                _time.sleep(0.02)
            else:
                return   # replay over before this event came due
            if action == "leave":
                w = widx if widx is not None else len(procs) - 1
                if procs[w].poll() is None:
                    churn_left.add(w)
                    procs[w].send_signal(signal.SIGTERM)
                    churn_counts["leaves"] += 1
                    harness_obs.event("WORKER_LEAVE", worker=w,
                                      owner=f"w{w}", after=int(after))
            elif action == "join":
                idx = len(procs)
                jp = os.path.join(store_dir, f"journal_w{idx}.jsonl")
                proc = _spawn_worker(spec, store_dir, jp, f"w{idx}",
                                     chaos=True)
                try:
                    port = _await_ready(proc, idx, Stopwatch(),
                                        ready_timeout_s)
                except Exception:
                    proc.kill()
                    raise
                journal_paths.append(jp)
                procs.append(proc)
                urls.append(f"http://127.0.0.1:{port}")
                churn_counts["joins"] += 1
                harness_obs.event("WORKER_JOIN", worker=idx,
                                  owner=f"w{idx}", after=int(after))

    if chaos is not None and chaos.churn:
        churn_thread = threading.Thread(target=_churn_loop,
                                        name="fleet-churn", daemon=True)
        churn_thread.start()

    threads = [threading.Thread(target=_client_loop, args=(i,),
                                name=f"fleet-client-{i}")
               for i in range(spec.n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(client_timeout_s + 60.0)
        if t.is_alive():
            unresolved += 1
    churn_stop.set()
    if churn_thread is not None:
        churn_thread.join(ready_timeout_s)

    # chaos campaign: every drill sequentially against the
    # live pool, then a recovery phase whose duplicate publishes are
    # ledgered (a re-publish of an already-published key after the
    # drills is an exactly-once violation, not noise)
    drill_info = None
    recovery_served = recovery_errors = recovery_dup = 0
    if chaos is not None:
        from .chaos import run_drills

        ctl = FleetCtl(spec, procs, urls, list(journal_paths) + [
            os.path.join(store_dir, "journal_harness.jsonl")],
            store_dir, timeout_s=client_timeout_s)
        try:
            drill_info = run_drills(chaos, ctl)
            pubs_before = _publish_counts(journal_paths)
            for k in range(int(chaos.recovery_queries)):
                cell = spec.cells[k % len(spec.cells)]
                try:
                    ctl.query(cell)
                    recovery_served += 1
                except Exception:
                    recovery_errors += 1
            pubs_after = _publish_counts(journal_paths)
            recovery_dup = sum(
                pubs_after[k] - n for k, n in pubs_before.items()
                if pubs_after.get(k, 0) > n)
        except BaseException:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            raise

    # final snapshots from live workers, then graceful shutdown
    worker_snapshots = []
    for i, url in enumerate(urls):
        if procs[i].poll() is not None:
            continue
        try:
            worker_snapshots.append(client.get(url, "/metrics"))
        except Exception:
            pass
    rcs: dict = {}
    worker_launches: dict = {}
    for i, proc in enumerate(procs):
        # the drilled worker already received its SIGTERM (so did any
        # churn-departed worker); a second one landing after its
        # preemption_guard exited (handlers restored) would kill it
        # mid-cleanup with the default action
        if proc.poll() is None and i not in churn_left \
                and not (drill_fired.is_set()
                         and i == spec.sigterm_worker):
            proc.send_signal(signal.SIGTERM)
    for i, proc in enumerate(procs):
        try:
            rcs[i] = proc.wait(60.0)
        except Exception:
            proc.kill()
            rcs[i] = proc.wait()
        worker_launches[i] = exit_launches(proc)
        if proc.stdout is not None:
            proc.stdout.close()

    # journal-based fleet accounting (survives the drilled death)
    publishes, spec_published, prefetch_issued = [], set(), 0
    seed_by_key: dict = {}
    claims_won = claims_lost = reclaims = 0
    # vacuously true only when NO drill ran; a drilled worker whose
    # journal never materialized is a FAILED journaling leg, not a pass
    interrupted_journaled = spec.sigterm_worker is None
    for i, jp in enumerate(journal_paths):
        if not os.path.exists(jp):
            continue
        for ev in read_journal(jp, event="FLEET_PUBLISH"):
            publishes.append(int(ev["key"]))
            if ev.get("speculative"):
                spec_published.add(int(ev["key"]))
            if ev.get("seed") is not None:
                seed_by_key[int(ev["key"])] = ev["seed"]
        claims_won += len(read_journal(jp, event="FLEET_CLAIM"))
        reclaims += len(read_journal(jp, event="FLEET_LEASE_RECLAIM"))
        prefetch_issued += len(read_journal(jp,
                                            event="PREFETCH_ISSUED"))
        if i == spec.sigterm_worker:
            interrupted_journaled = bool(
                read_journal(jp, event="INTERRUPTED"))

    # lease-leak audit through the store's own API (the canonical lease
    # spelling lives in ONE place): anything a dead worker still held
    # goes stale within the TTL; sweep then count what survived (must
    # be zero)
    import time as _time

    from .store import SolutionStore

    # the audit MUST interrogate the same coordination authority the
    # workers used: auditing a CAS-backed fleet against the
    # shared directory would vacuously find zero leases
    audit_backend = None
    if spec.lease_backend is not None:
        from .lease import make_backend

        audit_backend = make_backend(spec.lease_backend, root=store_dir)
    audit = SolutionStore(disk_path=store_dir, shared=True,
                          lease_ttl_s=spec.lease_ttl_s, owner="audit",
                          lease_backend=audit_backend)
    deadline = Stopwatch()
    while (audit.lease_files()
           and deadline.elapsed() < spec.lease_ttl_s + 10.0):
        audit.gc_stale_leases()
        if audit.lease_files():
            _time.sleep(0.2)
    leaked = len(audit.lease_files())
    audit.close()

    # every published solve's exact seed came through its journal, so
    # keys whose solving RESPONSE no client saw (prefetch solves, a
    # drilled worker's lost reply) still compare same-seed downstream
    for key, rec in served_values.items():
        if rec.get("bracket_init") is None and key in seed_by_key:
            rec["bracket_init"] = seed_by_key[key]

    counts: dict = {}
    for seq in outcomes_by_worker:
        for o in seq:
            counts[o] = counts.get(o, 0) + 1
    arrivals = sum(len(s) for s in outcomes_by_worker)
    # headline dedup stays the CLEAN ledger: when a chaos campaign ran,
    # its drill keys (which legitimately re-publish under torn-entry /
    # stalled-winner / skewed-election faults) get their own accounting
    # below — mixing them in would make the exactly-once invariant
    # unfalsifiable
    drill_keys = (set() if drill_info is None
                  else set(drill_info["drill_keys"]))
    main_pubs = [k for k in publishes if k not in drill_keys]
    distinct = len(set(main_pubs))
    converted = len({k for k in spec_published
                     if k in hit_keys and k not in warm_keys})

    def _pctl(vals, q):
        if not vals:
            return None
        s = sorted(vals)
        return round(s[min(len(s) - 1,
                           max(0, round(q / 100.0 * (len(s) - 1))))], 4)

    remote_hits = sum(int(s.get("fleet_remote_hits", 0))
                      for s in worker_snapshots)
    claims_lost = sum(int(s.get("fleet_claims_lost", 0))
                      for s in worker_snapshots)
    all_walls = [w for v in walls_by_path.values() for w in v]
    p50_ms = {p: _pctl(v, 50) for p, v in walls_by_path.items()}
    p99_ms = {p: _pctl(v, 99) for p, v in walls_by_path.items()}
    p50_ms["all"] = _pctl(all_walls, 50)
    p99_ms["all"] = _pctl(all_walls, 99)

    chaos_rec = None
    if drill_info is not None:
        served = sum(v for o, v in counts.items()
                     if o.startswith("served:"))
        # the DRILLED dedup ratio: every publish except the drills'
        # EXPECTED duplicates must still be exactly-once — what remains
        # above 1.0 is a real protocol violation
        expected = set(drill_info["expected_dup_keys"])
        honest = [k for k in publishes if k not in expected]
        chaos_rec = {
            "drills": drill_info["drills"],
            "injected": int(drill_info["injected"]),
            "detected": int(drill_info["detected"]),
            "dedup_ratio": (None if not honest else
                            round(len(honest) / len(set(honest)), 4)),
            "recovery_dup_publishes": int(recovery_dup),
            "recovery_served": int(recovery_served),
            "recovery_errors": int(recovery_errors),
            "availability": (None if arrivals == 0
                             else round(served / arrivals, 4)),
            "churn_p99_ms": p99_ms["all"],
            "joins": churn_counts["joins"],
            "leaves": churn_counts["leaves"],
            "kills": sum(1 for p in procs
                         if p.poll() == -int(signal.SIGKILL)),
            "hedges": client.hedge_counts(),
        }
    if harness_obs is not None:
        harness_obs.close()
    return FleetReport(
        workers=spec.n_workers, arrivals=arrivals, counts=counts,
        outcomes_by_worker=outcomes_by_worker, unresolved=unresolved,
        p50_ms=p50_ms, p99_ms=p99_ms,
        cold_solves=len(main_pubs), distinct_published=distinct,
        dedup_ratio=(None if distinct == 0
                     else round(len(main_pubs) / distinct, 4)),
        prefetch_issued=prefetch_issued, prefetch_converted=converted,
        remote_hits=remote_hits, claims_won=claims_won,
        claims_lost=claims_lost, lease_reclaims=reclaims,
        leases_leaked=leaked, interrupted_rcs=rcs,
        interrupted_journaled=interrupted_journaled,
        trace_digest=trace_digest, worker_snapshots=worker_snapshots,
        served_values=served_values, value_divergence=value_divergence,
        chaos=chaos_rec, worker_launches=worker_launches)
