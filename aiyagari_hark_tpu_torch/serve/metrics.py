"""Serving observability: counters, latency histograms, compile counts
(port of ``aiyagari_hark_tpu/serve/metrics.py``, host code, copied; the
same snapshot keys).

The serving analogue of the bench record fields: every number the
``--serve-smoke`` bench mode emits (``serve_hit_rate``, ``serve_p50_ms``,
``serve_batch_occupancy``, ``serve_compiles``, ...) is accumulated here,
thread-safely, by the ``EquilibriumService`` hot path.  Kept deliberately
dependency-free (no torch import): recording a hit must cost
microseconds — the exact-hit latency budget is < 1 ms end to end.
"""

from __future__ import annotations

import threading
import weakref

from ..utils.timing import CompileCounter

# Served-request paths, in cache-goodness order.  "degraded" is the
# overload brown-out path: a nearest-neighbor answer served
# from the store under pressure, tagged ``quality="degraded_neighbor"``.
# "surrogate" is the continuous-parameter interpolation tier:
# an off-lattice answer fit over the k nearest certified stored
# solutions, tagged ``quality="surrogate"`` with its error bound.
PATHS = ("hit", "near", "cold", "degraded", "surrogate")


class LatencyHistogram:
    """Bounded latency sample set with exact percentiles.

    Samples beyond ``cap`` are dropped by decimation (every other kept),
    so long soaks stay O(cap) memory while early AND late samples keep
    representation; ``count`` always reflects every observation."""

    def __init__(self, cap: int = 8192):
        self.cap = int(cap)
        self.samples: list = []
        self.count = 0
        self._stride = 1
        self._seen = 0

    def add(self, seconds: float) -> None:
        self.count += 1
        self._seen += 1
        if self._seen % self._stride:
            return
        self.samples.append(float(seconds))
        if len(self.samples) >= self.cap:
            self.samples = self.samples[::2]
            self._stride *= 2

    def percentile(self, q: float):
        """q in [0, 100]; None when no samples were recorded."""
        if not self.samples:
            return None
        s = sorted(self.samples)
        idx = min(len(s) - 1, max(0, round(q / 100.0 * (len(s) - 1))))
        return s[idx]


class ServeMetrics:
    """Thread-safe accumulator for one ``EquilibriumService``'s lifetime.

    * per-path request counts and latencies (submit -> future resolved);
    * batch shape accounting: real lanes vs padded ladder shape
      (``serve_batch_occupancy`` is mean real/shape over launches);
    * queue depth peak;
    * compile activity via ``utils.timing.CompileCounter`` — the
      service holds ``compile`` entered around every device launch, so
      ``serve_compiles`` counts the kernel libraries built or loaded
      for serving (a library already loaded fires nothing: the
      zero-compiles-after-warmup contract's number).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.served = {p: 0 for p in PATHS}
        # scenario disaggregation: per-(scenario,
        # path) served counts, so a multi-scenario service's traffic mix
        # is visible in snapshot()/prometheus_text() instead of blending
        # model families into one rate
        self.served_by_scenario: dict = {}
        self.failures = 0
        self.batches = 0
        self.lanes_real = 0
        self.lanes_padded = 0
        self.queue_depth_peak = 0
        self.latency = {p: LatencyHistogram() for p in PATHS}
        self.latency_all = LatencyHistogram()
        self.compile = CompileCounter()
        # precision-ladder phase accounting (DESIGN §5): per-phase inner
        # steps of every solved (non-hit) query, and how many inner fixed
        # points escalated descent -> reference
        self.descent_steps = 0
        self.polish_steps = 0
        self.precision_escalations = 0
        # integrity layer (DESIGN §9): deadline expirations at
        # batch seams, per-level certificate verdicts of certified
        # queries, and the store's corrupt-eviction counter (provided by
        # the SolutionStore so the metrics module stays dependency-free)
        self.deadline_expirations = 0
        self.certificates = {"certified": 0, "marginal": 0, "failed": 0}
        # overload layer (DESIGN §11): fail-fast admission
        # rejections, displaced (shed) pendings, breaker activity, and
        # submit-time deadline rejections (counted APART from the seam
        # expirations above — a rejected query never held a queue slot).
        # ``depth_hist`` samples the queue depth at submit AND at pop
        # (pre-pop depth), closing the drain-heavy understatement the
        # submit-only peak had.
        self.overloaded = 0
        self.load_sheds = 0
        self.circuit_rejects = 0
        self.deadline_rejects = 0
        self.breaker = {"opened": 0, "reopened": 0, "closed": 0,
                        "probe": 0}
        self.depth_hist = LatencyHistogram()
        # speculative neighbor prefetch: queries the service
        # issued at Priority.SPECULATIVE around misses, how many of
        # their stored solutions later converted a would-be miss into an
        # exact hit, and how many issues the overload layer suppressed
        # (prefetch is best-effort by construction — a rejected
        # speculative submit is working as designed, not an error)
        self.prefetch_issued = 0
        self.prefetch_converted = 0
        self.prefetch_suppressed = 0
        # surrogate tier: interpolated answers served, the
        # per-reason escalation counts (too_few_donors / donor_too_far /
        # bound_exceeded / audit), seeded-audit outcomes (an audit
        # failure = the real solve landed OUTSIDE the surrogate's own
        # reported bound — loud by design), lattice refinement points
        # published from escalated solves, and the reported error bound
        # distribution (reusing the latency-histogram percentiles)
        self.surrogate_escalations: dict = {}
        self.audits = 0
        self.audit_failures = 0
        self.lattice_refinements = 0
        self.surrogate_bounds = LatencyHistogram()
        # fleet tier: exact hits served from a PEER worker's
        # publish (discovered at the claim gate or the waiter poll)
        self.fleet_remote_hits = 0
        # provider id -> [WeakMethod, last dict] — the store's fleet
        # claim/publish/reclaim counters, merged like the eviction
        # counter below (weak, accumulate-across-stores)
        self._fleet_counts: dict = {}
        self._retired_fleet: dict = {}
        # provider id -> [WeakMethod, last-seen eviction count]: weak so
        # a long-lived shared metrics object cannot pin dead services'
        # stores (each bound provider strongly references its store's
        # whole memory tier); last-seen so a garbage-collected store's
        # final observed count stays in the sum (folded into the retired
        # total when its id is reused by a new store)
        self._store_counts: dict = {}
        self._retired_evictions = 0

    def attach_store(self, counts_provider) -> None:
        """Register a ``SolutionStore.integrity_counts`` provider whose
        counters ``snapshot`` merges (``store_corrupt_evictions``).
        Providers ACCUMULATE: a ``ServeMetrics`` shared by several
        services reports the SUM over their stores (a re-registered
        provider — e.g. two services over one store — counts once);
        holds only a weak reference."""
        with self._lock:
            key = id(counts_provider.__self__)
            entry = self._store_counts.get(key)
            if entry is not None:
                if entry[0]() is not None:
                    return      # same live store, already tracked
                # CPython id reuse: a NEW store was allocated at a
                # garbage-collected store's address — retire the dead
                # provider's final observed count (it must stay in the
                # sum) and track the new store from zero
                self._retired_evictions += entry[1]
            self._store_counts[key] = [weakref.WeakMethod(
                counts_provider), 0]

    def attach_fleet(self, counts_provider) -> None:
        """Register a ``SolutionStore.fleet_counts`` provider whose
        claim/publish/reclaim counters ``snapshot`` merges — the same
        weak, accumulate-across-stores semantics as ``attach_store``."""
        with self._lock:
            key = id(counts_provider.__self__)
            entry = self._fleet_counts.get(key)
            if entry is not None:
                if entry[0]() is not None:
                    return
                for k, v in entry[1].items():
                    self._retired_fleet[k] = (
                        self._retired_fleet.get(k, 0) + v)
            self._fleet_counts[key] = [weakref.WeakMethod(
                counts_provider), {}]

    def _fleet_totals(self) -> dict:
        totals = dict(self._retired_fleet)
        for entry in self._fleet_counts.values():
            provider = entry[0]()
            if provider is not None:
                entry[1] = provider()
            for k, v in entry[1].items():
                totals[k] = totals.get(k, 0) + v
        for k in ("fleet_claims_won", "fleet_claims_lost",
                  "fleet_publishes", "fleet_lease_reclaims"):
            totals.setdefault(k, 0)
        return totals

    def record_prefetch_issued(self) -> None:
        """One speculative neighbor query was enqueued."""
        with self._lock:
            self.prefetch_issued += 1

    def record_prefetch_converted(self) -> None:
        """One exact hit was served from a solution a prefetch stored —
        a would-be cold miss converted (counted once per stored key)."""
        with self._lock:
            self.prefetch_converted += 1

    def record_prefetch_suppressed(self) -> None:
        """One prefetch issue was declined by the overload layer or a
        full queue (best-effort by construction)."""
        with self._lock:
            self.prefetch_suppressed += 1

    def record_remote_hit(self) -> None:
        """One exact hit served from a peer worker's publish (fleet)."""
        with self._lock:
            self.fleet_remote_hits += 1

    def record_surrogate_bound(self, bound: float) -> None:
        """One surrogate answer's reported error bound (r* units)."""
        with self._lock:
            self.surrogate_bounds.add(float(bound))

    def record_surrogate_escalated(self, reason: str) -> None:
        """One surrogate-eligible query escalated to a real solve."""
        with self._lock:
            self.surrogate_escalations[str(reason)] = (
                self.surrogate_escalations.get(str(reason), 0) + 1)

    def record_audit(self, ok: bool) -> None:
        """One seeded-audit escalation resolved: the real solve landed
        inside (ok) or outside (FAILED — loud) the surrogate's own
        reported error bound."""
        with self._lock:
            self.audits += 1
            if not ok:
                self.audit_failures += 1

    def record_lattice_refined(self) -> None:
        """One escalated solve was published as a parameter-space
        refinement point (the lattice densified where the surrogate
        failed)."""
        with self._lock:
            self.lattice_refinements += 1

    def _store_evictions(self) -> int:
        total = self._retired_evictions
        for entry in self._store_counts.values():
            provider = entry[0]()
            if provider is not None:
                entry[1] = provider()["store_corrupt_evictions"]
            total += entry[1]
        return total

    def record_expired(self, latency_s: float) -> None:
        """One query failed with ``DeadlineExceeded`` at a batch seam."""
        with self._lock:
            self.deadline_expirations += 1
            self.latency_all.add(latency_s)

    def record_deadline_reject(self) -> None:
        """One query was rejected at SUBMIT because its deadline had
        already effectively passed, or (deadline-aware admission) could
        not be met given the queue — no slot was ever held."""
        with self._lock:
            self.deadline_rejects += 1

    def record_overloaded(self) -> None:
        """One arrival was rejected fail-fast by admission control."""
        with self._lock:
            self.overloaded += 1

    def record_shed(self, waited_s: float) -> None:
        """One queued pending was displaced by a higher-priority arrival
        (typed ``LoadShed`` on its future)."""
        with self._lock:
            self.load_sheds += 1
            self.latency_all.add(waited_s)

    def record_circuit_reject(self) -> None:
        """One arrival fast-failed on an open regional breaker."""
        with self._lock:
            self.circuit_rejects += 1

    def record_breaker(self, transition: str) -> None:
        """One breaker transition: opened/reopened/closed/probe."""
        with self._lock:
            self.breaker[transition] += 1

    def record_certificate(self, level: int) -> None:
        """One cold-miss solution was certified (``certify_before_cache``)."""
        name = ("certified", "marginal", "failed")[max(0, min(2,
                                                              int(level)))]
        with self._lock:
            self.certificates[name] += 1

    def record_served(self, path: str, latency_s: float,
                      scenario: str = "aiyagari") -> None:
        with self._lock:
            self.served[path] += 1
            per = self.served_by_scenario.setdefault(
                str(scenario), {p: 0 for p in PATHS})
            per[path] += 1
            self.latency[path].add(latency_s)
            self.latency_all.add(latency_s)

    def record_phases(self, descent: int, polish: int,
                      escalations: int) -> None:
        with self._lock:
            self.descent_steps += int(descent)
            self.polish_steps += int(polish)
            self.precision_escalations += int(escalations)

    def record_failure(self, latency_s: float) -> None:
        with self._lock:
            self.failures += 1
            self.latency_all.add(latency_s)

    def record_batch(self, n_real: int, shape: int) -> None:
        with self._lock:
            self.batches += 1
            self.lanes_real += int(n_real)
            self.lanes_padded += int(shape)

    def note_queue_depth(self, depth: int) -> None:
        """One queue-depth sample — taken at submit AND at every pop
        (the pre-pop depth), so drain-heavy loads no longer understate
        the peak; every sample also feeds the depth
        histogram (``serve_queue_depth_p50``/``p99``)."""
        with self._lock:
            if depth > self.queue_depth_peak:
                self.queue_depth_peak = depth
            self.depth_hist.add(float(depth))

    @staticmethod
    def _ms(value):
        return None if value is None else round(value * 1e3, 4)

    def publish(self, registry) -> None:
        """Mirror the snapshot into an ``obs.MetricsRegistry``
        without changing this class's public API: every numeric
        ``serve_*`` field becomes an ``aiyagari_``-prefixed gauge
        (gauges, not counters — a snapshot is a level, and rates/
        percentiles go down).  The ``EquilibriumService`` publishes on
        ``close()`` when observability is enabled; callers wanting a
        live scrape call this before ``registry.prometheus_text()``."""
        if registry is None:
            return
        for name, value in self.snapshot().items():
            if isinstance(value, bool) or not isinstance(value,
                                                         (int, float)):
                continue
            registry.gauge(f"aiyagari_{name}").set(float(value))
        # per-quality served gauges: one gauge per serving
        # path so a scrape splits the answer-quality mix directly
        with self._lock:
            served = dict(self.served)
        for path, n in served.items():
            registry.gauge(f"aiyagari_serve_served_{path}").set(float(n))
        # per-scenario disaggregation: one gauge per
        # (scenario, path) so prometheus_text() splits the traffic mix
        # by model family
        with self._lock:
            per = {s: dict(c) for s, c in self.served_by_scenario.items()}
        for scenario, counts in per.items():
            for path, n in counts.items():
                if n:
                    registry.gauge(
                        f"aiyagari_serve_served_{path}_scenario_"
                        f"{scenario}").set(float(n))

    def snapshot(self) -> dict:
        """The serving record fields, bench-JSON ready (``serve_*``)."""
        with self._lock:
            n = sum(self.served.values()) + self.failures
            total = max(n, 1)
            occ = (self.lanes_real / self.lanes_padded
                   if self.lanes_padded else None)
            return {
                "serve_requests": n,
                "serve_hit_rate": round(self.served["hit"] / total, 4),
                "serve_near_rate": round(self.served["near"] / total, 4),
                "serve_cold_rate": round(self.served["cold"] / total, 4),
                "serve_failures": self.failures,
                "serve_batches": self.batches,
                "serve_batch_occupancy": (None if occ is None
                                          else round(occ, 4)),
                "serve_queue_depth_peak": self.queue_depth_peak,
                "serve_p50_ms": self._ms(self.latency_all.percentile(50)),
                "serve_p95_ms": self._ms(self.latency_all.percentile(95)),
                "serve_hit_p50_ms": self._ms(
                    self.latency["hit"].percentile(50)),
                "serve_hit_p95_ms": self._ms(
                    self.latency["hit"].percentile(95)),
                "serve_compiles": self.compile.compile_events,
                "serve_compile_cache_misses": self.compile.cache_misses,
                "serve_compile_s": round(self.compile.compile_seconds, 3),
                "serve_descent_steps": self.descent_steps,
                "serve_polish_steps": self.polish_steps,
                "serve_polish_frac": (
                    None if self.descent_steps + self.polish_steps == 0
                    else round(self.polish_steps
                               / (self.descent_steps + self.polish_steps),
                               4)),
                "serve_precision_escalations": self.precision_escalations,
                "serve_deadline_expirations": self.deadline_expirations,
                "serve_degraded_rate": round(
                    self.served["degraded"] / total, 4),
                "serve_overloaded": self.overloaded,
                "serve_load_sheds": self.load_sheds,
                "serve_circuit_rejects": self.circuit_rejects,
                "serve_deadline_rejects_submit": self.deadline_rejects,
                "serve_breaker_opens": self.breaker["opened"],
                "serve_breaker_reopens": self.breaker["reopened"],
                "serve_breaker_closes": self.breaker["closed"],
                "serve_breaker_probes": self.breaker["probe"],
                "serve_queue_depth_p50": self.depth_hist.percentile(50),
                "serve_queue_depth_p99": self.depth_hist.percentile(99),
                "serve_certified": self.certificates["certified"],
                "serve_marginal_certificates": self.certificates["marginal"],
                "serve_failed_certificates": self.certificates["failed"],
                "store_corrupt_evictions": self._store_evictions(),
                # surrogate tier: hit rate over ALL requests
                # (UP is better — interpolation displacing cold solves),
                # escalation rate over surrogate-ELIGIBLE requests
                # (DOWN), seeded-audit outcomes, refinement publishes,
                # and the reported error-bound percentiles (r* units,
                # NOT milliseconds — DOWN is better)
                "surrogate_hit_rate": round(
                    self.served["surrogate"] / total, 4),
                "surrogate_escalation_rate": round(
                    sum(self.surrogate_escalations.values())
                    / max(self.served["surrogate"]
                          + sum(self.surrogate_escalations.values()),
                          1), 4),
                "surrogate_escalations": sum(
                    self.surrogate_escalations.values()),
                "surrogate_audits": self.audits,
                "surrogate_audit_failures": self.audit_failures,
                "surrogate_refinements": self.lattice_refinements,
                "surrogate_bound_p50": self.surrogate_bounds.percentile(50),
                "surrogate_bound_p95": self.surrogate_bounds.percentile(95),
                "surrogate_p50_ms": self._ms(
                    self.latency["surrogate"].percentile(50)),
                "surrogate_p95_ms": self._ms(
                    self.latency["surrogate"].percentile(95)),
                # speculative prefetch + fleet tier
                "serve_prefetch_issued": self.prefetch_issued,
                "serve_prefetch_converted": self.prefetch_converted,
                "serve_prefetch_suppressed": self.prefetch_suppressed,
                "fleet_remote_hits": self.fleet_remote_hits,
                **self._fleet_totals(),
                # per-scenario served counts: {scenario:
                # {path: n}} — JSON-ready; publish() mirrors the nonzero
                # cells as per-scenario gauges
                "serve_scenarios": {s: dict(c) for s, c in
                                    self.served_by_scenario.items()},
            }
