"""Bench-regression sentinel: robust baselines over a bench record
history, typed severity-ordered findings (port of
``aiyagari_hark_tpu/obs/regress.py``: the same direction-of-goodness
table, thresholds and findings, so either package's bench history grades
the same way).

* per metric, the baseline is the MEDIAN of the last ``window`` prior
  values and the noise band is ``max(IQR, rel_floor * |baseline|,
  abs_floor)``;
* a value flags only when it is worse than BOTH the baseline plus band
  AND the worst value the history already holds;
* severity: ``OK < NOISE < REGRESSED`` — NOISE is outside the band but
  under ``regress_frac`` relative movement; REGRESSED is a move of at
  least ``regress_frac`` (default 10%) in the bad direction;
* every numeric bench field must resolve in the direction-of-goodness
  table (``direction_of_goodness(field, strict=True)`` raises
  ``UnknownMetricError`` otherwise).

A REGRESSED finding under an active obs scope journals a typed
``REGRESSION_FLAGGED`` event through the port's ``emit_event``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

# Severity order (matching solver_health's small-int convention: higher
# is worse, comparisons are meaningful).
OK = 0
NOISE = 1
REGRESSED = 2
SEVERITY_NAMES = {OK: "OK", NOISE: "NOISE", REGRESSED: "REGRESSED"}

# Directions of goodness.
UP = "up"          # bigger is better (throughput, speedup, MFU)
DOWN = "down"      # smaller is better (walls, skew, error margins)
NEUTRAL = "neutral"  # informational (device counts, sizes, ids)

# -- the direction-of-goodness table (ONE place, DESIGN §10b) ---------------
# Explicit field names first; fields not listed resolve through the
# suffix rules below.  ``last_tpu.<field>`` recurses on ``<field>``.
DIRECTION_EXPLICIT: Dict[str, str] = {
    "value": DOWN,                 # the headline sweep wall (seconds)
    "vs_baseline": UP,             # speedup factor over the reference
    "mfu_pct": UP,                 # bare spelling ("_mfu_pct" suffixed
    #                                fields resolve via the suffix rule)
    "iteration_skew": DOWN,
    "iteration_skew_scheduled": DOWN,
    "scheduled_iteration_skew": DOWN,
    "n_devices": NEUTRAL,
    "n_buckets": NEUTRAL,
    "lanes": NEUTRAL,
    "backend_attempts": NEUTRAL,
    "exact_bits": NEUTRAL,
    # multi-chip scaling leg (bench --chips-scaling): the
    # device-count-suffixed speedups defeat the _speedup suffix rule
    # (they end in _Ndev), so they are declared here — the sentinel
    # grades the chips_* record from its first committed round instead
    # of raising unclassified.  chips_cells_per_sec_{N}dev needs no
    # entry: the 'cells_per_sec' affix rule already resolves it UP.
    "chips_speedup_2dev": UP,
    "chips_speedup_4dev": UP,
    "chips_speedup_8dev": UP,
    "chips_mem_stats_devices": NEUTRAL,
    # state-axis sharding leg (bench --state-scaling): the
    # shard-count-suffixed throughputs defeat the _per_sec suffix rule
    # (they end in _Mshard), so they are declared here, UP.  The
    # per-device RESIDENT RATIO (sharded/replicated model resident at
    # the largest grid, ~1/M) is the tentpole's whole point — DOWN,
    # overriding the neutral _ratio suffix rule; likewise the ledger-
    # sourced sharding overhead share overrides the neutral _frac rule,
    # DOWN.  The drill's grid size and the device-with-memory-stats
    # count are facts, NEUTRAL; drift resolves DOWN via the _bp suffix
    # and residents/budget NEUTRAL via _bytes.
    "state_gridpoints_per_sec_1shard": UP,
    "state_gridpoints_per_sec_2shard": UP,
    "state_gridpoints_per_sec_4shard": UP,
    "state_resident_ratio": DOWN,
    "state_collective_share_frac": DOWN,
    "state_overflow_grid": NEUTRAL,
    "state_mem_stats_devices": NEUTRAL,
    # grid-compaction leg (bench --compaction-smoke): the
    # sentinel grades the grid_* record from its first committed round —
    # gridpoints DOWN is good (the compaction's whole point), reductions
    # and certified counts UP.  grid_total_inner_steps_* and
    # grid_*_wall_s resolve through the _steps/_s suffix rules;
    # grid_r_drift_max_bp through _max_bp.
    "grid_points_reference": NEUTRAL,     # config constant, not a metric
    "grid_points_compact": DOWN,
    "grid_total_inner_steps_reference": NEUTRAL,   # baseline side
    "grid_total_inner_steps_compact": DOWN,
    "grid_effective_gridpoint_steps_reference": NEUTRAL,
    "grid_effective_gridpoint_steps_compact": DOWN,
    "grid_point_reduction": UP,
    "grid_step_reduction": UP,
    "grid_wall_reduction": UP,
    "grid_effective_reduction": UP,
    "grid_cells_certified": UP,
    "grid_escalations": DOWN,
    "grid_knee": NEUTRAL,
    # fused-kernel leg (bench --kernel-smoke): the sentinel
    # grades the kernel_* record from its first committed round.  Walls
    # and drift resolve through the _wall_s/_max_bp suffix rules and
    # throughputs through _per_sec_per_chip; the remaining fields are
    # declared here — reductions and certified counts UP, escalations
    # DOWN, launch counts informational.
    "kernel_cells": NEUTRAL,
    "kernel_wall_reduction": UP,
    "kernel_cells_certified": UP,
    "kernel_escalations": DOWN,
    "kernel_drill_escalations": NEUTRAL,   # the injected drill's count
    #                                        is a contract, not a trend
    "kernel_drill_max_knot_diff": NEUTRAL,  # bounded by the drill's own
    #                                         acceptance, not a trend
    "kernel_fused_executables": NEUTRAL,
    "kernel_fused_launches": NEUTRAL,
    # fleet serving leg (bench --fleet-smoke) + the serve
    # snapshot's prefetch/fleet counters (they ride every serve_* record
    # via ``ServeMetrics.snapshot``).  The load-bearing declarations:
    # the DEDUP RATIO is cold solves / distinct cold fingerprints — 1.0
    # is exactly-once, every increase is duplicated solve work, so DOWN
    # (the explicit entry overrides the neutral ``_ratio`` suffix rule);
    # leaked leases and unresolved arrivals are failures of the
    # protocol, DOWN from the first committed record; prefetch
    # CONVERSIONS are the prefetcher earning its solves, UP.  Fleet
    # p50/p99 fields resolve through the ``_ms`` suffix rule and the
    # wall through ``_s``.
    "fleet_dedup_ratio": DOWN,
    "fleet_leases_leaked": DOWN,
    "fleet_unresolved": DOWN,
    "fleet_prefetch_issued": NEUTRAL,
    "fleet_prefetch_converted": UP,
    "fleet_remote_hits": UP,
    "fleet_claims_won": NEUTRAL,
    "fleet_claims_lost": NEUTRAL,
    "fleet_publishes": NEUTRAL,
    "fleet_lease_reclaims": DOWN,
    "fleet_workers": NEUTRAL,
    "fleet_requests": NEUTRAL,
    "fleet_served": UP,
    "fleet_served_hit": NEUTRAL,     # traffic-mix facts, not goodness
    "fleet_served_near": NEUTRAL,
    "fleet_served_cold": NEUTRAL,
    "fleet_cold_solves": NEUTRAL,
    "fleet_distinct_fingerprints": NEUTRAL,
    "fleet_drill_rc": NEUTRAL,
    "fleet_value_mismatches": DOWN,
    "fleet_value_divergence": DOWN,
    "fleet_seeded_compares": NEUTRAL,
    # chaos smoke (bench --chaos-smoke): graded from their
    # FIRST committed record.  AVAILABILITY is served/submitted under
    # churn + drills — the headline robustness number, UP.  Leaked
    # leases, unresolved arrivals, value divergence, and recovery-phase
    # duplicate publishes are protocol violations, DOWN from record one.
    # The drilled dedup ratio excludes the drills' EXPECTED duplicates
    # (a stalled winner's late publish, a skew-forced double election)
    # — what remains must stay 1.0, so any increase is a real
    # exactly-once regression, DOWN.  Reclaims/kills/joins/leaves are
    # the drill script's own doing, facts not goodness — NEUTRAL;
    # injected/detected counts resolve NEUTRAL via the affix rules and
    # are pinned equal by the acceptance gate instead.  Hedge counts
    # are traffic facts, NEUTRAL (the hedge's latency win shows up in
    # the p99 fields, which resolve DOWN via the _ms suffix).
    "chaos_availability": UP,
    "chaos_dedup_ratio": DOWN,
    "chaos_recovery_dup_publishes": DOWN,
    "chaos_leases_leaked": DOWN,
    "chaos_unresolved": DOWN,
    "chaos_value_divergence": DOWN,
    "chaos_reclaims": NEUTRAL,
    "chaos_workers": NEUTRAL,
    "chaos_arrivals": NEUTRAL,
    "chaos_served": UP,
    "chaos_joins": NEUTRAL,
    "chaos_leaves": NEUTRAL,
    "chaos_kills": NEUTRAL,
    "chaos_hedges_issued": NEUTRAL,
    "chaos_hedges_won": NEUTRAL,
    "chaos_value_mismatches": DOWN,
    "chaos_seeded_compares": NEUTRAL,
    "chaos_recovery_served": NEUTRAL,
    "chaos_backend_faults": NEUTRAL,  # injected partitions land here
    # disaster-recovery smoke (bench --dr-smoke): the
    # replicated-CAS fleet's full-fleet-SIGKILL drill.  The dedup ratio
    # (expected drill duplicates excluded) must stay 1.0 — any rise is
    # an exactly-once regression, DOWN.  Leaked leases, unresolved
    # arrivals, value mismatches/divergence, and per-replica recovered-
    # state mismatches are protocol violations, DOWN from record one.
    # WAL replays / compactions / reclaims / recovered-key counts are
    # facts of the script, NEUTRAL; injected/detected counts resolve
    # NEUTRAL via the affix rules and are pinned equal by the
    # acceptance gate; the recovery wall resolves DOWN via ``_wall_s``.
    "dr_replicas": NEUTRAL,
    "dr_workers": NEUTRAL,
    "dr_arrivals": NEUTRAL,
    "dr_served": UP,
    "dr_dedup_ratio": DOWN,
    "dr_unresolved": DOWN,
    "dr_leases_leaked": DOWN,
    "dr_value_mismatches": DOWN,
    "dr_value_divergence": DOWN,
    "dr_seeded_compares": NEUTRAL,
    "dr_state_mismatches": DOWN,
    "dr_recovered_keys": NEUTRAL,
    "dr_wal_replays": NEUTRAL,
    "dr_snapshot_compacts": NEUTRAL,
    "dr_reclaims": NEUTRAL,
    "serve_prefetch_issued": NEUTRAL,
    "serve_prefetch_converted": UP,
    "serve_prefetch_suppressed": NEUTRAL,
    # surrogate tier + cell index (bench --surrogate-smoke;
    # the surrogate_* snapshot counters also ride every serve record via
    # ``ServeMetrics.snapshot``).  HIT RATE is the tier earning its keep
    # (answers served without a solve), UP; the ESCALATION RATE is the
    # fraction of surrogate-eligible queries that fell back to a cold
    # solve, DOWN — together with the bound percentiles (the tier's own
    # claimed error, DOWN: a tighter model is a better model) they are
    # the headline numbers.  Audit failures are answers outside their
    # own certified bound, DOWN from record one.  Audits and lattice
    # refinements are policy-driven facts, NEUTRAL.  INDEX speedups are
    # the sublinear store index's whole point, UP (the scale-suffixed
    # names defeat the ``_speedup`` suffix rule, same as chips_*);
    # linear-scan timings are the baseline side, NEUTRAL.
    "surrogate_hit_rate": UP,
    "surrogate_escalation_rate": DOWN,
    "surrogate_escalations": DOWN,
    "surrogate_audits": NEUTRAL,
    "surrogate_audit_failures": DOWN,
    "surrogate_refinements": NEUTRAL,
    "surrogate_bound_p50": DOWN,
    "surrogate_bound_p95": DOWN,
    "surrogate_bound_max": DOWN,
    "surrogate_err_max": DOWN,
    "surrogate_queries": NEUTRAL,
    "surrogate_served": UP,
    "surrogate_refined_published": NEUTRAL,
    "surrogate_events_served": NEUTRAL,
    "surrogate_events_escalated": NEUTRAL,
    "index_entries": NEUTRAL,
    "index_rebuilds": NEUTRAL,
    "index_speedup_1e4": UP,
    "index_speedup_5e4": UP,
    "index_grid_ms_1e4": DOWN,
    "index_grid_ms_5e4": DOWN,
    "index_linear_ms_1e4": NEUTRAL,
    "index_linear_ms_5e4": NEUTRAL,
}

# Suffix/affix rules, first match wins.  Kept coarse on purpose: bench
# fields are named by convention (units in the suffix), and the rules
# make the convention load-bearing.
DIRECTION_SUFFIX_RULES: Tuple[Tuple[str, str], ...] = (
    ("_wall_s", DOWN), ("_walls_s", DOWN), ("_seconds", DOWN),
    ("_wait_s", DOWN), ("_roundtrip_s", DOWN), ("_s", DOWN),
    ("_ms", DOWN), ("_us", DOWN),
    ("_per_sec_per_chip", UP), ("_per_sec", UP), ("_per_chip", UP),
    ("_mfu_pct", UP), ("_speedup", UP), ("_hit_rate", UP),
    ("_max_bp", DOWN), ("_bp", DOWN), ("_skew", DOWN),
    ("_overhead_frac", DOWN), ("_frac", NEUTRAL),
    ("_pct", NEUTRAL), ("_ratio", NEUTRAL),
    ("_count", NEUTRAL), ("_cells", NEUTRAL), ("_events", NEUTRAL),
    ("_bytes", NEUTRAL), ("_evals", DOWN), ("_steps", DOWN),
    ("_iters", DOWN), ("_compiles", DOWN), ("_misses", DOWN),
    ("_retries", DOWN), ("_errors", DOWN), ("_violations", DOWN),
    ("_failures", DOWN), ("_expirations", DOWN), ("_evictions", DOWN),
)
# Prefix rules (checked after suffixes): counts and ids are neutral.
DIRECTION_PREFIX_RULES: Tuple[Tuple[str, str], ...] = (
    ("n_", NEUTRAL), ("num_", NEUTRAL),
)
# Affix (anywhere) rules, last resort before UnknownMetricError.
DIRECTION_AFFIX_RULES: Tuple[Tuple[str, str], ...] = (
    ("mfu", UP), ("flops_per_sec", UP), ("cells_per_sec", UP),
    ("p50", DOWN), ("p95", DOWN), ("p99", DOWN),
    ("wall", DOWN), ("compile", DOWN), ("overhead", DOWN),
    ("drift", DOWN), ("residual", DOWN), ("corrupt", DOWN),
    ("injected", NEUTRAL), ("detected", NEUTRAL),
)


class UnknownMetricError(KeyError):
    """A numeric bench field with no declared direction of goodness —
    the table above must grow an entry (or the field a conventional
    suffix) before the sentinel can grade it."""


def direction_of_goodness(field: str, strict: bool = True) -> str:
    """Resolve one bench field to ``"up"``/``"down"``/``"neutral"``.

    ``strict=True`` raises ``UnknownMetricError`` on an unclassifiable
    field (the completeness contract tests pin); ``strict=False``
    degrades to NEUTRAL — the sentinel's runtime choice, so a brand-new
    field shows up as ungraded rather than crashing CI (the strict test
    is what forces the table entry)."""
    name = field.rsplit(".", 1)[-1]   # "last_tpu.compile_s" -> "compile_s"
    if name in DIRECTION_EXPLICIT:
        return DIRECTION_EXPLICIT[name]
    for suffix, direction in DIRECTION_SUFFIX_RULES:
        if name.endswith(suffix):
            return direction
    for prefix, direction in DIRECTION_PREFIX_RULES:
        if name.startswith(prefix):
            return direction
    for affix, direction in DIRECTION_AFFIX_RULES:
        if affix in name:
            return direction
    if strict:
        raise UnknownMetricError(
            f"bench field {field!r} has no direction of goodness; add it "
            "to obs.regress.DIRECTION_EXPLICIT (or use a conventional "
            "suffix: _wall_s/_per_sec/_mfu_pct/...)")
    return NEUTRAL


def flatten_record(record: dict, prefix: str = "") -> Dict[str, float]:
    """Numeric scalar fields of one bench record, nested dicts flattened
    with dotted keys (``last_tpu.compile_s``); bools, strings, lists
    (e.g. ``lanes_scaling``) are skipped — the sentinel grades scalars."""
    out: Dict[str, float] = {}
    for k, v in record.items():
        key = prefix + str(k)
        if isinstance(v, bool):
            continue
        if isinstance(v, dict):
            out.update(flatten_record(v, key + "."))
        elif isinstance(v, (int, float)):
            out[key] = float(v)
    return out


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _iqr(vals: Sequence[float]) -> float:
    """Interquartile range by linear interpolation (numpy's default
    percentile method, stdlib-only so the sentinel can run anywhere)."""
    s = sorted(vals)
    n = len(s)
    if n < 2:
        return 0.0

    def q(p: float) -> float:
        idx = p * (n - 1)
        lo = int(idx)
        hi = min(lo + 1, n - 1)
        return s[lo] + (s[hi] - s[lo]) * (idx - lo)

    return q(0.75) - q(0.25)


@dataclasses.dataclass(frozen=True)
class MetricFinding:
    """One metric's grade against its robust baseline."""

    metric: str
    severity: int                 # OK < NOISE < REGRESSED
    direction: str                # up | down | neutral
    value: Optional[float]
    baseline: Optional[float]     # median of the prior window
    band: Optional[float]         # noise half-width around the baseline
    worst_prior: Optional[float]  # worst value history already contains
    delta_frac: Optional[float]   # signed relative move, + = worse
    n_prior: int = 0
    note: str = ""

    @property
    def severity_name(self) -> str:
        return SEVERITY_NAMES[self.severity]


@dataclasses.dataclass
class RegressionReport:
    """Severity-ordered findings for the latest bench record against its
    history.  ``worst`` is the report's headline grade; ``regressed()``
    / ``noisy()`` slice by severity; ``summary()`` renders the one-line
    digest the CI log shows."""

    findings: List[MetricFinding]
    n_records: int
    latest_round: str
    baseline_rounds: List[str]
    unknown_fields: List[str]

    @property
    def worst(self) -> int:
        return max((f.severity for f in self.findings), default=OK)

    def regressed(self) -> List[MetricFinding]:
        return [f for f in self.findings if f.severity == REGRESSED]

    def noisy(self) -> List[MetricFinding]:
        return [f for f in self.findings if f.severity == NOISE]

    def summary(self) -> str:
        n_reg, n_noise = len(self.regressed()), len(self.noisy())
        return (f"bench-regress [{self.latest_round} vs "
                f"{len(self.baseline_rounds)} prior]: "
                f"{SEVERITY_NAMES[self.worst]} "
                f"({n_reg} regressed, {n_noise} noise, "
                f"{len(self.findings) - n_reg - n_noise} ok"
                + (f", {len(self.unknown_fields)} ungraded"
                   if self.unknown_fields else "") + ")")


def grade_metric(metric: str, value: float, priors: Sequence[float],
                 direction: Optional[str] = None,
                 window: int = 5, rel_floor: float = 0.05,
                 abs_floor: float = 1e-12,
                 regress_frac: float = 0.10) -> MetricFinding:
    """Grade one metric value against its prior history (the unit the
    report loops; exposed for tests to pin the severity rules)."""
    if direction is None:
        direction = direction_of_goodness(metric, strict=False)
    priors = [float(p) for p in priors][-int(window):]
    n_prior = len(priors)
    if direction == NEUTRAL or n_prior < 2:
        note = ("neutral" if direction == NEUTRAL
                else f"insufficient history ({n_prior} prior)")
        return MetricFinding(metric, OK, direction, value,
                             _median(priors) if priors else None,
                             None, None, None, n_prior, note)
    baseline = _median(priors)
    band = max(_iqr(priors), rel_floor * abs(baseline), abs_floor)
    worst_prior = max(priors) if direction == DOWN else min(priors)
    # signed badness: positive = moved in the bad direction
    bad_delta = (value - baseline) if direction == DOWN \
        else (baseline - value)
    delta_frac = (bad_delta / abs(baseline)) if baseline else None
    beyond_band = bad_delta > band
    beyond_worst = (value > worst_prior if direction == DOWN
                    else value < worst_prior)
    if not (beyond_band and beyond_worst):
        return MetricFinding(metric, OK, direction, value, baseline,
                             band, worst_prior, delta_frac, n_prior)
    severity = (REGRESSED if delta_frac is not None
                and delta_frac >= regress_frac else NOISE)
    return MetricFinding(metric, severity, direction, value, baseline,
                         band, worst_prior, delta_frac, n_prior)


def evaluate_history(history: Sequence[Tuple[str, dict]],
                     window: int = 5, rel_floor: float = 0.05,
                     regress_frac: float = 0.10) -> RegressionReport:
    """The sentinel: grade the LAST record of ``history`` (a sequence of
    ``(round_name, record_dict)``, oldest first) against the robust
    baseline of the earlier ones, emitting ``REGRESSION_FLAGGED`` into
    the active obs scope for every REGRESSED finding."""
    from .runtime import emit_event

    if not history:
        return RegressionReport([], 0, "<none>", [], [])
    flat = [(name, flatten_record(rec)) for name, rec in history]
    latest_name, latest = flat[-1]
    prior_rounds = [name for name, _ in flat[:-1]]
    findings: List[MetricFinding] = []
    unknown: List[str] = []
    for metric in sorted(latest):
        try:
            direction = direction_of_goodness(metric, strict=True)
        except UnknownMetricError:
            unknown.append(metric)
            direction = NEUTRAL
        priors = [f[metric] for _, f in flat[:-1] if metric in f]
        finding = grade_metric(metric, latest[metric], priors,
                               direction=direction, window=window,
                               rel_floor=rel_floor,
                               regress_frac=regress_frac)
        findings.append(finding)
        if finding.severity == REGRESSED:
            emit_event("REGRESSION_FLAGGED", metric=metric,
                       value=finding.value, baseline=finding.baseline,
                       band=finding.band,
                       delta_frac=finding.delta_frac,
                       direction=finding.direction,
                       latest_round=latest_name)
    findings.sort(key=lambda f: (-f.severity,
                                 -(f.delta_frac or 0.0), f.metric))
    return RegressionReport(findings, len(flat), latest_name,
                            prior_rounds, unknown)


def load_bench_history(repo_dir: str) -> List[Tuple[str, dict]]:
    """The committed ``BENCH_r*.json`` history, oldest first, as
    ``(round, record)`` pairs.  Each file wraps the bench's JSON record
    under ``"parsed"`` (None when that round's bench failed — skipped,
    the sentinel grades measurements, not absences)."""
    import glob
    import json
    import os
    import re

    out: List[Tuple[str, dict]] = []
    paths = glob.glob(os.path.join(repo_dir, "BENCH_r*.json"))

    def round_key(p: str) -> int:
        m = re.search(r"BENCH_r(\d+)\.json$", p)
        return int(m.group(1)) if m else 0

    for path in sorted(paths, key=round_key):
        with open(path) as fh:
            wrapper = json.load(fh)
        rec = wrapper.get("parsed")
        if isinstance(rec, dict):
            out.append((os.path.basename(path)[len("BENCH_"):-len(".json")],
                        rec))
    return out
