"""Structured event journal: typed lifecycle events as append-only JSONL
(port of ``aiyagari_hark_tpu/obs/journal.py``; the same vocabulary and
line layout, so a journal reader works on either package's files).

Every seam of the engine -- a bucket launch, a quarantine, an SDC
suspicion, a transient retry, an interrupt, a resume, a failed
certificate, a disk fault -- writes ONE typed, machine-readable line:

    {"ts": ..., "run_id": "run-...", "event": "QUARANTINE",
     "cell": 7, "crra": 5.0, ...}

* **Typed**: ``event`` must be a member of ``EVENT_TYPES`` (the JAX
  package's whole closed set, the serving tier's types included); an
  unknown type raises at the emit site.
* **Append-only, crash-consistent**: lines go through
  ``utils.checkpoint.append_jsonl``, one ``os.write`` of one complete
  line per event, so a kill tears at most the final line, which
  ``read_journal`` skips with a warning.
* **Run-scoped**: every line carries the ``run_id`` shared with the
  trace and the metrics snapshot.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

# The typed lifecycle vocabulary, grouped by the subsystem that owns
# each seam (the JAX package's tuple, in its order).
EVENT_TYPES = (
    # run lifecycle (obs runtime)
    "RUN_START", "RUN_END",
    # sweep scheduler (parallel.sweep)
    "BUCKET_LAUNCH", "QUARANTINE", "SDC_SUSPECTED",
    # resilience layer (utils.resilience)
    "RETRY_TRANSIENT", "INTERRUPTED", "RESUME_RESTORE",
    # precision ladder (DESIGN §5)
    "PRECISION_ESCALATED",
    # integrity / certification (verify, utils.fingerprint)
    "CERT_FAILED", "INTEGRITY_FAILED",
    # serving (serve.service / serve.store)
    "STORE_EVICT_CORRUPT", "DEADLINE_EXCEEDED",
    # serving overload layer (serve.service / serve.overload):
    # fail-fast admission rejection, priority displacement of a queued
    # pending, a degraded nearest-neighbor answer, breaker transitions
    # (OPEN covers reopen-after-failed-probe), the half-open probe
    # admission, and each fast-fail on an already-open breaker
    "OVERLOADED", "LOAD_SHED", "DEGRADED_ANSWER",
    "CIRCUIT_OPEN", "CIRCUIT_PROBE", "CIRCUIT_CLOSE", "CIRCUIT_REJECT",
    # typed solver divergence escaping to a caller (models, facade)
    "SOLVER_DIVERGED",
    # fleet tier (serve.store / serve.service): the claim/
    # lease election (one FLEET_CLAIM per lease won), the exactly-once
    # publish completing a claim (FLEET_PUBLISH carries the solving
    # query's speculative flag — prefetch attribution), a stale lease
    # broken past its TTL (crashed-winner reclaim), and each
    # speculative neighbor query issued by the prefetcher
    "FLEET_CLAIM", "FLEET_PUBLISH", "FLEET_LEASE_RECLAIM",
    "PREFETCH_ISSUED",
    # fleet robustness tier (serve.{store,chaos,fleet,
    # loadgen}): a chaos-drill fault actually FIRING (the detection
    # ledger's injected side), a hedged read issued for a known-
    # published fingerprint / the hedge's answer winning the race, a
    # worker entering or leaving the pool mid-load (the elasticity
    # schedule), and a lease-backend operation degrading typed (substrate
    # fault, injected partition, or a held lease found lost/stolen)
    "FLEET_CHAOS_INJECT", "FLEET_HEDGE_ISSUED", "FLEET_HEDGE_WON",
    "WORKER_JOIN", "WORKER_LEAVE", "LEASE_BACKEND_FAULT",
    # performance-observability tier (obs.profile/obs.regress):
    # the run's cost-ledger summary at close, a bench-regression sentinel
    # finding graded REGRESSED, the flight-recorder crash artifact
    # written after a quarantine-ladder exhaustion, and a per-device
    # memory high-water mark growing
    "PROFILE_SNAPSHOT", "REGRESSION_FLAGGED",
    "FLIGHT_RECORD_DUMP", "DEVICE_MEM_HIGH_WATER",
    # surrogate tier (serve.{service,store,surrogate,
    # cellindex}): an off-lattice query answered by the certified
    # local-linear surrogate (bound + donors attached), a surrogate-
    # eligible query escalated to a real solve (too few / too far
    # donors, bound over budget, or the seeded audit draw), an
    # escalated solve published as a parameter-space refinement point
    # (audit escalations carry the a-posteriori bound check), and the
    # store's cell index (re)built from the metadata tier (restart,
    # scale change, or occupancy-driven rewidth)
    "SURROGATE_SERVED", "SURROGATE_ESCALATED", "LATTICE_REFINED",
    "INDEX_REBUILD",
    # durability / disaster-recovery tier (serve.{wal,
    # replicated,store} + utils.checkpoint): a CAS replica recovering
    # its version map from WAL+snapshot at start (torn tails and
    # applied-record counts attached), a snapshot compaction truncating
    # the WAL, anti-entropy repair pushing a rejoined/stale replica
    # back to the quorum's state, a replicated backend losing its
    # majority (typed CoordinationUnavailable at the caller), the
    # solution store degrading to memory-only after a failed disk
    # publish, and a disk write failing typed (injected ENOSPC/EIO or
    # a real full/failing disk)
    "WAL_REPLAY", "SNAPSHOT_COMPACT", "REPLICA_RESYNC", "QUORUM_LOST",
    "STORE_DEGRADED", "DISK_FAULT",
)


def _jsonable(v):
    from .trace import _jsonable as coerce

    return coerce(v)


class EventJournal:
    """Append-only JSONL journal for one run.

    ``emit`` is thread-safe and durable per event (no buffering: a
    lifecycle event is rare and must survive the preemption it often
    describes).  The file may hold several runs' events (appends never
    truncate) — readers filter by ``run_id``."""

    def __init__(self, path: str, run_id: str, clock=time.time):
        self.path = str(path)
        self.run_id = str(run_id)
        self._clock = clock
        self._lock = threading.Lock()
        self.emitted = 0

    def emit(self, etype: str, **attrs) -> dict:
        """Append one typed event; returns the record written.  Raises
        ``ValueError`` on an event type outside ``EVENT_TYPES`` — the
        journal's vocabulary is closed by design."""
        if etype not in EVENT_TYPES:
            raise ValueError(
                f"unknown journal event type {etype!r}; add it to "
                f"obs.journal.EVENT_TYPES if it is a new lifecycle seam "
                f"(known: {', '.join(EVENT_TYPES)})")
        rec = {"ts": round(float(self._clock()), 6),
               "run_id": self.run_id, "event": etype}
        for k, v in attrs.items():
            rec[str(k)] = _jsonable(v)
        from ..utils.checkpoint import append_jsonl

        with self._lock:
            append_jsonl(self.path, [json.dumps(rec)])
            self.emitted += 1
        return rec


def read_journal(path: str, run_id: Optional[str] = None,
                 event: Optional[str] = None) -> list:
    """Read a journal back as a list of dicts, optionally filtered by
    ``run_id`` and/or ``event`` type.

    A line that does not parse is SKIPPED, not fatal
    (``utils.checkpoint.read_jsonl_tolerant`` — the shared reader half
    of ``append_jsonl``'s crash contract): a journal must stay readable
    after the very preemption it recorded.  Skips are warned with a
    count, never silent.  A missing file reads as an empty journal."""
    import warnings

    from ..utils.checkpoint import read_jsonl_tolerant

    try:
        records, bad = read_jsonl_tolerant(path)
    except OSError:
        return []
    if bad:
        warnings.warn(
            f"event journal {path}: skipped {bad} unparseable line(s) "
            "(torn tail from a hard kill, or external corruption)",
            stacklevel=2)
    return [rec for rec in records
            if (run_id is None or rec.get("run_id") == run_id)
            and (event is None or rec.get("event") == event)]
