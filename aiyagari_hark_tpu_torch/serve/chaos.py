"""Deterministic fleet fault injection (DESIGN §14; port of
the JAX package's ``serve/chaos.py``, host code, copied).

The single-process engine already injects every failure it types
(``solver_health.inject_fault`` for NaN/stall, the loadgen's overload
regimes, corrupt-entry tests for the checksum chain).  The fleet tier's
failure domain — processes dying mid-election, heartbeats stalling,
partitions, skewed clocks — had no injector: the SIGTERM drill was the
only scripted fault.  This module closes that gap in two halves:

* **worker side** — ``ChaosAgent``, an armable fault surface the shared
  ``SolutionStore`` consults at exactly four seams: publish delay (hold
  a lease mid-"solve" so a kill/stall drill has a deterministic window),
  heartbeat stall (owner alive but not refreshing — the zombie-winner
  regime), transient disk-read partition (reads fail N times, the entry
  is NOT evicted — transient is not corrupt), and wall-clock skew
  applied to staleness judgments (the duplicated-election regime).
  Faults are armed over HTTP (``POST /chaos``, gated by the worker's
  ``--chaos`` flag) and every actual firing is journaled
  ``FLEET_CHAOS_INJECT`` — the harness counts *fired* injections, not
  armed intentions, so detected==injected is a real ledger.

* **harness side** — ``ChaosPlan`` + ``run_drills``: scripted drills
  against a LIVE worker pool (real processes, real HTTP, real store),
  each drill asserting the invariant the fleet claims: the query is
  still answered, the answer is bit-identical across every server that
  ever serves that fingerprint, leases do not leak, and the fault left
  a journal trail.  Expected duplicate publishes (a stalled winner's
  late publish, a skew-forced double election) are *accounted*, not
  hidden: the drill ledger separates them from protocol violations so
  the dedup invariant stays falsifiable.

Drill taxonomy (DESIGN §14): ``torn_publish`` (reader-side corrupt
entry: evict + re-solve), ``partition`` (transient read faults degrade
to a miss, never an eviction), ``worker_kill`` (SIGKILL mid-solve; TTL
reclaim re-elects), ``heartbeat_stall`` (live-but-silent winner loses
its claim; its late publish is bit-identical and its late release is
owner-checked away), ``clock_skew`` (a reclaimer running ``ttl×4``
ahead steals a fresh lease; both solves publish the same bits).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import NamedTuple, Optional, Tuple

from ..obs.runtime import NULL_OBS

# one spelling for "the same lattice cell" across HTTP/JSON hops
def _cell_token(cell) -> tuple:
    return tuple(round(float(c), 9) for c in cell)


class ChaosAgent:
    """Worker-side armable fault surface.  Thread-safe; consulted by the
    shared store at its chaos seams (``SolutionStore.set_chaos``).  Every
    fault that actually FIRES is journaled ``FLEET_CHAOS_INJECT`` by
    ``fire`` — arming alone journals nothing."""

    def __init__(self, obs=None, owner: str = ""):
        # reentrant: ``arm`` reports the armed state back via ``armed``
        # while still holding the lock
        self._lock = threading.RLock()
        self._obs = obs if obs is not None else NULL_OBS
        self.owner = str(owner)
        self._slow_publish_s = 0.0
        self._slow_cells: set = set()
        self._heartbeat_stall = False
        self._stall_fired = False
        self._partition_reads = 0
        self._lease_skew_s = 0.0
        self._skew_fired = False
        self._fired = 0

    def fire(self, drill: str, **fields) -> None:
        """Journal one actual fault firing (the detection ledger's
        injected side).  Seam-covered by ``check_obs_events``."""
        with self._lock:
            self._fired += 1
        self._obs.event("FLEET_CHAOS_INJECT", drill=str(drill),
                        owner=self.owner, **fields)

    def arm(self, cfg: dict) -> dict:
        """Adopt a fault configuration (the ``POST /chaos`` body); keys
        absent from ``cfg`` are left armed as-is, explicit zeros/False
        disarm.  Returns the armed state."""
        with self._lock:
            if "slow_publish_s" in cfg:
                self._slow_publish_s = float(cfg["slow_publish_s"])
            if "slow_cells" in cfg:
                self._slow_cells = {_cell_token(c)
                                    for c in cfg["slow_cells"]}
            if "heartbeat_stall" in cfg:
                self._heartbeat_stall = bool(cfg["heartbeat_stall"])
                self._stall_fired = False
            if "partition_reads" in cfg:
                self._partition_reads = int(cfg["partition_reads"])
            if "lease_skew_s" in cfg:
                self._lease_skew_s = float(cfg["lease_skew_s"])
                self._skew_fired = False
            if "disk_fault" in cfg:
                # arm the checkpoint writers' deterministic
                # ENOSPC/EIO seam inside THIS worker process (the
                # disk-full-publish drill); falsy disarms.
                from ..utils.checkpoint import (arm_disk_fault,
                                                disarm_disk_faults)

                df = cfg["disk_fault"]
                if df:
                    arm_disk_fault(df["op"],
                                   kind=df.get("kind", "ENOSPC"),
                                   count=int(df.get("count", 1)),
                                   match=df.get("match", ""))
                else:
                    disarm_disk_faults()
            return self.armed()

    def armed(self) -> dict:
        with self._lock:
            return {"slow_publish_s": self._slow_publish_s,
                    "slow_cells": [list(c) for c in
                                   sorted(self._slow_cells)],
                    "heartbeat_stall": self._heartbeat_stall,
                    "partition_reads": self._partition_reads,
                    "lease_skew_s": self._lease_skew_s,
                    "fired": self._fired}

    # -- the store's seams --------------------------------------------------

    def publish_delay_s(self, cell) -> float:
        """Seconds to hold the lease before a publish of ``cell`` (the
        kill/stall drills' deterministic mid-solve window); 0 when the
        cell is not armed."""
        with self._lock:
            if (self._slow_publish_s <= 0.0
                    or _cell_token(cell) not in self._slow_cells):
                return 0.0
            d = self._slow_publish_s
        self.fire("slow_publish", cell=list(_cell_token(cell)),
                  delay_s=d)
        return d

    def heartbeat_stalled(self) -> bool:
        """True while the heartbeat-stall fault is armed: the store's
        refresh loop skips its beats (owner alive, lease aging)."""
        with self._lock:
            stalled = self._heartbeat_stall
            first = stalled and not self._stall_fired
            if first:
                self._stall_fired = True
        if first:
            self.fire("heartbeat_stall")
        return stalled

    def read_fault(self, key: int) -> bool:
        """Consume one transient disk-read fault (the partition window);
        True = this read must fail WITHOUT evicting anything."""
        with self._lock:
            if self._partition_reads <= 0:
                return False
            self._partition_reads -= 1
        self.fire("partition", key=int(key))
        return True

    def skew_now(self) -> Optional[float]:
        """A skewed wall-clock ``now`` for staleness judgments, or None
        when no skew is armed.  The skewed clock IS the injected fault —
        a reclaimer running ahead by more than ttl + tolerance steals a
        live lease (the duplicated-election drill)."""
        with self._lock:
            skew = self._lease_skew_s
            first = skew != 0.0 and not self._skew_fired
            if first:
                self._skew_fired = True
        if skew == 0.0:
            return None
        if first:
            self.fire("clock_skew", skew_s=skew)
        return time.time() + skew  # timing-ok: the skewed wall IS the injected fault


# -- harness side -----------------------------------------------------------

DRILLS = ("torn_publish", "partition", "worker_kill",
          "heartbeat_stall", "clock_skew")


class ChaosPlan(NamedTuple):
    """One scripted chaos campaign over a live fleet.

    ``drills`` run SEQUENTIALLY after the main traffic replay, each on
    its own dedicated cell from ``drill_cells`` (disjoint from the
    traffic lattice, so drill duplicates never contaminate the clean
    dedup ledger); ``churn`` is the elasticity schedule applied DURING
    the replay: ``(after_total_dispatches, "leave"|"join",
    worker_index_or_None)`` — leave SIGTERMs, join spawns a fresh worker
    into the pool.  ``slow_publish_s`` must comfortably exceed the
    harness's observe-then-act window (poll /fleet, send the signal);
    ``settle_timeout_s`` bounds every wait-for-recovery loop."""

    drills: Tuple[str, ...] = DRILLS
    drill_cells: Tuple[Tuple[float, float, float], ...] = ()
    churn: Tuple[Tuple[int, str, Optional[int]], ...] = ()
    slow_publish_s: float = 8.0
    partition_reads: int = 2
    recovery_queries: int = 6
    settle_timeout_s: float = 60.0


class DrillError(RuntimeError):
    """A drill could not even run (no live victim, arming failed) —
    distinct from a drill that ran and was not detected."""


def _poll_until(pred, timeout_s: float, interval_s: float = 0.02) -> bool:
    from ..utils.timing import Stopwatch

    watch = Stopwatch()
    while watch.elapsed() < timeout_s:
        if pred():
            return True
        time.sleep(interval_s)
    return pred()


def run_drills(plan: ChaosPlan, ctl) -> dict:
    """Execute every drill in ``plan`` against the live fleet behind
    ``ctl`` (the loadgen's ``FleetCtl``) and return the chaos ledger:

    ``{"drills": [per-drill records], "injected": n, "detected": n,
    "expected_dup_keys": [...], "drill_keys": [...]}``

    Each drill record carries ``injected``/``detected`` (0/1), the
    drill key, and which evidence fired.  Detection is read from the
    workers' journals and process states — the same artifacts a
    postmortem would use — never from harness-private flags."""
    if len(plan.drill_cells) < len(plan.drills):
        raise ValueError(
            f"ChaosPlan needs one drill cell per drill "
            f"({len(plan.drills)} drills, {len(plan.drill_cells)} cells)")
    records = []
    expected_dup: list = []
    drill_keys: list = []
    runners = {"torn_publish": _drill_torn_publish,
               "partition": _drill_partition,
               "worker_kill": _drill_worker_kill,
               "heartbeat_stall": _drill_heartbeat_stall,
               "clock_skew": _drill_clock_skew}
    for i, name in enumerate(plan.drills):
        if name not in runners:
            raise ValueError(f"unknown drill {name!r} "
                             f"(known: {', '.join(DRILLS)})")
        rec = runners[name](plan, ctl, plan.drill_cells[i])
        rec["drill"] = name
        records.append(rec)
        if rec.get("key") is not None:
            drill_keys.append(int(rec["key"]))
        if rec.get("expected_dup"):
            expected_dup.append(int(rec["key"]))
    return {"drills": records,
            "injected": sum(r["injected"] for r in records),
            "detected": sum(r["detected"] for r in records),
            "expected_dup_keys": expected_dup,
            "drill_keys": drill_keys}


def _journal_events(ctl, event: str, key: Optional[int] = None) -> list:
    from ..obs.journal import read_journal

    out = []
    for jp in list(ctl.journal_paths):
        if not os.path.exists(jp):
            continue
        for ev in read_journal(jp, event=event):
            if key is None or ev.get("key") == int(key):
                out.append(ev)
    return out


def _value_fields(res: dict) -> tuple:
    return (res["r_star"], res["capital"], res["labor"], res["status"])


def _arm(ctl, worker: int, cfg: dict) -> None:
    resp = ctl.post(worker, "/chaos", cfg)
    if not resp.get("ok"):
        raise DrillError(f"arming worker {worker} failed: {resp}")


def _disarm(ctl, worker: int) -> None:
    if ctl.alive(worker):
        ctl.post(worker, "/chaos", {
            "slow_publish_s": 0.0, "slow_cells": [],
            "heartbeat_stall": False, "partition_reads": 0,
            "lease_skew_s": 0.0, "disk_fault": None})


def _drill_torn_publish(plan: ChaosPlan, ctl, cell) -> dict:
    """Reader-side torn entry: publish, corrupt the bytes on disk, and
    make a DIFFERENT worker serve the key — it must evict the garbage
    (``STORE_EVICT_CORRUPT``), re-solve, and re-publish the exact same
    bits."""
    first, second = ctl.two_live_workers()
    res0 = ctl.query(cell, prefer=first)
    key = int(res0["key"])
    path = os.path.join(ctl.store_dir,
                        f"sol_{_hex(key)}.npz")
    with open(path, "wb") as f:   # atomic-ok: the drill WRITES a torn entry
        f.write(b"torn-publish-drill: not an npz")
    res1 = ctl.query(cell, prefer=second)
    evicted = bool(_journal_events(ctl, "STORE_EVICT_CORRUPT", key=key))
    bits_equal = _value_fields(res0) == _value_fields(res1)
    republished = len(_journal_events(ctl, "FLEET_PUBLISH", key=key)) >= 2
    return {"injected": 1,
            "detected": int(evicted and bits_equal and republished),
            "key": key, "evicted": evicted, "bits_equal": bits_equal,
            "republished": republished, "expected_dup": True}


def _drill_partition(plan: ChaosPlan, ctl, cell) -> dict:
    """Transient store partition: the victim's next N disk reads fail.
    A read fault degrades to a MISS (journaled ``LEASE_BACKEND_FAULT``)
    — never an eviction: transient is not corrupt, and the entry must
    survive the window untouched."""
    first, victim = ctl.two_live_workers()
    res0 = ctl.query(cell, prefer=first)      # published, not in victim's RAM
    key = int(res0["key"])
    _arm(ctl, victim, {"partition_reads": int(plan.partition_reads)})
    try:
        res1 = ctl.query(cell, prefer=victim)
    finally:
        _disarm(ctl, victim)
    faults = [ev for ev in _journal_events(ctl, "LEASE_BACKEND_FAULT",
                                           key=key)
              if ev.get("op") == "disk_read"]
    survived = os.path.exists(os.path.join(ctl.store_dir,
                                           f"sol_{_hex(key)}.npz"))
    bits_equal = _value_fields(res0) == _value_fields(res1)
    return {"injected": 1,
            "detected": int(bool(faults) and survived and bits_equal),
            "key": key, "read_faults": len(faults),
            "entry_survived": survived, "bits_equal": bits_equal,
            "expected_dup": False}


def _drill_worker_kill(plan: ChaosPlan, ctl, cell) -> dict:
    """SIGKILL mid-solve: the victim wins the election, holds the lease
    inside an armed publish delay, and dies ungracefully.  The client's
    connection-level failover re-submits to a survivor, whose waiter
    path TTL-reclaims the orphaned lease and re-solves — the query is
    still answered, exactly once fleet-wide AFTER the reclaim."""
    victim, _ = ctl.two_live_workers()
    _arm(ctl, victim, {"slow_publish_s": float(plan.slow_publish_s),
                       "slow_cells": [list(cell)]})
    result: dict = {}

    def _ask():
        result["res"] = ctl.query(cell, prefer=victim)

    t = threading.Thread(target=_ask, name="chaos-kill-client")
    t.start()
    # observe the held lease through /fleet (the public surface), then kill
    held = _poll_until(lambda: ctl.fleet_info(victim) is not None
                       and len(ctl.fleet_info(victim)["held_leases"]) > 0,
                       plan.slow_publish_s * 0.75)
    ctl.kill(victim, signal.SIGKILL)
    t.join(plan.settle_timeout_s)
    res = result.get("res")
    key = None if res is None else int(res["key"])
    rc = ctl.returncode(victim)
    reclaimed = (key is not None
                 and bool(_journal_events(ctl, "FLEET_LEASE_RECLAIM",
                                          key=key)))
    return {"injected": 1,
            "detected": int(held and rc == -int(signal.SIGKILL)
                            and reclaimed and res is not None),
            "key": key, "lease_observed_held": held, "victim_rc": rc,
            "reclaimed": reclaimed, "answered": res is not None,
            "expected_dup": False}


def _drill_heartbeat_stall(plan: ChaosPlan, ctl, cell) -> dict:
    """Zombie winner: alive, holding the lease, not beating.  A peer
    TTL-reclaims and re-solves; the stalled winner's LATE publish lands
    the same bits (deterministic solve) and its late release is
    owner-checked into a no-op — the peer's claim is never deleted out
    from under it."""
    victim, peer = ctl.two_live_workers()
    _arm(ctl, victim, {"heartbeat_stall": True,
                       "slow_publish_s": float(plan.slow_publish_s),
                       "slow_cells": [list(cell)]})
    result: dict = {}

    def _ask():
        result["res"] = ctl.query(cell, prefer=victim)

    t = threading.Thread(target=_ask, name="chaos-stall-client")
    t.start()
    try:
        _poll_until(lambda: ctl.fleet_info(victim) is not None
                    and len(ctl.fleet_info(victim)["held_leases"]) > 0,
                    plan.slow_publish_s * 0.75)
        # the peer's claim loses to the stalled-but-unbeating lease and
        # its waiter path TTL-reclaims once the missing beats age it out
        res_peer = ctl.query(cell, prefer=peer)
        key = int(res_peer["key"])
        t.join(plan.settle_timeout_s)
    finally:
        _disarm(ctl, victim)
    res_victim = result.get("res")
    reclaimed = bool(_journal_events(ctl, "FLEET_LEASE_RECLAIM",
                                     key=key))
    victim_alive = ctl.alive(victim)
    bits_equal = (res_victim is not None
                  and _value_fields(res_victim)
                  == _value_fields(res_peer))
    return {"injected": 1,
            "detected": int(reclaimed and victim_alive and bits_equal),
            "key": key, "reclaimed": reclaimed,
            "victim_alive": victim_alive, "bits_equal": bits_equal,
            "expected_dup": True}


def _drill_clock_skew(plan: ChaosPlan, ctl, cell) -> dict:
    """Duplicated election under skew: the victim holds a FRESH lease;
    a peer whose staleness clock runs ``ttl×4`` ahead judges it stale,
    reclaims, and solves in parallel.  The election invariant is
    violated by construction — the drill verifies the violation is
    SAFE: both publishes carry identical bits and no lease leaks."""
    victim, skewed = ctl.two_live_workers()
    _arm(ctl, victim, {"slow_publish_s": float(plan.slow_publish_s),
                       "slow_cells": [list(cell)]})
    _arm(ctl, skewed, {"lease_skew_s": 4.0 * ctl.lease_ttl_s})
    result: dict = {}

    def _ask():
        result["res"] = ctl.query(cell, prefer=victim)

    t = threading.Thread(target=_ask, name="chaos-skew-client")
    t.start()
    try:
        _poll_until(lambda: ctl.fleet_info(victim) is not None
                    and len(ctl.fleet_info(victim)["held_leases"]) > 0,
                    plan.slow_publish_s * 0.75)
        res_skewed = ctl.query(cell, prefer=skewed)
        key = int(res_skewed["key"])
        t.join(plan.settle_timeout_s)
    finally:
        _disarm(ctl, victim)
        _disarm(ctl, skewed)
    res_victim = result.get("res")
    reclaims = _journal_events(ctl, "FLEET_LEASE_RECLAIM", key=key)
    injects = [ev for ev in _journal_events(ctl, "FLEET_CHAOS_INJECT")
               if ev.get("drill") == "clock_skew"]
    bits_equal = (res_victim is not None
                  and _value_fields(res_victim)
                  == _value_fields(res_skewed))
    return {"injected": 1,
            "detected": int(bool(reclaims) and bool(injects)
                            and bits_equal),
            "key": key, "reclaimed": bool(reclaims),
            "skew_fired": bool(injects), "bits_equal": bits_equal,
            "expected_dup": True}


# -- disaster-recovery drills (DESIGN §16) ------------------------------------
#
# The drills above attack the WORKERS; these attack the
# COORDINATION SUBSTRATE itself — the replicated CAS quorum the fleet's
# exactly-once election now rides on.  Same contract: injection through
# a public surface (signals, the replica wire protocol, the /chaos
# endpoint), detection ONLY from public artifacts (journals, /fleet,
# process return codes, served bits).

DR_DRILLS = ("replica_kill", "torn_wal_tail", "snapshot_mid_write",
             "minority_partition", "disk_full_publish")


class DRPlan(NamedTuple):
    """One disaster-recovery campaign over a live fleet + its replica
    set.  ``drill_cells`` must be disjoint from the traffic lattice
    (drill re-publishes carry their own accounting); each drill that
    needs a SECOND fresh fingerprint derives it by perturbing its cell's
    labor-sd, staying off-lattice.  ``mutation_budget`` bounds the
    synthetic lease traffic the snapshot drill drives to force a
    compaction."""

    drills: Tuple[str, ...] = DR_DRILLS
    drill_cells: Tuple[Tuple[float, float, float], ...] = ()
    settle_timeout_s: float = 60.0
    mutation_budget: int = 160


def run_dr_drills(plan: DRPlan, ctl, replicas) -> dict:
    """Execute every DR drill against the live fleet behind ``ctl``
    (loadgen ``FleetCtl``) coordinated by ``replicas`` (a
    ``serve.replicated.ReplicaSet``); returns the same ledger shape as
    ``run_drills``."""
    if len(plan.drill_cells) < len(plan.drills):
        raise ValueError(
            f"DRPlan needs one drill cell per drill "
            f"({len(plan.drills)} drills, {len(plan.drill_cells)} cells)")
    runners = {"replica_kill": _dr_replica_kill,
               "torn_wal_tail": _dr_torn_wal_tail,
               "snapshot_mid_write": _dr_snapshot_mid_write,
               "minority_partition": _dr_minority_partition,
               "disk_full_publish": _dr_disk_full_publish}
    records = []
    expected_dup: list = []
    drill_keys: list = []
    for i, name in enumerate(plan.drills):
        if name not in runners:
            raise ValueError(f"unknown DR drill {name!r} "
                             f"(known: {', '.join(DR_DRILLS)})")
        rec = runners[name](plan, ctl, replicas, plan.drill_cells[i])
        rec["drill"] = name
        records.append(rec)
        for k in rec.get("keys", ()):
            drill_keys.append(int(k))
            if rec.get("expected_dup"):
                expected_dup.append(int(k))
    return {"drills": records,
            "injected": sum(r["injected"] for r in records),
            "detected": sum(r["detected"] for r in records),
            "expected_dup_keys": expected_dup,
            "drill_keys": drill_keys}


def _replica_events(replicas, event: str, i: Optional[int] = None) -> list:
    """Journal events from the replica processes' own journals (the
    coordination substrate's public artifact trail)."""
    from ..obs.journal import read_journal

    paths = (replicas.journals if i is None else [replicas.journals[i]])
    out = []
    for jp in paths:
        if os.path.exists(jp):
            out.extend(read_journal(jp, event=event))
    return out


def _second_cell(cell) -> tuple:
    """A fresh off-lattice fingerprint adjacent to ``cell`` (drills that
    need two never-queried cells)."""
    return (float(cell[0]), float(cell[1]), float(cell[2]) + 1e-3)


def _dr_replica_kill(plan: DRPlan, ctl, replicas, cell) -> dict:
    """SIGKILL one replica: a 3-replica quorum keeps electing with 2,
    and the restarted replica recovers its exact map from WAL+snapshot
    (``WAL_REPLAY`` in its own journal)."""
    victim = replicas.n - 1
    replays_before = len(_replica_events(replicas, "WAL_REPLAY",
                                         i=victim))
    replicas.kill(victim, signal.SIGKILL)
    rc_ok = _poll_until(
        lambda: replicas.returncode(victim) == -int(signal.SIGKILL),
        plan.settle_timeout_s)
    res = ctl.query(cell)            # cold election on a 2/3 quorum
    key = int(res["key"])
    replicas.restart(victim)
    replayed = len(_replica_events(replicas, "WAL_REPLAY",
                                   i=victim)) > replays_before
    return {"injected": 1,
            "detected": int(rc_ok and replayed),
            "keys": [key], "victim_rc": replicas.returncode(victim),
            "answered": True, "replayed": replayed,
            "expected_dup": False}


def _dr_torn_wal_tail(plan: DRPlan, ctl, replicas, cell) -> dict:
    """Hard-kill a replica and tear its WAL tail (the partial final
    record a crash mid-append leaves): recovery must skip EXACTLY that
    record, loudly (``WAL_REPLAY`` with ``torn_skipped >= 1``), and
    serve every earlier acknowledged mutation."""
    victim = replicas.n - 1
    res0 = ctl.query(cell)           # ensure there is real CAS history
    key = int(res0["key"])
    replicas.kill(victim, signal.SIGKILL)
    _poll_until(lambda: replicas.returncode(victim) is not None,
                plan.settle_timeout_s)
    wal = os.path.join(replicas.data_dirs[victim], "cas.wal")
    with open(wal, "ab") as f:   # atomic-ok: the drill WRITES a torn tail
        f.write(b'{"seq":999999999,"k":1,"o":"torn')
    replicas.restart(victim)
    torn = [ev for ev in _replica_events(replicas, "WAL_REPLAY",
                                         i=victim)
            if ev.get("torn_skipped", 0) >= 1]
    res1 = ctl.query(_second_cell(cell))   # quorum still elects
    return {"injected": 1,
            "detected": int(bool(torn)),
            "keys": [key, int(res1["key"])],
            "torn_detected": bool(torn), "answered": True,
            "expected_dup": False}


def _dr_snapshot_mid_write(plan: DRPlan, ctl, replicas, cell) -> dict:
    """ENOSPC exactly at a replica's snapshot write (armed over the
    wire through the replica's own ``inject_fault`` op, fired by real
    compaction pressure): the replica journals ``DISK_FAULT``, keeps
    serving from memory + WAL, and the next compaction window retries."""
    from .lease import LoopbackCASBackend

    victim = 0
    cli = LoopbackCASBackend(f"127.0.0.1:{replicas.ports[victim]}")
    base = 0x5D15C000_00000000   # synthetic drill keys, off any lattice
    try:
        cli.inject_fault("atomic_write_json", kind="ENOSPC", count=1,
                         match="cas.snapshot")
        fired = False
        for i in range(int(plan.mutation_budget)):
            cli.try_acquire(base + i, "dr-snapshot-drill")
            cli.release(base + i, owner="dr-snapshot-drill")
            fired = bool(_replica_events(replicas, "DISK_FAULT",
                                         i=victim))
            if fired:
                break
        still_serving = cli.try_acquire(base + 999_999,
                                        "dr-snapshot-drill")
        cli.release(base + 999_999, owner="dr-snapshot-drill")
    finally:
        cli.close()
    res = ctl.query(cell)
    return {"injected": 1,
            "detected": int(fired and still_serving),
            "keys": [int(res["key"])], "fault_journaled": fired,
            "replica_served_after": bool(still_serving),
            "answered": True, "expected_dup": False}


def _dr_minority_partition(plan: DRPlan, ctl, replicas, cell) -> dict:
    """Client-side partition in two acts.  Minority unreachable: the
    worker keeps electing (quorum holds).  Majority unreachable: the
    worker's claims degrade TYPED (``QUORUM_LOST`` +
    ``LEASE_BACKEND_FAULT`` journaled, query parked); healing the
    partition lets the parked election win, and first contact with the
    returning replicas anti-entropy-resyncs them
    (``REPLICA_RESYNC``)."""
    worker, _ = ctl.two_live_workers()
    n = replicas.n
    # act 1: minority gone — still serves
    _arm(ctl, worker, {"partition_replicas": [n - 1]})
    res1 = ctl.query(cell, prefer=worker)
    key1 = int(res1["key"])
    # act 2: majority gone — typed degrade, then heal.  Counts are
    # taken before/after: earlier drills' replica restarts already left
    # resync events, and detection must be THIS drill's evidence.
    lost0 = len(_journal_events(ctl, "QUORUM_LOST"))
    resync0 = len(_journal_events(ctl, "REPLICA_RESYNC"))
    _arm(ctl, worker, {"partition_replicas": list(range(1, n))})
    cell2 = _second_cell(cell)
    result: dict = {}

    def _ask():
        try:
            result["res"] = ctl.query(cell2, prefer=worker)
        except Exception as e:
            result["err"] = e

    t = threading.Thread(target=_ask, name="dr-partition-client")
    t.start()
    try:
        lost = _poll_until(
            lambda: len(_journal_events(ctl, "QUORUM_LOST")) > lost0,
            plan.settle_timeout_s)
    finally:
        _arm(ctl, worker, {"partition_replicas": []})
    t.join(plan.settle_timeout_s)
    res2 = result.get("res")
    faults = [ev for ev in _journal_events(ctl, "LEASE_BACKEND_FAULT")
              if "CoordinationUnavailable" in str(ev.get("detail", ""))]
    resynced = len(_journal_events(ctl, "REPLICA_RESYNC")) > resync0
    keys = [key1] + ([] if res2 is None else [int(res2["key"])])
    return {"injected": 1,
            "detected": int(lost and bool(faults) and res2 is not None
                            and resynced),
            "keys": keys, "answered_minority": True,
            "quorum_lost_journaled": lost,
            "typed_degrades": len(faults),
            "answered_after_heal": res2 is not None,
            "resynced": resynced, "expected_dup": False}


def _dr_disk_full_publish(plan: DRPlan, ctl, replicas, cell) -> dict:
    """ENOSPC at a worker's store publish: the entry degrades to
    memory-only (``STORE_DEGRADED`` journaled), the query is still
    answered, and a peer re-solves the key onto healthy disk with
    bit-identical values."""
    victim, peer = ctl.two_live_workers()
    _arm(ctl, victim, {"disk_fault": {"op": "save_pytree",
                                      "kind": "ENOSPC", "count": 1,
                                      "match": "sol_"}})
    try:
        res0 = ctl.query(cell, prefer=victim)
    finally:
        _disarm(ctl, victim)
    key = int(res0["key"])
    degraded = bool(_journal_events(ctl, "STORE_DEGRADED", key=key))
    res1 = ctl.query(cell, prefer=peer)    # peer re-solves onto disk
    bits_equal = _value_fields(res0) == _value_fields(res1)
    republished = len(_journal_events(ctl, "FLEET_PUBLISH",
                                      key=key)) >= 2
    survives = os.path.exists(os.path.join(
        ctl.store_dir, f"sol_{_hex(key)}.npz"))
    return {"injected": 1,
            "detected": int(degraded and bits_equal and republished
                            and survives),
            "keys": [key], "degraded_journaled": degraded,
            "bits_equal": bits_equal, "republished": republished,
            "entry_on_disk_after": survives, "expected_dup": True}


def _hex(key: int) -> str:
    from ..utils.fingerprint import fingerprint_hex

    return fingerprint_hex(key)
