"""Quorum-replicated CAS coordination: 2f+1 replicas, majority-ack
conditional writes, versioned quorum reads with read-repair, and
anti-entropy resync on replica rejoin (DESIGN §16; port of
the JAX package's ``serve/replicated.py``, host code, copied).

``ReplicatedCASBackend`` is a CLIENT: it holds no lease state of its
own, only connections to ``2f+1`` ``CASServer`` replicas (usually
durable ones — ``serve.wal``).  Every trait op reduces to two
primitives the replicas expose:

* **versioned quorum read** — ``get`` from every reachable replica;
  fewer than a majority reachable raises the typed
  ``CoordinationUnavailable`` (minority side of a partition: refuse,
  don't guess).  The winner is the highest version; among same-version
  variants (two writers' racing conditional puts can both land on
  DISJOINT minorities) the variant on MORE replicas wins, so every
  reader picks the same record the election actually produced.
  Replicas holding older versions are READ-REPAIRED in passing.
* **majority-ack conditional write** — ``put_rec(key, rec, version =
  winner + 1)``; each replica acks at most ONE writer per version
  number, so at most one writer can collect a majority: the
  exactly-once election property, preserved across replication and
  proven by the same two-real-process conformance races that pin the
  single-server backends (``tests/test_torch_replicated.py``).

Partition semantics follow the fleet contract: the minority side's
``CoordinationUnavailable`` flows into the store's typed
``LEASE_BACKEND_FAULT`` degrade (fail-safe defaults, keep serving
published bits), while the majority side never notices.  A replica that
failed an op is marked SUSPECT; the first successful contact after that
triggers an anti-entropy resync (merge the quorum's dumps, push every
newer record) journaled ``REPLICA_RESYNC`` — so a rejoining replica
(restart, healed partition) converges without waiting for per-key
read-repair traffic.

Clock notes: record stamps are written with the CLIENT's wall clock and
ages are computed by each REPLICA against its own clock; the
``skew_tolerance_s`` staleness window absorbs the spread,
and the winner's age is the MINIMUM over the replicas agreeing on the
winning version — a live owner's lease can only look fresher, never
staler, from aggregation.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from .lease import (
    CoordinationUnavailable,
    LeaseBackend,
    LoopbackCASBackend,
)


class ReplicatedCASBackend(LeaseBackend):
    """The quorum client over ``2f+1`` CAS replica addresses (see the
    module docstring for the protocol)."""

    name = "replicated-cas"

    def __init__(self, addresses: List[str],
                 skew_tolerance_s: float = 0.0,
                 timeout_s: float = 5.0, clock=None):
        addresses = [str(a) for a in addresses]
        if not addresses:
            raise ValueError("replicated backend needs >= 1 address")
        if len(addresses) % 2 == 0:
            raise ValueError(
                f"replicated backend wants an odd replica count (2f+1); "
                f"got {len(addresses)} — an even quorum tolerates no "
                "more faults and splits evenly")
        self.addresses = addresses
        self._clients = [LoopbackCASBackend(a, timeout_s=timeout_s)
                         for a in addresses]
        self.n = len(addresses)
        self.majority = self.n // 2 + 1
        self.skew_tolerance_s = float(skew_tolerance_s)
        self._clock = clock if clock is not None else time.time
        self._lock = threading.Lock()
        self._obs = None
        self._partitioned: set = set()   # injected unreachable indices
        self._suspect: set = set()       # failed an op; resync on rejoin
        self._in_resync = False
        self._quorum_ok = True           # QUORUM_LOST edge trigger
        self.resyncs = 0
        self.read_repairs = 0

    def attach_obs(self, obs) -> None:
        """Adopt an observability bundle so QUORUM_LOST/REPLICA_RESYNC
        land in the owning run's journal (first caller wins)."""
        if self._obs is None and obs is not None:
            self._obs = obs

    def _emit(self, etype: str, **attrs) -> None:
        if self._obs is not None:
            self._obs.event(etype, **attrs)
            return
        from ..obs.runtime import emit_event

        emit_event(etype, **attrs)

    # -- chaos hook ---------------------------------------------------------

    def set_partition(self, indices) -> None:
        """Injected client-side partition (drills): ops to these replica
        indices fail as if the network dropped them.  ``()`` heals."""
        with self._lock:
            self._partitioned = {int(i) for i in indices}

    # -- replica fan-out ----------------------------------------------------

    def _call_replica(self, i: int, op: str, **kw):
        with self._lock:
            if i in self._partitioned:
                raise ConnectionError(
                    f"injected partition from replica {self.addresses[i]}")
        return getattr(self._clients[i], op)(**kw)

    def _fanout(self, op: str, **kw):
        """One op against every replica: ``(results, failed)`` by
        index.  Rejoin detection rides along: a SUSPECT replica that
        answers again gets an anti-entropy resync before the result is
        used further."""
        results: Dict[int, object] = {}
        failed: Dict[int, Exception] = {}
        for i in range(self.n):
            try:
                results[i] = self._call_replica(i, op, **kw)
            except (OSError, ConnectionError) as e:
                failed[i] = e
        rejoined = []
        with self._lock:
            if not self._in_resync:
                rejoined = [i for i in results if i in self._suspect]
            self._suspect -= set(results)
            self._suspect |= set(failed)
        for i in rejoined:
            self._resync_replica(i)
        return results, failed

    def _require_quorum(self, op: str, results: dict) -> None:
        if len(results) >= self.majority:
            with self._lock:
                self._quorum_ok = True
            return
        self._quorum_lost(op, reachable=len(results))

    def _quorum_lost(self, op: str, reachable: int) -> None:
        """The lost-majority seam (covered by ``check_obs_events``):
        journal QUORUM_LOST on the healthy→lost EDGE (a partitioned
        worker retries every op; one event per outage, not per call)
        and raise the typed refusal either way."""
        with self._lock:
            first = self._quorum_ok
            self._quorum_ok = False
        if first:
            self._emit("QUORUM_LOST", op=str(op), reachable=int(reachable),
                       needed=int(self.majority),
                       replicas=list(self.addresses))
        raise CoordinationUnavailable(
            f"quorum lost: {reachable}/{self.n} replicas reachable for "
            f"{op!r}, need {self.majority} — refusing a minority answer")

    # -- quorum read + read-repair ------------------------------------------

    @staticmethod
    def _winner(results: dict):
        """The quorum read's winning record: highest version; among
        same-version variants, the one on most replicas (then the
        lexicographically smallest (stamp, owner), so every reader
        converges on the same pick).  Returns ``(rec, age, holders)``
        with ``age`` the MIN age reported for the winning variant."""
        top_v = 0
        for rec in results.values():
            if rec is not None:
                top_v = max(top_v, int(rec["version"]))
        if top_v == 0:
            return None, None, []
        variants: dict = {}
        for i, rec in results.items():
            if rec is None or int(rec["version"]) != top_v:
                continue
            ident = (rec["owner"], float(rec["stamp"]))
            variants.setdefault(ident, []).append(i)
        (owner, stamp), holders = min(
            variants.items(),
            key=lambda kv: (-len(kv[1]), kv[0][1],
                            kv[0][0] is not None, kv[0][0] or ""))
        ages = [results[i]["age"] for i in holders
                if results[i]["age"] is not None]
        rec = {"owner": owner, "stamp": stamp, "version": top_v}
        return rec, (min(ages) if ages else None), holders

    def _quorum_get(self, key: int, repair: bool = True, now=None):
        results, _failed = self._fanout("get", key=int(key), now=now)
        self._require_quorum("get", results)
        win, age, holders = self._winner(results)
        if win is not None and repair:
            stale = [i for i, rec in results.items()
                     if (0 if rec is None else int(rec["version"]))
                     < win["version"]]
            if stale:
                self._read_repair(int(key), win, stale)
        return win, age

    def _read_repair(self, key: int, win: dict, stale: list) -> None:
        """Push the winning record to replicas observed behind it (the
        per-key half of anti-entropy; journaled REPLICA_RESYNC, covered
        by ``check_obs_events``).  Best-effort: a replica that refuses
        or drops mid-repair is repaired again on the next read."""
        repaired = []
        for i in stale:
            try:
                if self._call_replica(i, "put_rec", key=key,
                                      owner=win["owner"],
                                      stamp=win["stamp"],
                                      version=win["version"]):
                    repaired.append(self.addresses[i])
            except (OSError, ConnectionError):
                continue
        if repaired:
            with self._lock:
                self.read_repairs += len(repaired)
            self._emit("REPLICA_RESYNC", mode="read_repair", key=int(key),
                       version=int(win["version"]), replicas=repaired)

    # -- anti-entropy resync (replica rejoin) --------------------------------

    def _resync_replica(self, i: int) -> None:
        """Full-map repair of one rejoined replica (journaled
        REPLICA_RESYNC, covered by ``check_obs_events``): merge every
        reachable peer's dump by the same winner rule and push each
        record the rejoined replica is missing or holds stale."""
        with self._lock:
            if self._in_resync:
                return
            self._in_resync = True
        try:
            dumps, _failed = self._fanout("dump")
            if len(dumps) < self.majority or i not in dumps:
                return
            have = {int(k): int(v) for k, _o, _t, v in dumps[i]}
            merged: dict = {}
            for j, rows in dumps.items():
                for k, owner, stamp, version in rows:
                    k, version = int(k), int(version)
                    cur = merged.get(k)
                    if cur is None or version > cur[2]:
                        merged[k] = (owner, float(stamp), version)
            pushed = 0
            for k, (owner, stamp, version) in merged.items():
                if have.get(k, 0) >= version:
                    continue
                try:
                    if self._call_replica(i, "put_rec", key=k, owner=owner,
                                          stamp=stamp, version=version):
                        pushed += 1
                except (OSError, ConnectionError):
                    return
            with self._lock:
                self.resyncs += 1
            self._emit("REPLICA_RESYNC", mode="anti_entropy",
                       replica=self.addresses[i], pushed=int(pushed),
                       keys=len(merged))
        finally:
            with self._lock:
                self._in_resync = False

    # -- conditional writes --------------------------------------------------

    def _cond_write(self, op: str, key: int, owner: Optional[str],
                    expect_version: int) -> bool:
        """Majority-ack conditional put at ``expect_version + 1``.
        Fewer than a majority of ACKS (not merely of responses) means a
        racing writer won the version — the election's loser."""
        version = int(expect_version) + 1
        results, _failed = self._fanout(
            "put_rec", key=int(key), owner=owner,
            stamp=float(self._clock()), version=version)
        self._require_quorum(op, results)
        acks = sum(1 for r in results.values() if r)
        return acks >= self.majority

    # -- the LeaseBackend trait ----------------------------------------------

    def try_acquire(self, key: int, owner: str) -> bool:
        win, _age = self._quorum_get(key)
        if win is not None and win["owner"] is not None:
            return False
        expect = 0 if win is None else int(win["version"])
        return self._cond_write("try_acquire", key, str(owner), expect)

    def release(self, key: int, owner: Optional[str] = None) -> bool:
        win, _age = self._quorum_get(key)
        if win is None or win["owner"] is None:
            return False
        if owner is not None and win["owner"] != str(owner):
            return False
        return self._cond_write("release", key, None, int(win["version"]))

    def heartbeat(self, key: int, owner: str) -> bool:
        win, _age = self._quorum_get(key)
        if win is None or win["owner"] != str(owner):
            return False
        return self._cond_write("heartbeat", key, str(owner),
                                int(win["version"]))

    def age_s(self, key: int, now=None) -> Optional[float]:
        # ``now`` rides the versioned read to every replica, which
        # computes age against it instead of its own clock — the trait's
        # single-clock semantics (backward-clock clamp, skew drills)
        # hold verbatim on the quorum; the winner's age is still the
        # MIN over the winning variant's holders.
        win, age = self._quorum_get(key, now=now)
        if win is None or win["owner"] is None:
            return None
        return age

    def break_stale(self, key: int, ttl_s: float, now=None) -> bool:
        win, age = self._quorum_get(key, now=now)
        if win is None or win["owner"] is None or age is None:
            return False
        if age <= float(ttl_s) + self.skew_tolerance_s:
            return False
        # the version guard IS the reclaim-vs-heartbeat close: a beat
        # that landed after our read bumped the version, so our
        # conditional put collides and the majority refuses it
        return self._cond_write("break_stale", key, None,
                                int(win["version"]))

    def owner_of(self, key: int) -> Optional[str]:
        win, _age = self._quorum_get(key)
        return None if win is None else win["owner"]

    def list_keys(self) -> List[int]:
        dumps, _failed = self._fanout("dump")
        self._require_quorum("dump", dumps)
        merged: dict = {}
        for rows in dumps.values():
            for k, owner, stamp, version in rows:
                k, version = int(k), int(version)
                cur = merged.get(k)
                if cur is None or version > cur[1]:
                    merged[k] = (owner, version)
        return sorted(k for k, (owner, _v) in merged.items()
                      if owner is not None)

    def backdate(self, key: int, dt_s: float) -> None:
        """Test hook: age the lease on EVERY replica (strict — a
        partially-backdated quorum would make staleness tests flaky)."""
        _results, failed = self._fanout("backdate", key=int(key),
                                        dt_s=float(dt_s))
        if failed:
            raise ConnectionError(
                f"backdate could not reach replicas "
                f"{sorted(failed)}: {list(failed.values())[0]}")

    def reachable(self) -> int:
        """How many replicas answer a ping right now (health probe)."""
        results, _failed = self._fanout("ping")
        return len(results)

    def close(self) -> None:
        for c in self._clients:
            c.close()


# -- replica process harness --------------------------------------------------


class ReplicaSet:
    """Spawn/kill/restart ``2f+1`` durable CAS replica PROCESSES (the
    ``serve.lease`` replica entry point) — the DR drills' and
    ``--dr-smoke``'s substrate.  Each replica gets its own WAL+snapshot
    directory and journal under ``root``; ``spec`` is the
    ``replicated:...`` spelling workers consume.  Ports are pinned
    after the first spawn so a RESTARTED replica comes back at the same
    address and clients simply re-dial."""

    def __init__(self, root: str, n: int = 3, snapshot_every: int = 64,
                 ready_timeout_s: float = 60.0):
        if n < 1 or n % 2 == 0:
            raise ValueError(f"replica count must be odd (2f+1), got {n}")
        self.root = str(root)
        self.n = int(n)
        self.snapshot_every = int(snapshot_every)
        self.ready_timeout_s = float(ready_timeout_s)
        self.data_dirs = [os.path.join(self.root, f"replica{i}")
                          for i in range(self.n)]
        self.journals = [os.path.join(self.root, f"replica{i}.journal")
                         for i in range(self.n)]
        self.procs: List[Optional[subprocess.Popen]] = [None] * self.n
        self.ports: List[Optional[int]] = [None] * self.n

    @property
    def spec(self) -> str:
        ports = [p for p in self.ports if p is not None]
        if len(ports) != self.n:
            raise RuntimeError("replica set not fully started")
        return "replicated:" + ",".join(
            f"127.0.0.1:{p}" for p in self.ports)

    def addresses(self) -> List[str]:
        return [f"127.0.0.1:{p}" for p in self.ports if p is not None]

    def start(self) -> "ReplicaSet":
        for i in range(self.n):
            self.start_replica(i)
        return self

    def start_replica(self, i: int) -> None:
        """Spawn replica ``i`` (fresh or RESTART over its surviving
        data dir — recovery is the replica's own WAL replay)."""
        os.makedirs(self.data_dirs[i], exist_ok=True)
        cmd = [sys.executable, "-m", "aiyagari_hark_tpu_torch.serve.lease",
               "--port", str(self.ports[i] or 0),
               "--data-dir", self.data_dirs[i],
               "--journal", self.journals[i],
               "--snapshot-every", str(self.snapshot_every)]
        env = dict(os.environ)
        # the replica runs `-m aiyagari_hark_tpu_torch.serve.lease`: make the
        # package importable even when the CALLER found it via sys.path
        # rather than cwd (a path-hacked harness in another directory)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else pkg_root)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True,
                                env=env)
        port = self._await_ready(proc, i)
        self.procs[i] = proc
        self.ports[i] = port

    def _await_ready(self, proc: subprocess.Popen, i: int) -> int:
        import selectors

        sel = selectors.DefaultSelector()
        sel.register(proc.stdout, selectors.EVENT_READ)
        deadline = time.monotonic() + self.ready_timeout_s  # timing-ok: readiness deadline, not a measurement
        buf = ""
        try:
            while time.monotonic() < deadline:  # timing-ok: readiness deadline, not a measurement
                if proc.poll() is not None:
                    raise RuntimeError(
                        f"CAS replica {i} exited rc={proc.returncode} "
                        "before CAS_READY (corrupt WAL refuses typed — "
                        "check its data dir)")
                if not sel.select(timeout=0.2):
                    continue
                chunk = proc.stdout.readline()
                if not chunk:
                    continue
                buf = chunk.strip()
                if buf.startswith("CAS_READY"):
                    return int(buf.split("port=")[1].split()[0])
            raise TimeoutError(
                f"CAS replica {i} not ready after "
                f"{self.ready_timeout_s:.0f}s (last line: {buf!r})")
        finally:
            sel.close()

    def alive(self, i: int) -> bool:
        p = self.procs[i]
        return p is not None and p.poll() is None

    def kill(self, i: int, sig: int = signal.SIGKILL) -> None:
        p = self.procs[i]
        if p is not None and p.poll() is None:
            p.send_signal(sig)
            p.wait(timeout=30)

    def kill_all(self, sig: int = signal.SIGKILL) -> None:
        for i in range(self.n):
            self.kill(i, sig=sig)

    def restart(self, i: int) -> None:
        self.kill(i)
        self.start_replica(i)

    def returncode(self, i: int):
        p = self.procs[i]
        return None if p is None else p.poll()

    def stop(self) -> None:
        """Orderly teardown: SIGTERM, wait, SIGKILL stragglers."""
        for i in range(self.n):
            p = self.procs[i]
            if p is not None and p.poll() is None:
                p.terminate()
        for i in range(self.n):
            p = self.procs[i]
            if p is None:
                continue
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)

    def __enter__(self) -> "ReplicaSet":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()
