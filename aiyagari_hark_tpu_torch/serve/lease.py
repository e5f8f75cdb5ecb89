"""Pluggable lease-coordination backends for the fleet tier (DESIGN §14;
port of ``aiyagari_hark_tpu/serve/lease.py``, host code, copied).

The claim/lease/publish protocol the shared ``SolutionStore`` runs
(exactly-once election per solution fingerprint, heartbeat-refreshed
liveness, TTL reclaim of a crashed winner) was born fused to ONE
implementation: lease files on one filesystem, ``O_CREAT | O_EXCL`` for
the election and mtime for staleness.  A multi-host tier
needs the same protocol over an object store or coordination service —
so the protocol is now a trait, ``LeaseBackend``, with the election
semantics specified by one shared conformance suite
(``tests/test_torch_serve_store.py`` holds it against the JAX
package's) instead of by whatever the filesystem
happens to do:

* ``SharedDirBackend`` — the existing shared-directory implementation,
  verbatim semantics (``lease_<hex>.lease`` files via
  ``utils.checkpoint``); the fleet default.  Byte-compatible with the
  JAX package's stores: same filenames, same payloads.
* ``MemoryCASBackend`` — an in-memory backend modeling OBJECT-STORE
  conditional-put semantics: a lease is a versioned record, acquisition
  is put-if-absent, heartbeat is read-check-owner-bump, and reclaim is
  delete-if-version-unchanged — the compare-and-swap shape an
  S3/GCS/etcd backend would use, so the reclaim-vs-heartbeat race is
  closed by VERSION, not by filesystem atomicity.  Single-process by
  construction (it is a dict); its job is to pin the conformance
  contract a real remote backend must meet.
* ``CASServer`` + ``LoopbackCASBackend`` — the memory backend served
  over a line-JSON TCP loopback, so REAL separate processes can run the
  conformance races (two interpreters' concurrent claims) against the
  CAS semantics, and a fleet worker can be pointed at a shared CAS
  authority with ``--lease-backend cas:<host>:<port>``.

Contract notes shared by every backend:

* ``release``/``heartbeat`` are OWNER-CHECKED: a stalled winner whose
  lease was TTL-reclaimed and re-acquired by a peer must not delete the
  peer's fresh lease when it finally wakes and releases (the unchecked
  ``os.remove`` release had exactly this bug), and its heartbeat must
  return False — "you no longer hold this" — instead of resurrecting a
  stolen claim.
* ages are CLAMPED at zero and staleness honors a ``skew_tolerance_s``
  window: a backward wall-clock step never makes a
  fresh lease stale, and a reclaimer's forward skew must exceed
  ``ttl + tolerance`` before it can steal from a live owner.
* backend choice NEVER enters solution fingerprints or served bytes —
  it decides who solves, not what a solve produces.

Host-side coordination only: no torch, no device.
"""

from __future__ import annotations

import glob
import json
import os
import socket
import socketserver
import threading
import time
from typing import Dict, List, Optional

from ..utils.checkpoint import (
    LEASE_SUFFIX,
    acquire_lease,
    break_stale_lease,
    lease_age_s,
    read_lease,
    release_lease,
)
from ..utils.fingerprint import fingerprint_hex


def key_from_hex(hex_str: str) -> int:
    """Inverse of ``utils.fingerprint.fingerprint_hex``: the signed
    int64 back from its two's-complement hex spelling."""
    v = int(hex_str, 16)
    return v - (1 << 64) if v >= (1 << 63) else v


class CoordinationUnavailable(ConnectionError):
    """The replicated coordination tier cannot reach a MAJORITY of its
    replicas: conditional writes and quorum reads are
    refused rather than answered from a minority view.  A subclass of
    ``ConnectionError`` on purpose — the store's ``_backend_call``
    degrade path (typed ``LEASE_BACKEND_FAULT``, fail-safe defaults,
    the partition semantics) owns it without a new catch site, and
    the fleet HTTP tier maps it to a retryable 503."""


class LeaseBackend:
    """The coordination trait: per-fingerprint lease election with
    heartbeat liveness and TTL reclaim.  Keys are signed int64 solution
    fingerprints; owners are diagnostic worker ids (election correctness
    never depends on reading them, but release/heartbeat verify them).

    Every method is non-blocking and exception-free under normal
    operation; a backend whose substrate can fail transiently (network
    CAS) raises ``OSError``/``ConnectionError`` and the store degrades
    through its typed ``LEASE_BACKEND_FAULT`` path."""

    name = "abstract"

    def try_acquire(self, key: int, owner: str) -> bool:
        """Atomically create the key's lease.  True iff THIS caller now
        owns it; False when any lease for the key already exists."""
        raise NotImplementedError

    def release(self, key: int, owner: Optional[str] = None) -> bool:
        """Remove the key's lease; True iff this call removed it.  With
        ``owner`` given, remove ONLY a lease that owner holds (a lease
        re-acquired by a peer after a reclaim survives the original
        owner's late release).  An unreadable/ownerless lease record
        yields to the release — existence is the contract, the payload
        is diagnostic."""
        raise NotImplementedError

    def heartbeat(self, key: int, owner: str) -> bool:
        """Refresh the lease's liveness stamp.  True iff the lease still
        exists AND is owned by ``owner``; False means the claim was
        released, reclaimed, or stolen — the caller must stop treating
        the key as held."""
        raise NotImplementedError

    def age_s(self, key: int, now=None) -> Optional[float]:
        """Seconds since the last acquire/heartbeat stamp, clamped >= 0;
        None when no lease exists."""
        raise NotImplementedError

    def break_stale(self, key: int, ttl_s: float, now=None) -> bool:
        """Reclaim the key's lease iff its age exceeds ``ttl_s +
        skew_tolerance_s``; True iff this call removed it."""
        raise NotImplementedError

    def owner_of(self, key: int) -> Optional[str]:
        """The lease's recorded owner, None when no lease exists (or
        the payload is unreadable — the lease itself may still exist;
        probe with ``age_s``)."""
        raise NotImplementedError

    def list_keys(self) -> List[int]:
        """Every key with a live lease record, any owner (leak audit)."""
        raise NotImplementedError

    def lease_names(self) -> List[str]:
        """Audit spelling of every live lease (the shared-dir backend
        returns real file paths; others synthesize the same naming)."""
        return [f"lease_{fingerprint_hex(k)}{LEASE_SUFFIX}"
                for k in sorted(self.list_keys())]

    def close(self) -> None:
        """Release backend resources (sockets); leases are NOT touched —
        a closing process's held leases reclaim through the TTL."""


class SharedDirBackend(LeaseBackend):
    """Lease files in one shared directory — the original protocol
    behind the trait, byte-compatible (``lease_<hex>.lease``, O_EXCL
    create, mtime staleness).  Single-host-N-process scope: it trusts
    one filesystem's atomic create and one wall clock.

    ``release``/``heartbeat`` owner checks are read-then-act (the
    filesystem has no conditional delete); the TOCTOU window is
    microseconds against a reclaim that already took the TTL to open,
    honest for this backend's scope — the CAS backend closes the same
    race by version."""

    name = "shared-dir"

    def __init__(self, root: str, skew_tolerance_s: float = 0.0):
        self.root = str(root)
        self.skew_tolerance_s = float(skew_tolerance_s)

    def _path(self, key: int) -> str:
        return os.path.join(self.root,
                            f"lease_{fingerprint_hex(key)}{LEASE_SUFFIX}")

    def _resolve(self, key: int) -> str:
        """The canonical (zero-padded) path, or an EXISTING alternate
        hex spelling of the same key — pre-trait sweeps globbed the
        directory and acted on whatever file was there, so the sweep
        path must still find e.g. ``lease_feedbeef.lease`` even though
        new claims always write the padded form."""
        path = self._path(key)
        if os.path.exists(path):
            return path
        for cand in glob.glob(os.path.join(
                self.root, f"lease_*{LEASE_SUFFIX}")):
            stem = os.path.basename(cand)[len("lease_"):-len(LEASE_SUFFIX)]
            try:
                if key_from_hex(stem) == int(key):
                    return cand
            except ValueError:
                continue
        return path

    def try_acquire(self, key: int, owner: str) -> bool:
        return acquire_lease(self._path(key), owner=owner)

    def release(self, key: int, owner: Optional[str] = None) -> bool:
        path = self._path(key)
        if owner is not None:
            rec = read_lease(path)
            if rec is None:
                return False
            holder = rec.get("owner")
            if holder is not None and holder != str(owner):
                return False     # a peer re-acquired it: not ours to drop
        return release_lease(path)

    def heartbeat(self, key: int, owner: str) -> bool:
        path = self._path(key)
        rec = read_lease(path)
        if rec is None:
            return False         # released/reclaimed: we no longer hold it
        holder = rec.get("owner")
        if holder is not None and holder != str(owner):
            return False         # reclaimed AND re-acquired by a peer
        try:
            os.utime(path)
        except OSError:
            return False         # vanished between read and touch
        return True

    def age_s(self, key: int, now=None) -> Optional[float]:
        return lease_age_s(self._resolve(key), now=now)

    def break_stale(self, key: int, ttl_s: float, now=None) -> bool:
        return break_stale_lease(self._resolve(key), ttl_s, now=now,
                                 tolerance_s=self.skew_tolerance_s)

    def owner_of(self, key: int) -> Optional[str]:
        rec = read_lease(self._resolve(key))
        return None if rec is None else rec.get("owner")

    def list_keys(self) -> List[int]:
        out = []
        for path in glob.glob(os.path.join(
                self.root, f"lease_*{LEASE_SUFFIX}")):
            stem = os.path.basename(path)[len("lease_"):-len(LEASE_SUFFIX)]
            try:
                out.append(key_from_hex(stem))
            except ValueError:
                continue         # foreign file matching the glob: not ours
        return sorted(out)

    def lease_names(self) -> List[str]:
        # real paths, sorted — the pre-trait ``lease_files()`` spelling
        return sorted(glob.glob(os.path.join(
            self.root, f"lease_*{LEASE_SUFFIX}")))


class _Rec:
    """One CAS lease record: owner + liveness stamp + version (the
    conditional-put token).  ``owner is None`` is a TOMBSTONE:
    a released/reclaimed lease keeps its record with the version
    bumped, so per-key versions are MONOTONIC forever — the property
    quorum replication and read-repair need to order a deletion against
    a re-acquire ("highest version wins" is only sound when a delete
    carries a version instead of erasing one)."""

    __slots__ = ("owner", "stamp", "version")

    def __init__(self, owner: Optional[str], stamp: float,
                 version: int = 1):
        self.owner = owner
        self.stamp = stamp
        self.version = version


class MemoryCASBackend(LeaseBackend):
    """Object-store conditional-put semantics over an in-memory dict:

    * acquire  = put-if-absent (one writer wins, the CAS primitive);
    * heartbeat = read; if owner matches, bump stamp AND version;
    * reclaim  = read (stamp, version); if stale, tombstone-if-version —
      a heartbeat that lands between the read and the delete bumps the
      version and the delete is REFUSED, so a live owner can never lose
      its lease to a reclaimer that raced its beat (the race the
      shared-dir backend can only shrink, closed exactly here).

    Deletions are tombstones (see ``_Rec``): invisible through the
    trait (``age_s``/``owner_of`` read None, ``list_keys`` skips them,
    acquire treats them as absent) but version-ordered for the
    replication tier's ``get``/``put_rec``/``dump`` primitives.

    ``clock`` is injectable for deterministic staleness tests; the
    default is the wall clock (leases coordinate processes)."""

    name = "memory-cas"

    def __init__(self, clock=None, skew_tolerance_s: float = 0.0):
        self._recs: Dict[int, _Rec] = {}
        # reentrant: the durable subclass logs WAL records from inside
        # the mutators' critical sections (serve.wal)
        self._lock = threading.RLock()
        self._clock = clock if clock is not None else time.time
        self.skew_tolerance_s = float(skew_tolerance_s)

    def try_acquire(self, key: int, owner: str) -> bool:
        key = int(key)
        with self._lock:
            rec = self._recs.get(key)
            if rec is not None and rec.owner is not None:
                return False
            version = 1 if rec is None else rec.version + 1
            self._recs[key] = _Rec(str(owner), float(self._clock()),
                                   version)
            self._mutated(key)
            return True

    def release(self, key: int, owner: Optional[str] = None) -> bool:
        key = int(key)
        with self._lock:
            rec = self._recs.get(key)
            if rec is None or rec.owner is None:
                return False
            if owner is not None and rec.owner != str(owner):
                return False
            rec.owner = None
            rec.stamp = float(self._clock())
            rec.version += 1
            self._mutated(key)
            return True

    def heartbeat(self, key: int, owner: str) -> bool:
        key = int(key)
        with self._lock:
            rec = self._recs.get(key)
            if rec is None or rec.owner != str(owner):
                return False
            rec.stamp = float(self._clock())
            rec.version += 1
            self._mutated(key)
            return True

    def age_s(self, key: int, now=None) -> Optional[float]:
        key = int(key)
        with self._lock:
            rec = self._recs.get(key)
            if rec is None or rec.owner is None:
                return None
            now = float(self._clock()) if now is None else float(now)
            return max(0.0, now - rec.stamp)

    def break_stale(self, key: int, ttl_s: float, now=None) -> bool:
        key = int(key)
        with self._lock:
            rec = self._recs.get(key)
            if rec is None or rec.owner is None:
                return False
            now_v = float(self._clock()) if now is None else float(now)
            age = max(0.0, now_v - rec.stamp)
            if age <= float(ttl_s) + self.skew_tolerance_s:
                return False
            version = rec.version
            # tombstone-if-version: under this lock the re-read is
            # trivially current, but the shape is the remote-CAS
            # contract — a beat between the staleness read and the
            # delete MUST refuse it
            cur = self._recs.get(key)
            if cur is None or cur.version != version:
                return False
            cur.owner = None
            cur.stamp = float(self._clock())
            cur.version += 1
            self._mutated(key)
            return True

    def owner_of(self, key: int) -> Optional[str]:
        with self._lock:
            rec = self._recs.get(int(key))
            return None if rec is None else rec.owner

    def list_keys(self) -> List[int]:
        with self._lock:
            return sorted(k for k, rec in self._recs.items()
                          if rec.owner is not None)

    # -- replication primitives (serve.replicated) ----------------

    def get(self, key: int, now=None) -> Optional[dict]:
        """The versioned read: the key's full record — tombstones
        included — or None when the key was never seen.  ``age`` is
        computed HERE, against this replica's clock (stamps never cross
        clocks) unless the caller supplies its own ``now`` (the trait's
        single-clock affordance, forwarded by the quorum client so
        ``age_s(key, now=...)`` means the same thing on every backend);
        None for a tombstone."""
        with self._lock:
            rec = self._recs.get(int(key))
            if rec is None:
                return None
            now_v = float(self._clock()) if now is None else float(now)
            age = (None if rec.owner is None
                   else max(0.0, now_v - rec.stamp))
            return {"owner": rec.owner, "stamp": rec.stamp,
                    "version": rec.version, "age": age}

    def put_rec(self, key: int, owner: Optional[str], stamp: float,
                version: int) -> bool:
        """Conditional versioned write — the quorum-CAS primitive:
        apply iff ``version`` is STRICTLY newer than the stored one
        (absent = 0).  Each replica therefore acks at most one writer
        per version number, which is what makes a majority of acks an
        election.  Also the anti-entropy repair op (push a winner to a
        stale replica)."""
        key, version = int(key), int(version)
        with self._lock:
            cur = self._recs.get(key)
            if cur is not None and cur.version >= version:
                return False
            self._recs[key] = _Rec(
                None if owner is None else str(owner),
                float(stamp), version)
            self._mutated(key)
            return True

    def dump(self) -> list:
        """Every record (tombstones included) as ``[key, owner, stamp,
        version]`` rows — the anti-entropy transfer format."""
        with self._lock:
            return [[k, rec.owner, rec.stamp, rec.version]
                    for k, rec in sorted(self._recs.items())]

    def _mutated(self, key: int) -> None:
        """Post-mutation hook (lock held); the durable subclass appends
        the key's new record to its WAL here.  A no-op in memory."""

    # -- test hooks ---------------------------------------------------------

    def backdate(self, key: int, dt_s: float) -> None:
        """Age one lease by ``dt_s`` (conformance-suite staleness hook —
        the dict analogue of ``os.utime`` backdating a lease file)."""
        with self._lock:
            rec = self._recs.get(int(key))
            if rec is not None:
                rec.stamp -= float(dt_s)
                self._mutated(int(key))

    def inject_fault(self, writer: str, kind: str = "ENOSPC",
                     count: int = 1, match: str = "") -> bool:
        """Arm a deterministic disk fault in THIS process (drill hook —
        reaching a replica's ``utils.checkpoint`` injector over the
        wire is how the snapshot-mid-write drill works).  ``writer`` is
        the blessed-writer name (``op`` is taken by the wire dispatch)."""
        from ..utils.checkpoint import arm_disk_fault

        arm_disk_fault(writer, kind=kind, count=count, match=match)
        return True


# -- the loopback CAS: same semantics, across real processes ----------------

_CAS_OPS = {"try_acquire", "release", "heartbeat", "age_s",
            "break_stale", "owner_of", "list_keys", "backdate", "ping",
            # replication / durability tier: versioned read,
            # conditional versioned write, anti-entropy transfer, and
            # the drill hook arming a disk fault inside the replica
            "get", "put_rec", "dump", "inject_fault"}


class _CASHandler(socketserver.StreamRequestHandler):
    """One connection, many line-JSON requests: ``{"op": ..., ...}`` in,
    ``{"r": <result>}`` (or ``{"err": ...}``) out.  Every op executes
    under the wrapped backend's lock, so each request is atomic — the
    server IS the serialization point, exactly the role an object
    store's conditional-put API plays."""

    def handle(self):
        backend: MemoryCASBackend = self.server.backend
        for line in self.rfile:
            try:
                req = json.loads(line.decode("utf-8"))
                op = req.pop("op")
                if op not in _CAS_OPS:
                    raise ValueError(f"unknown CAS op {op!r}")
                r = (True if op == "ping"
                     else getattr(backend, op)(**req))
                resp = {"r": r}
            except Exception as e:   # a bad request must not kill the server
                resp = {"err": f"{type(e).__name__}: {e}"}
            try:
                self.wfile.write((json.dumps(resp) + "\n").encode("utf-8"))
            except OSError:
                return


class _CASTCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class CASServer:
    """A ``MemoryCASBackend`` served over loopback TCP so separate
    processes share one CAS authority.  ``address`` is ``host:port``
    (ephemeral port when constructed with ``port=0``).

    ``data_dir`` makes the server CRASH-DURABLE: the backend
    becomes a ``serve.wal.DurableCASBackend`` that write-ahead-logs
    every mutation (checksummed, fsynced) and compacts to an atomic
    snapshot every ``snapshot_every`` mutations, so a SIGKILLed replica
    restarted over the same directory recovers its exact version map."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 clock=None, skew_tolerance_s: float = 0.0,
                 data_dir: Optional[str] = None,
                 snapshot_every: int = 256, obs=None):
        if data_dir is not None:
            from .wal import DurableCASBackend

            self.backend: MemoryCASBackend = DurableCASBackend(
                data_dir, clock=clock,
                skew_tolerance_s=skew_tolerance_s,
                snapshot_every=snapshot_every, obs=obs)
        else:
            self.backend = MemoryCASBackend(
                clock=clock, skew_tolerance_s=skew_tolerance_s)
        self._srv = _CASTCPServer((host, int(port)), _CASHandler)
        self._srv.backend = self.backend
        self.host, self.port = self._srv.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "CASServer":
        # poll_interval bounds how long ``shutdown()`` blocks (the
        # default 0.5 s charges every short-lived server a teardown tax)
        self._thread = threading.Thread(
            target=lambda: self._srv.serve_forever(poll_interval=0.05),
            name="cas-server", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def __enter__(self) -> "CASServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()


class LoopbackCASBackend(LeaseBackend):
    """Client half of ``CASServer``: every trait op is one line-JSON
    round trip on a persistent per-backend connection (re-dialed on
    failure).  Substrate failures surface as ``ConnectionError`` — the
    store's ``LEASE_BACKEND_FAULT`` degrade path owns them."""

    name = "loopback-cas"

    def __init__(self, address: str, timeout_s: float = 10.0):
        host, _, port = str(address).rpartition(":")
        self.address = str(address)
        self._host, self._port = host or "127.0.0.1", int(port)
        self._timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._rfile = None

    def _call(self, op: str, **kw):
        with self._lock:
            for attempt in (0, 1):   # one re-dial on a dropped connection
                try:
                    if self._sock is None:
                        self._sock = socket.create_connection(
                            (self._host, self._port),
                            timeout=self._timeout_s)
                        self._rfile = self._sock.makefile("rb")
                    self._sock.sendall(
                        (json.dumps(dict(kw, op=op)) + "\n").encode())
                    line = self._rfile.readline()
                    if line:
                        break
                    raise ConnectionError("CAS server closed connection")
                except (OSError, ConnectionError):
                    self._close_locked()
                    if attempt:
                        raise
            resp = json.loads(line.decode("utf-8"))
        if "err" in resp:
            raise ConnectionError(f"CAS backend error: {resp['err']}")
        return resp["r"]

    def _close_locked(self) -> None:
        if self._rfile is not None:
            try:
                self._rfile.close()
            except OSError:
                pass
            self._rfile = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def try_acquire(self, key: int, owner: str) -> bool:
        return bool(self._call("try_acquire", key=int(key),
                               owner=str(owner)))

    def release(self, key: int, owner: Optional[str] = None) -> bool:
        return bool(self._call("release", key=int(key), owner=owner))

    def heartbeat(self, key: int, owner: str) -> bool:
        return bool(self._call("heartbeat", key=int(key),
                               owner=str(owner)))

    def age_s(self, key: int, now=None) -> Optional[float]:
        return self._call("age_s", key=int(key), now=now)

    def break_stale(self, key: int, ttl_s: float, now=None) -> bool:
        return bool(self._call("break_stale", key=int(key),
                               ttl_s=float(ttl_s), now=now))

    def owner_of(self, key: int) -> Optional[str]:
        return self._call("owner_of", key=int(key))

    def list_keys(self) -> List[int]:
        return [int(k) for k in self._call("list_keys")]

    def backdate(self, key: int, dt_s: float) -> None:
        self._call("backdate", key=int(key), dt_s=float(dt_s))

    # replication / durability primitives

    def get(self, key: int, now=None) -> Optional[dict]:
        return self._call("get", key=int(key), now=now)

    def put_rec(self, key: int, owner: Optional[str], stamp: float,
                version: int) -> bool:
        return bool(self._call("put_rec", key=int(key), owner=owner,
                               stamp=float(stamp), version=int(version)))

    def dump(self) -> list:
        return self._call("dump")

    def inject_fault(self, writer: str, kind: str = "ENOSPC",
                     count: int = 1, match: str = "") -> bool:
        return bool(self._call("inject_fault", writer=str(writer),
                               kind=str(kind), count=int(count),
                               match=str(match)))

    def ping(self) -> bool:
        return bool(self._call("ping"))

    def close(self) -> None:
        with self._lock:
            self._close_locked()


def make_backend(spec: str, root: Optional[str] = None,
                 skew_tolerance_s: float = 0.0) -> LeaseBackend:
    """Backend from a CLI spelling: ``dir`` (shared-directory default;
    needs ``root``), ``cas:<host>:<port>`` (loopback CAS client),
    ``replicated:<host>:<port>,...`` (quorum client over 2f+1 CAS
    replicas), or ``memory`` (single-process CAS, tests)."""
    spec = str(spec)
    if spec == "dir":
        if root is None:
            raise ValueError("lease backend 'dir' requires a store root")
        return SharedDirBackend(root, skew_tolerance_s=skew_tolerance_s)
    if spec.startswith("replicated:"):
        from .replicated import ReplicatedCASBackend

        addrs = [a.strip() for a in spec[len("replicated:"):].split(",")
                 if a.strip()]
        return ReplicatedCASBackend(addrs,
                                    skew_tolerance_s=skew_tolerance_s)
    if spec.startswith("cas:"):
        return LoopbackCASBackend(spec[len("cas:"):])
    if spec == "memory":
        return MemoryCASBackend(skew_tolerance_s=skew_tolerance_s)
    raise ValueError(
        f"unknown lease backend {spec!r} (expected 'dir', 'memory', "
        "'cas:<host>:<port>', or 'replicated:<h>:<p>,<h>:<p>,...')")


# -- replica process entry point ----------------------------------


def replica_main(argv=None) -> int:
    """Run one CAS replica as a standalone process:

        python -m aiyagari_hark_tpu_torch.serve.lease \\
            --port 0 --data-dir /path/to/replica0 --journal j.jsonl

    Prints ``CAS_READY port=<p> pid=<pid>`` once serving (the spawn
    harness parses it), recovers the version map from WAL+snapshot when
    ``--data-dir`` holds a prior life's state, and exits 0 on
    SIGTERM/SIGINT.  SIGKILL is the drill case: the WAL is the
    contract.  Host code only: a replica never touches the CUDA card."""
    import argparse
    import signal
    import sys

    p = argparse.ArgumentParser(prog="aiyagari-cas-replica")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--data-dir", default=None,
                   help="WAL+snapshot directory (durable mode)")
    p.add_argument("--journal", default=None,
                   help="append lifecycle events (WAL_REPLAY, "
                        "SNAPSHOT_COMPACT, DISK_FAULT) to this JSONL")
    p.add_argument("--snapshot-every", type=int, default=256)
    p.add_argument("--skew-tolerance-s", type=float, default=0.0)
    args = p.parse_args(argv)

    obs = None
    if args.journal is not None:
        from ..obs.runtime import ObsConfig, build_obs

        obs = build_obs(ObsConfig(enabled=True,
                                  journal_path=args.journal))
    srv = CASServer(host=args.host, port=args.port,
                    skew_tolerance_s=args.skew_tolerance_s,
                    data_dir=args.data_dir,
                    snapshot_every=args.snapshot_every, obs=obs)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    srv.start()
    print(f"CAS_READY port={srv.port} pid={os.getpid()}", flush=True)
    sys.stdout.flush()
    try:
        while not stop.is_set():
            stop.wait(0.2)
    finally:
        srv.stop()
        if obs is not None:
            obs.close()
    return 0


if __name__ == "__main__":   # pragma: no cover - subprocess entry
    import sys

    sys.exit(replica_main())
