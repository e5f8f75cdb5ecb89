"""Crash-durable CAS state: write-ahead log + snapshot compaction
(DESIGN §16; port of ``aiyagari_hark_tpu/serve/wal.py``, host code,
copied).

``MemoryCASBackend`` holds the fleet's entire coordination truth — every
lease, every version — in one process's dict: a SIGKILL loses all of it
at once, which is exactly the failure mode the chaos drills could
not survive.  ``DurableCASBackend`` keeps the dict (reads and the
conditional-write decision logic are unchanged and memory-speed) and
makes every MUTATION durable before the caller's ack:

* **WAL** (``cas.wal``): one checksummed JSONL record per mutation —
  the key's POST-state ``(owner, stamp, version)`` plus a monotonic
  ``seq`` — appended through the blessed ``utils.checkpoint
  .append_jsonl`` with ``durable=True`` (fsync file, and the directory
  on create).  State-based, not operation-based, on purpose: replay
  never re-runs an op against a clock, it re-applies exact records, so
  a recovered replica's version map is BIT-identical to the dead one's.
* **Snapshot** (``cas.snapshot.json``): every ``snapshot_every``
  mutations the full map is written via ``atomic_write_json`` (tmp +
  rename + fsync) with the covered ``seq`` and a whole-body checksum,
  then the WAL is atomically emptied.  A crash between the two leaves
  records with ``seq <= snapshot.seq`` in the WAL — replay filters
  them, so compaction is crash-consistent at every instruction.
* **Replay** (construction over a non-empty ``data_dir``): snapshot
  first (checksum-verified; a corrupt snapshot REFUSES typed — its WAL
  suffix is gone, recovery cannot pretend), then every WAL record with
  a newer ``seq``.  A torn FINAL line (the ``append_jsonl`` crash
  contract) is skipped LOUDLY, and the WAL is rewritten to its valid
  prefix (atomic, durable) before the replica serves: the port's
  difference from the JAX package, whose next append lands after the
  torn bytes on the same line, so a replica killed again before its
  next compaction refuses the mid-log record it made.  A corrupt record
  MID-log means external damage and refuses typed
  (``WALCorruptionError``) — the operator resyncs the replica from its
  quorum peers instead of serving a silently-wrong prefix.  Every
  recovery journals ``WAL_REPLAY``.

Disk faults (ENOSPC/EIO — injected by ``utils.checkpoint
.arm_disk_fault`` or real) degrade AVAILABILITY-first and loudly: a
failed WAL append or snapshot write warns + journals but the in-memory
op still serves (the replica's durability is degraded, its quorum's is
not — the other 2f replicas still log), and compaction re-arms after
another ``snapshot_every`` mutations.
"""

from __future__ import annotations

import contextlib
import json
import os
import warnings
import zlib
from typing import Optional

from ..utils.checkpoint import append_jsonl, atomic_write_json
from .lease import MemoryCASBackend, _Rec

WAL_NAME = "cas.wal"
SNAPSHOT_NAME = "cas.snapshot.json"


class WALCorruptionError(ValueError):
    """The WAL or snapshot is damaged beyond the crash contract (a
    corrupt record MID-log, a snapshot failing its checksum): recovery
    REFUSES rather than serve a silently-wrong prefix.  Typed so a
    supervisor can catch exactly this and re-seed the replica from its
    quorum peers (anti-entropy owns the rest)."""


def _checksum(payload: dict) -> int:
    """One canonical spelling for record/snapshot checksums: crc32 of
    the sorted, separator-minimal JSON of everything but ``ck``."""
    body = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF


def _read_wal(path: str):
    """Parse a WAL back: ``(records, torn_tail)``.

    Unlike ``read_jsonl_tolerant`` (skip anywhere), a WAL's tolerance
    is POSITIONAL: only the final line may be torn (the ``append_jsonl``
    crash artifact).  An unparseable or checksum-failing line anywhere
    else is external corruption — ``WALCorruptionError``."""
    with open(path, "rb") as f:
        raw_lines = [ln for ln in (r.strip() for r in f) if ln]
    records = []
    torn = 0
    for i, raw in enumerate(raw_lines):
        last = i == len(raw_lines) - 1
        try:
            rec = json.loads(raw.decode("utf-8"))
            ck = rec.pop("ck")
            if ck != _checksum(rec):
                raise ValueError("record checksum mismatch")
        except (ValueError, KeyError, UnicodeDecodeError) as e:
            if last:
                torn += 1
                break
            raise WALCorruptionError(
                f"CAS WAL {path}: unreadable record at line {i + 1} of "
                f"{len(raw_lines)} ({e}) — mid-log corruption is outside "
                "the torn-tail crash contract; refusing to replay a "
                "silently-wrong prefix (resync this replica from its "
                "quorum peers)") from e
        records.append(rec)
    return records, torn


def _read_snapshot(path: str) -> Optional[dict]:
    """The snapshot dict, or None when absent.  A snapshot that parses
    but fails its checksum refuses typed — its WAL suffix was truncated
    at compaction, so 'skip it' would silently lose every record it
    covered."""
    try:
        with open(path, "rb") as f:
            snap = json.loads(f.read().decode("utf-8"))
    except FileNotFoundError:
        return None
    except (ValueError, OSError, UnicodeDecodeError) as e:
        raise WALCorruptionError(
            f"CAS snapshot {path} is unreadable ({e}); its compacted "
            "WAL records are unrecoverable locally — resync this "
            "replica from its quorum peers") from e
    ck = snap.pop("ck", None)
    if ck != _checksum(snap):
        raise WALCorruptionError(
            f"CAS snapshot {path} failed its checksum (stored {ck}, "
            f"content hashes to {_checksum(snap)}) — silent corruption; "
            "resync this replica from its quorum peers")
    return snap


class DurableCASBackend(MemoryCASBackend):
    """A ``MemoryCASBackend`` whose every mutation is write-ahead
    logged, with periodic atomic snapshot compaction; construction over
    a directory with prior state replays it exactly.  See the module
    docstring for the format and crash contract."""

    name = "durable-cas"

    def __init__(self, data_dir: str, clock=None,
                 skew_tolerance_s: float = 0.0,
                 snapshot_every: int = 256, obs=None):
        super().__init__(clock=clock, skew_tolerance_s=skew_tolerance_s)
        self.data_dir = str(data_dir)
        os.makedirs(self.data_dir, exist_ok=True)
        self.wal_path = os.path.join(self.data_dir, WAL_NAME)
        self.snapshot_path = os.path.join(self.data_dir, SNAPSHOT_NAME)
        self.snapshot_every = max(1, int(snapshot_every))
        self._obs = obs
        self._seq = 0                 # last seq written (or recovered)
        self._since_snapshot = 0
        self._replaying = False
        self.wal_faults = 0           # degraded appends/snapshots
        self._recover_state()

    # -- observability ------------------------------------------------------

    def _emit(self, etype: str, **attrs) -> None:
        if self._obs is not None:
            self._obs.event(etype, **attrs)
            return
        from ..obs.runtime import emit_event

        emit_event(etype, **attrs)

    def _scope(self):
        """Activate this backend's obs around the checkpoint writers:
        a ``DISK_FAULT`` firing inside them (``_fire_disk_fault`` emits
        through the ACTIVE scope) must land in the replica's journal
        even from a server handler thread that never activated one."""
        return (self._obs.activate() if self._obs is not None
                else contextlib.nullcontext())

    # -- recovery (construction) -------------------------------------------

    def _recover_state(self) -> None:
        """Rebuild the version map from snapshot + WAL suffix (the
        ``WAL_REPLAY`` seam, covered by ``check_obs_events``).  A fresh
        directory recovers nothing and journals nothing."""
        snap = _read_snapshot(self.snapshot_path)
        had_wal = os.path.exists(self.wal_path)
        if snap is None and not had_wal:
            return
        snap_seq = 0
        with self._lock:
            self._replaying = True
            try:
                if snap is not None:
                    snap_seq = int(snap["seq"])
                    for k, owner, stamp, version in snap["recs"]:
                        self._recs[int(k)] = _Rec(
                            owner, float(stamp), int(version))
                records, torn = ([], 0)
                if had_wal:
                    records, torn = _read_wal(self.wal_path)
                applied = 0
                max_seq = snap_seq
                for rec in records:
                    seq = int(rec["seq"])
                    if seq <= snap_seq:
                        continue      # compaction already covers it
                    self._recs[int(rec["k"])] = _Rec(
                        rec["o"], float(rec["t"]), int(rec["v"]))
                    applied += 1
                    max_seq = max(max_seq, seq)
                self._seq = max_seq
            finally:
                self._replaying = False
        if torn:
            warnings.warn(
                f"CAS WAL {self.wal_path}: skipped {torn} torn final "
                "record (hard-kill crash artifact); every acknowledged "
                "earlier record was replayed", stacklevel=2)
            self._drop_torn_tail(records)
        self._emit("WAL_REPLAY", path=self.wal_path,
                   snapshot_seq=snap_seq, applied=applied,
                   torn_skipped=torn, seq=self._seq,
                   keys=len(self._recs))

    def _drop_torn_tail(self, records: list) -> None:
        """Rewrite the WAL as its valid records, byte for byte as they
        were appended, without the torn final line, so the next append
        starts a line of its own.  A disk fault here degrades as a failed
        append does: the replica serves, and the torn line stays until
        the next compaction empties the WAL."""
        from ..utils.checkpoint import atomic_write_text

        text = "".join(json.dumps(dict(rec, ck=_checksum(rec))) + "\n"
                       for rec in records)
        try:
            with self._scope():
                atomic_write_text(self.wal_path, text, durable=True)
        except OSError as e:
            self.wal_faults += 1
            warnings.warn(f"CAS WAL torn-tail repair degraded ({e})",
                          stacklevel=3)

    # -- the write path -----------------------------------------------------

    def _mutated(self, key: int) -> None:
        """Every base-class mutation lands here (lock held, post-state
        committed in memory): append the key's new record to the WAL,
        then maybe compact.  A disk fault degrades loudly — the op
        still serves; the quorum's other logs carry the durability."""
        if self._replaying:
            return
        rec = self._recs[int(key)]
        self._seq += 1
        payload = {"seq": self._seq, "k": int(key), "o": rec.owner,
                   "t": rec.stamp, "v": rec.version}
        payload["ck"] = _checksum(payload)
        try:
            with self._scope():
                append_jsonl(self.wal_path, [json.dumps(payload)],
                             durable=True)
        except OSError as e:
            self.wal_faults += 1
            warnings.warn(
                f"CAS WAL append degraded ({e}); serving from memory — "
                "this replica's durability is reduced until the disk "
                "recovers", stacklevel=3)
            return
        self._since_snapshot += 1
        if self._since_snapshot >= self.snapshot_every:
            self._compact()

    def _compact(self) -> None:
        """Snapshot + WAL truncation (lock held) — the
        ``SNAPSHOT_COMPACT`` seam, covered by ``check_obs_events``.
        Crash-consistent at every step: the snapshot write is atomic
        and durable, and until the WAL is emptied its stale prefix is
        filtered by ``seq`` on replay."""
        snap = {"seq": self._seq,
                "recs": [[int(k), r.owner, r.stamp, r.version]
                         for k, r in sorted(self._recs.items())]}
        snap["ck"] = _checksum({"seq": snap["seq"], "recs": snap["recs"]})
        try:
            with self._scope():
                atomic_write_json(self.snapshot_path, snap, durable=True)
                from ..utils.checkpoint import atomic_write_text

                atomic_write_text(self.wal_path, "", durable=True)
        except OSError as e:
            self.wal_faults += 1
            self._since_snapshot = 0     # retry after another window
            warnings.warn(
                f"CAS snapshot compaction degraded ({e}); the WAL keeps "
                "growing and compaction retries after "
                f"{self.snapshot_every} more mutations", stacklevel=4)
            return
        self._since_snapshot = 0
        self._emit("SNAPSHOT_COMPACT", path=self.snapshot_path,
                   seq=self._seq, keys=len(self._recs))

    def compact(self) -> None:
        """Force one compaction now (drill/test hook)."""
        with self._lock:
            self._compact()
