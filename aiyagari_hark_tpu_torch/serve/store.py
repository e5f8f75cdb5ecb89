"""Content-addressed equilibrium solution store: LRU memory + disk tier
(port of ``aiyagari_hark_tpu/serve/store.py``, host code, copied; the
same file layout, so either package reads the other's directory).

The serving cache (DESIGN §8).  A solution is addressed by its
``utils.fingerprint.solution_fingerprint`` — the solver configuration
(kwargs + dtype) plus the calibration cell — so two queries collide iff
every input that can move a bit of the answer matches.  Entries within one
*solver group* (``work_fingerprint``: same kwargs + dtype, any cell) also
serve as **warm-start donors**: ``nominate`` picks the nearest solved
neighbor in normalized (σ, ρ, sd) space and proposes a (target, margin)
pair for the service's dyadic bracket descent — the same donor rule the
sweep scheduler applies across buckets (``parallel.sweep._neighbor_seed``),
pointed at the store instead of the in-flight batch.

Tiers:

* **memory** — a bounded LRU of full entries (the hot set; an exact hit
  is a dict lookup, no device, no disk).
* **disk** (optional) — one tiny npz per entry under ``disk_path``,
  written with ``utils.checkpoint.save_pytree`` (tmp + ``os.replace``;
  the atomic-write lint covers this package).  Evicted memory entries
  stay on disk; a process restart reloads the index and serves stored
  calibrations without re-solving.

Failed solutions (``solver_health.is_failure``) are never stored — a
quarantine-grade status must not become a cache hit, and a NaN root must
never be nominated as a donor (the sidecar's NaN-row rule).

Integrity (DESIGN §9): every
entry carries a solve-time ``packed_row_checksum`` verified at every
TIER BOUNDARY — on disk load, and ONCE per in-memory residency (the
first ``get`` after an insert).  Re-hashing on every memory hit (the
original rule) re-verified bytes that had not crossed any boundary since
the last verification and put a ~µs hash on the hot path's critical
microseconds; the memoized rule keeps the corrupt-eviction semantics at
every boundary a bit can actually go wrong across (disk write/read,
promotion, restart) and accepts that a bit flipped INSIDE a verified
resident Python object is out of the threat model (pinned by the
mutate-after-residency test in the JAX package's ``tests/test_fleet.py``
— disk-tier
corruption is still caught and evicted).  An entry failing verification
is EVICTED: dropped from both tiers, its disk file deleted (a corrupt
file left in place would re-degrade every restart), the eviction
counted (``integrity_counts`` → ``ServeMetrics``
``store_corrupt_evictions``) and logged once with the entry key.  The
store never serves bytes it cannot verify — a miss and a re-solve is
the degrade.

Fleet tier (DESIGN §14): ``shared=True`` makes the disk tier
safe for N CONCURRENT WORKER PROCESSES over one directory.  Entry
publication was already atomic (``save_pytree`` = tmp + ``os.replace``;
readers see the old bytes or the new bytes, never a hybrid, and the
checksum chain verifies whichever they got); what sharing adds is
**exactly-once election**: a ``lease_<hex>.lease`` claim file per
solution fingerprint (``utils.checkpoint.acquire_lease``,
O_CREAT|O_EXCL — one process wins the create) so N workers racing the
same cold miss solve it once fleet-wide, the losers blocking-or-polling
on the winner's publish.  A crashed winner cannot wedge its
fingerprint: leases older than ``lease_ttl_s`` are BROKEN by any
claimant (``FLEET_LEASE_RECLAIM`` journaled) and the reclaimer solves.
``get`` under ``shared`` additionally probes the disk directory for
keys the in-memory index has never seen — a peer's publish after this
process's index load must become servable without a restart.

Coordination backend (DESIGN §14): the claim/heartbeat/
reclaim mechanics live behind the ``serve.lease.LeaseBackend`` trait —
``SharedDirBackend`` (lease files over this directory; the default,
byte-compatible with pre-trait stores) or any conformant peer (the
in-memory/loopback CAS backend models object-store conditional-put).
Backend substrate faults degrade typed (``LEASE_BACKEND_FAULT``
journaled, the operation fails SAFE); the backend decides who solves,
never what a solve produces — entry bytes and fingerprints are backend-
independent."""

from __future__ import annotations

import glob
import os
import threading
import warnings
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np

from ..obs.runtime import NULL_OBS, active_obs
from ..solver_health import is_failure
from ..utils.checkpoint import (
    CORRUPT_NPZ_ERRORS,
    LEASE_SUFFIX,
    load_pytree,
    save_pytree,
)
from ..utils.fingerprint import fingerprint_hex, packed_row_checksum
from .cellindex import CellIndex
from .lease import LeaseBackend, SharedDirBackend

# verify.certificate.UNCERTIFIED, inlined to keep this module's imports
# host-cheap (the certificate module is imported lazily by the service);
# the equality is pinned by tests/test_verify.py.
UNCERTIFIED = -1


class StoredSolution(NamedTuple):
    """One cached equilibrium, npz-able as a pytree (disk tier).

    ``packed`` is the batched solver's device row in its SCENARIO's
    ``RowSchema`` layout (widths differ per family), in float64
    — float64 round-trips npz bit-exactly and holds every narrower
    compute dtype exactly, so a reload serves the original bits.
    ``schema_ck`` is the producing scenario's ``RowSchema.checksum()``;
    ``status``/``root`` lift the schema's status code and warm-start
    target out of the row so the store never hard-codes a column index.
    A pre-scenario disk entry fails the template load and degrades like
    any corrupt entry; a same-key entry with a STALE schema checksum is
    evicted at read time.

    ``checksum`` is the solve-time ``packed_row_checksum`` of ``packed``
    (verified at every boundary, DESIGN §9); ``cert_level`` the
    ``verify`` certificate verdict for this solution (``UNCERTIFIED``
    when the service ran without ``certify_before_cache``)."""

    cell: np.ndarray    # [3] cell coordinates, float64
    packed: np.ndarray  # [W] float64 — scenario row layout
    group: np.ndarray   # scalar int64 — work_fingerprint (solver config)
    key: np.ndarray     # scalar int64 — solution_fingerprint (full address)
    checksum: np.ndarray    # scalar int64 — solve-time row checksum
    cert_level: np.ndarray  # scalar int64 — verify certificate level
    schema_ck: np.ndarray   # scalar int64 — RowSchema.checksum()
    status: np.ndarray      # scalar int64 — solver_health code
    root: np.ndarray        # scalar float64 — donor/warm-start target


def _template() -> StoredSolution:
    # leaf SHAPES come from the file (load_pytree), so one template loads
    # every scenario's row width; structure (leaf count) is what gates
    return StoredSolution(cell=np.zeros(3),
                          packed=np.zeros(1),
                          group=np.zeros((), np.int64),
                          key=np.zeros((), np.int64),
                          checksum=np.zeros((), np.int64),
                          cert_level=np.zeros((), np.int64),
                          schema_ck=np.zeros((), np.int64),
                          status=np.zeros((), np.int64),
                          root=np.zeros(()))


def make_solution(cell, packed, group: int, key: int,
                  cert_level: int = UNCERTIFIED,
                  schema=None) -> StoredSolution:
    """Build one entry from a packed row.  ``schema`` is the producing
    scenario's ``RowSchema`` (None = the Aiyagari layout): it names the
    status and root columns and stamps ``schema_ck`` so stale layouts
    drop instead of misparsing."""
    if schema is None:
        from ..scenarios.aiyagari import AIYAGARI_SCHEMA as schema
    packed = np.asarray(packed, dtype=np.float64)
    return StoredSolution(
        cell=np.asarray(cell, dtype=np.float64),
        packed=packed,
        group=np.asarray(group, np.int64),
        key=np.asarray(key, np.int64),
        checksum=np.asarray(packed_row_checksum(packed), np.int64),
        cert_level=np.asarray(int(cert_level), np.int64),
        schema_ck=np.asarray(schema.checksum(), np.int64),
        status=np.asarray(
            int(np.rint(packed[schema.idx(schema.status)])), np.int64),
        root=np.asarray(float(packed[schema.idx(schema.root)]),
                        np.float64))


class Donation(NamedTuple):
    """A nominated warm-start seed: descend toward ``target`` keeping a
    ``margin`` safety ball (the ``dyadic_bracket`` inputs)."""

    target: float
    margin: float
    donor_key: int


class _Meta(NamedTuple):
    """Host-side index row kept for every known entry (memory or disk):
    what donor nomination (and degraded-answer selection)
    needs without touching the entry itself."""

    cell: tuple
    group: int
    r_star: float            # the schema root value (donor target)
    on_disk: bool
    cert_level: int = UNCERTIFIED
    schema_ck: int = 0       # producing scenario's RowSchema.checksum()


class SolutionStore:
    """Bounded LRU of ``StoredSolution`` with an optional disk tier.

    Thread-safe (one lock; every operation is O(small)).  ``capacity``
    bounds the in-memory entries only; with a disk tier, evicted entries
    remain addressable (a ``get`` promotes them back), and the index of
    disk entries — a few dozen bytes each — is kept in memory for donor
    nomination."""

    def __init__(self, capacity: int = 256,
                 disk_path: Optional[str] = None,
                 donor_cutoff: float = float("inf"), obs=None,
                 shared: bool = False, lease_ttl_s: float = 30.0,
                 owner: str = "",
                 lease_backend: Optional[LeaseBackend] = None,
                 index: str = "grid"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if index not in ("grid", "linear"):
            raise ValueError(
                f"index must be 'grid' or 'linear', got {index!r}")
        if shared and disk_path is None:
            raise ValueError(
                "SolutionStore(shared=True) requires a disk_path: the "
                "shared tier IS the disk directory")
        self.capacity = int(capacity)
        self.disk_path = disk_path
        # fleet tier: shared enables the claim/lease protocol
        # and the unknown-key disk probe; lease_ttl_s is the stale-lease
        # reclaim horizon; owner is a diagnostic worker id stamped into
        # lease payloads (election correctness never reads it).
        # lease_backend is the pluggable coordination
        # authority behind the protocol — default the shared-dir
        # backend over the store directory (the pre-trait behavior,
        # byte-compatible); backend choice never enters solution
        # fingerprints or served bytes.
        self.shared = bool(shared)
        self.lease_ttl_s = float(lease_ttl_s)
        self.owner = str(owner)
        if lease_backend is not None and not shared:
            raise ValueError(
                "lease_backend requires SolutionStore(shared=True): "
                "the claim protocol only exists on the shared tier")
        if isinstance(lease_backend, str):
            # accept the worker-flag spec spelling ("dir"/"cas:host:port"/
            # "memory") directly — a raw string would otherwise fail only
            # at the FIRST claim, deep inside _backend_call
            from .lease import make_backend
            lease_backend = make_backend(lease_backend, root=disk_path)
        self.lease_backend: Optional[LeaseBackend] = (
            (lease_backend if lease_backend is not None
             else SharedDirBackend(disk_path)) if shared else None)
        self._held: set = set()          # keys whose lease WE hold
        self._published_keys: list = []  # keys this store published
        self._fleet = {"fleet_claims_won": 0, "fleet_claims_lost": 0,
                       "fleet_publishes": 0, "fleet_lease_reclaims": 0,
                       "fleet_backend_faults": 0,
                       "fleet_store_degraded": 0}
        # lease HEARTBEAT: a lease's liveness stamp is
        # refreshed every ttl/4 while its owner lives, so staleness
        # means "the owner stopped beating" (crashed/killed), never
        # "the solve is slower than the TTL" — without it, a first cold
        # solve's compile wall outlives a short TTL and a LIVE winner
        # gets its claim stolen (a measured double-solve, dedup ratio
        # 1.5, in the JAX package's drill trials).  The daemon runs only
        # while leases are held, and stops DETERMINISTICALLY on the last
        # release, on ``close``, and on
        # ``__del__`` — ``_hb_wake`` is the wake-now event those paths
        # set so no thread outlives the store.
        self._hb_thread = None
        self._hb_wake = threading.Event()
        self._hb_beats = 0       # completed refresh rounds
        self._hb_lost = 0        # held leases found released/stolen
        self._closed = False
        # chaos seams: an armable ``serve.chaos.ChaosAgent``
        # consulted at publish / heartbeat / disk-read / staleness
        # seams; None (the default) costs one attribute check
        self._chaos = None
        # normalized-distance radius beyond which nominate() declines: a
        # donor across the whole lattice proposes a junk target (safe —
        # in-program verification falls back to cold — but an honest
        # "cold" classification beats a doomed descent).  inf = always
        # nominate, the sweep scheduler's behavior.
        self.donor_cutoff = float(donor_cutoff)
        self._lock = threading.RLock()
        self._mem: OrderedDict = OrderedDict()   # key -> StoredSolution
        self._meta: dict = {}                    # key -> _Meta
        # neighbor-lookup acceleration: the grid-bucket
        # CellIndex is the default; "linear" keeps the scan as the
        # pinned fallback.  Both tie-break by _meta insertion order, so
        # every mutation of _meta MUST go through _meta_set/_meta_del —
        # the index mirror and the per-group matrix cache stay exact.
        self._index: Optional[CellIndex] = (
            CellIndex(on_rebuild=self._index_rebuilt)
            if index == "grid" else None)
        self.index_kind = index
        self._group_cache: dict = {}    # group -> (rows, cell matrix)
        # keys whose CURRENT in-memory residency has been checksum-
        # verified: membership is dropped whenever
        # the memory copy changes hands (insert, promote, evict), so
        # every residency is verified exactly once — on its first get
        self._verified_mem: set = set()
        self._corrupt_evictions = 0
        # Eviction "log once" state is PER STORE INSTANCE: the old
        # pattern leaned on the warnings module's
        # per-process dedup registry, so a second store over the same
        # corrupt path — a restarted service in one process — degraded
        # SILENTLY.  The machine-readable trail (journal event + counter
        # + ``integrity_counts``) fires on EVERY eviction regardless.
        self._evict_warned: set = set()
        # the obs bundle must be adopted BEFORE the disk index loads:
        # restart-time evictions are exactly the ones worth journaling
        self._obs = obs if obs is not None else NULL_OBS
        # the replicated backend journals its own seams (QUORUM_LOST,
        # REPLICA_RESYNC); adopt it into this store's scope
        if (self.lease_backend is not None and self._obs is not NULL_OBS
                and hasattr(self.lease_backend, "attach_obs")):
            self.lease_backend.attach_obs(self._obs)
        if disk_path is not None:
            os.makedirs(disk_path, exist_ok=True)
            self._load_disk_index()

    # -- tiers --------------------------------------------------------------

    def _file(self, key: int) -> str:
        # keys are signed int64; the shared hex spelling
        # (``fingerprint_hex``) keeps entry and lease filenames agreeing
        return os.path.join(self.disk_path,
                            f"sol_{fingerprint_hex(key)}.npz")

    def _lease_file(self, key: int) -> str:
        return os.path.join(self.disk_path,
                            f"lease_{fingerprint_hex(key)}{LEASE_SUFFIX}")

    def attach_obs(self, obs) -> None:
        """Adopt a service's observability bundle so eviction
        events/counters land in ITS journal/registry.  First caller
        wins — a store shared by two services keeps one run's scope —
        and the active-scope fallback still covers a bare store used
        inside someone else's run."""
        if self._obs is NULL_OBS and obs is not None:
            self._obs = obs
            if (self.lease_backend is not None
                    and hasattr(self.lease_backend, "attach_obs")):
                self.lease_backend.attach_obs(obs)

    def _obs_scope(self):
        return self._obs if self._obs is not NULL_OBS else active_obs()

    # -- metadata index maintenance ------------------------------

    def _meta_set(self, key: int, meta: _Meta) -> None:
        """The ONLY writer of ``_meta`` rows (lock held): mirrors every
        insert/refresh into the CellIndex and invalidates the group's
        cached cell matrix, so the neighbor seam can never observe a
        stale view."""
        key = int(key)
        prior = self._meta.get(key)
        if prior is not None and prior.group != meta.group:
            # defensive: a key's group is fingerprint-derived and never
            # changes in practice, but a mismatch must not strand the
            # old group's mirror entry
            self._group_cache.pop(prior.group, None)
            if self._index is not None:
                self._index.remove(key, prior.group)
        self._meta[key] = meta
        self._group_cache.pop(meta.group, None)
        if self._index is not None:
            self._index.add(key, meta.cell, meta.group, meta.r_star,
                            meta.cert_level)

    def _meta_del(self, key: int) -> Optional[_Meta]:
        """The ONLY remover of ``_meta`` rows (lock held)."""
        meta = self._meta.pop(int(key), None)
        if meta is not None:
            self._group_cache.pop(meta.group, None)
            if self._index is not None:
                self._index.remove(int(key), meta.group)
        return meta

    def _index_rebuilt(self, group, entries, reason: str) -> None:
        """The index-rebuild seam (covered by
        ``check_obs_events``): every CellIndex (re)build — restart
        reload, scenario scale change, growth re-width — leaves a
        journal trail with its size and cause."""
        self._obs_scope().event(
            "INDEX_REBUILD", group=None if group is None else int(group),
            entries=int(entries), reason=str(reason))

    def _record_eviction(self, reason: str, tier: str, path: str,
                         key=None, message=None,
                         stacklevel: int = 4) -> None:
        """The machine-readable eviction trail (lock
        held): journal event + registry counter on EVERY eviction, a
        human warning once per (tier, key) per store instance.
        ``stacklevel`` counts frames from the warn to the store's
        caller: 4 via ``_evict_corrupt``, 3 for direct callers."""
        self._corrupt_evictions += 1
        obs = self._obs_scope()
        obs.event("STORE_EVICT_CORRUPT", tier=tier, reason=reason,
                  key=None if key is None else int(key),
                  file=os.path.basename(path) if path else None)
        obs.counter("aiyagari_store_corrupt_evictions_total",
                    "store entries evicted on failed verification").inc()
        token = (tier, os.path.basename(path) if key is None
                 else int(key))
        if token in self._evict_warned:
            return
        self._evict_warned.add(token)
        if message is None:
            message = (
                "solution store: evicting corrupt entry "
                + (f"{int(key)} " if key is not None else "")
                + f"({os.path.basename(path) if path else tier}): "
                f"{reason}; the entry is deleted and the query will "
                "re-solve")
        warnings.warn(message, stacklevel=stacklevel)

    def _evict_corrupt(self, path: str, reason: str, key=None) -> None:
        """One shared corrupt-entry eviction (DESIGN §9; lock held):
        journal + count + log (``_record_eviction``), forget the entry
        in both tiers, and DELETE the disk file — a corrupt file left
        behind would re-degrade on every restart, and must never be
        servable."""
        if key is not None:
            self._mem.pop(int(key), None)
            self._meta_del(int(key))
            self._verified_mem.discard(int(key))
        self._record_eviction(reason, "disk", path, key=key)
        try:
            os.remove(path)
        except OSError:
            pass

    def _verified(self, sol: StoredSolution) -> bool:
        """Content-checksum verification of one entry's packed row
        against its solve-time checksum (# integrity-ok: this IS the
        verification site)."""
        return packed_row_checksum(sol.packed) == int(sol.checksum)

    def _load_disk_index(self) -> None:
        """Rebuild the index from the disk tier (process restart).  A
        corrupt entry file is EVICTED — logged with its key, counted,
        deleted — and the store degrades to re-solving: it must never
        refuse to start, and never serve (or keep) bytes it cannot
        verify."""
        for path in sorted(glob.glob(os.path.join(self.disk_path,
                                                  "sol_*.npz"))):
            try:
                sol = load_pytree(path, _template())
            except CORRUPT_NPZ_ERRORS as e:
                # includes pre-scenario entry formats (leaf-count
                # mismatch): stale layouts drop, never misparse
                self._evict_corrupt(path, f"unreadable ({e})")
                continue
            if not self._verified(sol):
                self._evict_corrupt(path, "checksum mismatch",
                                    key=sol.key)
                continue
            self._meta_set(int(sol.key), _Meta(
                cell=tuple(np.asarray(sol.cell, dtype=np.float64)),
                group=int(sol.group),
                r_star=float(sol.root), on_disk=True,
                cert_level=int(sol.cert_level),
                schema_ck=int(sol.schema_ck)))
        if self._index is not None and self._meta:
            # restart rebuild of the neighbor index from the metadata
            # tier — journaled through the rebuild seam
            self._index_rebuilt(None, len(self._meta), "restart")

    # -- core ops -----------------------------------------------------------

    def get(self, key: int,
            schema_ck: Optional[int] = None) -> Optional[StoredSolution]:
        """Exact lookup; promotes to most-recently-used.  A disk-resident
        entry is loaded and promoted into memory (evicting LRU).  Every
        TIER BOUNDARY re-verifies the entry's content checksum — disk
        load, and once per in-memory residency on its first get (the
        memoized rule; module docstring for the threat model) — and a failed verification evicts the entry (both
        tiers + disk file) and reports a miss, so the caller re-solves
        instead of serving corruption.  Under ``shared`` a key unknown
        to the index additionally probes the disk directory: a peer
        worker's publish becomes servable without a restart.

        ``schema_ck``: the querying scenario's
        ``RowSchema.checksum()``.  An entry stored under a DIFFERENT row
        layout is evicted as stale (a widened schema must drop old
        entries, never misparse their columns); None skips the check."""
        key = int(key)
        with self._lock:
            sol = self._mem.get(key)
            if (sol is not None and schema_ck is not None
                    and int(sol.schema_ck) != int(schema_ck)):
                self._mem.pop(key, None)
                self._meta_del(key)
                self._verified_mem.discard(key)
                self._record_eviction("stale row schema", "memory", "",
                                      key=key, stacklevel=3)
                if self.disk_path is not None:
                    try:
                        os.remove(self._file(key))
                    except OSError:
                        pass
                return None
            if sol is not None:
                if (key not in self._verified_mem
                        and not self._verified(sol)):
                    # in-RAM corruption caught at the residency's first
                    # verification: drop ONLY the memory copy — the
                    # disk entry is a separate byte store written
                    # atomically with its own verification on load, very
                    # plausibly still healthy; destroying it would turn
                    # one transient memory flip into a permanent cache
                    # loss.  Fall through to the disk path below, which
                    # re-verifies (and evicts the file iff IT is bad).
                    del self._mem[key]
                    meta = self._meta.get(key)
                    on_disk = meta is not None and meta.on_disk
                    self._record_eviction(
                        "checksum mismatch", "memory", "", key=key,
                        message=(
                            f"solution store: entry {key} failed "
                            "checksum verification in the memory tier; "
                            "dropping the in-memory copy"
                            + (" and retrying the disk tier" if on_disk
                               else "")),
                        stacklevel=3)
                    if not on_disk:
                        self._meta_del(key)
                        return None
                else:
                    self._verified_mem.add(key)
                    self._mem.move_to_end(key)
                    return sol
            meta = self._meta.get(key)
            if meta is None or not meta.on_disk:
                # shared tier: the index was built at startup
                # (plus our own puts) — a PEER process may have
                # published this key since.  One existence probe per
                # miss keeps cross-process publication visible; the
                # load below verifies the bytes like any disk read.
                if not (self.shared and meta is None
                        and os.path.exists(self._file(key))):
                    return None
            path = self._file(key)
            if self._chaos is not None and self._chaos.read_fault(key):
                # injected store partition: a TRANSIENT read
                # failure degrades to a miss WITHOUT evicting — the
                # bytes on disk are healthy, and deleting them would
                # turn a partition window into a permanent cache loss
                self._backend_fault(
                    "disk_read", "injected partition read fault",
                    key=key)
                return None
            try:
                sol = load_pytree(path, _template())
            except CORRUPT_NPZ_ERRORS as e:
                self._evict_corrupt(path, f"unreadable ({e})", key=key)
                return None
            if (schema_ck is not None
                    and int(sol.schema_ck) != int(schema_ck)):
                self._evict_corrupt(path, "stale row schema", key=key)
                return None
            if not self._verified(sol):
                self._evict_corrupt(path, "checksum mismatch", key=key)
                return None
            # a verified disk load begins a verified residency; a
            # probe-discovered peer publish also earns an index row so
            # donor nomination sees it from now on
            self._meta_set(key, _Meta(
                cell=tuple(np.asarray(sol.cell, dtype=np.float64)),
                group=int(sol.group),
                r_star=float(sol.root), on_disk=True,
                cert_level=int(sol.cert_level),
                schema_ck=int(sol.schema_ck)))
            self._insert(key, sol)
            self._verified_mem.add(key)
            return sol

    def put(self, sol: StoredSolution) -> None:
        """Insert (or refresh) one solution.  Failed statuses are refused
        loudly — caching an uncertified result is a caller bug."""
        status = int(sol.status)
        if is_failure(status):
            raise ValueError(
                f"refusing to store a failed solution (status={status}); "
                "failures raise on their future, they are never cached")
        key = int(sol.key)
        with self._lock:
            on_disk = False
            if self.disk_path is not None:
                try:
                    save_pytree(self._file(key), sol)
                    on_disk = True
                except OSError as e:
                    self._degrade_memory_only(key, e)
            prior = self._meta.get(key)
            if prior is not None and prior.on_disk:
                on_disk = True
            self._meta_set(key, _Meta(
                cell=tuple(np.asarray(sol.cell, dtype=np.float64)),
                group=int(sol.group),
                r_star=float(sol.root), on_disk=on_disk,
                cert_level=int(sol.cert_level),
                schema_ck=int(sol.schema_ck)))
            self._insert(key, sol)

    def _degrade_memory_only(self, key: int, error) -> None:
        """The failed-disk-publish seam (covered by
        ``check_obs_events``; ``_lock`` held): a full/failing disk
        (ENOSPC/EIO — real or injected via ``utils.checkpoint
        .arm_disk_fault``) must degrade the store to MEMORY-ONLY for
        this entry — journaled ``STORE_DEGRADED``, counted, warned —
        never crash the solve or tear the disk tier.  This process
        keeps serving the solution from memory; peers re-solve (the
        atomic writer guarantees they never read a torn file)."""
        self._fleet["fleet_store_degraded"] += 1
        self._obs_scope().event(
            "STORE_DEGRADED", key=int(key), tier="disk",
            error=f"{type(error).__name__}: {error}")
        warnings.warn(
            f"solution store: could not persist entry {int(key)} "
            f"({error}); serving it memory-only — peers will re-solve "
            "until the disk recovers", stacklevel=3)

    # -- fleet claim / publish (DESIGN §14) -----------------------

    def _require_shared(self, what: str) -> None:
        if not self.shared:
            raise ValueError(
                f"{what} requires SolutionStore(shared=True): the "
                "claim/lease protocol only exists on the shared tier")

    def _backend_call(self, op: str, default, *args, **kw):
        """One lease-backend operation with the typed degrade: a
        substrate fault (socket drop, I/O error) journals
        ``LEASE_BACKEND_FAULT`` and returns ``default`` — chosen per
        call site so a transient fault fails SAFE (an acquire fault
        reads as "lost", a heartbeat fault keeps the claim, a reclaim
        fault reclaims nothing)."""
        try:
            return getattr(self.lease_backend, op)(*args, **kw)
        except (OSError, ConnectionError) as e:
            self._backend_fault(op, e)
            return default

    def _backend_fault(self, op: str, detail, key=None) -> None:
        """The lease-backend fault seam (covered by
        ``check_obs_events``): journal + count every degraded backend
        operation — partitions and lost leases must leave the same
        machine-readable trail as every other typed failure."""
        with self._lock:
            self._fleet["fleet_backend_faults"] += 1
        if isinstance(detail, BaseException):
            detail = f"{type(detail).__name__}: {detail}"
        self._obs_scope().event(
            "LEASE_BACKEND_FAULT", op=str(op), owner=self.owner,
            key=None if key is None else int(key), detail=str(detail))

    def _chaos_now(self):
        """The staleness clock's ``now`` override: None normally; a
        chaos-armed skew returns a shifted wall (the duplicated-
        election drill's injected fault)."""
        return None if self._chaos is None else self._chaos.skew_now()

    def set_chaos(self, agent) -> None:
        """Attach a ``serve.chaos.ChaosAgent`` (fault-injection drills;
        ``--chaos`` workers only).  None detaches."""
        self._chaos = agent

    def claim(self, key: int) -> str:
        """Elect a solver for ``key`` fleet-wide.  Returns:

        * ``"published"`` — the entry already exists on disk (serve it;
          no solve needed);
        * ``"won"`` — THIS store now holds the key's lease: the caller
          must solve and then ``publish`` (success) or ``release``
          (failure/abandon), or let the TTL reclaim it (crash);
        * ``"lost"`` — a live peer holds the lease: block-or-poll for
          its publish (``get`` probes the disk) or for the lease to go
          stale.

        A lease older than ``lease_ttl_s`` is broken here (journaled
        ``FLEET_LEASE_RECLAIM``) and the claim re-runs — a crashed
        winner never wedges its fingerprint."""
        self._require_shared("claim")
        key = int(key)
        for _ in range(2):      # once, plus once after a stale break
            if os.path.exists(self._file(key)):
                return "published"
            if self._backend_call("try_acquire", False, key, self.owner):
                with self._lock:
                    self._held.add(key)
                    self._fleet["fleet_claims_won"] += 1
                    self._ensure_heartbeat_locked()
                self._obs_scope().event("FLEET_CLAIM", key=key,
                                        owner=self.owner)
                # the entry may have been published between the
                # existence probe and the create: the winner must not
                # re-solve what the fleet already has
                if os.path.exists(self._file(key)):
                    self.release(key)
                    return "published"
                return "won"
            if self._backend_call("break_stale", False, key,
                                  self.lease_ttl_s, now=self._chaos_now()):
                with self._lock:
                    self._fleet["fleet_lease_reclaims"] += 1
                self._obs_scope().event("FLEET_LEASE_RECLAIM", key=key,
                                        owner=self.owner)
                continue
            break
        with self._lock:
            self._fleet["fleet_claims_lost"] += 1
        return "lost"

    def publish(self, sol: StoredSolution, speculative: bool = False,
                seed=None) -> None:
        """Winner's completion: ``put`` (atomic disk write included) then
        release the key's lease, journaled ``FLEET_PUBLISH``.
        ``speculative`` tags a prefetch-driven solve (the fleet load
        harness attributes prefetch conversions from this attr);
        ``seed`` is the solving lane's exact bracket seed ``(lo, hi,
        levels)`` — journaled bit-exactly so the fleet bit-identity
        acceptance can replay ANY published solve through a same-seed
        ``reference_solve``, including solves whose response no client
        ever saw (prefetch, a drilled worker's in-flight reply)."""
        self._require_shared("publish")
        key = int(sol.key)
        if self._chaos is not None:
            # chaos seam: an armed publish delay holds the lease
            # mid-"solve" — the kill/stall drills' deterministic window
            delay = self._chaos.publish_delay_s(sol.cell)
            if delay > 0.0:
                import time

                time.sleep(delay)
        self.put(sol)
        with self._lock:
            self._fleet["fleet_publishes"] += 1
            self._published_keys.append(key)
        self._obs_scope().event(
            "FLEET_PUBLISH", key=key, owner=self.owner,
            speculative=bool(speculative),
            seed=(None if seed is None else
                  [float(seed[0]), float(seed[1]), int(seed[2])]))
        self.release(key)

    def release(self, key: int) -> None:
        """Give up a held lease WITHOUT publishing (failed solve, cert
        failure, abandoned batch): the fingerprint becomes claimable
        again immediately.  Idempotent; a no-op for leases this store
        never held.  OWNER-CHECKED at the backend: a release
        landing after a TTL reclaim + peer re-acquire must not delete
        the peer's fresh lease.  The LAST release wakes the heartbeat
        daemon so it exits deterministically instead of on its next
        tick."""
        key = int(key)
        with self._lock:
            held = key in self._held
            self._held.discard(key)
            if held and not self._held:
                self._hb_wake.set()
        if held:
            self._backend_call("release", False, key, owner=self.owner)

    def _ensure_heartbeat_locked(self) -> None:
        """Start the lease-heartbeat daemon if it is not running
        (``_lock`` held).  It exits on its own once nothing is held (or
        the store closed), so a store that stops claiming stops
        threading."""
        if self._closed:
            return
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return
        self._hb_wake.clear()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="lease-heartbeat",
            daemon=True)
        self._hb_thread.start()

    def _heartbeat_loop(self) -> None:
        interval = max(0.05, self.lease_ttl_s / 4.0)
        while True:
            self._hb_wake.wait(interval)
            with self._lock:
                self._hb_wake.clear()
                if self._closed or not self._held:
                    self._hb_thread = None
                    return
                held = list(self._held)
            chaos = self._chaos
            if chaos is not None and chaos.heartbeat_stalled():
                continue     # the zombie-winner drill: alive, not beating
            lost = []
            for key in held:
                # default True: a TRANSIENT backend fault must not drop
                # the claim (the fault itself is journaled); only a
                # definitive "you no longer hold this" does
                if not self._backend_call("heartbeat", True, key,
                                          self.owner):
                    lost.append(key)
            with self._lock:
                self._hb_beats += 1
                for key in lost:
                    self._held.discard(key)
                    self._hb_lost += 1
            for key in lost:
                self._backend_fault(
                    "heartbeat",
                    "held lease no longer ours (released, TTL-reclaimed,"
                    " or re-acquired by a peer) — claim dropped",
                    key=key)

    def close(self, release_leases: bool = False,
              timeout_s: float = 5.0) -> None:
        """Deterministically stop the heartbeat daemon: after ``close`` returns no store thread is running.
        Held leases are left for TTL reclaim by default — the crashed-
        winner protocol, and the right semantics for a dying worker —
        or released first with ``release_leases=True`` (an orderly
        shutdown that will not publish).  Idempotent; entries and the
        disk tier are untouched.

        The release pass is BOUNDED by ``timeout_s``: against an unreachable/partitioned backend each
        release already degrades typed (``_backend_call``), but N keys
        x a dial timeout could wedge a dying worker for minutes — once
        the budget is spent the remaining leases are LEFT FOR TTL
        RECLAIM with one more typed journal line, and ``close`` keeps
        its promise to return."""
        if release_leases:
            import time as _time

            deadline = _time.monotonic() + max(0.0, float(timeout_s))
            held = self.held_leases()
            for idx, key in enumerate(held):
                if _time.monotonic() >= deadline:
                    self._backend_fault(
                        "close_release",
                        f"close(release_leases=True) exceeded its "
                        f"{float(timeout_s):.1f}s budget with "
                        f"{len(held) - idx} lease(s) unreleased — "
                        "left for TTL reclaim")
                    break
                self.release(key)
        with self._lock:
            self._closed = True
            t = self._hb_thread
            self._hb_wake.set()
        if t is not None and t is not threading.current_thread():
            t.join(max(1.0, self.lease_ttl_s))
        if self.lease_backend is not None:
            try:
                self.lease_backend.close()
            except (OSError, ConnectionError) as e:
                self._backend_fault("close", e)

    def __del__(self):   # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def heartbeat_health(self) -> dict:
        """Heartbeat/lease liveness for ``/healthz`` and ``/fleet``
       : completed refresh rounds, held-lease count, leases
        found lost/stolen by the beat, backend identity, and whether
        the daemon is currently running."""
        with self._lock:
            return {
                "thread_alive": (self._hb_thread is not None
                                 and self._hb_thread.is_alive()),
                "held": len(self._held),
                "beats": self._hb_beats,
                "lost_leases": self._hb_lost,
                "backend": (None if self.lease_backend is None
                            else self.lease_backend.name),
                "closed": self._closed,
            }

    def lease_present(self, key: int) -> bool:
        self._require_shared("lease_present")
        return self._backend_call("age_s", None, int(key)) is not None

    def lease_stale(self, key: int) -> bool:
        """True iff the key's lease exists and is past the TTL."""
        self._require_shared("lease_stale")
        age = self._backend_call("age_s", None, int(key))
        return age is not None and age > self.lease_ttl_s

    def reclaim_if_stale(self, key: int) -> bool:
        """Break one stale lease (TTL reclaim outside the claim loop —
        the waiter path); True iff this call removed it."""
        self._require_shared("reclaim_if_stale")
        key = int(key)
        if self._backend_call("break_stale", False, key,
                              self.lease_ttl_s, now=self._chaos_now()):
            with self._lock:
                self._fleet["fleet_lease_reclaims"] += 1
            self._obs_scope().event("FLEET_LEASE_RECLAIM", key=key,
                                    owner=self.owner)
            return True
        return False

    def held_leases(self) -> list:
        """Keys whose lease THIS store instance currently holds."""
        with self._lock:
            return sorted(self._held)

    def lease_files(self) -> list:
        """Every live lease, all owners — the leak audit.  The
        shared-dir backend returns real file paths (the pre-trait
        spelling); other backends synthesize the same naming."""
        self._require_shared("lease_files")
        return self._backend_call("lease_names", [])

    def gc_stale_leases(self) -> int:
        """Sweep every stale lease the backend knows (end-of-run leak
        reclaim; counts + journals each).  Returns how many were
        removed."""
        self._require_shared("gc_stale_leases")
        removed = 0
        for key in self._backend_call("list_keys", []):
            if self._backend_call("break_stale", False, key,
                                  self.lease_ttl_s):
                removed += 1
                with self._lock:
                    self._fleet["fleet_lease_reclaims"] += 1
                self._obs_scope().event(
                    "FLEET_LEASE_RECLAIM", key=int(key),
                    owner=self.owner, swept=True)
        return removed

    def contains(self, key: int) -> bool:
        """Key addressable without loading it: indexed in either tier,
        or (shared) published on disk by a peer."""
        key = int(key)
        with self._lock:
            if key in self._meta:
                return True
        return self.shared and os.path.exists(self._file(key))

    def published_keys(self) -> list:
        """Keys THIS store published (fleet dedup accounting)."""
        with self._lock:
            return list(self._published_keys)

    def fleet_counts(self) -> dict:
        """Fleet protocol counters (``ServeMetrics`` merge)."""
        with self._lock:
            return dict(self._fleet)

    def _insert(self, key: int, sol: StoredSolution) -> None:
        # a (re)insert starts a FRESH residency: verification membership
        # is per-residency, so the new bytes verify on their first get
        # unless the caller (a just-verified disk load) marks them
        self._verified_mem.discard(key)
        self._mem[key] = sol
        self._mem.move_to_end(key)
        while len(self._mem) > self.capacity:
            old_key, _ = self._mem.popitem(last=False)
            self._verified_mem.discard(old_key)
            meta = self._meta.get(old_key)
            if meta is not None and not meta.on_disk:
                # memory-only tier: eviction forgets the entry entirely
                # (bounded memory is the contract); with a disk tier the
                # index row stays so the entry remains addressable
                self._meta_del(old_key)

    # -- donor nomination ---------------------------------------------------

    def _group_rows_locked(self, group: int):
        """Cached per-group donor rows for the LINEAR path (lock
        held): the finite-r* rows of ``group`` in
        metadata insertion order plus their prebuilt cell matrix —
        ``nominate``/``nearest`` previously re-materialized the matrix
        on EVERY call.  Invalidated by ``_meta_set``/``_meta_del``."""
        cached = self._group_cache.get(group)
        if cached is None:
            rows = [(k, m) for k, m in self._meta.items()
                    if m.group == group and np.isfinite(m.r_star)]
            mat = (np.asarray([m.cell for _, m in rows])
                   if rows else None)
            cached = (rows, mat)
            self._group_cache[group] = cached
        return cached

    def neighbors(self, cell, group: int, k: Optional[int],
                  require_certified: bool = False, scale=None):
        """THE neighbor-selection seam (DESIGN §15): donor
        nomination, degraded-answer selection and the surrogate tier's
        k-NN all route through here.  Returns up to ``k`` entries
        ``[(key, _Meta, distance), ...]`` ordered by (normalized-L1
        distance, metadata insertion order) — ``k=None`` ranks the whole
        group.  The grid-bucket ``CellIndex`` answers by default; the
        linear scan (over the cached per-group cell matrix) is the
        pinned fallback, and the two are property-tested bitwise
        identical, ties included."""
        from ..parallel.sweep import NEIGHBOR_CELL_SCALE, neighbor_distance

        if scale is None:
            scale = NEIGHBOR_CELL_SCALE
        group = int(group)
        with self._lock:
            if self._index is not None:
                hits = self._index.nearest_k(
                    cell, group, k, scale=scale,
                    require_certified=require_certified)
                return [(kk, self._meta[kk], dd) for kk, dd in hits]
            rows, mat = self._group_rows_locked(group)
        if require_certified and rows:
            sel = [i for i, (_, m) in enumerate(rows)
                   if m.cert_level >= 0]
            rows = [rows[i] for i in sel]
            mat = mat[sel] if sel else None
        if not rows:
            return []
        d = neighbor_distance(cell, mat, scale=scale)
        if k == 1:
            # first-minimum == stable-argsort[0]; O(n) beats the sort
            i = int(np.argmin(d))
            return [(int(rows[i][0]), rows[i][1], float(d[i]))]
        order = np.argsort(d, kind="stable")
        if k is not None:
            order = order[:k]
        return [(int(rows[int(i)][0]), rows[int(i)][1], float(d[int(i)]))
                for i in order]

    def nominate(self, cell, group: int, width: float,
                 r_tol: float, scale=None) -> Optional[Donation]:
        """Warm-start donor for ``cell`` within solver group ``group``:
        target = nearest stored root in normalized (σ, ρ, sd) space,
        margin = the r*-spread between the two nearest donors (how far the
        root plausibly moved), floored defensively — LITERALLY the sweep
        scheduler's neighbor rule (``parallel.sweep.neighbor_distance`` /
        ``donor_margin``, one shared implementation) pointed at the store.
        ``width`` is the economic bracket width and ``r_tol`` the
        bisection tolerance of the *querying* configuration; ``scale``
        the querying scenario's ``CellSpace.scale`` (None = the Aiyagari
        lattice normalization).  None when the group holds no donors (or
        none inside ``donor_cutoff``)."""
        from ..parallel.sweep import donor_margin

        near = self.neighbors(cell, group, k=2, scale=scale)
        if not near:
            return None
        k0, m0, d0 = near[0]
        if d0 > self.donor_cutoff:
            return None
        target = float(m0.r_star)
        spread = (abs(target - float(near[1][1].r_star))
                  if len(near) > 1 else None)
        return Donation(target=target,
                        margin=donor_margin(spread, width, r_tol),
                        donor_key=int(k0))

    def nearest(self, cell, group: int,
                require_certified: bool = False, scale=None):
        """Nearest stored neighbor of ``cell`` within solver group
        ``group`` in normalized (σ, ρ, sd) space — the degraded-answer
        donor (DESIGN §11).  Returns ``(key, distance)`` or
        None.

        Unlike ``nominate`` this proposes no bracket: the caller serves
        the donor's OWN row, tagged degraded, so the donor must be a
        real addressable entry — fetch it with ``get(key)``, which
        re-verifies the content checksum (a corrupt donor degrades to a
        miss, never to a served wrong answer).  With
        ``require_certified`` only donors carrying a CERTIFIED/MARGINAL
        ``verify`` certificate qualify (an UNCERTIFIED entry from a
        service running without ``certify_before_cache`` is skipped)."""
        near = self.neighbors(cell, group, k=1,
                              require_certified=require_certified,
                              scale=scale)
        if not near:
            return None
        return int(near[0][0]), float(near[0][2])

    # -- introspection ------------------------------------------------------

    def __len__(self) -> int:
        """In-memory (LRU-bounded) entry count."""
        with self._lock:
            return len(self._mem)

    def known(self) -> int:
        """Addressable entries across both tiers."""
        with self._lock:
            return len(self._meta)

    def mem_keys(self) -> list:
        """Memory-tier keys in LRU order (oldest first) — test hook for
        the eviction-order contract."""
        with self._lock:
            return list(self._mem.keys())

    def integrity_counts(self) -> dict:
        """Integrity counters for ``ServeMetrics`` (DESIGN §9):
        ``store_corrupt_evictions`` is the number of entries that failed
        checksum/format verification and were evicted (+ file deleted)."""
        with self._lock:
            return {"store_corrupt_evictions": self._corrupt_evictions}

    def index_stats(self) -> dict:
        """Neighbor-index introspection: which path answers
        ``neighbors`` and how often the grid index was (re)built."""
        with self._lock:
            return {
                "index_kind": self.index_kind,
                "index_entries": (len(self._index)
                                  if self._index is not None
                                  else len(self._meta)),
                "index_rebuilds": (self._index.rebuilds
                                   if self._index is not None else 0),
            }
