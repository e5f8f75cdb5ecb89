"""Checkpoint / resume of fixed-point state as flat npz pytrees (port of
``aiyagari_hark_tpu/utils/checkpoint.py``).

A pytree here is a tuple or NamedTuple of tensors, arrays and scalars
(an ``AFuncParams``, a ``DistPanelState``, a ``KSCheckpoint``, a
``SweepSidecar``, a sweep ledger).  The file layout is the JAX package's:
leaves under ``leaf_<i>`` (six digits, depth-first), plus a
``__treedef__`` string spelled as JAX's ``PyTreeDef`` repr spells these
trees (``PyTreeDef((*, CustomNode(namedtuple[DistPanelState], [*, *, *,
*, *])))``), which this module writes itself.  So a KS checkpoint or a
scheduler sidecar written by either package loads in the other.  Leaves
load as NumPy arrays; the caller moves them to its device.

Also here: the disk-fault injection hooks (an injected fault journals
``DISK_FAULT`` into the active obs scope before it raises), the atomic
text, JSON and JSONL writers, the tolerant JSONL reader, the sweep of
orphaned writer temp files (``gc_orphaned_tmp``), and the sweep
scheduler's ``SweepSidecar`` (a checksum failure journals
``INTEGRITY_FAILED``), the text, JSON and JSONL writers' ``durable=True``
fsync mode (the serving tier's write-ahead log) and the serving tier's lease files
(``acquire_lease`` and its family).
"""

from __future__ import annotations

import errno
import os
import re
import tempfile
import threading
import zipfile
from typing import NamedTuple

import numpy as np
import torch

# What ``np.load``/``load_pytree`` raise on a missing, truncated or trashed
# npz (a half-written or zeroed file raises BadZipFile or EOFError, neither
# an OSError): every best-effort loader degrades on this one set.
CORRUPT_NPZ_ERRORS = (OSError, ValueError, EOFError, zipfile.BadZipFile)


# -- deterministic disk-fault injection ---------------------------------------
#
# Every writer consults ``_maybe_disk_fault(op, path)`` before touching the
# disk.  Armed through ``arm_disk_fault``, the next ``count`` matching
# writes raise the OSError a full or failing disk raises (ENOSPC/EIO, the
# target path attached).  Ops: ``save_pytree``, ``atomic_write_text``,
# ``atomic_write_json``, ``append_jsonl``.

_DISK_FAULTS: dict = {}          # op -> {"errno", "count", "match"}
_DISK_FAULT_LOCK = threading.Lock()
_DISK_FAULT_TLS = threading.local()


def arm_disk_fault(op: str, kind: str = "ENOSPC", count: int = 1,
                   match: str = "") -> None:
    """Arm the next ``count`` ``op`` writes (optionally only on paths
    containing ``match``) to raise ``OSError(errno.<kind>)``."""
    code = getattr(errno, str(kind).upper(), None)
    if code is None:
        raise ValueError(f"unknown errno name {kind!r}")
    with _DISK_FAULT_LOCK:
        _DISK_FAULTS[str(op)] = {"errno": int(code),
                                 "count": max(0, int(count)),
                                 "match": str(match)}


def disarm_disk_faults() -> None:
    """Drop every armed fault (idempotent)."""
    with _DISK_FAULT_LOCK:
        _DISK_FAULTS.clear()


def _fire_disk_fault(op: str, path: str, code: int) -> None:
    """The injection seam: journal ``DISK_FAULT`` into the active obs
    scope, then raise the fault, as a full or failing disk raises it."""
    kind = errno.errorcode.get(code, str(code))
    _DISK_FAULT_TLS.active = True     # the event's append must not re-fault
    try:
        from ..obs.runtime import emit_event

        emit_event("DISK_FAULT", op=str(op), path=str(path),
                   errno=int(code), kind=kind, injected=True)
    finally:
        _DISK_FAULT_TLS.active = False
    raise OSError(code, f"injected disk fault ({kind})", str(path))


def _maybe_disk_fault(op: str, path: str) -> None:
    if not _DISK_FAULTS or getattr(_DISK_FAULT_TLS, "active", False):
        return
    with _DISK_FAULT_LOCK:
        plan = _DISK_FAULTS.get(op)
        if (plan is None or plan["count"] <= 0
                or plan["match"] not in str(path)):
            return
        plan["count"] -= 1
        code = plan["errno"]
    _fire_disk_fault(op, path, code)


class CheckpointMismatchError(ValueError):
    """A checkpoint was written by a different run (seed or configuration
    fingerprint mismatch) and resuming from it is refused."""


# -- pytrees ------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree):
    """(leaves depth-first, JAX's repr of the structure)."""
    if _is_namedtuple(tree) or isinstance(tree, (tuple, list)):
        leaves, reprs = [], []
        for child in tree:
            sub, r = _flatten(child)
            leaves += sub
            reprs.append(r)
        body = ", ".join(reprs)
        if _is_namedtuple(tree):
            return leaves, (f"CustomNode(namedtuple[{type(tree).__name__}], "
                            f"[{body}])")
        if isinstance(tree, list):
            return leaves, f"[{body}]"
        return leaves, f"({body},)" if len(reprs) == 1 else f"({body})"
    if tree is None:
        return [], "None"
    if isinstance(tree, dict):
        raise TypeError("dict pytrees are not supported; use a NamedTuple")
    return [tree], "*"


def tree_structure(tree) -> str:
    """The structure string JAX's ``str(jax.tree_util.tree_structure)``
    gives for ``tree``."""
    return f"PyTreeDef({_flatten(tree)[1]})"


def _unflatten(like, leaves):
    """Rebuild ``like``'s structure from an iterator of leaves."""
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(c, leaves) for c in like))
    if isinstance(like, tuple):
        return tuple(_unflatten(c, leaves) for c in like)
    if isinstance(like, list):
        return [_unflatten(c, leaves) for c in like]
    if like is None:
        return None
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _fsync_dir(path: str) -> None:
    """fsync the directory holding ``path`` so a rename or create itself
    survives power loss (the second half of a durable write)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return      # a platform that cannot open directories
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_pytree(path: str, tree) -> None:
    """Write a pytree of tensors, arrays or scalars to ``path`` (npz,
    atomic rename), its structure string alongside so a load against the
    wrong template is an error."""
    _maybe_disk_fault("save_pytree", path)
    leaves, r = _flatten(tree)
    arrays = {f"leaf_{i:06d}": _to_numpy(leaf)
              for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.asarray(f"PyTreeDef({r})")
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _canonical_treedef(s: str) -> str:
    """The structure string with NamedTuple class names erased (the
    migration loaders' templates are aliases with other names)."""
    return re.sub(r"namedtuple\[\w+\]", "namedtuple[_]", s)


def load_pytree(path: str, like, strict: bool = True):
    """Read a pytree saved by ``save_pytree`` (either package's) into the
    structure of ``like``; leaf shapes and dtypes come from the file, as
    NumPy arrays.  ``strict=True`` requires the exact structure string,
    NamedTuple names included; ``strict=False`` erases the names before
    comparing (the migration loaders only)."""
    want = tree_structure(like)
    n = len(_flatten(like)[0])
    with np.load(path) as data:
        stored_def = (str(data["__treedef__"])
                      if "__treedef__" in data.files else None)
        keys = sorted((k for k in data.files if k.startswith("leaf_")),
                      key=lambda k: int(k[5:]))
        if stored_def is not None:
            match = (stored_def == want if strict else
                     _canonical_treedef(stored_def)
                     == _canonical_treedef(want))
            if not match:
                raise ValueError(
                    f"checkpoint {path} was written for pytree structure\n  "
                    f"{stored_def}\nbut the template is\n  {want}")
        if len(keys) != n:
            raise ValueError(
                f"checkpoint {path} holds {len(keys)} leaves, template "
                f"expects {n} — wrong template or corrupted file")
        leaves = [data[k] for k in keys]
    return _unflatten(like, iter(leaves))


# -- atomic text, JSON and JSONL writers --------------------------------------

def _atomic_write_text(path: str, text: str, suffix: str,
                       durable: bool = False) -> None:
    """tmp + ``os.replace`` in the target's directory: a kill at any point
    leaves the old file or the new one, never a truncated hybrid.
    ``durable=True`` fsyncs the file and the directory."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=suffix)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            if durable:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if durable:
            _fsync_dir(path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def atomic_write_text(path: str, text: str, durable: bool = False) -> None:
    """Crash-consistent replacement for ``open(path, "w").write(text)``."""
    _maybe_disk_fault("atomic_write_text", path)
    _atomic_write_text(path, text, suffix=".txt.tmp", durable=durable)


def atomic_write_json(path: str, obj, indent: int = 2,
                      sort_keys: bool = False,
                      trailing_newline: bool = True,
                      durable: bool = False) -> None:
    """Crash-consistent JSON write (tmp + ``os.replace``)."""
    import json

    _maybe_disk_fault("atomic_write_json", path)
    text = json.dumps(obj, indent=indent, sort_keys=sort_keys)
    _atomic_write_text(path, text + ("\n" if trailing_newline else ""),
                       suffix=".json.tmp", durable=durable)


def append_jsonl(path: str, lines, durable: bool = False) -> None:
    """Append complete lines, each with one ``os.write`` to an
    ``O_APPEND`` descriptor: a kill between lines loses nothing, a kill
    mid-write tears at most the final line, and two appenders never
    interleave bytes within a line.  ``durable=True`` fsyncs the
    descriptor after the batch, and the directory entry when this call
    created the file, so a write-ahead log's acknowledged records
    survive power loss."""
    _maybe_disk_fault("append_jsonl", path)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    created = durable and not os.path.exists(path)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        for line in lines:
            if not line.endswith("\n"):
                line += "\n"
            os.write(fd, line.encode("utf-8"))
        if durable:
            os.fsync(fd)
    finally:
        os.close(fd)
    if created:
        _fsync_dir(path)


# -- serving leases (DESIGN §14) -----------------------------------------------
#
# Exclusive creation elects one solver per fingerprint among processes
# sharing a store directory: ``os.open(O_CREAT | O_EXCL)`` is atomic on
# POSIX, so exactly one process wins the create and every other sees
# ``FileExistsError``.  Losers key off the file's existence; the payload
# is diagnostic.  Staleness is judged by the file's mtime, the one
# timestamp a crashed owner cannot fail to have written.

LEASE_SUFFIX = ".lease"


def acquire_lease(path: str, owner: str = "") -> bool:
    """Try to create the lease file at ``path`` exclusively: True iff
    this caller created it (and now holds the lease), False when it
    already exists.  Never blocks."""
    import json

    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    try:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
    except FileExistsError:
        return False
    try:
        os.write(fd, (json.dumps({"owner": str(owner)}) + "\n").encode())
    finally:
        os.close(fd)
    return True


def read_lease(path: str):
    """The lease's owner payload (``{"owner": ...}``), or None when the
    file is missing; an unreadable or torn payload reads as ``{"owner":
    None}`` (the lease still exists)."""
    import json

    try:
        with open(path, "rb") as f:
            return json.loads(f.read().decode("utf-8"))
    except FileNotFoundError:
        return None
    except (ValueError, OSError, UnicodeDecodeError):
        return {"owner": None}


def lease_age_s(path: str, now=None):
    """Seconds since the lease file was written (mtime, on the wall
    clock ``time.time``, which processes share), or None when it is
    missing.  Clamped at zero: a wall clock stepped backward reads as
    fresh, never as a negative age."""
    import time

    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return None
    return max(0.0, (time.time() if now is None else float(now)) - mtime)


def release_lease(path: str) -> bool:
    """Remove the lease file; True iff this call removed it (release is
    idempotent)."""
    try:
        os.remove(path)
        return True
    except FileNotFoundError:
        return False


def break_stale_lease(path: str, ttl_s: float, now=None,
                      tolerance_s: float = 0.0) -> bool:
    """Remove the lease if its age exceeds ``ttl_s + tolerance_s`` (a
    crashed owner must not wedge its fingerprint); True iff this call
    removed it.  ``tolerance_s`` absorbs a reclaimer's clock running
    ahead of the owner's; a clock stepped back is harmless, since
    ``lease_age_s`` clamps at zero."""
    age = lease_age_s(path, now=now)
    if age is None or age <= float(ttl_s) + max(0.0, float(tolerance_s)):
        return False
    return release_lease(path)


def read_jsonl_tolerant(path: str) -> tuple:
    """Read a JSONL stream as ``(records, skipped)``, skipping unparseable
    lines (read as bytes and decoded per line, so a line torn inside a
    multibyte character is one more skipped line)."""
    import json

    records, skipped = [], 0
    with open(path, "rb") as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            try:
                records.append(json.loads(raw.decode("utf-8")))
            except (ValueError, UnicodeDecodeError):
                skipped += 1
    return records, skipped


def gc_orphaned_tmp(path: str, max_age_s: float = 3600.0) -> list:
    """Remove stale temp files of this module's atomic writers next to
    ``path``.  The writers clean their temp file on any in-process
    failure, but a hard kill (SIGKILL, OOM, power) between the write and
    the rename strands one.  Only the writers' own names
    (``tmp*.npz.tmp``, ``tmp*.json.tmp``, ``tmp*.txt.tmp``) and only
    files at least ``max_age_s`` old (default one hour: never a
    concurrent writer's file in flight) are removed, with a warning.
    Returns the removed paths."""
    import glob
    import time

    d = os.path.dirname(os.path.abspath(path)) or "."
    removed = []
    now = time.time()
    ours = [os.path.join(d, f"tmp*{s}")
            for s in (".npz.tmp", ".json.tmp", ".txt.tmp")]
    for tmp in sorted(t for pat in ours for t in glob.glob(pat)):
        try:
            if now - os.path.getmtime(tmp) >= max_age_s:
                os.remove(tmp)
                removed.append(tmp)
        except OSError:
            continue
    if removed:
        import warnings
        warnings.warn(
            f"removed {len(removed)} orphaned checkpoint tmp file(s) "
            f"next to {path}: " + ", ".join(os.path.basename(r)
                                            for r in removed),
            stacklevel=2)
    return removed


# -- the sweep scheduler's sidecar --------------------------------------------

class SweepSidecar(NamedTuple):
    """One prior sweep's per-cell work counters and roots for the next
    sweep's scheduler, keyed by the cell triples and fingerprinted
    against the solver configuration that produced them (the JAX
    package's layout: a sidecar either package wrote loads in the other).

    The work model reads ``total_work()`` to bucket cells by measured
    cost; the warm-bracket seeder reads ``r_star`` to descend each cell's
    bracket toward its known root.  A failed cell's row has NaN
    ``r_star`` (never a seed) but keeps its counters.  ``descent_steps``
    and ``polish_steps`` split the counters by precision-ladder phase, so
    a cheap descent step weighs ``config.DESCENT_STEP_COST``.
    ``checksum`` is the ``fingerprint.content_checksum`` of every content
    array, taken at save time and verified at load (0: unset)."""

    cells: np.ndarray          # [C, 3] float64
    r_star: np.ndarray         # [C] root; NaN = failed
    bisect_iters: np.ndarray   # [C] int64
    egm_iters: np.ndarray      # [C] int64
    dist_iters: np.ndarray     # [C] int64
    descent_steps: np.ndarray  # [C] int64 cheap-phase inner steps
    polish_steps: np.ndarray   # [C] int64 reference-phase inner steps
    status: np.ndarray         # [C] int64 solver_health codes
    fingerprint: np.ndarray    # scalar int64 solver-configuration key
    checksum: np.ndarray = np.zeros((), np.int64)

    def content_checksum(self) -> int:
        """The checksum the stored content should carry (one hashing
        order for the writer and the verifier)."""
        from .fingerprint import content_checksum

        return content_checksum(self.cells, self.r_star, self.bisect_iters,
                                self.egm_iters, self.dist_iters,
                                self.descent_steps, self.polish_steps,
                                self.status)

    def total_work(self) -> np.ndarray:
        """Per-cell work in reference-step units: every step, a descent
        step weighted by its relative cost."""
        from .config import DESCENT_STEP_COST

        total = (self.egm_iters + self.dist_iters).astype(np.float64)
        return total - (1.0 - DESCENT_STEP_COST) * self.descent_steps

    def lookup(self, cell, decimals: int = 9):
        """Row index of ``cell`` (rounded match), or None."""
        key = np.round(np.asarray(cell, dtype=np.float64), decimals)
        hits = np.nonzero(
            (np.round(self.cells, decimals) == key[None, :]).all(axis=1))[0]
        return int(hits[0]) if len(hits) else None


def save_sweep_sidecar(path: str, cells, r_star, bisect_iters, egm_iters,
                       dist_iters, status, fingerprint: int,
                       descent_steps=None, polish_steps=None) -> None:
    """Write a sweep's per-cell record for the next run's scheduler
    (atomic npz), its content checksum stamped.  ``descent_steps`` and
    ``polish_steps`` default to the all-reference split."""
    n = len(np.asarray(r_star))
    if descent_steps is None:
        descent_steps = np.zeros(n, dtype=np.int64)
    if polish_steps is None:
        polish_steps = (np.asarray(egm_iters, dtype=np.int64)
                        + np.asarray(dist_iters, dtype=np.int64))
    side = SweepSidecar(
        cells=np.asarray(cells, dtype=np.float64),
        r_star=np.asarray(r_star, dtype=np.float64),
        bisect_iters=np.asarray(bisect_iters, dtype=np.int64),
        egm_iters=np.asarray(egm_iters, dtype=np.int64),
        dist_iters=np.asarray(dist_iters, dtype=np.int64),
        descent_steps=np.asarray(descent_steps, dtype=np.int64),
        polish_steps=np.asarray(polish_steps, dtype=np.int64),
        status=np.asarray(status, dtype=np.int64),
        fingerprint=np.asarray(fingerprint, np.int64),
        checksum=np.zeros((), np.int64))
    save_pytree(path, side._replace(
        checksum=np.asarray(side.content_checksum(), np.int64)))


def load_sweep_sidecar(path: str, fingerprint: int) -> SweepSidecar:
    """Load a scheduler sidecar, refusing one written under another solver
    configuration (``CheckpointMismatchError``) or whose content no longer
    hashes to its checksum (``fingerprint.IntegrityError``); a missing or
    corrupt file raises one of ``CORRUPT_NPZ_ERRORS``.  The sweep catches
    all of them and falls back to its heuristic."""
    from .fingerprint import IntegrityError

    n = 1   # the leaf shapes come from the file
    tmpl = SweepSidecar(
        cells=np.zeros((n, 3)), r_star=np.zeros(n),
        bisect_iters=np.zeros(n, np.int64), egm_iters=np.zeros(n, np.int64),
        dist_iters=np.zeros(n, np.int64),
        descent_steps=np.zeros(n, np.int64),
        polish_steps=np.zeros(n, np.int64), status=np.zeros(n, np.int64),
        fingerprint=np.zeros((), np.int64), checksum=np.zeros((), np.int64))
    side = load_pytree(path, tmpl)
    if int(side.fingerprint) != int(fingerprint):
        raise CheckpointMismatchError(
            f"sweep sidecar {path} was written under solver-config "
            f"fingerprint {int(side.fingerprint)}, current is "
            f"{int(fingerprint)}; refusing a stale work model")
    want = side.content_checksum()
    if int(side.checksum) != int(want):
        from ..obs.runtime import emit_event

        emit_event("INTEGRITY_FAILED", boundary="sidecar", path=path)
        raise IntegrityError(
            f"sweep sidecar {path} failed content-checksum verification "
            f"(stored {int(side.checksum)}, content hashes to {want}) — "
            "silent corruption; refusing the work model",
            boundary="sidecar")
    return side


# -- the Krusell-Smith checkpoint ---------------------------------------------

class KSCheckpoint(NamedTuple):
    """Resumable state of the Krusell-Smith outer loop: the perceived
    rule, how many outer iterations produced it, the seed of the shock
    panel, a fingerprint of the configuration, and (slope-pinned mode)
    the secant's memory (previous iterate, previous residual, bracket)."""

    intercept: np.ndarray    # [2]
    slope: np.ndarray        # [2]
    iteration: np.ndarray    # scalar int
    seed: np.ndarray         # scalar int
    converged: np.ndarray    # scalar bool
    fingerprint: np.ndarray  # scalar int64 config hash
    secant: np.ndarray       # [4] (i_prev, g_prev, lo, hi); NaN = unset
    last_distance: np.ndarray  # scalar: rule distance at the saved iteration
    last_residual: np.ndarray  # scalar: pinned |g| (+inf when not pinned)


def ks_checkpoint_template() -> KSCheckpoint:
    return KSCheckpoint(
        intercept=np.zeros(2), slope=np.zeros(2),
        iteration=np.zeros((), np.int64), seed=np.zeros((), np.int64),
        converged=np.zeros((), np.bool_),
        fingerprint=np.zeros((), np.int64),
        secant=np.full((4,), np.nan),
        last_distance=np.full((), np.inf),
        last_residual=np.full((), np.inf))


# The fingerprint primitive lives in ``utils.fingerprint``; the JAX
# package's import path from this module stays valid.
from .fingerprint import config_fingerprint  # noqa: F401,E402  (re-export)


def save_ks_checkpoint(path: str, afunc, iteration: int, seed: int,
                       converged: bool, fingerprint: int = 0,
                       secant=None, last_distance: float = np.inf,
                       last_residual: float = np.inf) -> None:
    """Write the KS outer loop's state (``afunc`` fields may be tensors on
    any device; they are stored in their own dtype)."""
    save_pytree(path, KSCheckpoint(
        intercept=_to_numpy(afunc.intercept),
        slope=_to_numpy(afunc.slope),
        iteration=np.asarray(iteration, np.int64),
        seed=np.asarray(seed, np.int64),
        converged=np.asarray(converged, np.bool_),
        fingerprint=np.asarray(fingerprint, np.int64),
        secant=(np.full((4,), np.nan) if secant is None
                else np.asarray(secant, np.float64)),
        last_distance=np.asarray(last_distance, np.float64),
        last_residual=np.asarray(last_residual, np.float64)))


class _KSCheckpointV1(NamedTuple):
    """Round-1 layout (no secant memory, no last_distance)."""

    intercept: np.ndarray
    slope: np.ndarray
    iteration: np.ndarray
    seed: np.ndarray
    converged: np.ndarray
    fingerprint: np.ndarray


class _KSCheckpointV2(NamedTuple):
    """Intermediate layout (secant memory, no last_distance)."""

    intercept: np.ndarray
    slope: np.ndarray
    iteration: np.ndarray
    seed: np.ndarray
    converged: np.ndarray
    fingerprint: np.ndarray
    secant: np.ndarray


class _KSCheckpointV3(NamedTuple):
    """Round-2 layout (last_distance, no last_residual)."""

    intercept: np.ndarray
    slope: np.ndarray
    iteration: np.ndarray
    seed: np.ndarray
    converged: np.ndarray
    fingerprint: np.ndarray
    secant: np.ndarray
    last_distance: np.ndarray


def load_ks_checkpoint(path: str) -> KSCheckpoint:
    """Load a KS checkpoint, migrating the older layouts: a missing
    ``secant`` is unset (the pinned iteration re-probes), a missing
    ``last_distance`` / ``last_residual`` +inf (a migrated "converged"
    checkpoint re-runs at least one outer iteration against the current
    tolerance)."""
    try:
        return load_pytree(path, ks_checkpoint_template())
    except ValueError:
        pass
    zeros6 = (np.zeros(2), np.zeros(2), np.zeros((), np.int64),
              np.zeros((), np.int64), np.zeros((), np.bool_),
              np.zeros((), np.int64))
    try:
        old = load_pytree(path, _KSCheckpointV3(*zeros6, secant=np.zeros(4),
                                                last_distance=np.zeros(())),
                          strict=False)
        return KSCheckpoint(*old, last_residual=np.asarray(np.inf))
    except ValueError:
        pass
    try:
        old = load_pytree(path, _KSCheckpointV2(*zeros6,
                                                secant=np.zeros(4)),
                          strict=False)
        return KSCheckpoint(*old, last_distance=np.asarray(np.inf),
                            last_residual=np.asarray(np.inf))
    except ValueError:
        old = load_pytree(path, _KSCheckpointV1(*zeros6), strict=False)
        return KSCheckpoint(*old, secant=np.full((4,), np.nan),
                            last_distance=np.asarray(np.inf),
                            last_residual=np.asarray(np.inf))
