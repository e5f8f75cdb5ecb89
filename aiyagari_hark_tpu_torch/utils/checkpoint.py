"""Checkpoint / resume of fixed-point state as flat npz pytrees (port of
the parts of ``aiyagari_hark_tpu/utils/checkpoint.py`` the Krusell-Smith
outer loop uses).

A pytree here is a tuple or NamedTuple of tensors, arrays and scalars
(an ``AFuncParams``, a ``DistPanelState``, a ``KSCheckpoint``).  The file
layout is the JAX package's: leaves under ``leaf_<i>`` (six digits,
depth-first), plus a ``__treedef__`` string spelled as JAX's
``PyTreeDef`` repr spells these trees (``PyTreeDef((*,
CustomNode(namedtuple[DistPanelState], [*, *, *, *, *])))``), which this
module writes itself.  So a KS checkpoint written by either package
resumes in the other.  Leaves load as NumPy arrays; the caller moves
them to its device.

Also here: the disk-fault injection hooks, the atomic text, JSON and
JSONL writers, and the tolerant JSONL reader.  Not ported yet: the fleet
leases and ``gc_orphaned_tmp`` (the serve tier, ROADMAP Queue 1 item 8),
``SweepSidecar`` (item 3) and the writers' ``durable=True`` fsync mode
(the serving tier's write-ahead log is its only user, item 8).  The JAX writers journal a ``DISK_FAULT``
event when an injected fault fires; the port has no event journal yet
(item 8).
"""

from __future__ import annotations

import errno
import os
import re
import tempfile
import threading
from typing import NamedTuple

import numpy as np
import torch

# -- deterministic disk-fault injection ---------------------------------------
#
# Every writer consults ``_maybe_disk_fault(op, path)`` before touching the
# disk.  Armed through ``arm_disk_fault``, the next ``count`` matching
# writes raise the OSError a full or failing disk raises (ENOSPC/EIO, the
# target path attached).  Ops: ``save_pytree``, ``atomic_write_text``,
# ``atomic_write_json``, ``append_jsonl``.

_DISK_FAULTS: dict = {}          # op -> {"errno", "count", "match"}
_DISK_FAULT_LOCK = threading.Lock()


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


def _maybe_disk_fault(op: str, path: str) -> None:
    if not _DISK_FAULTS:
        return
    with _DISK_FAULT_LOCK:
        plan = _DISK_FAULTS.get(op)
        if (plan is None or plan["count"] <= 0
                or plan["match"] not in str(path)):
            return
        plan["count"] -= 1
        code = plan["errno"]
    kind = errno.errorcode.get(code, str(code))
    raise OSError(code, f"injected disk fault ({kind})", str(path))


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

def _atomic_write_text(path: str, text: str, suffix: str) -> None:
    """tmp + ``os.replace`` in the target's directory: a kill at any point
    leaves the old file or the new one, never a truncated hybrid."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=suffix)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def atomic_write_text(path: str, text: str) -> None:
    """Crash-consistent replacement for ``open(path, "w").write(text)``."""
    _maybe_disk_fault("atomic_write_text", path)
    _atomic_write_text(path, text, suffix=".txt.tmp")


def atomic_write_json(path: str, obj, indent: int = 2,
                      sort_keys: bool = False,
                      trailing_newline: bool = True) -> None:
    """Crash-consistent JSON write (tmp + ``os.replace``)."""
    import json

    _maybe_disk_fault("atomic_write_json", path)
    text = json.dumps(obj, indent=indent, sort_keys=sort_keys)
    _atomic_write_text(path, text + ("\n" if trailing_newline else ""),
                       suffix=".json.tmp")


def append_jsonl(path: str, lines) -> None:
    """Append complete lines, each with one ``os.write`` to an
    ``O_APPEND`` descriptor: a kill between lines loses nothing, a kill
    mid-write tears at most the final line, and two appenders never
    interleave bytes within a line."""
    _maybe_disk_fault("append_jsonl", path)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        for line in lines:
            if not line.endswith("\n"):
                line += "\n"
            os.write(fd, line.encode("utf-8"))
    finally:
        os.close(fd)


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
