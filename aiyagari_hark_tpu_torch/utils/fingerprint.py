"""Fingerprints and content checksums (the port's own copy of the host
code of ``aiyagari_hark_tpu/utils/fingerprint.py``): the sweep's SDC
sample ranks cells by ``solution_fingerprint``, the scheduler sidecar is
keyed by ``work_fingerprint``, the resume ledger by ``ledger_fingerprint``,
and every durable row carries a ``packed_row_checksum`` taken at solve
time.

For equal inputs every int here equals the JAX package's: the same md5
over the same strings.  A dtype is hashed as ``str(np.dtype(dtype))``, so
a torch dtype goes through ``canonical_dtype`` first ("float64" /
"float32", as JAX's ``_canonical_dtype`` spells them).

The inputs differ where the packages differ: the JAX sweep's
``prepare_kwargs`` inserts its engine choices (``dist_method``,
``egm_method``) into the solver kwargs before hashing, and the port has
no such keys.  So for the same user call the port's ``kwargs_items`` --
and its fingerprints and SDC sample -- may differ from JAX's.

One key differs on purpose: ``ledger_fingerprint`` also hashes
``PACKAGE_TOKEN``.  A resume ledger restores a sweep's rows bit for bit
into a result that claims to be the port's; a ledger the JAX package
wrote holds JAX's bits, so the port refuses it (warns and recomputes).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np
import torch

from .config import (resolve_grid, resolve_kernel, resolve_precision,
                     resolve_state)

class IntegrityError(RuntimeError):
    """A content checksum failed verification at an artifact boundary: the
    stored bytes are not the bytes that were solved (a bit flip, a torn
    write that still parses).  Not a ``ValueError`` or ``OSError``, so the
    best-effort loaders (``checkpoint.CORRUPT_NPZ_ERRORS``) cannot swallow
    it by accident: each boundary decides its own degrade (the resume
    ledger recomputes the cell, the sidecar falls back to the heuristic).
    ``boundary`` names the site ("ledger", "sidecar", ...), ``key`` the
    entry or cell when there is one."""

    def __init__(self, message: str, boundary: str | None = None,
                 key=None):
        super().__init__(message)
        self.boundary = boundary
        self.key = None if key is None else int(key)


def content_checksum(*arrays) -> int:
    """Deterministic int64 checksum over the canonical bytes of numeric
    arrays: each as little-endian float64 (which holds every narrower
    dtype exactly and round-trips npz bit for bit), C-contiguous, its
    shape included.  The JAX package's spelling: equal arrays give equal
    ints in both packages."""
    h = hashlib.md5()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a, dtype="<f8"))
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return int.from_bytes(h.digest()[:8], "little", signed=True)


def packed_row_checksum(row) -> int:
    """Content checksum of one packed row, taken at solve time and
    verified wherever the row is restored."""
    return content_checksum(row)


def packed_row_checksums(rows) -> np.ndarray:
    """Per-row checksums of a [C, W] packed block, int64 (NaN rows too:
    the same program writes the same NaN bits)."""
    rows = np.asarray(rows, dtype=np.float64)
    return np.asarray([packed_row_checksum(r) for r in rows],
                      dtype=np.int64)


def verify_packed_row(row, expected: int, boundary: str,
                      key=None) -> None:
    """Raise ``IntegrityError`` unless ``row``'s checksum is ``expected``
    (the int64 recorded at solve time), after journaling
    ``INTEGRITY_FAILED`` into the active obs scope."""
    got = packed_row_checksum(row)
    if int(got) != int(expected):
        from ..obs.runtime import emit_event

        emit_event("INTEGRITY_FAILED", boundary=boundary,
                   key=None if key is None else int(key))
        where = "" if key is None else f" (entry {int(key)})"
        raise IntegrityError(
            f"packed-row checksum mismatch at the {boundary} "
            f"boundary{where}: stored bytes hash to {got}, solve-time "
            f"checksum was {int(expected)} — silent corruption",
            boundary=boundary, key=key)


def fingerprint_hex(key: int) -> str:
    """A signed int64 fingerprint as a file-name spelling: its
    two's-complement bits, zero-padded hex."""
    return f"{int(key) & 0xFFFFFFFFFFFFFFFF:016x}"


_NUMPY_DTYPES = {torch.float64: np.dtype(np.float64),
                 torch.float32: np.dtype(np.float32)}


def canonical_dtype(dtype) -> np.dtype:
    """The numpy dtype a sweep runs in: a torch dtype maps to its numpy
    twin, ``None`` to float32 (the port's default, ``device.
    resolve_dtype``), a numpy dtype or its name to itself."""
    if dtype is None:
        return np.dtype(np.float32)
    if isinstance(dtype, torch.dtype):
        try:
            return _NUMPY_DTYPES[dtype]
        except KeyError:
            raise ValueError(f"dtype must be torch.float32 or "
                             f"torch.float64, got {dtype!r}") from None
    return np.dtype(dtype)


def config_fingerprint(*objs) -> int:
    """Deterministic int64 fingerprint of configs and arrays: a dataclass
    hashes its sorted field dict, an array its dtype, shape and bytes,
    anything else its ``repr``."""
    parts = []
    for o in objs:
        if o is None:
            parts.append("none")
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            parts.append(json.dumps(dataclasses.asdict(o), sort_keys=True,
                                    default=repr))
        elif isinstance(o, np.ndarray) or hasattr(o, "__array__"):
            a = np.asarray(o)
            parts.append(f"{a.dtype}{a.shape}"
                         + hashlib.md5(a.tobytes()).hexdigest())
        else:
            parts.append(repr(o))
    digest = hashlib.md5("|".join(parts).encode()).digest()
    return int.from_bytes(digest[:8], "little", signed=True)


def hashable_kwargs(model_kwargs: dict) -> tuple:
    """Solver kwargs as a canonical, hashable, sorted items tuple, the one
    spelling every fingerprint hashes.  Sequences become tuples; anything
    unhashable raises ``TypeError``.

    The four policies are normalised alike: ``precision``, ``grid`` and
    ``kernel`` hash their canonical name and drop "reference", ``state``
    drops "replicated" (the defaults give the same bits, so the two
    spellings must share one fingerprint); an unknown policy raises
    ``ValueError`` from its resolver."""
    defaults = (("precision", resolve_precision, "reference"),
                ("grid", resolve_grid, "reference"),
                ("kernel", resolve_kernel, "reference"),
                ("state", resolve_state, "replicated"))
    items = []
    for k, v in sorted(model_kwargs.items()):
        skip = False
        for key, resolve, default in defaults:
            if k == key:
                v = resolve(v).policy
                skip = v == default
        if skip:
            continue
        if isinstance(v, (list, np.ndarray)):
            arr = np.asarray(v)
            if arr.ndim > 1:
                raise TypeError(
                    f"sweep kwarg {k!r} has shape {arr.shape}; only scalars "
                    "and 1-D sequences can be forwarded to the cell solver")
            v = tuple(arr.tolist())
        try:
            hash(v)
        except TypeError:
            raise TypeError(
                f"sweep kwarg {k!r}={v!r} is not hashable; pass scalars or "
                "tuples (grids are rebuilt per cell from scalar settings)"
            ) from None
        items.append((k, v))
    return tuple(items)


# Every key hashes the scenario name, so a fingerprint of one model family
# never addresses another's.
DEFAULT_SCENARIO = "aiyagari"


def _scenario_token(scenario: str) -> str:
    return f"scenario:{scenario}"


def work_fingerprint(kwargs_items: tuple, dtype,
                     scenario: str = DEFAULT_SCENARIO) -> int:
    """Solver-configuration key: the scenario, the solver kwargs and the
    dtype (not the cells)."""
    return config_fingerprint(_scenario_token(scenario),
                              str(canonical_dtype(dtype)),
                              repr(kwargs_items))


def solution_fingerprint(crra, labor_ar, labor_sd, kwargs_items: tuple,
                         dtype, scenario: str = DEFAULT_SCENARIO) -> int:
    """Content address of one equilibrium: the ``work_fingerprint`` inputs
    plus the calibration cell."""
    return config_fingerprint(
        _scenario_token(scenario),
        str(canonical_dtype(dtype)), repr(kwargs_items),
        float(crra), float(labor_ar), float(labor_sd))


# Hashed into every resume-ledger key of the port (see the module
# docstring): a ledger written by the JAX package never matches.
PACKAGE_TOKEN = "package:aiyagari_hark_tpu_torch"


def ledger_fingerprint(cells, kwargs_items: tuple, dtype,
                       schedule: str, n_buckets: int, warm_brackets: bool,
                       warm_margin: float, fault_mode, fault_iters,
                       max_retries: int, quarantine: bool,
                       sidecar, scenario: str = DEFAULT_SCENARIO,
                       row_fields=None, mesh_shards: int = 1,
                       state_shards: int = 1) -> int:
    """Validity key of the sweep resume ledger (``resilience.SweepLedger``):
    the JAX package's fields -- the scenario, the cells (perturb
    included), solver kwargs, dtype, schedule knobs, fault injection, the
    sidecar's content (warm seeds read it), the packed-row layout
    (``row_fields``; None: the registered scenario's) and the launch
    geometry (``mesh_shards``, ``state_shards``: 1 and 1 in the port,
    which shards nothing yet) -- plus ``PACKAGE_TOKEN``."""
    if row_fields is None:
        from ..scenarios.registry import get_scenario

        row_fields = get_scenario(scenario).schema.fields
    return config_fingerprint(
        PACKAGE_TOKEN, _scenario_token(scenario), repr(tuple(row_fields)),
        np.asarray(cells, dtype=np.float64),
        repr(kwargs_items), str(canonical_dtype(dtype)),
        schedule, int(n_buckets), bool(warm_brackets),
        float(warm_margin), str(fault_mode),
        "none" if fault_iters is None else fault_iters,
        int(max_retries), bool(quarantine),
        (int(mesh_shards), int(state_shards)),
        *(tuple(sidecar) if sidecar is not None else ("no-sidecar",)))
