"""Wall timing on the host clock, iteration records, FLOP accounting and
device traces (port of ``aiyagari_hark_tpu/utils/timing.py``).  A wall
that covers work on the card ends with the results on the host (a copy
or a synchronize), so the host clock sees the device's time.  The FLOP
accounting's peaks are the card's own (``peak_flops_per_chip``), and
``device_trace`` is ``torch.profiler`` where JAX has ``jax.profiler``.
``CompileCounter`` counts what compiles under PyTorch: the CUDA kernels'
libraries, built by ``nvcc`` or loaded from their build directory."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, NamedTuple, Optional


class PhaseTimer:
    """Accumulating named timers: ``with timer.phase("solve"): ...``.
    ``report()`` returns {phase: seconds}; ``counts`` holds invocation
    counts.  Wall-clock only: the caller synchronizes with the device
    before a phase ends, as the solvers do."""

    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, float]:
        return dict(self.seconds)

    def summary(self) -> str:
        total = sum(self.seconds.values())
        lines = [f"{name:>12s}: {sec:8.3f}s x{self.counts[name]:<4d} "
                 f"({100.0 * sec / total:5.1f}%)"
                 for name, sec in sorted(self.seconds.items(),
                                         key=lambda kv: -kv[1])]
        return "\n".join(lines + [f"{'total':>12s}: {total:8.3f}s"])


class Stopwatch:
    """A started wall timer: ``elapsed()`` reads the running interval,
    ``seconds`` is filled at exit when used through ``stopwatch()`` (NaN
    while still running)."""

    __slots__ = ("t0", "seconds")

    def __init__(self):
        self.t0 = time.perf_counter()
        self.seconds = float("nan")

    def elapsed(self) -> float:
        """Seconds since construction (monotonic clock)."""
        return time.perf_counter() - self.t0


@contextlib.contextmanager
def stopwatch():
    """Measure one wall interval: ``with stopwatch() as sw: ...`` then read
    ``sw.seconds`` (filled even when the block raises)."""
    sw = Stopwatch()
    try:
        yield sw
    finally:
        sw.seconds = time.perf_counter() - sw.t0


def write_records_jsonl(path: str, records: Iterable,
                        append: bool = False) -> None:
    """Persist iteration records (``KSIterationRecord`` dataclasses or
    dicts) as JSON lines, through the ``utils.checkpoint`` writers:
    ``append=False`` replaces the whole file (tmp + ``os.replace``);
    ``append=True`` appends each complete line with one ``os.write``, so
    a kill tears at most the final line, which ``read_records_jsonl``
    skips."""
    from .checkpoint import append_jsonl, atomic_write_text

    lines = []
    for rec in records:
        if dataclasses.is_dataclass(rec) and not isinstance(rec, type):
            rec = dataclasses.asdict(rec)
        lines.append(json.dumps(rec) + "\n")
    if append:
        append_jsonl(path, lines)
    else:
        atomic_write_text(path, "".join(lines))


def read_records_jsonl(path: str):
    """Read a records JSONL back, skipping unparseable lines (a torn tail
    from a kill mid-append), with a warning that counts them."""
    from .checkpoint import read_jsonl_tolerant

    out, bad = read_jsonl_tolerant(path)
    if bad:
        import warnings

        warnings.warn(
            f"records jsonl {path}: skipped {bad} unparseable line(s) "
            "(torn tail from a hard kill mid-append?)", stacklevel=2)
    return out


def model_flops(egm_iters: float, dist_iters: float, a_count: int,
                n_states: int, d_count: int, dense_dist: bool) -> float:
    """Model FLOPs of counted inner-loop work, the JAX package's analytic
    step model: per EGM step the expectation ``[A,N] x [N,N]`` (2 A N^2)
    and ~12 A N of interpolation; per distribution step the labor mix
    ``[D,N] x [N,N]`` (2 D N^2) plus the dense lottery (2 N D^2) or the
    two-point scatter (~6 D N).  The port's kernels run the two-point
    lottery (``dense_dist=False``)."""
    egm = egm_iters * (2.0 * a_count * n_states ** 2
                       + 12.0 * a_count * n_states)
    per_dist = 2.0 * d_count * n_states ** 2
    per_dist += (2.0 * n_states * d_count ** 2 if dense_dist
                 else 6.0 * d_count * n_states)
    return egm + dist_iters * per_dist


class PeakFlops(NamedTuple):
    """The MFU denominator and its provenance: ``assumed=True`` means the
    card was not recognized and ``value`` is a guess -- record it as
    ``peak_flops_assumed``, never pass it off as known."""

    value: Optional[float]
    assumed: bool


# Data-sheet peaks of the H100 SXM (80 GB HBM3) outside the tensor cores,
# per dtype: the kernels run plain FP64/FP32 arithmetic.
H100_SXM_PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
H100_SXM_BYTES_PER_S = 3.35e12
_ASSUMED_PEAK_WARNED: set = set()


def card_name(device=None) -> Optional[str]:
    """``torch.cuda.get_device_name`` of ``device`` (a CUDA device, index
    or ``"cuda"``), or None on the CPU or without a CUDA device."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(0 if dev.index is None else dev.index)


def is_h100_sxm(name: Optional[str]) -> bool:
    """True for the H100 SXM card's name ("NVIDIA H100 80GB HBM3"); the
    PCIe and NVL boards have other peaks."""
    n = (name or "").upper()
    return "H100" in n and not any(k in n for k in ("PCIE", "NVL"))


def _dtype_key(dtype) -> str:
    return "float32" if str(dtype).endswith("float32") else "float64"


def peak_flops_per_chip(backend="cuda", dtype=None) -> PeakFlops:
    """Nominal peak FLOP/s of one card for the MFU denominator, per dtype
    (default float64), with ``assumed`` for an unrecognized card.
    ``backend`` is a device (``"cuda"``, ``"cuda:1"``, a ``torch.device``)
    or ``"cpu"``.  The H100 SXM's FP64 and FP32 peaks outside the tensor
    cores are known; any other card gets the H100 SXM's as a guess,
    flagged ``assumed`` and warned once per name; the CPU gets None (no
    single-number peak for a host)."""
    name = card_name(backend) if str(backend) != "cpu" else None
    if name is None:
        return PeakFlops(None, False)
    value = H100_SXM_PEAK_FLOPS[_dtype_key(dtype)]
    if is_h100_sxm(name):
        return PeakFlops(value, False)
    if name not in _ASSUMED_PEAK_WARNED:
        _ASSUMED_PEAK_WARNED.add(name)
        import warnings

        warnings.warn(
            f"unrecognized card {name!r}: assuming the H100 SXM's peaks "
            "for MFU -- treat mfu_pct as approximate "
            "(peak_flops_assumed=True in records)", stacklevel=2)
    return PeakFlops(value, True)


def flop_report(egm_iters: float, dist_iters: float, wall_s: float,
                a_count: int, n_states: int, d_count: int,
                dense_dist: bool, backend,
                measured_flops: Optional[float] = None,
                dtype=None) -> dict:
    """Achieved FLOP rate and MFU of one measured phase, as record
    fields: ``{"flops_per_sec", "mfu_pct", "peak_flops_assumed",
    "flops_provenance"}`` (``mfu_pct`` None on the CPU).  A degenerate
    wall records nulls, never raises.  ``measured_flops`` replaces the
    analytic ``model_flops`` numerator with the kernels' work model
    (``obs.profile.CostLedger.measured_flops_total``); the provenance
    field says which: ``"analytic"`` or ``"kernel_work_model"``."""
    if wall_s is None or not wall_s > 0:
        return {"flops_per_sec": None, "mfu_pct": None,
                "peak_flops_assumed": False, "flops_provenance": None}
    if measured_flops is not None:
        flops = float(measured_flops)
        provenance = "kernel_work_model"
    else:
        flops = model_flops(egm_iters, dist_iters, a_count, n_states,
                            d_count, dense_dist)
        provenance = "analytic"
    peak = peak_flops_per_chip(backend, dtype)
    return {"flops_per_sec": round(flops / wall_s),
            "mfu_pct": (None if peak.value is None
                        else round(100.0 * flops / wall_s / peak.value, 4)),
            "peak_flops_assumed": peak.assumed,
            "flops_provenance": provenance}


def record_flop_fields(record: dict, prefix: str, egm_iters: float,
                       dist_iters: float, wall_s: float, a_count: int,
                       n_states: int, d_count: int, dense_dist: bool,
                       backend, measured_flops: Optional[float] = None,
                       dtype=None) -> dict:
    """Stamp one phase's ``flop_report`` onto ``record`` under ``prefix``
    (``record[prefix + "flops_per_sec"]`` and the rest) and return it."""
    rep = flop_report(egm_iters, dist_iters, wall_s, a_count, n_states,
                      d_count, dense_dist, backend,
                      measured_flops=measured_flops, dtype=dtype)
    for key, value in rep.items():
        record[prefix + key] = value
    return record


# -- device traces (torch.profiler) ------------------------------------------

_DEVICE_TRACES = [0]       # device_trace exports of this process


def _profiler_running() -> bool:
    """True while a ``torch.profiler`` (ours or the caller's) records."""
    import torch

    enabled = getattr(torch._C._autograd, "_profiler_enabled", None)
    if enabled is not None:
        return bool(enabled())
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False))


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    where a card is present) and export its Chrome trace as
    ``<log_dir>/device_trace_<pid>_<n>.json``; a no-op when ``log_dir``
    is None.  A profiler cannot nest: inside a running one the block runs
    unprofiled.  The export happens after the block, so the block's own
    wall holds no file write; the profiler's start and stop cost wall,
    the first on a card seconds (CUPTI)."""
    if log_dir is None or _profiler_running():
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    _DEVICE_TRACES[0] += 1
    prof.export_chrome_trace(os.path.join(
        log_dir, f"device_trace_{os.getpid()}_{_DEVICE_TRACES[0]}.json"))


# -- kernel library build counting --------------------------------------------

_ACTIVE_COMPILE_COUNTERS: list = []
_COMPILE_LOCK = threading.Lock()


def note_library(seconds: float, built: bool) -> None:
    """Report one kernel library to every active ``CompileCounter``
    (``ops.kernels.build_libraries`` calls it once per library it built
    with ``nvcc`` or loaded from its build directory)."""
    with _COMPILE_LOCK:
        for c in _ACTIVE_COMPILE_COUNTERS:
            c.compile_events += 1
            c.compile_seconds += float(seconds)
            if built:
                c.cache_misses += 1
            else:
                c.cache_hits += 1


class CompileCounter:
    """Counts what compiles inside a ``with`` block: the CUDA kernels'
    shared libraries (``ops.kernels.build_libraries``), the only code the
    port compiles (the JAX package counts XLA compiles here; the fields
    and published names are its own).

    * ``compile_events`` / ``compile_seconds``: libraries built or loaded
      in the window, and their wall.
    * ``cache_misses``: libraries ``nvcc`` built (the "new compiles"
      number: a warm relaunch contract is ``cache_misses == 0``).
    * ``cache_hits``: libraries loaded from the build directory.

    A library already loaded in this process costs nothing and counts
    nothing, and on the CPU nothing is built, so all stay 0.  Windows
    may nest or overlap, from any thread: every active counter sees
    every library."""

    def __init__(self):
        self.compile_events = 0
        self.compile_seconds = 0.0
        self.cache_misses = 0
        self.cache_hits = 0

    def __enter__(self) -> "CompileCounter":
        with _COMPILE_LOCK:
            _ACTIVE_COMPILE_COUNTERS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _COMPILE_LOCK:
            _ACTIVE_COMPILE_COUNTERS.remove(self)

    def publish(self, registry, prefix: str = "aiyagari_xla_") -> None:
        """Mirror the totals into an ``obs.MetricsRegistry`` as gauges
        (a window total can be re-published), under the JAX package's
        names."""
        if registry is None:
            return
        registry.gauge(prefix + "compile_events",
                       "backend compile requests").set(self.compile_events)
        registry.gauge(prefix + "compile_seconds",
                       "backend compile wall").set(self.compile_seconds)
        registry.gauge(prefix + "cache_misses",
                       "programs compiled from scratch").set(
            self.cache_misses)
        registry.gauge(prefix + "cache_hits",
                       "compilations served from the persistent "
                       "cache").set(self.cache_hits)
