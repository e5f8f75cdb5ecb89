"""Cost attribution, the roofline and per-device telemetry (port of
``aiyagari_hark_tpu/obs/profile.py``; the same roofline table, snapshot
layout, metric names and events).

What differs by design:

* **Where a launch's cost comes from.**  PyTorch has no XLA
  ``cost_analysis()``.  Each ``CostLedger`` entry's cost is the kernels'
  analytic work model at the launch's shapes (``egm_work``,
  ``dist_work``, ``fused_work``, the one copy ``chip_smoke.py`` reads
  too): every input read once and every output written once, and the
  operations per step times the steps the lanes actually took, read from
  the packed rows' counters after they reached the host.  So
  ``cost_source`` is ``"kernel_work_model"``, ``lowering_s`` and
  ``compile_s`` are None (nothing is lowered or compiled per launch),
  and ``flops_model_vs_measured_ratio`` is None while every entry's
  source is that model: a ratio of the model to itself would be 1.0 and
  check nothing.  The launch walls are the sweep's own (``_timed_launch``
  in ``parallel.sweep``), which end when the rows arrive on the host, so
  the ledger adds no synchronisation.
* **Device memory.**  ``DeviceTelemetry.sample`` reads the CUDA caching
  allocator's counters (``torch.cuda.memory_stats(i)``:
  ``allocated_bytes.all.current`` and ``.peak``) for every CUDA device,
  and the device's memory (``torch.cuda.mem_get_info(i)[1]``, read once
  per device) as its limit; it journals ``DEVICE_MEM_HIGH_WATER`` each
  time a device's mark grows.  Without a CUDA device it counts the
  sample and records no gauge, as the JAX package does off a TPU; the
  solve's device is the caller's, and telemetry only reports.

``classify_roofline``'s table and thresholds are the JAX package's.  The
peaks are the card's (``utils.timing.peak_flops_per_chip``,
``peak_membw_per_chip``): the H100 SXM's data-sheet numbers, any other
card's flagged ``assumed``, none on the CPU.
"""

from __future__ import annotations

import math
import re
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

# Roofline classes (a closed vocabulary, like the journal's events).
ROOFLINE_UNKNOWN = "unknown"
ROOFLINE_LATENCY = "latency"
ROOFLINE_MEMORY = "memory"
ROOFLINE_COMPUTE = "compute"
ROOFLINE_CLASSES = (ROOFLINE_UNKNOWN, ROOFLINE_LATENCY,
                    ROOFLINE_MEMORY, ROOFLINE_COMPUTE)

# Achieved/ceiling fraction below which a launch is latency-bound: it
# engages neither roof, so dispatch and serialisation bind, not silicon.
LATENCY_UTIL_FRAC = 0.02
# With no known peak: a per-launch wall at or under this is dispatch.
LATENCY_WALL_FLOOR_S = 1e-3
# Ridge (FLOP/byte) used when no peak pair is known; only the
# memory/compute side depends on it, never a number in the record.
DEFAULT_RIDGE_FLOPS_PER_BYTE = 10.0


def peak_membw_per_chip(backend="cuda") -> Tuple[Optional[float], bool]:
    """Nominal peak memory bytes/s of one card for the roofline ridge,
    with ``assumed`` as ``utils.timing.peak_flops_per_chip`` has it: the
    H100 SXM's 3.35e12 (HBM3), any other card the same number flagged
    ``assumed``, the CPU ``(None, False)``."""
    from ..utils.timing import H100_SXM_BYTES_PER_S, card_name, is_h100_sxm

    name = card_name(backend) if str(backend) != "cpu" else None
    if name is None:
        return None, False
    return H100_SXM_BYTES_PER_S, not is_h100_sxm(name)


def classify_roofline(flops, bytes_accessed, wall_s, launches,
                      peak_flops=None, peak_bytes_per_s=None,
                      latency_util_frac: float = LATENCY_UTIL_FRAC,
                      latency_wall_floor_s: float = LATENCY_WALL_FLOOR_S,
                      default_ridge: float = DEFAULT_RIDGE_FLOPS_PER_BYTE
                      ) -> str:
    """The roofline taxonomy (the JAX package's table):

    1. ``unknown`` — no cost (flops or bytes missing) or no measured
       launches;
    2. ``latency`` — the achieved fraction of the ceiling ``min(peak_flops,
       AI * peak_bw)`` is under ``latency_util_frac`` (with no known peak:
       the per-launch wall is at or under ``latency_wall_floor_s``);
    3. ``compute`` / ``memory`` — arithmetic intensity (FLOP/byte) at or
       above / below the ridge (``peak_flops / peak_bytes_per_s``, else
       ``default_ridge``).
    """
    if (flops is None or bytes_accessed is None or not flops > 0.0
            or not bytes_accessed > 0.0 or not launches
            or wall_s is None or not wall_s > 0.0):
        return ROOFLINE_UNKNOWN
    ai = float(flops) / float(bytes_accessed)
    achieved = float(flops) * float(launches) / float(wall_s)
    if peak_flops is not None and peak_flops > 0.0:
        ceiling = peak_flops
        if peak_bytes_per_s is not None and peak_bytes_per_s > 0.0:
            ceiling = min(peak_flops, ai * peak_bytes_per_s)
        if achieved / ceiling < latency_util_frac:
            return ROOFLINE_LATENCY
        ridge = (peak_flops / peak_bytes_per_s
                 if peak_bytes_per_s is not None and peak_bytes_per_s > 0.0
                 else default_ridge)
    else:
        if wall_s / float(launches) <= latency_wall_floor_s:
            return ROOFLINE_LATENCY
        ridge = default_ridge
    return ROOFLINE_COMPUTE if ai >= ridge else ROOFLINE_MEMORY


# ---------------------------------------------------------------------------
# The kernels' work model: (bytes, operations) of one launch.
# ---------------------------------------------------------------------------
# ``itemsize`` is the float's size in bytes (8 for float64), ``lanes`` the
# launch's C, ``steps`` the inner steps summed over its lanes.  A pow counts
# as one operation.

def egm_work(itemsize: int, lanes: int, n_states: int, a_count: int,
             steps: float, knots: Optional[int] = None):
    """(bytes, operations) of the EGM fixed points of one launch of
    ``egm_policy_grid``: inputs read once, outputs written once; per step
    and lane, per (state, asset) pair 3 flops for m', ~log2(K) compares
    and 5 flops of interpolation, a pow, 2N-1 for the expectation, a pow
    and 2 more; 4 per knot for the sup-norm; every 32nd step 8 more per
    knot (dot products and extrapolation).  ``knots`` K defaults to
    A + 1."""
    s, N, A = int(itemsize), int(n_states), int(a_count)
    K = A + 1 if knots is None else int(knots)
    nbytes = lanes * (s * (2 * N * K + A + N + N * N + 5) + s * 2 * N * K
                      + 4 + s)
    per_step = (N * A * (3 + math.log2(K) + 5 + 1 + (2 * N - 1) + 3)
                + 4 * N * K + 8 * N * K / 32)
    return float(nbytes), per_step * float(steps)


def dist_work(itemsize: int, lanes: int, n_states: int, d_count: int,
              steps: float):
    """(bytes, operations) of the distribution fixed points of one launch
    of ``stationary_lottery_grid``: inputs (int64 index, weight, P, dist0)
    read once, outputs written once; per step and lane 4 D N flops of
    lottery, D N (2N-1) of labor mix, 2 D N for the sup-norm, and every
    64th step 10 D N more."""
    s, N, D = int(itemsize), int(n_states), int(d_count)
    dn = D * N
    nbytes = lanes * (8 * dn + s * dn + s * N * N + s * dn + s * dn + 4 + s)
    per_step = dn * (4 + (2 * N - 1) + 2) + 10 * dn / 64
    return float(nbytes), per_step * float(steps)


def fused_work(itemsize: int, lanes: int, n_states: int, a_count: int,
               d_count: int, egm_steps: float, dist_steps: float,
               tail: bool):
    """(bytes, operations) of one launch of ``fused_cell_grid``: the EGM
    and distribution operations above on these steps, plus per lane the
    transition's D N interpolations (3 flops for m, ~log2(K) and ~log2(D)
    compares, 5 of interpolation, 2 clamps, 3 for the weight); bytes: the
    fused inputs (knots [N, K], a, the support [D], levels, P, scalars,
    h, dist0) read once and its outputs (knots, dist, four statistics)
    written once.  K is A + 3 with the analytic tail, else A + 1."""
    s, N, A, D = int(itemsize), int(n_states), int(a_count), int(d_count)
    K = A + (3 if tail else 1)
    ops = (egm_work(s, lanes, N, A, egm_steps, K)[1]
           + dist_work(s, lanes, N, D, dist_steps)[1]
           + lanes * D * N * (3 + math.log2(K) + math.log2(D) + 5 + 2 + 3))
    nbytes = lanes * (s * (2 * N * K + A + D + N + N * N + 5 + N + D * N)
                      + s * (2 * N * K + D * N) + 2 * 4 + 2 * s)
    return float(nbytes), float(ops)


def launch_work(engines: dict, itemsize: int, lanes: int, n_states: int,
                a_count: int, d_count: int, egm_steps: float,
                dist_steps: float, tail: bool = False):
    """(bytes, operations) of one sweep launch from the engines it runs
    (``{"egm_engine": ..., "dist_engine": ...}``, as a scenario's
    ``prepare_kwargs`` names them): the fused kernel's work when both are
    ``fused_cell_grid``, else the EGM kernel's (when the policy loop is
    ``egm_policy_grid``; a plain PyTorch loop is not a kernel and counts
    nothing) plus the distribution kernel's."""
    egm, dist = engines.get("egm_engine"), engines.get("dist_engine")
    if egm == dist == "fused_cell_grid":
        return fused_work(itemsize, lanes, n_states, a_count, d_count,
                          egm_steps, dist_steps, tail)
    nbytes = ops = 0.0
    if egm == "egm_policy_grid":
        b, o = egm_work(itemsize, lanes, n_states, a_count, egm_steps,
                        a_count + (3 if tail else 1))
        nbytes, ops = nbytes + b, ops + o
    if dist == "stationary_lottery_grid":
        b, o = dist_work(itemsize, lanes, n_states, d_count, dist_steps)
        nbytes, ops = nbytes + b, ops + o
    return nbytes, ops


# ---------------------------------------------------------------------------
# The cost ledger.
# ---------------------------------------------------------------------------

_SLUG_RE = re.compile(r"[^a-zA-Z0-9_]+")


def _slug(label: str) -> str:
    """Prometheus-safe metric-name fragment from a free-form label."""
    return _SLUG_RE.sub("_", str(label)).strip("_").lower() or "exe"


@dataclass
class CostEntry:
    """One launch shape's cost record (one per ledger key).

    ``flops`` and ``bytes_accessed`` are the work model's per-launch
    means over this entry's launches (``flops_total`` and ``bytes_total``
    their sums); None until a launch brings its work.  ``cost_source`` is
    ``"kernel_work_model"`` once it does, ``"uncaptured"`` before."""

    key: tuple
    label: str
    lowering_s: Optional[float] = None
    compile_s: Optional[float] = None
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    transcendentals: Optional[float] = None
    cost_source: str = "uncaptured"
    launches: int = 0
    launch_wall_s: float = 0.0
    flops_total: float = 0.0
    bytes_total: float = 0.0
    work_launches: int = 0

    def achieved_flops_per_sec(self) -> Optional[float]:
        if (self.flops is None or not self.launches
                or not self.launch_wall_s > 0.0):
            return None
        return self.flops * self.launches / self.launch_wall_s

    def arithmetic_intensity(self) -> Optional[float]:
        if (self.flops is None or self.bytes_accessed is None
                or not self.bytes_accessed > 0.0):
            return None
        return self.flops / self.bytes_accessed

    def roofline(self, peak_flops=None, peak_bytes_per_s=None) -> str:
        return classify_roofline(
            self.flops, self.bytes_accessed, self.launch_wall_s,
            self.launches, peak_flops=peak_flops,
            peak_bytes_per_s=peak_bytes_per_s)


@dataclass
class _Peaks:
    flops: Optional[float] = None
    flops_assumed: bool = False
    bytes_per_s: Optional[float] = None
    bytes_assumed: bool = False


WORK_MODEL = "kernel_work_model"


class CostLedger:
    """Cost attribution for every launch shape of a run.

    ``capture(key, label, device, dtype)`` creates the entry of a launch
    shape once (memoized by key) and binds the ledger's peaks to the
    run's device and dtype; ``record_launch(key, wall_s, tracer, work)``
    adds one launch's measured wall and its work model ``(flops,
    bytes)``, and with a ``tracer`` drops Chrome-trace counter samples.
    Neither touches the device."""

    def __init__(self, backend=None, peak_flops: Optional[float] = None,
                 peak_bytes_per_s: Optional[float] = None):
        self._lock = threading.Lock()
        self._entries: Dict[tuple, CostEntry] = {}
        self._peaks: Optional[_Peaks] = None
        if peak_flops is not None or peak_bytes_per_s is not None:
            self._peaks = _Peaks(peak_flops, False, peak_bytes_per_s,
                                 False)
        self._backend = backend
        self._dtype = None

    # -- peaks (lazy: bound by the first capture's device and dtype) -------

    def peaks(self) -> _Peaks:
        if self._peaks is None:
            from ..utils.timing import peak_flops_per_chip

            backend = "cpu" if self._backend is None else self._backend
            pf = peak_flops_per_chip(backend, self._dtype)
            bw, bw_assumed = peak_membw_per_chip(backend)
            self._peaks = _Peaks(pf.value, pf.assumed, bw, bw_assumed)
        return self._peaks

    # -- capture / launch ---------------------------------------------------

    def capture(self, key: tuple, label: str = "", device=None,
                dtype=None) -> CostEntry:
        """The entry of ``key``, created once; the first call that names a
        ``device`` and ``dtype`` binds the ledger's peaks to them."""
        with self._lock:
            if self._backend is None and device is not None:
                self._backend = str(device)
            if self._dtype is None and dtype is not None:
                self._dtype = dtype
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = CostEntry(
                    key=key, label=str(label) or "exe")
            return entry

    def record_launch(self, key: tuple, wall_s: float, tracer=None,
                      work=None) -> None:
        """Add one launch's wall (and, with ``work=(flops, bytes)``, its
        work model) to ``key``'s entry; with a ``tracer``, sample the
        launch wall and the entry's achieved FLOP/s onto counter
        tracks."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = CostEntry(key=key, label="exe")
            entry.launches += 1
            entry.launch_wall_s += float(wall_s)
            if work is not None:
                entry.work_launches += 1
                entry.flops_total += float(work[0])
                entry.bytes_total += float(work[1])
                entry.flops = entry.flops_total / entry.work_launches
                entry.bytes_accessed = (entry.bytes_total
                                        / entry.work_launches)
                entry.cost_source = WORK_MODEL
        if tracer is not None:
            slug = _slug(entry.label)
            tracer.counter(f"profile/{slug}/launch_wall_s",
                           value=float(wall_s))
            achieved = entry.achieved_flops_per_sec()
            if achieved is not None:
                tracer.counter(f"profile/{slug}/achieved_flops_per_sec",
                               value=achieved)

    def entries(self) -> list:
        with self._lock:
            return list(self._entries.values())

    # -- aggregation / export ----------------------------------------------

    def measured_flops_total(self) -> Optional[float]:
        """The work model's operations summed over every launch that
        brought work; None when none did (absence is not zero work)."""
        totals = [e.flops_total for e in self.entries() if e.work_launches]
        return sum(totals) if totals else None

    def flops_model_vs_measured_ratio(self, analytic_flops
                                      ) -> Optional[float]:
        """Analytic ``model_flops`` over an independent count of the same
        launches.  None while every entry's count is the kernels' work
        model itself (no second opinion exists on PyTorch)."""
        measured = self.measured_flops_total()
        if measured is None or not measured > 0.0 or analytic_flops is None:
            return None
        if all(e.cost_source == WORK_MODEL for e in self.entries()
               if e.work_launches):
            return None
        return float(analytic_flops) / measured

    def snapshot(self) -> dict:
        """The ledger as one JSON-able dict: per-entry records plus run
        totals with the roofline class (the payload of the
        ``PROFILE_SNAPSHOT`` event), in the JAX package's layout."""
        peaks = self.peaks()
        entries = self.entries()
        per = {}
        for e in entries:
            # one slug per entry: two keys may share a label
            slug = base = _slug(e.label)
            n = 2
            while slug in per:
                slug = f"{base}_{n}"
                n += 1
            per[slug] = {
                "label": e.label,
                "launches": e.launches,
                "launch_wall_s": e.launch_wall_s,
                "lowering_s": e.lowering_s,
                "compile_s": e.compile_s,
                "flops": e.flops,
                "bytes_accessed": e.bytes_accessed,
                "transcendentals": e.transcendentals,
                "cost_source": e.cost_source,
                "achieved_flops_per_sec": e.achieved_flops_per_sec(),
                "arithmetic_intensity": e.arithmetic_intensity(),
                "roofline": e.roofline(peaks.flops, peaks.bytes_per_s),
            }
        wall = sum(e.launch_wall_s for e in entries)
        launches = sum(e.launches for e in entries)
        flops_total = self.measured_flops_total()
        bytes_totals = [e.bytes_total for e in entries if e.work_launches]
        bytes_total = sum(bytes_totals) if bytes_totals else None
        achieved = (flops_total / wall
                    if flops_total is not None and wall > 0.0 else None)
        ai = (flops_total / bytes_total
              if flops_total is not None and bytes_total else None)
        # classify the per-launch work (classify_roofline multiplies by
        # the launch count itself)
        roofline = classify_roofline(
            None if flops_total is None else flops_total / max(launches,
                                                              1),
            None if bytes_total is None else bytes_total / max(launches,
                                                               1),
            wall, launches,
            peak_flops=peaks.flops, peak_bytes_per_s=peaks.bytes_per_s)
        mfu = (None if peaks.flops is None or achieved is None
               else 100.0 * achieved / peaks.flops)
        sources = {}
        for e in entries:
            tag = e.cost_source.split(":", 1)[0]
            sources[tag] = sources.get(tag, 0) + 1
        return {
            "executables": len(entries),
            "launches": launches,
            "launch_wall_s": wall,
            "lowering_wall_s": sum(e.lowering_s or 0.0 for e in entries),
            "compile_wall_s": sum(e.compile_s or 0.0 for e in entries),
            "measured_flops_total": flops_total,
            "bytes_accessed_total": bytes_total,
            "achieved_flops_per_sec": achieved,
            "arithmetic_intensity": ai,
            "roofline": roofline,
            "mfu_pct": mfu,
            "peak_flops_per_chip": peaks.flops,
            "peak_flops_assumed": peaks.flops_assumed,
            "peak_bytes_per_s_per_chip": peaks.bytes_per_s,
            "peak_bytes_assumed": peaks.bytes_assumed,
            "cost_sources": sources,
            "entries": per,
        }

    def publish(self, registry, prefix: str = "aiyagari_profile_"
                ) -> None:
        """Mirror the ledger into a metrics registry (totals as gauges,
        plus per-entry launch wall, launches and achieved FLOP/s under
        slugged names)."""
        if registry is None:
            return
        snap = self.snapshot()
        for name, help_text in (
                ("executables", "profiled executables this run"),
                ("launches", "profiled launches this run"),
                ("launch_wall_s", "summed profiled launch wall"),
                ("compile_wall_s", "summed AOT compile wall"),
                ("lowering_wall_s", "summed lowering wall")):
            registry.gauge(prefix + name, help_text).set(
                float(snap[name] or 0.0))
        if snap["achieved_flops_per_sec"] is not None:
            registry.gauge(prefix + "achieved_flops_per_sec",
                           "measured FLOP/s over profiled launches").set(
                snap["achieved_flops_per_sec"])
        for slug, e in snap["entries"].items():
            registry.gauge(f"{prefix}launch_wall_s_{slug}",
                           f"launch wall: {e['label']}").set(
                e["launch_wall_s"])
            registry.gauge(f"{prefix}launches_{slug}",
                           f"launches: {e['label']}").set(e["launches"])
            if e["achieved_flops_per_sec"] is not None:
                registry.gauge(
                    f"{prefix}achieved_flops_per_sec_{slug}",
                    f"achieved FLOP/s: {e['label']}").set(
                    e["achieved_flops_per_sec"])


class DeviceTelemetry:
    """Per-device memory telemetry with a journaled high-water mark.

    ``sample(obs, where=...)`` reads every CUDA device's allocator
    counters, mirrors ``bytes_in_use`` / ``peak_bytes_in_use`` /
    ``bytes_limit`` into the run's registry (the JAX package's gauge
    names), and emits ONE ``DEVICE_MEM_HIGH_WATER`` event per device each
    time its high-water mark grows.  Reading the counters does not
    synchronise with the device."""

    def __init__(self):
        self._lock = threading.Lock()
        self._high_water: Dict[int, float] = {}
        self._limits: Dict[int, int] = {}
        self.samples = 0
        self.devices_without_stats = 0

    def _limit(self, i: int) -> int:
        if i not in self._limits:
            import torch

            self._limits[i] = int(torch.cuda.mem_get_info(i)[1])
        return self._limits[i]

    def sample(self, obs, where: str = "") -> int:
        """Sample all CUDA devices once; returns how many had stats."""
        try:
            import torch

            n = (torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)
        except Exception:   # noqa: BLE001 — telemetry only reports
            return 0
        with self._lock:
            self.samples += 1
        with_stats = 0
        for i in range(n):
            try:
                stats = torch.cuda.memory_stats(i)
            except Exception:   # noqa: BLE001
                stats = None
            if not stats:
                with self._lock:
                    self.devices_without_stats += 1
                continue
            with_stats += 1
            in_use = float(stats.get("allocated_bytes.all.current", 0) or 0)
            peak = float(stats.get("allocated_bytes.all.peak", in_use)
                         or in_use)
            limit = self._limit(i)
            obs.gauge(f"aiyagari_device{i}_mem_bytes_in_use",
                      "device bytes in use at the last sample").set(in_use)
            obs.gauge(f"aiyagari_device{i}_mem_peak_bytes_in_use",
                      "device peak bytes in use").set(peak)
            if limit:
                obs.gauge(f"aiyagari_device{i}_mem_bytes_limit",
                          "device memory limit").set(float(limit))
            hw = max(in_use, peak)
            with self._lock:
                prev = self._high_water.get(i, 0.0)
                grew = hw > prev
                if grew:
                    self._high_water[i] = hw
            if grew:
                obs.event("DEVICE_MEM_HIGH_WATER", device=int(i),
                          bytes=int(hw), where=where,
                          **({} if not limit
                             else {"bytes_limit": int(limit)}))
        return with_stats

    def high_water(self) -> dict:
        with self._lock:
            return dict(self._high_water)
