"""One run of one cell of the port's benchmark.

``run_cell`` drives everything but the look for a card: it builds the
cell from ``BENCHMARK.json`` and the files named there, loads the
kernels, warms up on a sweep of the cell's own shapes, runs the closed
loop of sweeps for the window (under the profiler with ``trace``),
reads the metrics through their readers, and holds a sample of the
window's answers to the configuration's plain reference.  ``main`` is the
command line: it refuses to run without the cards the cell asks for,
refuses to print a result when the JAX package was loaded, and prints
the result line.

Files, found by name (``Bench``): the configuration's file as
``BENCHMARK.json`` names it, which names the program's ``scenario`` and
its plain ``reference`` (``portbench/<reference>.py``, a function
``judge(cells, r_star, capital, cfg, device)`` returning each compared
number's value for every cell judged); the traffic mix in
``portbench/workloads/<traffic>.json``; and each metric's reader in
``portbench/metrics/<metric>.py``, a function ``read(run)`` that
returns a number or None (nothing to read: the metric is left out).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from . import traffic as traffic_mod
from .trace import SWEEP, WINDOW, Tracer, port_kernel_names, summarize
from .workmodel import PEAK_BYTES_PER_S, PEAK_FLOPS

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level modules that may not be loaded in the process that prints a
# result: JAX and the JAX package (the port's own name starts with it, so
# names are compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "aiyagari_hark_tpu")
PORT_CSRC = ("aiyagari_hark_tpu_torch", "ops", "csrc")


class Bench:
    """``BENCHMARK.json`` under ``root`` and the files it names; the
    benchmark's own files live in ``root / "portbench"``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "portbench"

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "workloads" / f"{name}.json")
                          .read_text())

    def metrics(self, workload: str, trace: bool) -> list:
        """The metric entries a run of ``workload`` reports: the per-layer
        ones with ``trace``, else the end-to-end ones."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def reference(self, cfg: dict):
        """The configuration's plain reference, ``portbench/<name>.py``."""
        return importlib.import_module(f"portbench.{cfg['reference']}")


class Sweep:
    """One sweep of the window: its host wall (call to rows on the host),
    the engine's own wall of its batched launches, and its rows."""

    def __init__(self, host_s: float, res):
        self.host_s = host_s
        self.engine_s = float(res.wall_seconds)
        self.cells = res.cells
        self.r_star = res.col("r_star")
        self.capital = res.col("capital")
        self.bisect = res.icol("bisect_iters")
        self.egm = res.icol("egm_iters")
        self.dist = res.icol("dist_iters")
        self.failed = np.zeros(len(res.status), dtype=bool)
        self.failed[res.failed_cells()] = True


class Run:
    """What the readers read: the window's sweeps, its length, the set-up
    time, the cell's sizes and dtype, the peaks, and the trace summary
    (None without ``--trace 1``)."""

    def __init__(self, sweeps, window_s, setup_s, cfg, dtype_name, summary):
        self.sweeps = sweeps
        self.window_s = window_s
        self.setup_s = setup_s
        self.A = int(cfg["a_count"])
        self.N = int(cfg["labor_states"])
        self.D = int(cfg["dist_count"])
        self.itemsize = 8 if dtype_name == "float64" else 4
        self.peak_flops = PEAK_FLOPS[dtype_name]
        self.peak_bytes_per_s = PEAK_BYTES_PER_S
        self.trace = summary
        self.notes = []           # lines printed before the result

    def column(self, name: str) -> np.ndarray:
        return np.concatenate([getattr(s, name) for s in self.sweeps])

    @property
    def trips(self) -> int:
        """Bisection trips of the window: a sweep's host loop runs as many
        trips as its slowest lane takes."""
        return int(sum(int(s.bisect.max()) for s in self.sweeps))


def process_age() -> float:
    """Seconds since this process started (from ``/proc``; where that is
    unreadable, since this module was imported)."""
    try:
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        up = float(Path("/proc/uptime").read_text().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", dtype_name: str | None = None,
             sweep_fn=None):
    """One run of cell ``name``.  Returns (result dict without the checks'
    key, checks {name: (value, limit)}, notes).  ``dtype_name`` replaces
    the traffic's dtype (the control runs the program one precision
    below); ``sweep_fn(cells, dtype, device, kwargs)`` replaces the call
    into the program (the fault drills)."""
    import torch
    from torch.autograd.profiler import record_function

    from aiyagari_hark_tpu_torch.ops import kernels
    from aiyagari_hark_tpu_torch.parallel.sweep import run_sweep

    entry = bench.workload(name)
    cfg = bench.config(entry["config"])
    mix = bench.traffic(entry["traffic"])
    dtype_name = dtype_name or mix["dtype"]
    dtype = getattr(torch, dtype_name)
    kwargs = {k: cfg[k] for k in cfg["port_kwargs"]}
    kwargs.update(mix["sweep_kwargs"])
    cuda = torch.device(device).type == "cuda"
    if sweep_fn is None:
        def sweep_fn(cells, dtype, device, kwargs):
            return run_sweep(cfg["scenario"], cells=cells, dtype=dtype,
                             device=device, **kwargs)

    if cuda:
        kernels.build_libraries(tuple(mix["libraries"]))
        torch.cuda.reset_peak_memory_stats()
    for i in range(int(mix["warmup_sweeps"])):
        sweep_fn(traffic_mod.sweep_cells(mix, seed, i,
                                         traffic_mod.STREAM_WARMUP),
                 dtype, device, kwargs)
    tracer = Tracer(cuda) if trace else None
    sweeps = []
    if tracer is not None:
        tracer.start()
    setup_s = process_age()
    t0 = time.perf_counter()
    with record_function(WINDOW) if tracer else contextlib.nullcontext():
        k = 0
        while time.perf_counter() - t0 < seconds:
            cells = traffic_mod.sweep_cells(mix, seed, k)
            ts = time.perf_counter()
            with (record_function(SWEEP) if tracer
                  else contextlib.nullcontext()):
                res = sweep_fn(cells, dtype, device, kwargs)
            sweeps.append(Sweep(time.perf_counter() - ts, res))
            k += 1
    window_s = time.perf_counter() - t0
    summary = None
    notes = []
    if tracer is not None:
        t_stop = time.perf_counter()
        events = tracer.stop()
        t_events = time.perf_counter()
        summary = summarize(events, port_kernel_names(
            bench.root.joinpath(*PORT_CSRC)))
        del events
        notes.append(f"trace: stop and events {t_events - t_stop:.1f} s, "
                     f"reduction {time.perf_counter() - t_events:.1f} s")
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    run = Run(sweeps, window_s, setup_s, cfg, dtype_name, summary)
    run.notes.extend(notes)

    metrics = {}
    for m in bench.metrics(name, trace):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    failed = int(run.column("failed").sum())
    attempted = int(sum(len(s.failed) for s in sweeps))
    # A cell that ends with a failing status is an answer that never came:
    # the window's cells are all due, so the limit is none.
    checks = {"failed_cells": (failed, 0)}
    checks.update(check_answers(run, mix, cfg, seed, device,
                                bench.reference(cfg)))
    result = {
        "correct": bool(attempted > 0 and all(
            v <= lim for v, lim in checks.values())),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": (torch.cuda.get_device_name(torch.device(device))
                     if cuda else "cpu"),
            "count": int(entry["chips"]),
            "memory_peak_bytes": memory_peak,
        },
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    return result, checks, run.notes


def check_answers(run: Run, mix: dict, cfg: dict, seed: int, device,
                  reference):
    """Hold a sample of the window's solved cells, drawn from the seed
    with the cell of the most distribution steps among them, to
    ``reference``.  Returns {number: (worst value, limit)}."""
    ok = ~run.column("failed")
    cells = run.column("cells")[ok]
    if len(cells) == 0:
        return {name: (math.inf, lim)
                for name, lim in mix["check"]["limits"].items()}
    dist = run.column("dist")[ok]
    pick = traffic_mod.check_sample(len(cells), int(mix["check"]["cells"]),
                                    seed, must=int(np.argmax(dist)))
    values = reference.judge(cells[pick], run.column("r_star")[ok][pick],
                             run.column("capital")[ok][pick], cfg, device)
    return {name: (max(values[name]), float(lim))
            for name, lim in mix["check"]["limits"].items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    bench = Bench()
    chips = int(bench.workload(args.workload)["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"portbench: the cell asks for {chips} CUDA card(s); {have} "
              "available", file=sys.stderr)
        return 2
    result, checks, notes = run_cell(bench, args.workload, args.seed,
                                     args.seconds, bool(args.trace))
    # Read after the window, so that the query is no part of set-up.
    print(f"card: {power_limit()}", flush=True)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"portbench: {', '.join(loaded)} loaded in the benchmark's "
              "process; no result", file=sys.stderr)
        return 3
    for line in notes:
        print(line)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
