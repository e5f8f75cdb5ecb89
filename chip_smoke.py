#!/usr/bin/env python3
"""Drive the PyTorch port of the Table II equilibrium on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):
  1. card: name and power limit, TF32 off, build of the CUDA kernels
     (one nvcc per source, all started together);
  2. each kernel against its plain PyTorch version, both on the card, at
     the reference width (N=7, A=32, D=500), C=12 and C=1, float64 and
     float32: equal step counts and bitwise equal values, C=12 bitwise
     equal to twelve C=1 launches, each kernel's global-memory layout
     (force_global=True) bitwise equal to the shared-memory one it takes
     by default; kernel times with CUDA events, both layouts timed in
     turns, and the time per step of the slowest lane.  The
     fused kernel runs on the reference grid and, with its analytic tail,
     on the compact grid, and once more with no distribution step, which
     splits its EGM, transition and sort phases from its distribution
     phase;
  3. the reference path (kernel="reference"), float64: the 12-cell sweep
     at full width against tests/data/table2_golden.json, launch counters
     advanced;
  4. the reference path, float32: every cell within 1 bp of the golden;
  5. the fused path (kernel="fused"): the sweep in float64 (0.1 bp of the
     golden, all CONVERGED), float32 (1 bp) and on the compact grid in
     float64 (0.1 bp, all CONVERGED); only the fused kernel launched;
  6. where the float64 sweeps' time goes (torch.profiler), reference and
     fused;
  7. the fine configuration (A=1000, N=15, D=1000, float64): the EGM
     kernel in its cluster layout (the lane does not fit one block's
     shared memory) bitwise equal to its plain version, to its global
     layout and, at C=4, to four C=1 launches, both layouts timed in
     turns; the distribution kernel in its global layout, bitwise equal to
     its plain version;
  8. one cell with the full equilibrium objects (the single-lane entry:
     every launch has C=1), reference and fused, launch counters advanced.
Every phase line carries the card's name and power limit.  The line
before the last two holds the kernels' JSON record; then the card's name
and power limit from nvidia-smi; the last line is the result.
It needs one card and the repository beside it; it imports no JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "data", "table2_golden.json")
WIDTH = dict(a_count=32, dist_count=500)      # the paper's grid, 7 states
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
PEAK_FLOPS = {torch.float64: 34e12,           # FP64 outside the tensor cores
              torch.float32: 67e12}           # FP32 outside the tensor cores
# f64: the JAX kernel-parity tolerance.  f32: two runs of a contraction,
# each certified to within tol of its previous iterate with rate at most
# the accelerator's cap 0.995, lie within tol / (1 - 0.995) = 200 tol of
# each other.  Every kernel is also held bitwise to its plain version
# (same arithmetic, same summation order, pow built as torch.pow is);
# these tolerances report how far apart the two would be allowed to be.
F64_TOL = dict(rtol=1e-9, atol=1e-8)
INNER_TOL = {torch.float64: (1e-6, 1e-11), torch.float32: (1e-5, 1e-8)}
F32_SLACK = 200.0
REPLACES = {
    "egm_policy_grid": ("aiyagari_hark_tpu/ops/pallas_kernels.py:339",
                        "aiyagari_hark_tpu/ops/pallas_kernels.py:263"),
    "stationary_lottery_grid": (
        "aiyagari_hark_tpu/ops/pallas_kernels.py:169",
        "aiyagari_hark_tpu/ops/pallas_kernels.py:92"),
    "fused_cell_grid": ("aiyagari_hark_tpu/ops/pallas_kernels.py:613",
                        "aiyagari_hark_tpu/ops/pallas_kernels.py:531"),
}
# The fused path's JAX budget: r* within 0.1 bp of the golden
# (bench.py KERNEL_DRIFT_BUDGET_BP), also the compact grids' contract.
FUSED_BUDGET_PCT = 1e-3


CARD = ""                                     # nvidia-smi's name, power limit


def log(tag, **fields):
    """One JSON line per phase, with the card beside every number."""
    print(json.dumps({"phase": tag, **fields, "card": CARD}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of ``fn`` on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def paired_ms(fa, fb, reps: int = 5):
    """Mean milliseconds of ``fa`` and ``fb`` on the card, each timed twice
    by ``cuda_ms`` in turns (a, b, b, a)."""
    a1, b1, b2, a2 = (cuda_ms(fn, reps) for fn in (fa, fb, fb, fa))
    return (a1 + a2) / 2, (b1 + b2) / 2


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def close(a: torch.Tensor, b: torch.Tensor, dt, tol: float) -> float:
    """Max abs error of ``a`` against ``b``; raises beyond the tolerance."""
    a, b = a.double().cpu(), b.double().cpu()
    err = float((a - b).abs().max())
    if dt == torch.float64:
        ok = bool(((a - b).abs() <= F64_TOL["atol"]
                   + F64_TOL["rtol"] * b.abs()).all())
    else:
        ok = err <= F32_SLACK * tol
    if not ok:
        raise AssertionError(f"kernel and plain version disagree: max abs "
                             f"error {err} in {dt}")
    return err


def golden_cells(dt, dev, grid="reference"):
    """The 12 Table II cells as one lane-batched model, with the golden
    r* as each lane's price."""
    from aiyagari_hark_tpu_torch.models import firm
    from aiyagari_hark_tpu_torch.models.household import (build_simple_model,
                                                          stack_models)

    with open(GOLDEN) as f:
        g = json.load(f)
    model = stack_models([build_simple_model(labor_ar=rho, dtype=dt,
                                             device=dev, grid=grid, **WIDTH)
                          for rho in g["labor_ar"]])
    r = torch.tensor(g["r_star_pct"], dtype=dt, device=dev) / 100.0
    k_to_l = firm.k_to_l_from_r(r, 0.36, 0.08)
    W = firm.wage_rate(k_to_l, 0.36)
    crra = torch.tensor(g["crra"], dtype=dt, device=dev)
    return model, 1.0 + r, W, crra


def phase_kernels(dev):
    """Each kernel against its plain version; returns per-kernel records
    (measured at C=12, float64, the reference width)."""
    from aiyagari_hark_tpu_torch.models import household as H
    from aiyagari_hark_tpu_torch.ops import kernels as K

    records = {}
    for dt in (torch.float64, torch.float32):
        egm_tol, dist_tol = INNER_TOL[dt]
        model, R, W, crra = golden_cells(dt, dev)
        C = R.shape[0]
        p0 = H.initial_policy(model)
        sc = H._scalars(R, W, model, 0.96, crra)
        egm_args = (p0.m_knots, p0.c_knots, model.a_grid, model.labor_levels,
                    model.transition, sc, egm_tol)
        km, kc, kit, kdiff = K.egm_policy_grid(*egm_args)
        pm, pc, pit, pdiff = K.egm_policy_grid_plain(*egm_args)
        if not torch.equal(kit, pit):
            raise AssertionError(f"egm_policy_grid step counts differ from "
                                 f"the plain version in {dt}: "
                                 f"{kit.tolist()} vs {pit.tolist()}")
        err = max(close(km, pm, dt, egm_tol), close(kc, pc, dt, egm_tol))
        if not all(torch.equal(x, y) for x, y in ((km, pm), (kc, pc),
                                                 (kdiff, pdiff))):
            raise AssertionError(f"egm_policy_grid is not bitwise equal to "
                                 f"its plain version in {dt} (max abs "
                                 f"error {err})")
        for c in range(C):
            one = K.egm_policy_grid(*(t[c:c + 1] for t in egm_args[:6]),
                                    egm_tol)
            for x, y in zip(one, (km, kc, kit, kdiff)):
                if not torch.equal(x[0], y[c]):
                    raise AssertionError(f"egm_policy_grid lane {c}: C=1 is "
                                         f"not bitwise equal to C=12 ({dt})")
        N, A = model.labor_levels.shape[1], model.a_grid.shape[1]
        layout = K.egm_policy_grid_layout(N, A, dt)
        for x, y in zip(K.egm_policy_grid(*egm_args, force_global=True),
                        (km, kc, kit, kdiff)):
            if not torch.equal(x, y):
                raise AssertionError(f"egm_policy_grid: the global-memory "
                                     f"layout is not bitwise equal to the "
                                     f"{layout} one ({dt})")
        rec = dict(dtype=str(dt), ok=True, max_abs_err=err,
                   iters=kit.tolist(), bitwise_c1_c12=True,
                   bitwise_vs_plain=True, layout=layout,
                   bitwise_global_shared=True,
                   plain_ms=wall_ms(
                       lambda: K.egm_policy_grid_plain(*egm_args)))
        rec["kernel_ms"], rec["global_ms"] = paired_ms(
            lambda: K.egm_policy_grid(*egm_args),
            lambda: K.egm_policy_grid(*egm_args, force_global=True))
        steps = int(kit.max())         # the slowest lane sets the time
        rec["ns_per_step"] = 1e6 * rec["kernel_ms"] / steps
        rec["global_ns_per_step"] = 1e6 * rec["global_ms"] / steps
        rec["bound_ms"], rec["bound_by"] = egm_bound(dt, C, model, kit)
        c1 = int(kit.argmax())         # a single cell: the slowest lane
        one_args = tuple(t[c1:c1 + 1] for t in egm_args[:6]) + (egm_tol,)
        rec["c1_lane"] = c1
        rec["c1_ms"], rec["c1_global_ms"] = paired_ms(
            lambda: K.egm_policy_grid(*one_args),
            lambda: K.egm_policy_grid(*one_args, force_global=True))
        rec["c1_plain_ms"] = wall_ms(
            lambda: K.egm_policy_grid_plain(*one_args))
        rec["c1_bound_ms"] = egm_bound(dt, 1, model, kit[c1:c1 + 1])[0]
        records.setdefault("egm_policy_grid", []).append(rec)
        log("kernel", name="egm_policy_grid", **rec)

        pol = H.HouseholdPolicy(km, kc)
        trans = H.wealth_transition(pol, R, W, model)
        d0 = H.initial_distribution(model)
        dist_args = (trans.idx, trans.weight, model.transition, d0, dist_tol)
        kd, kit, kdiff = K.stationary_lottery_grid(*dist_args)
        # the plain version on the card: it sums each target in the
        # kernel's order, so the two agree bitwise
        t0 = time.perf_counter()
        pd, pit, pdiff = K.stationary_lottery_grid_plain(*dist_args)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        if not torch.equal(kit, pit):
            raise AssertionError(
                f"stationary_lottery_grid step counts differ from the plain "
                f"version in {dt}: {kit.tolist()} vs {pit.tolist()}")
        if not (torch.equal(kd, pd) and torch.equal(kdiff, pdiff)):
            raise AssertionError(f"stationary_lottery_grid is not bitwise "
                                 f"equal to its plain version in {dt}")
        err = close(kd, pd, dt, dist_tol)
        for c in range(C):
            one = K.stationary_lottery_grid(
                *(t[c:c + 1] for t in dist_args[:4]), dist_tol)
            for x, y in zip(one, (kd, kit, kdiff)):
                if not torch.equal(x[0], y[c]):
                    raise AssertionError(
                        f"stationary_lottery_grid lane {c}: C=1 is not "
                        f"bitwise equal to C=12 ({dt})")
        D, N = d0.shape[1:]
        layout = K.stationary_lottery_grid_layout(D, N, dt)
        glob = K.stationary_lottery_grid(*dist_args, force_global=True)
        for x, y in zip(glob, (kd, kit, kdiff)):
            if not torch.equal(x, y):
                raise AssertionError(
                    f"stationary_lottery_grid: the global-memory layout is "
                    f"not bitwise equal to the {layout} one ({dt})")
        rec = dict(dtype=str(dt), ok=True, max_abs_err=err,
                   iters=kit.tolist(), bitwise_c1_c12=True,
                   bitwise_vs_plain=True, layout=layout,
                   bitwise_global_shared=True, plain_ms=plain_ms)
        rec["kernel_ms"], rec["global_ms"] = paired_ms(
            lambda: K.stationary_lottery_grid(*dist_args),
            lambda: K.stationary_lottery_grid(*dist_args, force_global=True))
        steps = int(kit.max())         # the slowest lane sets the time
        rec["ns_per_step"] = 1e6 * rec["kernel_ms"] / steps
        rec["global_ns_per_step"] = 1e6 * rec["global_ms"] / steps
        rec["bound_ms"], rec["bound_by"] = dist_bound(dt, C, model, kit)
        c1 = int(kit.argmax())
        one_args = tuple(t[c1:c1 + 1] for t in dist_args[:4]) + (dist_tol,)
        rec["c1_lane"] = c1
        rec["c1_ms"], rec["c1_global_ms"] = paired_ms(
            lambda: K.stationary_lottery_grid(*one_args),
            lambda: K.stationary_lottery_grid(*one_args, force_global=True))
        rec["c1_plain_ms"] = wall_ms(
            lambda: K.stationary_lottery_grid_plain(*one_args))
        rec["c1_bound_ms"] = dist_bound(dt, 1, model, kit[c1:c1 + 1])[0]
        records.setdefault("stationary_lottery_grid", []).append(rec)
        log("kernel", name="stationary_lottery_grid", **rec)
        for grid in ("reference", "compact"):
            records.setdefault("fused_cell_grid", []).append(
                fused_kernel_check(dev, dt, grid))
    return records


def fused_kernel_check(dev, dt, grid):
    """The fused kernel against its plain version on the card, on the 12
    golden cells at the golden r*: the reference grid (tail off) or the
    compact grid (analytic tail on)."""
    from aiyagari_hark_tpu_torch.models import household as H
    from aiyagari_hark_tpu_torch.ops import kernels as K

    egm_tol, dist_tol = INNER_TOL[dt]
    tail = grid == "compact"
    model, R, W, crra = golden_cells(dt, dev, grid)
    C = R.shape[0]
    p0 = H.initial_policy(model, analytic_tail=tail)
    sc = H._scalars(R, W, model, 0.96, crra)
    h = (H.perfect_foresight_human_wealth(R, W, model.labor_levels,
                                          model.transition)
         if tail else torch.zeros_like(model.labor_levels))
    args = (p0.m_knots, p0.c_knots, model.a_grid, model.dist_grid,
            model.labor_levels, model.transition, sc, h,
            H.initial_distribution(model))
    kw = dict(tol=egm_tol, dist_tol=dist_tol, tail=tail)
    out = K.fused_cell_grid(*args, **kw)
    t0 = time.perf_counter()
    ref = K.fused_cell_grid_plain(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    km, kc, kd, keit, _, kdit, _ = out
    for name, a, b in (("EGM", keit, ref[3]), ("distribution", kdit, ref[5])):
        if not torch.equal(a, b):
            raise AssertionError(f"fused_cell_grid {name} step counts differ "
                                 f"from the plain version ({dt}, {grid}): "
                                 f"{a.tolist()} vs {b.tolist()}")
    err = max(close(km, ref[0], dt, egm_tol), close(kc, ref[1], dt, egm_tol),
              close(kd, ref[2], dt, dist_tol))
    if not all(torch.equal(x, y) for x, y in zip(out, ref)):
        raise AssertionError(f"fused_cell_grid is not bitwise equal to its "
                             f"plain version ({dt}, {grid}; max abs error "
                             f"{err})")
    for c in range(C):
        one = K.fused_cell_grid(*(t[c:c + 1] for t in args), **kw)
        for x, y in zip(one, out):
            if not torch.equal(x[0], y[c]):
                raise AssertionError(f"fused_cell_grid lane {c}: C=1 is not "
                                     f"bitwise equal to C=12 ({dt}, {grid})")
    N, K_ = km.shape[1:]
    D = kd.shape[1]
    A = model.a_grid.shape[1]
    layout = K.fused_cell_grid_layout(N, A, D, tail, dt)
    for x, y in zip(K.fused_cell_grid(*args, **kw, force_global=True), out):
        if not torch.equal(x, y):
            raise AssertionError(f"fused_cell_grid: the global-memory layout "
                                 f"is not bitwise equal to the {layout} one "
                                 f"({dt}, {grid})")
    rec = dict(dtype=str(dt), grid=grid, tail=tail, ok=True,
               max_abs_err=err, egm_iters=keit.tolist(),
               dist_iters=kdit.tolist(), bitwise_c1_c12=True,
               bitwise_vs_plain=True,
               layout=layout, bitwise_global_shared=True,
               knots=(N, K_), dist_points=D, plain_ms=plain_ms)
    rec["kernel_ms"], rec["global_ms"] = paired_ms(
        lambda: K.fused_cell_grid(*args, **kw),
        lambda: K.fused_cell_grid(*args, **kw, force_global=True))
    # the EGM, transition and sort phases alone: no distribution step
    rec["no_dist_ms"] = cuda_ms(
        lambda: K.fused_cell_grid(*args, **kw, dist_max_iter=0))
    steps = int(kdit.max())            # the slowest lane's loop
    rec["ns_per_step"] = 1e6 * rec["kernel_ms"] / steps
    rec["dist_ns_per_step"] = 1e6 * (rec["kernel_ms"]
                                     - rec["no_dist_ms"]) / steps
    rec["global_ns_per_step"] = 1e6 * rec["global_ms"] / steps
    rec["bound_ms"], rec["bound_by"] = fused_bound(dt, C, model, keit, kdit,
                                                   tail)
    c1 = int((keit + kdit).argmax())   # a single cell: the slowest lane
    one_args = tuple(t[c1:c1 + 1] for t in args)
    rec["c1_lane"] = c1
    rec["c1_ms"], rec["c1_global_ms"] = paired_ms(
        lambda: K.fused_cell_grid(*one_args, **kw),
        lambda: K.fused_cell_grid(*one_args, **kw, force_global=True))
    rec["c1_plain_ms"] = wall_ms(lambda: K.fused_cell_grid_plain(*one_args,
                                                                 **kw))
    rec["c1_bound_ms"] = fused_bound(dt, 1, model, keit[c1:c1 + 1],
                                     kdit[c1:c1 + 1], tail)[0]
    log("kernel", name="fused_cell_grid", **rec)
    return rec


def _bound(dt, nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dt]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def egm_work(dt, C, model, iters, K=None):
    """(bytes, operations) of the EGM fixed points of this run: inputs
    read once, outputs written once; per step and lane, per (state,
    asset) pair 3 flops for m', ~log2(K) compares and 5 flops of
    interpolation, a pow, 2N-1 for the expectation, a pow and 2 more; 4
    per knot for the sup-norm; every 32nd step 8 more per knot (dot
    products and extrapolation).  A pow counts as one operation."""
    s = torch.finfo(dt).bits // 8
    N = model.labor_levels.shape[1]
    A = model.a_grid.shape[1]
    K = A + 1 if K is None else K
    nbytes = C * (s * (2 * N * K + A + N + N * N + 5) + s * 2 * N * K + 4 + s)
    per_step = (N * A * (3 + math.log2(K) + 5 + 1 + (2 * N - 1) + 3)
                + 4 * N * K + 8 * N * K / 32)
    return nbytes, per_step * float(iters.sum())


def dist_work(dt, C, model, iters):
    """(bytes, operations) of the distribution fixed points of this run:
    inputs (int64 index, weight, P, dist0) read once, outputs written
    once; per step and lane 4 D N flops of lottery, D N (2N-1) of labor
    mix, 2 D N for the sup-norm, and every 64th step 10 D N more."""
    s = torch.finfo(dt).bits // 8
    N = model.labor_levels.shape[1]
    D = model.dist_grid.shape[1]
    dn = D * N
    nbytes = C * (8 * dn + s * dn + s * N * N + s * dn + s * dn + 4 + s)
    per_step = dn * (4 + (2 * N - 1) + 2) + 10 * dn / 64
    return nbytes, per_step * float(iters.sum())


def egm_bound(dt, C, model, iters):
    return _bound(dt, *egm_work(dt, C, model, iters))


def dist_bound(dt, C, model, iters):
    return _bound(dt, *dist_work(dt, C, model, iters))


def fused_bound(dt, C, model, egm_iters, dist_iters, tail):
    """Least time for the fused supply evaluations of this run: the EGM
    and distribution operations above on this run's steps, plus per lane
    the transition's D N interpolations (3 flops for m, ~log2(K) and
    ~log2(D) compares, 5 of interpolation, 2 clamps, 3 for the weight);
    bytes: the fused inputs (knots [N, K], a, the support [D], levels,
    P, scalars, h, dist0) read once and its outputs (knots, dist, four
    statistics) written once."""
    s = torch.finfo(dt).bits // 8
    N = model.labor_levels.shape[1]
    A = model.a_grid.shape[1]
    D = model.dist_grid.shape[1]
    K = A + (3 if tail else 1)
    ops = (egm_work(dt, C, model, egm_iters, K)[1]
           + dist_work(dt, C, model, dist_iters)[1]
           + C * D * N * (3 + math.log2(K) + math.log2(D) + 5 + 2 + 3))
    nbytes = C * (s * (2 * N * K + A + D + N + N * N + 5 + N + D * N)
                  + s * (2 * N * K + D * N) + 2 * 4 + 2 * s)
    return _bound(dt, nbytes, ops)


def fused_over_parts(records):
    """Per dtype, the fused kernel's C=12 time on the reference grid over
    the EGM plus the distribution kernel's, all from this run."""
    out = {}
    for f in records["fused_cell_grid"]:
        if f["grid"] != "reference":
            continue
        dt = f["dtype"]
        parts = sum(next(r["kernel_ms"] for r in records[name]
                         if r["dtype"] == dt)
                    for name in ("egm_policy_grid", "stationary_lottery_grid"))
        out[dt] = f["kernel_ms"] / parts
    return out


PATH_KERNELS = {"reference": ("egm_policy_grid", "stationary_lottery_grid"),
                "fused": ("fused_cell_grid",)}


def phase_sweep(dt, dev, golden, kernel="reference", grid="reference"):
    """One sweep of a path, its launch counters set to 0 just before it
    and read just after: every kernel of the path launched, no other."""
    from aiyagari_hark_tpu_torch.ops import kernels as K
    from aiyagari_hark_tpu_torch.parallel.sweep import run_table2_sweep
    from aiyagari_hark_tpu_torch.solver_health import status_name

    K.reset_launches()
    res = run_table2_sweep(dtype=dt, device=dev, kernel=kernel, grid=grid,
                           **WIDTH)
    launches = dict(K.LAUNCHES)
    for name, n in launches.items():
        if (n > 0) != (name in PATH_KERNELS[kernel]):
            raise AssertionError(f"the {dt} {kernel}/{grid} sweep launched "
                                 f"{name} {n} times")
    dr = res.r_star_pct - golden["r_star_pct"]
    ds = res.saving_rate_pct - golden["saving_rate_pct"]
    statuses = [status_name(s) for s in res.status]
    log("sweep", dtype=str(dt), kernel=kernel, grid=grid,
        wall_s=res.wall_seconds, launches=launches,
        r_star_pct=res.r_star_pct.tolist(), max_abs_dr_pct=float(
            abs(dr).max()), max_abs_dsave_pct=float(abs(ds).max()),
        status=statuses, bisect_iters=res.bisect_iters.tolist(),
        egm_iters=res.egm_iters.tolist(), dist_iters=res.dist_iters.tolist(),
        sum_egm_iters=int(res.egm_iters.sum()),
        sum_dist_iters=int(res.dist_iters.sum()))
    if kernel == "fused" and dt == torch.float64:
        if not abs(dr).max() < FUSED_BUDGET_PCT:
            raise AssertionError(f"f64 fused {grid} sweep is "
                                 f"{abs(dr).max()} pct from the golden, "
                                 f"above 0.1 bp")
        if any(s != "CONVERGED" for s in statuses):
            raise AssertionError(f"f64 fused sweep statuses {statuses}")
    elif dt == torch.float64:
        if not (abs(dr).max() <= 1e-6 and abs(ds).max() <= 1e-4):
            raise AssertionError(f"f64 sweep misses the golden: max |dr*| "
                                 f"{abs(dr).max()} pct, max |ds| "
                                 f"{abs(ds).max()} pct")
        if any(s != "CONVERGED" for s in statuses):
            raise AssertionError(f"f64 sweep statuses {statuses}")
    else:
        if not abs(dr).max() <= 0.01:
            raise AssertionError(f"f32 sweep is {abs(dr).max()} pct from "
                                 f"the golden, above 1 bp")
        if any(s in ("MAX_ITER", "NONFINITE") for s in statuses):
            raise AssertionError(f"f32 sweep statuses {statuses}")
    return launches, res.wall_seconds


def phase_profile(dev, kernel="reference"):
    """Where the f64 sweep's time goes: one more run under torch.profiler,
    device time by kernel against the wall (idle share = 1 - busy/wall).
    Reports "not measured" where the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    from aiyagari_hark_tpu_torch.parallel.sweep import run_table2_sweep

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        res = run_table2_sweep(dtype=torch.float64, device=dev,
                               kernel=kernel, **WIDTH)
    by_name = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type):
            by_name[ev.key] = by_name.get(ev.key, 0.0) + t / 1e3
    busy = sum(by_name.values())
    wall_ms = 1e3 * res.wall_seconds
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log("profile", dtype="torch.float64", kernel=kernel, wall_ms=wall_ms,
        device_busy_ms=busy if busy else "not measured",
        idle_share=(1.0 - busy / wall_ms) if busy else "not measured",
        top_device_ms={k[:60]: v for k, v in top},
        note="profiled run; its wall includes the profiler's cost")


def phase_fine(dev):
    """The fine configuration (A=1000, N=15, D=1000), float64.  The EGM
    lane (851 KB as one block) must take the cluster layout; on one cell
    it matches its plain version bitwise and its global layout
    (force_global) bitwise, both layouts timed in turns; at C=4 (four
    prices) one launch equals four C=1 launches bitwise.  The distribution
    kernel, on that policy, takes its global layout (420 KB of lottery
    alone) and matches its plain version bitwise, both on the card.
    Returns the EGM record."""
    from aiyagari_hark_tpu_torch.models import firm
    from aiyagari_hark_tpu_torch.models import household as H
    from aiyagari_hark_tpu_torch.ops import kernels as K

    dt = torch.float64
    N, A = 15, 1000
    base = H.build_simple_model(labor_states=N, a_count=A, dist_count=1000,
                                labor_ar=0.6, dtype=dt, device=dev)
    model1 = H.stack_models([base])
    model = H.stack_models([base] * 4)
    r = torch.tensor([0.04, 0.03, 0.035, 0.045], dtype=dt, device=dev)
    R, W = 1.0 + r, firm.wage_rate(firm.k_to_l_from_r(r, 0.36, 0.08), 0.36)
    p0 = H.initial_policy(model)
    args4 = (p0.m_knots, p0.c_knots, model.a_grid, model.labor_levels,
             model.transition, H._scalars(R, W, model, 0.96, 3.0))
    args = tuple(t[:1] for t in args4) + (1e-6,)
    layout = K.egm_policy_grid_layout(N, A, dt)
    if layout != "cluster":
        raise AssertionError(f"the fine EGM lane takes the {layout} layout, "
                             f"not the cluster one")
    lib = K._library("egm_policy_grid")
    m, c, eit, ediff = out = K.egm_policy_grid(*args)
    pm, pc, pit, pdiff = K.egm_policy_grid_plain(*args)
    if not torch.equal(eit, pit):
        raise AssertionError(f"fine egm_policy_grid step counts "
                             f"{eit.tolist()} vs plain {pit.tolist()}")
    egm_err = max(close(m, pm, dt, 1e-6), close(c, pc, dt, 1e-6))
    if not all(torch.equal(x, y) for x, y in zip(out, (pm, pc, pit, pdiff))):
        raise AssertionError(f"fine egm_policy_grid is not bitwise equal to "
                             f"its plain version (max abs error {egm_err})")
    if not all(torch.equal(x, y) for x, y in zip(
            K.egm_policy_grid(*args, force_global=True), out)):
        raise AssertionError("fine egm_policy_grid: the cluster layout is "
                             "not bitwise equal to the global one")
    four = K.egm_policy_grid(*args4, 1e-6)
    for lane in range(4):
        one = K.egm_policy_grid(*(t[lane:lane + 1] for t in args4), 1e-6)
        if not all(torch.equal(x[0], y[lane]) for x, y in zip(one, four)):
            raise AssertionError(f"fine egm_policy_grid lane {lane}: C=1 is "
                                 f"not bitwise equal to C=4")
    steps = int(eit.max())
    egm = dict(N=N, A=A, layout=layout, cluster_blocks=int(
                   lib.egm_policy_grid_cluster_blocks(N)),
               workspace_bytes=int(lib.egm_policy_grid_workspace_bytes(
                   N, A, 1)),
               cluster_block_bytes=int(lib.egm_policy_grid_cluster_bytes(
                   N, A, 1)),
               iters=eit.tolist(), diff=float(ediff[0]),
               max_abs_err=egm_err, bitwise_vs_plain=True,
               bitwise_global_cluster=True, bitwise_c1_c4=True,
               c4_iters=four[2].tolist())
    egm["kernel_ms"], egm["global_ms"] = paired_ms(
        lambda: K.egm_policy_grid(*args),
        lambda: K.egm_policy_grid(*args, force_global=True), reps=3)
    egm["ns_per_step"] = 1e6 * egm["kernel_ms"] / steps
    egm["global_ns_per_step"] = 1e6 * egm["global_ms"] / steps
    egm["c4_ms"] = cuda_ms(lambda: K.egm_policy_grid(*args4, 1e-6), reps=3)
    egm["plain_ms"] = wall_ms(lambda: K.egm_policy_grid_plain(*args))
    egm["bound_ms"], egm["bound_by"] = egm_bound(dt, 1, model1, eit)
    log("fine_egm", **egm)

    trans = H.wealth_transition(H.HouseholdPolicy(m, c), R[:1], W[:1],
                                model1)
    dargs = (trans.idx, trans.weight, model1.transition,
             H.initial_distribution(model1), 1e-11)
    dlayout = K.stationary_lottery_grid_layout(1000, N, dt)
    if dlayout != "global":
        raise AssertionError(f"the fine distribution lane takes the "
                             f"{dlayout} layout: this phase would not test "
                             f"the global one")
    kd, kit, kdiff = K.stationary_lottery_grid(*dargs)
    t0 = time.perf_counter()
    pd, pit, pdiff = K.stationary_lottery_grid_plain(*dargs)
    torch.cuda.synchronize()
    dist_plain_ms = 1e3 * (time.perf_counter() - t0)
    if not torch.equal(kit, pit):
        raise AssertionError(f"fine stationary_lottery_grid step counts "
                             f"{kit.tolist()} vs plain {pit.tolist()}")
    if not (torch.equal(kd, pd) and torch.equal(kdiff, pdiff)):
        raise AssertionError("fine stationary_lottery_grid is not bitwise "
                             "equal to its plain version")
    log("fine", stationary_lottery_grid="ran", layout=dlayout,
        iters=kit.tolist(), bitwise_vs_plain=True,
        dist_plain_ms=dist_plain_ms,
        kernel_ms=cuda_ms(lambda: K.stationary_lottery_grid(*dargs), reps=2))
    return egm


def phase_cell(dev, golden, kernel="reference"):
    """One unbatched cell (the single-lane entry, C=1 launches); returns
    the launch counts of its solve."""
    from aiyagari_hark_tpu_torch.models.equilibrium import solve_calibration
    from aiyagari_hark_tpu_torch.ops import kernels as K
    from aiyagari_hark_tpu_torch.solver_health import status_name

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    eq = solve_calibration(3.0, 0.6, dtype=torch.float64, device=dev,
                           kernel=kernel, **WIDTH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    # (sigma=3, rho=0.6).  solve_calibration solves every midpoint from
    # the cold start while the golden's lean path warm-starts, so the
    # inner tolerances place the root differently, by far less than
    # 1e-4 pct (0.01 bp); the fused path's budget is 0.1 bp
    ref = golden["r_star_pct"][6]
    budget = 1e-4 if kernel == "reference" else FUSED_BUDGET_PCT
    r_pct = 100.0 * float(eq.r_star)
    shapes = (tuple(eq.policy.m_knots.shape), tuple(eq.distribution.shape))
    ok = (shapes == ((7, 33), (500, 7))
          and bool(torch.isfinite(eq.policy.c_knots).all())
          and abs(float(eq.distribution.sum()) - 1.0) < 1e-9
          and math.isfinite(float(eq.excess))
          and abs(float(eq.excess)) < 1e-6
          and abs(r_pct - ref) <= budget
          and status_name(eq.status) == "CONVERGED"
          and all((n > 0) == (name in PATH_KERNELS[kernel])
                  for name, n in launches.items()))
    log("cell", kernel=kernel, sigma=3.0, rho=0.6, r_star_pct=r_pct,
        golden_pct=ref,
        excess=float(eq.excess), saving_rate=float(eq.saving_rate),
        bisect_iters=int(eq.bisect_iters), status=status_name(eq.status),
        policy_shape=shapes[0], dist_shape=shapes[1], wall_s=wall,
        launches=launches)
    if not ok:
        raise AssertionError("the one-cell solve failed its checks")
    return launches


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from aiyagari_hark_tpu_torch.device import resolve_device
    from aiyagari_hark_tpu_torch.ops import kernels as K

    dev = resolve_device("cuda")
    card = CARD = card_line()
    log("card", name=torch.cuda.get_device_name(0),
        torch=torch.__version__, cuda=torch.version.cuda,
        allow_tf32=[torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32])
    build_s = K.build_libraries()
    log("build", seconds=build_s)
    for name, text in K.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    records = phase_kernels(dev)
    with open(GOLDEN) as f:
        golden = json.load(f)
    # each path: counters set to 0 just before its run, read just after
    launches, wall64 = phase_sweep(torch.float64, dev, golden)
    launches32, wall32 = phase_sweep(torch.float32, dev, golden)
    f_launches, f_wall64 = phase_sweep(torch.float64, dev, golden, "fused")
    f_launches32, f_wall32 = phase_sweep(torch.float32, dev, golden,
                                         "fused")
    c_launches, c_wall64 = phase_sweep(torch.float64, dev, golden, "fused",
                                       "compact")
    phase_profile(dev)
    phase_profile(dev, "fused")
    fine_egm = phase_fine(dev)
    launches_c1 = phase_cell(dev, golden)
    launches_c1.update({k: v for k, v in phase_cell(dev, golden,
                                                    "fused").items() if v})
    for name in PATH_KERNELS["fused"]:
        launches[name] = f_launches[name]
        launches32[name] = f_launches32[name]

    kernels = []
    for name, recs in records.items():
        r64 = next(r for r in recs if r["dtype"] == "torch.float64")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"aiyagari_hark_tpu_torch/ops/csrc/{K.SOURCES[name]}",
            "replaces": REPLACES[name][0],
            "replaces_single_lane": REPLACES[name][1],
            "launches": launches[name], "launches_f32": launches32[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": r64["kernel_ms"], "plain_ms": r64["plain_ms"],
            "bound_ms": r64["bound_ms"], "bound_by": r64["bound_by"],
            "library_ms": None, "ok": all(r["ok"] for r in recs),
            "iters": r64.get("iters", r64.get("dist_iters")),
            "kernel_ms": r64["kernel_ms"],
            "c1_ms": r64["c1_ms"], "c1_plain_ms": r64["c1_plain_ms"],
            "c1_bound_ms": r64["c1_bound_ms"],
            "c1_launches": launches_c1[name],
            "layout": r64.get("layout", "shared"),
            "global_ms": r64.get("global_ms"),
            "ns_per_step": r64.get("ns_per_step"),
            "no_dist_ms": r64.get("no_dist_ms"),
            "variants": recs[1:],
            "shape": "C=12, N=7, A=32, D=500, float64",
        })
    kernels[0]["fine"] = fine_egm
    kernels[-1]["launches_compact_f64"] = c_launches["fused_cell_grid"]
    kernels[-1]["over_egm_plus_dist"] = fused_over_parts(records)
    print(json.dumps({"kernels": kernels, "sweep_wall_s": {
        "float64": wall64, "float32": wall32, "fused_float64": f_wall64,
        "fused_float32": f_wall32, "fused_compact_float64": c_wall64},
        "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
