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
  5b. the ladders: the EGM kernel's tail mode (the compact grid, A=28,
     and its coarse subset, A=15; float64 and float32) bitwise equal to
     its plain version, to its global layout and, at C=12, to twelve C=1
     launches, timed as in phase 2; the precision ladder escalating some
     lanes on the card (each escalated lane bitwise a direct reference
     launch from the caller's iterate, the others unchanged), and the
     descent fault drill refused on CUDA tensors; sweeps in float64 under
     precision="mixed" (0.25 bp of the golden, at most 2 escalations),
     "fast" (5 bp, no polish step), "mixed" under kernel="fused" (0.25 bp,
     only the reference kernels launched), grid="compact" under
     kernel="reference" (0.1 bp, all CONVERGED), and "mixed" in float32
     (1 bp); each with its launch set checked;
  6. where the float64 sweeps' time goes (torch.profiler), reference and
     fused;
  7. the fine configuration (A=1000, N=15, D=1000, float64): the EGM
     kernel in its cluster layout (the lane does not fit one block's
     shared memory) bitwise equal to its plain version, to its global
     layout and, at C=4, to four C=1 launches, both layouts timed in
     turns; the distribution kernel in its global layout, bitwise equal to
     its plain version;
  8. one cell with the full equilibrium objects (the single-lane entry:
     every launch has C=1), reference, fused and precision="mixed",
     launch counters advanced; one lean cell by root_method="illinois"
     (0.01 bp of the golden);
  9. the sweep engine (float64, full width), each run's launches counted:
     run_table2_sweep(SweepConfig()) takes the locked path, with phase
     3's rows bit for bit and its launches; schedule="balanced" bitwise
     the locked rows (reference kernels, and the fused kernel against
     phase 5's fused sweep), with its buckets and wall; warm brackets
     within 1e-6 pct of the golden in fewer bisection trips, its wall
     against locked in turns; a NaN injected into cell 2 from its second
     trip, recovered by the first quarantine rung with the other cells
     bitwise unchanged (reference and fused kernels; the rung runs the
     reference kernels); a full SDC recheck of a clean sweep finding no
     suspect, and with bit 30 of cell 1's r* flipped, exactly that cell
     suspected and recovered; certify=True grading every CONVERGED cell
     CERTIFIED (its wall and peak device memory), and the grade of cell
     (sigma=5, rho=0) under precision="mixed";
 10. the Huggett and Epstein-Zin families (float64, full width, 12 cells
     each; tests/data/torch_families_golden.json from the JAX package):
     the EGM and lottery kernels at borrow_limit=-2 on the Huggett cells
     at their golden r* (float64 and float32), bitwise their plain
     versions, twelve C=1 launches and their global layouts, timed; the
     Epstein-Zin policy loop (plain PyTorch) alone, its steps, wall and
     host syncs; run_sweep("huggett") within 1e-6 pct of the golden, all
     CONVERGED, below the autarky rate with borrowers, in float32 within
     1 bp and balanced bitwise locked; run_sweep("epstein_zin", gamma in
     {3, 5, 8}, ez_rho=3) within 1e-6 pct, its gamma = 3 column within
     5e-4 in r of Table II's sigma = 3 column, no EGM kernel launched;
     per family a NaN cell recovered by quarantine (the others bitwise
     unchanged), a clean full recheck, certification (CERTIFIED or
     MARGINAL), each run's launches counted.
 11. the notebook's Krusell-Smith path (float64, the notebook's width:
     notebook_run_configs(), AgentCount=350, a_count=32, the default
     M-grid, act_T=11000, dist_count=500; tests/data/torch_ks_golden.json
     from the JAX package): AiyagariEconomy.solve(sim_method=
     "distribution") on JAX's chain against the golden (outer iterations
     equal, AFunc, r*, saving rate and den Haan within KS_TOL); the same
     solve interrupted after outer iteration 2 by the interrupt guard and
     resumed from its checkpoint, its final rule and history bitwise the
     uninterrupted run's; float32 (r* within 1 bp of the golden, its gap
     to JAX's float32); the panel engine (seed 1, make_Mrkv_history,
     solve()) converged with r* within 0.2 pp of the golden's; a true-KS
     panel's employment counts bitwise the exact-count recursion; the
     panel at the wealth study's fixed rule inside |z| <= 3 of its
     32-seed band; launches per period and the device's idle share under
     torch.profiler; the host syncs of each outer iteration (the f64
     histogram and the panel solves run under the sync debug mode).
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
import warnings

import numpy as np
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
    records = {}
    for dt in (torch.float64, torch.float32):
        model, R, W, crra = golden_cells(dt, dev)
        egm, dist = kernel_pair_check(dev, dt, model, R, W, crra)
        records.setdefault("egm_policy_grid", []).append(egm)
        records.setdefault("stationary_lottery_grid", []).append(dist)
        for coarse in (False, True):
            records["egm_policy_grid"].append(
                egm_tail_check(dev, dt, coarse))
        for grid in ("reference", "compact"):
            records.setdefault("fused_cell_grid", []).append(
                fused_kernel_check(dev, dt, grid))
    return records


def kernel_pair_check(dev, dt, model, R, W, crra, **tag):
    """The EGM kernel, then the lottery kernel on its policy, each against
    its plain version on the lanes of ``model`` at prices (R, W), cold
    start: equal step counts and bitwise equal values, C lanes bitwise
    equal to C launches of one lane, the default layout bitwise equal to
    the global one; times with CUDA events (both layouts in turns), per
    step of the slowest lane, of the slowest lane alone, and the plain
    versions' walls.  ``tag`` goes into both records and the log lines.
    Returns the two records."""
    from aiyagari_hark_tpu_torch.models import household as H
    from aiyagari_hark_tpu_torch.ops import kernels as K

    egm_tol, dist_tol = INNER_TOL[dt]
    C = R.shape[0]
    p0 = H.initial_policy(model)
    sc = H._scalars(R, W, model, 0.96, crra)
    egm_args = (p0.m_knots, p0.c_knots, model.a_grid, model.labor_levels,
                model.transition, sc, egm_tol)
    km, kc, kit, kdiff = K.egm_policy_grid(*egm_args)
    pm, pc, pit, pdiff = K.egm_policy_grid_plain(*egm_args)
    if not torch.equal(kit, pit):
        raise AssertionError(f"egm_policy_grid step counts differ from "
                             f"the plain version in {dt} {tag}: "
                             f"{kit.tolist()} vs {pit.tolist()}")
    err = max(close(km, pm, dt, egm_tol), close(kc, pc, dt, egm_tol))
    if not all(torch.equal(x, y) for x, y in ((km, pm), (kc, pc),
                                             (kdiff, pdiff))):
        raise AssertionError(f"egm_policy_grid is not bitwise equal to "
                             f"its plain version in {dt} {tag} (max abs "
                             f"error {err})")
    for c in range(C):
        one = K.egm_policy_grid(*(t[c:c + 1] for t in egm_args[:6]),
                                egm_tol)
        for x, y in zip(one, (km, kc, kit, kdiff)):
            if not torch.equal(x[0], y[c]):
                raise AssertionError(f"egm_policy_grid lane {c}: C=1 is "
                                     f"not bitwise equal to C={C} ({dt} "
                                     f"{tag})")
    N, A = model.labor_levels.shape[1], model.a_grid.shape[1]
    layout = K.egm_policy_grid_layout(N, A, dt)
    for x, y in zip(K.egm_policy_grid(*egm_args, force_global=True),
                    (km, kc, kit, kdiff)):
        if not torch.equal(x, y):
            raise AssertionError(f"egm_policy_grid: the global-memory "
                                 f"layout is not bitwise equal to the "
                                 f"{layout} one ({dt} {tag})")
    rec = dict(dtype=str(dt), **tag, ok=True, max_abs_err=err,
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
    log("kernel", name="egm_policy_grid", **rec)
    egm_rec = rec

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
            f"version in {dt} {tag}: {kit.tolist()} vs {pit.tolist()}")
    if not (torch.equal(kd, pd) and torch.equal(kdiff, pdiff)):
        raise AssertionError(f"stationary_lottery_grid is not bitwise "
                             f"equal to its plain version in {dt} {tag}")
    err = close(kd, pd, dt, dist_tol)
    for c in range(C):
        one = K.stationary_lottery_grid(
            *(t[c:c + 1] for t in dist_args[:4]), dist_tol)
        for x, y in zip(one, (kd, kit, kdiff)):
            if not torch.equal(x[0], y[c]):
                raise AssertionError(
                    f"stationary_lottery_grid lane {c}: C=1 is not "
                    f"bitwise equal to C={C} ({dt} {tag})")
    D, N = d0.shape[1:]
    layout = K.stationary_lottery_grid_layout(D, N, dt)
    glob = K.stationary_lottery_grid(*dist_args, force_global=True)
    for x, y in zip(glob, (kd, kit, kdiff)):
        if not torch.equal(x, y):
            raise AssertionError(
                f"stationary_lottery_grid: the global-memory layout is "
                f"not bitwise equal to the {layout} one ({dt} {tag})")
    rec = dict(dtype=str(dt), **tag, ok=True, max_abs_err=err,
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
    log("kernel", name="stationary_lottery_grid", **rec)
    return egm_rec, rec


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


def egm_tail_check(dev, dt, coarse: bool):
    """The EGM kernel's tail mode against its plain version on the card,
    on the 12 golden cells at the golden r*: the compact grid (A=28) or
    the grid ladder's coarse subset of it (A=15), each iterate closed by
    the analytic tail (K = A+3 knots).  Bitwise equal to the plain
    version, to its global layout and, at C=12, to twelve C=1 launches;
    the lane must not take the cluster layout."""
    from aiyagari_hark_tpu_torch.models import household as H
    from aiyagari_hark_tpu_torch.ops import kernels as K

    egm_tol = INNER_TOL[dt][0]
    model, R, W, crra = golden_cells(dt, dev, "compact")
    p0 = H.initial_policy(model, analytic_tail=True)
    if coarse:
        idx = H._coarse_knot_indices(model.a_grid.shape[1])
        model = model._replace(a_grid=model.a_grid[:, idx])
        p0 = H._restrict_policy(p0, idx)
    C, N = model.labor_levels.shape
    A = model.a_grid.shape[1]
    sc = H._scalars(R, W, model, 0.96, crra)
    h = H.perfect_foresight_human_wealth(R, W, model.labor_levels,
                                         model.transition)
    args = (p0.m_knots, p0.c_knots, model.a_grid, model.labor_levels,
            model.transition, sc, egm_tol)
    kw = dict(h=h, tail=True)
    out = K.egm_policy_grid(*args, **kw)
    t0 = time.perf_counter()
    ref = K.egm_policy_grid_plain(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    tag = f"{dt}, A={A}"
    if not torch.equal(out[2], ref[2]):
        raise AssertionError(f"egm_policy_grid tail mode step counts differ "
                             f"from the plain version ({tag}): "
                             f"{out[2].tolist()} vs {ref[2].tolist()}")
    err = max(close(out[0], ref[0], dt, egm_tol),
              close(out[1], ref[1], dt, egm_tol))
    if not all(torch.equal(x, y) for x, y in zip(out, ref)):
        raise AssertionError(f"egm_policy_grid tail mode is not bitwise "
                             f"equal to its plain version ({tag}; max abs "
                             f"error {err})")
    for c in range(C):
        one = K.egm_policy_grid(*(t[c:c + 1] for t in args[:6]), egm_tol,
                                h=h[c:c + 1], tail=True)
        if not all(torch.equal(x[0], y[c]) for x, y in zip(one, out)):
            raise AssertionError(f"egm_policy_grid tail mode lane {c}: C=1 "
                                 f"is not bitwise equal to C=12 ({tag})")
    layout = K.egm_policy_grid_layout(N, A, dt, tail=True)
    if layout == "cluster":
        raise AssertionError("egm_policy_grid took the cluster layout with a "
                             "tail")
    for x, y in zip(K.egm_policy_grid(*args, **kw, force_global=True), out):
        if not torch.equal(x, y):
            raise AssertionError(f"egm_policy_grid tail mode: the global "
                                 f"layout is not bitwise equal to the "
                                 f"{layout} one ({tag})")
    rec = dict(dtype=str(dt), grid="compact", tail=True,
               ladder_phase="coarse" if coarse else "fine", knots=(N, A + 3),
               ok=True, max_abs_err=err, iters=out[2].tolist(),
               bitwise_c1_c12=True, bitwise_vs_plain=True, layout=layout,
               bitwise_global_shared=True, plain_ms=plain_ms)
    rec["kernel_ms"], rec["global_ms"] = paired_ms(
        lambda: K.egm_policy_grid(*args, **kw),
        lambda: K.egm_policy_grid(*args, **kw, force_global=True))
    steps = int(out[2].max())          # the slowest lane sets the time
    rec["ns_per_step"] = 1e6 * rec["kernel_ms"] / steps
    rec["global_ns_per_step"] = 1e6 * rec["global_ms"] / steps
    rec["bound_ms"], rec["bound_by"] = _bound(
        dt, *egm_work(dt, C, model, out[2], A + 3))
    log("kernel", name="egm_policy_grid", **rec)
    return rec


def escalation_check(dev):
    """The precision ladder on the card with some lanes escalating: the
    12 golden cells in float64, the descent of lanes 3 and 7 poisoned
    through the ladder's phase seam (its cheap solve), once for the
    policy and once for the distribution.  Each escalated lane must equal
    a direct float64 launch from the caller's initial iterate at the
    polish cadence, bitwise; every other lane the unpoisoned ladder's,
    bitwise.  Then the descent fault drill, which wraps a plain step,
    must refuse CUDA tensors."""
    from aiyagari_hark_tpu_torch.models import household as H
    from aiyagari_hark_tpu_torch.solver_health import (
        classify_fixed_point_exit)

    f64, f32 = torch.float64, torch.float32
    egm_tol, dist_tol = INNER_TOL[f64]
    model, R, W, crra = golden_cells(f64, dev)
    C = R.shape[0]
    bad = torch.zeros(C, dtype=torch.bool, device=dev)
    bad[[3, 7]] = True

    def poison(solve):
        def poisoned(x0, tol, max_iter, accel_every):
            x, it, diff, _ = solve(x0, tol, max_iter, accel_every)
            nan = float("nan")
            diff = torch.where(bad, torch.full_like(diff, nan), diff)
            if isinstance(x, torch.Tensor):
                x = H._where_lanes(bad, torch.full_like(x, nan), x)
            else:
                x = type(x)(*(H._where_lanes(bad, torch.full_like(f, nan), f)
                              for f in x))
            return x, it, diff, classify_fixed_point_exit(diff, tol, it,
                                                          max_iter)
        return poisoned

    def same(a, b, lanes):
        if isinstance(a, torch.Tensor):
            return torch.equal(a[lanes], b[lanes])
        return all(torch.equal(x[lanes], y[lanes]) for x, y in zip(a, b))

    out = {}
    p0 = H.initial_policy(model)
    cheap = H._egm_solver(R, W, model, 0.96, crra, False, f32)
    ref = H._egm_solver(R, W, model, 0.96, crra, False, f64)
    d0 = H.initial_distribution(model)
    for name in ("policy", "distribution"):
        if name == "policy":
            ladder, x0, tol, accel = (H.ladder_policy_fixed_point, p0,
                                      egm_tol, 32)
            dtol = H.descent_tolerance(tol, f32, H.POLICY_DESCENT_TOL_SCALE)
        else:
            pol = ref(p0, egm_tol, 3000, 32)[0]
            trans = H.wealth_transition(pol, R, W, model)
            cheap = H._lottery_solver(trans, model.transition, f32)
            ref = H._lottery_solver(trans, model.transition, f64)
            ladder, x0, tol, accel = (H.ladder_distribution_fixed_point, d0,
                                      dist_tol, 64)
            dtol = H.descent_tolerance(tol, f32, H.DIST_DESCENT_TOL_SCALE)
        max_iter = 3000 if name == "policy" else 20000
        clean = ladder(cheap, ref, x0, tol, dtol, max_iter, accel,
                       cheap_dtype=f32)
        hit = ladder(poison(cheap), ref, x0, tol, dtol, max_iter, accel,
                     cheap_dtype=f32)
        direct = ref(x0, tol, max_iter, H._polish_cadence(accel))
        if not torch.equal(hit[4].escalated, bad) or bool(
                clean[4].escalated.any()):
            raise AssertionError(f"{name} ladder escalated "
                                 f"{hit[4].escalated.tolist()} (clean: "
                                 f"{clean[4].escalated.tolist()})")
        # the result, diff and status; the polish's steps are the direct
        # launch's (the total adds the poisoned descent's)
        if not (all(same(hit[i], direct[i], bad) for i in (0, 2, 3))
                and torch.equal(hit[4].polish_steps[bad], direct[1][bad])):
            raise AssertionError(f"{name} ladder: an escalated lane is not "
                                 f"bitwise a direct reference launch")
        if not all(same(a, b, ~bad) for a, b in zip(hit[:4], clean[:4])):
            raise AssertionError(f"{name} ladder: a lane that did not "
                                 f"escalate changed")
        out[name] = dict(escalated=hit[4].escalated.tolist(),
                         descent_steps=clean[4].descent_steps.tolist(),
                         polish_steps=clean[4].polish_steps.tolist(),
                         direct_steps=direct[1].tolist())
    try:
        H.solve_household(R, W, model, 0.96, crra, precision="mixed",
                          descent_fault_iter=3)
    except ValueError as e:
        out["fault_drill_on_cuda"] = f"ValueError: {e}"
    else:
        raise AssertionError("solve_household(descent_fault_iter=3) ran on "
                             "CUDA tensors")
    log("escalation", bitwise_escalated_vs_direct=True,
        bitwise_others_unchanged=True, **out)


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
# r* budgets of the ladders against the golden, in pct (1 bp = 0.01 pct):
# the JAX acceptance of "mixed" (tests/test_precision.py, 0.25 bp) and of
# "fast" (5 bp); a float32 sweep keeps its 1 bp.
MIXED_BUDGET_PCT = 2.5e-3
FAST_BUDGET_PCT = 5e-2


def path_kernels(kernel="reference", precision="reference"):
    """The kernels a path launches: the fused kernel alone under
    kernel="fused" with a single-phase precision, else the two reference
    kernels (a two-phase precision runs its ladders on them)."""
    if kernel == "fused" and precision == "reference":
        return PATH_KERNELS["fused"]
    return PATH_KERNELS["reference"]


def phase_sweep(dt, dev, golden, kernel="reference", grid="reference",
                precision="reference"):
    """One sweep of a path, its launch counters set to 0 just before it
    and read just after: every kernel of the path launched, no other."""
    from aiyagari_hark_tpu_torch.ops import kernels as K
    from aiyagari_hark_tpu_torch.parallel.sweep import run_table2_sweep
    from aiyagari_hark_tpu_torch.solver_health import is_failure, status_name

    K.reset_launches()
    res = run_table2_sweep(dtype=dt, device=dev, kernel=kernel, grid=grid,
                           precision=precision, **WIDTH)
    launches = dict(K.LAUNCHES)
    for name, n in launches.items():
        if (n > 0) != (name in path_kernels(kernel, precision)):
            raise AssertionError(f"the {dt} {kernel}/{grid}/{precision} "
                                 f"sweep launched {name} {n} times")
    dr = res.r_star_pct - golden["r_star_pct"]
    ds = res.saving_rate_pct - golden["saving_rate_pct"]
    statuses = [status_name(s) for s in res.status]
    log("sweep", dtype=str(dt), kernel=kernel, grid=grid,
        precision=precision, wall_s=res.wall_seconds, launches=launches,
        r_star_pct=res.r_star_pct.tolist(), max_abs_dr_pct=float(
            abs(dr).max()), max_abs_dsave_pct=float(abs(ds).max()),
        status=statuses, bisect_iters=res.bisect_iters.tolist(),
        egm_iters=res.egm_iters.tolist(), dist_iters=res.dist_iters.tolist(),
        sum_egm_iters=int(res.egm_iters.sum()),
        sum_dist_iters=int(res.dist_iters.sum()),
        sum_descent_steps=int(res.descent_steps.sum()),
        sum_polish_steps=int(res.polish_steps.sum()),
        polish_frac=res.polish_frac(),
        precision_escalations=int(res.precision_escalations.sum()))
    if precision != "reference":
        budget = (1e-2 if dt == torch.float32 else
                  MIXED_BUDGET_PCT if precision == "mixed"
                  else FAST_BUDGET_PCT)
        if not abs(dr).max() <= budget:
            raise AssertionError(f"{dt} {precision} {kernel} sweep is "
                                 f"{abs(dr).max()} pct from the golden, "
                                 f"above {budget}")
        if bool(is_failure(res.status).any()):
            raise AssertionError(f"{precision} sweep statuses {statuses}")
        if precision == "mixed" and int(res.precision_escalations.sum()) > 2:
            raise AssertionError(f"mixed sweep escalated "
                                 f"{res.precision_escalations.tolist()}")
        if precision == "fast" and int(res.polish_steps.sum()) != 0:
            raise AssertionError("the fast sweep ran polish steps")
    elif (kernel == "fused" or grid != "reference") \
            and dt == torch.float64:
        if not abs(dr).max() < FUSED_BUDGET_PCT:
            raise AssertionError(f"f64 {kernel} {grid} sweep is "
                                 f"{abs(dr).max()} pct from the golden, "
                                 f"above 0.1 bp")
        if any(s != "CONVERGED" for s in statuses):
            raise AssertionError(f"f64 {kernel} {grid} sweep statuses "
                                 f"{statuses}")
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
    return launches, res


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
                   N, A, 0, 1)),
               cluster_block_bytes=int(lib.egm_policy_grid_cluster_bytes(
                   N, A, 0, 1)),
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


def phase_cell(dev, golden, kernel="reference", precision="reference"):
    """One unbatched cell (the single-lane entry, C=1 launches); returns
    the launch counts of its solve."""
    from aiyagari_hark_tpu_torch.models.equilibrium import solve_calibration
    from aiyagari_hark_tpu_torch.ops import kernels as K
    from aiyagari_hark_tpu_torch.solver_health import status_name

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    eq = solve_calibration(3.0, 0.6, dtype=torch.float64, device=dev,
                           kernel=kernel, precision=precision, **WIDTH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    # (sigma=3, rho=0.6).  solve_calibration solves every midpoint from
    # the cold start while the golden's lean path warm-starts, so the
    # inner tolerances place the root differently, by far less than
    # 1e-4 pct (0.01 bp); the fused path's budget is 0.1 bp, the mixed
    # ladder's 0.25 bp.  The residual at r*: under "mixed" each supply
    # carries its polish's fixed-point error (the policy within
    # egm_tol / (1 - beta) = 2.5e-5, which moves K by that order), not
    # the reference's 1e-6
    ref = golden["r_star_pct"][6]
    budget = (MIXED_BUDGET_PCT if precision == "mixed"
              else 1e-4 if kernel == "reference" else FUSED_BUDGET_PCT)
    excess_bound = 1e-4 if precision == "mixed" else 1e-6
    r_pct = 100.0 * float(eq.r_star)
    shapes = (tuple(eq.policy.m_knots.shape), tuple(eq.distribution.shape))
    ok = (shapes == ((7, 33), (500, 7))
          and bool(torch.isfinite(eq.policy.c_knots).all())
          and abs(float(eq.distribution.sum()) - 1.0) < 1e-9
          and math.isfinite(float(eq.excess))
          and abs(float(eq.excess)) < excess_bound
          and abs(r_pct - ref) <= budget
          and status_name(eq.status) == "CONVERGED"
          and all((n > 0) == (name in path_kernels(kernel, precision))
                  for name, n in launches.items()))
    log("cell", kernel=kernel, precision=precision, sigma=3.0, rho=0.6,
        r_star_pct=r_pct,
        golden_pct=ref,
        excess=float(eq.excess), saving_rate=float(eq.saving_rate),
        bisect_iters=int(eq.bisect_iters), status=status_name(eq.status),
        policy_shape=shapes[0], dist_shape=shapes[1], wall_s=wall,
        launches=launches)
    if not ok:
        raise AssertionError("the one-cell solve failed its checks")
    return launches


def phase_illinois(dev, golden):
    """One lean cell (sigma=3, rho=0.6) by root_method="illinois": within
    0.01 bp of the golden, CONVERGED, on the reference kernels."""
    from aiyagari_hark_tpu_torch.models.equilibrium import (
        solve_calibration_lean)
    from aiyagari_hark_tpu_torch.ops import kernels as K
    from aiyagari_hark_tpu_torch.solver_health import status_name

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    lean = solve_calibration_lean(3.0, 0.6, root_method="illinois",
                                  dtype=torch.float64, device=dev, **WIDTH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    ref = golden["r_star_pct"][6]
    r_pct = 100.0 * float(lean.r_star)
    log("cell_illinois", sigma=3.0, rho=0.6, r_star_pct=r_pct,
        golden_pct=ref, bisect_iters=int(lean.bisect_iters),
        egm_iters=int(lean.egm_iters), dist_iters=int(lean.dist_iters),
        status=status_name(lean.status), wall_s=wall, launches=launches)
    if not (abs(r_pct - ref) <= 1e-4
            and status_name(lean.status) == "CONVERGED"
            and all((n > 0) == (name in path_kernels())
                    for name, n in launches.items())):
        raise AssertionError("the Illinois cell failed its checks")


def _bits_equal(a, b) -> bool:
    """Bitwise equality of two host arrays (NaN payloads included)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _engine_run(dev, sweep, **kw):
    """One float64 full-width ``run_table2_sweep`` of the engine, its
    launch counters set to 0 just before it and read just after; warnings
    are kept (a quarantine or a recheck warns).  The last item is the
    host wall of the whole call in seconds: the batched launches and the
    quarantine rungs, rechecks and certification after them (every
    result reaches the host inside the call)."""
    import warnings

    from aiyagari_hark_tpu_torch.ops import kernels as K
    from aiyagari_hark_tpu_torch.parallel.sweep import run_table2_sweep

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = run_table2_sweep(sweep, dtype=torch.float64, device=dev,
                               **WIDTH, **kw)
    call_s = time.perf_counter() - t0
    return res, dict(K.LAUNCHES), [str(x.message) for x in w], call_s


ROWS = ("r_star_pct", "capital", "status", "bisect_iters", "egm_iters",
        "dist_iters", "descent_steps", "polish_steps")


def phase_engine(dev, golden, sweeps):
    """Phase 9, the sweep engine on the card (float64, full width): the
    default SweepConfig (locked) against phase 3's sweep; the balanced
    schedule bitwise the locked one (reference and fused kernels); warm
    brackets; a quarantined NaN cell (reference and fused kernels); the
    SDC recheck, clean and with a bit flip; certification.  Returns each
    kernel's launches per run."""
    from aiyagari_hark_tpu_torch.parallel.sweep import SweepResult
    from aiyagari_hark_tpu_torch.utils.config import SweepConfig
    from aiyagari_hark_tpu_torch.verify import CERTIFIED, cert_level_name

    g_r = np.asarray(golden["r_star_pct"])
    base = SweepConfig()
    launches = {}

    def check(ok, what):
        if not ok:
            raise AssertionError(f"sweep engine: {what}")

    def same_rows(a: SweepResult, b: SweepResult, cells=slice(None)):
        return all(_bits_equal(getattr(a, f)[cells], getattr(b, f)[cells])
                   for f in ROWS)

    # 1. the default configuration takes the locked path: phase 3's bits
    p3_launches, p3 = sweeps["float64"]
    locked, launches["locked"], _, _ = _engine_run(dev, base)
    check(locked.bucket is None, "SweepConfig() did not take 'locked'")
    check(same_rows(locked, p3), "the default sweep's rows are not phase "
          "3's bit for bit")
    check(launches["locked"] == p3_launches, f"launches "
          f"{launches['locked']} against phase 3's {p3_launches}")
    log("engine_locked", wall_s=locked.wall_seconds,
        launches=launches["locked"], phase3_launches=p3_launches,
        bitwise_phase3=True, max_abs_dr_pct=float(
            np.abs(locked.r_star_pct - g_r).max()))

    # 2. balanced: the buckets un-permute to the locked rows, bit for bit
    bal, launches["balanced"], _, _ = _engine_run(
        dev, base.replace(schedule="balanced"))
    check(same_rows(bal, locked), "balanced rows differ from locked")
    fused_p5 = sweeps["fused_float64"][1]
    fbal, launches["balanced_fused"], _, _ = _engine_run(
        dev, base.replace(schedule="balanced", kernel="fused"))
    check(same_rows(fbal, fused_p5), "fused balanced rows differ from the "
          "fused locked sweep of phase 5")
    log("engine_balanced", buckets=bal.bucket.tolist(),
        wall_s=bal.wall_seconds, locked_wall_s=locked.wall_seconds,
        fused_wall_s=fbal.wall_seconds,
        fused_locked_wall_s=fused_p5.wall_seconds,
        launches=launches["balanced"],
        launches_fused=launches["balanced_fused"],
        skew=bal.iteration_skew(),
        scheduled_skew=bal.scheduled_iteration_skew(),
        bitwise_locked=True)

    # 3. warm brackets, walls in turns against locked
    warm_cfg = base.replace(schedule="balanced", warm_brackets=True)
    warm, launches["warm"], _, _ = _engine_run(dev, warm_cfg)
    dr = np.abs(warm.r_star_pct - g_r)
    check(float(dr.max()) <= 1e-6, f"warm sweep {dr.max()} pct from the "
          f"golden")
    check(int(warm.bisect_iters.sum()) < int(locked.bisect_iters.sum()),
          f"warm trips {warm.bisect_iters.tolist()} not fewer than locked "
          f"{locked.bisect_iters.tolist()}")
    check(not bool((warm.status != 0).any()), f"warm statuses "
          f"{warm.status.tolist()}")
    walls = {"locked": [], "warm": []}
    for name in ("locked", "warm", "warm", "locked"):
        res, _, _, _ = _engine_run(dev, base if name == "locked"
                                   else warm_cfg)
        walls[name].append(res.wall_seconds)
    log("engine_warm", max_abs_dr_pct=float(dr.max()),
        bisect_iters=warm.bisect_iters.tolist(),
        locked_bisect_iters=locked.bisect_iters.tolist(),
        sum_bisect=int(warm.bisect_iters.sum()),
        locked_sum_bisect=int(locked.bisect_iters.sum()),
        total_work=int(warm.total_work().sum()),
        locked_total_work=int(locked.total_work().sum()),
        buckets=warm.bucket.tolist(), walls_in_turns_s=walls,
        launches=launches["warm"])

    # 4. quarantine: a NaN from cell 2's second trip, recovered by a rung
    fault = {"cell": 2, "at_iter": 1, "mode": "nan"}
    others = [i for i in range(12) if i != 2]
    for kernel, ref in (("reference", locked), ("fused", fused_p5)):
        q, ql, msgs, call_s = _engine_run(dev, base.replace(kernel=kernel),
                                          inject_fault=fault)
        launches[f"quarantine_{kernel}"] = ql
        check(q.retries.tolist() == [0, 0, 1] + [0] * 9,
              f"retries {q.retries.tolist()} under kernel={kernel}")
        check(q.status.tolist() == [0] * 12, f"statuses "
              f"{q.status.tolist()} after quarantine")
        check(same_rows(q, ref, others), "quarantine moved another cell")
        check(abs(q.r_star_pct[2] - g_r[2]) <= 1e-6, "the recovered cell "
              "misses the golden")
        log("engine_quarantine", kernel=kernel, fault=fault,
            retries=q.retries.tolist(), status=q.status.tolist(),
            recovered_r_star_pct=float(q.r_star_pct[2]),
            recovered_bitwise_clean=bool(_bits_equal(
                q.r_star_pct[2], locked.r_star_pct[2])),
            others_bitwise_clean=True, launches=ql,
            wall_s=q.wall_seconds, call_s=call_s, warnings=msgs)

    # 5. SDC: a clean full recheck finds nothing; a flipped bit is caught
    clean, launches["recheck"], _, clean_s = _engine_run(
        dev, base.replace(recheck_fraction=1.0))
    check(clean.sdc_suspected is not None
          and not clean.sdc_suspected.any(),
          f"clean recheck suspects {np.nonzero(clean.sdc_suspected)[0]}")
    check(same_rows(clean, locked), "a clean recheck changed the rows")
    flip = {"cell": 1, "bit": 30}
    bad, launches["recheck_flip"], msgs, flip_s = _engine_run(
        dev, base.replace(recheck_fraction=1.0), inject_sdc=flip)
    check(np.nonzero(bad.sdc_suspected)[0].tolist() == [1],
          f"suspects {np.nonzero(bad.sdc_suspected)[0].tolist()}")
    check(bad.status.tolist() == [0] * 12 and bad.retries[1] == 1,
          "the flipped cell was not recovered")
    check(same_rows(bad, locked, [i for i in range(12) if i != 1]),
          "the flip moved another cell")
    log("engine_sdc", clean_suspects=0, recheck_wall_s=(
        clean.recheck_wall_seconds), clean_call_s=clean_s,
        flip_call_s=flip_s, flip=flip,
        suspects=np.nonzero(bad.sdc_suspected)[0].tolist(),
        recovered_bitwise_clean=bool(_bits_equal(bad.r_star_pct[1],
                                                 locked.r_star_pct[1])),
        launches_clean=launches["recheck"],
        launches_flip=launches["recheck_flip"], warnings=msgs)

    # 6. certification of every cell, and of (sigma=5, rho=0) under mixed
    torch.cuda.reset_peak_memory_stats(dev)
    cert, launches["certify"], _, cert_s = _engine_run(dev, base.replace(
        certify=True))
    peak = torch.cuda.max_memory_allocated(dev)
    levels = [cert_level_name(x) for x in cert.cert_level]
    check(all(lv == CERTIFIED for lv, s in zip(cert.cert_level,
                                               cert.status) if s == 0),
          f"certificate levels {levels}")
    mixed, _, _, _ = _engine_run(dev, SweepConfig(
        crra_values=(5.0,), rho_values=(0.0,), certify=True),
        precision="mixed")
    log("engine_certify", levels=levels, certify_wall_s=(
        cert.certify_wall_seconds), solve_wall_s=cert.wall_seconds,
        call_s=cert_s,
        peak_device_bytes=int(peak), launches=launches["certify"],
        mixed_cell={"sigma": 5.0, "rho": 0.0,
                    "level": cert_level_name(mixed.cert_level[0]),
                    "r_star_pct": float(mixed.r_star_pct[0]),
                    "certify_wall_s": mixed.certify_wall_seconds})
    return launches


FAMILIES = os.path.join(HERE, "tests", "data", "torch_families_golden.json")
# The JAX suite's bound on the Epstein-Zin collapse gamma = ez_rho -> CRRA
# (tests/test_scenarios.py, test_ez_collapses_to_crra): 5e-4 in r.
EZ_COLLAPSE_R = 5e-4


def family_cells(g, name, dt, dev):
    """One family's 12 golden cells as a lane-batched model on the card
    ([C, 3] host cells, the model, the golden r* as a [C] tensor)."""
    from aiyagari_hark_tpu_torch.models.household import build_cell_models

    fam = g[name]
    axis = fam["crra"] if name == "huggett" else fam["gamma"]
    cells = np.asarray([(a, rho, g["labor_sd"])
                        for a, rho in zip(axis, fam["labor_ar"])])
    build = dict(g["config"])
    if name == "huggett":
        build["borrow_limit"] = fam["borrow_limit"]
    else:
        build["grid_tail"] = "anchors"
    model = build_cell_models(cells, dtype=dt, device=dev, **build)
    r = torch.tensor(fam["r_star_pct"], dtype=dt, device=dev) / 100.0
    return cells, model, r


def _family_run(dev, name, sweep, dt=torch.float64, **kw):
    """One full-width ``run_sweep`` of a family, its launch counters set to
    0 just before it and read just after; warnings kept; the last item is
    the host wall of the whole call in seconds."""
    import warnings

    from aiyagari_hark_tpu_torch.ops import kernels as K
    from aiyagari_hark_tpu_torch.parallel.sweep import run_sweep

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = run_sweep(name, sweep, dtype=dt, device=dev, **WIDTH, **kw)
    call_s = time.perf_counter() - t0
    return res, dict(K.LAUNCHES), [str(x.message) for x in w], call_s


FAMILY_ROW_CHECK = ("r_star", "bisect_iters", "egm_iters", "dist_iters")


def phase_families(dev, table2):
    """Phase 10, the Huggett and Epstein-Zin families on the card, float64
    at full width unless named: both kernels at borrow_limit=-2 on the 12
    Huggett cells at their golden r* (bitwise their plain versions, C=12
    bitwise twelve C=1 launches, the shared layout bitwise the global one,
    f64 and f32, timed); the Epstein-Zin policy loop alone (its steps,
    wall and host syncs); each family's sweep against the JAX goldens
    (tests/data/torch_families_golden.json) with its launches; Huggett in
    float32 (1 bp) and balanced (bitwise locked); Epstein-Zin's gamma = 3
    column against Table II's sigma = 3 column; per family a NaN cell
    recovered by quarantine with the others bitwise unchanged, a clean
    full recheck, certification.  Returns (kernel records, each kernel's
    launches per family run)."""
    from aiyagari_hark_tpu_torch.models.epstein_zin import solve_ez_household
    from aiyagari_hark_tpu_torch.models.household import _scalars
    from aiyagari_hark_tpu_torch.solver_health import status_name
    from aiyagari_hark_tpu_torch.utils.config import SweepConfig
    from aiyagari_hark_tpu_torch.verify import cert_level_name

    with open(FAMILIES) as f:
        g = json.load(f)
    records = {}
    launches = {}

    def check(ok, what):
        if not ok:
            raise AssertionError(f"families: {what}")

    # 10a. the kernels below a zero debt limit
    for dt in (torch.float64, torch.float32):
        cells, model, r = family_cells(g, "huggett", dt, dev)
        crra = torch.as_tensor(cells[:, 0], dtype=dt, device=dev)
        check(float(_scalars(1.0 + r, 1.0, model, 0.96, crra)[0, 4]) == -2.0,
              "the EGM kernel's b is not -2")
        egm, dist = kernel_pair_check(dev, dt, model, 1.0 + r,
                                      torch.ones_like(r), crra,
                                      family="huggett", borrow_limit=-2.0)
        records.setdefault("egm_policy_grid", []).append(egm)
        records.setdefault("stationary_lottery_grid", []).append(dist)

    # 10b. the Epstein-Zin policy loop alone: 12 lanes at the golden r*
    from aiyagari_hark_tpu_torch.models import firm

    cells, model, r = family_cells(g, "epstein_zin", torch.float64, dev)
    W = firm.wage_rate(firm.k_to_l_from_r(r, 0.36, 0.08), 0.36)
    gamma = torch.as_tensor(cells[:, 0], dtype=torch.float64, device=dev)
    solve_ez_household(1.0 + r, W, model, 0.96, g["epstein_zin"]["ez_rho"],
                       gamma, tol=INNER_TOL[torch.float64][0])   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pol, it, diff, st = solve_ez_household(
        1.0 + r, W, model, 0.96, g["epstein_zin"]["ez_rho"], gamma,
        tol=INNER_TOL[torch.float64][0])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    check(bool((st == 0).all()) and all(bool(torch.isfinite(f).all())
                                        for f in pol),
          f"the EZ policy loop ended {st.tolist()}")
    steps = int(it.max())
    # the host syncs, counted in a third, untimed run: every synchronizing
    # CUDA call warns under the sync debug mode
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solve_ez_household(1.0 + r, W, model, 0.96,
                               g["epstein_zin"]["ez_rho"], gamma,
                               tol=INNER_TOL[torch.float64][0])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    log("families_ez_policy_loop", lanes=len(cells), iters=it.tolist(),
        steps=steps, host_syncs=syncs,
        host_syncs_by="torch.cuda.set_sync_debug_mode('warn'), counted",
        wall_s=loop_s, ms_per_step=1e3 * loop_s / steps,
        engine="egm_step_ez, plain PyTorch")

    # 10c. the sweeps against the JAX goldens
    ez_cfg = SweepConfig(crra_values=(3.0, 5.0, 8.0))
    runs = {"huggett": (SweepConfig(), {}),
            "epstein_zin": (ez_cfg, {"ez_rho": g["epstein_zin"]["ez_rho"]})}
    out = {}
    for name, (cfg, kw) in runs.items():
        fam = g[name]
        res, ln, _, call_s = _family_run(dev, name, cfg, **kw)
        launches[name] = ln
        dr = np.abs(100.0 * res.col("r_star") - np.asarray(fam["r_star_pct"]))
        statuses = [status_name(x) for x in res.status]
        check(float(dr.max()) <= 1e-6, f"{name} r* {dr.max()} pct from the "
              f"JAX golden")
        check(res.status.tolist() == fam["status"], f"{name} statuses "
              f"{statuses} against {fam['status']}")
        want = {"egm_policy_grid": name == "huggett",
                "stationary_lottery_grid": True, "fused_cell_grid": False}
        check(all((n > 0) == want[k] for k, n in ln.items()),
              f"{name} launched {ln}")
        rec = dict(family=name, wall_s=res.wall_seconds, call_s=call_s,
                   launches=ln, max_abs_dr_pct=float(dr.max()),
                   r_star_pct=(100.0 * res.col("r_star")).tolist(),
                   status=statuses, methods=res.methods,
                   sum_bisect=int(res.icol("bisect_iters").sum()),
                   sum_egm_iters=int(res.icol("egm_iters").sum()),
                   sum_dist_iters=int(res.icol("dist_iters").sum()),
                   steps_equal_jax={
                       f: bool(res.icol(f).tolist() == fam[f])
                       for f in ("bisect_iters", "egm_iters", "dist_iters")})
        if name == "huggett":
            check(all(s == "CONVERGED" for s in statuses),
                  f"huggett statuses {statuses}")
            check(bool((res.col("r_star") < (1.0 - 0.96) / 0.96).all()),
                  "a Huggett r* at or above the autarky bound")
            check(bool((res.col("borrower_share") > 0.0).all()),
                  "a Huggett cell without borrowers")
            rec["borrower_share"] = res.col("borrower_share").tolist()
        else:
            t2 = np.asarray(table2["r_star_pct"])[
                np.asarray(table2["crra"]) == 3.0]
            gap = np.abs(100.0 * res.col("r_star")[:4] - t2) / 100.0
            check(float(gap.max()) <= EZ_COLLAPSE_R, f"the gamma = 3 column "
                  f"is {gap.max()} from Table II's sigma = 3 column in r")
            rec["collapse_gap_bp"] = (1e4 * gap).tolist()
        log("families_sweep", **rec)
        out[name] = res

    # Huggett in float32 and under the balanced schedule
    f32, ln, _, _ = _family_run(dev, "huggett", SweepConfig(),
                                torch.float32)
    launches["huggett_float32"] = ln
    dr = np.abs(100.0 * f32.col("r_star")
                - np.asarray(g["huggett"]["r_star_pct"]))
    check(float(dr.max()) <= 1e-2, f"f32 Huggett r* {dr.max()} pct from "
          f"the golden, above 1 bp")
    check(not bool((f32.status >= 2).any()), f"f32 Huggett statuses "
          f"{f32.status.tolist()}")
    bal, launches["huggett_balanced"], _, _ = _family_run(
        dev, "huggett", SweepConfig(schedule="balanced"))
    check(_bits_equal(bal.rows, out["huggett"].rows),
          "balanced Huggett rows differ from locked")
    log("families_huggett_f32_balanced", f32_max_abs_dr_pct=float(dr.max()),
        f32_wall_s=f32.wall_seconds, f32_launches=ln,
        balanced_wall_s=bal.wall_seconds, buckets=bal.bucket.tolist(),
        balanced_bitwise_locked=True,
        balanced_launches=launches["huggett_balanced"])

    # 10d. the engine per family: quarantine, recheck, certification
    fault = {"cell": 2, "at_iter": 1, "mode": "nan"}
    for name, (cfg, kw) in runs.items():
        clean = out[name]
        others = [i for i in range(12) if i != 2]
        q, launches[f"{name}_quarantine"], msgs, q_s = _family_run(
            dev, name, cfg, inject_fault=fault, **kw)
        check(q.retries.tolist() == [0, 0, 1] + [0] * 9,
              f"{name} retries {q.retries.tolist()}")
        check(not bool((q.status >= 2).any()), f"{name} statuses "
              f"{q.status.tolist()} after quarantine")
        check(_bits_equal(q.rows[others], clean.rows[others]),
              f"{name}: quarantine moved another cell")
        rc, launches[f"{name}_recheck"], _, rc_s = _family_run(
            dev, name, cfg.replace(recheck_fraction=1.0), **kw)
        check(rc.sdc_suspected is not None and not rc.sdc_suspected.any(),
              f"{name} clean recheck suspects "
              f"{np.nonzero(rc.sdc_suspected)[0].tolist()}")
        check(_bits_equal(rc.rows, clean.rows),
              f"{name}: a clean recheck changed the rows")
        torch.cuda.reset_peak_memory_stats(dev)
        ce, launches[f"{name}_certify"], _, ce_s = _family_run(
            dev, name, cfg.replace(certify=True), **kw)
        peak = torch.cuda.max_memory_allocated(dev)
        levels = [cert_level_name(x) for x in ce.cert_level]
        check(all(lv <= 1 for lv, s in zip(ce.cert_level, ce.status)
                  if s == 0), f"{name} certificate levels {levels}")
        log("families_engine", family=name, fault=fault,
            retries=q.retries.tolist(),
            recovered_r_star_pct=100.0 * float(q.col("r_star")[2]),
            recovered_bitwise_clean=bool(_bits_equal(q.rows[2],
                                                     clean.rows[2])),
            others_bitwise_clean=True, quarantine_call_s=q_s,
            quarantine_launches=launches[f"{name}_quarantine"],
            warnings=msgs, recheck_suspects=0,
            recheck_wall_s=rc.recheck_wall_seconds, recheck_call_s=rc_s,
            recheck_launches=launches[f"{name}_recheck"],
            cert_levels=levels, certify_wall_s=ce.certify_wall_seconds,
            certify_call_s=ce_s, peak_device_bytes=int(peak),
            certify_launches=launches[f"{name}_certify"])
    return records, launches


KS_GOLDEN = os.path.join(HERE, "tests", "data", "torch_ks_golden.json")
WEALTH_STUDY = os.path.join(HERE, "tests", "data", "wealth_seed_study.json")
# The notebook run's width (notebook_run_configs(), AgentCount=350,
# a_count=32, the default M-grid, act_T=11000) and the histogram's points.
KS_WIDTH = dict(act_T=11000, T_discard=1000, dist_count=500, agents=350)
# The pinned-histogram solve against JAX's, absolute: tests/test_torch_ks.py
# holds the CPU gaps (~1e-12) to these; the card sums in other orders over
# a longer horizon.
KS_TOL = dict(intercept=1e-9, r_star_pct=1e-7, saving_rate_pct=1e-6,
              den_haan_pct=1e-6)
KS_F32_R_PCT = 1e-2     # float32 r* within 1 bp of the float64 golden
KS_PANEL_R_PP = 0.2     # the panel's r* within 0.2 pp of the golden's
KS_BAND_Z = 3.0         # the fixed-rule panel inside the 32-seed band
# A true-KS calibration (Krusell-Smith 1998's unemployment rates) whose
# exact-count employment moves every period.
KS_EMPLOYMENT = dict(urate_b=0.10, urate_g=0.04, prod_b=0.99, prod_g=1.01)


def ks_check(ok, what):
    if not ok:
        raise AssertionError(f"ks: {what}")


def _ks_economy(dev, seed: int, **econ_updates):
    """The notebook's economy and agent through the facade (cells 16-18:
    LaborAR=0.3, LaborSD=0.2, CRRA=1.0, AgentCount=350)."""
    from aiyagari_hark_tpu_torch import (AiyagariEconomy, AiyagariType,
                                         init_aiyagari_agents,
                                         init_aiyagari_economy)

    econ_dict = init_aiyagari_economy()
    econ_dict.update(LaborAR=0.3, LaborSD=0.2, CRRA=1.0, verbose=False,
                     act_T=KS_WIDTH["act_T"], T_discard=KS_WIDTH["T_discard"],
                     **econ_updates)
    agent_dict = init_aiyagari_agents()
    agent_dict.update(AgentCount=KS_WIDTH["agents"])
    economy = AiyagariEconomy(seed=seed, device=dev, **econ_dict)
    agent = AiyagariType(**agent_dict)
    agent.cycles = 0
    agent.get_economy_data(economy)
    economy.agents = [agent]
    return economy


def _ks_readout(economy, sol) -> dict:
    """r*, the saving rate and den Haan's errors, as reproduce.py reads
    them."""
    from aiyagari_hark_tpu_torch.models.diagnostics import den_haan_forecast

    depr = economy.DeprFac
    if "aNowGrid" in economy.reap_state:
        a_mean = float(np.average(economy.reap_state["aNowGrid"][0],
                                  weights=economy.reap_state["aNowWeights"][0]))
    else:
        a_mean = float(np.mean(economy.reap_state["aNow"][0]))
    dh = den_haan_forecast(sol, t_start=KS_WIDTH["T_discard"])
    return {"r_star_pct": (economy.sow_state["Rnow"] - 1.0) * 100.0,
            "saving_rate_pct": 100.0 * depr * a_mean / (
                economy.sow_state["Mnow"] - (1.0 - depr) * a_mean),
            "den_haan_max_error_pct": float(dh.max_error_pct),
            "den_haan_mean_error_pct": float(dh.mean_error_pct)}


def _ks_solve(dev, dt, chain=None, seed=1, economy_kw=None, **kw):
    """One ``AiyagariEconomy.solve()`` on the card (the chain injected, or
    drawn by ``make_Mrkv_history``): (economy, solution, phase walls,
    whole wall)."""
    from aiyagari_hark_tpu_torch.utils.timing import PhaseTimer

    economy = _ks_economy(dev, seed, **(economy_kw or {}))
    if chain is None:
        economy.make_Mrkv_history()
    else:
        economy.MrkvNow_hist = chain
    timer = PhaseTimer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = economy.solve(dtype=dt, timer=timer, **kw)
    torch.cuda.synchronize()
    return economy, sol, timer.report(), time.perf_counter() - t0


def _synced_solve(dev, dt, chain=None, **kw):
    """``_ks_solve`` under ``torch.cuda.set_sync_debug_mode("warn")``,
    the implicit host syncs counted between outer iterations (at each
    iteration's callback; the first count includes the solve's set-up).
    An explicit ``torch.cuda.synchronize`` is not counted.  Returns
    ``_ks_solve``'s tuple and the syncs of each outer iteration."""
    torch.cuda.synchronize()
    marks = []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")

            def mark(rec):
                marks.append(sum("synchroniz" in str(x.message) for x in w))

            out = _ks_solve(dev, dt, chain, callback=mark, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, np.diff([0] + marks).tolist()


def _device_profile(fn):
    """``fn()`` under torch.profiler: (kernels launched, device busy
    seconds, profiled wall seconds)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    launched = sum(1 for e in kernels
                   if not e.name.startswith(("Memcpy", "Memset")))
    busy = sum(e.device_time for e in kernels) * 1e-6
    return launched, busy, wall


def _employment_counts(cal, chain: torch.Tensor, agents: int):
    """The exact-count employment recursion on the host (float64, the
    calibration's own matrices): the employed count of every period."""
    c = [t.cpu() for t in (cal.agg_transition, cal.empl_transition,
                           cal.urate_by_agg)]
    agg, empl, urate = c
    z = chain.cpu().tolist()
    n_emp = agents - int(torch.round(urate[z[0]] * agents))
    prev, counts = z[0], []
    for now in z:
        p_agg = agg[prev, now]
        p_ue = empl[2 * prev, 2 * now + 1] / p_agg
        p_eu = empl[2 * prev + 1, 2 * now] / p_agg
        fire = int(torch.round(torch.tensor(float(n_emp)) * p_eu))
        hire = int(torch.round(torch.tensor(float(agents - n_emp)) * p_ue))
        n_emp = n_emp - fire + hire
        counts.append(n_emp)
        prev = now
    return counts


def phase_ks(dev):
    """Phase 11, the notebook's Krusell-Smith path on the card at full
    width, float64 unless named: the pinned-histogram engine on JAX's chain
    against tests/data/torch_ks_golden.json, interrupted after outer
    iteration 2 and resumed (final rule and history bitwise the
    uninterrupted run's), float32; the panel engine through
    ``AiyagariEconomy.solve()`` (converged, r* near the golden's), the
    exact employment counts of a true-KS panel, the panel at the wealth
    study's fixed rule against its 32-seed band; launches per period,
    host syncs per outer iteration, the device's idle share."""
    from aiyagari_hark_tpu_torch.models import ks_model, simulate
    from aiyagari_hark_tpu_torch.models.ks_model import AFuncParams
    from aiyagari_hark_tpu_torch.ops import kernels as K
    from aiyagari_hark_tpu_torch.utils import stats
    from aiyagari_hark_tpu_torch.utils.config import notebook_run_configs
    from aiyagari_hark_tpu_torch.utils.resilience import (Interrupted,
                                                          preemption_guard,
                                                          request_interrupt)

    f64 = torch.float64
    with open(KS_GOLDEN) as f:
        golden = json.load(f)
    T = KS_WIDTH["act_T"]
    chain = np.asarray([int(c) for c in golden["mrkv_hist"][:T]], np.int64)
    g64 = golden["float64"]
    hist_kw = dict(sim_method="distribution",
                   dist_count=KS_WIDTH["dist_count"])
    K.reset_launches()

    # 11a. the deterministic engine against JAX
    (econ_a, sol_a, phases_a, wall_a), syncs_a = _synced_solve(
        dev, f64, chain, **hist_kw)
    out_a = _ks_readout(econ_a, sol_a)
    icpt = sol_a.afunc.intercept.cpu()
    gaps = {"intercept": float((icpt - torch.tensor(
                g64["afunc_intercept"], dtype=f64)).abs().max()),
            "slope": float(sol_a.afunc.slope.cpu().abs().max()),
            "r_star_pct": abs(out_a["r_star_pct"] - g64["r_star_pct"]),
            "saving_rate_pct": abs(out_a["saving_rate_pct"]
                                   - g64["saving_rate_pct"]),
            "den_haan_pct": max(
                abs(out_a["den_haan_max_error_pct"]
                    - g64["den_haan_max_error_pct"]),
                abs(out_a["den_haan_mean_error_pct"]
                    - g64["den_haan_mean_error_pct"]))}
    ks_check(sol_a.converged, "the pinned histogram solve did not converge")
    ks_check(len(sol_a.records) == g64["outer_iterations"],
             f"{len(sol_a.records)} outer iterations against JAX's "
             f"{g64['outer_iterations']}")
    ks_check(gaps["slope"] == 0.0, "the pinned rule has a slope")
    for k, tol in KS_TOL.items():
        ks_check(gaps[k] <= tol, f"{k} is {gaps[k]} from JAX's, above {tol}")
    log("ks_histogram", dtype="float64", wall_s=wall_a, phases_s=phases_a,
        outer_iterations=len(sol_a.records),
        iteration_walls_s=[r.wall_seconds for r in sol_a.records],
        egm_iters=[r.egm_iters for r in sol_a.records],
        host_syncs_per_iteration=syncs_a,
        intercept=icpt.tolist(), **out_a, gaps_to_jax=gaps, tolerances=KS_TOL,
        jax_cpu_solve_s=g64["jax_cpu_solve_seconds"])

    # 11b. interrupted after outer iteration 2, resumed from the
    # checkpoint: bitwise the uninterrupted run (rule and history, so this
    # is also the run-to-run determinism check)
    import tempfile

    def stop_after_two(rec):
        if rec.iteration == 1:
            request_interrupt()

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ks.npz")
        stopped = None
        try:
            with preemption_guard():
                _ks_solve(dev, f64, chain, checkpoint_path=ck,
                          callback=stop_after_two, **hist_kw)
        except Interrupted as e:
            stopped = e.progress
        ks_check(stopped is not None and stopped["iteration"] == 2,
                 f"the interrupt stopped at {stopped}")
        _, sol_b, phases_b, wall_b = _ks_solve(dev, f64, chain,
                                               checkpoint_path=ck, **hist_kw)
    same_rule = all(torch.equal(a.cpu(), b.cpu())
                    for a, b in zip(sol_a.afunc, sol_b.afunc))
    same_hist = torch.equal(sol_a.history.A_prev.cpu(),
                            sol_b.history.A_prev.cpu())
    ks_check(same_rule, "the resumed rule is not bitwise the uninterrupted")
    ks_check(same_hist, "the resumed history.A_prev is not bitwise the "
             "uninterrupted run's")
    ks_check([r.iteration for r in sol_b.records]
             == list(range(2, len(sol_a.records))),
             f"resumed iterations {[r.iteration for r in sol_b.records]}")
    log("ks_resume", interrupted_at=stopped, resumed_wall_s=wall_b,
        resumed_phases_s=phases_b, resumed_iterations=len(sol_b.records),
        afunc_bitwise=same_rule, history_bitwise=same_hist)

    # 11c. float32: the r* gap against the float64 golden and JAX's f32
    econ_c, sol_c, phases_c, wall_c = _ks_solve(dev, torch.float32, chain,
                                                **hist_kw)
    out_c = _ks_readout(econ_c, sol_c)
    gap32 = abs(out_c["r_star_pct"] - g64["r_star_pct"])
    ks_check(gap32 <= KS_F32_R_PCT, f"f32 r* {gap32} pct from the golden")
    log("ks_histogram", dtype="float32", wall_s=wall_c, phases_s=phases_c,
        outer_iterations=len(sol_c.records), converged=sol_c.converged,
        **out_c, r_gap_to_f64_golden_pct=gap32,
        r_gap_to_jax_f32_pct=abs(out_c["r_star_pct"]
                                 - golden["float32"]["r_star_pct"]),
        jax_f32_outer_iterations=golden["float32"]["outer_iterations"])

    # 11d. the panel engine: AiyagariEconomy(seed=1) -> make_Mrkv_history
    # -> solve(), the notebook's own pipeline
    (econ_d, sol_d, phases_d, wall_d), syncs_d = _synced_solve(dev, f64,
                                                               seed=1)
    out_d = _ks_readout(econ_d, sol_d)
    dr = abs(out_d["r_star_pct"] - g64["r_star_pct"])
    ks_check(sol_d.converged, "the panel solve did not converge")
    ks_check(dr <= KS_PANEL_R_PP, f"panel r* {out_d['r_star_pct']} is {dr} "
             f"pp from the golden's")
    urate = sol_d.history.urate.cpu()
    ks_check(bool((urate == 0.0).all()), "a nonzero unemployment rate at "
             "UrateB = UrateG = 0")
    log("ks_panel", wall_s=wall_d, phases_s=phases_d,
        outer_iterations=len(sol_d.records),
        iteration_walls_s=[r.wall_seconds for r in sol_d.records],
        egm_iters=[r.egm_iters for r in sol_d.records],
        host_syncs_per_iteration=syncs_d,
        intercept=sol_d.afunc.intercept.cpu().tolist(),
        slope=sol_d.afunc.slope.cpu().tolist(), **out_d,
        r_gap_to_golden_pp=dr, wealth_stats=stats.wealth_stats(
            econ_d.reap_state["aNow"][0])._asdict())

    # the exact employment counts of a true-KS panel
    agent, econ = notebook_run_configs()
    cal_ks = ks_model.build_ks_calibration(
        agent, econ.replace(**KS_EMPLOYMENT), ks_employment=True, dtype=f64,
        device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    ks_chain = torch.as_tensor(chain[:2000], device=dev)
    init = simulate.initial_panel(cal_ks, KS_WIDTH["agents"], int(chain[0]),
                                  g)
    hist_e, _ = simulate.simulate_panel(ks_model.initial_ks_policy(cal_ks),
                                        cal_ks, ks_chain, init, g)
    want = _employment_counts(cal_ks, ks_chain, KS_WIDTH["agents"])
    got = torch.round((1.0 - hist_e.urate.cpu()) * KS_WIDTH["agents"])
    want_urate = 1.0 - torch.tensor(want, dtype=f64) / KS_WIDTH["agents"]
    ks_check(got.long().tolist() == want, "employment counts differ from "
             "the exact-count recursion")
    ks_check(torch.equal(hist_e.urate.cpu(), want_urate), "urate is not "
             "1 - count / agents bit for bit")
    log("ks_employment_counts", periods=len(want),
        counts_min_max=[min(want), max(want)], equal=True)

    # the panel at the wealth study's fixed rule, against its 32-seed band
    with open(WEALTH_STUDY) as f:
        study = json.load(f)
    cal = ks_model.build_ks_calibration(agent, econ, dtype=f64, device=dev)
    rule = AFuncParams(*(torch.tensor(study["policy_afunc"][k], dtype=f64,
                                      device=dev)
                         for k in ("intercept", "slope")))
    policy = ks_model.solve_ks_household(rule, cal)[0]
    study_chain = torch.as_tensor(_ks_economy(dev, 0).make_Mrkv_history(),
                                  device=dev)
    g.manual_seed(12345)
    init = simulate.initial_panel(cal, KS_WIDTH["agents"], 0, g)
    _, final = simulate.simulate_panel(policy, cal, study_chain, init, g)
    assets = final.assets.cpu().numpy()
    ws = stats.wealth_stats(assets)._asdict()
    ws["lorenz_vs_scf"] = stats.lorenz_distance_vs_scf(assets)
    z = {k: (ws[k] - study["band"][k]["mean"]) / study["band"][k]["std"]
         for k in ws}
    ks_check(all(abs(v) <= KS_BAND_Z for v in z.values()),
             f"fixed-rule panel outside the band: z = {z}")
    log("ks_fixed_rule_panel", stats=ws, z=z)

    # launches per period and the idle share (11a and 11d counted the
    # host syncs of each outer iteration)
    launches_ks = dict(K.LAUNCHES)
    ks_check(not any(launches_ks.values()), f"the KS path launched "
             f"{launches_ks}")
    fixed_K = torch.exp(sol_a.afunc.intercept[0])
    grid = sol_a.dist_grid
    ch = torch.as_tensor(chain, device=dev)
    per = {}
    runs = {
        "histogram_pinned": lambda n: simulate.simulate_distribution_history(
            sol_a.policy, sol_a.calibration, ch[:n], grid, fixed_K=fixed_K),
        "panel": lambda n: simulate.simulate_panel(
            sol_d.policy, sol_d.calibration, ch[:n],
            simulate.initial_panel(sol_d.calibration, KS_WIDTH["agents"], 0,
                                   torch.Generator(device=dev).manual_seed(3)),
            torch.Generator(device=dev).manual_seed(4)),
    }
    for name, run in runs.items():
        short, busy_s, wall_s_ = _device_profile(lambda: run(100))
        long_, busy_l, wall_l = _device_profile(lambda: run(1100))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(1100)
        torch.cuda.synchronize()
        plain = time.perf_counter() - t0
        per[name] = {"launches_per_period": (long_ - short) / 1000.0,
                     "device_busy_s_1100": busy_l,
                     "profiled_wall_s_1100": wall_l,
                     "unprofiled_wall_s_1100": plain,
                     "ms_per_period": 1e3 * plain / 1100,
                     "idle_share_profiled": 1.0 - busy_l / wall_l,
                     "idle_share_unprofiled": 1.0 - busy_l / plain}
    egm_l, egm_busy, egm_wall = _device_profile(
        lambda: ks_model.solve_ks_household(sol_a.afunc, sol_a.calibration))
    per["egm_solve"] = {"launches": egm_l, "device_busy_s": egm_busy,
                        "profiled_wall_s": egm_wall,
                        "idle_share_profiled": 1.0 - egm_busy / egm_wall}
    log("ks_launches_idle", per=per, kernel_launches_ks_path=launches_ks)
    return launches_ks


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
    f64, f32 = torch.float64, torch.float32
    sweeps = {
        "float64": phase_sweep(f64, dev, golden),
        "float32": phase_sweep(f32, dev, golden),
        "fused_float64": phase_sweep(f64, dev, golden, "fused"),
        "fused_float32": phase_sweep(f32, dev, golden, "fused"),
        "fused_compact_float64": phase_sweep(f64, dev, golden, "fused",
                                             "compact"),
        "mixed_float64": phase_sweep(f64, dev, golden, precision="mixed"),
        "fast_float64": phase_sweep(f64, dev, golden, precision="fast"),
        "fused_mixed_float64": phase_sweep(f64, dev, golden, "fused",
                                           precision="mixed"),
        "compact_float64": phase_sweep(f64, dev, golden, grid="compact"),
        "mixed_float32": phase_sweep(f32, dev, golden, precision="mixed"),
    }
    launches = dict(sweeps["float64"][0])
    launches32 = dict(sweeps["float32"][0])
    f_launches, f_launches32 = (sweeps["fused_float64"][0],
                                sweeps["fused_float32"][0])
    escalation_check(dev)
    phase_profile(dev)
    phase_profile(dev, "fused")
    fine_egm = phase_fine(dev)
    launches_c1 = phase_cell(dev, golden)
    launches_c1.update({k: v for k, v in phase_cell(dev, golden,
                                                    "fused").items() if v})
    mixed_c1 = phase_cell(dev, golden, precision="mixed")
    phase_illinois(dev, golden)
    engine = phase_engine(dev, golden, sweeps)
    fam_records, families = phase_families(dev, golden)
    launches_ks = phase_ks(dev)
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
    # the ladders' launches per f64 sweep (the tail mode's: compact)
    for k in kernels[:2]:
        for path in ("mixed_float64", "fast_float64", "fused_mixed_float64",
                     "compact_float64"):
            k[f"launches_{path}"] = sweeps[path][0][k["name"]]
        k["c1_launches_mixed"] = mixed_c1[k["name"]]
    kernels[-1]["launches_compact_f64"] = \
        sweeps["fused_compact_float64"][0]["fused_cell_grid"]
    # phase 9: each kernel's launches per f64 engine run (the fused
    # kernel's under kernel="fused"; a quarantine rung runs the reference
    # kernels)
    for k in kernels:
        k["launches_engine"] = {run: n[k["name"]]
                                for run, n in engine.items()}
    # phase 10: each kernel's launches per family run, and the two
    # reference kernels' checks and times at borrow_limit=-2
    for k in kernels:
        k["launches_families"] = {run: n[k["name"]]
                                  for run, n in families.items()}
        if k["name"] in fam_records:
            k["borrow_limit_minus_2"] = fam_records[k["name"]]
    # phase 11: the Krusell-Smith path runs none of the kernels (plain
    # PyTorch; no Pallas kernel on its JAX path either)
    for k in kernels:
        k["launches_ks"] = launches_ks[k["name"]]
    kernels[-1]["over_egm_plus_dist"] = fused_over_parts(records)
    print(json.dumps({
        "kernels": kernels,
        "sweep_wall_s": {k: v[1].wall_seconds for k, v in sweeps.items()},
        "polish_frac": {k: v[1].polish_frac() for k, v in sweeps.items()},
        "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
