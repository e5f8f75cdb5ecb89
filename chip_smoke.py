#!/usr/bin/env python3
"""Drive the PyTorch port of the Table II equilibrium on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):
  1. card: name and power limit, TF32 off, build of the CUDA kernels
     (one nvcc per source, all started together), beside phase 11, which
     runs first: its path launches none of them;
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
  7. the fine configuration (BASELINE.json config 2: A=1000, N=15,
     D=1000): the EGM kernel (float64) and the distribution kernel
     (float64 and float32) in their cluster layouts (the lane does not fit
     one block's shared memory), each bitwise equal to its plain version,
     to its global layout and, at C=4 (four prices), to four C=1 launches,
     both layouts timed in turns; the fused kernel (float64 and float32)
     in its cluster layout, bitwise its global layout, its plain version
     and the reference kernels' chain, timed in turns against each, and
     at N = 12 and 3 (A=D=1000, float64: blocks past the EGM phase's
     states join its barriers) bitwise its global layout and the chain.
     The compact grids at the fine width, every policy closed by the
     analytic tail: the EGM kernel's tail mode (compact A=851 in float64
     and float32, its coarse subset A=426 and the adaptive grid A=751 in
     float64) in its cluster layout, bitwise its plain version, its
     global layout and, at C=4, four C=1 launches, both layouts timed in
     turns; the fused kernel with the tail (A=851, D=926, float64 and
     float32) in its cluster layout, bitwise its global layout, its plain
     version and the tailed reference chain, timed in turns against the
     global layout and the chain;
     then solve_calibration_lean(**fine_grid_kwargs()) on the card in
     float64 (r* within 1e-6 pct of tests/data/torch_fine_golden.json, the JAX
     package's, trips, EGM and distribution steps equal, CONVERGED) and
     float32 (1 bp, trips equal), under the reference kernels (one launch
     of each a trip) and under kernel="fused" (one fused launch a trip),
     and bench.py's four fine lanes (CRRA 1, rho 0-0.9) as one
     solve_cells_lean batch, each lane bitwise its C=1 solve and within
     1e-6 pct of the golden; the fine cell on grid="compact" (float64 and
     float32) and grid="adaptive" (float64) under both kernel policies
     against the golden's grid records (reference kernels: float64 r*
     within 1e-6 pct, trips, EGM, distribution, descent and polish steps
     equal; float32 1 bp, trips equal; kernel="fused": one fused launch a
     trip, float64 within 1e-6 pct of the fused record with its counts
     where the golden has one and within 0.1 bp of the reference record,
     float32 within 1 bp).  Any number of labor states: the lottery and
     fused kernels at N = 17 and 40 (D = 500 and 40), every layout each
     size takes bitwise the plain version; config 1 (N=7, A=100, D=500)
     in float64 and float32 and the cells N = 17, 21, 40 (A=32, D=500)
     against their goldens, each kernel's layout printed;
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
     M-grid, dist_count=500; the solves over KS_DEPTH = 4000 periods, the
     fixed-rule panel over the notebook's act_T=11000;
     tests/data/torch_ks_golden.json from the JAX package, its act_T_4000
     record): AiyagariEconomy.solve(sim_method="distribution") on the
     first 4000 states of JAX's chain against the golden (outer iterations
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
 12. the model extensions (float64, the paper's width N=7, A=32, D=500,
     CRRA=2; tests/data/torch_extensions_golden.json from the JAX
     package, EXT_TOL): the steady state; the beta-dist economy (5 types
     as lanes, r* within 1e-6 pct with JAX's trips, one trip's C=5
     launches of both kernels bitwise their plain versions, degenerate
     types at the homogeneous r*); the tax sweep (8 rates as lanes, with
     welfare; the lean sweep under kernel="fused" within 0.1 bp, only the
     fused kernel launched); the calibrated discount factor and the
     Lorenz fit (at the JAX test's configuration); the labor economy (its
     lottery launch bitwise the plain version, the labor EGM's host
     syncs); the transition (T=100, 1 % TFP shock decaying at 0.8, JAX's
     iterations, host syncs per iteration), the sequence-space Jacobians,
     the linear-nonlinear gap and the shock-process fit; the credit
     crunch (the JAX test's configuration over a 50-period horizon, JAX's
     iterations at that horizon, its wall);
     the life cycle at horizon 40; each run's launches and wall.
 13. the two-asset portfolio economy (float64, the JAX defaults' width:
     N=7, A=48, K=7 return draws, S=25 shares, D=300; tests/data/
     torch_portfolio_golden.json from the JAX package): the real-risk
     equilibrium (CRRA 5, premium 0.04) with the golden's trips and EGM
     steps, r* within 1e-6 pct, the stocks within 1e-6; the household and
     distribution loops alone at the golden r* (steps, walls, host syncs,
     device kernels a step, busy share); the push-forward bitwise from run
     to run; the degenerate economy (risky_std=1e-5) within 7e-4 in r and
     3 % in capital of the single-asset equilibrium of the EGM and lottery
     kernels.  No kernel runs on the portfolio path (plain PyTorch, as
     XLA in the JAX package).
 14. the sweep engine's durability (float64, the paper's width, 12 cells,
     balanced, 3 buckets, a stall-injected cell): preempted and resumed,
     the locked schedule resumed through quarantine, a transient replayed
     in place, an escaped transient resumed, a flipped ledger row
     recomputed, each bitwise the uninterrupted run; a sidecar written and
     reread (predicted work = measured work) and the warm sidecar-seeded
     run's work against locked; the ledger's flush cost.
 15. observability (float64, the paper's width, 12 cells, locked), per
     kernel policy (reference, fused): the sweep with the journal, the
     trace, the cost ledger and a torch.profiler trace of its bucket, its
     rows bitwise phase 3's (5's) and its launches theirs; the journal's
     lifecycle events and one device-memory high-water mark under the
     card's memory; the ledger's snapshot with the card's peaks not
     assumed; the profiler trace naming the path's __global__ kernels;
     host syncs equal with obs off, journaled and profiled; walls off
     against on, in turns.  Then a quarantine and a transient drill, each
     journaling exactly one typed event.
 16. serving (float64, the paper's width, the reference kernels):
     EquilibriumService(start_worker=False, max_batch=4, ladder=(1, 2, 4))
     on the card.  The cold replay of the 12 cells (1e-6 pct of the
     golden, each lane bitwise a C=1 launch with its seed); a shuffled
     exact-hit replay (resolved at submit, no launch, no library built,
     the cold bits, hit p50 under 1 ms); a neighbour replay at rho - 0.05
     against a cold control (near rate, fewer bisection trips, 0.1 bp);
     certify_before_cache with a corrupted lane (CertificationFailed, not
     cached); a NaN lane failing only its future; the threaded worker fed
     by 4 client threads (the cold bits); a disk store reopened (hits
     bitwise, a perturbed entry evicted and re-solved); four Huggett cells
     cold (1e-6 pct of tests/data/torch_families_golden.json), exact and
     near; two cells under kernel="fused" (0.1 bp).  The walls, the hit
     p50, the near rate and each run's launches are logged.
 17. the serving fleet (float64, the reference kernels), after phase 1's
     build so no worker runs nvcc: (a) a FleetFront over one
     EquilibriumService on the card, the 12 cells queried by a
     FleetClient over HTTP at the paper's width from 4 client threads,
     every value bitwise phase 16's cold bits, the hits, and JAX's HTTP
     codes for a past deadline, an unknown scenario, an unknown path, a
     chaos arm on a worker without --chaos and a NaN lane; (b)
     run_fleet_load with 4 worker processes (python -m
     aiyagari_hark_tpu_torch.serve.fleet --device cuda) on the card over
     one shared store at the paper's width, bench.py's _fleet_smoke spec
     (30 queries a worker, zipf 0.8, prefetch_k=2, lease TTL 2 s, worker
     3 SIGTERMed after 10): every arrival served, dedup 1.0, no leaked
     lease, exit 75, every served value bitwise its same-seed C=1 launch
     in this process and equal on every worker that served it; (c)
     bench.py's _chaos_smoke (the five drills, churn) and (d) _dr_smoke
     (a 3-replica quorum of replica processes, the five DR drills, the
     full-fleet SIGKILL with a live lease, the record maps recovered
     bitwise, a fresh pool re-serving every cell), both at bench.py's
     SERVE_SMOKE_KWARGS width.  In each leg every worker holds a context
     on the card and no replica does (nvidia-smi's compute apps counted
     against the live children), and no worker builds a library (its
     /metrics).  The walls, p50/p99 per path and each worker's launches
     (from its exit line) are logged.
 18. sharding (float64, the paper's width, the 12 Table II cells; every
     mesh over virtual entries of the one card, parallel.mesh.
     virtual_devices): (a) run_table2_sweep with mesh="auto" (None on one
     card) and a cells mesh of 2, 3, 4 and 8 shards (12 cells pad to 16),
     every packed field bitwise phase 3's, and at 4 shards under
     kernel="fused" bitwise phase 5's; (b) state_shards=2 on the four
     sigma = 1 cells (M = 4 and the other 8 cells cut for time; the CPU
     tests hold them): r* within 0.1 bp
     of phase 3, statuses equal, the EGM grid kernel launched and the
     lottery grid kernel not (the row-block push-forward is plain
     PyTorch, one CUDA graph a step, held bitwise against the eager
     push); state="sharded" with no mesh bitwise phase 3; a NaN in cell 2
     recovered by a replicated rung, the other cells bitwise the clean
     run; (c) EquilibriumService with a 4-shard lane mesh, the 12-cell
     cold replay bitwise phase 16's, and with state_shards=2, two cells
     ((1, 0) and (5, 0.6)) within 0.1 bp; the two together refused;
     (d) the notebook's Krusell-Smith calibration at the wealth
     study's rule, 200 periods: simulate_panel_sharded on one shard bitwise
     simulate_panel, on 4 shards (352 agents) finite, positive, mean
     capital within 0.8-1.25 of the unsharded run, ms a period; (e)
     multihost.initialize over one NCCL rank: an all_reduce, then (a)'s
     4-shard sweep through the group-spanning mesh bitwise (a).  Walls,
     the dense operator's bytes and each run's launches are logged.
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
import threading
import time
import warnings

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "data", "table2_golden.json")
WIDTH = dict(a_count=32, dist_count=500)      # the paper's grid, 7 states
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
T0 = time.perf_counter()                      # the script's start


def log(tag, **fields):
    """One JSON line per phase, with the card beside every number and the
    seconds since the script started (``t_s``: a phase's wall is the
    difference between its last line's and the previous phase's)."""
    print(json.dumps({"phase": tag, **fields, "card": CARD,
                      "t_s": time.perf_counter() - T0}), flush=True)


# Each phase's end, seconds since the script started (``stamp``); the
# script prints each phase's wall (from the end of the one before) on one
# line before the kernels' record.
PHASE_ENDS: dict = {}


def stamp(phase: str) -> None:
    PHASE_ENDS[phase] = time.perf_counter() - T0


def phase_walls() -> dict:
    ends = list(PHASE_ENDS.values())
    return {p: t - (ends[i - 1] if i else 0.0)
            for i, (p, t) in enumerate(PHASE_ENDS.items())}


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


def kernel_pair_check(dev, dt, model, R, W, crra, disc_fac=0.96, **tag):
    """The EGM kernel, then the lottery kernel on its policy, each against
    its plain version on the lanes of ``model`` at prices (R, W) and
    discount factors ``disc_fac`` (a scalar or one per lane), cold start:
    equal step counts and bitwise equal values, C lanes bitwise equal to C
    launches of one lane, the default layout bitwise equal to the global
    one; times with CUDA events (both layouts in turns), per step of the
    slowest lane, of the slowest lane alone, and the plain versions'
    walls.  ``tag`` goes into both records and the log lines.  Returns
    the two records."""
    from aiyagari_hark_tpu_torch.models import household as H
    from aiyagari_hark_tpu_torch.ops import kernels as K

    egm_tol, dist_tol = INNER_TOL[dt]
    C = R.shape[0]
    p0 = H.initial_policy(model)
    sc = H._scalars(R, W, model, disc_fac, crra)
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
    """(least ms, "bytes" or "operations") at the H100 SXM's data-sheet
    peaks (HBM3 bytes/s; FP64/FP32 outside the tensor cores), the
    package's constants (``utils.timing``) that the cost ledger reads."""
    from aiyagari_hark_tpu_torch.utils.timing import (H100_SXM_BYTES_PER_S,
                                                      H100_SXM_PEAK_FLOPS)

    t_bytes = nbytes / H100_SXM_BYTES_PER_S
    t_ops = flops / H100_SXM_PEAK_FLOPS[str(dt).rsplit(".", 1)[-1]]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _dims(dt, model):
    """(itemsize, N, A, D) of a lane-batched model."""
    return (torch.finfo(dt).bits // 8, model.labor_levels.shape[1],
            model.a_grid.shape[1], model.dist_grid.shape[1])


def egm_work(dt, C, model, iters, K=None):
    """(bytes, operations) of the EGM fixed points of this run: the
    package's work model (``obs.profile.egm_work``, which the cost ledger
    reads too) on this run's summed steps."""
    from aiyagari_hark_tpu_torch.obs import profile as P

    s, N, A, _ = _dims(dt, model)
    return P.egm_work(s, C, N, A, float(iters.sum()), K)


def dist_work(dt, C, model, iters):
    """(bytes, operations) of the distribution fixed points of this run
    (``obs.profile.dist_work``)."""
    from aiyagari_hark_tpu_torch.obs import profile as P

    s, N, _, D = _dims(dt, model)
    return P.dist_work(s, C, N, D, float(iters.sum()))


def egm_bound(dt, C, model, iters):
    return _bound(dt, *egm_work(dt, C, model, iters))


def dist_bound(dt, C, model, iters):
    return _bound(dt, *dist_work(dt, C, model, iters))


def fused_bound(dt, C, model, egm_iters, dist_iters, tail):
    """Least time for the fused supply evaluations of this run
    (``obs.profile.fused_work`` on this run's steps)."""
    from aiyagari_hark_tpu_torch.obs import profile as P

    s, N, A, D = _dims(dt, model)
    nbytes, ops = P.fused_work(s, C, N, A, D, float(egm_iters.sum()),
                               float(dist_iters.sum()), tail)
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
    """The fine configuration's kernels (A=1000, N=15, D=1000).  The EGM
    lane (851 KB as one block, float64) must take the cluster layout; on
    one cell it matches its plain version bitwise and its global layout
    (force_global) bitwise, both layouts timed in turns; at C=4 (four
    prices) one launch equals four C=1 launches bitwise.  The distribution
    kernel, on those policies, in float64 and float32:
    ``fine_lottery_check``.  The fused kernel: ``fine_fused_check`` and
    ``fused_cluster_states_check``.  Returns the EGM record, the two
    lottery records and the fused ones."""
    from aiyagari_hark_tpu_torch.models import firm
    from aiyagari_hark_tpu_torch.models import household as H
    from aiyagari_hark_tpu_torch.ops import kernels as K

    dt = torch.float64
    N, A = 15, 1000
    base = H.build_simple_model(labor_states=N, a_count=A, dist_count=1000,
                                labor_ar=0.6, dtype=dt, device=dev)
    model1 = H.stack_models([base])
    model = H.stack_models([base] * 4)
    r = torch.tensor(FINE_RATES, dtype=dt, device=dev)
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

    lottery = [fine_lottery_check(dev, dt, four if dt == torch.float64
                                  else None) for dt in FINE_DTYPES]
    return (egm, lottery, fine_fused_check(dev)
            + fused_cluster_states_check(dev))


# Phase 7: the fine configuration's lottery lanes and equilibria.
FINE_GOLDEN = os.path.join(HERE, "tests", "data", "torch_fine_golden.json")
FINE_DTYPES = (torch.float64, torch.float32)
FINE_RATES = (0.04, 0.03, 0.035, 0.045)
# r* against the JAX golden: ROADMAP's slice rule in float64, 1 bp in
# float32 (the JAX accelerator path's contract)
FINE_RSTAR_PCT = {torch.float64: 1e-6, torch.float32: 1e-2}


def _fine_lanes(dev, dt, pol=None, rates=FINE_RATES):
    """The fine model (rho 0.6) as one lane per rate of ``rates``, their
    prices and EGM policies (``pol``: phase 7's C=4 knots, else solved
    here)."""
    from aiyagari_hark_tpu_torch.models import firm
    from aiyagari_hark_tpu_torch.models import household as H
    from aiyagari_hark_tpu_torch.ops import kernels as K
    from aiyagari_hark_tpu_torch.utils.config import fine_grid_kwargs

    kw = fine_grid_kwargs()
    crra = kw.pop("crra")
    base = H.build_simple_model(dtype=dt, device=dev, **kw)
    model = H.stack_models([base] * len(rates))
    r = torch.tensor(rates, dtype=dt, device=dev)
    R, W = 1.0 + r, firm.wage_rate(firm.k_to_l_from_r(r, 0.36, 0.08), 0.36)
    if pol is None:
        p0 = H.initial_policy(model)
        pol = K.egm_policy_grid(p0.m_knots, p0.c_knots, model.a_grid,
                                model.labor_levels, model.transition,
                                H._scalars(R, W, model, 0.96, crra),
                                INNER_TOL[dt][0])
    return model, R, W, H.HouseholdPolicy(pol[0], pol[1])


def fine_lottery_check(dev, dt, pol=None):
    """The lottery kernel at the fine width (D=1000, N=15) on the policies
    of FINE_RATES: it takes the cluster layout; at r = 4 % (C=1) it is
    bitwise its plain version (run once) and its global layout, both
    layouts timed in turns; one C=4 launch is bitwise four C=1 launches.
    Returns the record."""
    from aiyagari_hark_tpu_torch.models import household as H
    from aiyagari_hark_tpu_torch.ops import kernels as K

    model, R, W, pol = _fine_lanes(dev, dt, pol)
    dist_tol = INNER_TOL[dt][1]
    trans = H.wealth_transition(pol, R, W, model)
    args4 = (trans.idx, trans.weight, model.transition,
             H.initial_distribution(model))
    args = tuple(t[:1] for t in args4) + (dist_tol,)
    D, N = args4[3].shape[1:]
    layout = K.stationary_lottery_grid_layout(D, N, dt)
    if layout != "cluster":
        raise AssertionError(f"the fine {dt} distribution lane takes the "
                             f"{layout} layout, not the cluster one")
    out = K.stationary_lottery_grid(*args)
    t0 = time.perf_counter()
    plain = K.stationary_lottery_grid_plain(*args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = close(out[0], plain[0], dt, dist_tol)
    if not all(torch.equal(x, y) for x, y in zip(out, plain)):
        raise AssertionError(f"fine {dt} stationary_lottery_grid (cluster) "
                             f"is not bitwise equal to its plain version: "
                             f"steps {out[1].tolist()} vs "
                             f"{plain[1].tolist()}, max abs error {err}")
    if not all(torch.equal(x, y) for x, y in zip(
            K.stationary_lottery_grid(*args, force_global=True), out)):
        raise AssertionError(f"fine {dt} stationary_lottery_grid: the "
                             f"cluster layout is not bitwise equal to the "
                             f"global one")
    four = K.stationary_lottery_grid(*args4, dist_tol)
    for lane in range(len(FINE_RATES)):
        one = K.stationary_lottery_grid(
            *(t[lane:lane + 1] for t in args4), dist_tol)
        if not all(torch.equal(x[0], y[lane]) for x, y in zip(one, four)):
            raise AssertionError(f"fine {dt} stationary_lottery_grid lane "
                                 f"{lane}: C=1 is not bitwise equal to C=4")
    steps = int(out[1][0])
    rec = dict(dtype=str(dt), D=D, N=N, layout=layout,
               cluster=K.stationary_lottery_grid_cluster(D, N, dt),
               iters=out[1].tolist(), c4_iters=four[1].tolist(),
               max_abs_err=err, bitwise_vs_plain=True,
               bitwise_global_cluster=True, bitwise_c1_c4=True,
               plain_ms=plain_ms)
    rec["kernel_ms"], rec["global_ms"] = paired_ms(
        lambda: K.stationary_lottery_grid(*args),
        lambda: K.stationary_lottery_grid(*args, force_global=True), reps=3)
    rec["ns_per_step"] = 1e6 * rec["kernel_ms"] / steps
    rec["global_ns_per_step"] = 1e6 * rec["global_ms"] / steps
    rec["c4_ms"] = cuda_ms(lambda: K.stationary_lottery_grid(
        *args4, dist_tol), reps=3)
    rec["bound_ms"], rec["bound_by"] = dist_bound(dt, 1, model, out[1])
    rec["c4_bound_ms"] = dist_bound(dt, len(FINE_RATES), model, four[1])[0]
    log("fine_lottery", **rec)
    return rec


def fine_fused_check(dev):
    """The fused kernel at the fine width (r = 4 %, C=1), float64 and
    float32: it takes its cluster layout (8 blocks: the EGM phase split by
    labor state, the lottery sorted into a global workspace, the
    distribution split by target row) and is bitwise its global layout
    (force_global) and the reference kernels' chain on the card (the EGM
    kernel, wealth_transition, the lottery kernel, both in their cluster
    layouts, each bitwise its plain version in phase 7, so the fused
    kernel is its plain version's bits too).  Times, each pair in turns:
    the cluster against the global layout, the cluster against the
    chain; the cluster and the global layout with no distribution step;
    ns per distribution step; the bound.  Returns the records."""
    from aiyagari_hark_tpu_torch.models import household as H
    from aiyagari_hark_tpu_torch.ops import kernels as K

    recs = []
    for dt in FINE_DTYPES:
        egm_tol, dist_tol = INNER_TOL[dt]
        model, R, W, pol = _fine_lanes(dev, dt, rates=FINE_RATES[:1])
        trans = H.wealth_transition(pol, R, W, model)
        d0 = H.initial_distribution(model)
        dist, dit, ddiff = K.stationary_lottery_grid(
            trans.idx, trans.weight, model.transition, d0, dist_tol)
        p0 = H.initial_policy(model)
        sc = H._scalars(R, W, model, 0.96, 3.0)
        args = (p0.m_knots, p0.c_knots, model.a_grid, model.dist_grid,
                model.labor_levels, model.transition, sc,
                torch.zeros_like(model.labor_levels), d0)
        kw = dict(tol=egm_tol, dist_tol=dist_tol)
        N, A, D = model.labor_levels.shape[1], model.a_grid.shape[1], \
            d0.shape[1]
        layout = K.fused_cell_grid_layout(N, A, D, False, dt)
        if layout != "cluster":
            raise AssertionError(f"the fine {dt} fused lane takes the "
                                 f"{layout} layout, not the cluster one")
        out = K.fused_cell_grid(*args, **kw)
        if not all(torch.equal(x, y) for x, y in zip(
                (out[0], out[1], out[2], out[5], out[6]),
                (pol.m_knots, pol.c_knots, dist, dit, ddiff))):
            raise AssertionError(f"fine {dt} fused_cell_grid (cluster) is "
                                 f"not bitwise the reference kernels' chain")
        if not all(torch.equal(x, y) for x, y in zip(
                K.fused_cell_grid(*args, **kw, force_global=True), out)):
            raise AssertionError(f"fine {dt} fused_cell_grid: the cluster "
                                 f"layout is not bitwise the global one")

        def chain():
            m, c, _, _ = K.egm_policy_grid(*args[:2], model.a_grid,
                                           model.labor_levels,
                                           model.transition, sc, egm_tol)
            tr = H.wealth_transition(H.HouseholdPolicy(m, c), R, W, model)
            return K.stationary_lottery_grid(tr.idx, tr.weight,
                                             model.transition, d0, dist_tol)

        rec = dict(dtype=str(dt), N=N, A=A, D=D, layout=layout,
                   cluster=K.fused_cell_grid_cluster(N, A, D, dt),
                   egm_iters=out[3].tolist(), dist_iters=out[5].tolist(),
                   bitwise_vs_reference_kernels=True,
                   bitwise_global_cluster=True)
        fused = lambda: K.fused_cell_grid(*args, **kw)  # noqa: E731
        rec["kernel_ms"], rec["global_ms"] = paired_ms(
            fused, lambda: K.fused_cell_grid(*args, **kw, force_global=True),
            reps=2)
        rec["turns_ms"], rec["chain_ms"] = paired_ms(fused, chain, reps=2)
        rec["no_dist_ms"], rec["global_no_dist_ms"] = paired_ms(
            lambda: K.fused_cell_grid(*args, **kw, dist_max_iter=0),
            lambda: K.fused_cell_grid(*args, **kw, dist_max_iter=0,
                                      force_global=True), reps=2)
        steps = int(out[5][0])
        rec["dist_ns_per_step"] = 1e6 * (rec["kernel_ms"]
                                         - rec["no_dist_ms"]) / steps
        rec["global_dist_ns_per_step"] = 1e6 * (
            rec["global_ms"] - rec["global_no_dist_ms"]) / steps
        rec["bound_ms"], rec["bound_by"] = fused_bound(dt, 1, model, out[3],
                                                       out[5], False)
        log("fine_fused", **rec)
        recs.append(rec)
    return recs


# Labor-state counts whose EGM phase holds fewer than 8 blocks of states
# (egm_cluster_blocks: 6 at N=12, 3 at N=3): the fused cluster's other
# blocks only join its barriers and sums.
FUSED_CLUSTER_STATES = (12, 3)


def fused_cluster_states_check(dev):
    """The fused kernel's cluster at the fine width's A and D with N = 12
    and 3 labor states (float64, r = 4 %, C=1), where blocks past the EGM
    states hold none: it takes the cluster layout and is bitwise its
    global layout and the reference kernels' chain.  Returns the
    records."""
    from aiyagari_hark_tpu_torch.models import firm
    from aiyagari_hark_tpu_torch.models import household as H
    from aiyagari_hark_tpu_torch.ops import kernels as K

    dt = torch.float64
    egm_tol, dist_tol = INNER_TOL[dt]
    A = D = 1000
    recs = []
    for N in FUSED_CLUSTER_STATES:
        model = H.stack_models([H.build_simple_model(
            labor_states=N, a_count=A, dist_count=D, labor_ar=0.6, dtype=dt,
            device=dev)])
        r = torch.tensor([0.04], dtype=dt, device=dev)
        R = 1.0 + r
        W = firm.wage_rate(firm.k_to_l_from_r(r, 0.36, 0.08), 0.36)
        p0 = H.initial_policy(model)
        sc = H._scalars(R, W, model, 0.96, 3.0)
        d0 = H.initial_distribution(model)
        args = (p0.m_knots, p0.c_knots, model.a_grid, model.dist_grid,
                model.labor_levels, model.transition, sc,
                torch.zeros_like(model.labor_levels), d0)
        kw = dict(tol=egm_tol, dist_tol=dist_tol)
        layout = K.fused_cell_grid_layout(N, A, D, False, dt)
        if layout != "cluster":
            raise AssertionError(f"the fused lane of {N} states at the fine "
                                 f"width takes the {layout} layout")
        out = K.fused_cell_grid(*args, **kw)
        m, c, eit, ediff = K.egm_policy_grid(*args[:3], model.labor_levels,
                                             model.transition, sc, egm_tol)
        tr = H.wealth_transition(H.HouseholdPolicy(m, c), R, W, model)
        dist, dit, ddiff = K.stationary_lottery_grid(
            tr.idx, tr.weight, model.transition, d0, dist_tol)
        if not all(torch.equal(x, y) for x, y in zip(
                out, (m, c, dist, eit, ediff, dit, ddiff))):
            raise AssertionError(f"fused cluster at N={N} is not bitwise "
                                 f"the reference kernels' chain")
        if not all(torch.equal(x, y) for x, y in zip(
                K.fused_cell_grid(*args, **kw, force_global=True), out)):
            raise AssertionError(f"fused cluster at N={N} is not bitwise "
                                 f"its global layout")
        rec = dict(dtype=str(dt), N=N, A=A, D=D, layout=layout,
                   egm_blocks_holding_states=int(K._library(
                       "egm_policy_grid").egm_policy_grid_cluster_blocks(N)),
                   egm_iters=out[3].tolist(), dist_iters=out[5].tolist(),
                   bitwise_vs_reference_kernels=True,
                   bitwise_global_cluster=True)
        log("fine_fused_states", **rec)
        recs.append(rec)
    return recs


# The fine configuration on the compact grids (every policy closed by the
# analytic tail, K = A+3 knots): the EGM kernel's lanes, (grid, dtype,
# coarse) -- the compact grid (A=851) in float64 and float32, its coarse
# subset (A=426, the grid ladder's descent) and the adaptive grid (A=751)
# in float64 -- and the fused kernel's compact lane (A=851, D=926).
FINE_TAIL_EGM = (("compact", torch.float64, False),
                 ("compact", torch.float32, False),
                 ("compact", torch.float64, True),
                 ("adaptive", torch.float64, False))


def _fine_tail_lanes(dev, dt, grid, rates=FINE_RATES):
    """The fine model (rho 0.6, CRRA 3) on a compact ``grid`` as one lane
    per rate of ``rates``: (model, R, W, scalars, the tail's intercept h,
    the tail-closed initial policy)."""
    from aiyagari_hark_tpu_torch.models import firm
    from aiyagari_hark_tpu_torch.models import household as H
    from aiyagari_hark_tpu_torch.utils.config import fine_grid_kwargs

    kw = fine_grid_kwargs()
    crra = kw.pop("crra")
    base = H.build_simple_model(dtype=dt, device=dev, grid=grid, **kw)
    model = H.stack_models([base] * len(rates))
    r = torch.tensor(rates, dtype=dt, device=dev)
    R, W = 1.0 + r, firm.wage_rate(firm.k_to_l_from_r(r, 0.36, 0.08), 0.36)
    sc = H._scalars(R, W, model, 0.96, crra)
    h = H.perfect_foresight_human_wealth(R, W, model.labor_levels,
                                         model.transition)
    return model, R, W, sc, h, H.initial_policy(model, analytic_tail=True)


def fine_tail_egm_check(dev):
    """The EGM kernel's tail mode at the fine width on the compact grids
    (FINE_TAIL_EGM, four prices FINE_RATES): each lane takes the cluster
    layout (one block cannot hold it); at r = 4 % (C=1) it is bitwise its
    plain version and its global layout, both layouts timed in turns; one
    C=4 launch is bitwise four C=1 launches.  Returns the records."""
    from aiyagari_hark_tpu_torch.models import household as H
    from aiyagari_hark_tpu_torch.ops import kernels as K

    lib = K._library("egm_policy_grid")
    recs = []
    for grid, dt, coarse in FINE_TAIL_EGM:
        egm_tol = INNER_TOL[dt][0]
        model, _, _, sc, h, p0 = _fine_tail_lanes(dev, dt, grid)
        if coarse:
            idx = H._coarse_knot_indices(model.a_grid.shape[1])
            model = model._replace(a_grid=model.a_grid[:, idx])
            p0 = H._restrict_policy(p0, idx)
        N, A = model.labor_levels.shape[1], model.a_grid.shape[1]
        args4 = (p0.m_knots, p0.c_knots, model.a_grid, model.labor_levels,
                 model.transition, sc)
        args = tuple(t[:1] for t in args4) + (egm_tol,)
        kw = dict(h=h[:1], tail=True)
        tag = f"{grid} {dt}, A={A}"
        layout = K.egm_policy_grid_layout(N, A, dt, tail=True)
        if layout != "cluster":
            raise AssertionError(f"the fine tailed EGM lane ({tag}) takes "
                                 f"the {layout} layout, not the cluster one")
        out = K.egm_policy_grid(*args, **kw)
        t0 = time.perf_counter()
        plain = K.egm_policy_grid_plain(*args, **kw)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        err = max(close(out[0], plain[0], dt, egm_tol),
                  close(out[1], plain[1], dt, egm_tol))
        if not all(torch.equal(x, y) for x, y in zip(out, plain)):
            raise AssertionError(f"fine tailed egm_policy_grid ({tag}) is "
                                 f"not bitwise its plain version: steps "
                                 f"{out[2].tolist()} vs {plain[2].tolist()},"
                                 f" max abs error {err}")
        if not all(torch.equal(x, y) for x, y in zip(
                K.egm_policy_grid(*args, **kw, force_global=True), out)):
            raise AssertionError(f"fine tailed egm_policy_grid ({tag}): the "
                                 f"cluster layout is not bitwise the global "
                                 f"one")
        four = K.egm_policy_grid(*args4, egm_tol, h=h, tail=True)
        for lane in range(len(FINE_RATES)):
            one = K.egm_policy_grid(*(t[lane:lane + 1] for t in args4),
                                    egm_tol, h=h[lane:lane + 1], tail=True)
            if not all(torch.equal(x[0], y[lane]) for x, y in zip(one, four)):
                raise AssertionError(f"fine tailed egm_policy_grid ({tag}) "
                                     f"lane {lane}: C=1 is not bitwise C=4")
        steps = int(out[2][0])
        f64 = int(dt == torch.float64)
        rec = dict(grid=grid, dtype=str(dt), tail=True,
                   ladder_phase="coarse" if coarse else "fine", N=N, A=A,
                   knots=A + 3, layout=layout,
                   cluster_blocks=int(lib.egm_policy_grid_cluster_blocks(N)),
                   workspace_bytes=int(lib.egm_policy_grid_workspace_bytes(
                       N, A, 1, f64)),
                   cluster_block_bytes=int(lib.egm_policy_grid_cluster_bytes(
                       N, A, 1, f64)),
                   iters=out[2].tolist(), c4_iters=four[2].tolist(),
                   max_abs_err=err, bitwise_vs_plain=True,
                   bitwise_global_cluster=True, bitwise_c1_c4=True,
                   plain_ms=plain_ms)
        rec["kernel_ms"], rec["global_ms"] = paired_ms(
            lambda: K.egm_policy_grid(*args, **kw),
            lambda: K.egm_policy_grid(*args, **kw, force_global=True),
            reps=3)
        rec["ns_per_step"] = 1e6 * rec["kernel_ms"] / steps
        rec["global_ns_per_step"] = 1e6 * rec["global_ms"] / steps
        rec["bound_ms"], rec["bound_by"] = _bound(
            dt, *egm_work(dt, 1, model, out[2], A + 3))
        log("fine_egm_tail", **rec)
        recs.append(rec)
    return recs


def fine_tail_fused_check(dev):
    """The fused kernel with the tail at the fine compact width (A=851,
    D=926, r = 4 %, C=1), float64 and float32: it takes its cluster layout
    and is bitwise its global layout, its plain version (run once, timed)
    and the tailed reference chain on the card (the EGM kernel's tail
    mode, wealth_transition, the lottery kernel).  Times, each pair in
    turns: the cluster against the global layout, the cluster against the
    chain; both layouts with no distribution step; ns per distribution
    step; the bound.  Returns the records."""
    from aiyagari_hark_tpu_torch.models import household as H
    from aiyagari_hark_tpu_torch.ops import kernels as K

    recs = []
    for dt in FINE_DTYPES:
        egm_tol, dist_tol = INNER_TOL[dt]
        model, R, W, sc, h, p0 = _fine_tail_lanes(dev, dt, "compact",
                                                  FINE_RATES[:1])
        d0 = H.initial_distribution(model)
        args = (p0.m_knots, p0.c_knots, model.a_grid, model.dist_grid,
                model.labor_levels, model.transition, sc, h, d0)
        kw = dict(tol=egm_tol, dist_tol=dist_tol, tail=True)
        N, A, D = model.labor_levels.shape[1], model.a_grid.shape[1], \
            d0.shape[1]
        layout = K.fused_cell_grid_layout(N, A, D, True, dt)
        if layout != "cluster":
            raise AssertionError(f"the fine compact {dt} fused lane takes "
                                 f"the {layout} layout, not the cluster one")

        def chain():
            m, c, eit, ediff = K.egm_policy_grid(
                *args[:3], model.labor_levels, model.transition, sc,
                egm_tol, h=h, tail=True)
            tr = H.wealth_transition(H.HouseholdPolicy(m, c), R, W, model)
            return (m, c) + K.stationary_lottery_grid(
                tr.idx, tr.weight, model.transition, d0, dist_tol) \
                + (eit, ediff)

        out = K.fused_cell_grid(*args, **kw)
        m, c, dist, dit, ddiff, eit, ediff = chain()
        if not all(torch.equal(x, y) for x, y in zip(
                out, (m, c, dist, eit, ediff, dit, ddiff))):
            raise AssertionError(f"fine compact {dt} fused_cell_grid "
                                 f"(cluster) is not bitwise the tailed "
                                 f"reference kernels' chain")
        if not all(torch.equal(x, y) for x, y in zip(
                K.fused_cell_grid(*args, **kw, force_global=True), out)):
            raise AssertionError(f"fine compact {dt} fused_cell_grid: the "
                                 f"cluster layout is not bitwise the global "
                                 f"one")
        t0 = time.perf_counter()
        plain = K.fused_cell_grid_plain(*args, egm_tol, dist_tol=dist_tol,
                                        tail=True)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        err = close(out[2], plain[2], dt, dist_tol)
        if not all(torch.equal(x, y) for x, y in zip(out, plain)):
            raise AssertionError(f"fine compact {dt} fused_cell_grid is not "
                                 f"bitwise its plain version (max abs error "
                                 f"{err})")
        rec = dict(grid="compact", dtype=str(dt), tail=True, N=N, A=A, D=D,
                   layout=layout,
                   cluster=K.fused_cell_grid_cluster(N, A, D, dt, tail=True),
                   egm_iters=out[3].tolist(), dist_iters=out[5].tolist(),
                   max_abs_err=err, bitwise_vs_plain=True,
                   bitwise_vs_reference_kernels=True,
                   bitwise_global_cluster=True, plain_ms=plain_ms)
        fused = lambda: K.fused_cell_grid(*args, **kw)  # noqa: E731
        rec["kernel_ms"], rec["global_ms"] = paired_ms(
            fused, lambda: K.fused_cell_grid(*args, **kw, force_global=True),
            reps=2)
        rec["turns_ms"], rec["chain_ms"] = paired_ms(fused, chain, reps=2)
        rec["no_dist_ms"], rec["global_no_dist_ms"] = paired_ms(
            lambda: K.fused_cell_grid(*args, **kw, dist_max_iter=0),
            lambda: K.fused_cell_grid(*args, **kw, dist_max_iter=0,
                                      force_global=True), reps=2)
        steps = int(out[5][0])
        rec["dist_ns_per_step"] = 1e6 * (rec["kernel_ms"]
                                         - rec["no_dist_ms"]) / steps
        rec["global_dist_ns_per_step"] = 1e6 * (
            rec["global_ms"] - rec["global_no_dist_ms"]) / steps
        rec["bound_ms"], rec["bound_by"] = fused_bound(dt, 1, model, out[3],
                                                       out[5], True)
        log("fine_fused_tail", **rec)
        recs.append(rec)
    return recs


def _lean_fields(res, lane=None):
    """A lean equilibrium's fields, of one lane of a batch."""
    return {f: (v if lane is None else v[lane])
            for f, v in res._asdict().items()}


def _golden_solve(dev, fn, *a, kernel="reference", **kw):
    """One lean solve on the card, its launch counters set to 0 just
    before it and read just after: one launch of each kernel of the path
    per trip (two of the EGM kernel under the reference kernels on a
    compact grid: the grid ladder's descent and polish), none of any
    other.  Returns (result, wall s, launches)."""
    from aiyagari_hark_tpu_torch.ops import kernels as K

    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn(*a, device=dev, kernel=kernel, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    trips = int(res.bisect_iters.max())
    ladder = kernel == "reference" and kw.get("grid", "reference") in (
        "compact", "adaptive")
    for name, n in launches.items():
        want = trips if name in PATH_KERNELS[kernel] else 0
        if ladder and name == "egm_policy_grid":
            want *= 2
        if n != want:
            raise AssertionError(f"a {kernel} solve of {trips} trips "
                                 f"launched {name} {n} times")
    return res, wall, launches


def _golden_cell_check(tag, res, dt, g, **fields):
    """A lean solve against its JAX golden record under the slice rule:
    r* within FINE_RSTAR_PCT, trips equal, and in float64 the EGM and
    distribution steps (and the descent and polish steps where the record
    holds them) equal and CONVERGED.  Logs the comparison."""
    from aiyagari_hark_tpu_torch.solver_health import status_name

    got = {f: float(v) if v.is_floating_point() else int(v)
           for f, v in _lean_fields(res).items()}
    dr = abs(100.0 * got["r_star"] - g["r_star_pct"])
    counts = ("bisect_iters", "egm_iters", "dist_iters") + tuple(
        k for k in ("descent_steps", "polish_steps") if k in g)
    log(tag, dtype=str(dt), dr_star_pct=dr,
        status_name=status_name(got["status"]),
        golden={k: g[k] for k in ("r_star_pct",) + counts}, **fields, **got)
    if not dr <= FINE_RSTAR_PCT[dt]:
        raise AssertionError(f"{tag} {dt} r* is {dr} pct from the golden, "
                             f"above {FINE_RSTAR_PCT[dt]}")
    same = counts if dt == torch.float64 else counts[:1]
    if any(got[k] != g[k] for k in same):
        raise AssertionError(f"{tag} {dt} counts {[got[k] for k in same]} "
                             f"vs the golden's {[g[k] for k in same]}")
    if dt == torch.float64 and status_name(got["status"]) != "CONVERGED":
        raise AssertionError(f"{tag} f64 status {status_name(got['status'])}")


def phase_fine_equilibrium(dev):
    """The fine configuration solved end to end on the card
    (solve_calibration_lean(**fine_grid_kwargs()), the path a user
    calls), float64 and float32, under the reference kernels and under
    kernel="fused" (the fused kernel's cluster layout), against
    tests/data/torch_fine_golden.json (the JAX package on the CPU): r*
    within FINE_RSTAR_PCT, trips equal, and in float64 the EGM and
    distribution steps equal and CONVERGED.  Then the four lanes of
    bench.py's fine-lanes run (CRRA 1, rho 0, 0.3, 0.6, 0.9) as one
    solve_cells_lean batch in float64, each lane bitwise its C=1 solve and
    within 1e-6 pct of the golden.  Each solve's counters are set to 0
    just before it and read just after: one launch of each kernel of its
    path per trip.  Returns the launches by run."""
    from aiyagari_hark_tpu_torch.models.equilibrium import (
        solve_calibration_lean, solve_cells_lean)
    from aiyagari_hark_tpu_torch.utils.config import fine_grid_kwargs

    with open(FINE_GOLDEN) as f:
        golden = json.load(f)

    def solve(fn, *a, **kw):
        return _golden_solve(dev, fn, *a, **kw)

    out = {}
    kw = fine_grid_kwargs()
    crra, rho = kw.pop("crra"), kw.pop("labor_ar")
    for kernel in ("reference", "fused"):
        for dt in FINE_DTYPES:
            name = str(dt).rsplit(".", 1)[-1]
            res, wall, launches = solve(solve_calibration_lean, crra, rho,
                                        dtype=dt, kernel=kernel, **kw)
            _golden_cell_check("fine_equilibrium", res, dt,
                               golden["fine"][name], kernel=kernel,
                               wall_s=wall, launches=launches)
            out[f"fine_{name}" if kernel == "reference"
                else f"fine_fused_{name}"] = launches

    dt = torch.float64
    cells = [(g["crra"], g["labor_ar"], 0.2) for g in golden["lanes"]]
    res4, wall4, out["fine_lanes4"] = solve(solve_cells_lean, cells,
                                            dtype=dt, **kw)
    walls1 = []
    for lane, (c, r, _) in enumerate(cells):
        one, wall1, _ = solve(solve_calibration_lean, c, r, dtype=dt, **kw)
        walls1.append(wall1)
        a, b = _lean_fields(one), _lean_fields(res4, lane)
        if not all(torch.equal(a[f], b[f]) for f in a):
            raise AssertionError(f"fine lane {lane} (rho {r}) is not "
                                 f"bitwise its C=1 solve")
        dr = abs(100.0 * float(a["r_star"])
                 - golden["lanes"][lane]["r_star_pct"])
        if not dr <= FINE_RSTAR_PCT[dt]:
            raise AssertionError(f"fine lane {lane} r* is {dr} pct from "
                                 f"the golden")
    log("fine_lanes", dtype=str(dt), wall_s=wall4, c1_wall_s=walls1,
        launches=out["fine_lanes4"], bitwise_c1=True,
        r_star_pct=(100.0 * res4.r_star).tolist(),
        bisect_iters=res4.bisect_iters.tolist(),
        egm_iters=res4.egm_iters.tolist(),
        dist_iters=res4.dist_iters.tolist())
    return out


# The fine cell's compact-grid solves of phase 7: (grid, dtype), each under
# both kernel policies, against tests/data/torch_fine_golden.json's "grids".
FINE_GRID_RUNS = (("compact", torch.float64), ("compact", torch.float32),
                  ("adaptive", torch.float64))


def phase_fine_grids(dev):
    """The fine configuration on the compact grids, end to end on the
    card: solve_calibration_lean(**fine_grid_kwargs(), grid=...) for
    FINE_GRID_RUNS under the reference kernels (the grid ladder on the EGM
    kernel's tail mode, then the lottery kernel) and under kernel="fused"
    (the fused kernel with the tail), each kernel of the lane in its
    cluster layout.  Reference kernels: against the golden's record of
    the grid and dtype under the slice rule (float64: r* within 1e-6 pct,
    trips, EGM, distribution, descent and polish steps equal, CONVERGED;
    float32: 1 bp, trips equal).  kernel="fused": one fused launch a
    trip; float64 within 1e-6 pct of the golden's fused record with its
    counts where it has one (compact), and within FUSED_BUDGET_PCT of the
    reference record, CONVERGED; float32 within 1 bp of it.  Returns the
    launches by run."""
    from aiyagari_hark_tpu_torch.models.equilibrium import (
        solve_calibration_lean)
    from aiyagari_hark_tpu_torch.solver_health import status_name
    from aiyagari_hark_tpu_torch.utils.config import fine_grid_kwargs

    with open(FINE_GOLDEN) as f:
        grids = json.load(f)["grids"]
    kw = fine_grid_kwargs()
    crra, rho = kw.pop("crra"), kw.pop("labor_ar")
    out = {}
    for grid, dt in FINE_GRID_RUNS:
        name = str(dt).rsplit(".", 1)[-1]
        g = grids[grid]
        pts = dict(a_points=g["a_points"], dist_points=g["dist_points"])
        layouts = _tail_layouts(kw["labor_states"], g["a_points"],
                                g["dist_points"], dt)
        if layouts["egm"] != "cluster" or layouts["fused"] != "cluster":
            raise AssertionError(f"fine {grid} {name} lanes take the "
                                 f"layouts {layouts}, not the cluster")
        res, wall, launches = _golden_solve(
            dev, solve_calibration_lean, crra, rho, dtype=dt, grid=grid,
            **kw)
        _golden_cell_check("fine_grid_equilibrium", res, dt, g[name],
                           grid=grid, kernel="reference", wall_s=wall,
                           launches=launches, layouts=layouts, **pts)
        out[f"fine_{grid}_{name}"] = launches
        res, wall, launches = _golden_solve(
            dev, solve_calibration_lean, crra, rho, dtype=dt, grid=grid,
            kernel="fused", **kw)
        fused_rec = g.get(f"fused_{name}")
        if fused_rec is not None:
            _golden_cell_check("fine_grid_equilibrium", res, dt, fused_rec,
                               grid=grid, kernel="fused", wall_s=wall,
                               launches=launches, layouts=layouts, **pts)
        dr = abs(100.0 * float(res.r_star) - g[name]["r_star_pct"])
        budget = FUSED_BUDGET_PCT if dt == torch.float64 \
            else FINE_RSTAR_PCT[dt]
        status = status_name(int(res.status))
        log("fine_grid_fused_vs_reference", grid=grid, dtype=str(dt),
            dr_star_pct=dr, budget_pct=budget, status_name=status,
            golden_fused_record=fused_rec is not None, wall_s=wall,
            launches=launches, bisect_iters=int(res.bisect_iters),
            egm_iters=int(res.egm_iters), dist_iters=int(res.dist_iters))
        if not dr <= budget:
            raise AssertionError(f"fine {grid} {name} under kernel=fused: r* "
                                 f"{dr} pct from the reference record, above "
                                 f"{budget}")
        if dt == torch.float64 and status != "CONVERGED":
            raise AssertionError(f"fine {grid} {name} under kernel=fused: "
                                 f"status {status}")
        out[f"fine_{grid}_fused_{name}"] = launches
    return out


def _tail_layouts(N, A, D, dt) -> dict:
    """The layout each kernel takes for a tail-closed lane of N states, A
    assets and D wealth points (the EGM kernel's tail mode, the lottery
    kernel, the fused kernel with the tail)."""
    from aiyagari_hark_tpu_torch.ops import kernels as K

    return dict(egm=K.egm_policy_grid_layout(N, A, dt, tail=True),
                lottery=K.stationary_lottery_grid_layout(D, N, dt),
                fused=K.fused_cell_grid_layout(N, A, D, True, dt))


# Config 1 and the many-state cells (tests/data/torch_fine_golden.json),
# and the distribution kernels past 16 labor states: the bound 32 (N=17)
# and the wide mix (N=40), at the golden cells' width (D=500: the lottery
# kernel's cluster, the fused kernel's global layout) and at one that one
# block holds (D=40: shared), each against its global layout.
MANY_KERNEL_STATES = (17, 40)
MANY_KERNEL_DISTS = (500, 40)


def _layouts(N, A, D, dt) -> dict:
    """The layout each kernel takes for a lane of N states, A assets and
    D wealth points, and the lane's bound on the states."""
    from aiyagari_hark_tpu_torch.ops import kernels as K

    return dict(egm=K.egm_policy_grid_layout(N, A, dt),
                lottery=K.stationary_lottery_grid_layout(D, N, dt),
                fused=K.fused_cell_grid_layout(N, A, D, False, dt),
                state_bound=K.lottery_state_bound(N))


def many_state_kernel_check(dev):
    """The lottery and fused kernels at N = 17 and 40 (float64, r = 4 %,
    C=1, A=32), D = 500 and 40: each default layout and its global layout
    bitwise the plain version on the card (the lottery kernel's is the
    fused plain version's distribution, on the EGM kernel's policy, which
    is bitwise the plain EGM loop's); at D=500 both layouts timed in
    turns, ns per step, the bounds.  Returns the records."""
    from aiyagari_hark_tpu_torch.models import firm
    from aiyagari_hark_tpu_torch.models import household as H
    from aiyagari_hark_tpu_torch.ops import kernels as K

    dt = torch.float64
    egm_tol, dist_tol = INNER_TOL[dt]
    recs = []
    for N in MANY_KERNEL_STATES:
        for D in MANY_KERNEL_DISTS:
            model = H.stack_models([H.build_simple_model(
                labor_states=N, a_count=32, dist_count=D, labor_ar=0.6,
                dtype=dt, device=dev)])
            r = torch.tensor([0.04], dtype=dt, device=dev)
            R = 1.0 + r
            W = firm.wage_rate(firm.k_to_l_from_r(r, 0.36, 0.08), 0.36)
            p0 = H.initial_policy(model)
            sc = H._scalars(R, W, model, 0.96, 3.0)
            m, c, eit, ediff = K.egm_policy_grid(
                p0.m_knots, p0.c_knots, model.a_grid, model.labor_levels,
                model.transition, sc, egm_tol)
            trans = H.wealth_transition(H.HouseholdPolicy(m, c), R, W, model)
            d0 = H.initial_distribution(model)
            largs = (trans.idx, trans.weight, model.transition, d0, dist_tol)
            fargs = (p0.m_knots, p0.c_knots, model.a_grid, model.dist_grid,
                     model.labor_levels, model.transition, sc,
                     torch.zeros_like(model.labor_levels), d0)
            fkw = dict(tol=egm_tol, dist_tol=dist_tol)
            # the fused plain version is the plain EGM loop, the
            # transition and the lottery's plain version: the lottery's
            # is its part, on the kernel's policy once that is its own
            t0 = time.perf_counter()
            fplain = K.fused_cell_grid_plain(*fargs, egm_tol,
                                             dist_tol=dist_tol)
            torch.cuda.synchronize()
            fplain_ms = 1e3 * (time.perf_counter() - t0)
            if not (torch.equal(fplain[0], m) and torch.equal(fplain[1], c)):
                raise AssertionError(f"egm_policy_grid at N={N} is not "
                                     f"bitwise its plain version")
            lplain = (fplain[2], fplain[5], fplain[6])
            lay = _layouts(N, 32, D, dt)
            runs = {"lottery": (lambda g: K.stationary_lottery_grid(
                        *largs, force_global=g), lplain),
                    "fused": (lambda g: K.fused_cell_grid(
                        *fargs, **fkw, force_global=g), fplain)}
            for name, (run, plain) in runs.items():
                for g in (False, True):
                    got = run(g)
                    if not all(torch.equal(x, y) for x, y in zip(got, plain)):
                        raise AssertionError(
                            f"{name} kernel at N={N}, D={D} "
                            f"({'global' if g else lay[name]} layout) is not "
                            f"bitwise its plain version")
            rec = dict(dtype=str(dt), N=N, A=32, D=D, layouts=lay,
                       dist_iters=lplain[1].tolist(),
                       egm_iters=fplain[3].tolist(),
                       bitwise_vs_plain=True, bitwise_global=True,
                       fused_plain_ms=fplain_ms)
            if D == MANY_KERNEL_DISTS[0]:
                steps = int(lplain[1][0])
                for name, (run, _) in runs.items():
                    ms, gms = paired_ms(lambda: run(False), lambda: run(True),
                                        reps=3)
                    rec[f"{name}_ms"], rec[f"{name}_global_ms"] = ms, gms
                rec["lottery_ns_per_step"] = 1e6 * rec["lottery_ms"] / steps
                rec["lottery_global_ns_per_step"] = \
                    1e6 * rec["lottery_global_ms"] / steps
                rec["lottery_bound_ms"], rec["lottery_bound_by"] = \
                    dist_bound(dt, 1, model, lplain[1])
                rec["fused_bound_ms"], rec["fused_bound_by"] = fused_bound(
                    dt, 1, model, fplain[3], fplain[5], False)
            log("many_states_kernels", **rec)
            recs.append(rec)
    return recs


def phase_many_states(dev):
    """Any number of labor states on the card: the distribution kernels at
    N = 17 and 40 (``many_state_kernel_check``), then BASELINE.json config
    1 (baseline_cell_kwargs(): N=7, A=100, D=500) in float64 and float32
    and the many-state cells (CRRA 3, rho 0.6, A=32, D=500; N = 17, 21, 40
    in float64, 17 in float32) through solve_calibration_lean on the card
    against tests/data/torch_fine_golden.json under the slice rule, each
    with the layout each kernel takes, one launch of each reference kernel
    a trip.  Returns (launches by run, the kernel records)."""
    from aiyagari_hark_tpu_torch.models.equilibrium import (
        solve_calibration_lean)
    from aiyagari_hark_tpu_torch.utils.config import baseline_cell_kwargs

    with open(FINE_GOLDEN) as f:
        golden = json.load(f)
    records = many_state_kernel_check(dev)
    out = {}
    base = baseline_cell_kwargs()
    crra, rho = base.pop("crra"), base.pop("labor_ar")
    for dt in FINE_DTYPES:
        name = str(dt).rsplit(".", 1)[-1]
        res, wall, launches = _golden_solve(dev, solve_calibration_lean,
                                            crra, rho, dtype=dt, **base)
        _golden_cell_check("baseline_equilibrium", res, dt,
                           golden["baseline"][name], wall_s=wall,
                           launches=launches, layouts=_layouts(
                               base["labor_states"], base["a_count"],
                               base["dist_count"], dt))
        out[f"baseline_{name}"] = launches
    for g in golden["many_states"]:
        dt = getattr(torch, g["dtype"])
        width = {k: g[k] for k in ("labor_states", "a_count", "dist_count")}
        res, wall, launches = _golden_solve(
            dev, solve_calibration_lean, g["crra"], g["labor_ar"], dtype=dt,
            **width)
        _golden_cell_check("many_states_equilibrium", res, dt, g,
                           wall_s=wall, launches=launches, layouts=_layouts(
                               width["labor_states"], width["a_count"],
                               width["dist_count"], dt), **width)
        out[f"labor_states_{g['labor_states']}_{g['dtype']}"] = launches
    return out, records


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
# The depth of the solves of 11a-11d (the histogram solves in float64,
# interrupted and resumed, and in float32; the panel solve): the first
# KS_DEPTH states of the golden's chain, cut from 11000 for the script's
# time limit, against the golden's act_T_4000 record (JAX at that depth,
# scripts/make_torch_ks_golden.py --act-T 4000).  The fixed-rule panel
# keeps the notebook's act_T: its band is the 32-seed study's there.
KS_DEPTH = 4000
# The pinned-histogram solve against JAX's, absolute: tests/test_torch_ks.py
# holds the CPU gaps (~1e-12) to these; the card sums in other orders over
# a longer horizon.
KS_TOL = dict(intercept=1e-9, r_star_pct=1e-7, saving_rate_pct=1e-6,
              den_haan_pct=1e-6)
KS_F32_R_PCT = 1e-2     # float32 r* within 1 bp of the float64 golden
KS_PANEL_R_PP = 0.2     # the panel's r* within 0.2 pp of the golden's
# the profiled windows: KS_PROFILE_SHORT periods, then KS_PROFILE_PERIODS
# (cut from 100 and 1100 for the script's time limit; launches a period
# are the same every period)
KS_PROFILE_SHORT = 50
KS_PROFILE_PERIODS = 150
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
                     act_T=KS_WIDTH["act_T"], T_discard=KS_WIDTH["T_discard"])
    econ_dict.update(econ_updates)
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
    width, float64 unless named: the pinned-histogram engine on the first
    KS_DEPTH states of JAX's chain against tests/data/torch_ks_golden.json
    (its record at that depth), interrupted after outer
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
    T = KS_DEPTH
    chain = np.asarray([int(c) for c in golden["mrkv_hist"][:T]], np.int64)
    gold = golden[f"act_T_{T}"]
    g64 = gold["float64"]
    depth = dict(act_T=T)
    hist_kw = dict(sim_method="distribution",
                   dist_count=KS_WIDTH["dist_count"], economy_kw=depth)
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
    log("ks_histogram", dtype="float64", act_T=T, wall_s=wall_a,
        phases_s=phases_a,
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
                                 - gold["float32"]["r_star_pct"]),
        jax_f32_outer_iterations=gold["float32"]["outer_iterations"])

    # 11d. the panel engine: AiyagariEconomy(seed=1) -> make_Mrkv_history
    # -> solve(), the notebook's own pipeline
    (econ_d, sol_d, phases_d, wall_d), syncs_d = _synced_solve(
        dev, f64, seed=1, economy_kw=depth)
    out_d = _ks_readout(econ_d, sol_d)
    dr = abs(out_d["r_star_pct"] - g64["r_star_pct"])
    ks_check(sol_d.converged, "the panel solve did not converge")
    ks_check(dr <= KS_PANEL_R_PP, f"panel r* {out_d['r_star_pct']} is {dr} "
             f"pp from the golden's")
    urate = sol_d.history.urate.cpu()
    ks_check(bool((urate == 0.0).all()), "a nonzero unemployment rate at "
             "UrateB = UrateG = 0")
    log("ks_panel", act_T=T, wall_s=wall_d, phases_s=phases_d,
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
    short_n, long_n = KS_PROFILE_SHORT, KS_PROFILE_PERIODS
    for name, run in runs.items():
        short, busy_s, wall_s_ = _device_profile(lambda: run(short_n))
        long_, busy_l, wall_l = _device_profile(lambda: run(long_n))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(long_n)
        torch.cuda.synchronize()
        plain = time.perf_counter() - t0
        per[name] = {"launches_per_period": (long_ - short)
                     / (long_n - short_n),
                     "periods": long_n,
                     "device_busy_s_long": busy_l,
                     "profiled_wall_s_long": wall_l,
                     "unprofiled_wall_s_long": plain,
                     "ms_per_period": 1e3 * plain / long_n,
                     "idle_share_profiled": 1.0 - busy_l / wall_l,
                     "idle_share_unprofiled": 1.0 - busy_l / plain}
    egm_l, egm_busy, egm_wall = _device_profile(
        lambda: ks_model.solve_ks_household(sol_a.afunc, sol_a.calibration))
    per["egm_solve"] = {"launches": egm_l, "device_busy_s": egm_busy,
                        "profiled_wall_s": egm_wall,
                        "idle_share_profiled": 1.0 - egm_busy / egm_wall}
    log("ks_launches_idle", per=per, kernel_launches_ks_path=launches_ks)
    return launches_ks


EXTENSIONS = os.path.join(HERE, "tests", "data",
                          "torch_extensions_golden.json")
# Phase 12's tolerances against the JAX goldens (float64).  Equilibrium
# r* within 1e-6 pct (ROADMAP's slice rule); the rest relative to the
# golden unless named.  The card sums in other orders than JAX's CPU and
# lands each r* a few 1e-10 away, which the quantities below inherit
# through their slopes in r (dK/dr ~ 1e2): hence 1e-6 where a CPU test
# holds 1e-8.
EXT_TOL = dict(r_pct=1e-6, capital=1e-6, welfare=1e-6, hours=1e-6,
               beta=1e-6, spread=1e-9, distance=1e-6, k_path=1e-6,
               jacobian=1e-5, irf_gap_pp=1e-5, fit=1e-6, crunch_r=1e-8,
               lifecycle=1e-10, fused_bp=1e-3)


# The crunch's golden record: the JAX test's configuration over a
# 50-period horizon (the same 24-period phase-in), cut from 100 for the
# script's time limit (scripts/make_torch_extensions_golden.py crunch_50).
CRUNCH_RECORD = "crunch_50"


def ext_check(ok, what):
    if not ok:
        raise AssertionError(f"extensions: {what}")


def _counted(fn):
    """``fn()`` with the launch counters set to 0 just before and read just
    after, timed on the host between two syncs.  Returns (result,
    launches, wall seconds)."""
    from aiyagari_hark_tpu_torch.ops import kernels as K

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(K.LAUNCHES), time.perf_counter() - t0


def _host_syncs(fn) -> int:
    """The implicit host syncs of ``fn()``: each synchronizing CUDA call
    warns under ``torch.cuda.set_sync_debug_mode("warn")``."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _rel(a, b) -> float:
    a = np.asarray(torch.as_tensor(a).detach().cpu(), dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _dr_pct(r, golden) -> float:
    return float(np.abs(100.0 * (np.asarray(torch.as_tensor(r).cpu(),
                                            dtype=np.float64)
                                 - np.asarray(golden))).max())


def phase_extensions(dev):
    """Phase 12, the model extensions at the paper's width (N=7, A=32,
    D=500, float64; alpha=0.36, delta=0.08, CRRA=2, beta=0.96) against
    tests/data/torch_extensions_golden.json from the JAX package: the
    beta-dist economy (J=5 types as lanes; one trip's C=5 launches of
    both kernels bitwise their plain versions; degenerate types against
    the homogeneous equilibrium), the tax sweep (8 rates as lanes, with
    welfare; lean under kernel="fused" within 0.1 bp), calibration (the
    discount factor, the Lorenz fit at the JAX test's configuration), the
    labor economy (its lottery launch bitwise its plain version; the labor
    EGM's host syncs), the transition and the sequence-space Jacobians at
    T=100 under the 1 % TFP shock (host syncs per iteration), the credit
    crunch at the JAX test's configuration (its wall), the life cycle at
    horizon 40.  Returns (each run's launches, the C=5 kernel records)."""
    from aiyagari_hark_tpu_torch.models import (calibrate, fiscal,
                                                heterogeneity, household,
                                                huggett, jacobian, labor,
                                                lifecycle, transition)
    from aiyagari_hark_tpu_torch.models.equilibrium import (
        solve_bisection_equilibrium)
    from aiyagari_hark_tpu_torch.ops import kernels as K

    with open(EXTENSIONS) as f:
        g = json.load(f)
    cfg = g["config"]
    f64 = torch.float64
    beta, crra, alpha, delta = (cfg[k] for k in ("beta", "crra", "alpha",
                                                 "delta"))
    width = dict(cfg["width"], dtype=f64, device=dev)
    launches, pairs = {}, {}

    def run(name, fn, **fields):
        out, ln, wall = _counted(fn)
        launches[name] = ln
        log("extensions", run=name, wall_s=wall, launches=ln, **fields)
        return out, wall

    # 12a. the transition's steady state (the homogeneous equilibrium)
    model = household.build_simple_model(**width)
    gt = g["transition"]
    eq, _ = run("steady_state", lambda: solve_bisection_equilibrium(
        model, beta, crra, alpha, delta))
    dr = _dr_pct(eq.r_star, gt["steady_state"]["r_star"])
    ext_check(dr <= EXT_TOL["r_pct"], f"steady-state r* {dr} pct from JAX")
    ext_check(int(eq.bisect_iters) == gt["steady_state"]["bisect_iters"],
              f"steady-state trips {int(eq.bisect_iters)}")
    log("extensions_check", run="steady_state", r_gap_pct=dr,
        bisect_iters=int(eq.bisect_iters))

    # 12b. beta types as lanes
    gh = g["heterogeneity"]
    betas = heterogeneity.uniform_beta_types(**cfg["beta_types"],
                                             device=dev)
    ones = torch.ones_like(betas)
    het, _ = run("heterogeneity", lambda: (
        heterogeneity.solve_heterogeneous_equilibrium(
            model, betas, ones, crra, alpha, delta)))
    dr = _dr_pct(het.r_star, gh["r_star"])
    k_gap = _rel(het.type_capital, gh["type_capital"])
    ext_check(dr <= EXT_TOL["r_pct"], f"beta-dist r* {dr} pct from JAX")
    ext_check(int(het.bisect_iters) == gh["bisect_iters"],
              f"beta-dist trips {int(het.bisect_iters)} vs "
              f"{gh['bisect_iters']}")
    ext_check(k_gap <= EXT_TOL["capital"], f"type capital {k_gap} from JAX")
    ext_check(all(launches["heterogeneity"][k] > 0 for k in
                  ("egm_policy_grid", "stationary_lottery_grid")),
              f"the beta-dist path launched {launches['heterogeneity']}")
    J = betas.shape[0]
    lanes = household.stack_models([model] * J)
    r5 = torch.full((J,), float(het.r_star), dtype=f64, device=dev)
    from aiyagari_hark_tpu_torch.models import firm
    w5 = firm.wage_rate(firm.k_to_l_from_r(r5, alpha, delta), alpha)
    pairs["beta_types_c5"] = [
        dict(rec, name=name) for name, rec in zip(
            ("egm_policy_grid", "stationary_lottery_grid"),
            kernel_pair_check(dev, f64, lanes, 1.0 + r5, w5,
                              torch.full_like(r5, crra), disc_fac=betas,
                              family="beta_types"))]
    degen, _ = run("heterogeneity_degenerate", lambda: (
        heterogeneity.solve_heterogeneous_equilibrium(
            model, torch.full_like(betas, beta), ones, crra, alpha, delta)))
    d_gap = abs(float(degen.r_star) - float(eq.r_star))
    ext_check(d_gap <= 1e-10, f"degenerate types {d_gap} from the "
              f"homogeneous r*")
    log("extensions_check", run="heterogeneity", r_gap_pct=dr,
        type_capital_rel=k_gap, bisect_iters=int(het.bisect_iters),
        degenerate_r_gap=d_gap, tolerances=EXT_TOL)

    # 12c. the tax sweep: rates as lanes
    gf = g["fiscal"]
    sweep, _ = run("fiscal_welfare", lambda: fiscal.tax_rate_sweep(
        cfg["tax_rates"], beta, crra, alpha, delta, **width))
    dr = _dr_pct(sweep.r_star, gf["r_star"])
    gaps = dict(r_gap_pct=dr, capital_rel=_rel(sweep.capital, gf["capital"]),
                welfare_rel=_rel(sweep.welfare, gf["welfare"]))
    ext_check(dr <= EXT_TOL["r_pct"], f"tax sweep r* {dr} pct from JAX")
    ext_check(gaps["capital_rel"] <= EXT_TOL["capital"]
              and gaps["welfare_rel"] <= EXT_TOL["welfare"],
              f"tax sweep capital/welfare {gaps}")
    best = int(torch.argmax(sweep.welfare))
    ext_check(best == int(np.argmax(gf["welfare"])),
              f"the welfare-best rate is lane {best}")
    fused, _ = run("fiscal_lean_fused", lambda: fiscal.tax_rate_sweep(
        cfg["tax_rates"], beta, crra, alpha, delta, with_welfare=False,
        kernel="fused", **width))
    f_bp = float((100.0 * (fused.r_star - sweep.r_star)).abs().max())
    ext_check(f_bp <= EXT_TOL["fused_bp"], f"fused tax sweep {f_bp} pct "
              f"from the reference lanes")
    ln = launches["fiscal_lean_fused"]
    ext_check(ln["fused_cell_grid"] > 0 and not ln["egm_policy_grid"]
              and not ln["stationary_lottery_grid"],
              f"the fused tax sweep launched {ln}")
    log("extensions_check", run="fiscal", **gaps, best_rate=
        cfg["tax_rates"][best], fused_gap_pct=f_bp,
        r_star_pct=(100.0 * sweep.r_star).tolist())

    # 12d. calibration
    gc = g["calibrate"]
    cal, _ = run("calibrate_discount_factor", lambda: (
        calibrate.calibrate_discount_factor(model, gc["target_r"], crra,
                                            alpha, delta)))
    b_gap = abs(float(cal.value) - beta)
    ext_check(b_gap <= 1e-6, f"the calibrated beta is {b_gap} from {beta}")
    ext_check(int(cal.iterations) == gc["iterations"],
              f"calibration iterations {int(cal.iterations)}")
    ext_check(abs(float(cal.value) - gc["beta"]) <= EXT_TOL["beta"],
              "the calibrated beta differs from JAX's")
    gl = g["lorenz"]
    lcfg = dict(cfg["lorenz"])
    lmodel = household.build_simple_model(**lcfg.pop("model"), dtype=f64,
                                          device=dev)
    fit, _ = run("calibrate_spread_to_lorenz", lambda: (
        calibrate.calibrate_spread_to_lorenz(lmodel, lcfg.pop("center"),
                                             lcfg.pop("crra"), alpha, delta,
                                             **lcfg)))
    ext_check(fit.evaluations == gl["evaluations"]
              and abs(fit.spread - gl["spread"]) <= EXT_TOL["spread"]
              and abs(fit.distance / gl["distance"] - 1.0)
              <= EXT_TOL["distance"], f"Lorenz fit {fit} vs {gl}")
    log("extensions_check", run="calibrate", beta=float(cal.value),
        beta_gap=b_gap, iterations=int(cal.iterations),
        lorenz_spread=fit.spread, lorenz_distance=fit.distance,
        lorenz_spread_gap=abs(fit.spread - gl["spread"]),
        lorenz_r_star_gap_pct=abs(fit.r_star_pct - gl["r_star_pct"]))

    # 12e. the labor economy
    glab = g["labor"]
    lm = labor.build_labor_model(**cfg["labor"], **width)
    leq, _ = run("labor", lambda: labor.solve_labor_equilibrium(
        lm, beta, crra, alpha, delta))
    dr = _dr_pct(leq.r_star, glab["r_star"])
    lgaps = {f: abs(float(getattr(leq, f)) / glab[f] - 1.0)
             for f in ("mean_hours", "effective_labor", "capital")}
    ext_check(dr <= EXT_TOL["r_pct"], f"labor r* {dr} pct from JAX")
    ext_check(int(leq.bisect_iters) == glab["bisect_iters"],
              f"labor trips {int(leq.bisect_iters)}")
    ext_check(max(lgaps.values()) <= EXT_TOL["hours"], f"labor {lgaps}")
    R, W = 1.0 + leq.r_star, leq.wage
    trans, _, _ = labor.labor_wealth_transition(leq.policy, R, W, lm, crra)
    largs = (trans.idx[None], trans.weight[None], lm.base.transition[None],
             household.initial_distribution(lm.base)[None], 1e-11)
    kd, kit, kdiff = K.stationary_lottery_grid(*largs)
    pd, pit, pdiff = K.stationary_lottery_grid_plain(*largs)
    ext_check(torch.equal(kit, pit) and torch.equal(kd, pd)
              and torch.equal(kdiff, pdiff),
              "the labor lottery's launch is not bitwise its plain version")
    (_, egm_steps, _), _, egm_s = _counted(
        lambda: labor.solve_labor_household(R, W, lm, beta, crra))
    egm_syncs = _host_syncs(
        lambda: labor.solve_labor_household(R, W, lm, beta, crra))
    log("extensions_check", run="labor", r_gap_pct=dr, **lgaps,
        bisect_iters=int(leq.bisect_iters),
        lottery_bitwise_plain=True, lottery_iters=int(kit[0]),
        labor_egm_steps=egm_steps, labor_egm_wall_s=egm_s,
        labor_egm_host_syncs=egm_syncs,
        host_syncs_by="torch.cuda.set_sync_debug_mode('warn'), counted",
        engine="egm_step_labor, plain PyTorch")

    # 12f. the transition and the sequence-space Jacobians
    T = cfg["horizon"]
    dz = cfg["shock"]["size"] * cfg["shock"]["decay"] ** np.arange(T)
    prod = torch.as_tensor(1.0 + dz, dtype=f64, device=dev)
    nl, tr_s = run("transition", lambda: transition.solve_transition(
        model, beta, crra, alpha, delta, init_dist=eq.distribution,
        terminal_policy=eq.policy, k_terminal=eq.capital, horizon=T,
        prod_path=prod))
    gtr = gt["transition"]
    k_gap = _rel(nl.k_path, gtr["k_path"])
    ext_check(nl.converged and nl.iterations == gtr["iterations"],
              f"transition {nl.iterations} iterations vs "
              f"{gtr['iterations']}, converged {nl.converged}")
    ext_check(k_gap <= EXT_TOL["k_path"], f"k_path {k_gap} from JAX")
    per_iter = _host_syncs(lambda: transition.transition_path_map(
        nl.k_path, prod, model, beta, crra, alpha, delta, eq.distribution,
        eq.policy))
    jac, jac_s = run("jacobian", lambda: jacobian.sequence_jacobians(
        model, beta, crra, alpha, delta, eq, T))
    gj = gt["jacobian"]
    cols = gj["columns"]
    jgaps = {n: float(np.abs(getattr(jac, n)[:, cols].T.cpu().numpy()
                             - np.asarray(gj[n])).max() / gj["max_abs"][n])
             for n in ("g_k", "g_c", "g_y")}
    ext_check(max(jgaps.values()) <= EXT_TOL["jacobian"],
              f"Jacobians {jgaps} of max|G| from JAX")
    lin = jacobian.linear_impulse_response(jac, dz)
    k_ss = float(eq.capital)
    gap = float(np.abs(100.0 * lin.dk.cpu().numpy() / k_ss - 100.0 * (
        nl.k_path.cpu().numpy() / k_ss - 1.0)).max())
    ext_check(abs(gap - gt["irf_gap_pp"]) <= EXT_TOL["irf_gap_pp"],
              f"the linear-nonlinear gap {gap} pp vs {gt['irf_gap_pp']}")
    mom = gt["moments"]
    fit_s = jacobian.fit_shock_process(jac, mom["std"]["y"],
                                       mom["autocorr1"]["y"])
    fgap = max(abs(float(fit_s.rho) / gt["fit"]["rho"] - 1.0),
               abs(float(fit_s.sigma_eps) / gt["fit"]["sigma_eps"] - 1.0))
    ext_check(fit_s.converged and fgap <= EXT_TOL["fit"],
              f"fit_shock_process {fit_s} vs {gt['fit']}")
    log("extensions_check", run="transition_jacobian", horizon=T,
        transition_iterations=nl.iterations, transition_wall_s=tr_s,
        transition_ms_per_iteration=1e3 * tr_s / nl.iterations,
        host_syncs_per_iteration=per_iter, k_path_rel=k_gap,
        jacobian_wall_s=jac_s, jacobian_gap_of_max=jgaps,
        irf_gap_pp=gap, irf_gap_jax_pp=gt["irf_gap_pp"],
        fit_rho=float(fit_s.rho), fit_sigma=float(fit_s.sigma_eps),
        fit_iterations=fit_s.iterations, fit_rel_gap=fgap,
        jax_cpu_transition_s=gtr["jax_cpu_seconds"],
        jax_cpu_jacobian_s=gj["jax_cpu_seconds"])

    # 12g. the credit crunch (the JAX test's configuration, over
    # CRUNCH_RECORD's horizon)
    gcr = g[CRUNCH_RECORD]
    ccfg = cfg[CRUNCH_RECORD]
    loose = household.build_simple_model(**ccfg["model"],
                                         borrow_limit=ccfg["b_loose"],
                                         dtype=f64, device=dev)
    tight = household.build_simple_model(**ccfg["model"],
                                         borrow_limit=ccfg["b_tight"],
                                         dtype=f64, device=dev)
    eq0, _ = run("crunch_pre", lambda: huggett.solve_huggett_equilibrium(
        loose, beta, crra))
    eqt, _ = run("crunch_terminal", lambda: (
        huggett.solve_huggett_equilibrium(tight, beta, crra)))
    pre_gap = max(_dr_pct(eq0.r_star, gcr["r_pre"]),
                  _dr_pct(eqt.r_star, gcr["r_terminal"]))
    ext_check(pre_gap <= EXT_TOL["r_pct"], f"crunch end points {pre_gap} "
              f"pct from JAX")
    H = ccfg["horizon"]
    phase_in = np.minimum(np.arange(H) / float(ccfg["phase_in"]), 1.0)
    b_path = ccfg["b_loose"] + (ccfg["b_tight"] - ccfg["b_loose"]) * phase_in
    cr, cr_s = run("crunch", lambda: huggett.solve_credit_crunch(
        loose, beta, crra, b_path, eq0.distribution, eqt.policy,
        eq0.r_star, eqt.r_star))
    r_gap = float(np.abs(cr.r_path.cpu().numpy()
                         - np.asarray(gcr["r_path"])).max())
    ext_check(cr.converged and cr.iterations == gcr["iterations"],
              f"crunch {cr.iterations} iterations vs {gcr['iterations']}, "
              f"converged {cr.converged}")
    ext_check(r_gap <= EXT_TOL["crunch_r"], f"crunch r path {r_gap} from "
              f"JAX")
    log("extensions_check", run="crunch", horizon=H,
        iterations=cr.iterations,
        wall_s=cr_s, ms_per_iteration=1e3 * cr_s / cr.iterations,
        r_path_gap=r_gap, end_point_gap_pct=pre_gap,
        max_excess=float(cr.max_excess),
        jax_cpu_crunch_s=gcr["crunch_jax_cpu_seconds"])

    for name in ("transition", "jacobian", "crunch"):
        ext_check(not any(launches[name].values()), f"the {name} path "
                  f"launched {launches[name]}: its loops are plain PyTorch")

    # 12h. the life cycle
    glc = g["lifecycle"]
    lc = cfg["lifecycle"]
    pol, _ = run("lifecycle", lambda: lifecycle.solve_lifecycle(
        lc["R"], lc["W"], model, beta, crra, horizon=lc["horizon"]))
    lc_gap = max(_rel(pol.m_knots[lc["ages"]], glc["m_knots"]),
                 _rel(pol.c_knots[lc["ages"]], glc["c_knots"]))
    ext_check(lc_gap <= EXT_TOL["lifecycle"], f"life-cycle knots {lc_gap} "
              f"from JAX")
    log("extensions_check", run="lifecycle", knots_rel=lc_gap)
    return launches, pairs


PORTFOLIO = os.path.join(HERE, "tests", "data",
                         "torch_portfolio_golden.json")
# Phase 13's tolerances against the JAX golden (float64): r* and r_free
# within 1e-6 pct (ROADMAP's slice rule), the stocks within 1e-6 relative
# (the card sums in other orders, and r* moves them through dK/dr), the
# distribution steps within 0.2 % (tests/test_torch_equilibrium.py's
# bound: the Aitken sums' order); trips and EGM steps equal.  The
# degenerate economy against the single-asset kernels' equilibrium: the
# JAX suite's 7e-4 in r and 3 % in capital (tests/test_portfolio.py).
PF_TOL = dict(r=1e-8, stocks=1e-6, dist_steps=2e-3, degenerate_r=7e-4,
              degenerate_capital=0.03)


# the profiled steps of 13b: a short and a long run (cut from 20 and 120
# for the script's time limit; kernels and ms a step are their difference)
PF_PROFILE_STEPS = (10, 60)


def pf_check(ok, what):
    if not ok:
        raise AssertionError(f"portfolio: {what}")


def _max_in_degree(trans) -> int:
    """The most contributions any (column n', gridpoint) target of a
    portfolio transition takes (left and right shares)."""
    d_size, n_next = trans.idx.shape[0], trans.idx.shape[3]
    left = (trans.idx.permute(3, 0, 1, 2).reshape(n_next, -1)
            + torch.arange(n_next, device=trans.idx.device)[:, None]
            * d_size).reshape(-1)
    return int(torch.bincount(torch.cat([left, left + 1])).max())


def phase_portfolio(dev):
    """Phase 13, the two-asset portfolio economy at the JAX defaults' full
    width (N=7, A=48, K=7 draws, S=25 shares, D=300, float64): the
    real-risk equilibrium against tests/data/torch_portfolio_golden.json
    (the JAX package on the CPU; trips and EGM steps equal, r*, r_free and
    the stocks within PF_TOL); the push-forward bitwise from run to run,
    timed; the household loop and the distribution loop alone at the
    golden r* (steps, walls, host syncs, device kernels a step and the
    device's busy share under torch.profiler); the degenerate economy
    (risky_std=1e-5, premium 0.03, CRRA 2) against the single-asset
    equilibrium of the EGM and lottery kernels.  Returns each run's
    launches of the port's kernels."""
    from aiyagari_hark_tpu_torch.models import firm
    from aiyagari_hark_tpu_torch.models import portfolio as P
    from aiyagari_hark_tpu_torch.models.equilibrium import (
        solve_bisection_equilibrium)
    from aiyagari_hark_tpu_torch.models.household import build_simple_model

    with open(PORTFOLIO) as f:
        g = json.load(f)
    cfg = g["config"]
    f64 = torch.float64
    launches = {}

    # 13a. real risk against the JAX golden
    model = P.build_portfolio_model(**cfg["model"], dtype=f64, device=dev)
    width = dict(labor_states=model.labor_levels.shape[0],
                 a_count=model.a_grid.shape[0],
                 risky_count=model.risky_returns.shape[0],
                 share_count=model.share_grid.shape[0],
                 dist_count=model.dist_grid.shape[0])
    pf_check(width == cfg["width"], f"width {width} against the golden's "
             f"{cfg['width']}")
    eq, launches["real_risk"], wall = _counted(
        lambda: P.solve_portfolio_equilibrium(model, **cfg["solve"]))
    gaps = dict(r=abs(float(eq.r_star) - g["r_star"]),
                r_free=abs(float(eq.r_free) - g["r_free"]),
                capital=_rel(eq.capital, g["capital"]),
                total_assets=_rel(eq.total_assets, g["total_assets"]),
                risky_share_mean=_rel(eq.risky_share_mean,
                                      g["risky_share_mean"]))
    dsteps = abs(eq.dist_iters - g["dist_iters"]) / g["dist_iters"]
    pf_check(gaps["r"] <= PF_TOL["r"] and gaps["r_free"] <= PF_TOL["r"],
             f"r* / r_free {gaps} from the golden")
    pf_check(all(gaps[k] <= PF_TOL["stocks"] for k in
                 ("capital", "total_assets", "risky_share_mean")),
             f"stocks {gaps} from the golden")
    pf_check(int(eq.bisect_iters) == g["bisect_iters"],
             f"trips {int(eq.bisect_iters)} vs {g['bisect_iters']}")
    pf_check(eq.egm_iters == g["egm_iters"],
             f"EGM steps {eq.egm_iters} vs {g['egm_iters']}")
    pf_check(dsteps <= PF_TOL["dist_steps"], f"distribution steps "
             f"{eq.dist_iters} vs {g['dist_iters']}")
    pf_check(int(eq.status) == 0, f"status {int(eq.status)}")
    pf_check(abs(float(eq.distribution.sum()) - 1.0) <= 1e-10,
             "distribution mass")
    log("portfolio", run="real_risk", wall_s=wall,
        launches=launches["real_risk"], gaps=gaps, tolerances=PF_TOL,
        r_star=float(eq.r_star), golden_r_star=g["r_star"],
        bisect_iters=int(eq.bisect_iters), egm_iters=eq.egm_iters,
        golden_egm_iters=g["egm_iters"], dist_iters=eq.dist_iters,
        golden_dist_iters=g["dist_iters"],
        jax_cpu_warm_s=g["jax_cpu_seconds"],
        jax_cpu_first_call_s=g["jax_cpu_first_call_seconds"])

    # 13b. the loops alone at the golden r*: steps, walls, host syncs,
    # device kernels a step and the device's busy share
    r = torch.tensor(g["r_star"], dtype=f64, device=dev)
    eps = model.risky_returns / torch.sum(model.risky_returns
                                          * model.risky_probs)
    m_r = model._replace(risky_returns=(1.0 + r) * eps)
    r_free = 1.0 + r - cfg["solve"]["premium"]
    wage = firm.wage_rate(firm.k_to_l_from_r(
        r, cfg["solve"]["cap_share"], cfg["solve"]["depr_fac"]),
        cfg["solve"]["cap_share"])
    beta, crra = cfg["solve"]["disc_fac"], cfg["solve"]["crra"]
    out = []
    egm_wall = wall_ms(lambda: out.append(P.solve_portfolio_household(
        r_free, wage, m_r, beta, crra))) / 1e3
    pol, n_egm, _ = out.pop()
    egm_syncs = _host_syncs(lambda: P.solve_portfolio_household(
        r_free, wage, m_r, beta, crra))
    dist_wall = wall_ms(lambda: out.append(P.stationary_portfolio_wealth(
        pol, r_free, wage, m_r))) / 1e3
    d0, n_dist = out[0][0], int(out.pop()[1])
    dist_syncs = _host_syncs(lambda: P.stationary_portfolio_wealth(
        pol, r_free, wage, m_r))

    def egm_steps(n):
        p = pol
        for _ in range(n):
            p = P.egm_step_portfolio(p, r_free, wage, m_r, beta, crra)

    trans = P.portfolio_wealth_transition(pol, r_free, wage, m_r)
    push = P.portfolio_push(trans)

    def push_steps(n):
        d = d0
        for _ in range(n):
            d = P._push_forward_portfolio(d, trans, m_r, push)

    per = {}
    n_s, n_l = PF_PROFILE_STEPS
    for name, fn in (("egm_step", egm_steps), ("push_step", push_steps)):
        short, busy_s, wall_s_ = _device_profile(lambda: fn(n_s))
        long_, busy_l, wall_l = _device_profile(lambda: fn(n_l))
        per[name] = dict(device_kernels=(long_ - short) / (n_l - n_s),
                         ms=1e3 * (wall_l - wall_s_) / (n_l - n_s),
                         device_busy_share=(busy_l - busy_s)
                         / max(wall_l - wall_s_, 1e-12))
    # 13c. the push, bitwise from run to run, and its time
    a = P._push_forward_portfolio(d0, trans, m_r, push)
    b = P._push_forward_portfolio(d0, trans, m_r, P.portfolio_push(trans))
    pf_check(_bits_equal(a.cpu().numpy(), b.cpu().numpy()),
             "two runs of the push differ")
    pf_check(abs(float(a.sum()) - 1.0) <= 1e-12, "the push lost mass")
    push_ms = cuda_ms(lambda: P._push_forward_portfolio(d0, trans, m_r,
                                                        push), reps=50)
    build_ms = cuda_ms(lambda: P.portfolio_push(trans), reps=10)
    log("portfolio", run="loops_at_golden_r", egm_steps=n_egm,
        egm_wall_s=egm_wall, egm_host_syncs=egm_syncs, dist_steps=n_dist,
        dist_wall_s=dist_wall, dist_host_syncs=dist_syncs,
        per_step=per, push_bitwise_run_to_run=True, push_ms=push_ms,
        push_build_ms=build_ms, contributions=int(push.source.numel()),
        tree_levels=len(push.masks),
        max_in_degree=_max_in_degree(trans),
        host_syncs_by="torch.cuda.set_sync_debug_mode('warn'), counted")

    # 13d. the degenerate economy against the kernels' single asset
    degen = P.build_portfolio_model(risky_mean=1.0, risky_std=1e-5,
                                    labor_ar=0.3, dtype=f64, device=dev)
    eq_d, launches["degenerate"], wall_d = _counted(
        lambda: P.solve_portfolio_equilibrium(
            degen, 0.96, 2.0, cap_share=0.36, depr_fac=0.08, premium=0.03))
    simple = build_simple_model(labor_states=width["labor_states"],
                                labor_ar=0.3, a_count=width["a_count"],
                                dist_count=width["dist_count"], dtype=f64,
                                device=dev)
    base, launches["single_asset"], wall_b = _counted(
        lambda: solve_bisection_equilibrium(simple, 0.96, 2.0, 0.36, 0.08))
    pf_check(all(launches["single_asset"][k] > 0 for k in
                 ("egm_policy_grid", "stationary_lottery_grid")),
             f"the single-asset solve launched {launches['single_asset']}")
    pf_check(not any(launches["real_risk"].values())
             and not any(launches["degenerate"].values()),
             "the portfolio path launched a kernel")
    dgap = dict(r=abs(float(eq_d.r_star) - float(base.r_star)),
                capital=_rel(eq_d.capital, float(base.capital)),
                share=float(eq_d.risky_share_mean))
    pf_check(dgap["r"] <= PF_TOL["degenerate_r"]
             and dgap["capital"] <= PF_TOL["degenerate_capital"]
             and dgap["share"] > 0.99, f"degenerate economy {dgap}")
    log("portfolio", run="degenerate", wall_s=wall_d,
        single_asset_wall_s=wall_b, launches=launches["degenerate"],
        single_asset_launches=launches["single_asset"], gaps=dgap,
        r_star=float(eq_d.r_star), single_asset_r_star=float(base.r_star),
        bisect_iters=int(eq_d.bisect_iters), egm_iters=eq_d.egm_iters,
        dist_iters=eq_d.dist_iters)
    return launches


DURABILITY_FAULT = {"cell": 2, "at_iter": 2, "mode": "stall"}


def dur_check(ok, what):
    if not ok:
        raise AssertionError(f"durability: {what}")


def _durable_run(dev, sweep, **kw):
    """``_engine_run`` of the phase's fault (the stall cell, one quarantine
    rung).  A retried launch replays its whole host loop, and the launch
    counters count both attempts."""
    return _engine_run(dev, sweep, inject_fault=DURABILITY_FAULT,
                       max_retries=1, **kw)


DURABLE_ROWS = ROWS + ("retries", "bucket", "predicted_work", "excess",
                       "saving_rate_pct")


def _same_sweep(a, b) -> bool:
    return all(_bits_equal(getattr(a, f), getattr(b, f))
               for f in DURABLE_ROWS)


def phase_durability(dev):
    """Phase 14, the sweep engine's durability on the card: the 12-cell
    Table II sweep at the paper's width (float64), schedule="balanced"
    with 3 buckets and one stall-injected cell that one quarantine rung
    recovers.  Six drills, each bitwise the uninterrupted run in r*,
    statuses, counters, retries and buckets: (1) preempted after bucket 0
    (the "flag" drill: "signal" would SIGTERM this script) and resumed,
    the ledger gone after; (2) the locked schedule preempted after its
    launch and resumed through quarantine without relaunching; (3) a
    transient at call 1 replayed in place, one warning; (4) a transient
    using up max_attempts=2, escaping, then resumed; (5) a ledger row
    flipped by corrupt_ledger_row: that cell recomputed, the rest
    restored; (6) a sidecar written by the locked run and reread: the
    balanced rerun's predicted work is the measured work, and the warm
    sidecar-seeded run's inner steps against locked.  Also the ledger's
    flush cost.  Returns each run's launches of the port's kernels."""
    import shutil
    import tempfile

    from aiyagari_hark_tpu_torch.solver_health import is_failure
    from aiyagari_hark_tpu_torch.utils.config import SweepConfig
    from aiyagari_hark_tpu_torch.utils.resilience import (
        InjectedTransientError, Interrupted, LedgerState, RetryPolicy,
        clear_interrupt, request_interrupt)
    from aiyagari_hark_tpu_torch.verify import corrupt_ledger_row

    bal = SweepConfig(schedule="balanced", n_buckets=3)
    launches, walls = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_durability_")
    try:
        ref, launches["uninterrupted"], _, walls["uninterrupted"] = \
            _durable_run(dev, bal)
        dur_check(ref.retries[DURABILITY_FAULT["cell"]] == 1
                  and not ref.status.any(), f"the reference run: retries "
                  f"{ref.retries.tolist()}, status {ref.status.tolist()}")
        dur_check(len(np.unique(ref.bucket)) == 3, "3 buckets")
        dur_check(all(launches["uninterrupted"][k] > 0 for k in
                      ("egm_policy_grid", "stationary_lottery_grid")),
                  f"the sweep launched {launches['uninterrupted']}")

        # 1. preempted after bucket 0, resumed; the ledger then gone
        ledger = os.path.join(tmp, "ledger.npz")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                _durable_run(dev, bal, resume_path=ledger,
                             inject_preempt={"after_bucket": 0,
                                             "mode": "flag"})
            raise AssertionError("durability: the preemption drill did not "
                                 "interrupt the sweep")
        except Interrupted as e:
            progress = e.progress
        finally:
            clear_interrupt()
        dur_check(os.path.exists(ledger) and progress == {
            "completed_buckets": 1, "n_buckets": 3}, f"progress {progress}")
        spare = os.path.join(tmp, "ledger_for_drill_5.npz")
        shutil.copy(ledger, spare)
        res, launches["resumed"], msgs, walls["resumed"] = _durable_run(
            dev, bal, resume_path=ledger)
        dur_check(_same_sweep(res, ref), "the resumed sweep differs")
        dur_check(not os.path.exists(ledger), "the ledger outlived its run")

        # 2. the locked schedule, preempted after its launch, resumed
        locked_cfg = bal.replace(schedule="locked")
        lref, launches["locked"], _, walls["locked"] = _durable_run(
            dev, locked_cfg)
        ledger2 = os.path.join(tmp, "locked.npz")
        try:
            request_interrupt()
            _durable_run(dev, locked_cfg, resume_path=ledger2)
            raise AssertionError("durability: the locked sweep was not "
                                 "interrupted")
        except Interrupted:
            pass
        finally:
            clear_interrupt()
        lres, launches["locked_resumed"], _, walls["locked_resumed"] = \
            _durable_run(dev, locked_cfg, resume_path=ledger2)
        dur_check(_same_sweep(lres, lref) and lres.wall_seconds == 0.0,
                  "the locked resume differs or relaunched the batch")
        dur_check(lres.retries[DURABILITY_FAULT["cell"]] == 1,
                  "the locked resume did not run the quarantine rung")

        # 3. a transient at call 1, replayed in place
        policy = RetryPolicy(max_attempts=3, sleep=lambda s: None)
        t3, launches["transient_in_place"], msgs3, walls["transient"] = \
            _durable_run(dev, bal, retry=policy,
                         inject_transient={"at_call": 1, "times": 1})
        retry_msgs = [m for m in msgs3 if "transient fault" in m]
        dur_check(_same_sweep(t3, ref) and len(retry_msgs) == 1,
                  f"the replayed sweep differs, or warned {retry_msgs}")

        # 4. a transient that uses up max_attempts=2, then a resume
        ledger4 = os.path.join(tmp, "transient.npz")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                _durable_run(dev, bal, resume_path=ledger4,
                             retry=RetryPolicy(max_attempts=2,
                                               sleep=lambda s: None),
                             inject_transient={"at_call": 1, "times": 2})
            raise AssertionError("durability: the transient did not escape")
        except InjectedTransientError:
            pass
        t4, launches["transient_resumed"], _, walls["transient_resumed"] = \
            _durable_run(dev, bal, resume_path=ledger4)
        dur_check(_same_sweep(t4, ref) and not os.path.exists(ledger4),
                  "the sweep resumed after an escaped transient differs")

        # 5. a flipped ledger row: that cell recomputed, the rest restored
        # reads only which rows the ledger claims solved, to pick the row
        # the drill then corrupts
        with np.load(spare) as raw:  # integrity-ok
            cell = int(np.nonzero(raw["leaf_000001"])[0][0])
        corrupt_ledger_row(spare, cell=cell, bit=21)
        t5, launches["corrupt_row"], msgs5, walls["corrupt_row"] = \
            _durable_run(dev, bal, resume_path=spare)
        dur_check(any(f"failed for cell(s) [{cell}]" in m for m in msgs5),
                  f"the flipped row was not detected: {msgs5}")
        dur_check(_same_sweep(t5, ref), "the sweep resumed past a flipped "
                  "row differs")

        # 6. a sidecar written by the locked run, then reread
        side = os.path.join(tmp, "side.npz")
        base = SweepConfig(sidecar_path=side)
        s_locked, launches["sidecar_locked"], _, _ = _engine_run(
            dev, base.replace(schedule="locked"))
        again, launches["sidecar_balanced"], _, _ = _engine_run(
            dev, base.replace(schedule="balanced", work_model="sidecar"))
        dur_check(np.array_equal(again.predicted_work.astype(np.int64),
                                 s_locked.total_work()),
                  "the predicted work is not the measured work")
        dur_check(_bits_equal(again.r_star_pct, s_locked.r_star_pct),
                  "the sidecar-planned sweep moved r*")
        warm, launches["sidecar_warm"], _, _ = _engine_run(
            dev, base.replace(schedule="balanced", warm_brackets=True))
        warm_dr = float(np.abs(warm.r_star_pct - s_locked.r_star_pct).max())
        log("durability_sidecar_warm", status=warm.status.tolist(),
            locked_status=s_locked.status.tolist(), max_abs_dr_pct=warm_dr,
            bisect_iters=warm.bisect_iters.tolist(),
            locked_bisect_iters=s_locked.bisect_iters.tolist(),
            egm_iters=warm.egm_iters.tolist(),
            dist_iters=warm.dist_iters.tolist())
        # Same-cell seeds descend to within 2 r_tol of the prior root,
        # inside the band where the excess's sign is inner-solver noise:
        # the JAX package promises r* only "up to inner-solver noise" there
        # and states no bound (its own run of this sweep on a CPU lands
        # two cells 4.6e-5 pct from locked, in these trips).  0.1 bp
        # (FUSED_BUDGET_PCT) is a sanity bound on the report, not a
        # contract.
        dur_check(not is_failure(warm.status).any()
                  and warm_dr <= FUSED_BUDGET_PCT,
                  f"the warm sidecar-seeded sweep: statuses "
                  f"{warm.status.tolist()}, r* {warm_dr} pct from locked")

        # the ledger's flush of this sweep's 12 rows, alone
        st = LedgerState(os.path.join(tmp, "flush.npz"), 1, 12, width=10)
        st.record_bucket(np.arange(12), np.ones((12, 10)), 0)
        t0 = time.perf_counter()
        for _ in range(20):
            st.flush()
        flush_ms = 1e3 * (time.perf_counter() - t0) / 20
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("durability", drills=["preempt_resume", "locked_resume",
                              "transient_in_place", "transient_resume",
                              "corrupt_row", "sidecar"],
        bitwise=True, corrupt_cell=cell,
        walls_s=walls, wall_seconds=dict(
            uninterrupted=ref.wall_seconds, resumed=res.wall_seconds,
            locked=lref.wall_seconds, transient_in_place=t3.wall_seconds),
        sidecar=dict(predicted_equals_measured=True,
                     locked_total_work=int(s_locked.total_work().sum()),
                     warm_total_work=int(warm.total_work().sum()),
                     warm_over_locked=float(warm.total_work().sum()
                                            / s_locked.total_work().sum()),
                     locked_sum_bisect=int(s_locked.bisect_iters.sum()),
                     warm_sum_bisect=int(warm.bisect_iters.sum()),
                     locked_wall_s=s_locked.wall_seconds,
                     warm_wall_s=warm.wall_seconds),
        ledger_flush_ms=flush_ms, launches=launches,
        launches_note="a retried launch is counted at every attempt")
    return launches


# Phase 15: each kernel's __global__ function, as the profiler names it.
GLOBAL_NAMES = {"egm_policy_grid": "egm_policy_kernel",
                "stationary_lottery_grid": "stationary_lottery_kernel",
                "fused_cell_grid": "fused_cell_kernel"}
LIFECYCLE = ["RUN_START", "BUCKET_LAUNCH", "RUN_END"]
PROFILE_EVENTS = ("PROFILE_SNAPSHOT", "DEVICE_MEM_HIGH_WATER")


def obs_check(ok, what):
    if not ok:
        raise AssertionError(f"observability: {what}")


def _device_trace_kernels(trace_dir) -> dict:
    """Kernel events by name in the one torch.profiler trace under
    ``trace_dir``."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    obs_check(len(files) == 1, f"device traces {files}, expected one")
    with open(os.path.join(trace_dir, files[0])) as f:
        trace = json.load(f)
    names: dict = {}
    for e in trace.get("traceEvents", []):
        if e.get("cat") == "kernel":
            names[e["name"]] = names.get(e["name"], 0) + 1
    return names


def phase_obs(dev, sweeps):
    """Phase 15, the observability layer on the card (float64, the paper's
    width, 12 cells, the locked schedule).  Per kernel policy (reference,
    fused): the journaled, traced, profiled sweep with a device trace of
    its one bucket, its rows bitwise phase 3's (phase 5's) and its
    launches theirs; its journal the lifecycle (RUN_START, BUCKET_LAUNCH,
    RUN_END) plus the profile tier's PROFILE_SNAPSHOT and one
    DEVICE_MEM_HIGH_WATER at or under the card's memory; the cost ledger's
    snapshot with the card's peaks not assumed; the torch.profiler trace
    naming the path's __global__ kernels; host syncs (sync debug mode)
    equal with obs off, journaled and traced (whose journal is exactly
    the lifecycle), and profiled; obs-off against obs-on walls in turns.
    Then the quarantine and transient drills, each exactly one typed
    event.  Returns each run's launches."""
    import shutil
    import tempfile

    from aiyagari_hark_tpu_torch.obs import (ObsConfig, build_obs,
                                             read_journal, trace_nesting_ok)
    from aiyagari_hark_tpu_torch.parallel.sweep import run_table2_sweep
    from aiyagari_hark_tpu_torch.utils.config import SweepConfig
    from aiyagari_hark_tpu_torch.utils.resilience import RetryPolicy

    t_phase = time.perf_counter()
    total_mem = torch.cuda.get_device_properties(dev).total_memory
    launches = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")

    def cfg(name, **kw):
        d = os.path.join(tmp, name)
        return ObsConfig(enabled=True, journal_path=f"{d}/events.jsonl",
                         trace_path=f"{d}/trace.json", **kw), d

    try:
        for kernel, ref in (("reference", "float64"),
                            ("fused", "fused_float64")):
            ref_launches, base = sweeps[ref]
            config, d = cfg(kernel, profile=True,
                            device_trace_dir=os.path.join(tmp, kernel,
                                                          "device"))
            obs = build_obs(config)
            res, launches[kernel], _, call_s = _engine_run(
                dev, SweepConfig(), obs=obs, kernel=kernel)
            obs.close()
            obs_check(all(_bits_equal(getattr(res, f), getattr(base, f))
                          for f in ROWS),
                      f"the {kernel} sweep's rows differ with obs on")
            obs_check(launches[kernel] == ref_launches,
                      f"{kernel} launches {launches[kernel]} against "
                      f"{ref_launches} with obs off")
            events = read_journal(config.journal_path)
            kinds = [e["event"] for e in events]
            obs_check([k for k in kinds if k not in PROFILE_EVENTS]
                      == LIFECYCLE and all(kinds.count(k) == 1
                                           for k in PROFILE_EVENTS),
                      f"the {kernel} journal {kinds}")
            hw = next((e for e in events
                       if e["event"] == "DEVICE_MEM_HIGH_WATER"), {})
            obs_check(0 < hw.get("bytes", 0) <= hw.get("bytes_limit", 0)
                      <= total_mem,
                      f"high water {hw} against {total_mem} bytes")
            snap = obs.cost_ledger.snapshot()
            obs_check(snap["launches"] == 1 and snap["cost_sources"] == {
                "kernel_work_model": 1} and (snap["mfu_pct"] or 0.0) > 0.0
                and not snap["peak_flops_assumed"]
                and not snap["peak_bytes_assumed"],
                f"the {kernel} ledger {snap}")
            with open(config.trace_path) as f:
                trace = json.load(f)
            spans = sorted({e["name"] for e in trace["traceEvents"]
                            if e["ph"] == "X"})
            obs_check(trace_nesting_ok(trace) and {
                "sweep/run", "sweep/bucket", "sweep/phase/polish"}
                <= set(spans), f"the {kernel} trace's spans {spans}")
            kernel_events = _device_trace_kernels(
                config.device_trace_dir)
            named = {name: sum(n for k, n in kernel_events.items()
                               if GLOBAL_NAMES[name] in k)
                     for name in path_kernels(kernel)}
            obs_check(all(n > 0 for n in named.values()),
                      f"the {kernel} device trace names {named}; kernel "
                      f"events {sorted(kernel_events)[:8]}")
            log("obs_ledger", kernel=kernel, dtype="torch.float64",
                **{k: v for k, v in snap.items() if k != "entries"},
                entries=snap["entries"])
            log("obs", kernel=kernel, bitwise_phase_sweep=True,
                launches=launches[kernel], journal=kinds,
                device_mem_high_water=hw, spans=spans,
                device_trace_kernel_events=named,
                device_trace_kernel_names=sorted(
                    k for k in kernel_events
                    if any(g in k for g in GLOBAL_NAMES.values())),
                device_trace_all_kernel_events=sum(kernel_events.values()),
                call_s=call_s, wall_s=res.wall_seconds)

            # host syncs, in turns: obs off, journaled and traced,
            # profiled, off again (the first run after the device trace
            # may pay a one-time sync; the claim is on, on, off equal)
            syncs, journals = {}, {}
            for mode in ("off_first", "journal_trace", "profile", "off"):
                obs_arg = None
                if not mode.startswith("off"):
                    c, _ = cfg(f"{kernel}_syncs_{mode}",
                               profile=mode == "profile")
                    obs_arg, journals[mode] = c, c.journal_path
                syncs[mode] = _host_syncs(lambda: run_table2_sweep(
                    dtype=torch.float64, device=dev, kernel=kernel,
                    obs=obs_arg, **WIDTH))
            obs_check(syncs["journal_trace"] == syncs["profile"]
                      == syncs["off"],
                      f"the {kernel} sweep's host syncs {syncs}")
            kinds = [e["event"]
                     for e in read_journal(journals["journal_trace"])]
            obs_check(kinds == LIFECYCLE, f"the journal {kinds}")

            # walls in turns: off, on, on, off (reported, no limit)
            on_cfg, _ = cfg(f"{kernel}_walls", profile=True)
            walls = {"off": [], "on": []}
            for mode in ("off", "on", "on", "off"):
                r, _, _, call = _engine_run(
                    dev, SweepConfig(), kernel=kernel,
                    obs=on_cfg if mode == "on" else None)
                walls[mode].append([call, r.wall_seconds])
            log("obs_cost", kernel=kernel, host_syncs=syncs,
                host_syncs_by="torch.cuda.set_sync_debug_mode('warn'), "
                              "counted",
                walls_call_and_sweep_s=walls,
                note="turns off, on, on, off; obs on = journal, trace, "
                     "profile (no device trace)")

        # the drills: exactly one typed event each
        drills = {
            "quarantine": (dict(inject_fault={"cell": 2, "at_iter": 1,
                                              "mode": "nan"}),
                           "QUARANTINE", {"cell": 2, "recovered": True}),
            "transient": (dict(inject_transient={"at_call": 0, "times": 1},
                               retry=RetryPolicy(sleep=lambda s: None)),
                          "RETRY_TRANSIENT", {"attempt": 1}),
        }
        seen = {}
        for name, (kw, etype, attrs) in drills.items():
            config, _ = cfg(f"drill_{name}")
            res, launches[name], _, _ = _engine_run(dev, SweepConfig(),
                                                    obs=config, **kw)
            events = read_journal(config.journal_path)
            typed = [e for e in events if e["event"] not in LIFECYCLE]
            obs_check(len(typed) == 1 and typed[0]["event"] == etype
                      and all(typed[0][k] == v for k, v in attrs.items()),
                      f"the {name} drill journaled {typed}")
            obs_check(not res.status.any(), f"the {name} drill's statuses "
                      f"{res.status.tolist()}")
            seen[name] = typed[0]
        obs_check(all(_bits_equal(getattr(res, f),
                                  getattr(sweeps["float64"][1], f))
                      for f in ROWS), "the transient drill's rows differ")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("obs_drills", events=seen, launches=launches,
        phase_s=time.perf_counter() - t_phase)
    return launches


# Phase 16: serving equilibrium queries through the lane kernels.
SERVE_CELLS = [(s, r) for s in (1.0, 3.0, 5.0) for r in (0.0, 0.3, 0.6, 0.9)]
SERVE_HUGGETT = 4            # the first four Huggett golden cells
SERVE_FUSED = 2              # two cells under kernel="fused"
SERVE_CLIENTS = 4            # client threads of the threaded drill


def serve_check(ok, what):
    if not ok:
        raise AssertionError(f"serve: {what}")


def _serve_bits(res) -> np.ndarray:
    return np.asarray(res.values, dtype=np.float64).view(np.uint64)


def _serve_wave(launches, run, svc, queries):
    """Submit ``queries`` and flush, the launch counters set to 0 just
    before and read just after; returns (results, host wall in s)."""
    from aiyagari_hark_tpu_torch.ops import kernels as K

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    futs = [svc.submit(x) for x in queries]
    svc.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches[run] = dict(K.LAUNCHES)
    return futs, wall


def _serve_shift(cells):
    """The neighbour cells: rho - 0.05, and 0.05 for rho = 0."""
    return [(s, round(r - 0.05, 12) if r > 0.0 else 0.05) for s, r in cells]


def _results(futs):
    return [f.result(0) for f in futs]


def _launched(launches, run, kernel="reference"):
    want = PATH_KERNELS[kernel]
    n = launches[run]
    serve_check(all((c > 0) == (k in want) for k, c in n.items()),
                f"the {run} run launched {n}")


def phase_serve(dev, golden):
    """Phase 16, the serving tier on the card: ``EquilibriumService(
    start_worker=False, max_batch=4, ladder=(1, 2, 4), device=dev)`` on
    the 12 Table II cells at the paper's width (float64, the reference
    kernels).  (a) a cold replay: r* within 1e-6 pct of the golden, all
    CONVERGED, each lane bitwise a C=1 launch of the same solver and
    seed; (b) a shuffled exact-hit replay: every future done at submit,
    no kernel launched and no library built (CompileCounter), the bits of
    (a), hit p50 under 1 ms; (c) a neighbour replay at rho - 0.05 (rho = 0
    at 0.05) against a cold control service: the near rate, fewer
    bisection trips warm than cold, every warm r* within 0.1 bp of the
    control (a sanity bound, as phase 14's); (d) certify_before_cache:
    every CONVERGED answer CERTIFIED, a corrupted lane raising
    CertificationFailed and not cached; (e) a NaN lane failing only its
    future, its batchmates bitwise (a); (f) the threaded worker fed by 4
    client threads, the bits of (a); (g) the disk store reopened by a
    second service: exact hits bitwise, a perturbed entry evicted and
    re-solved; (h) four Huggett cells cold (1e-6 pct of the golden),
    exact and near, and two cells under kernel="fused" (0.1 bp).
    Returns each run's launches."""
    import shutil
    import tempfile
    import threading

    from aiyagari_hark_tpu_torch.ops import kernels as K
    from aiyagari_hark_tpu_torch.serve import (CertificationFailed,
                                               EquilibriumService,
                                               EquilibriumSolveFailed,
                                               make_query)
    from aiyagari_hark_tpu_torch.solver_health import (NONFINITE,
                                                       is_failure,
                                                       status_name)
    from aiyagari_hark_tpu_torch.utils.timing import CompileCounter
    from aiyagari_hark_tpu_torch.verify import (CERTIFIED,
                                                corrupt_store_entry)

    f64 = torch.float64
    t_phase = time.perf_counter()
    sd = golden["labor_sd"]

    def q(s, r, **kw):
        return make_query(s, r, labor_sd=sd, dtype=f64, **WIDTH, **kw)

    def service(**kw):
        return EquilibriumService(start_worker=False, max_batch=4,
                                  ladder=(1, 2, 4), device=dev, **kw)

    g_r = {(c, r): x for c, r, x in zip(golden["crra"], golden["labor_ar"],
                                        golden["r_star_pct"])}
    launches, walls, stats = {}, {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        # (a) the cold replay, into a disk store that (c) and (g) reopen;
        # donor_cutoff=0 keeps every lane cold (a later batch of one flush
        # would otherwise take an earlier batch's roots as donors)
        store_dir = os.path.join(tmp, "store")
        svc = service(disk_path=store_dir, donor_cutoff=0.0)
        futs, walls["cold"] = _serve_wave(
            launches, "cold", svc, [q(s, r) for s, r in SERVE_CELLS])
        cold = _results(futs)
        _launched(launches, "cold")
        dr = max(abs(100.0 * x.r_star - g_r[c])
                 for x, c in zip(cold, SERVE_CELLS))
        serve_check(dr <= 1e-6, f"cold r* {dr} pct from the golden")
        serve_check(all(x.path == "cold" and x.status == 0 for x in cold),
                    f"cold paths {[x.path for x in cold]}, statuses "
                    f"{[status_name(x.status) for x in cold]}")
        for x, (s, r) in zip(cold, SERVE_CELLS):
            ref = svc.reference_solve(q(s, r), bracket_init=x.bracket_init)
            serve_check(np.array_equal(_serve_bits(ref), _serve_bits(x)),
                        f"cell ({s}, {r}) is not bitwise its C=1 launch")
        cold_bits = {c: _serve_bits(x) for x, c in zip(cold, SERVE_CELLS)}
        stats["cold"] = dict(max_abs_dr_pct=dr, bisect_evals=sum(
            x.bisect_iters for x in cold), inner_steps=sum(
            x.egm_iters + x.dist_iters for x in cold))

        # (b) the shuffled exact-hit replay
        order = np.random.default_rng(0).permutation(len(SERVE_CELLS))
        shuffled = [SERVE_CELLS[int(i)] for i in order]
        queries = [q(s, r) for s, r in shuffled]
        torch.cuda.synchronize()
        K.reset_launches()
        with CompileCounter() as cc:
            t0 = time.perf_counter()
            futs = [svc.submit(x) for x in queries]
            walls["hit"] = time.perf_counter() - t0
        launches["hit"] = dict(K.LAUNCHES)
        serve_check(all(f.done() for f in futs), "a hit did not resolve "
                    "at submit")
        hits = _results(futs)
        serve_check(all(x.path == "hit" for x in hits)
                    and all(np.array_equal(_serve_bits(x), cold_bits[c])
                            for x, c in zip(hits, shuffled)),
                    "the hit replay is not the cold replay's bits")
        serve_check(sum(launches["hit"].values()) == 0
                    and cc.compile_events == 0 and cc.cache_misses == 0,
                    f"the hit replay launched {launches['hit']} and built "
                    f"{cc.compile_events} libraries")
        lat = sorted(svc.metrics.latency["hit"].samples)
        serve_check(len(lat) == len(shuffled), f"{len(lat)} hit latencies")
        hit_p50_ms = 1e3 * lat[(len(lat) - 1) // 2]
        serve_check(hit_p50_ms < 1.0, f"hit p50 {hit_p50_ms} ms")
        stats["hit"] = dict(p50_ms=hit_p50_ms, max_ms=1e3 * lat[-1],
                            compile_events=cc.compile_events)
        hit_snap = svc.metrics.snapshot()
        svc.close()

        # (c) the neighbour replay against a cold control service: a
        # second service over (a)'s directory, its roots the donors
        svc = service(disk_path=store_dir)
        shifted = _serve_shift(SERVE_CELLS)
        futs, walls["near"] = _serve_wave(
            launches, "near", svc, [q(s, r) for s, r in shifted])
        warm = _results(futs)
        _launched(launches, "near")
        control = service()
        futs, walls["control"] = _serve_wave(
            launches, "control", control, [q(s, r) for s, r in shifted])
        ctl = _results(futs)
        control.close()
        near_rate = [x.path for x in warm].count("near") / len(warm)
        warm_evals = sum(x.bisect_iters for x in warm)
        cold_evals = sum(x.bisect_iters for x in ctl)
        warm_dr = max(abs(100.0 * (a.r_star - b.r_star))
                      for a, b in zip(warm, ctl))
        serve_check(near_rate > 0.0 and warm_evals < cold_evals,
                    f"near rate {near_rate}, warm trips {warm_evals} "
                    f"against cold {cold_evals}")
        # the JAX service promises a warm r* only "up to inner-solver
        # noise"; 0.1 bp (FUSED_BUDGET_PCT) is a sanity bound, as in
        # phase 14
        serve_check(not any(is_failure(x.status) for x in warm + ctl)
                    and warm_dr <= FUSED_BUDGET_PCT,
                    f"warm r* {warm_dr} pct from the cold control, "
                    f"statuses {[x.status for x in warm]} (warm), "
                    f"{[x.status for x in ctl]} (cold)")
        stats["near"] = dict(
            near_rate=near_rate, warm_bisect_evals=warm_evals,
            cold_bisect_evals=cold_evals, max_abs_dr_pct=warm_dr,
            warm_inner_steps=sum(x.egm_iters + x.dist_iters for x in warm),
            cold_inner_steps=sum(x.egm_iters + x.dist_iters for x in ctl))
        svc.close()

        # (d) certify before caching, the first lane corrupted
        cert = service(certify_before_cache=True,
                       inject_corrupt_lane={"at_launch": 0, "lane": 0,
                                            "field": 0, "amplitude": 3e-3})
        futs, walls["certify"] = _serve_wave(
            launches, "certify", cert, [q(s, r) for s, r in SERVE_CELLS[:4]])
        _launched(launches, "certify")
        try:
            futs[0].result(0)
            raise AssertionError("serve: the corrupted lane certified")
        except CertificationFailed as e:
            serve_check(e.certificate.failed
                        and cert.store.get(e.key) is None,
                        "the corrupted lane was cached")
        levels = [f.result(0).cert_level for f in futs[1:]]
        again = cert.submit(q(*SERVE_CELLS[0]))
        cert.flush()
        levels.append(again.result(0).cert_level)
        serve_check(all(c == CERTIFIED for c in levels),
                    f"cert levels {levels}")
        stats["certify"] = dict(levels=levels, failed=cert.metrics.snapshot(
            )["serve_failed_certificates"])
        cert.close()

        # (e) the NaN drill: one lane poisoned from its first trip
        nan = service(inject_fault_mode="nan")
        mates = SERVE_CELLS[:4]
        futs, walls["nan"] = _serve_wave(launches, "nan", nan, [
            q(s, r, fault_iter=0 if i == 1 else None)
            for i, (s, r) in enumerate(mates)])
        _launched(launches, "nan")
        try:
            futs[1].result(0)
            raise AssertionError("serve: the NaN lane did not fail")
        except EquilibriumSolveFailed as e:
            serve_check(e.status == NONFINITE and is_failure(e.status),
                        f"the NaN lane's status {e.status}")
        serve_check(nan.store.get(q(*mates[1]).key()) is None,
                    "the NaN lane was cached")
        for i in (0, 2, 3):
            serve_check(np.array_equal(_serve_bits(futs[i].result(0)),
                                       cold_bits[mates[i]]),
                        f"NaN batchmate {mates[i]} moved")
        nan.close()

        # (f) the threaded worker, fed by 4 client threads
        # donor_cutoff=0: every lane cold, whatever the batches the
        # worker happens to form, so each answer is (a)'s bits
        worker = EquilibriumService(start_worker=True, max_batch=4,
                                    max_wait_s=0.005, ladder=(1, 2, 4),
                                    donor_cutoff=0.0, device=dev)
        got = {}

        def client(k):
            for s, r in SERVE_CELLS[k::SERVE_CLIENTS]:
                got[(s, r)] = worker.submit(q(s, r)).result(600)

        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVE_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        torch.cuda.synchronize()
        walls["threaded"] = time.perf_counter() - t0
        launches["threaded"] = dict(K.LAUNCHES)
        batches = worker.metrics.snapshot()["serve_batches"]
        worker.close()
        _launched(launches, "threaded")
        serve_check(len(got) == len(SERVE_CELLS) and all(
            np.array_equal(_serve_bits(got[c]), cold_bits[c])
            for c in SERVE_CELLS), "the threaded worker's bits")
        stats["threaded"] = dict(batches=batches, clients=SERVE_CLIENTS)

        # (g) the disk store reopened; one entry perturbed on disk
        reopened = service(disk_path=store_dir)
        futs, walls["disk_hit"] = _serve_wave(
            launches, "disk_hit", reopened, [q(s, r) for s, r in
                                             SERVE_CELLS])
        serve_check(all(f.result(0).path == "hit" and np.array_equal(
            _serve_bits(f.result(0)), cold_bits[c])
            for f, c in zip(futs, SERVE_CELLS))
            and sum(launches["disk_hit"].values()) == 0,
            "the reopened store's hits")
        reopened.close()
        victim = SERVE_CELLS[5]
        corrupt_store_entry(store_dir, key=q(*victim).key(), mode="perturb")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            third = service(disk_path=store_dir)
            futs, walls["disk_resolve"] = _serve_wave(
                launches, "disk_resolve", third, [q(*victim)])
        redo = futs[0].result(0)
        evicted = third.metrics.snapshot()["store_corrupt_evictions"]
        third.close()
        _launched(launches, "disk_resolve")
        serve_check(evicted == 1 and redo.path in ("cold", "near")
                    and redo.status == 0 and abs(100.0 * redo.r_star
                                                 - g_r[victim])
                    <= FUSED_BUDGET_PCT,
                    f"the perturbed entry: {evicted} evicted, re-solved "
                    f"{redo.path} at {100.0 * redo.r_star} pct")
        stats["disk"] = dict(evicted=evicted, resolve_path=redo.path)

        # (h) Huggett: cold, exact and near; then kernel="fused"
        with open(FAMILIES) as f:
            fam = json.load(f)
        hg = fam["huggett"]
        h_cells = list(zip(hg["crra"], hg["labor_ar"]))[:SERVE_HUGGETT]
        hsvc = service()

        def hq(s, r):
            return q(s, r, scenario="huggett",
                     borrow_limit=hg["borrow_limit"])

        futs, walls["huggett_cold"] = _serve_wave(
            launches, "huggett_cold", hsvc, [hq(s, r) for s, r in h_cells])
        hcold = _results(futs)
        _launched(launches, "huggett_cold")
        hdr = max(abs(100.0 * x.r_star - g) for x, g in
                  zip(hcold, hg["r_star_pct"]))
        serve_check(hdr <= 1e-6 and all(
            x.path == "cold" and x.status == 0 for x in hcold),
            f"Huggett cold r* {hdr} pct from the golden, paths "
            f"{[x.path for x in hcold]}")
        hits = [hsvc.submit(hq(s, r)) for s, r in h_cells]
        serve_check(all(f.done() and f.result(0).path == "hit"
                        and f.result(0).values == x.values
                        for f, x in zip(hits, hcold)), "Huggett hits")
        h_shift = _serve_shift(h_cells)
        futs, walls["huggett_near"] = _serve_wave(
            launches, "huggett_near", hsvc, [hq(s, r) for s, r in h_shift])
        hnear = _results(futs)
        hctl_svc = service()
        futs, _ = _serve_wave(launches, "huggett_control", hctl_svc,
                              [hq(s, r) for s, r in h_shift])
        hctl = _results(futs)
        hctl_svc.close()
        hsvc.close()
        h_near_dr = max(abs(100.0 * (a.r_star - b.r_star))
                        for a, b in zip(hnear, hctl))
        serve_check("near" in [x.path for x in hnear]
                    and not any(is_failure(x.status) for x in hnear)
                    and h_near_dr <= FUSED_BUDGET_PCT,
                    f"Huggett near paths {[x.path for x in hnear]}, "
                    f"{h_near_dr} pct from the control")
        stats["huggett"] = dict(
            max_abs_dr_pct=hdr, near_paths=[x.path for x in hnear],
            near_max_abs_dr_pct=h_near_dr,
            warm_bisect_evals=sum(x.bisect_iters for x in hnear),
            cold_bisect_evals=sum(x.bisect_iters for x in hctl))

        fsvc = service()
        f_cells = SERVE_CELLS[:SERVE_FUSED]
        futs, walls["fused"] = _serve_wave(
            launches, "fused", fsvc, [q(s, r, kernel="fused")
                                      for s, r in f_cells])
        fres = _results(futs)
        fsvc.close()
        _launched(launches, "fused", "fused")
        fdr = max(abs(100.0 * x.r_star - g_r[c])
                  for x, c in zip(fres, f_cells))
        serve_check(fdr <= FUSED_BUDGET_PCT and all(x.status == 0
                                                    for x in fres),
                    f"fused r* {fdr} pct from the golden")
        stats["fused"] = dict(max_abs_dr_pct=fdr)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    per_replay = {run: sum(n.values()) for run, n in launches.items()}
    cold_values = {c: list(x.values) for x, c in zip(cold, SERVE_CELLS)}
    log("serve", cells=len(SERVE_CELLS), width=WIDTH, dtype="float64",
        max_batch=4, ladder=[1, 2, 4], walls_s=walls, stats=stats,
        hit_p50_ms=stats["hit"]["p50_ms"], near_rate=near_rate,
        launches=launches, launches_per_replay=per_replay,
        serve_snapshot={k: hit_snap[k] for k in (
            "serve_requests", "serve_hit_rate", "serve_near_rate",
            "serve_batches", "serve_batch_occupancy", "serve_hit_p50_ms",
            "serve_p50_ms", "serve_compiles")},
        phase_s=time.perf_counter() - t_phase)
    return launches, cold_values


# Phase 17: the serving fleet: worker processes behind HTTP on the card.
FLEET_CELLS = [(s, r) for s in (1.0, 3.0, 5.0) for r in (0.0, 0.3, 0.6, 0.9)]
FLEET_WORKERS = 4
FLEET_DEVICE = "cuda"        # the workers' --device
# bench.py's SERVE_SMOKE_KWARGS: the width of the JAX package's drills,
# which time the lease protocol, not the kernels (17c, 17d)
DRILL_WIDTH = dict(a_count=10, dist_count=32, labor_states=3, r_tol=1e-5,
                   max_bisect=24)
CHAOS_DRILL_CELLS = tuple((s, r, 0.25) for (s, r) in
                          ((1.0, 0.0), (3.0, 0.3), (5.0, 0.6),
                           (1.0, 0.9), (3.0, 0.0)))
DR_DRILL_CELLS = tuple((s, r, 0.3) for (s, r) in
                       ((1.0, 0.0), (3.0, 0.3), (5.0, 0.6),
                        (1.0, 0.9), (3.0, 0.9)))
DR_KILL_CELL = (5.0, 0.0, 0.3)
# JAX's error -> HTTP status table, for the errors the card leg raises
FLEET_HTTP = {"DeadlineExceeded": 504, "BadRequest": 400, "NotFound": 404,
              "ChaosDisabled": 404, "EquilibriumSolveFailed": 500}


def fleet_check(ok, what):
    if not ok:
        raise AssertionError(f"fleet: {what}")


def _children() -> dict:
    """This process's child processes that run a fleet worker or a CAS
    replica, pid -> "worker" or "replica" (from /proc)."""
    me, out = os.getpid(), {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid != me:
                continue
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode()
        except (OSError, ValueError, IndexError):
            continue
        if "serve.fleet" in cmd:
            out[int(d)] = "worker"
        elif "serve.lease" in cmd:
            out[int(d)] = "replica"
    return out


class CardWatch:
    """Samples, every ``interval_s`` on a thread, the contexts on the card
    (``nvidia-smi --query-compute-apps=pid,used_memory``) beside this
    process's live worker and replica children (from /proc).  In the
    chip machine's container nvidia-smi reports every context's pid as 1
    (its own namespace's view), so a context is matched to a process by
    count: with this process's own context, a sample holds 1 + (workers
    up) contexts when every worker holds one and no replica does."""

    def __init__(self, interval_s: float = 0.5):
        import threading

        self.interval_s = interval_s
        self.samples: list = []   # (contexts, MiB each, workers, replicas)
        self.kids: dict = {}      # pid -> "worker" | "replica", ever seen
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="card-watch")

    def sample(self) -> None:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout
        mib = []
        for line in out.splitlines():
            parts = [x.strip() for x in line.split(",")]
            if len(parts) == 2 and parts[0].isdigit():
                try:
                    mib.append(float(parts[1]))
                except ValueError:           # "[N/A]"
                    mib.append(float("nan"))
        live = _children()
        self.kids.update(live)
        roles = list(live.values())
        self.samples.append((len(mib), sorted(mib), roles.count("worker"),
                             roles.count("replica")))

    def _run(self) -> None:
        while not self._stop.is_set():
            self.sample()
            self._stop.wait(self.interval_s)

    def __enter__(self) -> "CardWatch":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(60)

    def verdict(self, leg: str, workers: int, replicas: int = 0) -> dict:
        """A sample with ``workers`` workers (and ``replicas`` replicas) up
        holds exactly 1 + ``workers`` contexts: each worker runs on the
        card, no replica does; and nine samples in ten hold no more
        contexts than this process and its live workers (the rest are
        the instants around a worker's exit)."""
        full = [x for x in self.samples
                if x[2] == workers and x[3] >= replicas]
        good = [x for x in full if x[0] == 1 + workers]
        clean = sum(x[0] <= 1 + x[2] for x in self.samples)
        fleet_check(good, f"{leg}: no sample with {workers} workers and "
                    f"{replicas} replicas up holds {1 + workers} contexts "
                    f"(samples {full[:8]})")
        fleet_check(clean >= 0.9 * len(self.samples),
                    f"{leg}: {len(self.samples) - clean} of "
                    f"{len(self.samples)} samples hold more contexts than "
                    "this process and its workers")
        roles = list(self.kids.values())
        return dict(samples=len(self.samples), clean=clean,
                    full_pool=good[0], worker_pids=roles.count("worker"),
                    replica_pids=roles.count("replica"))


def _fleet_vs_reference(dev, served_values: dict, kw: dict):
    """Each served value against an in-process C=1 launch on the card with
    the same seed, as bench.py's _served_vs_reference: a value that
    carries its solve's bracket_init on every field, one without it on
    r*, labor and status.  Returns (mismatched keys, seeded compares)."""
    from aiyagari_hark_tpu_torch.serve import EquilibriumService, make_query

    ref_svc = EquilibriumService(start_worker=False, max_batch=4,
                                 ladder=(1, 2, 4), device=dev)
    bad, seeded = [], 0
    try:
        for key, vals in sorted(served_values.items()):
            c = vals["cell"]
            q = make_query(c[0], c[1], labor_sd=c[2], **kw)
            seed = vals.get("bracket_init")
            fields = ("r_star", "labor", "status")
            if seed is not None:
                seeded += 1
                ref = ref_svc.reference_solve(q, bracket_init=tuple(seed))
                fields += ("capital",)
            else:
                ref = ref_svc.reference_solve(q)
            if any(vals[f] != getattr(ref, f) for f in fields):
                bad.append(key)
    finally:
        ref_svc.close()
    return bad, seeded


def _worker_checks(leg: str, snapshots: list, launches: dict,
                   kernels=PATH_KERNELS["reference"]) -> None:
    """No worker built a library (its /metrics), and the workers that
    reported their launches ran the path's kernels and no other."""
    misses = [s.get("serve_compile_cache_misses") for s in snapshots]
    fleet_check(snapshots and all(m == 0 for m in misses),
                f"{leg}: worker compile-cache misses {misses}")
    told = [n for n in launches.values() if n is not None]
    fleet_check(told and all(sum(n[k] for n in told) > 0 for k in kernels)
                and all(n[k] == 0 for n in told for k in n
                        if k not in kernels),
                f"{leg}: worker launches {launches}")


def _http_status(fn):
    """(code, error name) of a call that must fail over HTTP."""
    import urllib.error

    from aiyagari_hark_tpu_torch.serve import FleetHTTPError

    try:
        fn()
    except FleetHTTPError as e:
        return e.code, e.payload.get("error")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()).get("error")
    raise AssertionError("fleet: the call did not fail")


def _fleet_front(dev, golden, serve_cold, launches):
    """17a: a FleetFront over one EquilibriumService on the card, queried
    by a FleetClient over HTTP at the paper's width."""
    import threading

    from aiyagari_hark_tpu_torch.ops import kernels as K
    from aiyagari_hark_tpu_torch.serve import (EquilibriumService,
                                               FleetClient, FleetFront)

    sd = golden["labor_sd"]
    kw = dict(WIDTH, dtype="float64")
    svc = EquilibriumService(start_worker=True, max_batch=4,
                             max_wait_s=0.005, ladder=(1, 2, 4),
                             donor_cutoff=0.0, device=dev)
    front = FleetFront(svc).start()
    bad = EquilibriumService(start_worker=True, max_batch=4,
                             ladder=(1, 2, 4), inject_fault_mode="nan",
                             device=dev)
    bad_front = FleetFront(bad).start()
    try:
        client = FleetClient([front.url], timeout=600.0)
        got = {}

        def ask(k):
            for s, r in FLEET_CELLS[k::FLEET_WORKERS]:
                got[(s, r)] = client.query((s, r, sd), kw)

        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=ask, args=(k,))
                   for k in range(FLEET_WORKERS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches["front"] = dict(K.LAUNCHES)
        fleet_check(len(got) == len(FLEET_CELLS)
                    and all(x["path"] == "cold" for x in got.values()),
                    f"17a paths {[x['path'] for x in got.values()]}")
        fleet_check(all(got[c]["values"] == serve_cold[c]
                        and got[c]["r_star"] == serve_cold[c][0]
                        for c in FLEET_CELLS),
                    "17a: the values over HTTP are not phase 16's cold "
                    "bits")
        _launched(launches, "front")
        hit_ms = []
        for s, r in FLEET_CELLS:
            t0 = time.perf_counter()
            x = client.query((s, r, sd), kw)
            hit_ms.append(1e3 * (time.perf_counter() - t0))
            fleet_check(x["path"] == "hit"
                        and x["values"] == serve_cold[(s, r)],
                        f"17a: the hit of {(s, r)}")
        hit_ms.sort()
        codes = {
            "DeadlineExceeded": _http_status(lambda: client.query(
                (2.0, 0.5, sd), kw, deadline=-1.0)),      # not stored
            "BadRequest": _http_status(lambda: client.query(
                (3.0, 0.6, sd), kw, scenario="nope")),
            "NotFound": _http_status(lambda: client.get(front.url,
                                                        "/nope")),
            "ChaosDisabled": _http_status(lambda: client._post(
                front.url, "/chaos", {})),
            "EquilibriumSolveFailed": _http_status(lambda: FleetClient(
                [bad_front.url], timeout=600.0).query(
                    (1.0, 0.3, sd), dict(kw, fault_iter=0))),
        }
        fleet_check(all(codes[e] == (c, e) for e, c in FLEET_HTTP.items()),
                    f"17a typed errors {codes}")
        snap = client.get(front.url, "/metrics")
    finally:
        front.stop()
        svc.close()
        bad_front.stop()
        bad.close()
    return dict(cold_wall_s=cold_s, http_hit_p50_ms=hit_ms[len(hit_ms) // 2],
                http_hit_p99_ms=hit_ms[-1], codes=codes,
                serve_batches=snap["serve_batches"])


def _fleet_load(dev, golden, tmp, launches):
    """17b: run_fleet_load, 4 worker processes on the card over one
    shared store at the paper's width: bench.py's _fleet_smoke spec."""
    from aiyagari_hark_tpu_torch.serve.loadgen import (FleetSpec,
                                                       run_fleet_load)

    sd = golden["labor_sd"]
    kw = dict(WIDTH, dtype="float64")
    spec = FleetSpec(cells=tuple((s, r, sd) for s, r in FLEET_CELLS),
                     model_kwargs=kw, n_workers=FLEET_WORKERS,
                     queries_per_worker=30, seed=20260804, zipf_s=0.8,
                     prefetch_k=2, lease_ttl_s=2.0, warm_count=0,
                     sigterm_worker=3, sigterm_after=10, device=FLEET_DEVICE)
    t0 = time.perf_counter()
    with CardWatch() as watch:
        rep = run_fleet_load(spec, store_dir=os.path.join(tmp, "load"))
    wall = time.perf_counter() - t0
    on_card = watch.verdict("17b", FLEET_WORKERS)
    launches["load"] = rep.worker_launches
    bad, seeded = _fleet_vs_reference(dev, rep.served_values, kw)
    served = sum(n for o, n in rep.counts.items() if o.startswith("served:"))
    fleet_check(rep.unresolved == 0 and served == rep.arrivals,
                f"17b outcomes {rep.counts}, {rep.unresolved} unresolved")
    fleet_check(rep.dedup_ratio == 1.0 and rep.leases_leaked == 0,
                f"17b dedup {rep.dedup_ratio}, {rep.leases_leaked} leaked")
    fleet_check(rep.interrupted_rcs.get(3) == 75
                and rep.interrupted_journaled,
                f"17b SIGTERMed worker rc {rep.interrupted_rcs}")
    fleet_check(not bad and rep.value_divergence == 0,
                f"17b: {len(bad)} served values not their C=1 launch, "
                f"{rep.value_divergence} divergent")
    _worker_checks("17b", rep.worker_snapshots, rep.worker_launches)
    return dict(wall_s=wall, arrivals=rep.arrivals, counts=rep.counts,
                p50_ms=rep.p50_ms, p99_ms=rep.p99_ms,
                cold_solves=rep.cold_solves,
                distinct=rep.distinct_published,
                dedup_ratio=rep.dedup_ratio,
                prefetch_issued=rep.prefetch_issued,
                prefetch_converted=rep.prefetch_converted,
                remote_hits=rep.remote_hits, claims_won=rep.claims_won,
                claims_lost=rep.claims_lost, reclaims=rep.lease_reclaims,
                leaked=rep.leases_leaked, rcs=rep.interrupted_rcs,
                seeded_compares=seeded, compared=len(rep.served_values),
                on_card=on_card)


def _fleet_chaos(dev, tmp, launches):
    """17c: run_fleet_load(chaos=...) with bench.py's _chaos_smoke spec and
    plan at the drills' width: the five drills on live workers."""
    from aiyagari_hark_tpu_torch.serve.chaos import ChaosPlan
    from aiyagari_hark_tpu_torch.serve.loadgen import (FleetSpec,
                                                       run_fleet_load)

    kw = dict(DRILL_WIDTH, dtype="float64")
    spec = FleetSpec(cells=tuple((s, r, 0.2) for s, r in FLEET_CELLS),
                     model_kwargs=kw, n_workers=FLEET_WORKERS,
                     queries_per_worker=30, seed=20260806, zipf_s=0.8,
                     prefetch_k=0, lease_ttl_s=2.0, warm_count=0,
                     device=FLEET_DEVICE)
    plan = ChaosPlan(drill_cells=CHAOS_DRILL_CELLS,
                     churn=((40, "leave", 2), (60, "join", None)),
                     slow_publish_s=8.0, partition_reads=2,
                     recovery_queries=6, settle_timeout_s=60.0)
    t0 = time.perf_counter()
    with CardWatch() as watch:
        rep = run_fleet_load(spec, store_dir=os.path.join(tmp, "chaos"),
                             chaos=plan)
    wall = time.perf_counter() - t0
    on_card = watch.verdict("17c", FLEET_WORKERS)
    launches["chaos"] = rep.worker_launches
    ch = rep.chaos
    bad, seeded = _fleet_vs_reference(dev, rep.served_values, kw)
    drills = {r["drill"]: (r["detected"], r["injected"])
              for r in ch["drills"]}
    fleet_check(all(d == i for d, i in drills.values()),
                f"17c drills (detected, injected) {drills}")
    fleet_check(ch["dedup_ratio"] == 1.0 and rep.dedup_ratio == 1.0
                and ch["recovery_dup_publishes"] == 0,
                f"17c dedup {ch['dedup_ratio']} (drilled), "
                f"{rep.dedup_ratio} (traffic), "
                f"{ch['recovery_dup_publishes']} recovery duplicates")
    fleet_check(rep.unresolved == 0 and rep.leases_leaked == 0,
                f"17c {rep.unresolved} unresolved, {rep.leases_leaked} "
                "leaked")
    fleet_check(not bad and rep.value_divergence == 0,
                f"17c: {len(bad)} served values not their C=1 launch, "
                f"{rep.value_divergence} divergent")
    fleet_check(ch["joins"] >= 1 and ch["leaves"] >= 1 and ch["kills"] >= 1,
                f"17c churn {ch['joins']} joins, {ch['leaves']} leaves, "
                f"{ch['kills']} kills")
    _worker_checks("17c", rep.worker_snapshots, rep.worker_launches)
    return dict(wall_s=wall, arrivals=rep.arrivals, counts=rep.counts,
                drills=drills, availability=ch["availability"],
                churn_p99_ms=ch["churn_p99_ms"], hedges=ch["hedges"],
                p50_ms=rep.p50_ms, p99_ms=rep.p99_ms,
                seeded_compares=seeded, compared=len(rep.served_values),
                on_card=on_card)


def _fleet_dr(dev, tmp, launches):
    """17d: bench.py's _dr_smoke on the card: 4 --chaos workers on a
    3-replica quorum (ReplicaSet), the five DR drills, then the whole
    fleet SIGKILLed with a live lease, the replicas' record maps recovered
    bitwise, a fresh pool re-serving every cell."""
    import signal
    import threading

    from aiyagari_hark_tpu_torch.obs.journal import read_journal
    from aiyagari_hark_tpu_torch.serve.chaos import (DRPlan, _poll_until,
                                                     run_dr_drills)
    from aiyagari_hark_tpu_torch.serve.lease import (LoopbackCASBackend,
                                                     make_backend)
    from aiyagari_hark_tpu_torch.serve.loadgen import (FleetCtl, FleetSpec,
                                                       _spawn_fleet,
                                                       exit_launches)
    from aiyagari_hark_tpu_torch.serve.replicated import ReplicaSet
    from aiyagari_hark_tpu_torch.serve.store import SolutionStore

    kw = dict(DRILL_WIDTH, dtype="float64")
    cells = tuple((s, r, 0.2) for s, r in FLEET_CELLS)
    served_values: dict = {}
    divergence = served = arrivals = errors = 0

    def note(cell, res) -> None:
        nonlocal divergence, served
        served += 1
        key = int(res["key"])
        vals = {"cell": tuple(float(c) for c in cell),
                "r_star": res["r_star"], "capital": res["capital"],
                "labor": res["labor"], "status": res["status"],
                "bracket_init": res.get("bracket_init")}
        prior = served_values.get(key)
        if prior is not None and (prior["r_star"], prior["labor"],
                                  prior["status"]) != (
                vals["r_star"], vals["labor"], vals["status"]):
            divergence += 1
        served_values.setdefault(key, vals)

    t0 = time.perf_counter()
    store_dir = os.path.join(tmp, "dr")
    os.makedirs(store_dir)
    with CardWatch() as watch, ReplicaSet(os.path.join(tmp, "replicas"),
                                          n=3, snapshot_every=16) as replicas:
        spec = FleetSpec(cells=cells, model_kwargs=kw,
                         n_workers=FLEET_WORKERS, queries_per_worker=0,
                         seed=20260807, lease_ttl_s=2.0,
                         lease_backend=replicas.spec, device=FLEET_DEVICE)
        journals1 = [os.path.join(store_dir, f"journal_w{i}.jsonl")
                     for i in range(spec.n_workers)]
        t_spawn = time.perf_counter()
        procs, urls = _spawn_fleet(spec, store_dir, journals1,
                                   ready_timeout_s=180.0, chaos=True)
        spawn_s = [time.perf_counter() - t_spawn]
        ctl = FleetCtl(spec, procs, urls, journals1, store_dir,
                       timeout_s=120.0)
        try:
            for rnd in range(2):
                for j, cell in enumerate(cells):
                    arrivals += 1
                    try:
                        note(cell, ctl.query(
                            cell, prefer=(j + rnd) % spec.n_workers))
                    except Exception:
                        errors += 1
            t_drills = time.perf_counter()
            info = run_dr_drills(DRPlan(drill_cells=DR_DRILL_CELLS,
                                        settle_timeout_s=60.0),
                                 ctl, replicas)
            drills_s = time.perf_counter() - t_drills
            snaps1 = [ctl._client.get(u, "/metrics") for i, u in
                      enumerate(urls) if ctl.alive(i)]
            ctl.post(0, "/chaos", {"slow_publish_s": 12.0,
                                   "slow_cells": [list(DR_KILL_CELL)]})
            parked: dict = {}

            def park():
                try:
                    parked["res"] = ctl.query(DR_KILL_CELL, prefer=0)
                except Exception as e:
                    parked["err"] = e

            pt = threading.Thread(target=park, name="dr-park")
            pt.start()
            kill_parked = _poll_until(
                lambda: ctl.fleet_info(0) is not None
                and len(ctl.fleet_info(0)["held_leases"]) > 0, 10.0)
            for p in procs:
                p.send_signal(signal.SIGKILL)
            for p in procs:
                p.wait(30.0)
            pt.join(60.0)
        except BaseException:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            raise

        dumps_before = []
        for port in replicas.ports:
            cli = LoopbackCASBackend(f"127.0.0.1:{port}")
            dumps_before.append(sorted(map(tuple, cli.dump())))
            cli.close()
        replicas.kill_all(signal.SIGKILL)
        t_rec0 = time.perf_counter()
        for i in range(replicas.n):
            replicas.restart(i)
        state_mismatches = recovered_keys = 0
        for i, port in enumerate(replicas.ports):
            cli = LoopbackCASBackend(f"127.0.0.1:{port}")
            after = sorted(map(tuple, cli.dump()))
            cli.close()
            recovered_keys = max(recovered_keys, len(after))
            state_mismatches += after != dumps_before[i]

        journals2 = [os.path.join(store_dir, f"journal_r{i}.jsonl")
                     for i in range(spec.n_workers)]
        t_spawn = time.perf_counter()
        procs2, urls2 = _spawn_fleet(spec, store_dir, journals2,
                                     ready_timeout_s=180.0)
        spawn_s.append(time.perf_counter() - t_spawn)
        ctl2 = FleetCtl(spec, procs2, urls2, journals1 + journals2,
                        store_dir, timeout_s=120.0)
        try:
            arrivals += 1
            res_orphan = ctl2.query(DR_KILL_CELL)
            note(DR_KILL_CELL, res_orphan)
            orphan_key = int(res_orphan["key"])
            orphan_reclaimed = any(
                ev.get("key") == orphan_key
                for jp in journals2 if os.path.exists(jp)
                for ev in read_journal(jp,
                                       event="FLEET_LEASE_RECLAIM"))
            for j, cell in enumerate(cells):
                arrivals += 1
                try:
                    note(cell, ctl2.query(cell,
                                          prefer=j % spec.n_workers))
                except Exception:
                    errors += 1
            recovery_s = time.perf_counter() - t_rec0
            snaps2 = [ctl2._client.get(u, "/metrics") for u in urls2]
        except BaseException:
            for p in procs2:
                if p.poll() is None:
                    p.kill()
            raise
        for p in procs2:
            p.send_signal(signal.SIGTERM)
        worker_launches = {}
        for i, p in enumerate(procs2):
            try:
                p.wait(60.0)
            except Exception:
                p.kill()
                p.wait()
            worker_launches[i] = exit_launches(p)
            p.stdout.close()
        audit = SolutionStore(
            disk_path=store_dir, shared=True, lease_ttl_s=2.0,
            owner="dr-audit",
            lease_backend=make_backend(replicas.spec, root=store_dir))
        t_audit = time.perf_counter()
        while (audit.lease_files()
               and time.perf_counter() - t_audit < 12.0):
            audit.gc_stale_leases()
            if audit.lease_files():
                time.sleep(0.2)
        leaked = len(audit.lease_files())
        audit.close()
        wal_replays = snapshot_compacts = 0
        for jp in replicas.journals:
            if os.path.exists(jp):
                wal_replays += len(read_journal(jp, event="WAL_REPLAY"))
                snapshot_compacts += len(read_journal(
                    jp, event="SNAPSHOT_COMPACT"))
        pub_counts: dict = {}
        for jp in journals1 + journals2:
            if os.path.exists(jp):
                for ev in read_journal(jp, event="FLEET_PUBLISH"):
                    k = int(ev["key"])
                    pub_counts[k] = pub_counts.get(k, 0) + 1
    wall = time.perf_counter() - t0
    on_card = watch.verdict("17d", FLEET_WORKERS, replicas=3)
    launches["dr"] = worker_launches
    bad, seeded = _fleet_vs_reference(dev, served_values, kw)
    drill_keys = set(info["drill_keys"])
    expected_dup = set(info["expected_dup_keys"])
    clean = {k: n for k, n in pub_counts.items() if k not in drill_keys}
    dedup = sum(clean.values()) / len(clean) if clean else None
    violations = sum(n - 1 for k, n in pub_counts.items()
                     if k in drill_keys and k not in expected_dup and n > 1)
    drills = {r["drill"]: (r["detected"], r["injected"])
              for r in info["drills"]}
    fleet_check(all(d == i for d, i in drills.values()),
                f"17d DR drills (detected, injected) {drills}")
    fleet_check(state_mismatches == 0 and kill_parked and orphan_reclaimed,
                f"17d recovery: {state_mismatches} replica maps differ, "
                f"lease parked {kill_parked}, orphan reclaimed "
                f"{orphan_reclaimed}")
    fleet_check(dedup == 1.0 and violations == 0 and leaked == 0
                and errors == 0,
                f"17d dedup {dedup}, {violations} drill violations, "
                f"{leaked} leaked, {errors} unanswered")
    fleet_check(not bad and divergence == 0,
                f"17d: {len(bad)} served values not their C=1 launch, "
                f"{divergence} divergent")
    fleet_check(wal_replays >= 3 and snapshot_compacts >= 1,
                f"17d {wal_replays} WAL replays, {snapshot_compacts} "
                "compactions")
    _worker_checks("17d", snaps1 + snaps2, worker_launches)
    return dict(wall_s=wall, drills_s=drills_s, recovery_s=recovery_s,
                pool_start_s=spawn_s,
                arrivals=arrivals, served=served, drills=drills,
                recovered_keys=recovered_keys, wal_replays=wal_replays,
                snapshot_compacts=snapshot_compacts, dedup_ratio=dedup,
                seeded_compares=seeded, compared=len(served_values),
                on_card=on_card)


def phase_fleet(dev, golden, serve_cold):
    """Phase 17, the serving fleet on the card (float64, the reference
    kernels): (a) a FleetFront over one EquilibriumService queried by a
    FleetClient over HTTP at the paper's width, the 12 cells' values
    bitwise phase 16's cold bits, the hits, JAX's HTTP codes for the
    typed errors; (b) run_fleet_load with 4 worker processes on the card
    over one shared store at the paper's width, worker 3 SIGTERMed after
    10 queries (bench.py's _fleet_smoke spec): every arrival served,
    dedup 1.0, no leaked lease, exit 75, every served value bitwise its
    same-seed C=1 launch in this process and equal on every worker;
    (c) the five chaos drills (bench.py's _chaos_smoke) and (d) the five
    DR drills on a 3-replica quorum with the full-fleet SIGKILL (bench.py's
    _dr_smoke), both at the drills' width.  In each leg every worker holds
    a context on the card, no replica does, and no worker builds a
    library.  Returns each leg's launches: 17a's in this process, the
    others per worker."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    launches: dict = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    try:
        legs = {"front": _fleet_front(dev, golden, serve_cold, launches)}
        log("fleet_front", **legs["front"])
        legs["load"] = _fleet_load(dev, golden, tmp, launches)
        log("fleet_load", **legs["load"])
        legs["chaos"] = _fleet_chaos(dev, tmp, launches)
        log("fleet_chaos", **legs["chaos"])
        legs["dr"] = _fleet_dr(dev, tmp, launches)
        log("fleet_dr", **legs["dr"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("fleet", width=WIDTH, drill_width=DRILL_WIDTH, dtype="float64",
        workers=FLEET_WORKERS, launches=launches,
        walls_s={leg: r.get("wall_s", r.get("cold_wall_s"))
                 for leg, r in legs.items()},
        phase_s=time.perf_counter() - t_phase)
    return launches


SHARD_COUNTS = (2, 3, 4, 8)      # 18a: virtual shards of the one card
# 18b: for the script's time limit the state axis runs M = 2 only, on
# the first 4 of the 12 cells (sigma = 1, every rho), clean and with the
# NaN drill (PERF.md §4); the CPU tests hold M = 2 and 4 on every cell
# (tests/test_torch_state_sharding.py)
STATE_SHARDS = (2,)
STATE_CRRA = (1.0,)              # 18b's cells: phase 3's rows 0-3
NAN_CELL = 2                     # 18b's drill: sigma = 1, rho = 0.6
# 18c's state-sharded flush: two of phase 16's cells (cut from four for
# the script's time limit)
STATE_SERVE_CELLS = [(1.0, 0.0), (5.0, 0.6)]
STATE_BUDGET_PCT = 1e-3          # 0.1 bp: the JAX state-sharding contract
PANEL_PERIODS = 200              # 18d: periods of each panel history
PANEL_AGENTS = 352               # 18d: 350 rounded up to divide 4 shards
SWEEP_FIELDS = ("r_star_pct", "saving_rate_pct", "capital", "excess",
                "bisect_iters", "egm_iters", "dist_iters", "status",
                "descent_steps", "polish_steps", "precision_escalations")


def shard_check(ok, what):
    if not ok:
        raise AssertionError(f"sharding: {what}")


def _same_sweep_bits(a, b) -> bool:
    return all(_bits_equal(getattr(a, f), getattr(b, f))
               for f in SWEEP_FIELDS)


def _sharded_run(dev, sweep, **kw):
    """One float64 full-width ``run_table2_sweep``, its launch counters set
    to 0 just before it and read just after, and its host wall."""
    from aiyagari_hark_tpu_torch.ops import kernels as K
    from aiyagari_hark_tpu_torch.parallel.sweep import run_table2_sweep

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = run_table2_sweep(sweep, dtype=torch.float64, device=dev,
                               **WIDTH, **kw)
    torch.cuda.synchronize()
    return res, dict(K.LAUNCHES), time.perf_counter() - t0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_sharding(dev, golden, sweeps, serve_cold):
    """Phase 18, the sharding layer on the card (float64, the paper's
    width, the 12 Table II cells), every mesh over virtual entries of the
    one card (``parallel.mesh.virtual_devices``): (a) the cells axis,
    ``mesh="auto"`` (None on one card) and 2, 3, 4 and 8 shards (the 12
    cells pad to 16 at 8), bitwise phase 3's rows, and once under
    kernel="fused" at 4 shards, bitwise phase 5's; (b) the state axis,
    ``SweepConfig(state_shards=M)`` for M in
    ``STATE_SHARDS``: r* within 0.1 bp of phase 3's rows, statuses equal,
    the EGM grid kernel launched and the lottery grid kernel not; the
    loop's step as a CUDA graph bitwise the eager push;
    ``state="sharded"`` with no mesh bitwise phase 3; a NaN in cell 2
    recovered by a replicated rung, the other cells bitwise the clean
    M=2 run;
    (c) serving: a 4-shard lane mesh's 12-cell cold replay bitwise phase
    16's cold values, ``state_shards=2`` on ``STATE_SERVE_CELLS`` within
    0.1 bp of them, and the two together refused; (d) the notebook's
    Krusell-Smith panel split over agent shards: one shard bitwise
    ``simulate_panel``, 4 shards finite and positive with mean capital
    within 0.8-1.25 of the unsharded run; (e) one NCCL rank
    (``multihost.initialize``): an all-reduce, then (a)'s 4-shard sweep
    through the group-spanning mesh, bitwise (a).  Returns each run's
    launches."""
    from aiyagari_hark_tpu_torch.models import ks_model, simulate
    from aiyagari_hark_tpu_torch.models.ks_model import AFuncParams
    from aiyagari_hark_tpu_torch.ops import kernels as K
    from aiyagari_hark_tpu_torch.parallel import (initial_panel_sharded,
                                                  make_mesh, multihost,
                                                  simulate_panel_sharded)
    from aiyagari_hark_tpu_torch.models.household import graphed_step
    from aiyagari_hark_tpu_torch.ops.markov import (
        sharded_wealth_push_forward, split_wealth_operator)
    from aiyagari_hark_tpu_torch.parallel.mesh import (state_mesh,
                                                       virtual_devices)
    from aiyagari_hark_tpu_torch.serve import EquilibriumService, make_query
    from aiyagari_hark_tpu_torch.solver_health import is_failure, status_name
    from aiyagari_hark_tpu_torch.utils.config import (SweepConfig,
                                                      notebook_run_configs)

    f64 = torch.float64
    t_phase = time.perf_counter()
    launches, walls = {}, {}
    p3, p5 = sweeps["float64"][1], sweeps["fused_float64"][1]
    ref_set = set(PATH_KERNELS["reference"])

    def launched(run, want):
        n = launches[run]
        shard_check(all((c > 0) == (k in want) for k, c in n.items()),
                    f"the {run} run launched {n}")

    # 18a. the cells axis
    res, launches["auto"], walls["auto"] = _sharded_run(
        dev, SweepConfig(), mesh="auto")
    shard_check(_same_sweep_bits(res, p3), "mesh='auto' is not phase 3's "
                "rows bit for bit")
    launched("auto", ref_set)
    four = None
    for n in SHARD_COUNTS:
        with virtual_devices(dev, n):
            mesh = make_mesh(("cells",))
            res, launches[f"cells_{n}"], walls[f"cells_{n}"] = _sharded_run(
                dev, SweepConfig(), mesh=mesh)
        shard_check(_same_sweep_bits(res, p3), f"the {n}-shard sweep is not "
                    f"phase 3's rows bit for bit")
        launched(f"cells_{n}", ref_set)
        if n == 4:
            four = res
    with virtual_devices(dev, 4):
        res, launches["cells_4_fused"], walls["cells_4_fused"] = \
            _sharded_run(dev, SweepConfig(), mesh="auto", kernel="fused")
    shard_check(_same_sweep_bits(res, p5), "the 4-shard fused sweep is not "
                "phase 5's rows bit for bit")
    launched("cells_4_fused", set(PATH_KERNELS["fused"]))
    log("sharding_cells", shards=list(SHARD_COUNTS), walls_s=walls,
        phase3_wall_s=p3.wall_seconds, launches={
            k: v for k, v in launches.items() if k.startswith(("auto",
                                                               "cells"))},
        bitwise=True)

    # 18b. the state axis, on phase 3's first len(rho) cells
    state_cells = SweepConfig(crra_values=STATE_CRRA)
    n_state = len(state_cells.cells())
    g_r = np.asarray(p3.r_star_pct)[:n_state]
    p3_state = p3.status[:n_state]
    state_rec = {}
    clean2 = None
    for m in STATE_SHARDS:
        with virtual_devices(dev, m):
            res, launches[f"state_{m}"], walls[f"state_{m}"] = _sharded_run(
                dev, state_cells.replace(state_shards=m))
        shard_check(np.array_equal(res.labor_ar, p3.labor_ar[:n_state])
                    and np.array_equal(res.crra, p3.crra[:n_state]),
                    "18b's cells are not phase 3's")
        dr = float(np.abs(res.r_star_pct - g_r).max())
        shard_check(dr <= STATE_BUDGET_PCT, f"state_shards={m}: r* {dr} pct "
                    f"from phase 3")
        shard_check(np.array_equal(res.status, p3_state),
                    f"state_shards={m} statuses "
                    f"{[status_name(x) for x in res.status]}")
        launched(f"state_{m}", {"egm_policy_grid"})
        op_bytes = len(g_r) * 7 * WIDTH["dist_count"] ** 2 * 8
        state_rec[m] = dict(max_abs_dr_pct=dr, wall_s=walls[f"state_{m}"],
                            sum_dist_iters=int(res.dist_iters.sum()),
                            bisect_iters=res.bisect_iters.tolist(),
                            operator_bytes=op_bytes,
                            operator_bytes_per_shard=op_bytes // m)
        if m == 2:
            clean2 = res
    # the state-sharded loop's step on one card is a CUDA graph: its bits
    # are the eager push's, at the sweep's shapes
    gen = torch.Generator(device=dev).manual_seed(5)
    d_n = WIDTH["dist_count"]
    S = torch.rand((len(g_r), 7, d_n, d_n), generator=gen, dtype=f64,
                   device=dev)
    P = torch.rand((7, 7), generator=gen, dtype=f64, device=dev)
    d0, d1 = (torch.rand((len(g_r), d_n, 7), generator=gen, dtype=f64,
                         device=dev) for _ in range(2))
    with virtual_devices(dev, 2):
        sm = state_mesh(2)
        blocks = split_wealth_operator(S / S.sum(-2, keepdim=True), sm)

        def push(d):
            return sharded_wealth_push_forward(d, blocks, P, sm)

        step = graphed_step(push, d0)
        graph_bits = all(torch.equal(step(d), push(d)) for d in (d1, d0))
    del S, blocks, step
    shard_check(graph_bits, "the graphed state-sharded step is not the "
                "eager push bit for bit")
    res, launches["state_no_mesh"], walls["state_no_mesh"] = _sharded_run(
        dev, SweepConfig(), state="sharded")
    shard_check(_same_sweep_bits(res, p3), "state='sharded' with no mesh is "
                "not phase 3's rows bit for bit")
    launched("state_no_mesh", ref_set)
    # the NaN drill on cell 2
    with virtual_devices(dev, 2):
        res, launches["state_2_nan"], walls["state_2_nan"] = _sharded_run(
            dev, state_cells.replace(state_shards=2),
            inject_fault={"cell": NAN_CELL, "at_iter": 1, "mode": "nan"})
    shard_check(int(res.retries[NAN_CELL]) >= 1
                and not bool(is_failure(int(res.status[NAN_CELL]))),
                f"cell 2 not recovered: retries {res.retries.tolist()}, "
                f"status {status_name(int(res.status[NAN_CELL]))}")
    shard_check(abs(float(res.r_star_pct[NAN_CELL]) - float(g_r[NAN_CELL]))
                <= STATE_BUDGET_PCT, "the replicated rung's r* is off")
    others = np.arange(len(g_r)) != NAN_CELL
    shard_check(all(_bits_equal(getattr(res, f)[others],
                                getattr(clean2, f)[others])
                    for f in SWEEP_FIELDS),
                "the NaN drill moved another cell's bits")
    # the rung runs the reference kernels (C=1), the clean lanes neither
    shard_check(launches["state_2_nan"]["stationary_lottery_grid"] > 0,
                "the replicated rung did not launch the lottery kernel")
    log("sharding_state", runs=state_rec, graphed_step_bitwise=graph_bits,
        no_mesh_wall_s=walls["state_no_mesh"],
        nan_drill_wall_s=walls["state_2_nan"],
        nan_drill_retries=res.retries.tolist(), launches={
            k: v for k, v in launches.items() if k.startswith("state")})

    # 18c. serving
    sd = golden["labor_sd"]

    def q(s, r, **kw):
        return make_query(s, r, labor_sd=sd, dtype=f64, **WIDTH, **kw)

    def cold_wave(run, svc, cells, **kw):
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        futs = [svc.submit(q(s, r, **kw)) for s, r in cells]
        svc.flush()
        torch.cuda.synchronize()
        walls[run] = time.perf_counter() - t0
        launches[run] = dict(K.LAUNCHES)
        return [f.result(0) for f in futs]

    with virtual_devices(dev, 4):
        with EquilibriumService(start_worker=False, max_batch=4,
                                ladder=(1, 2, 4), device=dev, mesh="auto",
                                donor_cutoff=0.0) as svc:
            shard_check(svc.batcher.ladder == (4,), f"ladder "
                        f"{svc.batcher.ladder}")
            out = cold_wave("serve_cells_4", svc, SERVE_CELLS)
    shard_check(all(x.path == "cold" for x in out), "a 4-shard lane was "
                "not cold")
    shard_check(all(_bits_equal(np.asarray(x.values, np.float64),
                                np.asarray(serve_cold[c], np.float64))
                    for x, c in zip(out, SERVE_CELLS)),
                "the 4-shard cold replay is not phase 16's bits")
    launched("serve_cells_4", ref_set)
    with virtual_devices(dev, 2):
        with EquilibriumService(start_worker=False, max_batch=4,
                                ladder=(1, 2, 4), device=dev,
                                state_shards=2, donor_cutoff=0.0) as svc:
            out = cold_wave("serve_state_2", svc, STATE_SERVE_CELLS,
                            state="sharded")
        try:
            EquilibriumService(start_worker=False, device=dev, mesh="auto",
                               state_shards=2)
            refused = False
        except ValueError:
            refused = True
    shard_check(refused, "state_shards=2 with a 2-shard lane mesh was "
                "accepted")
    dr = max(abs(x.r_star - serve_cold[c][0]) * 100.0
             for x, c in zip(out, STATE_SERVE_CELLS))
    shard_check(dr <= STATE_BUDGET_PCT and all(x.status == 0 for x in out),
                f"served state-sharded r* {dr} pct from phase 16")
    launched("serve_state_2", {"egm_policy_grid"})
    log("sharding_serve", walls_s={k: walls[k] for k in ("serve_cells_4",
                                                          "serve_state_2")},
        state_max_abs_dr_pct=dr, launches={
            k: launches[k] for k in ("serve_cells_4", "serve_state_2")})

    # 18d. the panel over agent shards, the notebook's calibration at the
    # wealth study's fixed rule (phase 11's policy)
    agent, econ = notebook_run_configs()
    cal = ks_model.build_ks_calibration(agent, econ, dtype=f64, device=dev)
    with open(WEALTH_STUDY) as f:
        study = json.load(f)
    rule = AFuncParams(*(torch.tensor(study["policy_afunc"][k], dtype=f64,
                                      device=dev)
                         for k in ("intercept", "slope")))
    policy = ks_model.solve_ks_household(rule, cal)[0]
    chain = simulate.simulate_markov_history(
        cal.agg_transition, 0, PANEL_PERIODS,
        torch.Generator(device=dev).manual_seed(7))

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    K.reset_launches()
    one = make_mesh(("agents",), devices=[dev])
    init1 = initial_panel_sharded(cal, agent.agent_count, 0, gen(1), one)
    init0 = simulate.initial_panel(cal, agent.agent_count, 0, gen(1))
    h1, f1 = simulate_panel_sharded(policy, cal, chain, init1, gen(3), one)
    h0, f0 = simulate.simulate_panel(policy, cal, chain, init0, gen(3))
    shard_check(all(torch.equal(a, b) for a, b in zip(init1, init0))
                and all(torch.equal(a, b) for a, b in zip(h1, h0))
                and all(torch.equal(a, b) for a, b in zip(f1, f0)),
                "the one-shard panel is not simulate_panel bit for bit")
    with virtual_devices(dev, 4):
        mesh4 = make_mesh(("agents",))
        try:
            initial_panel_sharded(cal, agent.agent_count, 0, gen(1), mesh4)
            shard_check(False, f"{agent.agent_count} agents on 4 shards "
                        "did not raise")
        except ValueError:
            pass
        init4 = initial_panel_sharded(cal, PANEL_AGENTS, 0, gen(1), mesh4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h4, f4 = simulate_panel_sharded(policy, cal, chain, init4, gen(3),
                                        mesh4)
        torch.cuda.synchronize()
        ms4 = 1e3 * (time.perf_counter() - t0) / PANEL_PERIODS
    initu = simulate.initial_panel(cal, PANEL_AGENTS, 0, gen(1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hu, _ = simulate.simulate_panel(policy, cal, chain, initu, gen(3))
    torch.cuda.synchronize()
    msu = 1e3 * (time.perf_counter() - t0) / PANEL_PERIODS
    ratio = float(h4.A_prev.mean() / hu.A_prev.mean())
    shard_check(bool(torch.isfinite(h4.A_prev).all())
                and bool((h4.A_prev > 0).all())
                and f4.assets.shape == (PANEL_AGENTS,)
                and 0.8 < ratio < 1.25,
                f"the 4-shard panel: ratio {ratio}")
    launches["panel"] = dict(K.LAUNCHES)
    shard_check(not any(launches["panel"].values()), "the panel launched "
                f"{launches['panel']}")
    log("sharding_panel", periods=PANEL_PERIODS, agents_one_shard=int(
        agent.agent_count), agents_four_shards=PANEL_AGENTS,
        one_shard_bitwise=True, mean_capital_ratio_4_over_1=ratio,
        ms_per_period_4_shards=ms4, ms_per_period_unsharded=msu)

    # 18e. one NCCL rank: the group-spanning mesh
    import torch.distributed as dist

    shard_check(multihost.initialize(f"localhost:{_free_port()}", 1, 0,
                                     device=dev, timeout_s=120.0),
                "multihost.initialize did not build a group")
    try:
        x = torch.ones(4, dtype=f64, device=dev)
        dist.all_reduce(x)
        shard_check(bool((x == 1.0).all()), "the one-rank all_reduce")
        with virtual_devices(dev, 4):
            mesh = make_mesh(("cells",))
            shard_check(mesh.ranks is not None
                        and mesh.ranks.tolist() == [0, 0, 0, 0],
                        f"the group mesh's ranks {mesh.ranks}")
            res, launches["nccl_cells_4"], walls["nccl_cells_4"] = \
                _sharded_run(dev, SweepConfig(), mesh=mesh)
        shard_check(_same_sweep_bits(res, four), "the group-spanning "
                    "4-shard sweep is not 18a's bit for bit")
        launched("nccl_cells_4", ref_set)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    log("sharding_multihost", backend=backend, world=1,
        wall_s=walls["nccl_cells_4"], launches=launches["nccl_cells_4"])
    log("sharding", phase_s=time.perf_counter() - t_phase)
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
    # the kernels build while phase 11 runs: its path launches none of
    # them, so the build's wall overlaps it (the script's time limit)
    build = {}

    def build_kernels():
        try:
            build["seconds"] = K.build_libraries()
        except BaseException as e:            # re-raised after the join
            build["error"] = e

    build_thread = threading.Thread(target=build_kernels)
    build_thread.start()
    try:
        launches_ks = phase_ks(dev)
    finally:
        build_thread.join()
    stamp("11 (beside the build)")
    if "error" in build:
        raise build["error"]
    log("build", seconds=build["seconds"], overlapped_with="phase 11")
    for name, text in K.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    records = phase_kernels(dev)
    stamp("2")
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
    stamp("3-5b")
    phase_profile(dev)
    phase_profile(dev, "fused")
    stamp("6")
    fine_egm, fine_lottery, fine_fused = phase_fine(dev)
    fine_tail_egm = fine_tail_egm_check(dev)
    fine_tail_fused = fine_tail_fused_check(dev)
    launches_fine = phase_fine_equilibrium(dev)
    launches_fine.update(phase_fine_grids(dev))
    launches_many, many_records = phase_many_states(dev)
    stamp("7")
    launches_c1 = phase_cell(dev, golden)
    launches_c1.update({k: v for k, v in phase_cell(dev, golden,
                                                    "fused").items() if v})
    mixed_c1 = phase_cell(dev, golden, precision="mixed")
    phase_illinois(dev, golden)
    stamp("8")
    engine = phase_engine(dev, golden, sweeps)
    stamp("9")
    fam_records, families = phase_families(dev, golden)
    stamp("10")
    launches_ext, ext_pairs = phase_extensions(dev)
    stamp("12")
    launches_pf = phase_portfolio(dev)
    stamp("13")
    launches_dur = phase_durability(dev)
    stamp("14")
    launches_obs = phase_obs(dev, sweeps)
    stamp("15")
    launches_serve, serve_cold = phase_serve(dev, golden)
    stamp("16")
    launches_fleet = phase_fleet(dev, golden, serve_cold)
    stamp("17")
    launches_shard = phase_sharding(dev, golden, sweeps, serve_cold)
    stamp("18")
    log("phase_walls", seconds=phase_walls(),
        total_s=time.perf_counter() - T0)
    for name in PATH_KERNELS["fused"]:
        launches[name] = f_launches[name]
        launches32[name] = f_launches32[name]

    kernels = []
    for name, recs in records.items():
        r64 = next(r for r in recs if r["dtype"] == "torch.float64")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"aiyagari_hark_tpu_torch/ops/csrc/{K.SOURCES[name]}",
            "sources": [f"aiyagari_hark_tpu_torch/ops/csrc/{K.SOURCES[lib]}"
                        for lib in (name, f"{name}_wide")
                        if lib in K.SOURCES],
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
    kernels[1]["fine"] = fine_lottery
    kernels[2]["fine"] = fine_fused
    # phase 7's tailed lanes on the compact grids at the fine width
    kernels[0]["fine_tail"] = fine_tail_egm
    kernels[2]["fine_tail"] = fine_tail_fused
    # each kernel's layout by lane: Table II, the fine width, the fine
    # compact grids with the tail
    fine_layout = {"egm_policy_grid": [fine_egm["layout"]],
                   "stationary_lottery_grid": [r["layout"]
                                               for r in fine_lottery],
                   "fused_cell_grid": [r["layout"] for r in fine_fused]}
    for k in kernels:
        k["layouts"] = {
            "table2": k["layout"], "fine": fine_layout[k["name"]],
            "fine_tail": [f"{r['grid']} {r['dtype']} A={r['A']}: "
                          f"{r['layout']}" for r in k.get("fine_tail", [])]}
    # phase 7: each kernel's launches per fine solve (f64, f32, each
    # under both kernel policies, the four-lane batch), per config-1 and
    # many-state solve; the two distribution kernels past 16 states
    for k in kernels:
        k["launches_fine"] = {run: n[k["name"]]
                              for run, n in launches_fine.items()}
        k["launches_many_states"] = {run: n[k["name"]]
                                     for run, n in launches_many.items()}
    for k in kernels[1:]:
        k["many_states"] = many_records
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
    # phase 12: each kernel's launches per extension run, and the two
    # reference kernels' C=5 checks on the beta types
    for k in kernels:
        k["launches_extensions"] = {run: n[k["name"]]
                                    for run, n in launches_ext.items()}
    for k in kernels:
        for rec in ext_pairs["beta_types_c5"]:
            if rec["name"] == k["name"]:
                k["beta_types_c5"] = rec
    # phases 13-14: each kernel's launches per portfolio run (the
    # portfolio path is plain PyTorch; its degenerate check's single-asset
    # solve launches the reference kernels) and per durability drill (a
    # retried launch counts at every attempt)
    for k in kernels:
        k["launches_portfolio"] = {run: n[k["name"]]
                                   for run, n in launches_pf.items()}
        k["launches_durability"] = {run: n[k["name"]]
                                    for run, n in launches_dur.items()}
    # phase 15: each kernel's launches per observed run (the journaled,
    # traced, profiled sweep of each kernel policy; the two drills)
    for k in kernels:
        k["launches_obs"] = {run: n[k["name"]]
                             for run, n in launches_obs.items()}
    # phase 16: each kernel's launches per serve run (a cold or near flush
    # of the reference kernels; the fused kernel under kernel="fused"; an
    # exact hit launches nothing)
    for k in kernels:
        k["launches_serve"] = {run: n[k["name"]]
                               for run, n in launches_serve.items()}
    # phase 17: each kernel's launches per fleet leg: the in-process
    # front (17a), and per worker process as its exit line reported them
    # (17b-17d; a SIGKILLed worker reports nothing, null)
    for k in kernels:
        k["launches_fleet"] = {
            leg: ({w: (None if n is None else n[k["name"]])
                   for w, n in per.items()} if leg != "front" else
                  per[k["name"]])
            for leg, per in launches_fleet.items()}
    # phase 18: each kernel's launches per sharded run (blocks on virtual
    # entries of the one card; the state-sharded distribution loop is
    # plain PyTorch, so the lottery kernel launches only in a rung)
    for k in kernels:
        k["launches_sharding"] = {run: n[k["name"]]
                                  for run, n in launches_shard.items()}
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
