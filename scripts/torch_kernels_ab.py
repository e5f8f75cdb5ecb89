#!/usr/bin/env python3
"""Parent against change: the kernels' times of ``chip_smoke.py`` phase 2
(Table II width) and of the fused kernel at the fine width, two trees on
one card.

    git archive <parent> | tar -x -C scratch_chip/parent
    python3 scripts/torch_kernels_ab.py scratch_chip/parent

Needs one CUDA card and nvcc.  Each tree (the parent given as the
argument, the change this script sits in) runs in its own process, in
the order parent, change, change, parent: it builds its kernels (the
seconds are printed), then runs its own ``chip_smoke.phase_kernels``
(each kernel at N=7, A=32, D=500, C=12, float64 and float32, in its
default layout and its global one, timed with CUDA events) and
``chip_smoke.fine_fused_check`` (the fused kernel at A=1000, N=15,
D=1000, C=1, against the reference kernels' chain in turns where the
tree's check times it), then, with its own package, the tailed lanes of
the fine compact grid (A=851, N=15, D=926, r = 4 %, C=1, float64 and
float32): the EGM kernel's tail mode and the fused kernel with the tail,
each in the layout the tree chooses, timed with CUDA events, with its
steps and a digest of its outputs.  Prints each tree's kernel
milliseconds and, last, one JSON line with all of them, whether each
fine tailed lane's outputs are the same bits in every run (parent and
change), and the card's name and power limit.

    python3 scripts/torch_kernels_ab.py scratch_chip/parent split

runs instead, in the same order, the distribution kernels on five lanes
at r = 4.15 % (the savings policy from the EGM kernel): Table II's
(crra 1, rho 0) and (crra 5, rho 0.9), float64; the fine width's
(crra 1, rho 0) in float64 and in float32; and (crra 1, rho 0) at N=17,
A=32, D=500, float64 (the bound 32).  ``stationary_lottery_grid`` and
``fused_cell_grid`` run in every layout each lane can take, each forced
through the tree's own layout choice (Table II: shared,
shared_best_in_output, cluster, global; the fine width: cluster, global;
N=17: cluster, global, and global alone for the fused kernel, which has
no cluster past 16 states).  Per run: the outputs' digest, the steps,
the milliseconds of a launch (CUDA events, the median of three), the
microseconds of a distribution step, and, from the lane's CSR on the
host, the segments over the cluster split's degree and the share of
entries a cluster block lists (the rule of ``lottery_split_build``,
with this tree's ``LOTTERY_SPLIT_*``).  The last line says whether each
(lane, kernel) gives the same bits in every layout and every run,
parent and change.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHANGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = r'''
import contextlib, io, json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from aiyagari_hark_tpu_torch.ops import kernels as K
cs.CARD = cs.card_line()
build_s = K.build_libraries()
dev = torch.device("cuda")
with contextlib.redirect_stdout(io.StringIO()):
    recs = cs.phase_kernels(dev)
    fused = cs.fine_fused_check(dev)
out = {"build_s": build_s}
for name, rs in recs.items():
    for r in rs:
        tag = r.get("grid", "reference") + (
            "/" + r["ladder_phase"] if "ladder_phase" in r else "")
        out[f"{name}/{r['dtype'].rsplit('.', 1)[-1]}/{tag}"] = dict(
            ms=r["kernel_ms"], global_ms=r.get("global_ms"),
            layout=r.get("layout", "shared"))
for f in fused if isinstance(fused, list) else [fused]:   # one, before
    out[f"fine_fused/{f['dtype'].rsplit('.', 1)[-1]}"] = dict(
        ms=f["kernel_ms"], global_ms=f.get("global_ms"),
        chain_ms=f.get("chain_ms"), layout=f["layout"])
import hashlib
from aiyagari_hark_tpu_torch.models import firm
from aiyagari_hark_tpu_torch.models import household as H
from aiyagari_hark_tpu_torch.utils.config import fine_grid_kwargs
for dt in (torch.float64, torch.float32):
    kw = fine_grid_kwargs()
    crra = kw.pop("crra")
    model = H.stack_models([H.build_simple_model(dtype=dt, device=dev,
                                                 grid="compact", **kw)])
    r = torch.tensor([0.04], dtype=dt, device=dev)
    R, W = 1.0 + r, firm.wage_rate(firm.k_to_l_from_r(r, 0.36, 0.08), 0.36)
    sc = H._scalars(R, W, model, 0.96, crra)
    h = H.perfect_foresight_human_wealth(R, W, model.labor_levels,
                                         model.transition)
    p0 = H.initial_policy(model, analytic_tail=True)
    d0 = H.initial_distribution(model)
    egm_tol, dist_tol = cs.INNER_TOL[dt]
    N, A, D = (model.labor_levels.shape[1], model.a_grid.shape[1],
               model.dist_grid.shape[1])
    runs = {
        "egm": (lambda: K.egm_policy_grid(
            p0.m_knots, p0.c_knots, model.a_grid, model.labor_levels,
            model.transition, sc, egm_tol, h=h, tail=True),
            K.egm_policy_grid_layout(N, A, dt, tail=True), (2,)),
        "fused": (lambda: K.fused_cell_grid(
            p0.m_knots, p0.c_knots, model.a_grid, model.dist_grid,
            model.labor_levels, model.transition, sc, h, d0, egm_tol,
            dist_tol=dist_tol, tail=True),
            K.fused_cell_grid_layout(N, A, D, True, dt), (3, 5))}
    for name, (fn, layout, it) in runs.items():
        res = fn()
        digest = hashlib.sha256(b"".join(
            t.cpu().contiguous().numpy().tobytes() for t in res)).hexdigest()
        out[f"fine_tail_{name}/{str(dt).rsplit('.', 1)[-1]}"] = dict(
            ms=cs.cuda_ms(fn, reps=3), layout=layout, N=N, A=A, D=D,
            steps=[int(res[i][0]) for i in it], digest=digest[:16])
print("TIMES", json.dumps(out), flush=True)
'''

SPLIT = r'''
import hashlib, json, statistics, sys, torch
sys.path.insert(0, ".")
from aiyagari_hark_tpu_torch.models import firm
from aiyagari_hark_tpu_torch.models import household as H
from aiyagari_hark_tpu_torch.ops import kernels as K
dev = torch.device("cuda")
f64, f32 = torch.float64, torch.float32
build_s = K.build_libraries(("egm_policy_grid", "stationary_lottery_grid",
                             "fused_cell_grid", "stationary_lottery_grid_wide",
                             "fused_cell_grid_wide"))
# lane: (N, A, D, crra, rho, dtype, stationary layouts, fused layouts)
LANES = {"table2_1_0": (7, 32, 500, 1.0, 0.0, f64, (2, 1, 3, 0),
                        (2, 1, 3, 0)),
         "table2_5_09": (7, 32, 500, 5.0, 0.9, f64, (2, 1, 3, 0),
                         (2, 1, 3, 0)),
         "fine_1_0": (15, 1000, 1000, 1.0, 0.0, f64, (3, 0), (3, 0)),
         "fine_1_0_f32": (15, 1000, 1000, 1.0, 0.0, f32, (3, 0), (3, 0)),
         "n17_1_0": (17, 32, 500, 1.0, 0.0, f64, (3, 0), (0,))}
out = {"build_s": build_s}
for D, N, f in ((500, 7, 1), (1000, 15, 1), (1000, 15, 0)):
    lib = K._lottery_library("stationary_lottery_grid", N)
    nb = K.lottery_state_bound(N)
    out[f"bytes/{D}/{N}/{8 if f else 4}"] = [
        int(lib.stationary_lottery_grid_shared_bytes(D, N, nb, f, 1)),
        int(lib.stationary_lottery_grid_shared_bytes(D, N, nb, f, 0)),
        int(lib.stationary_lottery_grid_cluster_bytes(D, N, nb, f, 0)),
        K.stationary_lottery_grid_layout(D, N, f64 if f else f32)]


def split_share(start, D, N):
    # a cluster block's list, as lottery_split_build makes it: each block
    # of ceil(D/8) rows, its segments over the degree in thread order
    # (row, thread h of its 4, state n = h + 4q), listed while both caps
    # hold
    deg = (start[:, 1:] - start[:, :-1]).cpu().tolist()   # [N, D]
    limits = getattr(K, "LOTTERY_SPLIT_DEGREE", None)
    if limits is None:
        return None
    H0, S0, E0 = (K.LOTTERY_SPLIT_DEGREE, K.LOTTERY_SPLIT_SEGMENTS,
                  K.LOTTERY_SPLIT_ENTRIES)
    R = -(-D // 8)
    rec = dict(long_segments=0, long_entries=0, listed_segments=0,
               listed_entries=0, entries=2 * D * N)
    for r0 in range(0, D, R):
        s = e = 0
        full = False
        for r in range(r0, min(r0 + R, D)):
            for h in range(4):
                for n in range(h, N, 4):
                    d = deg[n][r]
                    if d <= H0:
                        continue
                    rec["long_segments"] += 1
                    rec["long_entries"] += d
                    if not full and s < S0 and e + d <= E0:
                        s += 1
                        e += d
                    else:
                        full = True
        rec["listed_segments"] += s
        rec["listed_entries"] += e
    rec["listed_share_pct"] = 100.0 * rec["listed_entries"] / rec["entries"]
    return rec


def forced(layout, stage):
    return lambda *a: (layout, stage)


def timed(fn):
    ms = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return statistics.median(ms)


def digest(res):
    return hashlib.sha256(b"".join(
        t.cpu().contiguous().numpy().tobytes() for t in res)).hexdigest()[:16]


for lane, (N, A, D, crra, rho, dt, st_layouts, fu_layouts) in LANES.items():
    model = H.stack_models([H.build_simple_model(
        labor_states=N, labor_ar=rho, a_count=A, dist_count=D, dtype=dt,
        device=dev)])
    r = torch.tensor([0.0415], dtype=dt, device=dev)
    R, W = 1.0 + r, firm.wage_rate(firm.k_to_l_from_r(r, 0.36, 0.08), 0.36)
    cr = torch.tensor([crra], dtype=dt, device=dev)
    pol = H.solve_household(R, W, model, 0.96, cr)[0]
    tr = H.wealth_transition(pol, R, W, model)
    d0 = H.initial_distribution(model)
    p0 = H.initial_policy(model)
    sc = H._scalars(R, W, model, 0.96, cr)
    h0 = torch.zeros_like(model.labor_levels)
    nb = K.lottery_state_bound(N)
    size = 8 if dt == f64 else 4
    out[f"{lane}/split_share"] = split_share(
        K.lottery_csr(tr.idx, tr.weight)[0][0], D, N)
    slib = K._lottery_library("stationary_lottery_grid", N)
    flib = K._lottery_library("fused_cell_grid", N)
    st_stage = K._lottery_cluster_cut(slib, D, N, dt)[1]
    fu_stage = (K._lottery_stage(int(
        flib.fused_cell_grid_cluster_lottery_bytes(N, D, nb, int(size == 8))),
        D, N, size) if 3 in fu_layouts else 0)
    tol = 1e-11 if dt == f64 else 1e-6
    kernels = {
        "stationary": ("_stationary_layout", st_stage, 1, st_layouts,
                       lambda: K.stationary_lottery_grid(
                           tr.idx, tr.weight, model.transition, d0, tol)),
        "fused": ("_fused_layout", fu_stage, 5, fu_layouts,
                  lambda: K.fused_cell_grid(
                      p0.m_knots, p0.c_knots, model.a_grid, model.dist_grid,
                      model.labor_levels, model.transition, sc, h0, d0,
                      1e-6 if dt == f64 else 1e-5, dist_tol=tol))}
    for kname, (chooser, stage, it_at, layouts, fn) in kernels.items():
        original = getattr(K, chooser)
        for layout in layouts:
            setattr(K, chooser, forced(layout, stage if layout == 3 else 0))
            try:
                res = fn()
                torch.cuda.synchronize()
                rec = dict(digest=digest(res), steps=int(res[it_at][0]))
                rec["ms"] = timed(fn)
                rec["us_per_step"] = rec["ms"] * 1e3 / max(rec["steps"], 1)
            finally:
                setattr(K, chooser, original)
            out[f"{lane}/{kname}/{K.LAYOUTS[layout]}"] = rec
print("SPLIT", json.dumps(out), flush=True)
'''


def main() -> int:
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in ([], ["split"]):
        print(__doc__)
        return 2
    split = sys.argv[2:] == ["split"]
    code, tag = (SPLIT, "SPLIT ") if split else (CHILD, "TIMES ")
    trees = {"parent": os.path.abspath(sys.argv[1]), "change": CHANGE}
    res = []
    for name in ("parent", "change", "change", "parent"):
        r = subprocess.run([sys.executable, "-c", code], cwd=trees[name],
                           capture_output=True, text=True, timeout=900)
        line = [x for x in r.stdout.splitlines() if x.startswith(tag)]
        if r.returncode or not line:
            print(name, "failed", r.returncode, r.stdout[-2000:],
                  r.stderr[-3000:])
            return 1
        res.append((name, json.loads(line[0][len(tag):])))
        print(name, json.dumps(res[-1][1]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if split:
        lanes = {k.rsplit("/", 1)[0] for k in res[0][1]
                 if k.count("/") == 2 and not k.startswith("bytes/")}
        # the share is the tree's rule on the same CSR: the change's alone
        shares = {k: v for k, v in res[1][1].items()
                  if k.endswith("/split_share")}
        same = {lane: len({r[k]["digest"] for _, r in res for k in r
                           if k.rsplit("/", 1)[0] == lane}) == 1
                for lane in sorted(lanes)}
        print(json.dumps({"runs": res, "same_bits": same,
                          "split_share": shares, "card": card}))
        return 0
    same = {k: len({r[k]["digest"] for _, r in res}) == 1
            for k in res[0][1] if k.startswith("fine_tail_")}
    print(json.dumps({"runs": res, "fine_tail_same_bits": same,
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
