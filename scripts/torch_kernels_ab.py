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


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__)
        return 2
    trees = {"parent": os.path.abspath(sys.argv[1]), "change": CHANGE}
    res = []
    for name in ("parent", "change", "change", "parent"):
        r = subprocess.run([sys.executable, "-c", CHILD], cwd=trees[name],
                           capture_output=True, text=True, timeout=900)
        line = [x for x in r.stdout.splitlines() if x.startswith("TIMES ")]
        if r.returncode or not line:
            print(name, "failed", r.returncode, r.stdout[-2000:],
                  r.stderr[-3000:])
            return 1
        res.append((name, json.loads(line[0][len("TIMES "):])))
        print(name, json.dumps(res[-1][1]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    same = {k: len({r[k]["digest"] for _, r in res}) == 1
            for k in res[0][1] if k.startswith("fine_tail_")}
    print(json.dumps({"runs": res, "fine_tail_same_bits": same,
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
