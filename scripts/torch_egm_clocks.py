#!/usr/bin/env python3
"""Where a step of the EGM kernel's loop goes: clock64 counters per warp
and phase, on the card.

    python3 scripts/torch_egm_clocks.py

Needs one CUDA card and nvcc.  It copies ``ops/csrc`` into the port's
git-ignored ``ops/_build/probe/``, inserts ``clock64()`` reads around the
phases of ``egm_device.cuh``'s loop (A: the marginal values; the barrier
after them; B: expectation, FOC inversion and knots; the closing max and
barrier), builds ``egm_policy_grid.cu`` from the copy, and runs it in place
of the shipped build: at the fine width (A=1000, N=15, one lane, r=4 %)
in the cluster and the global layout, and at the reference width on the
Table II cell with the most EGM steps (f64 and f32).  Each warp sums its
own cycles over the loop; the JSON line per case gives the mean, least
and largest warp's cycles per step for each phase.  The counters add a
few instructions a phase, so the step they see is a little longer than
the shipped kernel's.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ["A compute", "barrier after A", "B compute", "max and barrier"]
SLOTS = 64 * 16                      # (block, warp) pairs kept


def _instrument(text: str) -> str:
    """The loop of egm_device.cuh with clock64 reads between its phases."""
    def rep(old: str, new: str) -> None:
        nonlocal text
        if old not in text:
            raise RuntimeError(f"egm_device.cuh no longer has {old!r}")
        text = text.replace(old, new, 1)

    rep("namespace ahtt {\n",
        "namespace ahtt {\n__device__ long long egm_clk[%d * 5];\n" % SLOTS)
    rep("  while (diff > tol && step < max_iter && finite) {\n",
        "  long long acc[4] = {0, 0, 0, 0};\n"
        "  while (diff > tol && step < max_iter && finite) {\n"
        "    long long t0 = clock64();\n")
    rep("    if constexpr (kCluster) cg::this_cluster().sync();\n"
        "    else __syncthreads();\n    // (B)",
        "    long long t1 = clock64();\n"
        "    if constexpr (kCluster) cg::this_cluster().sync();\n"
        "    else __syncthreads();\n"
        "    long long t2 = clock64();\n    // (B)")
    rep("    // (C) the sup-norm",
        "    long long t3 = clock64();\n    // (C) the sup-norm")
    rep("    const bool accel = accel_every > 0",
        "    acc[0] += t1 - t0; acc[1] += t2 - t1; acc[2] += t3 - t2;\n"
        "    acc[3] += clock64() - t3;\n"
        "    const bool accel = accel_every > 0")
    rep("  const T* km = it + icert * bs;\n",
        "  {\n"
        "    const int row = blockIdx.x * 16 + (tid >> 5);\n"
        "    if (lane == 0 && row < %d) {\n"
        "      for (int q = 0; q < 4; ++q) egm_clk[row * 5 + q] = acc[q];\n"
        "      egm_clk[row * 5 + 4] = step;\n"
        "    }\n"
        "  }\n"
        "  const T* km = it + icert * bs;\n" % SLOTS)
    return text


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_egm_clocks: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from aiyagari_hark_tpu_torch.models import firm
    from aiyagari_hark_tpu_torch.models import household as H
    from aiyagari_hark_tpu_torch.ops import kernels as K

    src = K.BUILD_DIR / "probe" / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(K._CSRC, src)
    dev_h = src / "egm_device.cuh"
    dev_h.write_text(_instrument(dev_h.read_text()))
    cu = src / K.SOURCES["egm_policy_grid"]
    cu.write_text(cu.read_text() + (
        '\nextern "C" int egm_clk_copy(void* dst) {\n'
        '  return (int)cudaMemcpyFromSymbol(dst, ahtt::egm_clk,\n'
        '                                   sizeof(ahtt::egm_clk));\n}\n'))
    so = src.parent / "egm_clocks.so"
    r = subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-I", str(src), "-o",
                        str(so), str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    K._bind(lib, "egm_policy_grid")
    lib.egm_clk_copy.argtypes = [ctypes.c_void_p]
    lib.egm_clk_copy.restype = ctypes.c_int
    K._LIBS["egm_policy_grid"] = lib
    buf = (ctypes.c_longlong * (SLOTS * 5))()
    card = cs.card_line()

    def clocks(case: str, run, blocks: int, warps: int) -> None:
        run()                                     # warm-up
        run()
        torch.cuda.synchronize()
        if lib.egm_clk_copy(ctypes.addressof(buf)):
            raise RuntimeError("could not read the counters")
        rows = torch.tensor([[buf[(b * 16 + w) * 5 + q] for q in range(5)]
                             for b in range(blocks) for w in range(warps)],
                            dtype=torch.float64)
        steps = int(rows[0, 4])
        per = rows[:, :4] / max(steps, 1)
        print(json.dumps({
            "case": case, "steps": steps, "phases": PHASES,
            "cycles_per_step_mean": per.mean(0).tolist(),
            "cycles_per_step_min": per.min(0).values.tolist(),
            "cycles_per_step_max": per.max(0).values.tolist(),
            "card": card}), flush=True)

    dev = torch.device("cuda")
    dt = torch.float64
    fine = H.stack_models([H.build_simple_model(
        labor_states=15, a_count=1000, dist_count=1000, labor_ar=0.6,
        dtype=dt, device=dev)])
    r = torch.tensor([0.04], dtype=dt, device=dev)
    R, W = 1.0 + r, firm.wage_rate(firm.k_to_l_from_r(r, 0.36, 0.08), 0.36)
    p0 = H.initial_policy(fine)
    args = (p0.m_knots, p0.c_knots, fine.a_grid, fine.labor_levels,
            fine.transition, H._scalars(R, W, fine, 0.96, 3.0), 1e-6)
    blocks = int(lib.egm_policy_grid_cluster_blocks(15))
    clocks("fine, cluster", lambda: K.egm_policy_grid(*args), blocks, 16)
    clocks("fine, global",
           lambda: K.egm_policy_grid(*args, force_global=True), 1, 8)
    for dt in (torch.float64, torch.float32):
        model, R, W, crra = cs.golden_cells(dt, dev)
        q0 = H.initial_policy(model)
        full = (q0.m_knots, q0.c_knots, model.a_grid, model.labor_levels,
                model.transition, H._scalars(R, W, model, 0.96, crra))
        tol = cs.INNER_TOL[dt][0]
        lane = int(K.egm_policy_grid_plain(*full, tol)[2].argmax())
        one = tuple(t[lane:lane + 1] for t in full) + (tol,)
        clocks(f"reference, shared, {dt}, lane {lane}",
               lambda: K.egm_policy_grid(*one), 1, 8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
