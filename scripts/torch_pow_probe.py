#!/usr/bin/env python3
"""Why a CUDA kernel's f64 pow can leave torch.pow: libdevice pow built
without and with contraction, on the card.

    python3 scripts/torch_pow_probe.py

Needs one CUDA card and nvcc (it builds two small libraries and one
variant of the EGM kernel into the port's git-ignored ``ops/_build/``).
For f64 and f32 it records every pow input of the plain EGM fixed point
(``egm_policy_grid_plain``) on the 12 Table II cells at the golden r*,
reference width, on the card; it evaluates libdevice pow on them in a
kernel built with ``--fmad=false`` and one built with ``--fmad=true`` and
counts the results that differ from ``torch.pow``.  It then builds
``egm_policy_grid.cu`` with ``--fmad=false`` and reports how far that
build lands from the plain version (lanes, max abs error, the first step
count at which a lane differs), beside the kernel as the port builds it.
Prints one JSON line per dtype.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

POW_SRC = r"""
#include <cuda_runtime.h>
#include <math.h>
template <typename T>
__global__ void pow_kernel(const T* x, const T* y, T* o, long n) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i < n) o[i] = pow(x[i], y[i]);
}
extern "C" int run_pow(const void* x, const void* y, void* o, long n,
                       int f64) {
  const unsigned g = (unsigned)((n + 255) / 256);
  if (f64)
    pow_kernel<double><<<g, 256>>>((const double*)x, (const double*)y,
                                   (double*)o, n);
  else
    pow_kernel<float><<<g, 256>>>((const float*)x, (const float*)y,
                                  (float*)o, n);
  return (int)cudaGetLastError();
}
"""


def _build(K, src: str, name: str, fmad: str):
    out = K.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    flags = [f for f in K.NVCC_FLAGS if not f.startswith("--fmad")]
    so = out / f"{name}-fmad-{fmad}.so"
    r = subprocess.run([K._nvcc(), *flags, f"--fmad={fmad}", "-I",
                        str(K._CSRC), "-o", str(so), src],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(so))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_pow_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from aiyagari_hark_tpu_torch.models import household as H
    from aiyagari_hark_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    src = K.BUILD_DIR / "probe" / "pow_probe.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(POW_SRC)
    pows = {}
    for fmad in ("false", "true"):
        lib = _build(K, str(src), "pow_probe", fmad)
        lib.run_pow.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long,
                                                        ctypes.c_int]
        lib.run_pow.restype = ctypes.c_int
        pows[fmad] = lib
    K.build_libraries(("egm_policy_grid",))
    shipped = K._LIBS["egm_policy_grid"]
    nofma = _build(K, str(K._CSRC / K.SOURCES["egm_policy_grid"]),
                   "egm_policy_grid", "false")
    K._bind(nofma, "egm_policy_grid")
    card = cs.card_line()

    for dt in (torch.float64, torch.float32):
        model, R, W, crra = cs.golden_cells(dt, dev)
        p0 = H.initial_policy(model)
        args = (p0.m_knots, p0.c_knots, model.a_grid, model.labor_levels,
                model.transition, H._scalars(R, W, model, 0.96, crra))
        tol = cs.INNER_TOL[dt][0]
        seen = []
        mu, imu = K.marginal_utility, K.inverse_marginal_utility

        def record_mu(c, g):
            seen.append((c.flatten(), (-g).expand_as(c).flatten()))
            return mu(c, g)

        def record_imu(v, g):
            seen.append((v.flatten(), (-1.0 / g).expand_as(v).flatten()))
            return imu(v, g)

        K.marginal_utility, K.inverse_marginal_utility = record_mu, record_imu
        try:
            plain = K.egm_policy_grid_plain(*args, tol)
        finally:
            K.marginal_utility, K.inverse_marginal_utility = mu, imu
        x = torch.cat([s[0] for s in seen])
        y = torch.cat([s[1] for s in seen])
        ref = torch.pow(x, y)
        rec = {"dtype": str(dt), "pow_inputs": int(x.numel())}
        for fmad, lib in pows.items():
            o = torch.empty_like(x)
            rc = lib.run_pow(x.data_ptr(), y.data_ptr(), o.data_ptr(),
                             x.numel(), int(dt == torch.float64))
            if rc:
                raise RuntimeError(f"pow kernel failed with CUDA error {rc}")
            torch.cuda.synchronize()
            rec[f"pow_differs_fmad_{fmad}"] = int((o != ref).sum())
        for label, lib in (("fmad_false", nofma), ("shipped", shipped)):
            K._LIBS["egm_policy_grid"] = lib
            out = K.egm_policy_grid(*args, tol)
            diff = max(float((a - b).abs().max())
                       for a, b in zip(out[:2], plain[:2]))
            lanes = [c for c in range(out[0].shape[0])
                     if not (torch.equal(out[0][c], plain[0][c])
                             and torch.equal(out[1][c], plain[1][c]))]
            first = None
            if lanes:
                for k in range(1, int(plain[2].max()) + 1):
                    a = K.egm_policy_grid(*args, tol, k)
                    b = K.egm_policy_grid_plain(*args, tol, k)
                    if not all(torch.equal(u, v)
                               for u, v in zip(a[:2], b[:2])):
                        first = k
                        break
            rec[f"kernel_{label}"] = {
                "max_abs_err": diff, "lanes_differ": lanes,
                "iters_equal": bool(torch.equal(out[2], plain[2])),
                "first_step_that_differs": first}
        K._LIBS["egm_policy_grid"] = shipped
        rec["card"] = card
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
