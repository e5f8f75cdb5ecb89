#!/usr/bin/env python
"""How far the JAX package's sidecar-seeded warm sweep lands from its
locked sweep at the paper's width.

    JAX_PLATFORMS=cpu python scripts/sidecar_warm_drift.py

Runs the reference on the CPU in float64: the 12-cell Table II sweep
(N=7, A=32, D=500) locked, writing a scheduler sidecar, then balanced
with ``warm_brackets`` seeded from it, and prints the per-cell r* gap,
the bisection trips, the statuses and the inner work of both.  Same-cell
seeds descend to within 2 r_tol of the prior root, where the excess's
sign is inner-solver noise, so r* moves "up to inner-solver noise"
(the JAX engine's own words); ``chip_smoke.py`` phase 14 reports the
port's gap on the card beside this one.  About two and a half minutes.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from aiyagari_hark_tpu.parallel.sweep import run_table2_sweep
    from aiyagari_hark_tpu.utils.config import SweepConfig

    width = dict(a_count=32, dist_count=500)
    with tempfile.TemporaryDirectory() as tmp:
        base = SweepConfig(sidecar_path=os.path.join(tmp, "side.npz"))
        t0 = time.perf_counter()
        locked = run_table2_sweep(base.replace(schedule="locked"), **width)
        t1 = time.perf_counter()
        warm = run_table2_sweep(base.replace(schedule="balanced",
                                             warm_brackets=True), **width)
        t2 = time.perf_counter()
    dr = warm.r_star_pct - locked.r_star_pct
    print(f"max |dr*| {float(np.abs(dr).max())!r} pct")
    print("dr* pct", dr.tolist())
    print("trips warm", warm.bisect_iters.tolist(), "locked",
          locked.bisect_iters.tolist())
    print("status warm", warm.status.tolist(), "locked",
          locked.status.tolist())
    print("inner work warm", int(warm.total_work().sum()), "locked",
          int(locked.total_work().sum()))
    print(f"JAX on this CPU: locked {t1 - t0:.1f} s, warm {t2 - t1:.1f} s")


if __name__ == "__main__":
    main()
