#!/usr/bin/env python
"""Write the fine-configuration golden the PyTorch port is held to.

    JAX_PLATFORMS=cpu python scripts/make_torch_fine_golden.py

Runs the JAX package's ``solve_calibration_lean`` on the CPU at
``utils.config.fine_grid_kwargs()`` (BASELINE.json config 2: 1000 assets,
15 labor states, 1000 wealth points; CRRA 3, rho 0.6) in float64 and in
float32, then the four cells of ``bench.py``'s ``_timed_fine_lanes``
(CRRA 1, rho 0, 0.3, 0.6, 0.9 at the same width), each solved alone, in
float64.  Then BASELINE.json config 1 (``utils.config.
baseline_cell_kwargs()``: CRRA 3, rho 0.6, 7 labor states, 100 assets, 500
wealth points) in float64 and float32, and the many-state cells (CRRA 3,
rho 0.6, 32 assets, 500 wealth points) at 17, 21 and 40 labor states in
float64 and at 17 in float32.  Last, the fine cell on the compact grids
(``grid="compact"`` and ``"adaptive"``: every policy closed by the analytic
tail, the coarse-to-fine ladder under the reference kernels): compact in
float64 and float32 and adaptive in float64 under ``kernel="reference"``,
compact in float64 under ``kernel="fused"``, each record also holding its
descent and polish steps and the grid's solver and wealth points.  Writes
``tests/data/torch_fine_golden.json``: for each cell and dtype r*,
capital, labor, bisection trips, summed EGM and distribution steps and
the status code.

Each record's ``jax_cpu_seconds`` is the JAX solve's wall on the CPU it
ran on, a second, warm call; neither it nor anything else here is the
port's.  ``tests/test_torch_fine.py`` and ``chip_smoke.py`` read only the
JSON.
"""

import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "data", "torch_fine_golden.json")

LANE_CRRA = 1.0
LANE_RHOS = (0.0, 0.3, 0.6, 0.9)
# the many-state cells: (labor states, dtypes) at MANY_WIDTH
MANY_STATES = ((17, ("float64", "float32")), (21, ("float64",)),
               (40, ("float64",)))
MANY_CELL = dict(crra=3.0, labor_ar=0.6)
MANY_WIDTH = dict(a_count=32, dist_count=500)
# the fine cell on the compact grids: (grid, kernel, dtype), each a record
# of out["grids"][grid] keyed by dtype, "fused_" before it under the fused
# kernel
GRID_RUNS = (("compact", "reference", "float64"),
             ("compact", "reference", "float32"),
             ("adaptive", "reference", "float64"),
             ("compact", "fused", "float64"))


def solve(crra, rho, dtype, width, steps=False, **kw):
    """One cell, jitted as the JAX suite runs it; returns (record,
    warm seconds).  ``steps`` adds the descent and polish steps; ``kw``
    goes to the solver (``grid``, ``kernel``)."""
    import jax

    from aiyagari_hark_tpu.models.equilibrium import solve_calibration_lean
    from aiyagari_hark_tpu.solver_health import status_name

    fn = jax.jit(lambda c, r: solve_calibration_lean(c, r, dtype=dtype,
                                                     **width, **kw))
    jax.block_until_ready(fn(crra, rho))       # tracing and compilation
    t0 = time.perf_counter()
    res = jax.block_until_ready(fn(crra, rho))
    seconds = time.perf_counter() - t0
    r_star = float(res.r_star)
    rec = dict(crra=crra, labor_ar=rho, r_star=r_star,
               r_star_pct=100.0 * r_star, capital=float(res.capital),
               labor=float(res.labor), bisect_iters=int(res.bisect_iters),
               egm_iters=int(res.egm_iters), dist_iters=int(res.dist_iters),
               status=int(res.status),
               status_name=status_name(int(res.status)))
    if steps:
        rec.update(descent_steps=int(res.descent_steps),
                   polish_steps=int(res.polish_steps))
    rec["jax_cpu_seconds"] = seconds
    return rec, seconds


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from aiyagari_hark_tpu.utils.config import (baseline_cell_kwargs,
                                                fine_grid_kwargs)

    dtypes = {"float64": jnp.float64, "float32": jnp.float32}
    kw = fine_grid_kwargs()
    crra, rho = kw.pop("crra"), kw.pop("labor_ar")
    out = dict(width=kw, fine={}, lanes=[])
    for name, dt in dtypes.items():
        rec, s = solve(crra, rho, dt, kw)
        out["fine"][name] = rec
        print(f"fine {name}: r*={rec['r_star_pct']!r} pct, "
              f"{rec['bisect_iters']} trips, {rec['egm_iters']} EGM and "
              f"{rec['dist_iters']} distribution steps, {s:.1f} s")
    for r in LANE_RHOS:
        rec, s = solve(LANE_CRRA, r, jnp.float64, kw)
        out["lanes"].append(rec)
        print(f"lane rho={r}: r*={rec['r_star_pct']!r} pct, "
              f"{rec['bisect_iters']} trips, {s:.1f} s")
    base = baseline_cell_kwargs()
    bcrra, brho = base.pop("crra"), base.pop("labor_ar")
    out["baseline"] = dict(width=base)
    for name, dt in dtypes.items():
        rec, s = solve(bcrra, brho, dt, base)
        out["baseline"][name] = rec
        print(f"baseline {name}: r*={rec['r_star_pct']!r} pct, "
              f"{rec['bisect_iters']} trips, {s:.1f} s")
    out["many_states"] = []
    for n, names in MANY_STATES:
        width = dict(labor_states=n, **MANY_WIDTH)
        for name in names:
            rec, s = solve(MANY_CELL["crra"], MANY_CELL["labor_ar"],
                           dtypes[name], width)
            out["many_states"].append(dict(dtype=name, **width, **rec))
            print(f"N={n} {name}: r*={rec['r_star_pct']!r} pct, "
                  f"{rec['bisect_iters']} trips, {rec['egm_iters']} EGM "
                  f"and {rec['dist_iters']} distribution steps, {s:.1f} s")
    from aiyagari_hark_tpu.ops.grids import grid_point_counts

    out["grids"] = {}
    for grid, kernel, name in GRID_RUNS:
        a_pts, d_pts = grid_point_counts(grid, kw["a_count"],
                                         kw["dist_count"])
        rec, s = solve(crra, rho, dtypes[name], kw, steps=True, grid=grid,
                       kernel=kernel)
        key = name if kernel == "reference" else f"{kernel}_{name}"
        g = out["grids"].setdefault(grid, dict(a_points=a_pts,
                                               dist_points=d_pts))
        g[key] = dict(kernel=kernel, **rec)
        print(f"{grid} {kernel} {name} (A={a_pts}, D={d_pts}): "
              f"r*={rec['r_star_pct']!r} pct, {rec['bisect_iters']} trips, "
              f"{rec['egm_iters']} EGM and {rec['dist_iters']} distribution "
              f"steps, descent {rec['descent_steps']}, polish "
              f"{rec['polish_steps']}, {s:.1f} s")
    tmp = f"{OUT}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    os.replace(tmp, OUT)
    print(f"wrote {os.path.relpath(OUT, ROOT)}")


if __name__ == "__main__":
    main()
