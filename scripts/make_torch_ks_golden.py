#!/usr/bin/env python
"""Write the notebook Krusell-Smith golden the PyTorch port is held to.

    JAX_PLATFORMS=cpu python scripts/make_torch_ks_golden.py

Runs the JAX package on the CPU, through its facade as ``reproduce.py``
drives it: the notebook's configuration (cells 16-18: LaborAR=0.3,
LaborSD=0.2, CRRA=1.0, AgentCount=350, act_T=11000, T_discard=1000),
``AiyagariEconomy(seed=1)`` -> ``make_Mrkv_history`` -> ``solve(
sim_method="distribution")`` (the slope-pinned histogram engine,
``dist_count=500``).  Once in float64 and once in float32 (a child
process with x64 off, the JAX accelerator path's dtype, fed the float64
run's chain), and writes ``tests/data/torch_ks_golden.json``:

* the aggregate Markov chain of seed 1 (11 000 states, a string of 0/1);
* per dtype: the outer iterations, the saving rule (intercept, slope) and
  its trajectory, r* and the saving rate (pct, as ``reproduce.py``
  computes them), den Haan's max and mean forecast error (from
  ``T_discard``), the solve's wall on this CPU (the JAX run's, not the
  port's);
* the JAX, jaxlib and numpy versions.

``chip_smoke.py`` reads only the JSON.  About five minutes on the CPU.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "data", "torch_ks_golden.json")
SEED = 1
DIST_COUNT = 500
ECON_UPDATES = dict(LaborAR=0.3, LaborSD=0.2, CRRA=1.0, verbose=False)
AGENT_UPDATES = dict(AgentCount=350)


def _solve(chain=None) -> dict:
    """One pinned-histogram solve in the process's default dtype."""
    import numpy as np

    from aiyagari_hark_tpu import (AiyagariEconomy, AiyagariType,
                                   init_aiyagari_agents,
                                   init_aiyagari_economy)
    from aiyagari_hark_tpu.models.diagnostics import den_haan_forecast

    econ_dict = init_aiyagari_economy()
    econ_dict.update(ECON_UPDATES)
    agent_dict = init_aiyagari_agents()
    agent_dict.update(AGENT_UPDATES)
    economy = AiyagariEconomy(seed=SEED, **econ_dict)
    agent = AiyagariType(**agent_dict)
    agent.cycles = 0
    agent.get_economy_data(economy)
    economy.agents = [agent]
    economy.make_Mrkv_history()
    if chain is not None:
        economy.MrkvNow_hist = np.asarray(chain, dtype=np.int64)
    t0 = time.perf_counter()
    sol = economy.solve(sim_method="distribution", dist_count=DIST_COUNT)
    wall = time.perf_counter() - t0
    depr = econ_dict["DeprFac"]
    a_mean = float(np.average(economy.reap_state["aNowGrid"][0],
                              weights=economy.reap_state["aNowWeights"][0]))
    dh = den_haan_forecast(sol, t_start=econ_dict["T_discard"])
    return {
        "chain": "".join(str(int(z)) for z in economy.MrkvNow_hist),
        "dtype": str(np.asarray(sol.afunc.intercept).dtype),
        "converged": bool(sol.converged),
        "outer_iterations": len(sol.records),
        "afunc_intercept": [float(x) for x in np.asarray(sol.afunc.intercept)],
        "afunc_slope": [float(x) for x in np.asarray(sol.afunc.slope)],
        "intercept_trajectory": [r.intercept[0] for r in sol.records],
        "r_star_pct": (economy.sow_state["Rnow"] - 1.0) * 100.0,
        "saving_rate_pct": 100.0 * depr * a_mean / (
            economy.sow_state["Mnow"] - (1.0 - depr) * a_mean),
        "den_haan_max_error_pct": float(dh.max_error_pct),
        "den_haan_mean_error_pct": float(dh.mean_error_pct),
        "A_prev_last": float(sol.history.A_prev[-1]),
        "jax_cpu_solve_seconds": wall,
    }


def _child_f32(chain_path: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    with open(chain_path) as f:
        chain = [int(c) for c in f.read().strip()]
    print(json.dumps(_solve(chain)))


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--f32-child":
        _child_f32(sys.argv[2])
        return
    import tempfile

    import jax
    import jaxlib
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    print("float64 solve", flush=True)
    f64 = _solve()
    chain = f64.pop("chain")
    print(f"  {f64['outer_iterations']} outer iterations, r* "
          f"{f64['r_star_pct']:.9f} pct", flush=True)
    print("float32 solve (child process, x64 off)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "chain.txt")
        with open(path, "w") as f:
            f.write(chain)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--f32-child", path],
            capture_output=True, text=True, check=True)
    f32 = json.loads(out.stdout.strip().splitlines()[-1])
    if f32.pop("chain") != chain:
        raise AssertionError("the float32 run did not take the float64 chain")
    print(f"  {f32['outer_iterations']} outer iterations, r* "
          f"{f32['r_star_pct']:.9f} pct", flush=True)
    payload = {
        "command": "JAX_PLATFORMS=cpu python scripts/make_torch_ks_golden.py",
        "versions": {"jax": jax.__version__, "jaxlib": jaxlib.__version__,
                     "numpy": np.__version__,
                     "python": sys.version.split()[0]},
        "config": {"seed": SEED, "sim_method": "distribution",
                   "dist_count": DIST_COUNT, "economy": ECON_UPDATES,
                   "agent": AGENT_UPDATES, "act_T": len(chain),
                   "T_discard": 1000},
        "mrkv_hist": chain,
        "float64": f64,
        "float32": f32,
    }
    with open(OUT, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {os.path.relpath(OUT, ROOT)}")


if __name__ == "__main__":
    main()
