#!/usr/bin/env python
"""Write the model-extension goldens the PyTorch port is held to.

    JAX_PLATFORMS=cpu python scripts/make_torch_extensions_golden.py [ITEM ...]

Runs the JAX package on the CPU in float64 at the paper's width (N=7,
A=32, D=500; alpha=0.36, delta=0.08, CRRA=2, beta=0.96 unless an item
names other values) and writes ``tests/data/torch_extensions_golden.json``.
With item names, only those items are run and merged into the existing
file (so items can run in separate processes):

* ``heterogeneity``: J=5 ``uniform_beta_types(0.96, 0.01, 5)``;
* ``fiscal``: ``tax_rate_sweep`` over 8 rates in [0, 0.7] with welfare;
* ``calibrate``: ``calibrate_discount_factor`` to the r* of beta=0.96;
* ``lorenz``: ``calibrate_spread_to_lorenz`` at the JAX test's
  configuration (``tests/test_calibrate.py``: N=4, A=20, D=100, CRRA=1,
  4 types, spread in [0.002, 0.026] to 1.5e-3): at the paper's width one
  5-type equilibrium takes ~140 s here and the fit ~14 of them;
* ``labor``: ``solve_labor_equilibrium`` (Frisch 1, chi 12);
* ``transition``: the steady state, ``solve_transition`` and
  ``sequence_jacobians`` at T=100 under a 1 % TFP shock decaying at 0.8,
  the linear IRF, ``fit_shock_process`` and ``transition_welfare``;
* ``crunch``: ``solve_credit_crunch``, b from -2 to -1.5 over a 24-period
  phase-in, T=100, CRRA=2, at the JAX test's configuration
  (``tests/test_huggett.py``: N=3, A=30, a_max=20, D=120): at the Huggett
  families' width (N=7, A=32, a_max=50, D=500) the tatonnement does not
  converge (4000 iterations, max excess 0.2);
* ``crunch_50``: the same crunch over a 50-period horizon (the same
  24-period phase-in), the depth ``chip_smoke.py`` phase 12 runs it at;
* ``lifecycle``: ``solve_lifecycle`` at R=1.02, W=1, horizon 40.

Each item records its wall on this CPU as ``jax_cpu_seconds``: the JAX
run's time, not the port's.  ``chip_smoke.py`` reads only the JSON.
"""

import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "data", "torch_extensions_golden.json")

BETA, CRRA, ALPHA, DELTA = 0.96, 2.0, 0.36, 0.08
WIDTH = dict(labor_states=7, a_count=32, dist_count=500)
HORIZON = 100
SHOCK = dict(size=0.01, decay=0.8)
TAX_RATES = [0.1 * i for i in range(8)]          # 0, 0.1, ..., 0.7
BETA_TYPES = dict(center=0.96, spread=0.01, n_types=5)
LABOR = dict(frisch=1.0, labor_weight=12.0)
FIT_TRUTH = dict(rho=0.92, sigma=0.011)
JAC_COLUMNS = [0, 1, 5, 10, 25, 50, 99]
CRUNCH = dict(model=dict(labor_states=3, a_count=30, a_max=20.0,
                         dist_count=120), b_loose=-2.0, b_tight=-1.5, phase_in=24, horizon=100)
CRUNCH_50 = dict(CRUNCH, horizon=50)
LORENZ = dict(model=dict(labor_states=4, labor_ar=0.3, labor_sd=0.2,
                         a_count=20, dist_count=100),
              center=0.96, crra=1.0, n_types=4, spread_tol=1.5e-3,
              spread_lo=0.002, spread_hi=0.026)
LIFECYCLE = dict(R=1.02, W=1.0, horizon=40, ages=[0, 10, 20, 30, 39])


def _f(x):
    import numpy as np

    a = np.asarray(x)
    return a.tolist() if a.ndim else float(a)


def _model(**kw):
    import jax.numpy as jnp

    from aiyagari_hark_tpu.models.household import build_simple_model

    return build_simple_model(**{**WIDTH, **kw}, dtype=jnp.float64)


def item_heterogeneity():
    import jax.numpy as jnp

    from aiyagari_hark_tpu.models.heterogeneity import (
        solve_heterogeneous_equilibrium, uniform_beta_types)

    model = _model()
    betas = uniform_beta_types(**BETA_TYPES)
    eq = solve_heterogeneous_equilibrium(model, betas,
                                         jnp.ones_like(betas), CRRA,
                                         ALPHA, DELTA)
    return {"betas": _f(betas), "r_star": _f(eq.r_star),
            "capital": _f(eq.capital), "type_capital": _f(eq.type_capital),
            "wage": _f(eq.wage), "bisect_iters": int(eq.bisect_iters),
            "status": int(eq.status)}


def item_fiscal():
    import jax.numpy as jnp

    from aiyagari_hark_tpu.models.fiscal import tax_rate_sweep

    res = tax_rate_sweep(jnp.asarray(TAX_RATES, jnp.float64), BETA, CRRA,
                         ALPHA, DELTA, with_welfare=True, **WIDTH,
                         dtype=jnp.float64)
    return {"tax_rates": TAX_RATES, "r_star": _f(res.r_star),
            "capital": _f(res.capital), "welfare": _f(res.welfare)}


def item_calibrate():
    from aiyagari_hark_tpu.models.calibrate import calibrate_discount_factor
    from aiyagari_hark_tpu.models.equilibrium import solve_equilibrium_lean

    model = _model()
    target = solve_equilibrium_lean(model, BETA, CRRA, ALPHA, DELTA)
    cal = calibrate_discount_factor(model, target.r_star, CRRA, ALPHA, DELTA)
    return {"target_r": _f(target.r_star),
            "target_bisect_iters": int(target.bisect_iters),
            "beta": _f(cal.value), "achieved": _f(cal.achieved),
            "iterations": int(cal.iterations),
            "converged": bool(cal.converged), "status": int(cal.status)}


def item_lorenz():
    import jax.numpy as jnp

    from aiyagari_hark_tpu.models.calibrate import calibrate_spread_to_lorenz
    from aiyagari_hark_tpu.models.household import build_simple_model

    kw = dict(LORENZ)
    model = build_simple_model(**kw.pop("model"), dtype=jnp.float64)
    fit = calibrate_spread_to_lorenz(model, kw.pop("center"),
                                     kw.pop("crra"), ALPHA, DELTA, **kw)
    return {"spread": fit.spread, "distance": fit.distance,
            "r_star_pct": fit.r_star_pct,
            "distance_homogeneous": fit.distance_homogeneous,
            "evaluations": fit.evaluations}


def item_labor():
    import jax.numpy as jnp

    from aiyagari_hark_tpu.models.labor import (build_labor_model,
                                                solve_labor_equilibrium)

    lm = build_labor_model(**LABOR, **WIDTH, dtype=jnp.float64)
    eq = solve_labor_equilibrium(lm, BETA, CRRA, ALPHA, DELTA)
    return {"r_star": _f(eq.r_star), "capital": _f(eq.capital),
            "effective_labor": _f(eq.effective_labor),
            "mean_hours": _f(eq.mean_hours), "wage": _f(eq.wage),
            "bisect_iters": int(eq.bisect_iters), "status": int(eq.status)}


def item_transition():
    import jax.numpy as jnp
    import numpy as np

    from aiyagari_hark_tpu.models.equilibrium import (
        solve_bisection_equilibrium)
    from aiyagari_hark_tpu.models.jacobian import (business_cycle_moments,
                                                   fit_shock_process,
                                                   linear_impulse_response,
                                                   sequence_jacobians)
    from aiyagari_hark_tpu.models.transition import (solve_transition,
                                                     transition_welfare)

    model = _model()
    t0 = time.perf_counter()
    eq = solve_bisection_equilibrium(model, BETA, CRRA, ALPHA, DELTA)
    ss_s = time.perf_counter() - t0
    dz = SHOCK["size"] * SHOCK["decay"] ** np.arange(HORIZON)
    t0 = time.perf_counter()
    nl = solve_transition(model, BETA, CRRA, ALPHA, DELTA,
                          init_dist=eq.distribution, terminal_policy=eq.policy,
                          k_terminal=eq.capital, horizon=HORIZON,
                          prod_path=1.0 + dz)
    nl.k_path.block_until_ready()
    tr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jac = sequence_jacobians(model, BETA, CRRA, ALPHA, DELTA, eq, HORIZON)
    jac.g_k.block_until_ready()
    jac_s = time.perf_counter() - t0
    lin = linear_impulse_response(jac, jnp.asarray(dz))
    k_ss = float(eq.capital)
    gap = float(np.abs(100.0 * np.asarray(lin.dk) / k_ss
                       - 100.0 * (np.asarray(nl.k_path) / k_ss - 1.0)).max())
    mom = business_cycle_moments(jac, FIT_TRUTH["rho"], FIT_TRUTH["sigma"])
    fit = fit_shock_process(jac, mom.std["y"], mom.autocorr1["y"])
    wel = transition_welfare(model, BETA, CRRA, eq.distribution, eq.policy,
                             nl.r_path, nl.w_path)

    def cols(g):
        return np.asarray(g)[:, JAC_COLUMNS].T.tolist()

    return {
        "steady_state": {"r_star": _f(eq.r_star), "capital": k_ss,
                         "wage": _f(eq.wage),
                         "bisect_iters": int(eq.bisect_iters),
                         "jax_cpu_seconds": ss_s},
        "transition": {"k_path": _f(nl.k_path), "r_path": _f(nl.r_path),
                       "c_agg_path": _f(nl.c_agg_path),
                       "iterations": int(nl.iterations),
                       "max_diff": _f(nl.max_diff),
                       "converged": bool(nl.converged),
                       "jax_cpu_seconds": tr_s},
        "jacobian": {"columns": JAC_COLUMNS, "g_k": cols(jac.g_k),
                     "g_c": cols(jac.g_c), "g_y": cols(jac.g_y),
                     "max_abs": {k: float(np.abs(np.asarray(getattr(jac, k)))
                                          .max())
                                 for k in ("g_k", "g_c", "g_y")},
                     "lin_dk": _f(lin.dk), "lin_dc": _f(lin.dc),
                     "lin_dy": _f(lin.dy), "y_ss": _f(jac.y_ss),
                     "jax_cpu_seconds": jac_s},
        "irf_gap_pp": gap,
        "moments": {"std": {k: float(v) for k, v in mom.std.items()},
                    "autocorr1": {k: float(v)
                                  for k, v in mom.autocorr1.items()}},
        "fit": {"rho": _f(fit.rho), "sigma_eps": _f(fit.sigma_eps),
                "loss": _f(fit.loss), "iterations": int(fit.iterations),
                "converged": bool(fit.converged)},
        "welfare": {"ce": _f(wel.ce), "welfare_path": _f(wel.welfare_path),
                    "welfare_steady": _f(wel.welfare_steady)},
    }


def item_crunch(cfg=CRUNCH):
    import numpy as np

    from aiyagari_hark_tpu.models.huggett import (solve_credit_crunch,
                                                  solve_huggett_equilibrium)

    import jax.numpy as jnp

    from aiyagari_hark_tpu.models.household import build_simple_model

    loose = build_simple_model(**cfg["model"], borrow_limit=cfg["b_loose"],
                               dtype=jnp.float64)
    tight = build_simple_model(**cfg["model"], borrow_limit=cfg["b_tight"],
                               dtype=jnp.float64)
    eq0 = solve_huggett_equilibrium(loose, BETA, CRRA)
    eqT = solve_huggett_equilibrium(tight, BETA, CRRA)
    T = cfg["horizon"]
    phase = np.minimum(np.arange(T) / float(cfg["phase_in"]), 1.0)
    b_path = cfg["b_loose"] + (cfg["b_tight"] - cfg["b_loose"]) * phase
    t0 = time.perf_counter()
    res = solve_credit_crunch(loose, BETA, CRRA, b_path, eq0.distribution,
                              eqT.policy, eq0.r_star, eqT.r_star)
    res.r_path.block_until_ready()
    wall = time.perf_counter() - t0
    return {"r_pre": _f(eq0.r_star), "r_terminal": _f(eqT.r_star),
            "pre_bisect_iters": int(eq0.bisect_iters),
            "terminal_bisect_iters": int(eqT.bisect_iters),
            "r_path": _f(res.r_path), "debt_path": _f(res.debt_path),
            "max_excess": _f(res.max_excess),
            "iterations": int(res.iterations),
            "converged": bool(res.converged), "crunch_jax_cpu_seconds": wall}


def item_crunch_50():
    return item_crunch(CRUNCH_50)


def item_lifecycle():
    import numpy as np

    from aiyagari_hark_tpu.models.lifecycle import solve_lifecycle

    pol = solve_lifecycle(LIFECYCLE["R"], LIFECYCLE["W"], _model(), BETA,
                          CRRA, horizon=LIFECYCLE["horizon"])
    ages = LIFECYCLE["ages"]
    return {"m_knots": np.asarray(pol.m_knots)[ages].tolist(),
            "c_knots": np.asarray(pol.c_knots)[ages].tolist()}


ITEMS = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("item_")}


def main():
    import jax
    import jaxlib
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    names = sys.argv[1:] or list(ITEMS)
    payload = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            payload = json.load(f)
    payload.update({
        "command": "JAX_PLATFORMS=cpu python "
                   "scripts/make_torch_extensions_golden.py [ITEM ...]",
        "versions": {"jax": jax.__version__, "jaxlib": jaxlib.__version__,
                     "numpy": np.__version__,
                     "python": sys.version.split()[0]},
        "config": {"beta": BETA, "crra": CRRA, "alpha": ALPHA,
                   "delta": DELTA, "width": WIDTH, "horizon": HORIZON,
                   "shock": SHOCK, "tax_rates": TAX_RATES,
                   "beta_types": BETA_TYPES, "labor": LABOR,
                   "fit_truth": FIT_TRUTH, "crunch": CRUNCH,
                   "crunch_50": CRUNCH_50, "lorenz": LORENZ,
                   "lifecycle": LIFECYCLE, "dtype": "float64"},
    })
    for name in names:
        print(f"{name} ...", flush=True)
        t0 = time.perf_counter()
        out = ITEMS[name]()
        out["jax_cpu_seconds"] = time.perf_counter() - t0
        print(f"  {out['jax_cpu_seconds']:.1f} s", flush=True)
        # merge under a re-read, so items run in parallel processes keep
        # each other's results
        if os.path.exists(OUT):
            with open(OUT) as f:
                payload = {**json.load(f), **{k: payload[k] for k in
                                              ("command", "versions",
                                               "config")}}
        payload[name] = out
        tmp = f"{OUT}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, OUT)
    print(f"wrote {os.path.relpath(OUT, ROOT)}")


if __name__ == "__main__":
    main()
