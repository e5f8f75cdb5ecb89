#!/usr/bin/env python
"""Write the portfolio-economy golden the PyTorch port is held to.

    JAX_PLATFORMS=cpu python scripts/make_torch_portfolio_golden.py

Runs the JAX package on the CPU in float64 at ``build_portfolio_model``'s
default width (N=7, A=48, K=7 return draws, S=25 shares, D=300) with real
return risk (``risky_mean=1.0``, ``risky_std=0.15``, ``labor_ar=0.3``),
CRRA 5, beta 0.96, alpha 0.36, delta 0.08 and a premium of 0.04 (the
configuration of ``tests/test_portfolio.py``'s real-risk equilibrium, at
full width), and writes ``tests/data/torch_portfolio_golden.json``.

``solve_portfolio_equilibrium`` returns no inner step counts, so the
script also replays its bisection with the package's own pieces
(``solve_portfolio_household`` and ``stationary_portfolio_wealth``, each
trip warm-started from the previous midpoint as the solver does, then the
cold re-solve at r*) and records the summed EGM and distribution steps;
it checks that the replay takes the solver's trips and lands on its r*.
The record's ``jax_cpu_seconds`` is the JAX solve's wall on the CPU it ran
on, a second, warm call; ``jax_cpu_first_call_seconds`` is the first
call's, tracing and compilation included.  Neither is the port's.  ``chip_smoke.py`` reads only the JSON.
"""

import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "data", "torch_portfolio_golden.json")

MODEL = dict(risky_mean=1.0, risky_std=0.15, labor_ar=0.3)
SOLVE = dict(disc_fac=0.96, crra=5.0, cap_share=0.36, depr_fac=0.08,
             premium=0.04)


def replay(model, disc_fac, crra, cap_share, depr_fac, premium, prod=1.0,
           max_bisect=40):
    """``solve_portfolio_equilibrium``'s loop, trip by trip, with the
    inner step counts it drops.  Returns (r_star, trips, egm steps, dist
    steps, per-trip records)."""
    import jax
    import jax.numpy as jnp

    from aiyagari_hark_tpu.models import firm
    from aiyagari_hark_tpu.models.household import initial_distribution
    from aiyagari_hark_tpu.models.portfolio import (
        _share_on_dist_grid, initial_portfolio_policy,
        solve_portfolio_household, stationary_portfolio_wealth)

    r_tol, egm_tol, dist_tol = 1e-9, 1e-6, 1e-10
    eps = model.risky_returns / jnp.sum(model.risky_returns
                                        * model.risky_probs)
    labor = jnp.sum(model.labor_stationary * model.labor_levels)
    house = jax.jit(lambda rf, w, m, p: solve_portfolio_household(
        rf, w, m, disc_fac, crra, tol=egm_tol, init_policy=p))
    dist_fn = jax.jit(lambda p, rf, w, m, d: stationary_portfolio_wealth(
        p, rf, w, m, tol=dist_tol, init_dist=d))

    def supply(r, pol0, dist0):
        r_free = 1.0 + r - premium
        m = model._replace(risky_returns=(1.0 + r) * eps)
        k_to_l = firm.k_to_l_from_r(r, cap_share, depr_fac, prod)
        wage = firm.wage_rate(k_to_l, cap_share, prod)
        pol, n_egm, _ = house(r_free, wage, m, pol0)
        dst, n_dist, _, _ = dist_fn(pol, r_free, wage, m, dist0)
        omega = _share_on_dist_grid(pol, m)
        risky = jnp.sum(dst * omega * m.dist_grid[:, None])
        return risky, pol, dst, int(n_egm), int(n_dist), k_to_l

    lo = jnp.asarray(-depr_fac + premium + 1e-3, dtype=jnp.float64)
    hi = jnp.asarray(1.0 / disc_fac - 1.0 - 1e-4, dtype=jnp.float64)
    pol, dst = initial_portfolio_policy(model), initial_distribution(model)
    egm = dist = it = 0
    trips = []
    while float(hi - lo) > r_tol and it < max_bisect:
        mid = 0.5 * (lo + hi)
        risky, pol, dst, n_egm, n_dist, k_to_l = supply(mid, pol, dst)
        ex = risky - k_to_l * labor
        lo = jnp.where(ex > 0, lo, mid)
        hi = jnp.where(ex > 0, mid, hi)
        egm += n_egm
        dist += n_dist
        it += 1
        trips.append(dict(mid=float(mid), excess=float(ex), egm=n_egm,
                          dist=n_dist))
    r_star = 0.5 * (lo + hi)
    _, _, _, n_egm, n_dist, _ = supply(r_star, initial_portfolio_policy(
        model), initial_distribution(model))
    return (float(r_star), it, egm + n_egm, dist + n_dist, trips,
            dict(egm=n_egm, dist=n_dist))


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from aiyagari_hark_tpu.models.portfolio import (
        build_portfolio_model, solve_portfolio_equilibrium)

    model = build_portfolio_model(**MODEL, dtype=jnp.float64)
    solve = jax.jit(lambda: solve_portfolio_equilibrium(model, **SOLVE))
    t0 = time.perf_counter()
    first = float(solve().r_star)          # tracing and compilation too
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eq = solve()                           # warm: the solve alone
    r_star = float(eq.r_star)
    jax_s = time.perf_counter() - t0
    if first != r_star:
        raise SystemExit(f"two calls differ: r*={first!r} then {r_star!r}")
    t0 = time.perf_counter()
    r_rep, trips, egm, dist, per_trip, final = replay(model, **SOLVE)
    replay_s = time.perf_counter() - t0
    if trips != int(eq.bisect_iters) or abs(r_rep - r_star) > 1e-12:
        raise SystemExit(f"the replay took {trips} trips to r*={r_rep!r}; "
                         f"the solver {int(eq.bisect_iters)} to {r_star!r}")
    shape = {k: int(v) for k, v in dict(
        labor_states=model.labor_levels.shape[0],
        a_count=model.a_grid.shape[0],
        risky_count=model.risky_returns.shape[0],
        share_count=model.share_grid.shape[0],
        dist_count=model.dist_grid.shape[0]).items()}
    out = dict(
        config=dict(model=MODEL, solve=SOLVE, width=shape, dtype="float64"),
        r_star=r_star, r_free=float(eq.r_free), wage=float(eq.wage),
        capital=float(eq.capital), total_assets=float(eq.total_assets),
        risky_share_mean=float(eq.risky_share_mean),
        saving_rate=float(eq.saving_rate), excess=float(eq.excess),
        labor=float(eq.labor), bisect_iters=int(eq.bisect_iters),
        egm_iters=egm, dist_iters=dist, final_solve=final, trips=per_trip,
        dist_mass=float(jnp.sum(eq.distribution)),
        share_range=[float(np.min(eq.policy.share)),
                     float(np.max(eq.policy.share))],
        replay_r_star_gap=abs(r_rep - r_star),
        jax_cpu_seconds=jax_s, jax_cpu_first_call_seconds=first_s,
        replay_cpu_seconds=replay_s)
    tmp = f"{OUT}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    os.replace(tmp, OUT)
    print(f"wrote {os.path.relpath(OUT, ROOT)}: r*={r_star!r}, "
          f"{trips} trips, {egm} EGM and {dist} distribution steps, "
          f"{jax_s:.1f} s warm, {first_s:.1f} s with the compilation "
          f"(+{replay_s:.1f} s replay)")


if __name__ == "__main__":
    main()
