#!/usr/bin/env python
"""The notebook's pipeline on the PyTorch port (``aiyagari_hark_tpu_torch``),
on the CUDA card unless given ``--device cpu``.

    build economy + agent  ->  make_Mrkv_history  ->  solve (panel)
    -> equilibrium return and saving rate               (cells 19-20)
    -> den Haan forecast error, and beside it the pinned-histogram
       engine's (a second solve)
    -> consumption functions, aggregate saving rule     (cells 21-22)
    -> simulated wealth statistics                       (cell 24)
    -> Lorenz curve against the SCF, Euclidean distance  (cells 25-27)
    -> results.json, runtime.txt (phase breakdown)       (cell 30)

Everything is written under ``--output-dir`` (default
``reproduce_torch_out/``, figures in its ``Figures/``); the repository's
``Figures/``, ``results.json`` and ``runtime.txt`` belong to the JAX
package's ``reproduce.py`` and are never touched.  Figures are drawn only
when matplotlib imports; otherwise the run says so and goes on (plotting
is not the device path).  ``--extras`` adds the general-equilibrium
impulse response to a 1 % TFP shock decaying at 0.8 (``reproduce.py
--extras``'s: the nonlinear MIT-shock path of ``models.transition``
against the linear response of ``models.jacobian``, on the notebook's
calibration at illustration-size grids), under ``extras.irf`` in
results.json and as ``Figures/impulse_response.*``, and the
histogram-engine readout (``reproduce.py --extras``'s: the pinned
histogram engine's r*, wealth statistics and Lorenz distance, under
``extras.histogram_engine``; the den Haan side-by-side's solve is
reused, so the engine is solved once a run).

Usage:
    python reproduce_torch.py                      # the notebook run, card, f64
    python reproduce_torch.py --device cpu --quick # small smoke on the CPU
    python reproduce_torch.py --dtype float32      # the accelerator dtype
    python reproduce_torch.py --extras             # plus the impulse response
"""

from __future__ import annotations

import argparse
import os
import sys
import time

DEFAULT_OUT = "reproduce_torch_out"
REFERENCE_GOLDENS = {"r_pct": 4.178, "saving_rate_pct": 23.649,
                     "lorenz_vs_scf": 0.9714, "solve_minutes": 27.12}


def make_figs(fig, name: str, figures_dir: str) -> list:
    """Write ``fig`` as png/jpg/pdf/svg under ``figures_dir`` (the
    reference's ``make_figs`` contract), with the date metadata stripped
    and a fixed svg salt so reruns give the same bytes."""
    import matplotlib

    os.makedirs(figures_dir, exist_ok=True)
    paths = []
    for ext in ("png", "jpg", "pdf", "svg"):
        p = os.path.join(figures_dir, f"{name}.{ext}")
        metadata = {"pdf": {"CreationDate": None, "ModDate": None},
                    "svg": {"Date": None}}.get(ext)
        with matplotlib.rc_context({"svg.hashsalt": "aiyagari-hark-tpu"}):
            fig.savefig(p, metadata=metadata)
        paths.append(p)
    return paths


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None when it does not
    import."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def _economy(args, econ_dict, agent_dict):
    from aiyagari_hark_tpu_torch import AiyagariEconomy, AiyagariType

    economy = AiyagariEconomy(seed=args.seed, device=args.device,
                              **econ_dict)
    agent = AiyagariType(**agent_dict)
    agent.cycles = 0
    agent.get_economy_data(economy)
    economy.agents = [agent]
    return economy, agent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, choices=[None, "cuda", "cpu"],
                    help="default: the CUDA card (raises without one)")
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"],
                    help="the notebook-parity run is float64; float32 is "
                         "the accelerator dtype")
    ap.add_argument("--quick", action="store_true",
                    help="small config smoke run (seconds, not parity)")
    ap.add_argument("--output-dir", default=DEFAULT_OUT,
                    help="everything this run writes goes here")
    ap.add_argument("--seed", type=int, default=1,
                    help="shock-stream seed (the JAX artifacts' seed)")
    ap.add_argument("--sim-method", default="panel",
                    choices=["panel", "distribution"])
    ap.add_argument("--scf-csv", default=None,
                    help="optional wealth,weight CSV of the SCF microdata; "
                         "default: the vendored SCF Lorenz curve")
    ap.add_argument("--no-den-haan-pinned", action="store_true",
                    help="skip the pinned-histogram den Haan side-by-side "
                         "(a second full solve)")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="KS checkpoint for the main solve: written every "
                         "outer iteration, resumed from when it exists; "
                         "SIGTERM/SIGINT stop at the next iteration "
                         "boundary with exit code 75")
    ap.add_argument("--extras", action="store_true",
                    help="also the impulse response to a TFP shock "
                         "(transition path and sequence-space Jacobian) "
                         "and the histogram engine's readout")
    args = ap.parse_args(argv)
    if args.scf_csv and not os.path.exists(args.scf_csv):
        ap.error(f"--scf-csv {args.scf_csv!r} does not exist")

    from aiyagari_hark_tpu_torch.utils.resilience import (
        Interrupted,
        preemption_guard,
    )
    try:
        with preemption_guard():
            return _run_pipeline(args)
    except Interrupted as e:
        print(f"[reproduce_torch] preempted at a safe boundary: {e}"
              + (f"; rerun with --resume {e.resume_path} to continue"
                 if e.resume_path else ""), file=sys.stderr)
        sys.exit(75)           # EX_TEMPFAIL: supervisors restart on this


def _run_pipeline(args):
    start_time = time.perf_counter()
    import numpy as np
    import torch

    from aiyagari_hark_tpu_torch import (init_aiyagari_agents,
                                         init_aiyagari_economy)
    from aiyagari_hark_tpu_torch.device import resolve_device
    from aiyagari_hark_tpu_torch.models.diagnostics import den_haan_forecast
    from aiyagari_hark_tpu_torch.utils import stats
    from aiyagari_hark_tpu_torch.utils.checkpoint import (atomic_write_json,
                                                          atomic_write_text)
    from aiyagari_hark_tpu_torch.utils.timing import PhaseTimer

    dev = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")
    print(f"[reproduce_torch] device={device_name} dtype={args.dtype}")
    out_dir = args.output_dir
    figures_dir = os.path.join(out_dir, "Figures")
    plt = _pyplot()
    if plt is None:
        print("[reproduce_torch] matplotlib does not import: no figures "
              "this run")
    timer = PhaseTimer()

    # -- build (notebook cells 16-18: LaborAR=0.3, CRRA=1.0, AgentCount=350)
    econ_dict = init_aiyagari_economy()
    econ_dict.update(LaborAR=0.3, LaborSD=0.2, CRRA=1.0, verbose=False)
    agent_dict = init_aiyagari_agents()
    agent_dict.update(AgentCount=350)
    if args.quick:
        econ_dict.update(LaborStatesNo=3, act_T=300, T_discard=60)
        agent_dict.update(LaborStatesNo=3, AgentCount=60, aCount=12)
    economy, agent = _economy(args, econ_dict, agent_dict)
    with timer.phase("mrkv_history"):
        economy.make_Mrkv_history()

    # -- solve (cell 19)
    n_states = econ_dict["LaborStatesNo"]
    print(f"Now solving for the equilibrium of the {n_states}-State "
          f"Aiyagari (1994) model...")
    t0 = time.perf_counter()
    with timer.phase("solve"):
        sol = economy.solve(dtype=dtype, sim_method=args.sim_method,
                            checkpoint_path=args.resume)
    solve_minutes = (time.perf_counter() - t0) / 60.0
    print(f"Solving the Aiyagari model took {solve_minutes:.3f} minutes "
          f"(reference: 27.12 minutes). converged={sol.converged}")

    # -- equilibrium stats (cell 20); distribution mode reads the exact
    # histogram pair, "aNow" is the equal-weight panel in both modes
    depr = econ_dict["DeprFac"]
    if "aNowGrid" in economy.reap_state:
        sim_weights = economy.reap_state["aNowWeights"][0]
        a_mean = float(np.average(economy.reap_state["aNowGrid"][0],
                                  weights=sim_weights))
    else:
        sim_weights = None
        a_mean = float(np.mean(economy.reap_state["aNow"]))
    r_pct = (economy.sow_state["Rnow"] - 1.0) * 100.0
    saving_pct = 100.0 * depr * a_mean / (
        economy.sow_state["Mnow"] - (1.0 - depr) * a_mean)
    print(f"Equilibrium Return to Capital: {r_pct:.4f} % "
          f"(reference 4.178 %)")
    print(f"Equilibrium Savings Rate: {saving_pct:.4f} % "
          f"(reference 23.649 %)")

    # den Haan (2010) dynamic-forecast accuracy of the converged rule, and
    # beside it the pinned-histogram engine's (the engine that meets the
    # fraction-of-a-percent bar)
    dh = den_haan_forecast(sol, t_start=econ_dict["T_discard"])
    print(f"den Haan dynamic forecast error: "
          f"max {float(dh.max_error_pct):.3f} %  "
          f"mean {float(dh.mean_error_pct):.3f} %")
    dh_pin_fields = {}
    hist_solved = None
    if args.sim_method == "panel" and not args.no_den_haan_pinned:
        with timer.phase("den_haan_pinned"):
            pinned, _ = _economy(args, econ_dict, agent_dict)
            pinned.make_Mrkv_history()
            pinned_sol = pinned.solve(dtype=dtype,
                                      sim_method="distribution")
        hist_solved = (pinned_sol, pinned)
        dh_pin = den_haan_forecast(pinned_sol,
                                   t_start=econ_dict["T_discard"])
        dh_pin_fields = {
            "den_haan_pinned_max_error_pct": float(dh_pin.max_error_pct),
            "den_haan_pinned_mean_error_pct": float(dh_pin.mean_error_pct),
            "den_haan_pinned_converged": bool(pinned_sol.converged),
        }
        print(f"den Haan dynamic forecast error (pinned-histogram engine): "
              f"max {dh_pin_fields['den_haan_pinned_max_error_pct']:.3f} %  "
              f"mean {dh_pin_fields['den_haan_pinned_mean_error_pct']:.3f} %")

    # -- wealth stats (cell 24)
    sim_wealth = np.asarray(
        economy.reap_state["aNowGrid" if sim_weights is not None
                           else "aNow"][0])
    ws = stats.wealth_stats(sim_wealth, sim_weights)
    print(f"Simulated wealth: max={ws.max:.3f} mean={ws.mean:.3f} "
          f"std={ws.std:.3f} median={ws.median:.3f} "
          f"(reference 22.046 / 5.439 / 3.697 / 4.718)")

    # -- Lorenz vs SCF (cells 25-27)
    pctiles = np.linspace(0.01, 0.999, 15)   # Aiyagari-HARK.py:312
    if args.scf_csv:
        scf_wealth, scf_weights = stats.load_scf_wealth_weights(args.scf_csv)
        scf_lorenz = stats.get_lorenz_shares(
            scf_wealth, weights=scf_weights, percentiles=pctiles)
        scf_label = "SCF (raw microdata)"
    else:
        scf_lorenz = stats.load_scf_lorenz().scf_shares
        scf_label = "SCF"
    sim_lorenz = stats.get_lorenz_shares(sim_wealth, weights=sim_weights,
                                         percentiles=pctiles)
    lorenz_dist = float(np.sqrt(np.sum((scf_lorenz - sim_lorenz) ** 2)))
    print(f"The Euclidean distance between simulated wealth distribution "
          f"and the {scf_label} estimates is {lorenz_dist:.4f} "
          f"(reference vs real SCF: 0.9714)")

    figures = []
    if plt is not None:
        with timer.phase("figures"):
            figures = _figures(plt, economy, agent, n_states, pctiles,
                               scf_lorenz, sim_lorenz, scf_label,
                               figures_dir)

    extras = None
    if args.extras:
        irf_paths, irf = _run_irf_extra(args, econ_dict, dtype, dev, timer,
                                        plt, figures_dir)
        figures += irf_paths
        extras = {"irf": irf,
                  "histogram_engine": _run_histogram_extra(
                      args, econ_dict, agent_dict, dtype, timer, stats,
                      solved=hist_solved)}

    # -- runtime + structured results (cell 30)
    os.makedirs(out_dir, exist_ok=True)
    total_time = time.perf_counter() - start_time
    atomic_write_text(
        os.path.join(out_dir, "runtime.txt"),
        f"Total runtime: {total_time} seconds\n"
        f"Python version: {sys.version}\n"
        f"PyTorch: {torch.__version__}\n"
        f"Device: {device_name} ({args.dtype})\n"
        f"Phase breakdown:\n{timer.summary()}\n")
    results = {
        "device": device_name,
        "dtype": args.dtype,
        "quick": args.quick,
        "seed": args.seed,
        "sim_method": args.sim_method,
        "converged": bool(sol.converged),
        "outer_iterations": len(sol.records),
        "equilibrium_return_pct": r_pct,
        "equilibrium_saving_rate_pct": saving_pct,
        "den_haan_max_error_pct": float(dh.max_error_pct),
        "den_haan_mean_error_pct": float(dh.mean_error_pct),
        **dh_pin_fields,
        "wealth_stats": ws._asdict(),
        "lorenz_distance": lorenz_dist,
        "lorenz_reference": scf_label,
        "afunc_intercept": [a.intercept for a in economy.AFunc],
        "afunc_slope": [a.slope for a in economy.AFunc],
        "solve_minutes": solve_minutes,
        "total_seconds": total_time,
        "phases": timer.report(),
        "extras": extras,
        "figures": figures,
        "reference_goldens": REFERENCE_GOLDENS,
    }
    atomic_write_json(os.path.join(out_dir, "results.json"), results,
                      indent=2, trailing_newline=False)
    print(f"Total runtime: {total_time:.2f} seconds (results and phase "
          f"breakdown in {out_dir}/)")
    return results


def _run_histogram_extra(args, econ_dict, agent_dict, dtype, timer, stats,
                         solved=None):
    """The pinned histogram engine's own fixed point on the run's
    calibration, so results.json reports both simulators' wealth
    statistics (``reproduce.py --extras``'s ``histogram_engine``).  None
    when the main run already used the distribution engine.  ``solved``:
    the den Haan side-by-side's ``(solution, economy)``, reused instead
    of solving again."""
    import numpy as np

    if args.sim_method == "distribution":
        return None
    if solved is None:
        with timer.phase("histogram_engine"):
            economy, _ = _economy(args, econ_dict, agent_dict)
            economy.make_Mrkv_history()
            sol = economy.solve(dtype=dtype, sim_method="distribution")
    else:
        sol, economy = solved
    with timer.phase("histogram_stats"):
        grid = np.asarray(economy.reap_state["aNowGrid"][0])
        w = np.asarray(economy.reap_state["aNowWeights"][0])
        ws = stats.wealth_stats(grid, w)
        out = {
            "converged": bool(sol.converged),
            "r_pct": (economy.sow_state["Rnow"] - 1.0) * 100.0,
            "wealth_stats": {"max": ws.max, "mean": ws.mean,
                             "std": ws.std, "median": ws.median},
            "lorenz_distance": stats.lorenz_distance_vs_scf(grid, w),
        }
    print(f"Histogram engine (extras): r*={out['r_pct']:.4f}% "
          f"mean={ws.mean:.3f} std={ws.std:.3f} median={ws.median:.3f} "
          f"lorenz={out['lorenz_distance']:.4f}")
    return out


def _run_irf_extra(args, econ_dict, dtype, dev, timer, plt, figures_dir):
    """The general-equilibrium impulse response to a 1 % TFP shock
    decaying at 0.8: the nonlinear transition path (``solve_transition``)
    against the sequence-space Jacobian's linear response, on the
    notebook's (CRRA, labor-process) calibration at illustration-size
    grids (``reproduce.py --extras``'s configuration and fields).
    Returns (figure paths, fields)."""
    import numpy as np

    from aiyagari_hark_tpu_torch.models.equilibrium import (
        solve_bisection_equilibrium)
    from aiyagari_hark_tpu_torch.models.household import build_simple_model
    from aiyagari_hark_tpu_torch.models.jacobian import (
        linear_impulse_response, sequence_jacobians)
    from aiyagari_hark_tpu_torch.models.transition import solve_transition

    with timer.phase("irf"):
        horizon = 24 if args.quick else 48
        model = build_simple_model(
            labor_states=min(econ_dict["LaborStatesNo"], 5),
            labor_ar=econ_dict["LaborAR"], labor_sd=econ_dict["LaborSD"],
            a_count=16 if args.quick else 40,
            dist_count=60 if args.quick else 200, dtype=dtype, device=dev)
        crra, depr = econ_dict["CRRA"], econ_dict["DeprFac"]
        beta, alpha = econ_dict["DiscFac"], econ_dict["CapShare"]
        eq = solve_bisection_equilibrium(model, beta, crra, alpha, depr)
        dz = 0.01 * 0.8 ** np.arange(horizon)
        jac = sequence_jacobians(model, beta, crra, alpha, depr, eq, horizon)
        lin = linear_impulse_response(jac, dz)
        nl = solve_transition(model, beta, crra, alpha, depr,
                              init_dist=eq.distribution,
                              terminal_policy=eq.policy,
                              k_terminal=eq.capital, horizon=horizon,
                              prod_path=1.0 + dz)
        k_ss = float(eq.capital)
        y_ss = float(jac.y_ss)
        dk_nl = 100.0 * (nl.k_path.cpu().numpy() / k_ss - 1.0)
        dk_lin = 100.0 * lin.dk.cpu().numpy() / k_ss
        irf_gap = float(np.abs(dk_lin - dk_nl).max())
        paths = []
        if plt is not None:
            fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 3.6))
            t = np.arange(horizon)
            ax1.plot(t, 100.0 * dz, "k--", label="TFP shock (%)")
            ax1.plot(t, dk_nl, label="K, nonlinear (MIT shock)")
            ax1.plot(t, dk_lin, ":", label="K, linear (Jacobian)")
            ax1.set_xlabel("quarters"), ax1.set_ylabel("% dev from SS")
            ax1.legend(fontsize=8)
            ax2.plot(t, 100.0 * lin.dc.cpu().numpy() / y_ss,
                     label="C (linear)")
            ax2.plot(t, 100.0 * lin.dy.cpu().numpy() / y_ss,
                     label="Y (linear)")
            ax2.set_xlabel("quarters"), ax2.set_ylabel("% of SS output")
            ax2.legend(fontsize=8)
            fig.suptitle("GE impulse response to a 1% transitory TFP shock")
            fig.tight_layout()
            paths = make_figs(fig, "impulse_response", figures_dir)
            plt.close(fig)
    print(f"Impulse response: linear-vs-nonlinear peak gap {irf_gap:.4f} pp "
          f"of K, {nl.iterations} transition iterations")
    return paths, {
        "horizon": horizon, "shock_pct": 1.0,
        "k_peak_pct": float(np.abs(dk_nl).max()),
        "linear_nonlinear_gap_pp": irf_gap,
        "r_star_bisection_pct": 100.0 * float(eq.r_star)}


def _figures(plt, economy, agent, n_states, pctiles, scf_lorenz,
             sim_lorenz, scf_label, figures_dir) -> list:
    """The notebook's three figures: consumption functions by labor state
    (cell 21), the aggregate saving rule (cell 22), the Lorenz curves
    (cell 27)."""
    import numpy as np

    fig, axes = plt.subplots(1, n_states, figsize=(3.2 * n_states, 3.2),
                             sharey=True)
    m = np.linspace(0.0, 50.0, 200)
    for j, ax in enumerate(np.atleast_1d(axes)):
        for interp in agent.solution[0].cFunc[4 * j].xInterpolators:
            ax.plot(m, interp(m), lw=0.9)
        ax.set_title(f"labor state {j + 1}/{n_states}", fontsize=9)
        ax.set_xlabel(r"$m$")
    np.atleast_1d(axes)[0].set_ylabel(r"Consumption $c$")
    fig.suptitle("Consumption function by aggregate market resources")
    fig.tight_layout()
    paths = make_figs(fig, "consumption_functions", figures_dir)
    plt.close(fig)

    bottom, top = 0.1, 2.0 * economy.KSS
    x = np.linspace(bottom, top, 1000, endpoint=True)
    fig = plt.figure()
    plt.plot(x, economy.AFunc[0](x), label="AFunc[0] (bad state)")
    plt.plot(x, economy.AFunc[1](x), label="AFunc[1] (good state)")
    plt.xlim([bottom, top])
    plt.xlabel("Aggregate market resources $M$")
    plt.ylabel("Aggregate savings $A$")
    plt.title("Aggregate savings as a function of aggregate market resources")
    plt.legend()
    paths += make_figs(fig, "aggregate_savings", figures_dir)
    plt.close(fig)

    fig = plt.figure(figsize=(5, 5))
    plt.title("Wealth Distribution")
    plt.plot(pctiles, scf_lorenz, "--k", label=scf_label)
    plt.plot(pctiles, sim_lorenz, "-b", label="Aiyagari")
    plt.plot(pctiles, pctiles, "g-.", label="45 Degree")
    plt.xlabel("Percentile of net worth")
    plt.ylabel("Cumulative share of wealth")
    plt.legend(loc=2)
    plt.ylim([0, 1])
    paths += make_figs(fig, "wealth_distribution_1", figures_dir)
    plt.close(fig)
    return paths


if __name__ == "__main__":
    main()
