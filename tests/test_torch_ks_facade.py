"""The port's notebook surface against the JAX package, on the CPU in
float64: the facade (``AiyagariEconomy`` / ``AiyagariType``, the
reference's attribute names and result surface), den Haan's forecast,
``quantile_resample``, the wealth statistics and the Lorenz distance to
the SCF on the same arrays, and ``reproduce_torch.py``, which writes only
under its own output directory.

Tolerances: steady-state attributes and host statistics equal; den
Haan's errors 1e-12 relative; the facade's solved rule 1e-9 absolute
(``chip_smoke.KS_TOL``'s intercept), prices, histories and policies 1e-8
relative: at this tiny width (32 histogram points) the pinned secant's
residual has a log-slope of order 100, so the 1e-11 intercept gaps of the
two packages' summation orders move the realized aggregates ~1e-9.
"""

import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aiyagari_hark_tpu as jpkg
import aiyagari_hark_tpu.models.diagnostics as jd
import aiyagari_hark_tpu.models.ks_model as jk
import aiyagari_hark_tpu.utils.config as jc
import aiyagari_hark_tpu.utils.stats as jstats
import aiyagari_hark_tpu_torch as tpkg
import aiyagari_hark_tpu_torch.models.diagnostics as td
import aiyagari_hark_tpu_torch.models.ks_model as tk
import aiyagari_hark_tpu_torch.utils.config as tc
import aiyagari_hark_tpu_torch.utils.stats as tstats

torch.set_num_threads(1)
F64 = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ECON = dict(LaborStatesNo=3, act_T=150, T_discard=30, verbose=False,
            LaborAR=0.3, CRRA=1.0, max_loops=4)
AGENT = dict(LaborStatesNo=3, AgentCount=40, aCount=10)


def _build(pkg, device=None, **econ):
    kw = {} if device is None else {"device": device}
    economy = pkg.AiyagariEconomy(seed=0, **kw, **{**ECON, **econ})
    agent = pkg.AiyagariType(**AGENT)
    agent.cycles = 0
    agent.get_economy_data(economy)
    economy.agents = [agent]
    return economy, agent


@pytest.fixture(scope="module")
def solved_pair():
    """Both facades, the distribution engine on JAX's chain."""
    je, ja = _build(jpkg)
    te, ta = _build(tpkg, device="cpu")
    chain = je.make_Mrkv_history()
    te.MrkvNow_hist = np.array(chain)
    kw = dict(sim_method="distribution", dist_count=32)
    je.solve(dtype=jnp.float64, **kw)
    te.solve(dtype=F64, **kw)
    return (je, ja), (te, ta)


def test_reference_dicts_and_steady_state_equal_jax():
    assert tpkg.init_aiyagari_economy() == jpkg.init_aiyagari_economy()
    ja, ta = jpkg.init_aiyagari_agents(), tpkg.init_aiyagari_agents()
    assert ja.keys() == ta.keys()
    np.testing.assert_array_equal(ja.pop("MgridBase"), ta.pop("MgridBase"))
    assert ja == ta
    je, _ = _build(jpkg)
    te, _ = _build(tpkg, device="cpu")
    for k in ("KtoLSS", "KSS", "WSS", "RSS", "MSS", "KtoYSS"):
        assert getattr(te, k) == getattr(je, k), k
    assert te.sow_init == je.sow_init
    assert [a.intercept for a in te.AFunc] == [a.intercept for a in je.AFunc]


def test_facade_entry_points_default_to_the_card():
    economy = tpkg.AiyagariEconomy()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            economy.make_Mrkv_history()


def test_make_mrkv_history_is_seeded():
    te, _ = _build(tpkg, device="cpu")
    h = te.make_Mrkv_history()
    assert h.shape == (150,) and h.dtype == np.int64 and h[0] == 0
    np.testing.assert_array_equal(h, te.make_Mrkv_history())
    assert not np.array_equal(h, te.make_Mrkv_history(seed=3))


def test_solved_surface_matches_jax(solved_pair):
    (je, ja), (te, ta) = solved_pair
    for k in ("Mnow", "Aprev", "Rnow", "Wnow"):
        assert te.sow_state[k] == pytest.approx(je.sow_state[k], rel=1e-8), k
    assert te.sow_state["Mrkv"] == je.sow_state["Mrkv"]
    for j in range(2):
        assert te.AFunc[j].intercept == pytest.approx(je.AFunc[j].intercept,
                                                      abs=1e-9)
        assert te.AFunc[j].slope == je.AFunc[j].slope == 0.0
        assert te.AFunc[j].distance(je.AFunc[j]) < 1e-9
    assert te.intercept_prev == pytest.approx(je.intercept_prev, abs=1e-9)
    assert te.reap_state.keys() == je.reap_state.keys()
    for k in ("aNow", "aNowGrid", "aNowWeights"):
        np.testing.assert_allclose(te.reap_state[k][0], je.reap_state[k][0],
                                   rtol=1e-8, atol=1e-14, err_msg=k)
    assert te.history.keys() == je.history.keys()
    for k, v in je.history.items():
        np.testing.assert_allclose(te.history[k], v, rtol=1e-8, atol=1e-14,
                                   err_msg=k)
    assert len(ta.solution[0].cFunc) == len(ja.solution[0].cFunc) == 12
    m = np.linspace(0.0, 40.0, 25)
    M = te.MSS * 1.03
    for s in (0, 5, 11):
        tf, jf = ta.solution[0].cFunc[s], ja.solution[0].cFunc[s]
        np.testing.assert_allclose(tf(m, M), jf(m, M), rtol=1e-8)
        Ms = te.MSS * np.linspace(0.8, 1.2, 25)
        np.testing.assert_allclose(tf(m, Ms), jf(m, Ms), rtol=1e-8)
        assert len(tf.xInterpolators) == len(jf.xInterpolators) == 15
        np.testing.assert_allclose(tf.xInterpolators[7](m),
                                   jf.xInterpolators[7](m), rtol=1e-8)


def test_panel_solve_surface_and_errors():
    te, ta = _build(tpkg, device="cpu", tolerance=0.05)
    te.make_Mrkv_history()
    sol = te.solve(dtype=F64)
    assert te.reap_state["aNow"][0].shape == (40,)
    assert te.reap_state["EmpNow"][0].dtype == np.bool_
    assert te.history["Urate"].shape == (150,)
    # the reference's in-place continuation: the solved rule is the next
    # solve's initial guess
    assert te.parameters["intercept_prev"] == [
        float(x) for x in sol.afunc.intercept]
    with pytest.raises(ValueError, match="agents is empty"):
        tpkg.AiyagariEconomy(device="cpu").solve()
    economy = tpkg.AiyagariEconomy(device="cpu", CRRA=2.0)
    economy.agents = [tpkg.AiyagariType(CRRA=3.0)]
    with pytest.raises(ValueError, match="set explicitly on both"):
        economy.solve()


def test_den_haan_matches_jax_on_the_same_arrays():
    """The same rule, history and chain (a true-KS calibration, so the
    mill depends on the state) through both forecasts."""
    agent = dict(labor_states=3, a_count=10)
    econ = dict(labor_states=3, urate_b=0.1, urate_g=0.04, prod_b=0.99,
                prod_g=1.01)
    jcal = jk.build_ks_calibration(jc.AgentConfig(**agent),
                                   jc.EconomyConfig(**econ))
    tcal = tk.build_ks_calibration(tc.AgentConfig(**agent),
                                   tc.EconomyConfig(**econ), dtype=F64,
                                   device="cpu")
    rng = np.random.default_rng(0)
    chain = (rng.random(500) < 0.5).astype(np.int64)
    a_prev = 5.0 * np.exp(0.02 * rng.normal(size=500))
    rule = ([0.3, 0.35], [0.8, 0.78])
    jsol = types.SimpleNamespace(
        calibration=jcal, mrkv_hist=chain,
        afunc=jk.AFuncParams(*(jnp.asarray(x) for x in rule)),
        history=types.SimpleNamespace(A_prev=jnp.asarray(a_prev)))
    tsol = types.SimpleNamespace(
        calibration=tcal, mrkv_hist=chain,
        afunc=tk.AFuncParams(*(torch.tensor(x, dtype=F64) for x in rule)),
        history=types.SimpleNamespace(A_prev=torch.as_tensor(a_prev)))
    a, b = jd.den_haan_forecast(jsol, t_start=50), td.den_haan_forecast(
        tsol, t_start=50)
    np.testing.assert_allclose(b.forecast.numpy(), np.asarray(a.forecast),
                               rtol=1e-12)
    assert float(b.max_error_pct) == pytest.approx(float(a.max_error_pct),
                                                   rel=1e-12)
    assert float(b.mean_error_pct) == pytest.approx(float(a.mean_error_pct),
                                                    rel=1e-12)
    c = td.den_haan_forecast(tsol)
    assert c.forecast.shape == (500 - 500 // 8 - 1,)


def test_host_statistics_equal_jax():
    rng = np.random.default_rng(2)
    grid = np.concatenate([[0.0], np.geomspace(1e-3, 100.0, 80)])
    weights = rng.random(81) * np.exp(-grid / 8.0)
    weights[-5:] = [1e-9, 0.0, 3e-10, 0.0, 1e-11]
    np.testing.assert_array_equal(tpkg.quantile_resample(grid, weights, 350),
                                  jpkg.facade.quantile_resample(grid, weights,
                                                                350))
    sample = rng.lognormal(1.5, 0.6, 350)
    for args in ((sample,), (grid, weights)):
        assert tstats.wealth_stats(*args) == jstats.wealth_stats(*args)
        assert (tstats.lorenz_distance_vs_scf(*args)
                == jstats.lorenz_distance_vs_scf(*args))
        assert tstats.gini(*args) == jstats.gini(*args)
    t, j = tstats.load_scf_lorenz(), jstats.load_scf_lorenz()
    for x, y in zip(t, j):
        np.testing.assert_array_equal(x, y)
    assert tstats._SCF_LORENZ_CSV.startswith(
        os.path.join(ROOT, "aiyagari_hark_tpu_torch"))


def _snapshot(path):
    out = {}
    for dirpath, _, names in os.walk(path):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, path)] = os.stat(p).st_mtime_ns
    return out


def test_reproduce_torch_writes_only_under_its_output_dir(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """A CPU run of the quick config: results.json, runtime.txt (and no
    figures when matplotlib is missing) under --output-dir and nowhere
    else; the JAX run's artifacts in the repository untouched."""
    import reproduce_torch

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(reproduce_torch, "_pyplot", lambda: None)
    repo_before = {p: os.stat(os.path.join(ROOT, p)).st_mtime_ns
                   for p in ("results.json", "runtime.txt")}
    figs_before = _snapshot(os.path.join(ROOT, "Figures"))
    before = _snapshot(str(tmp_path))
    res = reproduce_torch.main(["--device", "cpu", "--quick",
                                "--no-den-haan-pinned", "--output-dir",
                                "out"])
    new = set(_snapshot(str(tmp_path))) - set(before)
    assert new == {os.path.join("out", "results.json"),
                   os.path.join("out", "runtime.txt")}
    assert "matplotlib does not import" in capsys.readouterr().out
    assert res["converged"] and res["figures"] == []
    assert 3.0 < res["equilibrium_return_pct"] < 5.5
    assert {p: os.stat(os.path.join(ROOT, p)).st_mtime_ns
            for p in repo_before} == repo_before
    assert _snapshot(os.path.join(ROOT, "Figures")) == figs_before
    with open(tmp_path / "out" / "runtime.txt") as f:
        assert "Phase breakdown" in f.read()


def test_reproduce_torch_extras_reuse_the_pinned_solve(tmp_path, monkeypatch):
    """``--quick --extras`` with the den Haan side-by-side on: the
    histogram-engine readout (``extras.histogram_engine``, as
    ``reproduce.py --extras`` writes it) reuses the side-by-side's pinned
    solve (no second solve phase) and reports r*, the wealth statistics
    and the Lorenz distance through the port's ``utils.stats``.  The
    impulse response of ``--extras`` is held by
    ``tests/test_torch_transition.py``; here it is stubbed."""
    import reproduce_torch

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(reproduce_torch, "_pyplot", lambda: None)
    monkeypatch.setattr(reproduce_torch, "_run_irf_extra",
                        lambda *a, **k: ([], None))
    res = reproduce_torch.main(["--device", "cpu", "--quick", "--extras",
                                "--output-dir", "out"])
    hist = res["extras"]["histogram_engine"]
    assert "den_haan_pinned" in res["phases"]
    assert "histogram_engine" not in res["phases"]       # reused, not re-run
    assert hist["converged"] is res["den_haan_pinned_converged"]
    assert 3.0 < hist["r_pct"] < 5.5
    assert set(hist["wealth_stats"]) == {"max", "mean", "std", "median"}
    assert 0.0 < hist["wealth_stats"]["mean"] < hist["wealth_stats"]["max"]
    assert 0.0 < hist["lorenz_distance"] < 2.0
    with open(tmp_path / "out" / "results.json") as f:
        assert json.load(f)["extras"]["histogram_engine"] == hist
