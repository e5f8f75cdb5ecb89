"""The port's Krusell-Smith machinery against the JAX reference, on the CPU
in float64: the calibration, one EGM step and the household fixed point,
the two-level interpolation, the masked regression, both simulators and
the distribution engine's outer loop.

Inputs are made from a seed with numpy; where a chain is needed both
packages take JAX's (``mrkv_hist``).  Tolerances, absolute unless named:
calibration arrays 1e-13, the EGM step and fixed point 1e-10 (equal step
counts), interpolation 1e-13, OLS 1e-12, the histogram's ``A_prev`` path
1e-11 with mass conserved to 1e-12, the panel's employment counts equal
(its ``urate`` within 1e-15: XLA contracts JAX's ``1 - n/N`` into one
fused multiply-add), the outer loop within ``chip_smoke.KS_TOL`` (the
tolerances the card is held to at the notebook's width).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aiyagari_hark_tpu.models.ks_model as jk
import aiyagari_hark_tpu.models.ks_solver as jks
import aiyagari_hark_tpu.models.simulate as js
import aiyagari_hark_tpu.ops.interp as ji
import aiyagari_hark_tpu.ops.regression as jr
import aiyagari_hark_tpu.utils.config as jc
import aiyagari_hark_tpu_torch.models.ks_model as tk
import aiyagari_hark_tpu_torch.models.ks_solver as tks
import aiyagari_hark_tpu_torch.models.simulate as ts
import aiyagari_hark_tpu_torch.ops.interp as ti
import aiyagari_hark_tpu_torch.ops.regression as tr
import aiyagari_hark_tpu_torch.utils.config as tc
from chip_smoke import KS_TOL

torch.set_num_threads(1)
F64 = torch.float64
SMALL_AGENT = dict(labor_states=3, a_count=12, agent_count=60)
KS_ECON = dict(labor_states=3, verbose=False, urate_b=0.10, urate_g=0.04,
               prod_b=0.99, prod_g=1.01)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _configs(agent_kw, econ_kw):
    return ((jc.AgentConfig(**agent_kw), jc.EconomyConfig(**econ_kw)),
            (tc.AgentConfig(**agent_kw), tc.EconomyConfig(**econ_kw)))


def _cals(ks_employment, agent_kw=SMALL_AGENT, econ_kw=KS_ECON):
    (ja, je), (ta, te) = _configs(agent_kw, econ_kw)
    return (jk.build_ks_calibration(ja, je, ks_employment=ks_employment,
                                    dtype=jnp.float64),
            tk.build_ks_calibration(ta, te, ks_employment=ks_employment,
                                    dtype=F64, device="cpu"))


def _afuncs(intercept=(-0.4, -0.3), slope=(1.1, 1.05)):
    return (jk.AFuncParams(jnp.asarray(intercept), jnp.asarray(slope)),
            tk.AFuncParams(torch.tensor(intercept, dtype=F64),
                           torch.tensor(slope, dtype=F64)))


def _jax_chain(cal, length, seed):
    return np.array(js.simulate_markov_history(
        cal.agg_transition, 0, length, jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def ks_cals():
    return _cals(True)


@pytest.fixture(scope="module")
def ks_policies(ks_cals):
    jcal, tcal = ks_cals
    ja, ta = _afuncs()
    return (jk.solve_ks_household(ja, jcal), tk.solve_ks_household(ta, tcal))


def test_config_defaults_and_reference_keys_match_jax():
    for jcls, tcls in ((jc.AgentConfig, tc.AgentConfig),
                       (jc.EconomyConfig, tc.EconomyConfig)):
        assert jcls() .__dict__ == tcls().__dict__
    ref = {"LaborAR": 0.3, "CRRA": 2.0, "AgentCount": 99, "act_T": 50,
           "MgridBase": np.array([0.5, 1.0, 2.0]),
           "intercept_prev": [0.1, 0.2]}
    assert (jc.AgentConfig.from_reference_dict(ref).__dict__
            == tc.AgentConfig.from_reference_dict(ref).__dict__)
    assert (jc.EconomyConfig.from_reference_dict(ref).__dict__
            == tc.EconomyConfig.from_reference_dict(ref).__dict__)
    assert [c.__dict__ for c in jc.notebook_run_configs()] == [
        c.__dict__ for c in tc.notebook_run_configs()]


@pytest.mark.parametrize("ks_employment", [False, True])
def test_calibration_and_precompute_match_jax(ks_employment):
    jcal, tcal = _cals(ks_employment)
    for f in jcal._fields:
        a, b = getattr(jcal, f), getattr(tcal, f)
        if f == "steady_state":
            assert [float(x) for x in a] == [float(x) for x in b]
        elif f == "ks_employment":
            assert a == b == ks_employment
        else:
            assert _np(b).dtype == np.asarray(a).dtype, f
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=0,
                                       atol=1e-13, err_msg=f)
    ja, ta = _afuncs()
    for x, y in zip(jk.precompute(ja, jcal), tk.precompute(ta, tcal)):
        np.testing.assert_allclose(_np(y), np.asarray(x), rtol=1e-14,
                                   atol=1e-13)


def test_egm_step_matches_jax(ks_cals):
    jcal, tcal = ks_cals
    ja, ta = _afuncs()
    jp, tp = jk.precompute(ja, jcal), tk.precompute(ta, tcal)
    jpol, tpol = jk.initial_ks_policy(jcal), tk.initial_ks_policy(tcal)
    np.testing.assert_array_equal(_np(tpol.m_knots), np.asarray(jpol.m_knots))
    for _ in range(3):
        jpol = jk.egm_step_ks(jpol, jp, jcal)
        tpol = tk.egm_step_ks(tpol, tp, tcal)
        for x, y in zip(jpol, tpol):
            np.testing.assert_allclose(_np(y), np.asarray(x), rtol=0,
                                       atol=1e-10)


def test_solve_ks_household_matches_jax(ks_policies):
    (jpol, jit, jdiff, jst), (tpol, tit, tdiff, tst) = ks_policies
    assert int(tit) == int(jit) and int(tst) == int(jst) == 0
    assert float(tdiff) == pytest.approx(float(jdiff), rel=1e-6)
    for x, y in zip(jpol, tpol):
        np.testing.assert_allclose(_np(y), np.asarray(x), rtol=0, atol=1e-10)


@pytest.mark.parametrize("precision,atol", [("mixed", 5e-5), ("fast", 1e-3)])
def test_solve_ks_household_precision_ladder(ks_cals, ks_policies,
                                             precision, atol):
    """The two-phase ladders land on the reference fixed point: two
    iterates each certified to ``tol`` of their predecessor under a
    contraction of rate ~beta lie within ``2 tol / (1 - beta)`` of each
    other (5e-5 at tol 1e-6; "fast" certifies 256 float32 eps only)."""
    jcal, tcal = ks_cals
    _, ta = _afuncs()
    pol, _, _, status = tk.solve_ks_household(ta, tcal, precision=precision)
    assert int(status) == 0
    ref = ks_policies[1][0]
    for x, y in zip(ref, pol):
        assert x.dtype == y.dtype == F64
        np.testing.assert_allclose(_np(y), _np(x), rtol=0, atol=atol)


def test_interpolation_matches_jax(ks_policies, ks_cals):
    """Random queries, some outside the knot span and some M outside the
    M-grid (linear extrapolation), on the same knots (JAX's, carried
    across)."""
    jcal, tcal = ks_cals
    (jpol, *_), _ = ks_policies
    tpol = tk.KSPolicy(*(torch.as_tensor(np.array(x)) for x in jpol))
    rng = np.random.default_rng(0)
    mg = np.asarray(jcal.m_grid)
    for M in (0.3 * mg[0], mg[3] + 0.01, 0.5 * (mg[5] + mg[6]),
              1.5 * mg[-1]):
        m = rng.uniform(-1.0, 80.0, 40)
        s = rng.integers(0, 12, 40)
        a = ji.interp_on_interp(jnp.asarray(m), jnp.asarray(M), jcal.m_grid,
                                jpol.m_knots[5], jpol.c_knots[5])
        b = ti.interp_on_interp(torch.as_tensor(m), torch.tensor(M),
                                tcal.m_grid, tpol.m_knots[5],
                                tpol.c_knots[5])
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=0, atol=1e-13)
        a = ji.eval_policy_agents(jnp.asarray(m), jnp.asarray(s),
                                  jnp.asarray(M), jcal.m_grid, jpol.m_knots,
                                  jpol.c_knots)
        b = ti.eval_policy_agents(torch.as_tensor(m), torch.as_tensor(s),
                                  torch.tensor(M, dtype=F64), tcal.m_grid,
                                  tpol.m_knots, tpol.c_knots)
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=0, atol=1e-13)


def test_masked_ols_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=200)
    y = 0.3 + 1.2 * x + 0.1 * rng.normal(size=200)
    for mask in (rng.random(200) < 0.5, np.zeros(200, bool),
                 np.ones(200, bool)):
        a = jr.masked_ols(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
        b = tr.masked_ols(torch.as_tensor(x), torch.as_tensor(y),
                          torch.as_tensor(mask))
        for u, v in zip(a, b):
            np.testing.assert_allclose(_np(v), np.asarray(u), rtol=1e-12,
                                       atol=1e-12)
    empty = tr.masked_ols(torch.as_tensor(x), torch.as_tensor(y),
                          torch.zeros(200, dtype=torch.bool))
    assert np.isnan(float(empty.slope)) and np.isnan(float(empty.intercept))
    flat = tr.masked_ols(torch.ones(10, dtype=F64), torch.as_tensor(y[:10]),
                         torch.ones(10, dtype=torch.bool))
    assert float(flat.r_squared) == 0.0


def test_distribution_history_matches_jax(ks_cals, ks_policies):
    """1500 periods of the histogram at realized prices: the A_prev path,
    M and urate against JAX; mass conserved every period."""
    jcal, tcal = ks_cals
    (jpol, *_), (tpol, *_) = ks_policies
    chain = _jax_chain(jcal, 1500, 3)
    jg, tg = js.make_sim_dist_grid(jcal, 60), ts.make_sim_dist_grid(tcal, 60)
    np.testing.assert_array_equal(_np(tg), np.asarray(jg))
    jh, jf = js.simulate_distribution_history(jpol, jcal, jnp.asarray(chain),
                                              jg)
    th, tf = ts.simulate_distribution_history(tpol, tcal,
                                              torch.as_tensor(chain), tg)
    for f in ("A_prev", "M_now", "urate"):
        np.testing.assert_allclose(_np(getattr(th, f)),
                                   np.asarray(getattr(jh, f)), rtol=0,
                                   atol=1e-11, err_msg=f)
    np.testing.assert_array_equal(_np(th.mrkv), chain)
    np.testing.assert_allclose(_np(tf.dist), np.asarray(jf.dist), rtol=0,
                               atol=1e-12)
    assert abs(float(tf.dist.sum()) - 1.0) < 1e-12
    assert float(tf.dist.min()) >= 0.0


def test_fixed_price_history_matches_jax(ks_cals, ks_policies):
    """The slope-pinned engine's simulation at fixed prices R(K-bar)."""
    jcal, tcal = ks_cals
    (jpol, *_), (tpol, *_) = ks_policies
    chain = _jax_chain(jcal, 400, 4)
    jg, tg = js.make_sim_dist_grid(jcal, 50), ts.make_sim_dist_grid(tcal, 50)
    kbar = 4.9
    jh, jf = js.simulate_distribution_history(
        jpol, jcal, jnp.asarray(chain), jg, fixed_K=jnp.float64(kbar))
    th, tf = ts.simulate_distribution_history(
        tpol, tcal, torch.as_tensor(chain), tg,
        fixed_K=torch.tensor(kbar, dtype=F64))
    for f in ("A_prev", "M_now", "urate"):
        np.testing.assert_allclose(_np(getattr(th, f)),
                                   np.asarray(getattr(jh, f)), rtol=0,
                                   atol=1e-11, err_msg=f)
    for f in ("M_now", "R_now", "W_now"):
        assert float(getattr(tf, f)) == pytest.approx(
            float(getattr(jf, f)), abs=1e-14)


def test_panel_employment_counts_equal_jax(ks_cals, ks_policies):
    """The exact-count employment draw: the same chain and initial count
    give JAX's employed count every period, whatever the draws."""
    jcal, tcal = ks_cals
    (jpol, *_), (tpol, *_) = ks_policies
    chain = _jax_chain(jcal, 400, 5)
    agents = 60
    jinit = js.initial_panel(jcal, agents, 0, jax.random.PRNGKey(1))
    tinit = ts.initial_panel(tcal, agents, 0,
                             torch.Generator().manual_seed(1))
    assert int(tinit.employed.sum()) == int(jinit.employed.sum())
    jh, _ = js.simulate_panel(jpol, jcal, jnp.asarray(chain), jinit,
                              jax.random.PRNGKey(2))
    th, tfin = ts.simulate_panel(tpol, tcal, torch.as_tensor(chain), tinit,
                                 torch.Generator().manual_seed(2))
    ju, tu = np.asarray(jh.urate), _np(th.urate)
    np.testing.assert_array_equal(np.round((1.0 - tu) * agents),
                                  np.round((1.0 - ju) * agents))
    assert len(set(np.round((1.0 - tu) * agents))) > 1   # counts move
    np.testing.assert_allclose(tu, ju, rtol=0, atol=1e-15)
    assert int(tfin.employed.sum()) == int(round((1.0 - tu[-1]) * agents))


def test_markov_history_is_seeded_and_has_the_chain_statistics(ks_cals):
    _, tcal = ks_cals

    def draw(seed, n=4000):
        return _np(ts.simulate_markov_history(
            tcal.agg_transition, 0, n, torch.Generator().manual_seed(seed)))

    h = draw(0)
    assert h[0] == 0 and set(np.unique(h)) <= {0, 1}
    np.testing.assert_array_equal(h, draw(0))
    assert not np.array_equal(h, draw(1))
    # the doubling scan equals the step-by-step chain of the same draws
    g = torch.Generator().manual_seed(0)
    u = torch.rand(3999, generator=g, dtype=F64).numpy()
    p_stay = np.diag(_np(tcal.agg_transition))
    z, ref = 0, [0]
    for x in u:
        cdf0 = _np(tcal.agg_transition)[z, 0]
        z = int(cdf0 <= x)
        ref.append(z)
    np.testing.assert_array_equal(h, ref)
    assert 0.3 < h.mean() < 0.7
    assert 4 < len(h) / max((np.diff(h) != 0).sum(), 1) < 16
    assert p_stay.tolist() == [0.875, 0.875]


def test_pinned_secant_trajectory_matches_jax():
    """The secant is host Python in both packages: the same residuals give
    the same iterates, bracket and checkpoint form."""
    j, t = jks._PinnedSecant(), tks._PinnedSecant()
    i = 1.8
    for k in range(12):
        g = -3.0 * (i - 1.7) + 0.01 * np.sin(k)
        ij, it_ = j.step(i, g), t.step(i, g)
        assert ij == it_
        np.testing.assert_array_equal(t.to_array(), j.to_array())
        i = ij
    t2 = tks._PinnedSecant()
    t2.restore(j.to_array())
    assert t2.step(i, 0.01) == j.step(i, 0.01)


def test_distribution_solve_matches_jax():
    """The outer loop on the distribution engine (the JAX suite's
    ``dist_method`` shape: the notebook run, act_T=1500, t_discard=300,
    tolerance 1e-3) at dist_count=150 on JAX's chain, two outer
    iterations: equal counts, the same trajectory, AFunc and r* within
    ``KS_TOL``."""
    (ja, je), (ta, te) = _configs(
        {}, dict(labor_ar=0.3, labor_sd=0.2, crra=1.0, act_T=1500,
                 t_discard=300, verbose=False, max_loops=2, tolerance=1e-3))
    ja, ta = ja.replace(agent_count=350), ta.replace(agent_count=350)
    chain = _jax_chain(jk.build_ks_calibration(ja, je), 1500, 0)
    kw = dict(seed=0, sim_method="distribution", dist_count=150,
              mrkv_hist=chain)
    jsol = jks.solve_ks_economy(ja, je, **kw)
    tsol = tks.solve_ks_economy(ta, te, device="cpu", dtype=F64, **kw)
    assert len(tsol.records) == len(jsol.records) == 2
    assert tsol.converged == jsol.converged
    np.testing.assert_allclose([r.intercept[0] for r in tsol.records],
                               [r.intercept[0] for r in jsol.records],
                               rtol=0, atol=KS_TOL["intercept"])
    np.testing.assert_allclose(_np(tsol.afunc.intercept),
                               np.asarray(jsol.afunc.intercept), rtol=0,
                               atol=KS_TOL["intercept"])
    np.testing.assert_array_equal(_np(tsol.afunc.slope), 0.0)
    assert tsol.equilibrium_r_pct == pytest.approx(
        jsol.equilibrium_r_pct, abs=KS_TOL["r_star_pct"])
    assert [r.egm_iters for r in tsol.records] == [
        r.egm_iters for r in jsol.records]
    np.testing.assert_allclose(_np(tsol.history.A_prev),
                               np.asarray(jsol.history.A_prev), rtol=0,
                               atol=1e-9)


def test_panel_engine_converges_short_horizon():
    """The panel engine's outer loop on the notebook run at a short
    horizon converges, r* in the JAX suite's band
    (``tests/test_ks_model.py``: 3.0-5.5 %)."""
    agent, econ = tc.notebook_run_configs()
    agent = agent.replace(agent_count=140)
    econ = econ.replace(act_T=1500, t_discard=300, verbose=False,
                        max_loops=12)
    sol = tks.solve_ks_economy(agent, econ, seed=0, device="cpu", dtype=F64)
    assert sol.converged and sol.status == 0
    assert 3.0 < sol.equilibrium_r_pct < 5.5
    assert len(sol.records) <= 12
    assert sol.records[-1].distance < econ.tolerance
    assert all(np.isfinite(r.r_squared).all() for r in sol.records)
