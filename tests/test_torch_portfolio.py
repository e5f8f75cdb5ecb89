"""The port's two-asset portfolio economy against the JAX reference, on the
CPU in float64.

Size: ``tests/test_portfolio.py``'s ``GE_KW`` (3 labor states, 16 assets,
5 return draws, 15 shares, 120 histogram points); the model is JAX's,
carried across bit for bit (``carry.portfolio_model_from_numpy``), and
the port's own build is held to it.  Held:

* ``lognormal_risky_returns`` and ``_optimal_share`` bitwise;
* one ``egm_step_portfolio`` within 1e-13 (the two packages contract the
  FOC and the expectation in their own orders), the share bitwise;
* ``solve_portfolio_household`` with JAX's step count, knots within
  1e-12;
* ``portfolio_wealth_transition`` bitwise (indices, weights, shares);
* one push-forward within 1e-15 relative to the largest mass: the port
  sums each target's contributions by a pairwise tree in JAX's source
  order, JAX left to right (``models.portfolio.PortfolioPush``); run
  twice, the port's push is bitwise itself; its tree, rebuilt in NumPy,
  as deep as the longest run needs, and bitwise the worst-case tree;
* the stationary distribution with JAX's step count, within 1e-13;
* the equilibrium with ``max_bisect`` capped at 8 (and uncapped): JAX's
  trips, r* within 1e-10, capital within 1e-9 relative; the port's EGM
  step total equal to a replay of JAX's loop by its own pieces, its
  distribution steps within ``tests/test_torch_equilibrium.py``'s 0.2 %;
  the empty bracket's ``ValueError``.
"""

import numpy as np
import pytest
import torch

import aiyagari_hark_tpu.models.portfolio as jp
import aiyagari_hark_tpu_torch.models.portfolio as tp
from aiyagari_hark_tpu_torch import carry

torch.set_num_threads(1)
F64 = torch.float64
GE_KW = dict(labor_states=3, a_count=16, share_count=15, risky_count=5,
             dist_count=120)
RISK = dict(risky_mean=1.0, risky_std=0.15, labor_ar=0.3)
R_FREE, WAGE, BETA, CRRA = 1.02, 1.0, 0.96, 5.0
GE = dict(cap_share=0.36, depr_fac=0.08, premium=0.04)


@pytest.fixture(scope="module")
def models():
    jm = jp.build_portfolio_model(**RISK, **GE_KW)
    tm = carry.portfolio_model_from_numpy([np.asarray(f) for f in jm],
                                          device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def household(models):
    import jax

    jm, tm = models
    pj, itj, _ = jax.jit(lambda: jp.solve_portfolio_household(
        R_FREE, WAGE, jm, BETA, CRRA))()
    pt, itt, diff = tp.solve_portfolio_household(R_FREE, WAGE, tm, BETA,
                                                 CRRA)
    return pj, int(itj), pt, itt, float(diff)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_build_and_returns_match_jax(models):
    jm, _ = models
    own = tp.build_portfolio_model(**RISK, **GE_KW, dtype=F64, device="cpu")
    for name, a, b in zip(jm._fields, jm, own):
        # the Tauchen pieces are the port's own (1 ulp apart, as in
        # build_simple_model); the rest is built bit for bit
        if name in ("labor_levels", "transition", "labor_stationary"):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-15,
                                       atol=1e-15, err_msg=name)
        else:
            assert np.array_equal(_np(b), np.asarray(a)), name
    for mean, std, n in ((1.08, 0.2, 7), (1.0, 1e-5, 5), (1.04, 0.3, 21)):
        vj, pj = jp.lognormal_risky_returns(mean, std, n)
        vt, pt = tp.lognormal_risky_returns(mean, std, n, dtype=F64,
                                            device="cpu")
        assert np.array_equal(_np(vt), np.asarray(vj))
        assert np.array_equal(_np(pt), np.asarray(pj))
    f32 = tp.build_portfolio_model(**GE_KW, dtype=torch.float32,
                                   device="cpu")
    import jax.numpy as jnp

    assert np.array_equal(_np(f32.share_grid), np.asarray(
        jnp.linspace(0.0, 1.0, 15, dtype=jnp.float32)))


def test_optimal_share_matches_jax():
    rng = np.random.default_rng(0)
    grid = np.linspace(0.0, 1.0, 11)
    # decreasing rows with interior crossings, corners, flat rows and ties
    slopes = rng.uniform(0.1, 3.0, size=(40, 1))
    zeros = rng.uniform(-0.3, 1.3, size=(40, 1))
    gap = slopes * (zeros - grid[None, :])
    gap[3] = 0.0
    gap[4, 5:] = 0.0
    gap = np.concatenate([gap, np.stack([0.45 - grid, -1.0 - grid,
                                         2.0 - grid])])
    out_j = np.asarray(jp._optimal_share(gap, grid))
    out_t = _np(tp._optimal_share(torch.as_tensor(gap), torch.as_tensor(
        grid)))
    assert np.array_equal(out_t, out_j)
    assert out_t[-3] == pytest.approx(0.45) and out_t[-2] == 0.0
    assert out_t[-1] == 1.0


def test_egm_step_matches_jax(models):
    jm, tm = models
    pj = jp.egm_step_portfolio(jp.initial_portfolio_policy(jm), R_FREE, WAGE,
                               jm, BETA, CRRA)
    pt = tp.egm_step_portfolio(tp.initial_portfolio_policy(tm), R_FREE, WAGE,
                               tm, BETA, CRRA)
    for name, a, b in zip(pj._fields, pj, pt):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-13,
                                   atol=0, err_msg=name)
    assert np.array_equal(_np(pt.share), np.asarray(pj.share))


def test_household_fixed_point_matches_jax(household, models):
    pj, itj, pt, itt, diff = household
    assert itt == itj and diff <= 1e-6
    for name, a, b in zip(pj._fields, pj, pt):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-12,
                                   atol=1e-14, err_msg=name)
    # the readouts: the share at a wealth level, per state and for one
    _, tm = models
    jm = models[0]
    np.testing.assert_allclose(_np(tp.share_at(pt, 3.0, tm)), np.asarray(
        jp.share_at(pj, 3.0, jm)), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(_np(tp.share_at(pt, 3.0, tm, state_idx=1)),
                               np.asarray(jp.share_at(pj, 3.0, jm,
                                                      state_idx=1)),
                               rtol=1e-12, atol=1e-14)
    cp = tp.consumption_policy(pt)
    assert cp.m_knots is pt.m_knots and cp.c_knots is pt.c_knots


def test_transition_push_and_distribution_match_jax(household, models):
    import jax
    import jax.numpy as jnp

    jm, tm = models
    pj, _, _, _, _ = household
    pol = carry.portfolio_policy_from_numpy(*(np.asarray(f) for f in pj),
                                            device="cpu")
    trj = jp.portfolio_wealth_transition(pj, R_FREE, WAGE, jm)
    trt = tp.portfolio_wealth_transition(pol, R_FREE, WAGE, tm)
    for name, a, b in zip(trj._fields, trj, trt):
        assert np.array_equal(_np(b), np.asarray(a)), name

    rng = np.random.default_rng(1)
    d = rng.random((120, 3))
    d /= d.sum()
    out_j = np.asarray(jp._push_forward_portfolio(jnp.asarray(d), trj, jm))
    push = tp.portfolio_push(trt)
    out_t = _np(tp._push_forward_portfolio(torch.as_tensor(d), trt, tm,
                                           push))
    assert np.abs(out_t - out_j).max() <= 1e-15 * np.abs(out_j).max()
    # a target with at most three contributions is JAX's sum bit for bit
    assert (out_t == out_j).mean() > 0.2
    again = _np(tp._push_forward_portfolio(torch.as_tensor(d), trt, tm))
    assert again.tobytes() == out_t.tobytes()
    assert out_t.sum() == pytest.approx(1.0, abs=1e-14)

    dj, itj, _, sj = jax.jit(lambda: jp.stationary_portfolio_wealth(
        pj, R_FREE, WAGE, jm))()
    dt, itt, diff, st = tp.stationary_portfolio_wealth(pol, R_FREE, WAGE, tm)
    assert int(itt) == int(itj) and int(st) == int(sj) == 0
    np.testing.assert_allclose(_np(dt), np.asarray(dj), rtol=0, atol=1e-13)


def test_push_tree_is_as_deep_as_the_longest_run(household, models):
    """The tree's levels, rebuilt in NumPy from the transition: as many as
    the longest run needs, each level's mask the same, and the levels a
    worst-case tree of 2 D N K shares would add hold no pair, so the push
    is the worst-case tree's bit for bit."""
    _, tm = models
    pol = carry.portfolio_policy_from_numpy(
        *(np.asarray(f) for f in household[0]), device="cpu")
    trt = tp.portfolio_wealth_transition(pol, R_FREE, WAGE, tm)
    push = tp.portfolio_push(trt)
    d_size, n, k, n_next = trt.idx.shape
    per_col = d_size * n * k
    idx = _np(trt.idx).transpose(3, 0, 1, 2).reshape(n_next, per_col)
    col = (np.arange(n_next) * d_size)[:, None]
    target = np.stack([idx + col, idx + 1 + col], axis=1).ravel()
    target = target[np.argsort(target, kind="stable")]
    m = target.size
    pos = np.arange(m)
    start = np.maximum.accumulate(
        np.where(np.r_[True, target[1:] != target[:-1]], pos, 0))
    rank, length = pos - start, np.bincount(target)[target]
    assert len(push.masks) == int(np.ceil(np.log2(length.max())))
    assert length.max() > 8            # the constrained sources pile up
    deep, step = [], 1
    while step < 2 * per_col:
        deep.append(((rank % (2 * step)) == 0)[:m - step]
                    & (rank[:m - step] + step < length[:m - step]))
        step *= 2
    for j, mask in enumerate(push.masks):
        assert np.array_equal(_np(mask), deep[j]), j
    assert not any(mask.any() for mask in deep[len(push.masks):])
    worst = push._replace(masks=tuple(torch.as_tensor(x) for x in deep))
    rng = np.random.default_rng(2)
    d = torch.as_tensor(rng.random((d_size, n)))
    d /= d.sum()
    assert (_np(tp._push_forward_portfolio(d, trt, tm, push)).tobytes()
            == _np(tp._push_forward_portfolio(d, trt, tm, worst)).tobytes())


def _replay_steps(jm, max_bisect):
    """JAX's bisection replayed by its own pieces, with the inner step
    counts ``solve_portfolio_equilibrium`` does not return (the loop of
    ``scripts/make_torch_portfolio_golden.py``)."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    from make_torch_portfolio_golden import replay

    return replay(jm, BETA, CRRA, max_bisect=max_bisect, **GE)


@pytest.mark.parametrize("max_bisect", [8, 40])
def test_equilibrium_matches_jax(models, max_bisect):
    import jax

    jm, tm = models
    ej = jax.jit(lambda: jp.solve_portfolio_equilibrium(
        jm, BETA, CRRA, max_bisect=max_bisect, **GE))()
    et = tp.solve_portfolio_equilibrium(tm, BETA, CRRA,
                                        max_bisect=max_bisect, **GE)
    assert int(et.bisect_iters) == int(ej.bisect_iters)
    assert abs(float(et.r_star) - float(ej.r_star)) <= 1e-10
    assert float(et.r_free) == pytest.approx(float(et.r_star) - 0.04,
                                             abs=1e-12)
    for name in ("capital", "total_assets", "risky_share_mean", "wage",
                 "labor", "saving_rate"):
        assert float(getattr(et, name)) == pytest.approx(
            float(getattr(ej, name)), rel=1e-9), name
    np.testing.assert_allclose(_np(et.distribution),
                               np.asarray(ej.distribution), atol=1e-10)
    # capped: the bracket is still wide (MAX_ITER); uncapped: converged
    assert int(et.status) == (2 if max_bisect == 8 else 0)
    r_rep, trips, egm, dist, _, _ = _replay_steps(jm, max_bisect)
    assert trips == int(ej.bisect_iters) and r_rep == float(ej.r_star)
    assert et.egm_iters == egm
    # the Aitken sums' order (ROADMAP Queue 3 item 4): the bound of
    # tests/test_torch_equilibrium.py
    assert abs(et.dist_iters - dist) <= 2e-3 * dist


def test_empty_bracket_raises(models):
    _, tm = models
    with pytest.raises(ValueError, match="empty bisection bracket"):
        tp.solve_portfolio_equilibrium(tm, 0.99, 2.0, cap_share=0.36,
                                       depr_fac=0.025, premium=0.04)
    with pytest.raises(ValueError, match="dist_grid is required"):
        tp.portfolio_wealth_transition(
            tp.initial_portfolio_policy(tm), R_FREE, WAGE,
            tm._replace(dist_grid=None))
