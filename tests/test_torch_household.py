"""The port's household fixed points against the JAX reference.

Small model (``labor_states=3, a_count=12, dist_count=48``, the JAX kernel
parity tests' size), f64, on the CPU.  Both packages start from
bit-identical inputs: the JAX model's arrays are carried across with
``carry.model_from_numpy``.  Step counts and statuses must be equal; values
agree to ``rtol=1e-9, atol=1e-8`` (the JAX kernel-parity tolerance: the
two engines round a few reductions in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aiyagari_hark_tpu.models.household as jh
import aiyagari_hark_tpu_torch.models.household as th
from aiyagari_hark_tpu_torch.carry import (dist_from_numpy, model_from_numpy,
                                           policy_from_numpy)

torch.set_num_threads(1)
TOL_KW = dict(rtol=1e-9, atol=1e-8)
SMALL = dict(labor_states=3, a_count=12, dist_count=48)
PRICES = [(1.02, 1.0, 2.0), (1.035, 1.2, 1.0), (1.01, 0.9, 5.0)]


@pytest.fixture(scope="module")
def models():
    jm = jh.build_simple_model(**SMALL)
    return jm, model_from_numpy([np.asarray(f) for f in jm], device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("ar,sd", [(0.6, 0.2), (0.9, 0.4), (0.0, 0.2)])
def test_build_simple_model_matches_jax(ar, sd):
    jm = jh.build_simple_model(labor_ar=ar, labor_sd=sd, **SMALL)
    tm = th.build_simple_model(labor_ar=ar, labor_sd=sd, dtype=torch.float64,
                               device="cpu", **SMALL)
    for f in th.SimpleModel._fields:
        np.testing.assert_allclose(_np(getattr(tm, f)),
                                   np.asarray(getattr(jm, f)), rtol=0,
                                   atol=1e-13, err_msg=f)


def test_carry_is_bit_identical(models):
    jm, tm = models
    for f in th.SimpleModel._fields:
        np.testing.assert_array_equal(_np(getattr(tm, f)),
                                      np.asarray(getattr(jm, f)))
    p = jh.initial_policy(jm)
    tp = policy_from_numpy(np.asarray(p.m_knots), np.asarray(p.c_knots),
                           device="cpu")
    np.testing.assert_array_equal(_np(tp.c_knots), np.asarray(p.c_knots))
    d = dist_from_numpy(np.asarray(jh.initial_distribution(jm)), device="cpu")
    assert d.dtype == torch.float64 and tuple(d.shape) == (48, 3)


def test_initial_objects_match_jax(models):
    jm, tm = models
    jp, tp = jh.initial_policy(jm), th.initial_policy(tm)
    np.testing.assert_array_equal(_np(tp.m_knots), np.asarray(jp.m_knots))
    np.testing.assert_array_equal(_np(tp.c_knots), np.asarray(jp.c_knots))
    np.testing.assert_array_equal(_np(th.initial_distribution(tm)),
                                  np.asarray(jh.initial_distribution(jm)))
    assert float(th.aggregate_labor(tm)) == pytest.approx(
        float(jh.aggregate_labor(jm)), abs=1e-15)


@pytest.mark.parametrize("R,W,crra", PRICES)
def test_egm_step_matches_jax(models, R, W, crra):
    jm, tm = models
    jp = jh.initial_policy(jm)
    tp = th.initial_policy(tm)
    for _ in range(3):   # a few steps away from the identity guess
        jp = jh.egm_step(jp, R, W, jm, 0.96, crra)
        tp = th.egm_step(tp, R, W, tm, 0.96, crra)
        np.testing.assert_allclose(_np(tp.m_knots), np.asarray(jp.m_knots),
                                   rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(_np(tp.c_knots), np.asarray(jp.c_knots),
                                   rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("R,W,crra", PRICES)
def test_solve_household_matches_jax(models, R, W, crra):
    jm, tm = models
    jp, jit, jdiff, jst = jh.solve_household(R, W, jm, 0.96, crra)
    tp, tit, tdiff, tst = th.solve_household(R, W, tm, 0.96, crra)
    assert int(tit) == int(jit) and int(tst) == int(jst) == 0
    np.testing.assert_allclose(_np(tp.c_knots), np.asarray(jp.c_knots),
                               **TOL_KW)
    np.testing.assert_allclose(_np(tp.m_knots), np.asarray(jp.m_knots),
                               **TOL_KW)
    np.testing.assert_allclose(float(tdiff), float(jdiff), rtol=1e-6)


def test_batched_solve_household_equals_single_lanes(models):
    """Lanes of a batch keep their own step counts: the frozen-lane
    masking reproduces each cell solved alone, bit for bit."""
    _, tm = models
    batch = th.stack_models([tm, tm, tm])
    R = torch.tensor([p[0] for p in PRICES], dtype=torch.float64)
    W = torch.tensor([p[1] for p in PRICES], dtype=torch.float64)
    crra = torch.tensor([p[2] for p in PRICES], dtype=torch.float64)
    bp, bit, bdiff, bst = th.solve_household(R, W, batch, 0.96, crra)
    for c, (r, w, s) in enumerate(PRICES):
        p, it, diff, st = th.solve_household(r, w, tm, 0.96, s)
        assert int(bit[c]) == int(it) and int(bst[c]) == int(st)
        assert torch.equal(bp.c_knots[c], p.c_knots)
        assert torch.equal(bdiff[c], diff)


@pytest.mark.parametrize("R,W,crra", PRICES)
def test_wealth_transition_and_operators_match_jax(models, R, W, crra):
    jm, tm = models
    jp, _, _, _ = jh.solve_household(R, W, jm, 0.96, crra)
    tp = policy_from_numpy(np.asarray(jp.m_knots), np.asarray(jp.c_knots),
                           device="cpu")
    jt = jh.wealth_transition(jp, R, W, jm)
    tt = th.wealth_transition(tp, R, W, tm)
    np.testing.assert_array_equal(_np(tt.idx), np.asarray(jt.idx))
    np.testing.assert_allclose(_np(tt.weight), np.asarray(jt.weight),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(_np(tt.a_next), np.asarray(jt.a_next),
                               rtol=0, atol=1e-13)
    # carry the JAX lottery across so the operators see identical inputs
    jt_t = th.WealthTransition(torch.tensor(np.asarray(jt.idx)),
                               torch.tensor(np.asarray(jt.weight)),
                               torch.tensor(np.asarray(jt.a_next)))
    np.testing.assert_array_equal(
        _np(th.dense_wealth_operator(jt_t, 48)),
        np.asarray(jh.dense_wealth_operator(jt, 48)))
    rng = np.random.default_rng(7)
    d = rng.random((48, 3))
    d /= d.sum()
    out = th._push_forward(torch.tensor(d), jt_t, tm.transition)
    ref = jh._push_forward(jnp.asarray(d), jt, jm.transition)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=1e-15)
    # batched lottery: lanes as one-cell calls
    bt = th.wealth_transition(
        th.HouseholdPolicy(tp.m_knots[None].repeat(2, 1, 1),
                           tp.c_knots[None].repeat(2, 1, 1)),
        torch.tensor([R, R], dtype=torch.float64),
        torch.tensor([W, W], dtype=torch.float64),
        th.stack_models([tm, tm]))
    assert torch.equal(bt.idx[1], tt.idx) and torch.equal(bt.weight[0],
                                                          tt.weight)


@pytest.mark.parametrize("R,W,crra", PRICES)
def test_stationary_wealth_matches_jax(models, R, W, crra):
    jm, tm = models
    jp, _, _, _ = jh.solve_household(R, W, jm, 0.96, crra)
    tp = policy_from_numpy(np.asarray(jp.m_knots), np.asarray(jp.c_knots),
                           device="cpu")
    jd, jit, jdiff, jst = jh.stationary_wealth(jp, R, W, jm)
    td, tit, tdiff, tst = th.stationary_wealth(tp, R, W, tm)
    assert int(tit) == int(jit) and int(tst) == int(jst)
    np.testing.assert_allclose(_np(td), np.asarray(jd), **TOL_KW)
    assert float(td.sum()) == pytest.approx(1.0, abs=1e-12)
    np.testing.assert_allclose(float(th.aggregate_capital(td, tm)),
                               float(jh.aggregate_capital(jd, jm)),
                               rtol=1e-9)


def test_stationary_wealth_warm_start_and_no_acceleration(models):
    jm, tm = models
    jp, _, _, _ = jh.solve_household(1.02, 1.0, jm, 0.96, 2.0)
    tp = policy_from_numpy(np.asarray(jp.m_knots), np.asarray(jp.c_knots),
                           device="cpu")
    rng = np.random.default_rng(8)
    d0 = rng.random((48, 3))
    d0 /= d0.sum()
    for kw in (dict(accel_every=0, max_iter=300), dict(accel_every=16)):
        jd, jit, _, jst = jh.stationary_wealth(
            jp, 1.02, 1.0, jm, init_dist=jnp.asarray(d0), method="scatter",
            **kw)
        td, tit, _, tst = th.stationary_wealth(
            tp, 1.02, 1.0, tm, init_dist=torch.tensor(d0), **kw)
        assert int(tit) == int(jit) and int(tst) == int(jst)
        np.testing.assert_allclose(_np(td), np.asarray(jd), **TOL_KW)


def test_accelerated_loops_flag_a_nonfinite_step():
    """A NaN step exits at once as NONFINITE in both loops."""
    p0 = th.HouseholdPolicy(torch.ones(2, 3, 4).cumsum(-1),
                            torch.ones(2, 3, 4))

    def poisoned(p):
        return th.HouseholdPolicy(p.m_knots * float("nan"), p.c_knots)

    _, it, diff, st = th.accelerated_policy_fixed_point(poisoned, p0, 1e-6,
                                                        50)
    assert it.tolist() == [1, 1] and st.tolist() == [3, 3]
    d0 = torch.full((2, 5, 3), 1.0 / 15, dtype=torch.float64)
    _, it, best, st = th.accelerated_distribution_fixed_point(
        lambda d: d * float("nan"), d0, 1e-10, 50)
    assert it.tolist() == [1, 1] and st.tolist() == [3, 3]


@pytest.mark.parametrize("kw,item", [
    (dict(precision="mixed"), "item 6"), (dict(grid="compact"), "item 7"),
    (dict(kernel="fused", precision="mixed"), "item 8"),
    (dict(state="sharded"), "item 13")])
def test_unported_policies_raise_naming_their_roadmap_item(models, kw, item):
    _, tm = models
    with pytest.raises(NotImplementedError, match=item):
        th.solve_household(1.02, 1.0, tm, 0.96, 2.0, **kw)
