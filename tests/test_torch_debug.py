"""The port's sanitizers (``utils/debug.py``) against the JAX package's, on
the CPU in float64.  Size: ``tests/test_aux.py``'s (3 labor states, 8
assets, 16 histogram points).

Held: a NaN made inside a loop raises in both packages on the same input,
the port's ``FloatingPointError`` naming the operator that made it; an
Inf from a division by zero raises in the port, with the operator and
the output's shape; a clean call returns the same bits with the check on
as off, and JAX's value;
``nan_guard`` checks only inside its block; and the validators accept
and reject the same policies and histograms as JAX's, with the same
messages.
"""

import numpy as np
import pytest
import torch

import aiyagari_hark_tpu.models.household as jh
import aiyagari_hark_tpu.utils.debug as jd
import aiyagari_hark_tpu_torch.models.household as th
import aiyagari_hark_tpu_torch.utils.debug as td
from aiyagari_hark_tpu_torch.carry import dist_from_numpy, policy_from_numpy

torch.set_num_threads(1)
SIZE = dict(labor_states=3, a_count=8, dist_count=16)


def _loop_port(x, shift, n=5):
    for _ in range(n):
        x = torch.log(x - shift)
    return x


def _loop_jax(x, shift, n=5):
    import jax

    return jax.lax.fori_loop(0, n, lambda i, v: jax.numpy.log(v - shift), x)


def test_checked_call_catches_nan_inside_a_loop_as_jax_does():
    """log of a negative number at the loop's second trip: both raise,
    the port naming aten.log."""
    import jax.numpy as jnp

    with pytest.raises(Exception, match="nan"):
        jd.checked_call(_loop_jax, jnp.asarray(2.0), 1.5)
    with pytest.raises(FloatingPointError, match=r"nan generated by "
                       r"aten\.log"):
        td.checked_call(_loop_port, torch.tensor(2.0, dtype=torch.float64),
                        1.5)
    # unchecked, the NaN propagates silently through the remaining trips
    assert torch.isnan(_loop_port(torch.tensor(2.0, dtype=torch.float64),
                                  1.5))


def test_checked_call_catches_inf_from_division_by_zero():
    x = torch.tensor([1.0, 0.0, 2.0], dtype=torch.float64)
    with pytest.raises(FloatingPointError, match=r"inf generated by "
                       r"aten\.div.*\(output shape \(3,\)\)"):
        td.checked_call(lambda v: torch.ones_like(v) / v, x)


@pytest.mark.parametrize("x0", [4.0, 9.0, 0.25])
def test_clean_checked_call_returns_the_same_bits_as_jax(x0):
    import jax.numpy as jnp

    def port(v):
        return torch.sqrt(v) * 2.0 + torch.exp(-v)

    def jax_fn(v):
        return jnp.sqrt(v) * 2.0 + jnp.exp(-v)

    x = torch.tensor(x0, dtype=torch.float64)
    out = td.checked_call(port, x)
    assert out.numpy().tobytes() == port(x).numpy().tobytes()
    assert float(out) == pytest.approx(
        float(jd.checked_call(jax_fn, jnp.asarray(x0))), rel=1e-15)


def test_nan_guard_checks_only_inside_its_block():
    x = torch.tensor([-1.0], dtype=torch.float64)
    with pytest.raises(FloatingPointError, match="aten.sqrt"):
        with td.nan_guard():
            torch.sqrt(x)
    assert torch.isnan(torch.sqrt(x)).all()      # the mode is off again
    with td.nan_guard():                         # finite work passes
        y = torch.sqrt(-x)
    assert float(y) == 1.0


@pytest.fixture(scope="module")
def base():
    jm = jh.build_simple_model(**SIZE)
    tm = th.build_simple_model(**SIZE, dtype=torch.float64, device="cpu")
    jpol = jh.initial_policy(jm)
    tpol = th.initial_policy(tm)
    np.testing.assert_array_equal(tpol.m_knots.numpy(),
                                  np.asarray(jpol.m_knots))
    np.testing.assert_array_equal(tpol.c_knots.numpy(),
                                  np.asarray(jpol.c_knots))
    return (np.asarray(jpol.m_knots), np.asarray(jpol.c_knots),
            np.asarray(jh.initial_distribution(jm)))


def _outcome(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


def _policy_case(name, m, c):
    m, c = m.copy(), c.copy()
    if name == "nan_c":
        c[0, 3] = np.nan
    elif name == "inf_m":
        m[1, 2] = np.inf
    elif name == "crossed":
        m[0, 3] = 0.0
    elif name == "flat":
        m[2, 4] = m[2, 3]
    elif name == "non_positive_c":
        c[1, 0] = 0.0
    return m, c


@pytest.mark.parametrize("case,expect", [
    ("sane", None), ("nan_c", "non-finite"), ("inf_m", "non-finite"),
    ("crossed", "non-increasing"), ("flat", "non-increasing"),
    ("non_positive_c", "non-positive")])
def test_validate_policy_matches_jax(base, case, expect):
    import jax.numpy as jnp

    m, c = _policy_case(case, *base[:2])
    want = _outcome(jd.validate_policy,
                    jh.HouseholdPolicy(jnp.asarray(m), jnp.asarray(c)))
    got = _outcome(td.validate_policy, policy_from_numpy(m, c,
                                                         device="cpu"))
    assert got == want
    assert (got is None) if expect is None else (expect in got)


@pytest.mark.parametrize("case,expect", [
    ("sane", None), ("half", "total mass"), ("negative", "negative mass"),
    ("nan", "non-finite"), ("tiny_negative", None)])
def test_validate_distribution_matches_jax(base, case, expect):
    import jax.numpy as jnp

    d = base[2].copy()
    if case == "half":
        d = d * 0.5
    elif case == "negative":
        d[0, 0] += 0.5
        d[1, 0] -= 0.5
    elif case == "nan":
        d[3, 1] = np.nan
    elif case == "tiny_negative":       # inside atol: accepted by both
        d[5, 0] = -1e-10
    want = _outcome(jd.validate_distribution, jnp.asarray(d))
    got = _outcome(td.validate_distribution,
                   dist_from_numpy(d, device="cpu"))
    assert got == want
    assert (got is None) if expect is None else (expect in got)
