"""The port's Krusell-Smith checkpoint, resume, retry and interrupt guard,
on the CPU in float64, against the JAX package where the two share a file.

* The committed ``tests/data/checkpoints/ks_layout_v{1,2,3}.npz`` load
  through the port's migration tiers into JAX's fields.
* A KS checkpoint pair written by either package resumes in the other
  (the same npz layout, structure string and configuration fingerprint).
  A JAX-written pair has no EGM warm start, so that resume restarts the
  household solve cold, as the JAX package's own resume does: the
  continued rule agrees to 1e-8, not bit for bit.
* A torn pair resumes loudly; a healthy pair, and the preemption guard's
  flushed state, resume to the uninterrupted run bit for bit.
* ``retry_transient`` replays an injected transient fault and re-raises a
  fatal one; ``classify_transient`` reads CUDA's messages.

Configs are tiny (3 labor states, 10-point grids, 150 periods).
"""

import os
import signal
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aiyagari_hark_tpu.models.ks_solver as jks
import aiyagari_hark_tpu.utils.checkpoint as jck
import aiyagari_hark_tpu.utils.config as jc
import aiyagari_hark_tpu_torch.models.ks_solver as tks
import aiyagari_hark_tpu_torch.utils.checkpoint as tck
import aiyagari_hark_tpu_torch.utils.config as tc
from aiyagari_hark_tpu_torch.solver_health import (INTERRUPTED,
                                                   SolverDivergenceError)
from aiyagari_hark_tpu_torch.utils.resilience import (
    InjectedTransientError,
    Interrupted,
    RetryPolicy,
    TransientInjector,
    classify_transient,
    clear_interrupt,
    fire_preemption,
    interrupt_requested,
    preemption_guard,
    request_interrupt,
    retry_transient,
)
from aiyagari_hark_tpu_torch.utils.timing import (PhaseTimer,
                                                  read_records_jsonl,
                                                  write_records_jsonl)

torch.set_num_threads(1)
F64 = torch.float64
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "checkpoints")
AGENT = dict(labor_states=3, a_count=10, agent_count=40)
ECON = dict(labor_states=3, act_T=150, t_discard=30, verbose=False,
            tolerance=0.02, max_loops=3)
CHAIN = np.array([0] * 40 + [1] * 60 + [0] * 50, np.int64)
KWARGS = dict(seed=0, sim_method="distribution", dist_count=32,
              mrkv_hist=CHAIN)


def _port(econ_kw=None, **kw):
    econ = tc.EconomyConfig(**{**ECON, **(econ_kw or {})})
    return tks.solve_ks_economy(tc.AgentConfig(**AGENT), econ,
                                **{**KWARGS, **kw}, device="cpu", dtype=F64)


def _jax(econ_kw=None, **kw):
    econ = jc.EconomyConfig(**{**ECON, **(econ_kw or {})})
    return jks.solve_ks_economy(jc.AgentConfig(**AGENT), econ,
                                **{**KWARGS, **kw}, dtype=jnp.float64)


def _rule(sol):
    return np.concatenate([np.asarray(sol.afunc.intercept),
                           np.asarray(sol.afunc.slope)])


@pytest.fixture(scope="module")
def full_port():
    return _port()


@pytest.mark.parametrize("version", [1, 2, 3])
def test_committed_layouts_load_into_jax_fields(version):
    path = os.path.join(DATA, f"ks_layout_v{version}.npz")
    a, b = jck.load_ks_checkpoint(path), tck.load_ks_checkpoint(path)
    assert type(b).__name__ == "KSCheckpoint" and b._fields == a._fields
    for f in a._fields:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
    assert np.isinf(b.last_residual)


def test_structure_string_is_jax_treedef(tmp_path):
    """The port writes JAX's ``PyTreeDef`` repr for its checkpoint trees
    and loads JAX's sidecar by it."""
    import jax

    tree = (np.asarray(3, np.int64),
            tck.KSCheckpoint(*tck.ks_checkpoint_template()))
    assert tck.tree_structure(tree) == str(jax.tree_util.tree_structure(tree))
    path = str(tmp_path / "t.npz")
    tck.save_pytree(path, tree)
    back = jck.load_pytree(path, tree)
    assert int(back[0]) == 3
    with pytest.raises(ValueError):
        tck.load_pytree(path, (np.zeros(()),))


def test_fingerprints_equal_across_packages(tmp_path):
    pj = str(tmp_path / "j.npz")
    pt = str(tmp_path / "t.npz")
    _jax(econ_kw=dict(max_loops=1), checkpoint_path=pj)
    _port(econ_kw=dict(max_loops=1), checkpoint_path=pt)
    a, b = jck.load_ks_checkpoint(pj), tck.load_ks_checkpoint(pt)
    assert int(a.fingerprint) == int(b.fingerprint)
    np.testing.assert_allclose(b.intercept, a.intercept, rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.secant, a.secant, rtol=0, atol=1e-12)


def test_jax_checkpoint_resumes_in_port(tmp_path, full_port):
    ck = str(tmp_path / "ks.npz")
    _jax(econ_kw=dict(max_loops=2), checkpoint_path=ck)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        resumed = _port(checkpoint_path=ck)
    # a matched pair: no approximate-resume warning
    assert not [w for w in caught if "approximate" in str(w.message)]
    assert [r.iteration for r in resumed.records] == [2]
    np.testing.assert_allclose(_rule(resumed), _rule(full_port), rtol=0,
                               atol=1e-8)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    ck = str(tmp_path / "ks.npz")
    _port(econ_kw=dict(max_loops=2), checkpoint_path=ck)
    assert os.path.exists(ck + ".dist.npz") and os.path.exists(
        ck + ".policy.npz")
    resumed = _jax(checkpoint_path=ck)
    assert [r.iteration for r in resumed.records] == [2]
    np.testing.assert_allclose(_rule(resumed), _rule(_jax()), rtol=0,
                               atol=1e-8)


def test_matched_pair_resumes_bitwise(tmp_path, full_port):
    ck = str(tmp_path / "ks.npz")
    _port(econ_kw=dict(max_loops=2), checkpoint_path=ck)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        resumed = _port(checkpoint_path=ck)
    assert not [w for w in caught if "approximate" in str(w.message)]
    np.testing.assert_array_equal(_rule(resumed), _rule(full_port))
    assert torch.equal(resumed.history.A_prev, full_port.history.A_prev)
    assert torch.equal(resumed.final_panel.dist, full_port.final_panel.dist)


def _bump_tag(path, delta=7):
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["leaf_000000"] = arrays["leaf_000000"] + delta
    np.savez(path, **arrays)


def test_torn_pair_resumes_loudly(tmp_path):
    """(old checkpoint, newer sidecar): the documented loud approximate
    resume; a checkpoint without its sidecar warns the same way; a
    mismatched checkpoint is refused."""
    ck = str(tmp_path / "ks.npz")
    _port(econ_kw=dict(max_loops=2), checkpoint_path=ck)
    tag0 = int(tck.load_ks_checkpoint(ck).iteration)
    _bump_tag(ck + ".dist.npz")
    with pytest.warns(UserWarning, match="interrupted between the two "
                                         "writes"):
        torn = _port(checkpoint_path=ck)
    assert all(r.iteration >= tag0 for r in torn.records)
    assert np.isfinite(_rule(torn)).all()
    os.remove(ck + ".dist.npz")
    with pytest.warns(UserWarning, match="resuming from a fresh initial "
                                         "distribution"):
        _port(checkpoint_path=ck)
    with pytest.raises(tck.CheckpointMismatchError):
        _port(checkpoint_path=ck, seed=5)


def test_preemption_flushes_checkpoint_and_resumes_bitwise(tmp_path,
                                                           full_port):
    ck = str(tmp_path / "ks.npz")
    try:
        request_interrupt()
        with pytest.raises(Interrupted) as ei:
            _port(checkpoint_path=ck)
    finally:
        clear_interrupt()
    assert ei.value.resume_path == ck and ei.value.status == INTERRUPTED
    assert ei.value.progress["iteration"] == 1
    assert int(tck.load_ks_checkpoint(ck).iteration) == 1
    resumed = _port(checkpoint_path=ck)
    assert [r.iteration for r in resumed.records] == list(
        range(1, 1 + len(resumed.records)))
    np.testing.assert_array_equal(_rule(resumed), _rule(full_port))


def test_preemption_guard_signal_and_escalation():
    with preemption_guard():
        assert not interrupt_requested()
        fire_preemption("signal")
        assert interrupt_requested()
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGTERM)
    assert not interrupt_requested()       # the outermost exit clears


def _spy(max_attempts):
    slept = []
    return RetryPolicy(max_attempts=max_attempts, sleep=slept.append), slept


def test_retry_transient_replays_and_reraises():
    policy, slept = _spy(3)
    calls = []
    assert retry_transient(lambda: calls.append(1) or "ok", policy,
                           inject=TransientInjector(times=2)) == "ok"
    assert len(calls) == 1 and slept == [policy.delay(0), policy.delay(1)]
    policy, slept = _spy(2)
    with pytest.raises(InjectedTransientError):
        retry_transient(lambda: "never", policy,
                        inject=TransientInjector(times=5))
    assert slept == [policy.delay(0)]

    def fatal(exc):
        def f():
            raise exc
        return f

    for exc in (SolverDivergenceError("NONFINITE", status=3),
                RuntimeError("CUDA error: an illegal memory access was "
                             "encountered"),
                ValueError("bad argument")):
        policy, slept = _spy(5)
        with pytest.raises(type(exc)):
            retry_transient(fatal(exc), policy)
        assert slept == []


def test_classify_transient_cuda_rules():
    yes = ("CUDA error: all CUDA-capable devices are busy or unavailable",
           "CUDA error: the launch timed out and was terminated",
           "CUDA error: system not yet initialized",
           "connection reset by peer")
    no = ("CUDA out of memory. Tried to allocate 2.00 GiB",
          "CUDA error: an illegal memory access was encountered",
          "CUDA error: device-side assert triggered",
          "CUDA error: unspecified launch failure",
          "CUDA error: uncorrectable ECC error encountered",
          "UNAVAILABLE: socket closed",          # the XLA/gRPC codes are not
          "DEADLINE_EXCEEDED: 60s",              # CUDA's
          "assertion failed")
    assert all(classify_transient(RuntimeError(m)) for m in yes)
    assert not any(classify_transient(RuntimeError(m)) for m in no)
    assert classify_transient(InjectedTransientError("x"))
    assert classify_transient(ConnectionError("peer"))
    assert not classify_transient(ValueError("busy or unavailable"))
    assert not classify_transient(KeyboardInterrupt())
    assert not classify_transient(Interrupted("shutdown"))
    assert not classify_transient(SolverDivergenceError("nan", status=3))


def test_solve_retries_a_transient_fault_in_place(monkeypatch, full_port):
    """A transient fault raised inside the household solve is replayed
    under the retry policy and the run ends on the same bits."""
    real = tks.solve_ks_household
    inject = TransientInjector(at_call=1, times=1)

    def flaky(*a, **k):
        inject.before_call()
        return real(*a, **k)

    monkeypatch.setattr(tks, "solve_ks_household", flaky)
    policy, slept = _spy(3)
    with pytest.warns(UserWarning, match="transient fault"):
        sol = _port(retry=policy)
    assert slept == [policy.delay(0)]
    np.testing.assert_array_equal(_rule(sol), _rule(full_port))


def test_records_timer_and_atomic_writers(tmp_path, full_port):
    path = str(tmp_path / "rec.jsonl")
    write_records_jsonl(path, full_port.records)
    write_records_jsonl(path, full_port.records[:1], append=True)
    with open(path, "ab") as f:
        f.write(b'{"torn": ')
    with pytest.warns(UserWarning, match="skipped 1"):
        back = read_records_jsonl(path)
    assert len(back) == len(full_port.records) + 1
    assert back[0]["iteration"] == 0
    timer = PhaseTimer()
    _port(econ_kw=dict(max_loops=1), timer=timer)
    assert set(timer.report()) == {"solve", "simulate", "regress"}
    assert "total" in timer.summary()
    tck.atomic_write_json(str(tmp_path / "a.json"), {"x": 1})
    tck.arm_disk_fault("atomic_write_json", count=1)
    try:
        with pytest.raises(OSError):
            tck.atomic_write_json(str(tmp_path / "a.json"), {"x": 2})
    finally:
        tck.disarm_disk_faults()
    with open(tmp_path / "a.json") as f:
        assert f.read().strip() == '{\n  "x": 1\n}'
