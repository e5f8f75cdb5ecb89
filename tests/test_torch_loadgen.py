"""The port's load harness against the JAX package's.

``serve.loadgen`` draws seeded open-loop traffic (``generate_arrivals``)
and per-worker fleet traces (``generate_fleet_arrivals``), and replays a
trace against a manual-clock service (``run_load``), classifying every
arrival into a typed outcome fingerprinted by ``LoadReport.digest``.  The
traces are host code and must be JAX's draw for draw; the replay solves
on the port's device (the CPU here), and under a pinned
``AdmissionPolicy.est_batch_s`` every admission, shedding, deadline and
degrade decision reads only the clock and the seeded streams, so the
port's digest and outcome counts must be JAX's too.  The spec is the JAX
package's ``tests/test_loadgen.py`` spec, in float64 in both packages.
"""

import pytest
import torch

import aiyagari_hark_tpu.serve as jserve
import aiyagari_hark_tpu_torch.serve as tserve

torch.set_num_threads(1)

KW = dict(a_count=10, dist_count=32, labor_states=3, r_tol=1e-4,
          max_bisect=16, dtype="float64")
CELLS = tuple((s, r, sd) for sd in (0.2, 0.3)
              for s in (1.0, 3.0) for r in (0.0, 0.3, 0.6, 0.9))
SPEC = dict(cells=CELLS, model_kwargs=KW, n_queries=80, seed=11,
            rate=2000.0, zipf_s=0.8, priority_mix=(0.4, 0.3, 0.3),
            deadline_frac=0.2, deadline_s=0.02, degraded_frac=0.4,
            batch_service_s=0.01, warm_frac=0.25)
POLICY = dict(max_work=2.5, est_batch_s=0.01, degraded_pressure=0.4,
              degraded_distance=0.6)
FLEET = dict(cells=CELLS[:8], model_kwargs=KW, n_workers=4,
             queries_per_worker=40, seed=20260804, zipf_s=0.8)


@pytest.mark.parametrize("over", [{}, {"seed": 12}, {"zipf_s": 1.3},
                                  {"offlattice_frac": 0.5,
                                   "n_queries": 200}])
def test_generate_arrivals_matches_jax(over):
    j = jserve.generate_arrivals(jserve.LoadSpec(**dict(SPEC, **over)))
    t = tserve.generate_arrivals(tserve.LoadSpec(**dict(SPEC, **over)))
    assert [tuple(a) for a in t] == [tuple(a) for a in j]
    assert len(t) == dict(SPEC, **over)["n_queries"]


@pytest.mark.parametrize("over", [{}, {"offlattice_frac": 0.3},
                                  {"priority_mix": (0.5, 0.5)}])
def test_generate_fleet_arrivals_matches_jax(over):
    jspec = jserve.FleetSpec(**dict(FLEET, **over))
    tspec = tserve.FleetSpec(**dict(FLEET, **over), device="cpu")
    for w in range(4):
        assert tserve.generate_fleet_arrivals(tspec, w) == \
            jserve.generate_fleet_arrivals(jspec, w)


def test_fleet_spec_adds_only_the_device():
    assert tserve.FleetSpec._fields == jserve.FleetSpec._fields + ("device",)
    assert tserve.FleetSpec._field_defaults["device"] == "cuda"
    assert tserve.LoadSpec._fields == jserve.LoadSpec._fields
    assert tserve.LoadReport._fields == jserve.LoadReport._fields
    assert tserve.FleetReport._fields == jserve.FleetReport._fields + (
        "worker_launches",)


@pytest.fixture(scope="module")
def reports():
    jrep = jserve.run_load(jserve.LoadSpec(**SPEC),
                           admission=jserve.AdmissionPolicy(**POLICY))
    trep = tserve.run_load(tserve.LoadSpec(**SPEC),
                           admission=tserve.AdmissionPolicy(**POLICY),
                           device="cpu")
    return jrep, trep


def test_run_load_digest_and_outcomes_match_jax(reports):
    jrep, trep = reports
    assert trep.digest == jrep.digest
    assert trep.outcomes == jrep.outcomes
    assert trep.counts == jrep.counts
    assert trep.unresolved == jrep.unresolved == 0
    # the overload machinery fired: not every arrival was served
    assert any(not o.startswith("served:") for o in trep.outcomes)
    assert trep.counts.get("served:hit", 0) > 0
    assert (trep.queue_depth_peak, trep.breaker_transitions) == \
        (jrep.queue_depth_peak, jrep.breaker_transitions)


def test_run_load_snapshot_counters_match_jax(reports):
    jrep, trep = reports
    keys = ("serve_requests", "serve_overloaded", "serve_load_sheds",
            "serve_deadline_rejects_submit", "serve_deadline_expirations",
            "serve_circuit_rejects", "serve_failures", "serve_batches")
    assert {k: trep.snapshot[k] for k in keys} == \
        {k: jrep.snapshot[k] for k in keys}
    assert set(trep.p50_ms) == set(jrep.p50_ms)


def test_run_load_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.run_load(tserve.LoadSpec(**dict(SPEC, n_queries=1)))
