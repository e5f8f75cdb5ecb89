"""The port's fleet tier against the JAX package's.

``serve.fleet`` puts an HTTP front (``FleetFront``) over one
``EquilibriumService`` and runs it as a worker process
(``python -m aiyagari_hark_tpu_torch.serve.fleet``); ``FleetClient``
queries a pool of workers with failover, retry and hedged reads.  Here,
on the CPU at the serve tests' width in float64: a query over HTTP is
bitwise the in-process service's answer; the ``/query``, ``/metrics``,
``/fleet`` and ``/healthz`` layouts and the typed error -> HTTP status
map are JAX's key for key; the client's failover, back-off and hedging
decide as JAX's client does on the stubs of the JAX package's
``tests/test_fleet_client.py``; a real fleet of two port workers
(``--device cpu``) dedups its cold solves, serves a claim loser the
winner's bits and exits 75 on SIGTERM; and a worker asked for the card
on a host without one exits before ``FLEET_READY``.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest
import torch

import aiyagari_hark_tpu.serve as jserve
import aiyagari_hark_tpu.serve.fleet as jfleet
import aiyagari_hark_tpu_torch.serve as tserve
import aiyagari_hark_tpu_torch.serve.fleet as tfleet

torch.set_num_threads(1)

KW = dict(a_count=10, dist_count=32, labor_states=3, r_tol=1e-5,
          max_bisect=24)
KWF = dict(KW, dtype="float64")
CELL = (3.0, 0.6, 0.2)
PKGS = {"jax": (jserve, jfleet), "torch": (tserve, tfleet)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fronts():
    out = {}
    for name, (serve, fleet) in PKGS.items():
        extra = {"device": "cpu"} if name == "torch" else {}
        svc = serve.EquilibriumService(start_worker=True, max_batch=4,
                                       max_wait_s=0.01, ladder=(1, 2, 4),
                                       **extra)
        out[name] = (svc, fleet.FleetFront(svc).start())
    yield out
    for svc, front in out.values():
        front.stop()
        svc.close()


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as resp:
        return json.loads(resp.read().decode())


def _keys(d):
    """A JSON object's layout: its keys, nested objects' layouts inside."""
    return {k: (_keys(v) if isinstance(v, dict) else None)
            for k, v in d.items()}


# -- /query: bitwise the in-process service, JAX's layout ---------------------

def test_http_query_is_bitwise_the_in_process_service(fronts):
    svc, front = fronts["torch"]
    client = tfleet.FleetClient([front.url], timeout=300.0)
    res = client.query(CELL, KWF)
    ref = svc.reference_solve(
        tserve.make_query(*CELL[:2], labor_sd=CELL[2], **KWF),
        bracket_init=(None if res["bracket_init"] is None
                      else tuple(res["bracket_init"])))
    # floats cross the JSON hop by repr round trip: every field bitwise
    assert res["values"] == list(ref.values)
    assert (res["r_star"], res["capital"], res["labor"], res["status"]) == \
        (ref.r_star, ref.capital, ref.labor, ref.status)
    again = client.query(CELL, KWF)
    assert again["path"] == "hit" and again["values"] == res["values"]
    # against JAX's front: the same path, status and trips, r* within
    # 100 r_tol pct (the serve tests' tolerance)
    jres = jfleet.FleetClient([fronts["jax"][1].url],
                              timeout=300.0).query(CELL, KWF)
    assert (res["path"], res["status"], res["bisect_iters"]) == \
        (jres["path"], jres["status"], jres["bisect_iters"])
    assert abs(res["r_star"] - jres["r_star"]) * 100 <= 100 * KW["r_tol"]
    assert _keys(res) == _keys(jres)


def test_endpoint_layouts_equal_jax(fronts):
    for name in PKGS:            # something served, so /fleet is filled
        PKGS[name][1].FleetClient([fronts[name][1].url]).query(
            (1.0, 0.3, 0.2), KWF)
    got = {name: {p: _get(front.url, p)
                  for p in ("/healthz", "/metrics", "/fleet")}
           for name, (_svc, front) in fronts.items()}
    for path in ("/healthz", "/metrics", "/fleet"):
        assert _keys(got["torch"][path]) == _keys(got["jax"][path]), path
    assert got["torch"]["/healthz"]["ok"] is True
    assert got["torch"]["/metrics"]["serve_requests"] >= 1


# -- the typed error -> HTTP status map ---------------------------------------

def test_error_status_table_equals_jax():
    def table(fleet):
        return ({cls.__name__: v for cls, v in fleet._ERROR_STATUS.items()},
                dict(fleet._EXTRA_STATUS))

    assert table(tfleet) == table(jfleet)
    errors = {}
    for name, (serve, fleet) in PKGS.items():
        errs = [serve.Overloaded(cell=CELL, key=7, depth=3, max_queue=3,
                                 est_wait_s=0.30000000000000004,
                                 reason="queue_full"),
                serve.DeadlineExceeded(CELL, key=5, waited_s=1.5),
                serve.EquilibriumSolveFailed(CELL, status=3, key=2),
                ValueError("x")]
        errors[name] = [fleet.error_to_json(e) for e in errs]
    assert errors["torch"] == errors["jax"]


def _http_error(fn):
    try:
        fn()
    except (jfleet.FleetHTTPError, tfleet.FleetHTTPError) as e:
        return e.code, e.payload.get("error")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()).get("error")
    raise AssertionError("the call did not fail")


def test_http_typed_errors_map_as_jax(fronts):
    codes = {}
    for name, (_svc, front) in fronts.items():
        client = PKGS[name][1].FleetClient([front.url])
        codes[name] = [
            _http_error(lambda: client.query((5.0, 0.9, 0.2), KWF,
                                             deadline=-1.0)),
            _http_error(lambda: client.query(CELL, KWF, scenario="nope")),
            _http_error(lambda: client.query(CELL, dict(KWF, a_count="x"))),
            _http_error(lambda: client.get(front.url, "/nope")),
            _http_error(lambda: client._post(front.url, "/chaos", {})),
            _http_error(lambda: client._post(front.url, "/nope", {}))]
    assert codes["torch"] == codes["jax"]
    # a malformed kwarg passes the request's validation and fails the
    # solve: 500, in both packages
    assert [c for c, _ in codes["torch"]] == [504, 400, 500, 404, 404, 404]


class _OverloadedService:
    """A service stub whose every submit refuses with a fractional
    retry-after (the 503 + Retry-After path)."""

    def __init__(self, serve, est_wait_s):
        self.serve, self.est_wait_s = serve, est_wait_s

    def submit(self, q, deadline=None):
        raise self.serve.Overloaded(cell=(q.crra, q.labor_ar, q.labor_sd),
                                    key=0, depth=3, max_queue=3,
                                    est_wait_s=self.est_wait_s,
                                    reason="queue_full")


@pytest.mark.parametrize("name", sorted(PKGS))
def test_retry_after_header_is_the_payload_bit_exactly(name):
    serve, fleet = PKGS[name]
    est = 0.1 + 0.2
    front = fleet.FleetFront(_OverloadedService(serve, est)).start()
    try:
        body = json.dumps({"cell": list(CELL), "kwargs": KWF}).encode()
        req = urllib.request.Request(front.url + "/query", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30.0)
        assert exc.value.code == 503
        assert exc.value.headers.get("Retry-After") == repr(est)
        payload = json.loads(exc.value.read().decode())
        assert payload["retry_after_s"] == est
        with pytest.raises(fleet.FleetHTTPError) as cexc:
            fleet.FleetClient([front.url]).query(CELL, KWF)
        assert cexc.value.retry_after_s == est
    finally:
        front.stop()


# -- FleetClient: failover, back-off, hedging, as JAX's client ----------------

class FakeClock:
    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


class _RecObs:
    def __init__(self):
        self.events = []

    def event(self, etype, **fields):
        self.events.append((etype, dict(fields)))


def _err(fleet, code, retry_after=None, error="Overloaded"):
    payload = {"error": error, "message": "m"}
    if retry_after is not None:
        payload["retry_after_s"] = retry_after
    return fleet.FleetHTTPError(code, payload, retry_after_s=retry_after)


# each script step: ("ok", payload) | ("503", retry_after) | ("400",) |
# ("conn",); then the query's retry policy and deadline
SCRIPTS = {
    "retry_after_honoured": ([("503", 0.7), ("503", 0.7), ("ok", "hit")],
                             dict(max_attempts=4, base_s=0.05), None),
    "own_schedule": ([("503", None), ("503", None), ("ok", "hit")],
                     dict(max_attempts=4, base_s=0.05), None),
    "non_503_not_retried": ([("400",)], {}, None),
    "exhaustion": ([("503", None)] * 3, dict(max_attempts=3, base_s=0.05),
                   None),
    "connection_retried": ([("conn",), ("conn",), ("ok", "hit")],
                           dict(max_attempts=4, base_s=0.05), None),
    "connection_exhausted": ([("conn",)] * 2,
                             dict(max_attempts=2, base_s=0.05), None),
    "no_policy": ([("503", 1.0)], None, None),
    "deadline_short": ([("503", None)] * 4, dict(max_attempts=4, base_s=1.0),
                       0.5),
    "deadline_one_wait": ([("503", None)] * 4,
                          dict(max_attempts=4, base_s=1.0, multiplier=2.0),
                          1.5),
}


def _scripted_run(fleet, script, retry, deadline_s):
    clock = FakeClock()
    c = fleet.FleetClient(["http://stub-a", "http://stub-b"],
                          retry=None if retry is None
                          else fleet.RetryPolicy(**retry),
                          clock=clock, sleep=clock.sleep)
    steps, calls = list(script), []

    def scripted(payload, start):
        calls.append(start)
        step = steps.pop(0)
        if step[0] == "ok":
            return {"path": step[1]}
        if step[0] == "conn":
            raise ConnectionError("down")
        if step[0] == "400":
            raise _err(fleet, 400, error="BadRequest")
        raise _err(fleet, 503, step[1])

    c._query_once = scripted
    try:
        out = ("ok", c.query(CELL, KWF, deadline_s=deadline_s))
    except Exception as e:
        out = ("raised", type(e).__name__, getattr(e, "code", None))
    return out, clock.sleeps, calls


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_client_retry_and_deadline_decide_as_jax(script):
    runs = {name: _scripted_run(fleet, *SCRIPTS[script])
            for name, (_s, fleet) in PKGS.items()}
    assert runs["torch"] == runs["jax"]


def test_backoff_schedule_equals_jax():
    for over in ({}, dict(base_s=0.1, multiplier=3.0, max_backoff_s=1.0)):
        j, t = jfleet.RetryPolicy(**over), tfleet.RetryPolicy(**over)
        for k in range(8):
            for ra in (None, 0.07, 0.7, 10.0):
                assert t.backoff_s(k, ra) == j.backoff_s(k, ra)


def _hedge_run(fleet, case):
    obs = _RecObs()
    release = threading.Event()
    urls = ["http://only"] if case == "one_worker" else ["http://a",
                                                         "http://b"]
    delay = {"cold_never": 0.001, "hedge_wins": 0.02, "fast_primary": 5.0,
             "one_worker": 0.0}[case]
    c = fleet.FleetClient(urls, hedge=fleet.HedgePolicy(delay_s=delay),
                          obs=obs)
    calls = []

    def scripted(payload, start):
        calls.append(start)
        if case == "hedge_wins" and start == 0:
            release.wait(5.0)                     # the sick primary
            return {"who": "primary"}
        return {"who": "hedge" if start == 1 else "primary"}

    c._query_once = scripted
    if case != "cold_never":
        c.note_published("aiyagari", CELL)
    res = c.query(CELL, KWF)
    release.set()
    return (res, c.hedge_counts(), sorted(calls),
            [t for t, _ in obs.events])


@pytest.mark.parametrize("case", ["cold_never", "hedge_wins",
                                  "fast_primary", "one_worker"])
def test_client_hedging_decides_as_jax(case):
    runs = {name: _hedge_run(fleet, case)
            for name, (_s, fleet) in PKGS.items()}
    assert runs["torch"] == runs["jax"]


def test_hedge_delay_from_p99_equals_jax():
    out = {}
    for name, (_s, fleet) in PKGS.items():
        c = fleet.FleetClient(["http://a", "http://b"],
                              hedge=fleet.HedgePolicy(min_delay_s=0.01))
        d = [c._hedge_delay_s()]
        c._lat_s = [0.001 * k for k in range(1, 101)]
        d.append(c._hedge_delay_s())
        c._lat_s = [0.0001]
        d.append(c._hedge_delay_s())
        out[name] = d
    assert out["torch"] == out["jax"]


def test_client_fails_over_to_a_live_worker(fronts):
    _svc, front = fronts["torch"]
    client = tfleet.FleetClient(["http://127.0.0.1:9", front.url])
    assert client.query(CELL, KWF)["path"] in ("hit", "cold", "near")


# -- real worker processes ----------------------------------------------------

def test_two_worker_fleet_dedups_and_serves_the_winners_bits(tmp_path):
    """Two ``--device cpu`` workers over one shared store, worker 1
    SIGTERMed after 4 of its queries: every arrival served, each cold
    fingerprint solved once fleet-wide, every response for one
    fingerprint the same bits (a claim loser serves the winner's publish),
    each served value bitwise the in-process same-seed solve, exit 75 and
    a journaled INTERRUPTED from the drilled worker, no leaked lease."""
    cells = tuple((s, r, 0.2) for s in (1.0, 3.0) for r in (0.0, 0.6))
    spec = tserve.FleetSpec(cells=cells, model_kwargs=KWF, n_workers=2,
                            queries_per_worker=8, seed=5, zipf_s=0.8,
                            lease_ttl_s=2.0, sigterm_worker=1,
                            sigterm_after=4, device="cpu")
    rep = tserve.run_fleet_load(spec, store_dir=str(tmp_path / "store"),
                                ready_timeout_s=120.0,
                                client_timeout_s=120.0)
    assert rep.unresolved == 0 and rep.arrivals == 16
    assert all(o.startswith("served:") for o in rep.counts)
    assert rep.dedup_ratio == 1.0 and rep.leases_leaked == 0
    assert rep.value_divergence == 0
    assert rep.interrupted_rcs[1] == 75 and rep.interrupted_journaled
    assert rep.remote_hits + rep.claims_lost >= 1     # served a peer's bits
    # the SIGTERMed worker reported its launches too (0: the CPU runs the
    # kernels' plain versions)
    assert set(rep.worker_launches) == {0, 1}
    assert all(n == {"egm_policy_grid": 0, "fused_cell_grid": 0,
                     "stationary_lottery_grid": 0}
               for n in rep.worker_launches.values())
    ref = tserve.EquilibriumService(start_worker=False, max_batch=4,
                                    ladder=(1, 2, 4), device="cpu")
    try:
        for vals in rep.served_values.values():
            c = vals["cell"]
            q = tserve.make_query(c[0], c[1], labor_sd=c[2], **KWF)
            seed = vals["bracket_init"]
            x = ref.reference_solve(
                q, bracket_init=None if seed is None else tuple(seed))
            assert (vals["r_star"], vals["labor"], vals["status"]) == \
                (x.r_star, x.labor, x.status)
            if seed is not None:
                assert vals["capital"] == x.capital
    finally:
        ref.close()


def test_worker_without_a_card_exits_before_ready(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the worker would serve")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "aiyagari_hark_tpu_torch.serve.fleet",
         "--store", str(tmp_path / "store"), "--max-seconds", "30"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "FLEET_READY" not in proc.stdout
    assert "no CUDA device is available" in proc.stderr
