"""Fleet serving: a thin HTTP front over ``EquilibriumService`` plus the
out-of-process worker entry point (DESIGN §14; port of the JAX package's
``serve/fleet.py``, host code, copied; each worker's service launches the
lane kernels on its card).

One process was the throughput ceiling: the in-process engine answers
exact hits in well under a millisecond and survives overload, but every
query funnels through one Python process.  The fleet tier scales OUT
instead of up:

* **N worker processes**, each running the UNCHANGED in-process
  ``EquilibriumService`` (priorities, deadlines, admission, breakers all
  ride through verbatim) behind a stdlib ``ThreadingHTTPServer`` — no
  new dependencies, JSON over HTTP;
* **one shared disk store** (``SolutionStore(shared=True)``): the
  content-addressed fingerprints plus the row checksum and
  ``schema_ck`` contracts make cross-process sharing verifiably safe,
  and the claim/lease election makes cold solves exactly-once
  fleet-wide (``serve.store`` docstring for the protocol);
* **speculative neighbor prefetch** around misses
  (``EquilibriumService(prefetch_k=..., prefetch_cells=...)``) riding
  ``Priority.SPECULATIVE`` — sheddable by construction, so prefetch can
  never displace interactive work.

Endpoints (JSON in, JSON out):

* ``POST /query`` — ``{"cell": [σ, ρ, sd], "kwargs": {...},
  "scenario", "priority", "deadline", "degraded_ok", "timeout"}`` →
  the served result, or a typed error payload (``{"error":
  "<TypeName>", "message", "retry_after_s"?, "status"?}``) with the
  HTTP status mapped from the serving layer's typed errors (503 +
  ``Retry-After`` for ``Overloaded``/``CircuitOpen``, 504 for
  deadlines/timeouts, 500 for solve/certification failures).
* ``GET /metrics`` — the ``ServeMetrics`` snapshot (fleet counters
  included).
* ``GET /fleet`` — fleet introspection: owner id, published keys,
  prefetch-issued keys, held leases (the load harness's attribution
  and leak-audit hook).
* ``GET /healthz`` — liveness.

Worker lifecycle: ``python -m aiyagari_hark_tpu_torch.serve.fleet --store
DIR --kwargs '{"a_count": 10}' [--device cuda|cpu] ...`` prints
``FLEET_READY port=<p> pid=<pid>`` once the server is listening and then
idles under ``resilience.preemption_guard``: SIGTERM turns into the typed
``Interrupted`` (journaled; pending futures fail at the batch seam), the
front stops, and the process exits 75 — the
driver-facing "interrupted, not failed" code.  Leases the dying worker
still holds are deliberately NOT released on the signal path: the lease
TTL is the designed reclaim (survivors break stale leases and re-solve),
and the interrupt path must not add disk I/O between the signal and
exit.

Scope, honestly: this is a single-host-N-process fleet by default (the
shared-dir lease backend trusts one filesystem's O_EXCL and one wall
clock).  ``--lease-backend cas:host:port`` swaps the directory for the
loopback CAS authority (``serve.lease``) behind the same claim/publish
API; nothing above the store changes, and the backend choice never
enters solution fingerprints.

Resilience (DESIGN §14): the client has TYPED resilience —
bounded deterministic exponential backoff honoring the server's 503
``Retry-After`` (``RetryPolicy``), per-request deadlines on an
injectable clock, and optional hedged reads for known-published
fingerprints (``HedgePolicy``; a hedge is never issued for a cold miss
— see the module docstring of ``serve.chaos`` for why).  Workers have a
``POST /chaos`` arm endpoint (only when started with ``--chaos``) and
surface per-worker lease/heartbeat health in ``/healthz`` and
``/fleet``.

The port's worker takes ``--device`` (default ``cuda``: the card, pinned
to an index as ``EquilibriumService`` pins it; a host without one makes
the worker raise before ``FLEET_READY``).  Its exit line adds the lane
kernels' launch counts, ``FLEET_EXIT interrupted=<0|1>
launches=<JSON>``.  Every endpoint's JSON layout is the JAX package's.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, NamedTuple, Optional
from urllib import error as urlerror
from urllib import request as urlrequest

from .batcher import ServeQueueFull
from .service import (
    CertificationFailed,
    CircuitOpen,
    DeadlineExceeded,
    EquilibriumService,
    EquilibriumSolveFailed,
    LoadShed,
    Overloaded,
    ServeError,
    ServiceClosed,
    make_query,
)

# typed serving error -> (HTTP status, should carry Retry-After).  503
# means "the fleet is saturated or this region is breaking — back off
# and retry"; 504 "your deadline/timeout passed"; 500 "the solve itself
# failed typed".  Unknown scenarios and malformed bodies are 400s.
# Keyed by CLASS (exact type): a rename upstream breaks this table
# loudly at import, not silently at serve time.
_ERROR_STATUS = {
    Overloaded: (503, True),
    CircuitOpen: (503, True),
    ServeQueueFull: (503, False),
    LoadShed: (503, False),
    ServiceClosed: (503, False),
    DeadlineExceeded: (504, False),
    EquilibriumSolveFailed: (500, False),
    CertificationFailed: (500, False),
}
# Interrupted is resolved lazily (importing the resilience layer here
# would be needless at module scope for a transport table).
# CoordinationUnavailable: the worker's replicated CAS lost
# its quorum — retryable 503, the client backs off and the majority
# side of the partition keeps serving.
_EXTRA_STATUS = {"Interrupted": (503, False),
                 "CoordinationUnavailable": (503, True)}


def result_to_json(res) -> dict:
    """A ``ServedResult`` as a JSON-safe dict.  Floats serialize via
    ``repr`` (shortest round-trip), so every float64 crosses the wire
    BIT-EXACTLY — the fleet bit-identity acceptance compares served
    values against a local ``reference_solve`` after one JSON hop."""
    return {
        "r_star": float(res.r_star),
        "capital": float(res.capital),
        "labor": float(res.labor),
        "bisect_iters": int(res.bisect_iters),
        "egm_iters": int(res.egm_iters),
        "dist_iters": int(res.dist_iters),
        "status": int(res.status),
        "path": str(res.path),
        "quality": str(res.quality),
        "key": int(res.key),
        "cert_level": (None if res.cert_level is None
                       else int(res.cert_level)),
        "scenario": str(res.scenario),
        "fields": list(res.fields),
        "values": [float(v) for v in res.values],
        "bracket_init": (None if res.bracket_init is None
                         else [float(res.bracket_init[0]),
                               float(res.bracket_init[1]),
                               int(res.bracket_init[2])]),
        # surrogate tier: the tag travels with the answer —
        # a surrogate response is never mistakable for an exact one
        "surrogate_error_bound": (
            None if res.surrogate_error_bound is None
            else float(res.surrogate_error_bound)),
        "donor_keys": (None if res.donor_keys is None
                       else [int(k) for k in res.donor_keys]),
    }


def error_to_json(exc: BaseException) -> dict:
    """A typed serving error as a JSON payload the client can re-type:
    the class name, message, and whichever retry-after / status / key
    attributes the error carries."""
    payload = {"error": type(exc).__name__, "message": str(exc)}
    for attr in ("retry_after_s", "est_wait_s", "status", "key",
                 "waited_s", "depth", "max_queue", "reason"):
        v = getattr(exc, attr, None)
        if v is not None and isinstance(v, (int, float, str)):
            payload[attr] = v
    return payload


class _FleetHandler(BaseHTTPRequestHandler):
    """One request: decode JSON, run the service call, encode JSON.
    The SERVICE is the authority on every serving decision — this layer
    only transports."""

    # the service is attached per-server (``FleetFront`` subclasses the
    # server class with a ``service`` attribute)
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # quiet: the journal is the log
        pass

    def _send(self, code: int, payload: dict,
              retry_after: Optional[float] = None) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            # repr(), not a fixed-width format: the header must equal
            # the JSON payload's ``retry_after_s`` BIT-EXACTLY after one
            # float round-trip (json.dumps also serializes floats via
            # repr), so a client honoring either sees the same wait —
            # pinned by tests/test_fleet_client.py.
            self.send_header("Retry-After", repr(max(0.0, float(retry_after))))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        svc: EquilibriumService = self.server.service
        store = svc.store
        if self.path == "/healthz":
            hb = (store.heartbeat_health()
                  if hasattr(store, "heartbeat_health") else {})
            self._send(200, {"ok": True,
                             "owner": getattr(store, "owner", ""),
                             "heartbeat": hb})
        elif self.path == "/metrics":
            self._send(200, svc.metrics.snapshot())
        elif self.path == "/fleet":
            hb = (store.heartbeat_health()
                  if hasattr(store, "heartbeat_health") else {})
            self._send(200, {
                "owner": getattr(store, "owner", ""),
                "shared": bool(getattr(store, "shared", False)),
                "published_keys": store.published_keys(),
                "prefetch_keys": svc.prefetch_keys(),
                "held_leases": store.held_leases(),
                "store_known": store.known(),
                "fleet_counts": store.fleet_counts(),
                "heartbeat": hb,
                "lease_backend": hb.get("backend", "shared-dir"),
            })
        else:
            self._send(404, {"error": "NotFound", "message": self.path})

    def do_POST(self):
        if self.path == "/chaos":
            self._do_chaos()
            return
        if self.path != "/query":
            self._send(404, {"error": "NotFound", "message": self.path})
            return
        svc: EquilibriumService = self.server.service
        try:
            n = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(n).decode("utf-8"))
            cell = [float(x) for x in req["cell"]]
            q = make_query(
                cell[0], cell[1], labor_sd=cell[2],
                priority=int(req.get("priority", 0)),
                degraded_ok=bool(req.get("degraded_ok", False)),
                scenario=str(req.get("scenario", "aiyagari")),
                surrogate_ok=bool(req.get("surrogate_ok", True)),
                **req.get("kwargs", {}))
        except Exception as e:   # malformed request: client error
            self._send(400, {"error": "BadRequest", "message": str(e)})
            return
        deadline = req.get("deadline")
        timeout = float(req.get("timeout", 300.0))
        try:
            fut = svc.submit(
                q, deadline=None if deadline is None else float(deadline))
            res = fut.result(timeout)
        except FutureTimeout:
            self._send(504, {"error": "Timeout",
                             "message": f"no result in {timeout:g}s"})
            return
        except BaseException as e:
            code, with_retry = _ERROR_STATUS.get(
                type(e), _EXTRA_STATUS.get(type(e).__name__,
                                           (500, False)))
            self._send(code, error_to_json(e),
                       retry_after=(getattr(e, "retry_after_s", None)
                                    if with_retry else None))
            return
        self._send(200, result_to_json(res))

    def _do_chaos(self):
        """Arm/disarm the worker's chaos agent (the drills).  Only
        live on workers started with ``--chaos`` — a production worker
        404s, so the fault surface cannot be armed by accident."""
        agent = getattr(self.server, "chaos", None)
        if agent is None:
            self._send(404, {"error": "ChaosDisabled",
                             "message": "worker not started with --chaos"})
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            cfg = (json.loads(self.rfile.read(n).decode("utf-8"))
                   if n else {})
            # ``partition_replicas`` is a COORDINATION fault,
            # not a solve fault — it routes to the replicated lease
            # backend (which replicas this worker may reach), not to the
            # ChaosAgent's solve-path seams.  [] heals the partition.
            part = cfg.pop("partition_replicas", None)
            if part is not None:
                backend = self.server.service.store.lease_backend
                if not hasattr(backend, "set_partition"):
                    raise ValueError(
                        "partition_replicas needs a replicated lease "
                        f"backend (got {type(backend).__name__})")
                backend.set_partition(part)
            armed = agent.arm(cfg)
        except Exception as e:
            self._send(400, {"error": "BadRequest", "message": str(e)})
            return
        self._send(200, {"ok": True, "armed": armed})


class _FleetServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    chaos = None   # a ChaosAgent when the worker was started with --chaos


class FleetFront:
    """The HTTP front for ONE worker's service: bind, serve on a daemon
    thread, stop.  ``port=0`` binds an ephemeral port (read ``.port``
    after construction — the worker prints it for its spawner)."""

    def __init__(self, service: EquilibriumService,
                 host: str = "127.0.0.1", port: int = 0, chaos=None):
        self._httpd = _FleetServer((host, int(port)), _FleetHandler)
        self._httpd.service = service
        self._httpd.chaos = chaos
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "FleetFront":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="fleet-front", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def __enter__(self) -> "FleetFront":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()


class FleetHTTPError(ServeError):
    """A worker answered with a typed error payload: ``payload`` is the
    decoded JSON (``payload["error"]`` names the serving-layer type),
    ``code`` the HTTP status, ``retry_after_s`` the parsed
    ``Retry-After`` header when the worker sent one (float seconds —
    equal to the payload's ``retry_after_s``/``est_wait_s`` field by the
    ``_send`` repr pin)."""

    def __init__(self, code: int, payload: dict,
                 retry_after_s: Optional[float] = None):
        super().__init__(
            f"fleet worker returned {code}: "
            f"{payload.get('error')} ({payload.get('message')})")
        self.code = int(code)
        self.payload = dict(payload)
        self.retry_after_s = (None if retry_after_s is None
                              else float(retry_after_s))


class RetryPolicy(NamedTuple):
    """Bounded DETERMINISTIC exponential backoff for ``FleetClient``.
    Attempt k waits ``base_s * multiplier**k``, raised to
    the server's 503 ``Retry-After`` when one was sent (the worker's
    estimate is better than the client's schedule), capped at
    ``max_backoff_s``.  No jitter by design: the chaos drills replay
    byte-identically only if every client wait is a pure function of
    (policy, attempt index, server answer)."""

    max_attempts: int = 4
    base_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 2.0

    def backoff_s(self, attempt: int,
                  retry_after_s: Optional[float] = None) -> float:
        wait = float(self.base_s) * float(self.multiplier) ** int(attempt)
        if retry_after_s is not None:
            wait = max(wait, float(retry_after_s))
        return min(wait, float(self.max_backoff_s))


class HedgePolicy(NamedTuple):
    """Hedged reads for KNOWN-PUBLISHED fingerprints (DESIGN §14).  If
    the primary worker hasn't answered within the hedge delay, a second
    identical request goes to the next worker and the first
    answer wins.  ``delay_s=None`` derives the delay from the client's
    own p99 success latency (an exact hit answering slower than p99 is
    evidence the worker is sick, not that the query is hard); the floor
    ``min_delay_s`` also serves as the delay before any latency history
    exists.  A hedge is only LEGAL for a fingerprint this client has
    already seen answered — a cold miss would trigger a second
    fleet-wide solve election and waste a worker on duplicated work, so
    cold misses never hedge."""

    delay_s: Optional[float] = None
    min_delay_s: float = 0.01


class FleetClient:
    """Stdlib client for a worker pool: submit one query to a worker,
    failing over to the next URL on a CONNECTION-level error (a dead
    worker).  Typed serving errors do NOT fail over — an ``Overloaded``
    from a live worker is an answer, not an outage.

    Resilience (all OPT-IN so existing callers' outcome
    accounting is unchanged):

    * ``retry=RetryPolicy(...)``: 503 answers (``Overloaded`` /
      ``CircuitOpen`` / queue-full / shed) and full-pool connection
      failures are retried under bounded deterministic exponential
      backoff honoring the server's ``Retry-After``.
    * ``deadline_s=`` per query: the whole retry/backoff schedule lives
      inside one budget on the injectable ``clock``; when the budget
      cannot cover the next wait the client raises typed
      ``DeadlineExceeded`` instead of sleeping past it.
    * ``hedge=HedgePolicy(...)``: hedged reads for known-published
      fingerprints only (see ``HedgePolicy``); journaled as
      ``FLEET_HEDGE_ISSUED`` / ``FLEET_HEDGE_WON`` when ``obs`` is
      attached.

    ``clock`` (monotonic seconds) and ``sleep`` are injectable so every
    retry test runs on a fake clock in zero wall time."""

    def __init__(self, urls: List[str], timeout: float = 300.0,
                 retry: Optional[RetryPolicy] = None,
                 hedge: Optional[HedgePolicy] = None,
                 clock=None, sleep=None, obs=None):
        if not urls:
            raise ValueError("FleetClient needs at least one worker URL")
        self.urls = list(urls)
        self.timeout = float(timeout)
        self.retry = retry
        self.hedge = hedge
        self._clock = clock if clock is not None else time.monotonic
        self._sleep = sleep if sleep is not None else time.sleep
        self._obs = obs
        # (scenario, rounded-cell) tokens this client has SEEN answered:
        # the hedge-legality set.  Client-observed only — the client
        # cannot compute fingerprints, and a worker-side "published"
        # answer is exactly the evidence a hedge needs.
        self._published = set()
        self._lat_s: List[float] = []   # success latencies, hedge p99
        self._hedge_counts = {"issued": 0, "won": 0}

    @staticmethod
    def _token(scenario: str, cell) -> tuple:
        return (str(scenario), tuple(round(float(c), 9) for c in cell))

    def hedge_counts(self) -> dict:
        return dict(self._hedge_counts)

    def note_published(self, scenario: str, cell) -> None:
        """Mark a cell hedge-legal without a prior query (e.g. the
        harness pre-warmed it through a different client)."""
        self._published.add(self._token(scenario, cell))

    def _hedge_delay_s(self) -> float:
        assert self.hedge is not None
        if self.hedge.delay_s is not None:
            return max(float(self.hedge.delay_s),
                       float(self.hedge.min_delay_s))
        if not self._lat_s:
            return float(self.hedge.min_delay_s)
        ordered = sorted(self._lat_s)
        p99 = ordered[min(len(ordered) - 1,
                          int(0.99 * (len(ordered) - 1) + 0.5))]
        return max(p99, float(self.hedge.min_delay_s))

    def _post(self, url: str, path: str, payload: dict) -> dict:
        data = json.dumps(payload).encode("utf-8")
        req = urlrequest.Request(url + path, data=data,
                                 headers={"Content-Type":
                                          "application/json"})
        try:
            with urlrequest.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urlerror.HTTPError as e:
            try:
                payload = json.loads(e.read().decode("utf-8"))
            except Exception:
                payload = {"error": "HTTPError", "message": str(e)}
            ra = e.headers.get("Retry-After") if e.headers else None
            try:
                ra = None if ra is None else float(ra)
            except ValueError:
                ra = None
            raise FleetHTTPError(e.code, payload,
                                 retry_after_s=ra) from None

    def get(self, url: str, path: str) -> dict:
        with urlrequest.urlopen(url + path,
                                timeout=self.timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def _query_once(self, payload: dict, start: int) -> dict:
        """One failover sweep over the pool (the plain behavior):
        connection errors and dying workers' typed refusals move on to
        the next URL; any other typed answer raises immediately."""
        last = None
        for i in range(len(self.urls)):
            url = self.urls[(start + i) % len(self.urls)]
            try:
                return self._post(url, "/query", payload)
            except FleetHTTPError as e:
                # a DYING worker's typed refusal is an outage, not an
                # answer — the query is valid, a peer can serve it
                if e.payload.get("error") in ("ServiceClosed",
                                              "Interrupted"):
                    last = e
                    continue
                raise
            except (urlerror.URLError, ConnectionError, OSError,
                    TimeoutError) as e:
                last = e
                continue
        raise ConnectionError(
            f"no fleet worker reachable ({len(self.urls)} tried): "
            f"{last}")

    def _query_hedged(self, payload: dict, start: int,
                      token: tuple) -> dict:
        """Primary request plus, after the hedge delay, one hedge to the
        next worker; first SUCCESS wins.  If the first arrival is an
        error the race waits for the straggler; only when both requests
        fail does the primary's error propagate."""
        results: "queue.Queue" = queue.Queue()

        def _run(tag: str, offset: int) -> None:
            try:
                results.put((tag, None,
                             self._query_once(payload, start + offset)))
            except BaseException as e:   # reported through the queue
                results.put((tag, e, None))

        threading.Thread(target=_run, args=("primary", 0),
                         daemon=True, name="fleet-hedge-primary").start()
        delay = self._hedge_delay_s()
        try:
            first = results.get(timeout=delay)
        except queue.Empty:
            first = None
        if first is not None and first[1] is None:
            return first[2]               # primary answered in time
        self._hedge_counts["issued"] += 1
        if self._obs is not None:
            self._obs.event("FLEET_HEDGE_ISSUED", scenario=token[0],
                            cell=list(token[1]),
                            delay_s=round(delay, 6))
        threading.Thread(target=_run, args=("hedge", 1),
                         daemon=True, name="fleet-hedge-second").start()
        outcomes = [] if first is None else [first]
        while len(outcomes) < 2:
            outcomes.append(results.get())
            tag, err, res = outcomes[-1]
            if err is None:
                if tag == "hedge":
                    self._hedge_counts["won"] += 1
                    if self._obs is not None:
                        self._obs.event("FLEET_HEDGE_WON",
                                        scenario=token[0],
                                        cell=list(token[1]))
                return res
        for tag, err, _res in outcomes:   # both failed: primary's error
            if tag == "primary":
                raise err
        raise outcomes[0][1]

    def query(self, cell, kwargs: dict, scenario: str = "aiyagari",
              priority: int = 0, deadline: Optional[float] = None,
              degraded_ok: bool = False,
              prefer: Optional[int] = None,
              deadline_s: Optional[float] = None) -> dict:
        """POST one query, starting at ``urls[prefer]`` and failing over
        on connection errors.  Returns the result payload; raises
        ``FleetHTTPError`` on a typed error answer, ``ConnectionError``
        when EVERY worker is unreachable (after the retry schedule, when
        one is attached), typed ``DeadlineExceeded`` when ``deadline_s``
        cannot cover the next backoff wait."""
        payload = {"cell": [float(c) for c in cell], "kwargs": kwargs,
                   "scenario": scenario, "priority": int(priority),
                   "deadline": deadline,
                   "degraded_ok": bool(degraded_ok),
                   "timeout": self.timeout}
        start = 0 if prefer is None else int(prefer) % len(self.urls)
        token = self._token(scenario, cell)
        hedge_ok = (self.hedge is not None and len(self.urls) >= 2
                    and token in self._published)
        attempts = (1 if self.retry is None
                    else max(1, int(self.retry.max_attempts)))
        t0 = self._clock()
        limit = None if deadline_s is None else t0 + float(deadline_s)
        for attempt in range(attempts):
            t_req = self._clock()
            try:
                res = (self._query_hedged(payload, start, token)
                       if hedge_ok
                       else self._query_once(payload, start))
                self._lat_s.append(max(0.0, self._clock() - t_req))
                if len(self._lat_s) > 512:
                    del self._lat_s[:-256]
                self._published.add(token)
                return res
            except FleetHTTPError as e:
                if (self.retry is None or attempt + 1 >= attempts
                        or e.code != 503):
                    raise
                wait = self.retry.backoff_s(attempt, e.retry_after_s)
            except ConnectionError:
                if self.retry is None or attempt + 1 >= attempts:
                    raise
                wait = self.retry.backoff_s(attempt)
            if limit is not None and self._clock() + wait > limit:
                raise DeadlineExceeded(   # obs-ok: client-side budget, journaled server-side if at all
                    tuple(float(c) for c in cell), key=-1,
                    waited_s=self._clock() - t0)
            self._sleep(wait)
        raise AssertionError("unreachable: loop raises or returns")


# -- the out-of-process worker ----------------------------------------------

def worker_main(argv=None) -> int:
    """One fleet worker process: shared store + service + HTTP front,
    idling under ``preemption_guard`` until SIGTERM (exit 75, the
    interrupted-not-failed convention) or ``--max-seconds`` (exit 0).
    ``--device`` picks the service's device (default the card); a
    request for the card on a host without one raises here, before
    anything is built or ``FLEET_READY`` is printed."""
    import argparse
    import sys
    import time

    ap = argparse.ArgumentParser(
        description="aiyagari fleet worker")
    ap.add_argument("--store", required=True,
                    help="shared disk store directory")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 binds an ephemeral port (printed)")
    ap.add_argument("--owner", default=f"worker-{os.getpid()}")
    ap.add_argument("--kwargs", default="{}",
                    help="solver model kwargs, JSON")
    ap.add_argument("--scenario", default="aiyagari")
    ap.add_argument("--lease-ttl", type=float, default=30.0)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--ladder", default="1,2,4")
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--prefetch-k", type=int, default=0)
    ap.add_argument("--prefetch-cells", default=None,
                    help="JSON list of [σ, ρ, sd] lattice cells")
    ap.add_argument("--admission", default=None,
                    help="AdmissionPolicy fields, JSON (omit: no "
                         "admission layer)")
    ap.add_argument("--journal", default=None,
                    help="worker event-journal JSONL path")
    ap.add_argument("--certify", action="store_true",
                    help="certify_before_cache on cold misses")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="safety exit after this long (tests)")
    ap.add_argument("--lease-backend", default="dir",
                    help="coordination backend spec: 'dir' (shared-dir "
                         "leases, the default), 'cas:HOST:PORT' (the "
                         "loopback CAS authority, serve.lease), or "
                         "'replicated:H:P,H:P,...' (quorum over an odd "
                         "replica set, serve.replicated)")
    ap.add_argument("--chaos", action="store_true",
                    help="enable the POST /chaos fault-injection "
                         "endpoint (the drills; never on by "
                         "default)")
    ap.add_argument("--surrogate", default=None,
                    help="SurrogatePolicy fields, JSON ("
                         "omit: no surrogate tier)")
    ap.add_argument("--device", default="cuda",
                    help="the service's device: 'cuda' (the default; "
                         "raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..obs.runtime import NULL_OBS, ObsConfig, build_obs
    from ..ops import kernels as K
    from ..utils.config import AdmissionPolicy
    from ..utils.resilience import interrupt_requested, preemption_guard
    from .lease import make_backend
    from .store import SolutionStore

    device = resolve_device(args.device)
    obs = (build_obs(ObsConfig(enabled=True, journal_path=args.journal))
           if args.journal else NULL_OBS)
    admission = (AdmissionPolicy(**json.loads(args.admission))
                 if args.admission else None)
    prefetch_cells = (json.loads(args.prefetch_cells)
                      if args.prefetch_cells else None)
    backend = (None if args.lease_backend == "dir"
               else make_backend(args.lease_backend, root=args.store))
    store = SolutionStore(capacity=args.capacity, disk_path=args.store,
                          shared=True, lease_ttl_s=args.lease_ttl,
                          owner=args.owner, obs=obs,
                          lease_backend=backend)
    chaos = None
    if args.chaos:
        from .chaos import ChaosAgent

        chaos = ChaosAgent(obs=obs, owner=args.owner)
        store.set_chaos(chaos)
    surrogate = None
    if args.surrogate:
        from .surrogate import SurrogatePolicy

        surrogate = SurrogatePolicy(**json.loads(args.surrogate))
    svc = EquilibriumService(
        store=store, max_batch=args.max_batch,
        ladder=tuple(int(s) for s in args.ladder.split(",")),
        admission=admission, obs=obs,
        certify_before_cache=bool(args.certify),
        prefetch_k=args.prefetch_k, prefetch_cells=prefetch_cells,
        surrogate=surrogate, device=device)
    if device.type == "cuda":
        # the card comes up before FLEET_READY: the context, and the lane
        # kernels' libraries loaded from the build directory (or built
        # once, under the cross-process lock), counted in /metrics as a
        # flush's first use would be
        import torch

        with svc.metrics.compile:
            K.build_libraries()
            torch.zeros(1, device=device)
            torch.cuda.synchronize()
    front = FleetFront(svc, host=args.host, port=args.port,
                       chaos=chaos).start()
    print(f"FLEET_READY port={front.port} pid={os.getpid()} "
          f"owner={args.owner}", flush=True)

    interrupted = False
    deadline = (None if args.max_seconds is None
                else time.monotonic() + args.max_seconds)  # timing-ok: test-only safety exit
    # cleanup stays INSIDE the guard: a second SIGTERM mid-cleanup must
    # escalate through the guard's typed path (KeyboardInterrupt), not
    # hit a restored default handler and kill the worker untyped
    with preemption_guard():
        try:
            while not interrupt_requested():
                if (deadline is not None
                        and time.monotonic() >= deadline):  # timing-ok: safety exit check
                    break
                time.sleep(0.02)
            interrupted = interrupt_requested()
            if interrupted and obs is not NULL_OBS:
                obs.event("INTERRUPTED", what="fleet worker",
                          owner=args.owner)
            front.stop()
            try:
                svc.close(drain=not interrupted)
            except BaseException:
                pass
            if obs is not NULL_OBS:
                obs.close()
        except KeyboardInterrupt:
            interrupted = True
    print(f"FLEET_EXIT interrupted={int(interrupted)} "
          f"launches={json.dumps(K.LAUNCHES, sort_keys=True)}", flush=True)
    return 75 if interrupted else 0


if __name__ == "__main__":   # pragma: no cover - exercised via subprocess
    import sys

    sys.exit(worker_main())
