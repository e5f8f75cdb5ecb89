"""The run-scoped observability bundle: config, lifecycle, active scope
(port of ``aiyagari_hark_tpu/obs/runtime.py``).

``ObsConfig`` is the one switch callers thread (``SweepConfig.obs``, the
``obs=`` argument of ``run_sweep`` / ``run_table2_sweep``); ``Obs``
bundles the tracer, the metrics registry and the event journal under one
``run_id``.  Off is the default and near free:

* ``NULL_OBS`` is a process singleton whose ``span()`` returns THE cached
  null context manager (``trace.NULL_SPAN_CM``), whose ``event()`` is a
  no-op and whose instrument accessors return a shared no-op instrument;
* ``emit_event`` -- the hook of seams too deep to thread a handle
  (``utils.resilience``'s retries and ledger, ``utils.fingerprint``'s
  checksums, ``utils.checkpoint``'s disk faults) -- costs one truth test
  when no run is active.

An enabled ``Obs`` registers itself as the ACTIVE scope (``activate()``)
for the duration of a run, so those deep seams land their events in the
run's journal.  The active scope is a per-thread stack: nested runs
journal to the innermost, and runs on different threads never blend.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import List, Optional

from .journal import EventJournal
from .metrics import MetricsRegistry
from .trace import NULL_SPAN_CM, Tracer, new_run_id


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability knobs for one run (hashable, rides frozen configs).

    * ``enabled`` — master switch; False (default) resolves to
      ``NULL_OBS``.  On or off, no solver bit moves.
    * ``trace`` / ``metrics`` — record spans / counters (both on when
      enabled; the journal is governed by ``journal_path`` alone).
    * ``trace_path`` — write the Chrome-trace JSON here on close
      (load it in chrome://tracing or https://ui.perfetto.dev).
    * ``journal_path`` — append typed lifecycle events to this JSONL.
    * ``run_id`` — correlation id; auto-generated when None.
    * ``device_trace_dir`` — opt-in bridge to ``utils.timing
      .device_trace``: spans created with ``device_profile=True`` run
      under ``torch.profiler`` and export a Chrome trace under this
      directory.
    * ``profile`` — the performance tier: an ``obs.profile.CostLedger``
      summing each launch's wall and the kernels' work model (bytes and
      operations at the launch's shapes and step counts) into achieved
      FLOP/s and a roofline class, plus ``DeviceTelemetry`` sampling the
      CUDA allocator's counters at the sweep's bucket seams.
    * ``flight_path`` — where the flight recorder dumps its ring as a
      crash artifact when a typed failure escalates past the quarantine
      ladder (``Obs.dump_flight``).  None derives a sibling of
      ``journal_path`` (``<journal>.flight.json``) when that is set,
      else disables dumping (the in-memory ring still records).
    * ``flight_limit`` — bounded size of the flight-recorder ring."""

    enabled: bool = False
    trace: bool = True
    metrics: bool = True
    trace_path: Optional[str] = None
    journal_path: Optional[str] = None
    run_id: Optional[str] = None
    device_trace_dir: Optional[str] = None
    profile: bool = False
    flight_path: Optional[str] = None
    flight_limit: int = 256

    def replace(self, **kwargs) -> "ObsConfig":
        return dataclasses.replace(self, **kwargs)


class _NullInstrument:
    """Accepts every instrument mutation, records nothing."""

    __slots__ = ()
    kind = "null"
    value = 0.0
    count = 0
    sum = 0.0

    def inc(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass


NULL_INSTRUMENT = _NullInstrument()
_NULL_ACTIVATE_CM = contextlib.nullcontext(None)


class FlightRecorder:
    """A bounded ring of a run's most recent lifecycle entries: every
    journal event and every completed span lands here (plus externally
    timed ``record_span`` latencies), so when a typed failure escalates
    past the quarantine ladder the run can dump "what just happened" as
    one crash artifact.  Oldest entries fall off; ``dropped`` counts
    them so a dump can never silently read as complete."""

    def __init__(self, limit: int = 256, clock=time.time):
        import collections

        self.limit = max(1, int(limit))
        self._ring = collections.deque(maxlen=self.limit)
        self._clock = clock
        self._lock = threading.Lock()
        self.noted = 0

    def note(self, kind: str, payload: dict) -> None:
        rec = {"t": round(float(self._clock()), 6), "kind": str(kind)}
        rec.update(payload)
        with self._lock:
            self._ring.append(rec)
            self.noted += 1

    @property
    def dropped(self) -> int:
        with self._lock:
            return max(0, self.noted - len(self._ring))

    def entries(self) -> list:
        with self._lock:
            return list(self._ring)


class Obs:
    """One run's observability bundle (build via ``build_obs``)."""

    enabled = True

    def __init__(self, run_id: Optional[str] = None,
                 tracer: Optional[Tracer] = None,
                 registry: Optional[MetricsRegistry] = None,
                 journal: Optional[EventJournal] = None,
                 trace_path: Optional[str] = None,
                 cost_ledger=None, telemetry=None,
                 flight: Optional[FlightRecorder] = None,
                 flight_path: Optional[str] = None):
        self.run_id = run_id if run_id is not None else new_run_id()
        self.tracer = tracer
        self.registry = registry
        self.journal = journal
        self.trace_path = trace_path
        self.cost_ledger = cost_ledger    # obs.profile.CostLedger | None
        self.telemetry = telemetry        # obs.profile.DeviceTelemetry
        self.flight = flight
        self.flight_path = flight_path
        self._closed = False

    # -- spans --------------------------------------------------------------

    def span(self, name: str, **attrs):
        if self.tracer is None:
            return NULL_SPAN_CM
        cm = self.tracer.span(name, **attrs)
        if self.flight is None:
            return cm
        return self._flight_span(cm, name)

    @contextlib.contextmanager
    def _flight_span(self, cm, name: str):
        """Wrap a tracer span so its completion also lands in the flight
        ring (name + wall; full attrs stay in the trace — the ring is a
        post-mortem digest, not a second trace)."""
        sp = None
        try:
            with cm as sp:
                yield sp
        finally:
            if sp is not None and sp.t1 is not None:
                self.flight.note("span", {"name": name,
                                          "wall_s": sp.duration()})

    def record_span(self, name: str, duration_s: float, **attrs) -> None:
        if self.tracer is not None:
            self.tracer.record(name, duration_s, **attrs)
        if self.flight is not None:
            self.flight.note("span", {"name": name,
                                      "wall_s": float(duration_s),
                                      "external": True})

    # -- events -------------------------------------------------------------

    def event(self, etype: str, **attrs) -> None:
        if self.journal is not None:
            self.journal.emit(etype, **attrs)
        if self.flight is not None:
            from .trace import _jsonable

            self.flight.note("event", {"event": etype,
                                       **{str(k): _jsonable(v)
                                          for k, v in attrs.items()}})

    # -- metrics ------------------------------------------------------------

    def counter(self, name: str, help: str = ""):
        if self.registry is None:
            return NULL_INSTRUMENT
        return self.registry.counter(name, help)

    def gauge(self, name: str, help: str = ""):
        if self.registry is None:
            return NULL_INSTRUMENT
        return self.registry.gauge(name, help)

    def histogram(self, name: str, help: str = "", **kw):
        if self.registry is None:
            return NULL_INSTRUMENT
        return self.registry.histogram(name, help, **kw)

    # -- performance tier ---------------------------------------------------

    def sample_devices(self, where: str = "") -> int:
        """Sample every CUDA device's allocator counters into gauges and
        high-water events (``obs.profile.DeviceTelemetry``).  No-op
        (returns 0) unless the profile pillar is on — the sampling sites
        (the sweep's bucket seams) call unconditionally."""
        if self.telemetry is None:
            return 0
        return self.telemetry.sample(self, where=where)

    def dump_flight(self, reason: str, **attrs) -> Optional[str]:
        """Dump the flight-recorder ring as a crash artifact (atomic
        JSON via ``utils.checkpoint``) and journal FLIGHT_RECORD_DUMP.
        Returns the path written, or None when the recorder is off or no
        dump path is configured.  The dump embeds the metrics-registry
        snapshot — the "recent metric samples" leg of the ring — and the
        ring's drop count, so a truncated window reads as truncated."""
        if self.flight is None or self.flight_path is None:
            return None
        from ..utils.checkpoint import atomic_write_json
        from .trace import _jsonable

        payload = {
            "run_id": self.run_id,
            "reason": str(reason),
            "dumped_at": round(float(self.flight._clock()), 6),
            "attrs": {str(k): _jsonable(v) for k, v in attrs.items()},
            "entries": self.flight.entries(),
            "entries_dropped": self.flight.dropped,
            "metrics": (self.registry.snapshot()
                        if self.registry is not None else None),
        }
        atomic_write_json(self.flight_path, payload)
        self.event("FLIGHT_RECORD_DUMP", path=self.flight_path,
                   reason=str(reason), entries=len(payload["entries"]))
        return self.flight_path

    # -- lifecycle ----------------------------------------------------------

    def activate(self):
        """Context manager making this the ACTIVE scope for module-level
        ``emit_event``/``active_obs`` callers (deep seams without a
        threaded handle)."""
        return _activation(self)

    def close(self) -> None:
        """Flush run-end artifacts: the cost-ledger summary
        (PROFILE_SNAPSHOT event + registry mirror), the RUN_END journal
        event, and the Chrome trace (atomic write).  Idempotent — a run
        interrupted between seams may close through more than one
        ``finally``."""
        if self._closed:
            return
        self._closed = True
        if self.cost_ledger is not None:
            snap = self.cost_ledger.snapshot()
            self.cost_ledger.publish(self.registry)
            self.event("PROFILE_SNAPSHOT",
                       executables=snap["executables"],
                       launches=snap["launches"],
                       launch_wall_s=snap["launch_wall_s"],
                       measured_flops_total=snap["measured_flops_total"],
                       achieved_flops_per_sec=snap[
                           "achieved_flops_per_sec"],
                       roofline=snap["roofline"],
                       cost_sources=snap["cost_sources"])
        self.event("RUN_END")
        if self.tracer is not None and self.trace_path is not None:
            self.tracer.save_chrome_trace(self.trace_path)


class _NullObs(Obs):
    """The disabled bundle: one process-wide instance, every operation a
    constant-time no-op."""

    enabled = False

    def __init__(self):
        super().__init__(run_id="run-disabled")

    def span(self, name: str, **attrs):
        return NULL_SPAN_CM

    def record_span(self, name: str, duration_s: float, **attrs) -> None:
        pass

    def event(self, etype: str, **attrs) -> None:
        pass

    def counter(self, name: str, help: str = ""):
        return NULL_INSTRUMENT

    gauge = counter
    histogram = counter

    def activate(self):
        return _NULL_ACTIVATE_CM

    def close(self) -> None:
        pass


NULL_OBS = _NullObs()

# The active-scope stack: appended under ``activate()``, innermost
# last.  PER-THREAD (``threading.local``) — two runs on two threads each
# see only their own scope, so a deep seam can never journal thread A's
# event under thread B's run_id.  A worker thread servicing a run it did
# not start re-activates the owning bundle around its launches.
_ACTIVE = threading.local()


def _active_stack() -> List[Obs]:
    stack = getattr(_ACTIVE, "stack", None)
    if stack is None:
        stack = _ACTIVE.stack = []
    return stack


@contextlib.contextmanager
def _activation(obs: Obs):
    stack = _active_stack()
    stack.append(obs)
    try:
        yield obs
    finally:
        try:
            stack.remove(obs)
        except ValueError:
            pass


def active_obs() -> Obs:
    """This thread's innermost active bundle, or ``NULL_OBS``."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else NULL_OBS


def emit_event(etype: str, **attrs) -> None:
    """Journal one event into the active scope — the hook for seams too
    deep to thread an ``Obs`` handle (retry backoffs, checksum
    failures, signal-flag polls).  One attribute read plus a truth-test
    when no run is active."""
    stack = getattr(_ACTIVE, "stack", None)
    if not stack:
        return
    stack[-1].event(etype, **attrs)


def active_span(name: str, **attrs):
    """A span on the active scope (cached null CM when none)."""
    stack = getattr(_ACTIVE, "stack", None)
    if not stack:
        return NULL_SPAN_CM
    return stack[-1].span(name, **attrs)


def build_obs(config: Optional[ObsConfig]) -> Obs:
    """Materialize a bundle from a config: ``None`` or
    ``enabled=False`` give ``NULL_OBS``."""
    if config is None or not config.enabled:
        return NULL_OBS
    run_id = config.run_id if config.run_id is not None else new_run_id()
    tracer = (Tracer(run_id=run_id,
                     device_trace_dir=config.device_trace_dir)
              if config.trace else None)
    registry = MetricsRegistry() if config.metrics else None
    journal = (EventJournal(config.journal_path, run_id)
               if config.journal_path is not None else None)
    cost_ledger = telemetry = None
    if config.profile:
        from .profile import CostLedger, DeviceTelemetry

        cost_ledger = CostLedger()
        telemetry = DeviceTelemetry()
    flight = FlightRecorder(limit=config.flight_limit)
    flight_path = config.flight_path
    if flight_path is None and config.journal_path is not None:
        flight_path = str(config.journal_path) + ".flight.json"
    obs = Obs(run_id=run_id, tracer=tracer, registry=registry,
              journal=journal, trace_path=config.trace_path,
              cost_ledger=cost_ledger, telemetry=telemetry,
              flight=flight, flight_path=flight_path)
    obs.event("RUN_START")
    return obs


def resolve_obs(obj) -> tuple:
    """Normalize a caller-facing ``obs`` argument to ``(Obs, owned)``:

    * ``None`` → ``(NULL_OBS, False)``;
    * an ``ObsConfig`` → a freshly built bundle, OWNED by the callee
      (who must ``close()`` it when the run ends);
    * an ``Obs`` → passed through un-owned (the caller's run spans
      several subsystems under one run_id, and closes it itself)."""
    if obj is None:
        return NULL_OBS, False
    if isinstance(obj, ObsConfig):
        obs = build_obs(obj)
        return obs, obs is not NULL_OBS
    if isinstance(obj, Obs):
        return obj, False
    raise TypeError(
        f"obs must be None, an ObsConfig, or an Obs bundle; got "
        f"{type(obj).__name__}")
