"""Run-scoped tracing spans with Chrome-trace export (port of
``aiyagari_hark_tpu/obs/trace.py``).

A ``Tracer`` records nestable host-side spans (``with
tracer.span("sweep/bucket", bucket=2): ...``) with monotonic walls and
JSON-able attributes, correlated by a per-run ``run_id`` shared with the
metrics registry and the event journal, and exports the Chrome-trace
JSON that ``chrome://tracing`` and Perfetto load.

* **Near-free when off.**  ``NULL_SPAN_CM`` is ONE cached
  ``contextlib.nullcontext`` reused by every disabled call site: no
  allocation, no clock read, no lock.
* **Host side only.**  Spans bracket host seams (a bucket launch, a
  quarantine rung) whose work already ends with the rows on the host, so
  a span adds no device synchronisation.  The phases inside a launch are
  reconstructed from the counters it returns (``Span.subdivide``:
  synthetic children splitting the parent's wall by descent/polish
  steps, marked ``synthetic``).
* **Thread-safe.**  Nesting is tracked per thread; each thread renders
  as its own Chrome-trace ``tid`` row.

The bridge to the device: a span opened with ``device_profile=True`` on
a tracer built with ``device_trace_dir`` runs its body under
``utils.timing.device_trace`` (``torch.profiler``, CPU and CUDA
activities), whose Chrome trace lands under that directory.  A profiler
cannot nest: inside another profiled span (or any running
``torch.profiler``) the body runs unprofiled.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional


def new_run_id() -> str:
    """A fresh run correlation id: sortable timestamp + random suffix,
    filesystem- and grep-safe.  Every artifact of one run — trace,
    journal lines, metrics snapshot, bench record — carries the same
    value (the correlation contract, DESIGN §10)."""
    import secrets

    return (time.strftime("run-%Y%m%dT%H%M%S-")
            + secrets.token_hex(4))


class _NullSpan:
    """The disabled span: every mutator is a no-op.  A single instance
    rides inside the single cached null context manager."""

    __slots__ = ()

    def annotate(self, **attrs) -> None:
        pass

    def subdivide(self, parts, prefix: str = "") -> None:
        pass


NULL_SPAN = _NullSpan()
# THE cached no-op context manager: ``nullcontext`` is
# stateless across __enter__/__exit__, so one instance serves every
# disabled ``span()`` call in the process, re-entrantly.
NULL_SPAN_CM = contextlib.nullcontext(NULL_SPAN)


class Span:
    """One live (or finished) span.  Mutable so the body can attach
    attributes discovered during the work (``annotate``) and phase
    splits known only from returned counters (``subdivide``)."""

    __slots__ = ("name", "attrs", "t0", "t1", "tid", "parent",
                 "synthetic", "external", "_parts")

    def __init__(self, name: str, attrs: dict, t0: float, tid: int,
                 parent: Optional["Span"], synthetic: bool = False,
                 external: bool = False):
        self.name = name
        self.attrs = attrs
        self.t0 = t0
        self.t1: Optional[float] = None
        self.tid = tid
        self.parent = parent
        self.synthetic = synthetic
        self.external = external
        self._parts = None

    def annotate(self, **attrs) -> None:
        """Attach attributes to the span (merged into Chrome-trace
        ``args``)."""
        self.attrs.update(attrs)

    def subdivide(self, parts: dict, prefix: str = "") -> None:
        """Declare a proportional phase split of this span's wall —
        e.g. ``{"descent": d_steps, "polish": p_steps}`` from a fixed
        point's returned counters.  At span exit the tracer materializes
        one SYNTHETIC child span per non-zero part, partitioning
        ``[t0, t1]`` by weight: the inside of a launch is not traced,
        but its phase budget is known from its counters."""
        self._parts = (dict(parts), prefix)

    def duration(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0


class Tracer:
    """Run-scoped span recorder.  ``span()`` is a context manager;
    completed spans accumulate until ``chrome_trace()`` /
    ``save_chrome_trace()`` export them."""

    # Completed-span cap: a long-lived traced service records one
    # external span per served query, and an unbounded list would grow
    # without limit at serving scale (and choke
    # the trace viewer long before memory).  Past the cap new spans are
    # DROPPED and counted — the count rides the export metadata, so a
    # truncated trace can never read as a complete one.
    DEFAULT_MAX_SPANS = 200_000

    def __init__(self, run_id: Optional[str] = None,
                 clock=time.perf_counter,
                 device_trace_dir: Optional[str] = None,
                 max_spans: int = DEFAULT_MAX_SPANS):
        self.run_id = run_id if run_id is not None else new_run_id()
        self._clock = clock
        self._t_base = clock()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._tids: Dict[int, int] = {}
        self.device_trace_dir = device_trace_dir
        self.max_spans = int(max_spans)
        self.dropped = 0
        self.spans: List[Span] = []
        # counter-track samples: (name, t, values) triples
        # exported as Chrome "C" events — the cost ledger's per-launch
        # achieved-FLOP/s stream renders as its own counter row in
        # Perfetto.  Same bounded-and-counted policy as spans.
        self._counters: List[tuple] = []
        self.counters_dropped = 0

    def _append(self, sp: Span) -> None:
        # Dropping the NEWEST keeps nesting exportable — children
        # complete (and append) before their parents, so a kept child
        # never dangles above a dropped ancestor's sibling.
        with self._lock:
            if len(self.spans) >= self.max_spans:
                self.dropped += 1
            else:
                self.spans.append(sp)

    # -- recording ----------------------------------------------------------

    def now(self) -> float:
        return self._clock()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            if ident not in self._tids:
                self._tids[ident] = len(self._tids)
            return self._tids[ident]

    @contextlib.contextmanager
    def span(self, name: str, device_profile: bool = False, **attrs):
        """Open a nested span.  ``device_profile=True`` also profiles the
        span body on the device when the tracer was built with
        ``device_trace_dir`` (``utils.timing.device_trace``) -- opt-in
        twice, because a profiler dump costs wall and disk."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        sp = Span(name, dict(attrs), self._clock(), self._tid(), parent)
        stack.append(sp)
        profile_dir = (self.device_trace_dir
                       if device_profile and self.device_trace_dir
                       else None)
        try:
            if profile_dir is not None:
                from ..utils.timing import device_trace

                sp.attrs.setdefault("device_trace_dir", profile_dir)
                with device_trace(profile_dir):
                    yield sp
            else:
                yield sp
        finally:
            sp.t1 = self._clock()
            stack.pop()
            self._append(sp)

    @staticmethod
    def _materialized_parts(sp: Span) -> list:
        """Synthetic child spans from a ``subdivide`` declaration —
        computed at EXPORT time, because the counters that define the
        split are typically attached right after the span's ``with``
        block exits (the launch must finish before its phase totals
        exist)."""
        if sp._parts is None or sp.t1 is None:
            return []
        parts, prefix = sp._parts
        total = float(sum(max(0.0, float(v)) for v in parts.values()))
        if total <= 0.0:
            return []
        out = []
        t = sp.t0
        wall = sp.t1 - sp.t0
        for part_name, weight in parts.items():
            w = max(0.0, float(weight))
            if w == 0.0:
                continue
            child = Span(f"{prefix}{part_name}",
                         {"synthetic": True, "weight": w},
                         t, sp.tid, sp, synthetic=True)
            t = min(sp.t1, t + wall * (w / total))
            child.t1 = t
            out.append(child)
        return out

    def counter(self, name: str, **values) -> None:
        """Record one counter-track sample at now (Chrome-trace "C"
        event): ``tracer.counter("profile/sweep/achieved_flops_per_sec",
        value=2.6e8)``.  Values must be numeric; each distinct ``name``
        renders as its own counter row in the trace viewer."""
        t = self._clock()
        sample = (name, t, {str(k): float(v) for k, v in values.items()})
        with self._lock:
            if len(self._counters) >= self.max_spans:
                self.counters_dropped += 1
            else:
                self._counters.append(sample)

    def record(self, name: str, duration_s: float, **attrs) -> None:
        """Record an externally-timed span ending now — for paths whose
        start predates any tracer involvement (a serve query's
        submit→resolve latency, timed by the service's own clock).

        External spans are NOT stack spans: several queries resolved by
        one batch flush genuinely overlap in the resolving thread, so
        they export as Chrome ASYNC events (``ph: "b"/"e"``), which
        viewers draw on their own track and ``trace_nesting_ok``'s
        same-row containment invariant deliberately ignores."""
        t1 = self._clock()
        sp = Span(name, dict(attrs), t1 - max(0.0, float(duration_s)),
                  self._tid(), None, external=True)
        sp.t1 = t1
        self._append(sp)

    # -- export -------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """The Chrome-trace (Perfetto) JSON object: stack spans as
        complete ("X") events in microseconds relative to the tracer's
        epoch (one tid row per recording thread), externally-timed
        ``record`` spans as async begin/end ("b"/"e") pairs on their own
        track, attributes in ``args`` with the ``run_id`` stamped on
        every begin/complete event and in ``metadata``."""
        import os

        pid = os.getpid()
        events = []
        with self._lock:
            spans = list(self.spans)
            dropped = self.dropped
            counters = list(self._counters)
            counters_dropped = self.counters_dropped
        expanded = []
        for sp in spans:
            expanded.append(sp)
            expanded.extend(self._materialized_parts(sp))
        for n_async, sp in enumerate(expanded):
            if sp.t1 is None:
                continue        # still open (another thread): skip
            args = {k: _jsonable(v) for k, v in sp.attrs.items()}
            args["run_id"] = self.run_id
            ts0 = round((sp.t0 - self._t_base) * 1e6, 3)
            ts1 = round((sp.t1 - self._t_base) * 1e6, 3)
            if sp.external:
                # externally-timed spans (``record``) overlap freely —
                # async begin/end pairs, matched by (cat, id, name)
                base = {"name": sp.name, "cat": "external",
                        "id": f"0x{n_async:x}", "pid": pid,
                        "tid": sp.tid}
                events.append({**base, "ph": "b", "ts": ts0,
                               "args": args})
                events.append({**base, "ph": "e", "ts": ts1})
                continue
            events.append({
                "name": sp.name,
                "ph": "X",
                "ts": ts0,
                # duration of the ROUNDED endpoints (not a third
                # independent rounding): ts + dur is then exactly ts1,
                # so a synthetic child sharing its parent's t1 can never
                # export an end a rounding-ulp past the parent's
                "dur": round(ts1 - ts0, 3),
                "pid": pid,
                "tid": sp.tid,
                "args": args,
            })
        for name, t, values in counters:
            events.append({
                "name": name,
                "ph": "C",
                "ts": round((t - self._t_base) * 1e6, 3),
                "pid": pid,
                "tid": 0,
                "args": values,
            })
        events.sort(key=lambda e: e["ts"])
        meta = {"run_id": self.run_id}
        if dropped:
            meta["spans_dropped"] = dropped   # never a silent cap
        if counters_dropped:
            meta["counters_dropped"] = counters_dropped
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "metadata": meta}

    def save_chrome_trace(self, path: str) -> None:
        """Write the trace crash-consistently (``atomic_write_json``) —
        a preempted run must leave either the previous trace or a valid
        one, never a torn JSON that chrome://tracing rejects."""
        from ..utils.checkpoint import atomic_write_json

        atomic_write_json(path, self.chrome_trace())


def _jsonable(v):
    """Coerce an attribute value to something ``json.dumps`` accepts:
    numpy scalars/arrays become Python numbers/lists, everything else
    unknown becomes ``str``.  A tensor on the card is described by its
    shape and device, never copied to the host."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if getattr(v, "is_cuda", False):
        # a device tensor is named, never read: reading it would sync
        return f"<tensor {tuple(v.shape)} on {v.device}>"
    tolist = getattr(v, "tolist", None)
    if tolist is not None:
        try:
            return _jsonable(tolist())
        except Exception:   # noqa: BLE001 — attribute coercion best-effort
            pass
    item = getattr(v, "item", None)
    if item is not None:
        try:
            return _jsonable(item())
        except Exception:   # noqa: BLE001
            pass
    return str(v)


def trace_nesting_ok(trace: dict) -> bool:
    """Structural sanity of an exported Chrome trace: every complete
    ("X") event has a non-negative duration, and within each tid row
    they are properly nested (any two either disjoint or one containing
    the other — the invariant a span STACK guarantees and a
    torn/mixed-up export breaks).  Async ("b"/"e") pairs — externally
    timed ``record`` spans, which legitimately overlap — are exempt.
    """
    by_tid: dict = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        if e.get("dur", -1) < 0:
            return False
        by_tid.setdefault(e.get("tid"), []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    eps = 0.5   # µs slack: exported timestamps are rounded to 1e-3 µs
    for intervals in by_tid.values():
        # containers before their same-start children: sort by start
        # ascending, then LONGEST first, so a child beginning exactly at
        # its parent's start nests instead of reading as an overlap
        intervals.sort(key=lambda iv: (iv[0], -iv[1]))
        stack: list = []
        for (t0, t1) in intervals:
            while stack and t0 >= stack[-1] - eps:
                stack.pop()
            if stack and t1 > stack[-1] + eps:
                return False    # overlap without containment
            stack.append(t1)
    return True
