"""Typed metrics registry: counters, gauges, histograms (port of
``aiyagari_hark_tpu/obs/metrics.py``; the same names, types, JSON layout
and Prometheus text, so a dashboard reads either package).

Instruments are get-or-create by name (``registry.counter``) and
thread-safe; a name re-used with another type raises.  Two encodings of
one snapshot:

* ``snapshot()`` -- a plain JSON dict that round-trips losslessly through
  ``MetricsRegistry.restore``;
* ``prometheus_text()`` -- the Prometheus exposition format.

Stdlib only, so the paths that record into it pay no import.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, Optional, Tuple

# Prometheus metric-name grammar — enforced at creation so a snapshot is
# exposition-valid by construction.
_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

# Default histogram bounds (seconds): spans the serving hit budget
# (sub-ms) through multi-minute sweep walls.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.005, 0.025, 0.1, 0.5, 2.0, 10.0, 60.0, 300.0)


class Counter:
    """Monotonically non-decreasing count (``inc`` with a negative
    amount raises — that is a gauge's job)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        amount = float(amount)
        if amount < 0.0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc({amount})); "
                "use a gauge for values that go down")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """A value that goes up and down (queue depth, overhead fraction,
    last-run wall)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += float(amount)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: ``le`` bounds,
    each bucket counts observations <= its bound, plus ``+Inf``)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError(f"histogram {name} needs >= 1 bucket bound")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)   # [+Inf] last
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            for i, b in enumerate(self.bounds):
                if value <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative_counts(self) -> list:
        """Counts per ``le`` bound, cumulative, ``+Inf`` last."""
        with self._lock:
            out, acc = [], 0
            for c in self._counts:
                acc += c
                out.append(acc)
            return out


class MetricsRegistry:
    """Named instrument registry with JSON and Prometheus export.

    ``counter``/``gauge``/``histogram`` are get-or-create: repeated
    calls with the same name return the same instrument; the same name
    with a different type raises ``ValueError``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, name: str, factory, kind: str):
        if not _NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} is not Prometheus-valid "
                "([a-zA-Z_:][a-zA-Z0-9_:]*)")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, lambda: Counter(name, help),
                                   "counter")

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help),
                                   "gauge")

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(
            name, lambda: Histogram(name, help, buckets), "histogram")

    def names(self) -> list:
        with self._lock:
            return sorted(self._metrics)

    # -- export -------------------------------------------------------------

    def snapshot(self) -> dict:
        """Every instrument as one JSON-able dict, keyed by name.  The
        inverse is ``restore``: ``restore(snapshot()).snapshot()`` is
        equal."""
        out = {}
        with self._lock:
            metrics = dict(self._metrics)
        for name in sorted(metrics):
            m = metrics[name]
            if m.kind == "histogram":
                out[name] = {"type": "histogram", "help": m.help,
                             "buckets": list(m.bounds),
                             "counts": m.cumulative_counts(),
                             "sum": m.sum, "count": m.count}
            else:
                out[name] = {"type": m.kind, "help": m.help,
                             "value": m.value}
        return out

    @classmethod
    def restore(cls, snapshot: dict) -> "MetricsRegistry":
        """Rebuild a registry from a ``snapshot()`` dict (counts and
        values restored exactly)."""
        reg = cls()
        for name, entry in snapshot.items():
            kind = entry["type"]
            if kind == "counter":
                reg.counter(name, entry.get("help", ""))._value = float(
                    entry["value"])
            elif kind == "gauge":
                reg.gauge(name, entry.get("help", "")).set(entry["value"])
            elif kind == "histogram":
                h = reg.histogram(name, entry.get("help", ""),
                                  tuple(entry["buckets"]))
                cum = list(entry["counts"])
                h._counts = [cum[0]] + [cum[i] - cum[i - 1]
                                        for i in range(1, len(cum))]
                h._sum = float(entry["sum"])
                h._count = int(entry["count"])
            else:
                raise ValueError(f"unknown metric type {kind!r} "
                                 f"for {name!r}")
        return reg

    def prometheus_text(self) -> str:
        """The Prometheus text exposition of every instrument."""
        lines = []
        snap = self.snapshot()
        for name, entry in snap.items():
            if entry.get("help"):
                lines.append(f"# HELP {name} {entry['help']}")
            lines.append(f"# TYPE {name} {entry['type']}")
            if entry["type"] == "histogram":
                for bound, c in zip(entry["buckets"], entry["counts"]):
                    lines.append(f'{name}_bucket{{le="{bound:g}"}} {c}')
                lines.append(f'{name}_bucket{{le="+Inf"}} '
                             f'{entry["counts"][-1]}')
                lines.append(f"{name}_sum {entry['sum']:g}")
                lines.append(f"{name}_count {entry['count']}")
            else:
                lines.append(f"{name} {entry['value']:g}")
        return "\n".join(lines) + ("\n" if lines else "")


# Process-global default registry: ambient consumers (one-off scripts)
# share it; run-scoped consumers build their own through ``ObsConfig``,
# so two concurrent runs' numbers cannot blend.
_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT


def reset_default_registry() -> None:
    """Drop the process-global registry (tests)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = None
