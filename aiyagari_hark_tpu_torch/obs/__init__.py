"""The observability layer (port of ``aiyagari_hark_tpu/obs``, with the
same exports, event types, metric names and JSON layouts): run-scoped
tracing spans, a typed metrics registry and a structured event journal,
correlated by one ``run_id``, plus the performance tier (cost ledger,
roofline, device telemetry, flight recorder) and the bench-regression
sentinel.

* ``trace`` — nestable host-side spans with Chrome-trace export and an
  opt-in ``utils.timing.device_trace`` (``torch.profiler``) bridge;
* ``metrics`` — counters, gauges, histograms with Prometheus text and
  round-tripping JSON snapshots;
* ``journal`` — append-only JSONL of typed lifecycle events emitted at
  every seam of the sweep engine and the deep layers (retries, resume,
  checksums, disk faults, certification, divergence).

Off by default (``NULL_OBS``; the no-op span is one cached null context
manager).  Enable with ``ObsConfig`` on ``SweepConfig(obs=...)`` or the
``obs=`` argument of ``run_sweep`` / ``run_table2_sweep``.  Stdlib only
at import, apart from ``profile``'s lazy torch calls.
"""

from .journal import EVENT_TYPES, EventJournal, read_journal  # noqa: F401
from .metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    reset_default_registry,
)
from .profile import (  # noqa: F401
    ROOFLINE_CLASSES,
    ROOFLINE_COMPUTE,
    ROOFLINE_LATENCY,
    ROOFLINE_MEMORY,
    ROOFLINE_UNKNOWN,
    CostEntry,
    CostLedger,
    DeviceTelemetry,
    classify_roofline,
    peak_membw_per_chip,
)
from .regress import (  # noqa: F401
    NOISE,
    OK,
    REGRESSED,
    MetricFinding,
    RegressionReport,
    UnknownMetricError,
    direction_of_goodness,
    evaluate_history,
    flatten_record,
)
from .runtime import (  # noqa: F401
    NULL_INSTRUMENT,
    NULL_OBS,
    FlightRecorder,
    Obs,
    ObsConfig,
    active_obs,
    active_span,
    build_obs,
    emit_event,
    resolve_obs,
)
from .trace import (  # noqa: F401
    NULL_SPAN,
    NULL_SPAN_CM,
    Span,
    Tracer,
    new_run_id,
    trace_nesting_ok,
)
