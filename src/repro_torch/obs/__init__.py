"""Observability: tracing, metrics, workload heat, and time series.

Four pieces, all stdlib + numpy only:

  * :mod:`repro_torch.obs.trace` — opt-in per-query spans propagated on a
    W3C-style ``traceparent``, recorded in the process-local
    :data:`TRACER`, shipped across the worker RPC in reply headers, and
    assembled into one span tree at the gateway (which also keeps the
    bounded :class:`SlowQueryLog` behind ``GET /debug/slow``), with
    :class:`TraceSampler` head/tail sampling for production rates;
  * :mod:`repro_torch.obs.metrics` — counters / gauges / fixed-bucket
    :class:`LatencyHistogram`\\ s behind a :class:`MetricsRegistry` with
    Prometheus/OpenMetrics text exposition (``GET /metrics``, histogram
    bucket exemplars).  The histogram is also ``QueryStats``' latency
    store, replacing the unbounded sample list;
  * :mod:`repro_torch.obs.heat` — per-worker workload heat (:class:`HeatSketch`:
    count-min keyword counts, space-saving top-K, doc-range histogram),
    merged across workers on the stats wire like the latency histogram
    and consumed by ``ClusterService.load_report()`` / ``GET /debug/heat``;
  * :mod:`repro_torch.obs.timeseries` — :class:`TimeSeriesStore`, a bounded
    ring-buffer history of every registry metric sampled on a daemon
    thread (``GET /debug/timeseries``).
"""
from .heat import CountMinSketch, HeatShapeError, HeatSketch, SpaceSaving
from .metrics import (
    DEFAULT_BUCKETS_MS,
    BucketMismatchError,
    Counter,
    Gauge,
    Histogram,
    LatencyHistogram,
    MetricsRegistry,
    sanitize_metric_name,
)
from .timeseries import TimeSeriesStore
from .trace import (
    NULL_SPAN,
    TRACER,
    SlowQueryLog,
    Span,
    TraceContext,
    Tracer,
    TraceSampler,
    emit_phases,
    make_traceparent,
    new_span_id,
    new_trace_id,
    parse_traceparent,
)

__all__ = [
    "BucketMismatchError",
    "CountMinSketch",
    "DEFAULT_BUCKETS_MS",
    "Counter",
    "Gauge",
    "HeatShapeError",
    "HeatSketch",
    "Histogram",
    "LatencyHistogram",
    "MetricsRegistry",
    "NULL_SPAN",
    "SlowQueryLog",
    "SpaceSaving",
    "Span",
    "TRACER",
    "TimeSeriesStore",
    "TraceContext",
    "TraceSampler",
    "Tracer",
    "emit_phases",
    "make_traceparent",
    "new_span_id",
    "new_trace_id",
    "parse_traceparent",
    "sanitize_metric_name",
]
