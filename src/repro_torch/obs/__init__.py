"""Observability layer: metrics registry, span tracing, tick profiling,
windowed time series, and SLO burn-rate evaluation.

- ``obs.metrics`` — dependency-free counters / gauges / log-bucket
  histograms behind a ``MetricsRegistry`` (JSON-able snapshots).
- ``obs.trace`` — bounded ring of completed spans, exported as Chrome
  trace-event JSON (Perfetto-loadable).
- ``obs.profiler`` — ``torch.profiler`` capture around N steady-state
  engine ticks, plus a blocking probe that splits dispatch time into
  host enqueue and device wait.
- ``obs.timeseries`` — bounded ring of timestamped registry samples
  with counter-delta windowed rates and JSONL sidecar export.
- ``obs.slo`` — declarative SLO specs (error budgets, p99 latency
  targets) judged by multi-window burn-rate rules over the time
  series: ``healthy`` / ``degraded`` / ``breach``.

The port's copies of the reference's ``repro.obs``; nothing here imports
JAX.
"""

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import Span, TraceRecorder
from repro_torch.obs.profiler import (
    dispatch_attribution,
    profile_ticks,
    tick_instrumentation_cost_us,
)
from repro_torch.obs.timeseries import Sample, TimeSeriesSampler
from repro_torch.obs.slo import (
    BurnRateRule,
    ErrorBudgetSLO,
    LatencySLO,
    STATUS_CODES,
    default_slos,
    evaluate as evaluate_slos,
    shed_rate_slo,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "TraceRecorder",
    "dispatch_attribution",
    "profile_ticks",
    "tick_instrumentation_cost_us",
    "Sample",
    "TimeSeriesSampler",
    "BurnRateRule",
    "ErrorBudgetSLO",
    "LatencySLO",
    "STATUS_CODES",
    "default_slos",
    "evaluate_slos",
    "shed_rate_slo",
]
