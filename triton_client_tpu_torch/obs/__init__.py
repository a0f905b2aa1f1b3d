"""Request-scoped serving telemetry (the port's copy of ``obs/__init__.py``).

- ``trace``: per-request spans, a bounded ring of recent request traces and
  the Chrome-trace export.
- ``collector``: the channel's and the batcher's ``stats()``, the card's
  memory and the CUDA-graph captures as Prometheus gauges, counters and
  histograms, with a ``snapshot()`` that scripts and the scrape share.
- ``histogram`` and ``slo``: per-(model, stage) latency histograms and SLO
  attainment with its tail-exemplar ring.
- ``http``: one endpoint on the metrics port serving ``/metrics``,
  ``/traces``, ``/snapshot``, ``/profile`` and ``/history``.
"""

from triton_client_tpu_torch.obs.trace import (
    MultiTrace,
    RequestTrace,
    Span,
    Tracer,
    chrome_trace,
)
from triton_client_tpu_torch.obs.collector import (
    METRIC_TYPES,
    CompileEvents,
    RuntimeCollector,
)
from triton_client_tpu_torch.obs.histogram import (
    DEFAULT_BUCKETS,
    SLO_STAGES,
    HistogramFamily,
    LatencyHistogram,
    quantile_from_snapshot,
)
from triton_client_tpu_torch.obs.http import TelemetryServer
from triton_client_tpu_torch.obs.slo import SLOTracker

__all__ = [
    "DEFAULT_BUCKETS",
    "METRIC_TYPES",
    "SLO_STAGES",
    "CompileEvents",
    "HistogramFamily",
    "LatencyHistogram",
    "MultiTrace",
    "RequestTrace",
    "RuntimeCollector",
    "SLOTracker",
    "Span",
    "TelemetryServer",
    "Tracer",
    "chrome_trace",
    "quantile_from_snapshot",
]
