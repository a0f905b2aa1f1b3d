"""Prometheus export for the online evaluator (the port's copy of
``eval/prometheus_export.py``).

Parity with the reference's client-side exporter: five Summary metrics,
observed per evaluated frame. prometheus_client is imported when an
exporter is built: constructing one without the package raises, and
``available()`` lets drivers degrade gracefully.

Two forms: ``registry=<CollectorRegistry>`` (or ``into(registry)``)
registers the Summaries on a caller's registry, to be served on that
caller's scrape endpoint; the standalone form (its own registry and
HTTP server, port 7658 by default) is what ``evaluate``'s
``--prometheus-port`` serves, and warns that it is deprecated, as the
JAX package's does.
"""

from __future__ import annotations

import warnings

import numpy as np

DEFAULT_PORT = 7658


def _prometheus_client():
    try:
        import prometheus_client
    except ImportError:
        return None
    return prometheus_client


def available() -> bool:
    return _prometheus_client() is not None


class EvalPrometheusExporter:
    """Five Summaries (precision/recall/ap/f1/ap_class).

    ``registry=None`` (legacy): a private registry, optionally served
    from its own HTTP port — the reference's standalone exporter, kept
    as a deprecation shim. ``registry=<CollectorRegistry>``: register
    the same Summaries into a caller's registry instead (``port`` and
    ``start_server`` are then ignored: the caller serves its registry)."""

    def __init__(
        self,
        port: int = DEFAULT_PORT,
        start_server: bool = True,
        registry=None,
    ) -> None:
        prometheus_client = _prometheus_client()
        if prometheus_client is None:
            raise ImportError("prometheus_client is not installed")
        folded = registry is not None
        if not folded:
            registry = prometheus_client.CollectorRegistry()
            if start_server:
                warnings.warn(
                    "the standalone port-7658 eval exporter is "
                    "deprecated: pass registry=<RuntimeCollector "
                    "registry> (or scrape the serving telemetry port) "
                    "instead",
                    DeprecationWarning,
                    stacklevel=2,
                )
        self.registry = registry
        self.folded = folded
        s = prometheus_client.Summary
        self.p_summary = s("model_precision", "per-class precision", registry=registry)
        self.r_summary = s("model_recall", "per-class recall", registry=registry)
        self.ap_summary = s("model_ap", "per-class AP@0.5", registry=registry)
        self.f1_summary = s("model_f1", "per-class F1", registry=registry)
        self.ap_class_summary = s(
            "model_ap_class", "class ids contributing AP", registry=registry
        )
        if not folded and start_server:
            prometheus_client.start_http_server(port, registry=registry)

    @classmethod
    def into(cls, registry) -> "EvalPrometheusExporter":
        """The folded spelling: Summaries on the shared registry."""
        return cls(registry=registry)

    def observe(self, p, r, ap, f1, classes) -> None:
        """Observe one ap_per_class result, value-by-value as the
        reference does (evaluate_inference.py:440-444)."""
        for v in np.atleast_1d(p):
            self.p_summary.observe(float(v))
        for v in np.atleast_1d(r):
            self.r_summary.observe(float(v))
        ap = np.atleast_2d(ap)
        for v in ap[:, 0] if ap.size else ():
            self.ap_summary.observe(float(v))
        for v in np.atleast_1d(f1):
            self.f1_summary.observe(float(v))
        for v in np.atleast_1d(classes):
            self.ap_class_summary.observe(float(v))

    def observe_window(self, window: dict) -> None:
        """Quality-plane bridge: one finished rolling window observed
        under the legacy spellings (aggregate precision/recall/AP@0.5/
        F1 — the window summary has no per-class split to fan out)."""
        self.p_summary.observe(float(window.get("precision", 0.0)))
        self.r_summary.observe(float(window.get("recall", 0.0)))
        self.ap_summary.observe(float(window.get("map50", 0.0)))
        self.f1_summary.observe(float(window.get("f1", 0.0)))
