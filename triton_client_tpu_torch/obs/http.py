"""Telemetry HTTP endpoint: /metrics, /traces, /snapshot, /profile and
/history on one port (the port's copy of ``obs/http.py``).

  GET /metrics   Prometheus exposition of the server's registry
  GET /traces    Chrome-trace JSON of the tracer ring (?n=K: the K most
                 recent; ?slo_violations=1: the SLO tail ring instead, the
                 exemplars that missed their deadline or landed at or above
                 their model's live p99)
  GET /snapshot  RuntimeCollector.snapshot() as JSON
  GET /profile   a ``torch.profiler`` window (?seconds=N, default 1, capped
                 at 60; ?top_k=K bounds the op rows): blocks for the window,
                 writes the trace into a server-local directory and returns
                 its path and the parsed per-op summary (obs.opstats: op,
                 kind, model, stage, occurrences, device time). One capture
                 at a time: a concurrent request gets 409. A trace that
                 fails to parse still returns the path (``op_summary_error``
                 names the failure) and never wedges the capture guard.
  GET /history   the MetricHistory ring (?n=K most recent entries)

Paths degrade independently: without ``prometheus_client`` /metrics is 503
and the traces still export; without a tracer /traces is 404 (without an
SLO tracker ?slo_violations=1 is 404); without torch's profiler /profile
is 503; without a history ring /history is 404.
"""

from __future__ import annotations

import json
import logging
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

log = logging.getLogger(__name__)

#: ceiling of one /profile capture window
_PROFILE_MAX_S = 60.0


def _int_param(q: dict, key: str, default: int) -> int:
    try:
        return int(q.get(key, [str(default)])[0])
    except ValueError:
        return default


class TelemetryServer:
    """Bound on construction (port 0 picks an ephemeral port); serves on a
    daemon thread until :meth:`close`."""

    def __init__(
        self,
        port: int = 8002,
        registry=None,
        tracer=None,
        collector=None,
        host: str = "0.0.0.0",
        slo=None,
        history=None,
    ) -> None:
        self._registry = registry
        self._tracer = tracer
        self._collector = collector
        self._slo = slo
        self._history = history
        # the capture guard: one profiler session a process, shared with the
        # continuous sampler
        self._profile_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # no stderr line a scrape
                log.debug("telemetry http: " + fmt, *args)

            def do_GET(self):
                try:
                    outer._handle(self)
                except BrokenPipeError:
                    pass  # the scraper went away mid-response
                except Exception:
                    log.exception("telemetry handler failed for %s", self.path)
                    try:
                        self.send_error(500)
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="telemetry-http", daemon=True
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def profile_lock(self) -> threading.Lock:
        """The capture guard the ``ContinuousSampler`` shares, so background
        windows and ``/profile`` captures never overlap."""
        return self._profile_lock

    def _handle(self, req) -> None:
        parsed = urlparse(req.path)
        path = parsed.path.rstrip("/") or "/"
        q = parse_qs(parsed.query)
        if path == "/metrics":
            if self._registry is None:
                self._send(req, 503, b"prometheus_client unavailable\n")
                return
            import prometheus_client

            body = prometheus_client.generate_latest(self._registry)
            self._send(req, 200, body, prometheus_client.CONTENT_TYPE_LATEST)
        elif path in ("/traces", "/trace"):
            n = _int_param(q, "n", 0)
            if q.get("slo_violations", ["0"])[0] not in ("0", ""):
                if self._slo is None:
                    self._send(req, 404, b"slo tracking disabled\n")
                    return
                from triton_client_tpu_torch.obs.trace import chrome_trace

                payload = chrome_trace(self._slo.violations(n))
            elif self._tracer is None:
                self._send(req, 404, b"tracing disabled\n")
                return
            else:
                payload = self._tracer.chrome_trace(n)
            self._send(req, 200, json.dumps(payload).encode(), "application/json")
        elif path == "/snapshot":
            if self._collector is None:
                self._send(req, 404, b"collector disabled\n")
                return
            body = json.dumps(self._collector.snapshot(), default=str).encode()
            self._send(req, 200, body, "application/json")
        elif path == "/profile":
            self._profile(req, q)
        elif path == "/history":
            if self._history is None:
                self._send(req, 404, b"metric history disabled\n")
                return
            n = _int_param(q, "n", 0)
            body = json.dumps(
                {"stats": self._history.stats(), "snapshots": self._history.snapshots(n)}
            ).encode()
            self._send(req, 200, body, "application/json")
        elif path == "/":
            self._send(req, 200,
                       b"tpu_serving telemetry: /metrics /traces /snapshot /profile /history\n")
        else:
            self._send(req, 404, b"not found\n")

    def _profile(self, req, q) -> None:
        """A blocking profiler window; refuses overlap. The guard covers the
        capture only: it is released before the (pure-file) parse, so a
        malformed trace degrades to ``op_summary_error``."""
        try:
            seconds = float(q.get("seconds", ["1"])[0])
        except ValueError:
            self._send(req, 400, b"seconds must be a number\n")
            return
        top_k = _int_param(q, "top_k", 20)
        seconds = min(max(seconds, 0.05), _PROFILE_MAX_S)
        try:
            from triton_client_tpu_torch.obs.profiling import device_trace
        except ImportError:
            self._send(req, 503, b"torch.profiler unavailable; /profile disabled\n")
            return
        if not self._profile_lock.acquire(blocking=False):
            self._send(req, 409, b"a profile capture is already in progress\n")
            return
        try:
            log_dir = tempfile.mkdtemp(prefix="tpu_serving_profile_")
            with device_trace(log_dir):
                time.sleep(seconds)
        except Exception as e:
            log.exception("profile capture failed")
            self._send(req, 500, f"profile capture failed: {e}\n".encode())
            return
        finally:
            self._profile_lock.release()
        doc = {"log_dir": log_dir, "seconds": seconds}
        try:
            from triton_client_tpu_torch.obs import opstats

            modules = None
            if self._collector is not None:
                hlo_modules = getattr(self._collector, "hlo_modules", None)
                if callable(hlo_modules):
                    modules = hlo_modules()
            doc["op_summary"] = opstats.summarize_profile_dir(
                log_dir, launchers=modules, top_k=top_k)
        except Exception as e:
            log.exception("profile trace parse failed")
            doc["op_summary_error"] = str(e)
        self._send(req, 200, json.dumps(doc).encode(), "application/json")

    @staticmethod
    def _send(req, code: int, body: bytes, ctype: str = "text/plain") -> None:
        req.send_response(code)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
