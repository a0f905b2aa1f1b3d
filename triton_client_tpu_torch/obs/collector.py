"""Runtime collector: the serving stack's in-process counters -> Prometheus
(the port's copy of ``obs/collector.py``).

``CUDAChannel`` and the batchers keep their counters in plain dicts
(``stats()``), so recording costs an increment under a lock the path
already holds. :class:`RuntimeCollector` is the bridge:

- ``snapshot()`` / ``delta()``: one structured read of everything (channel,
  batcher, device memory, graph captures, errors, histograms, SLO, device
  time), for scripts and for the Prometheus export alike, so both read the
  same numbers;
- a Prometheus custom collector: registered into a (per-server) registry,
  it turns a snapshot into typed gauge, counter and histogram families at
  scrape time (no background thread, no second book).

Every family of :data:`METRIC_TYPES` is exported even when its component
is absent (the lifecycle and sessions families export zeros without a
lifecycle or session manager; the quality and temporal planes are not
ported: their families export zeros), so a dashboard built on the JAX package's names
reads the same series. Two readings are the port's own:

- :class:`CompileEvents` counts CUDA-graph captures (``runtime/graphs``,
  the port's compile of a new input signature) under JAX's
  ``tpu_serving_jit_compiles_total`` family, where JAX counts XLA
  compilations through ``jax.monitoring``;
- the device-memory gauges read ``torch.cuda.memory_stats`` and
  ``mem_get_info`` for the channel's card, and nothing on a CPU channel.

``prometheus_client`` is imported only when a registry scrapes.
"""

from __future__ import annotations

import logging
import threading

log = logging.getLogger(__name__)

# Every family the collector always exports, name -> Prometheus type (the
# JAX package's inventory). Families exist (HELP/TYPE lines) even when their
# component is absent or idle. The device-memory gauges are not here: they
# exist only where the channel's device reports memory (a card, not a CPU).
METRIC_TYPES: dict[str, str] = {
    # server / request plane
    "tpu_serving_inflight_requests": "gauge",
    "tpu_serving_request_errors_total": "counter",
    # the staged channel's slots
    "tpu_serving_inflight_batches": "gauge",
    "tpu_serving_staging_slots_active": "gauge",
    "tpu_serving_pipeline_depth": "gauge",
    "tpu_serving_staged_requests_total": "counter",
    "tpu_serving_launched_batches_total": "counter",
    "tpu_serving_donated_launches_total": "counter",
    "tpu_serving_stage_slot_waits_total": "counter",
    "tpu_serving_slot_occupancy_launches_total": "counter",
    # serving mesh shape (1/1 on one card, 0 when no channel)
    "tpu_serving_data_axis_size": "gauge",
    "tpu_serving_mesh_devices": "gauge",
    # batch formation
    "tpu_serving_queue_depth": "gauge",
    "tpu_serving_batch_active_slots": "gauge",
    "tpu_serving_batch_fill_ratio": "gauge",
    "tpu_serving_batch_merges_total": "counter",
    "tpu_serving_batched_frames_total": "counter",
    "tpu_serving_padded_frames_total": "counter",
    "tpu_serving_batch_launch_frees_total": "counter",
    "tpu_serving_merge_occupancy_total": "counter",
    # dispatcher stall watchdog
    "tpu_serving_dispatcher_stalled": "gauge",
    "tpu_serving_dispatcher_last_progress_seconds": "gauge",
    # padding tax: the padded share of device rows, the merge occupancy as a
    # histogram, and the packed ragged route
    "tpu_serving_pad_fraction": "gauge",
    "tpu_serving_batch_occupancy": "histogram",
    "tpu_serving_ragged_batches_total": "counter",
    "tpu_serving_ragged_rows_total": "counter",
    "tpu_serving_ragged_pad_rows_total": "counter",
    # per-model precision policy and parameter bytes
    "tpu_serving_model_precision_info": "gauge",
    "tpu_serving_model_param_bytes": "gauge",
    # compile events (the port: CUDA-graph captures, process-global)
    "tpu_serving_jit_compiles_total": "counter",
    "tpu_serving_jit_compile_seconds_total": "counter",
    # tracer ring buffer
    "tpu_serving_traces_finished_total": "counter",
    "tpu_serving_trace_buffered": "gauge",
    # SLO plane: per (model, stage) latency histograms fed from finished
    # traces, attainment per (model, priority, outcome), the tail ring's
    # depth, and launches whose deadline had passed
    "tpu_serving_latency_seconds": "histogram",
    "tpu_serving_slo_requests_total": "counter",
    "tpu_serving_slo_tail_buffered": "gauge",
    "tpu_serving_deadline_expired_launches_total": "counter",
    # overload control: sheds by stage, breaker state and opens, admission
    # queue depth, the drain flag
    "tpu_serving_shed_total": "counter",
    "tpu_serving_breaker_state": "gauge",
    "tpu_serving_breaker_opens_total": "counter",
    "tpu_serving_admission_queue_depth": "gauge",
    "tpu_serving_draining": "gauge",
    # multi-tenant lifecycle (zeros without a lifecycle manager)
    "tpu_serving_hbm_budget_bytes": "gauge",
    "tpu_serving_hbm_resident_bytes": "gauge",
    "tpu_serving_tenant_hbm_bytes": "gauge",
    "tpu_serving_lifecycle_models": "gauge",
    "tpu_serving_model_promotions_total": "counter",
    "tpu_serving_model_evictions_total": "counter",
    "tpu_serving_promotion_seconds": "histogram",
    "tpu_serving_tenant_shed_total": "counter",
    "tpu_serving_tenant_served_frames_total": "counter",
    # device time: cumulative device seconds per model x tenant, the
    # rolling busy ratio, live MFU
    "tpu_serving_device_seconds_total": "counter",
    "tpu_serving_device_utilization_ratio": "gauge",
    "tpu_serving_mfu": "gauge",
    # host transport: the carrying transport, payload bytes by path, the
    # multi-frame stream group sizes
    "tpu_serving_transport_info": "gauge",
    "tpu_serving_transport_requests_total": "counter",
    "tpu_serving_wire_bytes_total": "counter",
    "tpu_serving_shm_bytes_total": "counter",
    "tpu_serving_stream_group_size": "histogram",
    # streaming sessions (zeros without a session manager)
    "tpu_serving_sessions_active": "gauge",
    "tpu_serving_session_slot_occupancy": "gauge",
    "tpu_serving_session_inflight_frames": "gauge",
    "tpu_serving_sessions_total": "counter",
    "tpu_serving_sessions_rejected_total": "counter",
    "tpu_serving_session_frames_total": "counter",
    "tpu_serving_track_births_total": "counter",
    "tpu_serving_track_deaths_total": "counter",
    # temporal reuse (not ported: zeros)
    "tpu_serving_frames_total": "counter",
    "tpu_serving_stream_effective_k": "gauge",
    "tpu_serving_temporal_disabled_total": "counter",
    "tpu_serving_suppressed_views_total": "counter",
    "tpu_serving_partial_tiles_total": "counter",
    # op attribution: per-op device time over the sampler's last window,
    # the window and its counters, each model's roofline placement, the
    # metric-history ring depth
    "tpu_serving_op_device_seconds": "gauge",
    "tpu_serving_op_sample_window_seconds": "gauge",
    "tpu_serving_op_samples_total": "counter",
    "tpu_serving_op_sample_skips_total": "counter",
    "tpu_serving_model_roofline_info": "gauge",
    "tpu_serving_model_arithmetic_intensity": "gauge",
    "tpu_serving_model_attainable_fps": "gauge",
    "tpu_serving_history_buffered": "gauge",
    # continuous quality plane (not ported: zeros), its own namespace
    "tpu_quality_map50": "gauge",
    "tpu_quality_map": "gauge",
    "tpu_quality_velocity_mae": "gauge",
    "tpu_quality_id_switch_rate": "gauge",
    "tpu_quality_scored_frames_total": "counter",
    "tpu_quality_shadow_lag_seconds": "gauge",
    "tpu_quality_shadow_dropped_total": "counter",
    "tpu_quality_canary_fraction": "gauge",
    "tpu_quality_canary_info": "gauge",
    "tpu_quality_promotions_total": "counter",
    "tpu_quality_rollbacks_total": "counter",
}

_HBM_KINDS = ("bytes_in_use", "bytes_limit", "peak_bytes_in_use")


class CompileEvents:
    """Process-global count of CUDA-graph captures (``runtime/graphs``'s
    capture listeners): count and cumulative seconds, warmup calls
    included. One listener a process, installed on first use and kept for
    the process's life, the scope a compile counter wants."""

    _instance: "CompileEvents | None" = None
    _install_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.compiles = 0
        self.compile_seconds = 0.0

    @classmethod
    def install(cls) -> "CompileEvents":
        with cls._install_lock:
            if cls._instance is None:
                from triton_client_tpu_torch.runtime import graphs

                inst = cls()
                graphs.add_capture_listener(inst._on_capture)
                cls._instance = inst
            return cls._instance

    def _on_capture(self, name: str, seconds: float) -> None:
        with self._lock:
            self.compiles += 1
            self.compile_seconds += float(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            return {"compiles": self.compiles, "compile_seconds": self.compile_seconds}


def _split_channel(channel):
    """(batcher | None, staged channel | None) from a channel stack.

    Duck-typed: the batcher is anything with ``inner`` and ``stats``; the
    staged channel anything with ``stats`` and ``pipeline_depth``."""
    batching, staged, c = None, None, channel
    if c is not None and hasattr(c, "inner") and hasattr(c, "stats"):
        batching = c
        c = c.inner
    if c is not None and hasattr(c, "stats") and hasattr(c, "pipeline_depth"):
        staged = c
    return batching, staged


def _cumulative(counts: dict, bounds) -> list:
    """Prometheus cumulative buckets from ``{size: n}`` over power-of-two
    ``bounds`` (a size counts in the first bound it does not exceed)."""
    cum, out = 0, []
    for bound in bounds:
        cum += sum(v for k, v in counts.items() if bound / 2 < k <= bound)
        out.append((repr(float(bound)), cum))
    out.append(("+Inf", sum(counts.values())))
    return out


def _histogram_buckets(h: dict) -> list:
    """Prometheus cumulative buckets from a ``LatencyHistogram`` snapshot."""
    cum, out = 0, []
    for bound, c in sorted((float(b), n) for b, n in h["buckets"].items() if b != "inf"):
        cum += c
        out.append((repr(bound), cum))
    out.append(("+Inf", h["count"]))
    return out


class RuntimeCollector:
    """One structured read of the serving stack's runtime state.

    Works with or without ``prometheus_client``: ``snapshot()``/``delta()``
    are plain dicts; ``registry=`` also registers this object as a
    Prometheus custom collector whose families come from a snapshot at
    scrape time."""

    def __init__(
        self,
        channel=None,
        tracer=None,
        namespace: str = "tpu_serving",
        registry=None,
        repository=None,
        histograms=None,
        slo=None,
        admission=None,
        lifecycle=None,
        device_time=None,
    ) -> None:
        """``histograms``: an ``obs.histogram.HistogramFamily``; ``slo``: an
        ``obs.slo.SLOTracker``; ``admission``: a ``runtime.admission.
        AdmissionController``; ``lifecycle``: a ``runtime.lifecycle.
        ModelLifecycleManager``; ``device_time``: an
        ``obs.device_time.DeviceTimeLedger``. All optional: their families
        export empty when absent."""
        self._batching, self._staged = _split_channel(channel)
        self._tracer = tracer
        self._repository = repository
        self._histograms = histograms
        self._slo = slo
        self._admission = admission
        self._lifecycle = lifecycle
        self._device_time = device_time
        self._ns = namespace
        self._compile = CompileEvents.install()
        self._lock = threading.Lock()
        self._inflight_requests = 0
        self._errors: dict[tuple[str, str], int] = {}
        # admission-door sheds ("model|priority|stage"); the channel and the
        # batcher count their own stages, merged at snapshot
        self._shed: dict[str, int] = {}
        self._transport_requests: dict[str, int] = {}
        self._wire_bytes = 0
        self._shm_bytes = 0
        self._stream_groups: dict[int, int] = {}
        # the sampler's last per-op window (gauges) and its count
        self._op_rows: list = []
        self._op_window_s = 0.0
        self._op_samples = 0
        self._sampler = None
        self._history = None
        self._quality = None
        self._temporal = None
        self._draining = False
        self._registry = None
        if registry is not None:
            registry.register(self)
            self._registry = registry

    # -- request-plane hooks (the server calls them) ---------------------------

    def request_started(self) -> None:
        with self._lock:
            self._inflight_requests += 1

    def request_finished(self) -> None:
        with self._lock:
            self._inflight_requests -= 1

    def record_error(self, model: str, code: str) -> None:
        with self._lock:
            key = (model, code)
            self._errors[key] = self._errors.get(key, 0) + 1

    def record_shed(self, model: str, priority: int, stage: str) -> None:
        """One request rejected at ``stage`` (the server's admission door;
        the channel and the batcher count their own stages)."""
        with self._lock:
            key = f"{model}|{int(priority)}|{stage}"
            self._shed[key] = self._shed.get(key, 0) + 1

    def record_transport(self, transport: str, wire_bytes: int, shm_bytes: int) -> None:
        """One inference request's transport (grpc / uds / shm / uds+shm) and
        the input payload bytes each path moved."""
        with self._lock:
            self._transport_requests[transport] = self._transport_requests.get(transport, 0) + 1
            self._wire_bytes += int(wire_bytes)
            self._shm_bytes += int(shm_bytes)

    def record_stream_group(self, size: int) -> None:
        """One packed multi-frame stream message of ``size`` frames."""
        with self._lock:
            self._stream_groups[int(size)] = self._stream_groups.get(int(size), 0) + 1

    def record_op_sample(self, rows, window_s: float) -> None:
        """The continuous sampler's sink: the top-K op rows of one capture
        window (``obs.opstats.summarize``'s rows). Gauges export the last
        window; the samples counter accumulates."""
        with self._lock:
            self._op_rows = list(rows or [])
            self._op_window_s = float(window_s or 0.0)
            self._op_samples += 1

    def attach_sampler(self, sampler) -> None:
        """The ``ContinuousSampler`` whose ``stats()`` this exports (attached
        after construction: the sampler takes the collector as its sink)."""
        self._sampler = sampler

    def attach_history(self, history) -> None:
        """The ``MetricHistory`` whose ring depth this exports."""
        self._history = history

    def attach_temporal(self, temporal) -> None:
        """A temporal reuse plane with ``stats()`` in the JAX plane's shape."""
        self._temporal = temporal

    def attach_quality(self, quality) -> None:
        """A quality plane with ``snapshot()`` in the JAX plane's shape."""
        self._quality = quality

    def hlo_modules(self) -> dict[str, str]:
        """``{launch annotation: model}`` over every registered model: the
        op -> model map the sampler and ``/profile`` hand to
        ``obs.opstats`` (``spec.extra["launch_annotation"]``, recorded by
        ``obs.roofline.record_launch_cost``; JAX's ``hlo_module``)."""
        out: dict[str, str] = {}
        for name, _, extra in self._extras() or ():
            module = extra.get("launch_annotation") or extra.get("hlo_module")
            if module:
                out[str(module)] = name
        return out

    def _extras(self) -> list | None:
        """``(name, version, spec.extra)`` of every registered model, read at
        call time (a reload shows on the next read); None without a
        repository."""
        if self._repository is None:
            return None
        try:
            listing = self._repository.list_models()
        except Exception:
            return None
        out = []
        for name, version in listing:
            try:
                out.append((name, version, self._repository.get(name, version).spec.extra))
            except Exception:
                continue
        return out

    def set_draining(self, draining: bool) -> None:
        with self._lock:
            self._draining = bool(draining)

    # -- snapshot API (scripts and the scrape share it) ------------------------

    def snapshot(self) -> dict:
        with self._lock:
            inflight = self._inflight_requests
            errors = {f"{m}|{c}": n for (m, c), n in self._errors.items()}
            shed = dict(self._shed)
            draining = self._draining
            transport = {
                "requests": dict(self._transport_requests),
                "wire_bytes": self._wire_bytes,
                "shm_bytes": self._shm_bytes,
                "stream_groups": dict(self._stream_groups),
            }
            op_sample = {
                "rows": list(self._op_rows),
                "window_s": self._op_window_s,
                "samples": self._op_samples,
            }
        snap = {
            "channel": self._staged.stats() if self._staged is not None else None,
            "batching": self._batching.stats() if self._batching is not None else None,
            "inflight_requests": inflight,
            "errors": errors,
            "compile": self._compile.snapshot(),
            "memory": self._memory(),
        }
        # one shed ledger across the stack: the admission door's (recorded
        # here) and the stages the batcher and the channel count
        for src in (snap["channel"], snap["batching"]):
            for key, n in ((src or {}).get("shed") or {}).items():
                shed[key] = shed.get(key, 0) + n
        snap["shed"] = shed
        snap["draining"] = int(draining)
        snap["transport"] = transport
        if self._admission is not None:
            snap["admission"] = self._admission.stats()
        if self._lifecycle is not None:
            snap["lifecycle"] = self._lifecycle.stats()
        if self._tracer is not None:
            snap["tracer"] = self._tracer.stats()
        if self._device_time is not None:
            snap["device_time"] = self._device_time.snapshot()
        sessions = getattr(self._staged, "sessions", None) if self._staged is not None else None
        if sessions is not None:
            snap["sessions"] = sessions.stats()
        snap["op_sample"] = op_sample
        if self._sampler is not None:
            snap["sampler"] = self._sampler.stats()
        if self._history is not None:
            snap["history"] = self._history.stats()
        if self._quality is not None:
            snap["quality"] = self._quality.snapshot()
        if self._temporal is not None:
            snap["temporal"] = self._temporal.stats()
        if self._histograms is not None:
            # numeric-leaved bucket counts: delta() of two snapshots is the
            # window's histogram, and quantile_from_snapshot reads either
            snap["histograms"] = self._histograms.snapshot()
        if self._slo is not None:
            snap["slo"] = self._slo.stats()
        models = self._models()
        if models is not None:
            snap["models"] = models
        return snap

    def _models(self) -> list | None:
        """Per-model precision and parameter bytes, and the roofline row once
        the channel has measured the launch cost."""
        extras = self._extras()
        if extras is None:
            return None
        rows = []
        for name, version, extra in extras:
            row = {
                "model": name,
                "version": version,
                "precision": str(extra.get("precision", "f32")),
                "param_bytes": int(extra.get("param_bytes", 0) or 0),
            }
            if extra.get("measured_flops_per_call") is not None:
                try:
                    from triton_client_tpu_torch.obs.roofline import model_row

                    row["roofline"] = model_row(extra)
                except Exception:
                    pass
            rows.append(row)
        return rows

    @staticmethod
    def delta(new: dict, old: dict) -> dict:
        """Recursive numeric diff of two snapshots, zero and empty leaves
        dropped."""

        def diff(n, o):
            if isinstance(n, dict):
                o = o if isinstance(o, dict) else {}
                out = {}
                for k, v in n.items():
                    r = diff(v, o.get(k))
                    if r not in (None, 0, 0.0, {}):
                        out[k] = r
                return out
            if isinstance(n, bool) or not isinstance(n, (int, float)):
                return None
            base = o if isinstance(o, (int, float)) and not isinstance(o, bool) else 0
            return n - base

        return diff(new, old if isinstance(old, dict) else {})

    def _memory(self) -> dict:
        """The channel card's memory (``torch.cuda.memory_stats`` and
        ``mem_get_info``) under JAX's ``memory_stats()`` keys; empty for a
        CPU channel or without one."""
        if self._staged is None:
            return {}
        try:
            device = self._staged.fetch_channel()
        except Exception:
            return {}
        if getattr(device, "type", None) != "cuda":
            return {}
        try:
            import torch

            ms = torch.cuda.memory_stats(device)
            free, total = torch.cuda.mem_get_info(device)
        except Exception:
            return {}
        index = device.index if device.index is not None else torch.cuda.current_device()
        return {
            str(index): {
                "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
                "bytes_limit": int(total),
                "bytes_reserved": int(ms.get("reserved_bytes.all.current", 0)),
                "bytes_free": int(free),
            }
        }

    # -- Prometheus custom-collector protocol ----------------------------------

    def describe(self):
        # an "unchecked" collector: label values appear as models are served
        return []

    def collect(self):
        from prometheus_client.core import (
            CounterMetricFamily,
            GaugeMetricFamily,
            HistogramMetricFamily,
        )

        snap = self.snapshot()
        chan = snap["channel"] or {}
        bat = snap["batching"] or {}
        ns = self._ns

        def family(cls, name, doc, value, labels, samples):
            fam = cls(name, doc, labels=labels or [])
            if labels:
                for lv, v in samples:
                    fam.add_metric(lv, v)
            else:
                fam.add_metric([], value)
            return fam

        def gauge(name, doc, value, labels=None, samples=()):
            return family(GaugeMetricFamily, name, doc, value, labels, samples)

        def counter(name, doc, value, labels=None, samples=()):
            return family(CounterMetricFamily, name, doc, value, labels, samples)

        def histogram(name, doc, buckets, total):
            fam = HistogramMetricFamily(name, doc, labels=[])
            fam.add_metric([], buckets, total)
            return fam

        yield gauge(f"{ns}_inflight_requests", "gRPC requests currently being served",
                    snap["inflight_requests"])
        yield counter(f"{ns}_request_errors_total", "failed requests by model and gRPC status code",
                      0, labels=["model", "code"],
                      samples=[(key.split("|", 1), n) for key, n in snap["errors"].items()])

        # the staged channel's slots
        yield gauge(f"{ns}_inflight_batches", "launched, not-yet-retired device batches",
                    chan.get("inflight", 0))
        yield gauge(f"{ns}_staging_slots_active", "staging slots currently held (stage..retire)",
                    chan.get("slots_active", 0))
        yield gauge(f"{ns}_pipeline_depth", "configured staging pipeline depth",
                    chan.get("pipeline_depth", 0))
        yield counter(f"{ns}_staged_requests_total", "requests staged onto the device",
                      chan.get("staged", 0))
        yield counter(f"{ns}_launched_batches_total", "device batches launched",
                      chan.get("launched", 0))
        yield counter(f"{ns}_donated_launches_total",
                      "launches through a donated-buffer path (none on the port)",
                      chan.get("donated_launches", 0))
        yield counter(f"{ns}_stage_slot_waits_total", "stage() calls that blocked on a staging slot",
                      chan.get("stage_slot_waits", 0))
        yield counter(f"{ns}_slot_occupancy_launches_total",
                      "launches observed at each in-flight depth", 0, labels=["inflight"],
                      samples=[([str(k)], v)
                               for k, v in (chan.get("slot_occupancy") or {}).items()])
        yield gauge(f"{ns}_data_axis_size",
                    "data-axis width request batches shard over (1 = one card, 0 = no channel)",
                    chan.get("data_axis_size", 1 if self._staged is not None else 0))
        yield gauge(f"{ns}_mesh_devices", "devices claimed by the serving channel",
                    chan.get("mesh_devices", 1 if self._staged is not None else 0))

        # batch formation
        yield gauge(f"{ns}_queue_depth", "requests admitted or staged, awaiting dispatch",
                    bat.get("ready_depth", 0) + bat.get("queue_depth", 0))
        yield gauge(f"{ns}_batch_active_slots", "batcher execution slots currently active",
                    bat.get("active_slots", 0))
        yield gauge(f"{ns}_dispatcher_stalled",
                    "1 when the dispatch loop's heartbeat is older than the stall threshold",
                    bat.get("dispatcher_stalled", 0))
        yield gauge(f"{ns}_dispatcher_last_progress_seconds",
                    "seconds since the dispatch loop last made progress",
                    bat.get("dispatcher_last_progress_age_s", 0.0))
        merges = bat.get("merges", 0)
        fill = 0.0
        if merges and bat.get("max_merge"):
            fill = bat.get("merged_frames", 0) / merges / bat["max_merge"]
        yield gauge(f"{ns}_batch_fill_ratio", "mean merged frames per dispatch / max_merge", fill)
        yield counter(f"{ns}_batch_merges_total", "device batches formed at dispatch time", merges)
        yield counter(f"{ns}_batched_frames_total", "frames merged into device batches",
                      bat.get("merged_frames", 0))
        by_model = bat.get("padded_by_model")
        if by_model is None and bat.get("padded_frames"):
            by_model = {"unknown": bat["padded_frames"]}
        yield counter(f"{ns}_padded_frames_total", "pad rows added by bucket padding, per model",
                      0, labels=["model"],
                      samples=[([m], n) for m, n in (by_model or {}).items()])
        yield counter(f"{ns}_batch_launch_frees_total",
                      "execution slots freed at launch (pre-readback)", bat.get("launch_frees", 0))
        occupancy = {int(k): v for k, v in (bat.get("merge_occupancy") or {}).items()}
        yield counter(f"{ns}_merge_occupancy_total", "dispatches observed at each merged frame count",
                      0, labels=["frames"], samples=[([str(k)], v) for k, v in occupancy.items()])
        yield gauge(f"{ns}_pad_fraction",
                    "share of device rows shipped as padding "
                    "(dense bucket pad + ragged alignment slack)",
                    bat.get("pad_fraction", 0.0))
        yield histogram(f"{ns}_batch_occupancy", "real frames per formed device batch",
                        _cumulative(occupancy, (1, 2, 4, 8, 16, 32, 64, 128)),
                        float(sum(k * v for k, v in occupancy.items())))
        yield counter(f"{ns}_ragged_batches_total",
                      "packed ragged batches dispatched (segment-table execution)",
                      bat.get("ragged_batches", 0))
        yield counter(f"{ns}_ragged_rows_total", "real rows executed through packed ragged batches",
                      bat.get("ragged_rows", 0))
        yield counter(f"{ns}_ragged_pad_rows_total",
                      "alignment pad rows shipped with packed ragged batches",
                      bat.get("ragged_pad_rows", 0))

        # per-model precision and parameter bytes
        models = snap.get("models") or []
        yield gauge(f"{ns}_model_precision_info",
                    "serving precision policy per registered model (info gauge)", 0,
                    labels=["model", "version", "precision"],
                    samples=[([m["model"], m["version"], m["precision"]], 1) for m in models])
        yield gauge(f"{ns}_model_param_bytes",
                    "registered parameter bytes per model (post-quantization)", 0,
                    labels=["model", "version"],
                    samples=[([m["model"], m["version"]], m["param_bytes"]) for m in models])

        comp = snap["compile"]
        yield counter(f"{ns}_jit_compiles_total",
                      "CUDA graph captures observed (runtime/graphs: one per new input signature)",
                      comp["compiles"])
        yield counter(f"{ns}_jit_compile_seconds_total",
                      "cumulative seconds spent capturing CUDA graphs (warmup calls included)",
                      comp["compile_seconds"])

        tr = snap.get("tracer") or {}
        yield counter(f"{ns}_traces_finished_total", "request traces finished",
                      tr.get("finished", 0))
        yield gauge(f"{ns}_trace_buffered", "request traces held in the export ring buffer",
                    tr.get("buffered", 0))

        # SLO plane
        lat = HistogramMetricFamily(
            f"{ns}_latency_seconds",
            "request latency per model and pipeline stage "
            "(queue_delay/merge_wait/device_execute/readback/e2e)",
            labels=["model", "stage"],
        )
        for key, h in (snap.get("histograms") or {}).items():
            model, _, stage = key.partition("|")
            lat.add_metric([model, stage], _histogram_buckets(h), h["sum"])
        yield lat
        slo = snap.get("slo") or {}
        yield counter(f"{ns}_slo_requests_total",
                      "requests scored against their latency SLO, by outcome", 0,
                      labels=["model", "priority", "outcome"],
                      samples=[(key.split("|", 1) + [outcome], cell[outcome])
                               for key, cell in (slo.get("requests") or {}).items()
                               for outcome in ("met", "missed")])
        yield gauge(f"{ns}_slo_tail_buffered",
                    "SLO-violating / p99+ exemplar traces held in the tail ring",
                    slo.get("tail_buffered", 0))
        yield counter(f"{ns}_deadline_expired_launches_total",
                      "batches launched after their request deadline had passed",
                      chan.get("deadline_expired_launches", 0))

        # overload control
        yield counter(f"{ns}_shed_total",
                      "requests deliberately rejected, by model, priority, and "
                      "pipeline stage (admission/queue/merge/launch/breaker)", 0,
                      labels=["model", "priority", "stage"],
                      samples=[(key.split("|", 2), n)
                               for key, n in (snap.get("shed") or {}).items()])
        breaker = chan.get("breaker") or {}
        yield gauge(f"{ns}_breaker_state",
                    "per-model circuit-breaker state (0 closed, 1 half-open, 2 open)", 0,
                    labels=["model"], samples=[([m], c["state"]) for m, c in breaker.items()])
        yield counter(f"{ns}_breaker_opens_total", "circuit-breaker open transitions per model", 0,
                      labels=["model"], samples=[([m], c["opens"]) for m, c in breaker.items()])
        adm = snap.get("admission") or {}
        yield gauge(f"{ns}_admission_queue_depth", "admitted-but-unfinished requests per model", 0,
                    labels=["model"],
                    samples=[([m], d) for m, d in (adm.get("inflight") or {}).items()])
        yield gauge(f"{ns}_draining", "1 while the server is draining (SIGTERM / drain())",
                    snap.get("draining", 0))

        # multi-tenant lifecycle: budget and residency, models per state,
        # promotions and evictions with the promotion latency, tenant sheds
        # (zeros without a lifecycle manager)
        lc = snap.get("lifecycle") or {}
        yield gauge(f"{ns}_hbm_budget_bytes", "configured device-memory paging budget "
                    "(0 = unbudgeted)", lc.get("budget_bytes", 0))
        yield gauge(f"{ns}_hbm_resident_bytes",
                    "estimated bytes of WARM model params under the budget",
                    lc.get("resident_bytes", 0))
        yield gauge(f"{ns}_tenant_hbm_bytes", "resident model bytes billed to each tenant", 0,
                    labels=["tenant"],
                    samples=[([t], b) for t, b in (lc.get("tenant_resident_bytes") or {}).items()])
        yield gauge(f"{ns}_lifecycle_models",
                    "registered models per lifecycle state (cold/warming/warm/evicting)", 0,
                    labels=["state"],
                    samples=[([s], n) for s, n in (lc.get("states") or {}).items()])
        lc_models = [(key.partition(":"), row) for key, row in (lc.get("models") or {}).items()]
        yield counter(f"{ns}_model_promotions_total", "COLD -> WARM promotions per model", 0,
                      labels=["model", "version"],
                      samples=[([name, version], row["promotions"])
                               for (name, _, version), row in lc_models])
        yield counter(f"{ns}_model_evictions_total", "WARM -> COLD evictions per model", 0,
                      labels=["model", "version"],
                      samples=[([name, version], row["evictions"])
                               for (name, _, version), row in lc_models])
        ph = lc.get("promotion_latency") or {"buckets": {}, "sum": 0.0, "count": 0}
        yield histogram(f"{ns}_promotion_seconds",
                        "COLD -> WARM promotion latency (make-room + page-in)",
                        _histogram_buckets(ph), ph["sum"])
        yield counter(f"{ns}_tenant_shed_total",
                      "requests shed at the admission door per tenant", 0, labels=["tenant"],
                      samples=[([t], n) for t, n in (adm.get("tenant_rejects") or {}).items()])
        yield counter(f"{ns}_tenant_served_frames_total",
                      "frames dispatched per tenant by the fair-share scheduler", 0,
                      labels=["tenant"],
                      samples=[([t], n)
                               for t, n in (bat.get("tenant_served_frames") or {}).items()])

        # device time
        dt = snap.get("device_time") or {}
        dt_window = dt.get("window") or {}
        yield counter(f"{ns}_device_seconds_total",
                      "cumulative device-execute seconds per model and tenant", 0,
                      labels=["model", "tenant"],
                      samples=[(key.split("|", 1), v)
                               for key, v in (dt.get("device_seconds") or {}).items()])
        yield gauge(f"{ns}_device_utilization_ratio",
                    "rolling-window busy device-seconds over elapsed wall x devices",
                    dt_window.get("utilization", 0.0))
        yield gauge(f"{ns}_mfu",
                    "live model flops utilization over the rolling window, per model "
                    "(measured flops against the peak of the precision they ran at)", 0,
                    labels=["model"],
                    samples=[([m], v) for m, v in (dt_window.get("mfu") or {}).items()])

        # streaming sessions: the staged channel's manager (zeros without one)
        ses = snap.get("sessions") or {}
        yield gauge(f"{ns}_sessions_active",
                    "streaming sessions currently holding a device-resident tracker slot",
                    ses.get("active_sessions", 0))
        yield gauge(f"{ns}_session_slot_occupancy", "active sessions over the slot pool size",
                    ses.get("slot_occupancy", 0.0))
        yield gauge(f"{ns}_session_inflight_frames",
                    "session frames between launch and resolve (slot refcounts)",
                    ses.get("inflight_frames", 0))
        yield counter(f"{ns}_sessions_total",
                      "session slot transitions by event "
                      "(created / restarted / ended / expired / reclaimed)", 0,
                      labels=["event"],
                      samples=[([ev], ses.get(f"{ev}_total", 0))
                               for ev in ("created", "restarted", "ended", "expired", "reclaimed")])
        yield counter(f"{ns}_sessions_rejected_total",
                      "session frames shed because the slot pool was full and unreclaimable",
                      ses.get("rejected_total", 0))
        yield counter(f"{ns}_session_frames_total",
                      "frames advanced through device-resident session state",
                      ses.get("frames_total", 0))
        yield counter(f"{ns}_track_births_total", "tracks born across all sessions",
                      ses.get("track_births_total", 0))
        yield counter(f"{ns}_track_deaths_total", "tracks retired across all sessions",
                      ses.get("track_deaths_total", 0))

        # temporal reuse (not ported: zeros)
        tmp = snap.get("temporal") or {}
        yield counter(f"{ns}_frames_total",
                      "stream frames by reuse decision: full detector pass, "
                      "tracker-coast, or ROI-tile partial recompute", 0, labels=["mode"],
                      samples=[([mode], tmp.get(f"frames_{mode}_total", 0))
                               for mode in ("full", "coast", "partial")])
        yield gauge(f"{ns}_stream_effective_k",
                    "current adaptive keyframe interval per stream", 0, labels=["stream"],
                    samples=[([str(sid)], k)
                             for sid, k in sorted((tmp.get("effective_k") or {}).items())])
        yield counter(f"{ns}_temporal_disabled_total",
                      "streams/models where temporal reuse auto-disabled", 0, labels=["reason"],
                      samples=[(["churn"], tmp.get("auto_disabled_total", 0)),
                               (["quality"], tmp.get("quality_disabled_total", 0))])
        yield counter(f"{ns}_suppressed_views_total",
                      "camera views skipped because all their tracked objects project into "
                      "already-processed overlap regions", tmp.get("suppressed_views_total", 0))
        yield counter(f"{ns}_partial_tiles_total",
                      "ROI tiles re-detected (selected) vs the full tile-grid size (possible)",
                      0, labels=["kind"],
                      samples=[(["selected"], tmp.get("partial_tiles_total", 0)),
                               (["possible"], tmp.get("partial_tiles_possible_total", 0))])

        # op attribution
        op = snap.get("op_sample") or {}
        samp = snap.get("sampler") or {}
        yield gauge(f"{ns}_op_device_seconds",
                    "device time per op over the sampler's last capture window "
                    "(top-K by time; model attributed through the launch annotations)", 0,
                    labels=["model", "op", "kind"],
                    samples=[([str(r.get("model") or "unattributed"), str(r.get("op", "?")),
                               str(r.get("kind", "other"))], float(r.get("time_us", 0.0)) / 1e6)
                             for r in (op.get("rows") or [])])
        yield gauge(f"{ns}_op_sample_window_seconds",
                    "length of the sampler's last profiler capture window",
                    op.get("window_s", 0.0))
        yield counter(f"{ns}_op_samples_total",
                      "profiler capture windows delivered by the continuous sampler",
                      op.get("samples", 0))
        yield counter(f"{ns}_op_sample_skips_total",
                      "sampler windows skipped because /profile held the capture guard",
                      samp.get("skipped_busy", 0))
        roofline_rows = [(m, m["roofline"]) for m in models if m.get("roofline")]
        yield gauge(f"{ns}_model_roofline_info",
                    "roofline bound class per model from measured flops/bytes "
                    "(info gauge: compute/bandwidth)", 0,
                    labels=["model", "version", "bound"],
                    samples=[([m["model"], m["version"], r["bound"]], 1)
                             for m, r in roofline_rows])
        yield gauge(f"{ns}_model_arithmetic_intensity",
                    "measured flops per device-memory byte of one launch", 0,
                    labels=["model", "version"],
                    samples=[([m["model"], m["version"]], r["intensity"])
                             for m, r in roofline_rows
                             if r["intensity"] == r["intensity"]
                             and r["intensity"] != float("inf")])
        yield gauge(f"{ns}_model_attainable_fps",
                    "roofline-ceiling frames/s at the measured batch", 0,
                    labels=["model", "version"],
                    samples=[([m["model"], m["version"]], r["attainable_fps"])
                             for m, r in roofline_rows])
        yield gauge(f"{ns}_history_buffered", "metric-history snapshots buffered in the ring",
                    (snap.get("history") or {}).get("buffered", 0))

        # continuous quality plane (not ported: zeros), its own namespace
        q = snap.get("quality") or {}
        q_pairs = q.get("pairs") or {}
        for field, doc in (
            ("map50", "rolling-window online mAP@0.5 of the served variant scored "
                      "against the shadow f32 reference as pseudo-GT"),
            ("map", "rolling-window online mAP@[.5:.95] vs the shadow reference"),
            ("velocity_mae", "mean |velocity| error of matched detections vs the shadow "
                             "reference"),
            ("id_switch_rate", "excess track births per frame of the primary tracking "
                               "stream vs the shadow reference stream"),
        ):
            yield gauge(f"tpu_quality_{field}", doc, 0, labels=["model", "variant"],
                        samples=[(key.split("|", 1), q_pairs[key]["last"][field])
                                 for key in sorted(q_pairs)
                                 if (q_pairs[key].get("last") or {}).get(field) is not None])
        yield counter("tpu_quality_scored_frames_total",
                      "sampled frames scored against the shadow reference", 0,
                      labels=["model", "variant"],
                      samples=[(key.split("|", 1), q_pairs[key].get("scored_frames", 0))
                               for key in sorted(q_pairs)])
        yield gauge("tpu_quality_shadow_lag_seconds",
                    "lag between a sampled request being served and its shadow score landing",
                    0, labels=["model", "variant"],
                    samples=[(key.split("|", 1), q_pairs[key].get("last_lag_s", 0.0))
                             for key in sorted(q_pairs)])
        yield counter("tpu_quality_shadow_dropped_total",
                      "sampled frames dropped because the shadow queue was full",
                      (q.get("mirror") or {}).get("dropped", 0))
        canary = q.get("canary") or {}
        canary_models = canary.get("models") or {}
        yield gauge("tpu_quality_canary_fraction",
                    "fraction of the primary's traffic hash-sliced to the canary variant", 0,
                    labels=["model", "variant"],
                    samples=[([m, c["variant"]], c["fraction"])
                             for m, c in sorted(canary_models.items())])
        yield gauge("tpu_quality_canary_info",
                    "canary lifecycle state per model (info gauge)", 0,
                    labels=["model", "variant", "state"],
                    samples=[([m, c["variant"], c["state"]], 1)
                             for m, c in sorted(canary_models.items())])
        yield counter("tpu_quality_promotions_total",
                      "canary variants promoted to full traffic", canary.get("promotions", 0))
        yield counter("tpu_quality_rollbacks_total",
                      "canary variants rolled back on a quality-budget violation",
                      canary.get("rollbacks", 0))

        # host transport
        tp = snap.get("transport") or {}
        tp_requests = tp.get("requests") or {}
        yield gauge(f"{ns}_transport_info",
                    "transports observed carrying inference requests "
                    "(grpc/uds/shm/uds+shm; info gauge, 1 per observed label)", 0,
                    labels=["transport"], samples=[([t], 1) for t in sorted(tp_requests)])
        yield counter(f"{ns}_transport_requests_total",
                      "inference requests per negotiated transport", 0, labels=["transport"],
                      samples=[([t], n) for t, n in sorted(tp_requests.items())])
        yield counter(f"{ns}_wire_bytes_total",
                      "input payload bytes that travelled as gRPC raw content",
                      tp.get("wire_bytes", 0))
        yield counter(f"{ns}_shm_bytes_total",
                      "input payload bytes that travelled through shared memory",
                      tp.get("shm_bytes", 0))
        groups = {int(k): v for k, v in (tp.get("stream_groups") or {}).items()}
        yield histogram(f"{ns}_stream_group_size",
                        "frames per packed multi-frame stream message",
                        _cumulative(groups, (1, 2, 4, 8, 16, 32, 64)),
                        float(sum(k * v for k, v in groups.items())))

        # device memory (absent on a CPU channel)
        if snap["memory"]:
            fam = GaugeMetricFamily(f"{ns}_device_hbm_bytes",
                                    "per-device memory bytes (torch.cuda.memory_stats, "
                                    "mem_get_info)", labels=["device", "kind"])
            for dev, stats in snap["memory"].items():
                for kind in _HBM_KINDS:
                    if kind in stats:
                        fam.add_metric([dev, kind], stats[kind])
            yield fam
            occ = GaugeMetricFamily(f"{ns}_device_hbm_occupancy_ratio",
                                    "per-device bytes_in_use / bytes_limit", labels=["device"])
            for dev, stats in snap["memory"].items():
                if stats.get("bytes_limit"):
                    occ.add_metric([dev], stats.get("bytes_in_use", 0) / stats["bytes_limit"])
            yield occ

    def close(self) -> None:
        if self._registry is not None:
            try:
                self._registry.unregister(self)
            except KeyError:
                pass
            self._registry = None
