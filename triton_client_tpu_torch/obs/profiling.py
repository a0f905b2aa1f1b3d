"""Per-stage latency profiling and device tracing (the port's copy of
``obs/profiling.py``; numpy, and ``torch.profiler`` when a trace is asked
for).

- ``StageProfiler``: thread-safe rolling reservoir of wall-clock
  durations per named stage -> p50/p95/p99/mean/count snapshots (the
  detect CLIs' ``--profile`` table: source, infer, sink).
  Listeners see every sample as it lands (the Prometheus export hook);
  ``stage`` and ``wrap`` time a block or a callable into it.
- ``device_trace``: a ``torch.profiler`` window (host and CUDA
  activities) exported as a Chrome trace into a directory, viewable in
  Perfetto or ``chrome://tracing``: the port's counterpart of the JAX
  package's ``jax.profiler`` trace behind ``--profile-trace``, the
  ``/profile`` endpoint and the continuous sampler. ``launch_scope``
  names a launch inside it from any thread.
- ``annotate``: a named host region inside such a window
  (``torch.profiler.record_function``, JAX's ``TraceAnnotation``).
- ``PrometheusStageExporter``: per-stage latency histograms on a metrics
  registry, the serving-side analogue of Triton's :8002 endpoint
  (``prometheus_client`` is imported when one is built).
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import threading
import time
from typing import Callable, Iterator

import numpy as np

log = logging.getLogger(__name__)

_QUANTILES = (50.0, 95.0, 99.0)


class StageProfiler:
    """Rolling per-stage duration reservoir: the most recent ``window``
    samples a stage (stable tail quantiles at camera rates without
    unbounded memory in a long-running process)."""

    def __init__(self, window: int = 4096) -> None:
        self._window = int(window)
        self._lock = threading.Lock()
        # deque(maxlen=...) evicts in O(1)
        self._stages: dict[str, collections.deque[float]] = {}
        self._counts: dict[str, int] = {}
        self._listeners: list[Callable[[str, float], None]] = []

    def record(self, stage: str, seconds: float) -> None:
        with self._lock:
            buf = self._stages.get(stage)
            if buf is None:
                buf = self._stages[stage] = collections.deque(maxlen=self._window)
            buf.append(float(seconds))
            self._counts[stage] = self._counts.get(stage, 0) + 1
            listeners = list(self._listeners)
        for listener in listeners:
            try:
                listener(stage, seconds)
            except Exception:  # observability never fails the observed path
                log.warning("profiler listener failed for stage %r", stage, exc_info=True)

    def add_listener(self, fn: Callable[[str, float], None]) -> None:
        """Observe every sample as it lands (the Prometheus export hook)."""
        with self._lock:
            self._listeners.append(fn)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def wrap(self, name: str, fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            with self.stage(name):
                return fn(*args, **kwargs)

        return wrapped

    def summary(self) -> dict[str, dict[str, float]]:
        """stage -> {count, mean_ms, p50_ms, p95_ms, p99_ms}."""
        with self._lock:
            stages = {k: np.asarray(v) for k, v in self._stages.items() if v}
            counts = dict(self._counts)
        out = {}
        for name, samples in stages.items():
            ms = samples * 1e3
            row = {"count": float(counts.get(name, len(samples)))}
            row["mean_ms"] = float(ms.mean())
            for q in _QUANTILES:
                row[f"p{int(q)}_ms"] = float(np.percentile(ms, q))
            out[name] = row
        return out

    def report(self) -> str:
        """Human-readable per-stage table (the driver's end-of-run print)."""
        rows = self.summary()
        if not rows:
            return "(no stage samples)"
        width = max(len(n) for n in rows)
        lines = [f"{'stage'.ljust(width)}  count    mean    p50    p95    p99  (ms)"]
        for name, r in sorted(rows.items()):
            lines.append(
                f"{name.ljust(width)}  {int(r['count']):5d}  "
                f"{r['mean_ms']:6.2f} {r['p50_ms']:6.2f} "
                f"{r['p95_ms']:6.2f} {r['p99_ms']:6.2f}"
            )
        return "\n".join(lines)


class _LaunchGate:
    """Launches pass while the gate is open; :meth:`closed` waits out the
    launches in progress and holds new ones back for a block. A profiler
    session starts and stops behind it: on the card, the profiler's
    tracing switched on or off while another thread launches a CUDA graph
    has hung both (a window opened beside a serving thread's replays)."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._active = 0
        self._closed = False
        self._local = threading.local()

    @contextlib.contextmanager
    def launching(self) -> Iterator[None]:
        """A launch; one nested in another on its thread (an ensemble's
        member) passes as part of it."""
        depth = getattr(self._local, "depth", 0)
        if depth:
            self._local.depth = depth + 1
            try:
                yield
            finally:
                self._local.depth = depth
            return
        with self._cv:
            while self._closed:
                self._cv.wait()
            self._active += 1
        self._local.depth = 1
        try:
            yield
        finally:
            self._local.depth = 0
            with self._cv:
                self._active -= 1
                if not self._active:
                    self._cv.notify_all()

    @contextlib.contextmanager
    def closed(self) -> Iterator[None]:
        with self._cv:
            while self._closed:
                self._cv.wait()
            self._closed = True
            while self._active:
                self._cv.wait()
        try:
            yield
        finally:
            with self._cv:
                self._closed = False
                self._cv.notify_all()


_gate = _LaunchGate()

# the launch windows of every thread while a device_trace is open (None when
# none is): a profiler window records host annotations only on the thread
# that opened it, while a server launches on its worker threads
_launch_log: list | None = None
_launch_log_lock = threading.Lock()
_tracing = False  # a device_trace is open (one at a time in a process)


@contextlib.contextmanager
def launch_scope(name: str) -> Iterator[None]:
    """``record_function(name)`` around a launcher call, behind the launch
    gate. While a :func:`device_trace` is open on any thread, the window
    also goes into its launch log, bracketed on a card by a
    ``cudaStreamQuery`` on each side: the runtime calls between the two
    of this thread in the trace are the launch's, with no clock to align."""
    from torch.profiler import record_function

    with _gate.launching():
        log_ = _launch_log
        if log_ is None:
            with record_function(name):
                yield
            return
        import torch

        mark = torch.cuda.current_stream().query if torch.cuda.is_available() else None
        if mark is not None:
            mark()
        t0 = time.perf_counter()
        try:
            with record_function(name):
                yield
        finally:
            t1 = time.perf_counter()
            if mark is not None:
                mark()
            log_.append((threading.get_native_id(), threading.get_ident(), t0, t1, name))


def _activities():
    from torch.profiler import ProfilerActivity

    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return activities


def prime_profiler() -> None:
    """Open and close one empty profiler session on this thread. The
    profiler's backend initializes on its first session and wants that on
    the thread that imported torch; a server's windows later open on its
    HTTP and sampler threads, so the server primes it while it starts."""
    from torch.profiler import profile

    with _gate.closed(), profile(activities=_activities()):
        pass


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """A ``torch.profiler`` window over the block: host ops and, where a
    card is present, its kernels and copies, written to
    ``<log_dir>/trace.json`` (Chrome trace format) when the block ends.
    Host timers see walls; this sees what the card did inside them.

    The session starts and stops behind the launch gate (:class:`_LaunchGate`).
    The profiler records host annotations only on this thread, while the
    card's runtime calls come from every thread; so the launch windows
    other threads open meanwhile (:func:`launch_scope`) are written to
    ``<log_dir>/`` :data:`opstats.LAUNCH_LOG` with the ``perf_counter``
    reading at which this thread's :data:`opstats.CLOCK_SYNC` annotation
    began (on a card: its last runtime call), and
    ``obs/opstats.summarize_profile_dir`` puts them on the trace's clock.
    One window at a time in a process."""
    import json

    from torch.profiler import profile, record_function

    from triton_client_tpu_torch.obs.opstats import CLOCK_SYNC, CLOCK_SYNC_CALLS, LAUNCH_LOG

    import torch

    global _launch_log, _tracing
    os.makedirs(log_dir, exist_ok=True)
    with _launch_log_lock:
        if _tracing:
            raise RuntimeError("a device trace is already open in this process")
        _tracing = True
    windows: list = []
    prof = profile(activities=_activities())
    try:
        # the log opens and closes with the session, behind the gate: every
        # launch it holds ran, with its markers, inside the session
        with _gate.closed():
            prof.start()
            _launch_log = windows
        try:
            t_sync = time.perf_counter()
            with record_function(CLOCK_SYNC):
                if torch.cuda.is_available():  # runtime calls, on their own clock
                    stream = torch.cuda.current_stream()
                    for _ in range(CLOCK_SYNC_CALLS - 1):
                        stream.query()
                    t_sync = time.perf_counter()
                    stream.query()
            yield
        finally:
            with _gate.closed():
                _launch_log = None
                prof.stop()
    finally:
        with _launch_log_lock:
            _tracing = False
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    own = (threading.get_native_id(), threading.get_ident())
    with open(os.path.join(log_dir, LAUNCH_LOG), "w") as fh:
        json.dump({"t_sync": t_sync, "sync_thread": list(own),
                   "windows": [list(w) for w in windows if (w[0], w[1]) != own]}, fh)


def annotate(name: str):
    """A named host region inside a ``torch.profiler`` window
    (``record_function``; JAX's ``jax.profiler.TraceAnnotation``): host
    spans beside the card's ops on the timeline."""
    from torch.profiler import record_function

    return record_function(name)


# latency buckets (seconds) for camera-rate serving: 1 ms .. 10 s
_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class PrometheusStageExporter:
    """Per-stage latency histograms on a metrics registry.

    One histogram family, ``<namespace>_stage_latency_seconds``, with a
    ``stage`` label: the serving stage is ``infer_<model>`` and a request
    trace's spans land as ``span_<name>`` (through ``obs.trace.Tracer``).
    ``registry``: the ``prometheus_client`` registry to export into (default
    the process-global one). A second exporter on the same (registry,
    namespace) records into the family already registered there rather
    than into nothing; give each server its own registry for independent
    series. ``port`` > 0 also starts ``prometheus_client``'s own HTTP
    server on it."""

    # registry -> {family name -> Histogram}
    _family_cache = None
    _family_cache_lock = threading.Lock()

    def __init__(self, port: int = 8002, namespace: str = "tpu_serving", registry=None) -> None:
        import weakref

        import prometheus_client

        if registry is None:
            registry = prometheus_client.REGISTRY
        self._lock = threading.Lock()
        self._label_sources: dict[str, str] = {}
        self._warned: set[tuple[str, str]] = set()
        name = f"{namespace}_stage_latency_seconds"
        cls = type(self)
        with cls._family_cache_lock:
            if cls._family_cache is None:
                cls._family_cache = weakref.WeakKeyDictionary()
            per_registry = cls._family_cache.setdefault(registry, {})
            family = per_registry.get(name)
            if family is None:
                try:
                    family = prometheus_client.Histogram(
                        name,
                        "wall-clock latency per pipeline/serving stage",
                        labelnames=("stage",),
                        buckets=_BUCKETS,
                        registry=registry,
                    )
                    per_registry[name] = family
                except ValueError:
                    # the name belongs to a collector this class did not make
                    log.warning("metric family %s already registered by a foreign collector; "
                                "this exporter records nothing", name)
                    family = None
        self._family = family
        if port:
            prometheus_client.start_http_server(port, registry=registry)

    def observe(self, stage: str, seconds: float) -> None:
        if self._family is None:
            return
        safe = "".join(c if c.isalnum() else "_" for c in stage)
        collision = None
        with self._lock:
            # two stage names that sanitize to one label value merge their
            # series: warn once a colliding pair
            first = self._label_sources.setdefault(safe, stage)
            if first != stage and (safe, stage) not in self._warned:
                self._warned.add((safe, stage))
                collision = first
            child = self._family.labels(stage=safe)
        if collision is not None:
            log.warning("stage label %r now receives both %r and %r: series merged",
                        safe, collision, stage)
        child.observe(seconds)

    def attach(self, profiler: StageProfiler) -> "PrometheusStageExporter":
        profiler.add_listener(self.observe)
        return self
