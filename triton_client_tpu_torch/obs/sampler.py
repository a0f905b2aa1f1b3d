"""Continuous op-level sampling: short profiler windows on a budget (the
port's copy of ``obs/sampler.py``).

One ``/profile`` capture answers "what ran during that second"; the
:class:`ContinuousSampler` takes a short ``torch.profiler`` window every
``interval_s`` seconds (``obs/profiling.device_trace``), parses it with
``obs/opstats.py`` and feeds the top-K op rows into the
``RuntimeCollector``, so ``tpu_serving_op_device_seconds{model,op,kind}``
is a standing series.

The duty cycle ``window_s / interval_s`` is clamped to
:data:`MAX_DUTY_CYCLE` at construction, and the sampler runs under the same
capture guard as ``/profile`` (one profiler session a process): when the
guard is busy it skips the tick and counts it (``skipped_busy``), the 409 a
second ``/profile`` caller gets. A failed window is counted in
``failures``. The capture directory is deleted after parsing.
"""

from __future__ import annotations

import logging
import shutil
import tempfile
import threading
import time

log = logging.getLogger(__name__)

#: hard ceiling on window_s / interval_s
MAX_DUTY_CYCLE = 0.01


class ContinuousSampler:
    """Background profiler sampling loop.

    ``sink``: anything answering ``record_op_sample(rows, window_s)`` (the
    ``RuntimeCollector``). ``hlo_modules``: zero-argument callable returning
    the live ``{launch annotation: model}`` map (read each tick).
    ``lock``: the shared capture guard (``TelemetryServer.profile_lock``; a
    private lock without the endpoint). ``sleep``: what waits out a window
    (``time.sleep``; tests pass a stand-in).

    The thread starts only on :meth:`start`; :meth:`sample_once` takes one
    window directly."""

    def __init__(
        self,
        sink=None,
        interval_s: float = 30.0,
        window_s: float = 0.2,
        top_k: int = 10,
        lock: threading.Lock | None = None,
        hlo_modules=None,
        sleep=time.sleep,
    ) -> None:
        self.interval_s = max(1.0, float(interval_s))
        # the window is clamped so the duty cycle never exceeds the budget
        self.window_s = min(max(0.01, float(window_s)), self.interval_s * MAX_DUTY_CYCLE)
        self.top_k = max(1, int(top_k))
        self._sink = sink
        self._lock = lock if lock is not None else threading.Lock()
        self._hlo_modules = hlo_modules
        self._sleep = sleep
        self._stats_lock = threading.Lock()
        self._captures = 0
        self._skipped_busy = 0
        self._failures = 0
        self._capture_seconds = 0.0
        self._started = time.perf_counter()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def duty_cycle(self) -> float:
        """Configured capture share of wall time (<= MAX_DUTY_CYCLE)."""
        return self.window_s / self.interval_s

    # -- one sample ------------------------------------------------------------

    def sample_once(self) -> dict | None:
        """Take one capture window now. Returns the opstats summary, or None
        when the capture guard was busy or the capture failed (each counted
        in ``stats()``)."""
        if not self._lock.acquire(blocking=False):
            # a /profile (or a concurrent tick) owns the profiler: skip,
            # never queue
            with self._stats_lock:
                self._skipped_busy += 1
            return None
        log_dir = None
        t0 = time.perf_counter()
        try:
            from triton_client_tpu_torch.obs import opstats
            from triton_client_tpu_torch.obs.profiling import device_trace

            log_dir = tempfile.mkdtemp(prefix="tpu_serving_sample_")
            with device_trace(log_dir):
                self._sleep(self.window_s)
            modules = {}
            if self._hlo_modules is not None:
                try:
                    modules = self._hlo_modules() or {}
                except Exception:
                    modules = {}
            summary = opstats.summarize_profile_dir(log_dir, launchers=modules, top_k=self.top_k)
            with self._stats_lock:
                self._captures += 1
                self._capture_seconds += time.perf_counter() - t0
            if self._sink is not None:
                try:
                    self._sink.record_op_sample(summary["ops"], self.window_s)
                except Exception:
                    log.exception("op-sample sink failed")
            return summary
        except Exception:
            log.exception("continuous profiler sample failed")
            with self._stats_lock:
                self._failures += 1
                self._capture_seconds += time.perf_counter() - t0
            return None
        finally:
            self._lock.release()
            if log_dir is not None:
                shutil.rmtree(log_dir, ignore_errors=True)

    # -- background loop -------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="op-sampler", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        # the first tick waits a whole interval: a server's first seconds
        # are captures nobody wants in the standing sample
        while not self._stop.wait(self.interval_s):
            self.sample_once()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.window_s + 5.0)
            self._thread = None

    # -- introspection ---------------------------------------------------------

    def stats(self) -> dict:
        with self._stats_lock:
            elapsed = max(time.perf_counter() - self._started, 1e-9)
            return {
                "interval_s": self.interval_s,
                "window_s": self.window_s,
                "duty_cycle": self.duty_cycle,
                "captures": self._captures,
                "skipped_busy": self._skipped_busy,
                "failures": self._failures,
                "capture_seconds": self._capture_seconds,
                "measured_duty_cycle": self._capture_seconds / elapsed,
            }
