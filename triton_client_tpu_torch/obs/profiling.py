"""Per-stage latency profiling and device tracing (the port's copy of
``obs/profiling.py``; numpy, and ``torch.profiler`` when a trace is asked
for).

- ``StageProfiler``: thread-safe rolling reservoir of wall-clock
  durations per named stage -> p50/p95/p99/mean/count snapshots (the
  detect CLIs' ``--profile`` table: source, infer, sink).
- ``device_trace``: a ``torch.profiler`` window (host and CUDA
  activities) exported as a Chrome trace into a directory, viewable in
  Perfetto or ``chrome://tracing``: the port's counterpart of the JAX
  package's ``jax.profiler`` trace behind ``--profile-trace``.

The JAX module's listeners, ``stage``/``wrap`` helpers and Prometheus
exporter serve the telemetry plane, which waits for ROADMAP.md Queue 1
item 8.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
from typing import Iterator

import numpy as np

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

    def record(self, stage: str, seconds: float) -> None:
        with self._lock:
            buf = self._stages.get(stage)
            if buf is None:
                buf = self._stages[stage] = collections.deque(maxlen=self._window)
            buf.append(float(seconds))
            self._counts[stage] = self._counts.get(stage, 0) + 1

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


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """A ``torch.profiler`` window over the block: host ops and, where a
    card is present, its kernels and copies, written to
    ``<log_dir>/trace.json`` (Chrome trace format) when the block ends.
    Host timers see walls; this sees what the card did inside them."""
    from torch.profiler import ProfilerActivity, profile

    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
