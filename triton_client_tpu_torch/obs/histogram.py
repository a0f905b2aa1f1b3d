"""Fixed-bucket latency histograms (the port's copy of ``obs/histogram.py``).

A thread-safe fixed-bucket histogram whose snapshot is a plain dict of
numbers, so it rides ``RuntimeCollector.snapshot()``/``delta()`` like every
counter: a script diffs two snapshots and reads the window's percentiles.

- Buckets are non-cumulative counts keyed by the upper bound's ``repr``
  (``"0.005"`` ... ``"inf"``), so ``delta()``'s numeric diff yields the
  window's per-bucket counts and :func:`quantile_from_snapshot` reads a raw
  snapshot and a delta alike.
- Bounds are fixed at construction, so two histograms (or two snapshots of
  one) always merge and diff.
- ``observe`` is one bisect and two adds under a per-histogram lock: cheap
  enough to feed from ``Tracer.finish`` on every request.

:class:`HistogramFamily` keys child histograms by ``(model, stage)``, the
label set the collector exports as ``tpu_serving_latency_seconds``, with
the stages ``queue_delay``, ``merge_wait``, ``device_execute``,
``readback`` and ``e2e``.
"""

from __future__ import annotations

import bisect
import math
import threading

# Upper bounds in seconds, from 250 us (a fast device_execute) to 60 s; the
# +Inf overflow bucket is implicit.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# The per-request span names that feed SLO stages, and the stage label each
# exports under. batch_queue covers the batcher's queue end to end;
# merge_wait (recorded per member by the batcher) is its ready-queue part.
SLO_STAGES: dict[str, str] = {
    "batch_queue": "queue_delay",
    "merge_wait": "merge_wait",
    "device_execute": "device_execute",
    "readback": "readback",
}


class LatencyHistogram:
    """One fixed-bucket histogram (counts + sum), thread-safe."""

    __slots__ = ("_bounds", "_counts", "_overflow", "_sum", "_count", "_lock")

    def __init__(self, buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        self._bounds = tuple(sorted(float(b) for b in buckets))
        if not self._bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * len(self._bounds)
        self._overflow = 0
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        v = float(seconds)
        if v < 0 or math.isnan(v):
            v = 0.0  # clock skew or a bad sample: clamp, never throw
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            if i < len(self._bounds):
                self._counts[i] += 1
            else:
                self._overflow += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> dict:
        """``{"buckets": {"<bound>": n, ..., "inf": n}, "sum": s, "count":
        c}``: every leaf numeric, so ``RuntimeCollector.delta`` diffs two
        snapshots into the window's histogram."""
        with self._lock:
            buckets = {repr(b): c for b, c in zip(self._bounds, self._counts)}
            buckets["inf"] = self._overflow
            return {"buckets": buckets, "sum": self._sum, "count": self._count}

    def quantile(self, q: float) -> float:
        return quantile_from_snapshot(self.snapshot(), q)

    @property
    def bounds(self) -> tuple[float, ...]:
        return self._bounds


def quantile_from_snapshot(snap: dict, q: float) -> float:
    """The ``q``-quantile (0..1) of a histogram snapshot or of a ``delta()``
    of two snapshots.

    Linear interpolation inside the target bucket (Prometheus'
    ``histogram_quantile`` estimator), so the error is bounded by the
    bucket's width. 0.0 on an empty histogram, the largest finite bound
    when the quantile lands in +Inf."""
    buckets = snap.get("buckets") or {}
    items = sorted((float(k), int(v)) for k, v in buckets.items() if k != "inf")
    overflow = int(buckets.get("inf", 0))
    total = sum(c for _, c in items) + overflow
    if total <= 0:
        return 0.0
    rank = max(0.0, min(1.0, float(q))) * total
    seen = 0
    lo = 0.0
    for bound, c in items:
        if seen + c >= rank and c > 0:
            frac = (rank - seen) / c
            return lo + (bound - lo) * frac
        seen += c
        lo = bound
    return items[-1][0] if items else 0.0


class HistogramFamily:
    """A child :class:`LatencyHistogram` per (model, stage) label pair.

    ``observe`` creates children lazily under the family lock; snapshots key
    them ``"model|stage"``, the ``|``-joined convention of the collector's
    error counter, so ``delta()`` output stays flat."""

    def __init__(self, buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        self._buckets = tuple(buckets)
        self._children: dict[tuple[str, str], LatencyHistogram] = {}
        self._lock = threading.Lock()

    def child(self, model: str, stage: str) -> LatencyHistogram:
        key = (str(model), str(stage))
        h = self._children.get(key)
        if h is None:
            with self._lock:
                h = self._children.get(key)
                if h is None:
                    h = self._children[key] = LatencyHistogram(self._buckets)
        return h

    def observe(self, model: str, stage: str, seconds: float) -> None:
        self.child(model, stage).observe(seconds)

    def quantile(self, model: str, stage: str, q: float) -> float:
        with self._lock:
            h = self._children.get((str(model), str(stage)))
        return h.quantile(q) if h is not None else 0.0

    def count(self, model: str, stage: str) -> int:
        with self._lock:
            h = self._children.get((str(model), str(stage)))
        return h.snapshot()["count"] if h is not None else 0

    def snapshot(self) -> dict:
        with self._lock:
            children = dict(self._children)
        return {f"{model}|{stage}": h.snapshot() for (model, stage), h in sorted(children.items())}

    def items(self):
        with self._lock:
            return sorted(self._children.items())
