"""Request-scoped spans (the port's copy of ``Span``, ``RequestTrace`` and
``MultiTrace`` from ``obs/trace.py``).

A ``RequestTrace`` is a flat, thread-safe list of named ``(t0, t1)``
intervals on the ``time.perf_counter`` clock, one trace per request,
carried on ``InferRequest.trace`` through the batcher and the channel.
Call sites guard on the attribute, so the untraced path costs one
attribute read per phase. The batcher writes ``batch_queue``,
``merge_wait``, ``batch_merge`` and ``batch_respond``; a merged group's
channel call carries a ``MultiTrace`` that fans each span out to every
member. The ``Tracer`` ring buffer, the Chrome-trace export, the span
summaries and the coverage gauge of the JAX module are not ported yet.
"""

from __future__ import annotations

import threading
import time


class Span:
    """One named wall-clock interval on the perf_counter clock, with
    optional structured tags (``attrs``)."""

    __slots__ = ("name", "t0", "t1", "attrs")

    def __init__(self, name: str, t0: float, t1: float, attrs: dict | None = None) -> None:
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def __repr__(self) -> str:
        return f"Span({self.name!r}, {self.duration_s * 1e3:.3f} ms)"


class RequestTrace:
    """Spans for one request. Append-only, safe from any thread.

    ``begin(name)`` / ``end(name)`` open and close a span across threads
    (the batcher opens ``batch_queue`` on the caller's thread and closes
    it on an executor thread); ``end`` without a matching ``begin`` is a
    no-op, and a span left open is dropped."""

    __slots__ = (
        "trace_id", "model", "request_id", "t_start", "t_end", "status", "spans",
        "context", "_open", "_lock",
    )

    def __init__(
        self, trace_id: int, model: str = "", request_id: str = "", context: object = None
    ) -> None:
        self.trace_id = trace_id
        self.model = model
        self.request_id = request_id
        self.t_start = time.perf_counter()
        self.t_end: float | None = None
        self.status = "ok"
        self.spans: list[Span] = []
        # distributed context of the wire façade; None on local traces
        self.context = context
        self._open: dict[str, float] = {}
        self._lock = threading.Lock()

    def add(self, name: str, t0: float, t1: float, attrs: dict | None = None) -> None:
        with self._lock:
            self.spans.append(Span(name, t0, t1, attrs))

    def begin(self, name: str) -> None:
        with self._lock:
            self._open[name] = time.perf_counter()

    def end(self, name: str) -> None:
        t1 = time.perf_counter()
        with self._lock:
            t0 = self._open.pop(name, None)
            if t0 is not None:
                self.spans.append(Span(name, t0, t1))


class MultiTrace:
    """Fan-out proxy for merged device batches: a span added to it lands
    on every member's trace."""

    __slots__ = ("members",)

    def __init__(self, members) -> None:
        self.members = [m for m in members if m is not None]

    def add(self, name: str, t0: float, t1: float) -> None:
        for m in self.members:
            m.add(name, t0, t1)

    def begin(self, name: str) -> None:
        for m in self.members:
            m.begin(name)

    def end(self, name: str) -> None:
        for m in self.members:
            m.end(name)
