"""Request-scoped spans (the port's copy of ``obs/trace.py``).

A ``RequestTrace`` is a flat, thread-safe list of named ``(t0, t1)``
intervals on the ``time.perf_counter`` clock, one trace per request,
carried on ``InferRequest.trace`` through the batcher and the channel.
Call sites guard on the attribute, so the untraced path costs one
attribute read per phase. The batcher writes ``batch_queue``,
``merge_wait``, ``batch_merge`` and ``batch_respond``; a merged group's
channel call carries a ``MultiTrace`` that fans each span out to every
member.

The serving façade (``runtime/server.py``) starts one trace a request
from a :class:`Tracer`, whose bounded ring keeps the recent finished
ones; it adopts the caller's W3C-style :class:`TraceContext` from the
request's ``traceparent`` parameter, and sends a compact span summary
back in the response's ``trace_summary`` parameter
(:func:`encode_span_summary`), which a client grafts onto its own clock
(:func:`graft_span_summary`). The JAX module's Chrome-trace export and
its profiler and histogram feeds are not ported (ROADMAP.md Queue 1
item 8, the telemetry plane).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from typing import Iterator


class TraceContext:
    """W3C-traceparent-style distributed context: ``trace_id`` (32 hex)
    names the request across processes, ``parent_span_id`` (16 hex) the
    hop that issued this RPC. The wire form ``00-<trace_id>-<parent>-<flags>``
    rides the KServe request ``parameters`` under :attr:`PARAM_KEY`."""

    __slots__ = ("trace_id", "parent_span_id", "sampled")

    PARAM_KEY = "traceparent"
    _VERSION = "00"

    def __init__(self, trace_id: str, parent_span_id: str, sampled: bool = True) -> None:
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.sampled = bool(sampled)

    def encode(self) -> str:
        flags = "01" if self.sampled else "00"
        return f"{self._VERSION}-{self.trace_id}-{self.parent_span_id}-{flags}"

    @classmethod
    def decode(cls, value: str) -> "TraceContext | None":
        """Tolerant parse: anything malformed is None (a foreign header
        never fails the request it rides on)."""
        if not value or not isinstance(value, str):
            return None
        parts = value.split("-")
        if len(parts) != 4 or not parts[1] or not parts[2]:
            return None
        return cls(parts[1], parts[2], sampled=parts[3] != "00")

    def __repr__(self) -> str:
        return f"TraceContext({self.encode()!r})"


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

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter())

    def begin(self, name: str) -> None:
        with self._lock:
            self._open[name] = time.perf_counter()

    def end(self, name: str) -> None:
        t1 = time.perf_counter()
        with self._lock:
            t0 = self._open.pop(name, None)
            if t0 is not None:
                self.spans.append(Span(name, t0, t1))

    def wall_s(self) -> float:
        end = self.t_end if self.t_end is not None else time.perf_counter()
        return end - self.t_start


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


class Tracer:
    """Trace factory and bounded ring buffer of finished request traces.
    ``capacity`` 0 (or ``enabled=False``) makes ``start`` return None,
    which every call site reads as the untraced path."""

    def __init__(self, enabled: bool = True, capacity: int = 256) -> None:
        self.enabled = bool(enabled) and capacity > 0
        self.capacity = int(capacity)
        self._ring: collections.deque[RequestTrace] = collections.deque(
            maxlen=max(1, self.capacity)
        )
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._finished = 0

    def start(
        self, model: str = "", request_id: str = "", context: TraceContext | None = None
    ) -> RequestTrace | None:
        if not self.enabled:
            return None
        return RequestTrace(next(self._ids), model=model, request_id=request_id, context=context)

    def finish(self, trace: RequestTrace | None, status: str = "ok") -> None:
        if trace is None:
            return
        trace.t_end = time.perf_counter()
        trace.status = status
        with self._lock:
            self._ring.append(trace)
            self._finished += 1

    def recent(self, n: int = 0) -> list[RequestTrace]:
        """The most recent ``n`` finished traces (0: all buffered), oldest
        first."""
        with self._lock:
            traces = list(self._ring)
        return traces[-n:] if n else traces

    def stats(self) -> dict:
        with self._lock:
            return {"finished": self._finished, "buffered": len(self._ring),
                    "capacity": self.capacity}


# -- cross-process span summaries ---------------------------------------------

#: KServe response parameters key the server's span summary rides under
SUMMARY_PARAM_KEY = "trace_summary"


def encode_span_summary(trace: RequestTrace) -> str:
    """Compact summary for the response ``parameters``: microseconds
    relative to the trace's own start (each process has its own clock),
    ``{"w": wall_us, "st": status, "s": [[name, t0_rel_us, dur_us], ...]}``
    and ``"ctx"`` when the trace carries a distributed context."""
    t_start = trace.t_start
    with trace._lock:
        spans = [
            [s.name, round((s.t0 - t_start) * 1e6), round(s.duration_s * 1e6)]
            for s in sorted(trace.spans, key=lambda s: s.t0)
        ]
    doc = {"w": round(trace.wall_s() * 1e6), "st": trace.status, "s": spans}
    if trace.context is not None:
        doc["ctx"] = trace.context.encode()
    return json.dumps(doc, separators=(",", ":"))


def decode_span_summary(value: str) -> dict | None:
    """Tolerant inverse of :func:`encode_span_summary` (None on garbage)."""
    if not value:
        return None
    try:
        doc = json.loads(value)
    except (ValueError, TypeError):
        return None
    if not isinstance(doc, dict) or "s" not in doc or "w" not in doc:
        return None
    return doc


def graft_span_summary(
    trace: RequestTrace,
    summary: dict,
    t_sent: float,
    t_recv: float,
    prefix: str = "srv.",
    attrs: dict | None = None,
) -> None:
    """Place a far side's span summary on the local clock: the caller saw
    the RPC as [t_sent, t_recv]; the residue past the server's wall is
    split evenly into ``wire_send`` and ``wire_recv`` spans, and the
    server's spans land prefixed (``srv.``)."""
    rtt = max(0.0, t_recv - t_sent)
    server_wall = max(0.0, summary.get("w", 0) / 1e6)
    residue = max(0.0, rtt - server_wall)
    t_server_start = t_sent + residue / 2.0
    if residue > 0:
        trace.add("wire_send", t_sent, t_server_start, attrs)
        trace.add("wire_recv", t_server_start + server_wall, t_recv, attrs)
    for row in summary.get("s", ()):
        try:
            name, t0_us, dur_us = row[0], float(row[1]), float(row[2])
        except (IndexError, TypeError, ValueError):
            continue
        t0 = t_server_start + t0_us / 1e6
        trace.add(f"{prefix}{name}", t0, t0 + dur_us / 1e6, attrs)
