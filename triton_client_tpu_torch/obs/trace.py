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
(:func:`graft_span_summary`). :func:`chrome_trace` (``Tracer.chrome_trace``)
exports traces in the Chrome trace format that Perfetto and
``chrome://tracing`` load, one row a request. The JAX ``Tracer``'s
``profiler=`` and ``histograms=`` feeds wait for the telemetry plane
(ROADMAP.md Queue 1 item 8, step 3).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
import uuid
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

    @classmethod
    def new(cls, sampled: bool = True) -> "TraceContext":
        """Originate a fresh context (the front door's role)."""
        return cls(uuid.uuid4().hex, uuid.uuid4().hex[:16], sampled)

    def child(self) -> "TraceContext":
        """Same trace, fresh parent span id: one per retry or hedge attempt,
        so sibling attempts are told apart on the server."""
        return TraceContext(self.trace_id, uuid.uuid4().hex[:16], self.sampled)

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

    def span_coverage(self) -> float:
        """Fraction of [t_start, t_end] covered by the union of the spans:
        the gauge of time no span accounts for."""
        wall = self.wall_s()
        if wall <= 0:
            return 1.0
        with self._lock:
            ivals = sorted((s.t0, s.t1) for s in self.spans)
        covered, cur0, cur1 = 0.0, None, None
        for t0, t1 in ivals:
            if cur1 is None or t0 > cur1:
                if cur1 is not None:
                    covered += cur1 - cur0
                cur0, cur1 = t0, t1
            else:
                cur1 = max(cur1, t1)
        if cur1 is not None:
            covered += cur1 - cur0
        return min(1.0, covered / wall)

    def summary(self) -> dict:
        with self._lock:
            spans = [
                {
                    "name": s.name,
                    "t0_s": s.t0 - self.t_start,
                    "dur_ms": s.duration_s * 1e3,
                    **({"attrs": s.attrs} if s.attrs else {}),
                }
                for s in sorted(self.spans, key=lambda s: s.t0)
            ]
        out = {
            "trace_id": self.trace_id,
            "model": self.model,
            "request_id": self.request_id,
            "status": self.status,
            "wall_ms": self.wall_s() * 1e3,
            "spans": spans,
        }
        if self.context is not None:
            out["context"] = self.context.encode()
        return out


class MultiTrace:
    """Fan-out proxy for merged device batches: a span added to it lands
    on every member's trace."""

    __slots__ = ("members",)

    def __init__(self, members) -> None:
        self.members = [m for m in members if m is not None]

    def add(self, name: str, t0: float, t1: float) -> None:
        for m in self.members:
            m.add(name, t0, t1)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
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

    def chrome_trace(self, n: int = 0) -> dict:
        return chrome_trace(self.recent(n))


def chrome_trace(traces) -> dict:
    """Chrome trace ('Trace Event Format') JSON for a list of traces.

    Complete ('X') events with microsecond timestamps, one tid (row) per
    request, the whole request as a parent event so its spans nest inside
    it. Timestamps rebase onto the earliest trace start, so the viewer
    opens at t=0."""
    traces = [t for t in traces if t is not None]
    if not traces:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    base = min(t.t_start for t in traces)

    def us(t: float) -> float:
        return round((t - base) * 1e6, 3)

    events: list[dict] = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": "tpu_serving"}}
    ]
    for tr in traces:
        tid = tr.trace_id
        label = f"req {tr.trace_id} {tr.model}".strip()
        events.append({"ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                       "args": {"name": label}})
        t_end = tr.t_end if tr.t_end is not None else time.perf_counter()
        req_args = {"model": tr.model, "request_id": tr.request_id, "status": tr.status}
        ctx = getattr(tr, "context", None)
        if ctx is not None:
            req_args["traceparent"] = ctx.encode()
        events.append({
            "ph": "X", "name": "request", "cat": "request", "pid": 1, "tid": tid,
            "ts": us(tr.t_start), "dur": max(0.0, (t_end - tr.t_start) * 1e6),
            "args": req_args,
        })
        for s in sorted(tr.spans, key=lambda s: s.t0):
            ev = {"ph": "X", "name": s.name, "cat": "span", "pid": 1, "tid": tid,
                  "ts": us(s.t0), "dur": max(0.0, s.duration_s * 1e6)}
            if s.attrs:
                ev["args"] = dict(s.attrs)
            events.append(ev)
    events.sort(key=lambda e: (e.get("ts", -1.0), e["tid"]))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_chrome_trace(traces, path: str) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(traces), f)


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
