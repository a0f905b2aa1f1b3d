"""Log correlation tags (the port's copy of ``log_tag`` from
``obs/logs.py``).

A request's log lines carry ``[trace=... req=...]`` so they grep across
client, router and server: the distributed ``trace_id`` of the trace's
context where there is one, else the process-local ring id.
"""

from __future__ import annotations


def log_tag(trace=None, request_id: str = "") -> str:
    """Correlation suffix ``" [trace=... req=...]"`` for a log line, or ""
    when there is neither a trace nor a request id."""
    parts = []
    rid = request_id
    if trace is not None:
        ctx = getattr(trace, "context", None)
        if ctx is not None:
            parts.append(f"trace={ctx.trace_id}")
        else:
            tid = getattr(trace, "trace_id", None)
            if tid is not None:
                parts.append(f"trace=local:{tid}")
        rid = rid or getattr(trace, "request_id", "")
    if rid:
        parts.append(f"req={rid}")
    return (" [" + " ".join(parts) + "]") if parts else ""
