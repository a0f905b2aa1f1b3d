"""Op-level device attribution from ``torch.profiler`` traces (the port's
copy of ``obs/opstats.py``).

``--profile-trace DIR`` (``obs/profiling.device_trace``) writes a Chrome
trace whose device events are CUPTI's: kernels, memcpys and memsets on
the card's streams, each carrying the ``correlation`` id of the runtime
call that launched it (``cudaLaunchKernel``, ``cudaGraphLaunch``,
``cudaMemcpyAsync``, ...). This module parses it into per-op rows the
rest of the observability plane can rank, export and diff:

  op name, kind, occurrences, device time, share of the window's total
  op time, owning model, fused stage.

Op -> model attribution, in order (JAX's order: exact key first, window
second):

  1. **Correlation.** ``StagedChannel.launch`` wraps every launcher call
     in a ``record_function("launch:<model>:<version>")``. A kernel's
     device timestamp never lies inside that host-side window (the launch
     is asynchronous, and a graph replay runs no host code at all), but the
     runtime call that launched it does: the op is attributed through its
     ``correlation`` id to that call, and the call to the ``launch:`` window
     on its thread enclosing it. An op whose call lies in no window (the
     staging upload, the readback) is unattributed.
  2. **Window midpoints**, only for device ops with no correlation: an op
     whose midpoint falls inside exactly one model's windows is attributed
     to it (majority vote over a row's occurrences).

The hand-written kernels get their fused stage from
:data:`KERNEL_STAGES` (their CUDA function names -> JAX's
``ops/fused.FUSED_STAGES``): a graph replay runs no host annotation, so
the name is the only key a replayed kernel carries.

Everything here is stdlib (json + gzip): it parses offline, with no
profiler and no card.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import re

#: annotation prefix StagedChannel.launch emits around every launch
LAUNCH_ANNOTATION_PREFIX = "launch:"

#: host annotation that ties a trace's clock to ``time.perf_counter``
#: (``obs/profiling.device_trace`` opens one as its window starts)
CLOCK_SYNC = "clock_sync"

#: the launch windows of other threads beside a trace
#: (``obs/profiling.device_trace``): ``{"t_sync", "sync_thread": [native
#: tid, thread ident], "windows": [[native tid, thread ident, t0, t1, name],
#: ...]}``, ``perf_counter`` seconds
LAUNCH_LOG = "launch_log.json"

#: scope prefix of a fused stage's annotation window (``fused:<stage>``)
FUSED_SCOPE_PREFIX = "fused:"

_FUSED_SCOPE_RE = re.compile(r"fused:([A-Za-z0-9_]+)")

#: the hand kernels' CUDA functions -> their JAX fused stage: kernel 1
#: (``csrc/decode_nms_2d.cu``), 3 (``residual_decode_3d.cu``) and 4
#: (``suppress_pack_3d.cu``) are ``decode_nms``; kernel 5
#: (``segment_mean.cu``) is ``voxelize_scatter``. Kernels 2 and 6 belong
#: to no fused stage (as in JAX).
KERNEL_STAGES = {
    "decode_nms_2d_order": "decode_nms",
    "decode_nms_2d_mask": "decode_nms",
    "decode_nms_2d_scan": "decode_nms",
    "residual_decode_3d_kernel": "decode_nms",
    "suppress_pack_3d_order": "decode_nms",
    "suppress_pack_3d_mask": "decode_nms",
    "suppress_pack_3d_scan": "decode_nms",
    "segment_mean_zero": "voxelize_scatter",
    "segment_mean_walk": "voxelize_scatter",
}

#: CUPTI's device activities in torch.profiler's trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: host-side annotations mirrored onto the device timeline (not windows)
_DEVICE_ANNOTATION = "gpu_user_annotation"

_MANGLED_RE = re.compile(r"_Z(\d+)")


def kernel_function(name: str) -> str:
    """A CUDA kernel's function name from the trace's demangled signature
    (``void ns::f<...>(args)`` or ``(anonymous namespace)::f(args)`` ->
    ``f``) or a free function's
    Itanium-mangled one (``_Z19decode_nms_2d_orderPKf...`` ->
    ``decode_nms_2d_order``)."""
    if name.startswith("_Z"):
        m = _MANGLED_RE.match(name)
        if m:
            n = int(m.group(1))
            return name[m.end():m.end() + n]
    name = name.replace("(anonymous namespace)::", "")
    head = name.split("(", 1)[0].split("<", 1)[0].strip()
    if head.startswith("void "):
        head = head[len("void "):]
    return head.rsplit("::", 1)[-1].strip()


def fused_stage(name: str, args: dict | None = None) -> str | None:
    """Stage of a device op: a hand kernel's from :data:`KERNEL_STAGES`,
    else a ``fused:<stage>`` scope marker searched in the event name and
    every string-valued arg (JAX's rule)."""
    stage = KERNEL_STAGES.get(kernel_function(name))
    if stage is not None:
        return stage
    m = _FUSED_SCOPE_RE.search(name)
    if m:
        return m.group(1)
    for v in (args or {}).values():
        if isinstance(v, str):
            m = _FUSED_SCOPE_RE.search(v)
            if m:
                return m.group(1)
    return None


#: op-name substring -> kind, first match wins (JAX's rules; a cuBLAS or
#: CUTLASS GEMM kernel is a ``dot``). Coarse on purpose: the question is
#: what KIND of work dominates.
_KIND_RULES = (
    ("fusion", "fusion"),
    ("custom-call", "custom-call"),
    ("custom_call", "custom-call"),
    ("convolution", "convolution"),
    ("conv", "convolution"),
    ("dot", "dot"),
    ("gemm", "dot"),
    ("all-reduce", "collective"),
    ("all-gather", "collective"),
    ("reduce-scatter", "collective"),
    ("collective", "collective"),
    ("scatter", "scatter"),
    ("gather", "gather"),
    ("reduce", "reduce"),
    ("sort", "sort"),
    ("copy", "data-movement"),
    ("transpose", "data-movement"),
    ("reshape", "data-movement"),
    ("broadcast", "data-movement"),
    ("slice", "data-movement"),
    ("concatenate", "data-movement"),
    ("pad", "data-movement"),
    ("infeed", "host-transfer"),
    ("outfeed", "host-transfer"),
)


def op_kind(name: str) -> str:
    low = name.lower()
    for needle, kind in _KIND_RULES:
        if needle in low:
            return kind
    return "other"


def find_trace_file(log_dir: str) -> str | None:
    """Newest ``*trace.json(.gz)`` under a profile directory
    (``device_trace`` writes ``trace.json``; torch's TensorBoard handler
    ``<worker>.<ts>.pt.trace.json``), or the path itself when it already
    points at a trace file."""
    if os.path.isfile(log_dir):
        return log_dir
    candidates = glob.glob(
        os.path.join(log_dir, "**", "*trace.json.gz"), recursive=True
    ) + glob.glob(os.path.join(log_dir, "**", "*trace.json"), recursive=True)
    if not candidates:
        return None
    return max(candidates, key=os.path.getmtime)


def load_trace(path: str) -> dict:
    """Chrome-trace JSON document from a .json(.gz) file."""
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as fh:
            return json.load(fh)
    with open(path) as fh:
        return json.load(fh)


def _is_device_op(e: dict) -> bool:
    return str(e.get("cat", "")).lower() in DEVICE_CATEGORIES


def _launch_model(name: str, prefix: str) -> str:
    """``<prefix><model>:<version>`` -> model (the version is folded out:
    device time is accounted per model name everywhere else)."""
    return name[len(prefix):].rsplit(":", 1)[0]


def _host_annotations(events, prefix: str):
    """Host-side ``X`` events named ``<prefix>...``: the annotation windows."""
    for e in events:
        if (e.get("ph") == "X" and str(e.get("name", "")).startswith(prefix)
                and not _is_device_op(e) and e.get("cat") != _DEVICE_ANNOTATION):
            yield e


def _annotation_windows(events, prefix: str) -> dict[str, list]:
    """``model -> [(ts, ts_end), ...]`` from launch annotations."""
    windows: dict[str, list] = {}
    for e in _host_annotations(events, prefix):
        ts = float(e.get("ts", 0.0))
        windows.setdefault(_launch_model(e["name"], prefix), []).append(
            (ts, ts + float(e.get("dur", 0.0))))
    return windows


def _thread_windows(events, prefix: str) -> dict[tuple, tuple[list, list]]:
    """``(pid, tid) -> (starts, [(ts, ts_end, name), ...])`` sorted by start:
    the launch annotations of each host thread, for the correlation pass."""
    by_thread: dict[tuple, list] = {}
    for e in _host_annotations(events, prefix):
        ts = float(e.get("ts", 0.0))
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(
            (ts, ts + float(e.get("dur", 0.0)), e["name"]))
    out = {}
    for key, spans in by_thread.items():
        spans.sort()
        out[key] = ([s[0] for s in spans], spans)
    return out


def _runtime_calls(events) -> dict:
    """``correlation id -> (pid, tid, ts)`` of the host events that carry
    one (the CUDA runtime and driver calls)."""
    calls = {}
    for e in events:
        if e.get("ph") != "X" or _is_device_op(e):
            continue
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            calls[corr] = (e.get("pid"), e.get("tid"), float(e.get("ts", 0.0)))
    return calls


def _enclosing(call, thread_windows) -> str | None:
    """The innermost launch window on the call's thread containing it."""
    pid, tid, ts = call
    found = thread_windows.get((pid, tid))
    if found is None:
        return None
    starts, spans = found
    for i in range(bisect.bisect_right(starts, ts) - 1, -1, -1):
        lo, hi, name = spans[i]
        if lo <= ts <= hi:
            return name
    return None


def summarize(
    doc: dict,
    launchers: dict | None = None,
    annotation_prefix: str = LAUNCH_ANNOTATION_PREFIX,
    top_k: int = 0,
) -> dict:
    """Per-op rows from one Chrome-trace document.

    An event is a DEVICE OP when its category is one of
    :data:`DEVICE_CATEGORIES` (CUPTI's kernels, memcpys and memsets).
    ``launchers`` maps a launch annotation name (``spec.extra
    ["launch_annotation"]``, JAX's ``hlo_modules``) to the model it names;
    without an entry the name itself says ``launch:<model>:<version>``.
    Rows aggregate over ``(launch, op name, stage)``, ``launch`` being the
    annotation the op's correlation found (``module`` in a row: ``?`` when
    none did); ``top_k`` > 0 truncates to the K largest by device time (the
    totals in the summary header stay whole)."""
    events = doc.get("traceEvents", []) or []
    model_of = {str(k): str(v) for k, v in (launchers or {}).items()}
    windows = _annotation_windows(events, annotation_prefix)
    thread_windows = _thread_windows(events, annotation_prefix)
    calls = _runtime_calls(events)
    stage_windows = _stage_windows(events)

    rows: dict[tuple, dict] = {}
    total_us = 0.0
    for e in events:
        if e.get("ph") != "X" or not _is_device_op(e):
            continue
        args = e.get("args") or {}
        name = str(e.get("name", "?"))
        call = calls.get(args.get("correlation"))
        module = "?"
        if call is not None:
            module = _enclosing(call, thread_windows) or "?"
        stage = fused_stage(name, args)
        dur = float(e.get("dur", 0.0))
        ts = float(e.get("ts", 0.0))
        key = (module, name, stage, call is not None)
        row = rows.get(key)
        if row is None:
            row = rows[key] = {
                "op": name,
                "module": module,
                "kind": op_kind(name),
                "model": None,
                "stage": stage,
                "occurrences": 0,
                "time_us": 0.0,
                "_mid": [],
            }
        row["occurrences"] += 1
        row["time_us"] += dur
        row["_mid"].append(ts + dur / 2.0)
        total_us += dur

    # attribution pass: the correlated launch first, annotation midpoints
    # only for ops with no correlation; the fused-stage split rides the same
    # midpoints where the name carried no stage
    model_us: dict[str, float] = {}
    stage_us: dict[str, float] = {}
    unattributed_us = 0.0
    for (module, _name, _stage, correlated), row in rows.items():
        if module != "?":
            model = model_of.get(module) or _launch_model(module, annotation_prefix)
        elif correlated:
            model = None  # launched outside every launch window
        else:
            model = _attribute_windows(row["_mid"], windows)
        if row["stage"] is None and stage_windows:
            row["stage"] = _attribute_windows(row["_mid"], stage_windows)
        row["model"] = model
        del row["_mid"]
        if model is None:
            unattributed_us += row["time_us"]
        else:
            model_us[model] = model_us.get(model, 0.0) + row["time_us"]
        if row["stage"] is not None:
            stage_us[row["stage"]] = stage_us.get(row["stage"], 0.0) + row["time_us"]

    ordered = sorted(rows.values(), key=lambda r: -r["time_us"])
    for row in ordered:
        row["share"] = row["time_us"] / total_us if total_us > 0 else 0.0
    if top_k and top_k > 0:
        ordered = ordered[:top_k]
    return {
        "total_op_time_us": total_us,
        "op_count": len(rows),
        "ops": ordered,
        "models": model_us,
        "unattributed_us": unattributed_us,
        # a SPLIT of the device time already counted under its model
        "stages": stage_us,
        "annotation_windows": {m: len(ws) for m, ws in windows.items()},
    }


def _stage_windows(events) -> dict[str, list]:
    """``stage -> [(ts, ts_end), ...]`` from host-side ``fused:<stage>``
    annotations around an eager fused launch (device ops excluded: their
    stage is read from their name)."""
    windows: dict[str, list] = {}
    for e in _host_annotations(events, FUSED_SCOPE_PREFIX):
        stage = e["name"][len(FUSED_SCOPE_PREFIX):]
        ts = float(e.get("ts", 0.0))
        windows.setdefault(stage, []).append((ts, ts + float(e.get("dur", 0.0))))
    return windows


def _attribute_windows(midpoints: list, windows: dict[str, list]) -> str | None:
    """Majority vote of op-occurrence midpoints over the models' launch
    annotation windows; None when no midpoint lands in any window."""
    votes: dict[str, int] = {}
    for mid in midpoints:
        for model, spans in windows.items():
            if any(lo <= mid <= hi for lo, hi in spans):
                votes[model] = votes.get(model, 0) + 1
                break
    if not votes:
        return None
    return max(votes.items(), key=lambda kv: kv[1])[0]


#: the runtime calls :data:`CLOCK_SYNC` makes on a card (``Stream.query``,
#: :data:`CLOCK_SYNC_CALLS` times in a row: a run the profiler's own start
#: does not make on that thread; ``t_sync`` is read just before the last)
CLOCK_SYNC_CALL = "cudaStreamQuery"
CLOCK_SYNC_CALLS = 3


def _thread_keys(native: int, ident: int) -> tuple:
    """The ids a trace may name a thread by: its native id, or its
    ``pthread_t`` (``threading.get_ident``), whole or cut to 32 bits, as
    the card's traces name the runtime calls of some threads."""
    low = ident & 0xFFFFFFFF
    return (native, ident, low, low - (1 << 32) if low >= 1 << 31 else low)


def _clock_sync(events, thread: list | None) -> dict | None:
    """The event whose ``ts`` the launch log's ``t_sync`` names: the last of
    a run of :data:`CLOCK_SYNC_CALLS` or more consecutive
    :data:`CLOCK_SYNC_CALL` runtime calls of the tracing thread
    (``thread``: its native id and ident), made inside the
    :data:`CLOCK_SYNC` annotation, on the runtime calls' own clock (the
    card's traces put it ~1 ms off the host ops'); else the annotation
    itself (no card)."""
    mark = next((e for e in events if e.get("name") == CLOCK_SYNC and e.get("ph") == "X"), None)
    if mark is None:
        return None
    keys = set(_thread_keys(*thread)) if thread else {mark.get("tid")}
    calls = sorted((e for e in events if e.get("ph") == "X" and e.get("tid") in keys
                    and not _is_device_op(e) and e.get("cat") != _DEVICE_ANNOTATION
                    and (e.get("args") or {}).get("correlation") is not None),
                   key=lambda e: float(e["ts"]))
    run = 0
    for i, e in enumerate(calls + [None]):
        if e is not None and e.get("name") == CLOCK_SYNC_CALL:
            run += 1
            continue
        if run >= CLOCK_SYNC_CALLS:
            return calls[i - 1]
        run = 0
    return mark


def merge_launch_log(doc: dict, log: dict) -> int:
    """Add the launch windows other threads logged beside a trace
    (:data:`LAUNCH_LOG`) to its events as host annotations on the thread id
    the trace gives that thread's runtime calls (:func:`_thread_keys`).

    On a card each window is bracketed by one :data:`CLOCK_SYNC_CALL` of
    its thread on either side (``obs/profiling.launch_scope``): where a
    thread's calls hold two a window, the window spans its pair, on the
    runtime calls' own clock. Otherwise (no card, or a call the profiler
    dropped) it is placed by ``perf_counter``, offset by
    :func:`_clock_sync`. Returns the count added (0 without a sync
    event)."""
    events = doc.setdefault("traceEvents", [])
    sync = _clock_sync(events, log.get("sync_thread"))
    if sync is None:
        return 0
    offset_us = float(sync["ts"]) - float(log["t_sync"]) * 1e6
    calls_by_tid: dict = {}
    for e in events:
        if (e.get("ph") == "X" and not _is_device_op(e)
                and (e.get("args") or {}).get("correlation") is not None):
            calls_by_tid.setdefault(e.get("tid"), []).append(e)
    by_thread: dict = {}
    for window in log.get("windows") or []:
        by_thread.setdefault((window[0], window[1]), []).append(window)
    pid = sync.get("pid")
    added = 0
    for (native, ident), windows in by_thread.items():
        tid = next((k for k in _thread_keys(native, ident) if k in calls_by_tid), native)
        marks = sorted((e for e in calls_by_tid.get(tid, ()) if e.get("name") == CLOCK_SYNC_CALL),
                       key=lambda e: float(e["ts"]))
        paired = len(marks) == 2 * len(windows)
        for k, (_, _, t0, t1, name) in enumerate(windows):
            if paired:
                ts = float(marks[2 * k]["ts"])
                end = float(marks[2 * k + 1]["ts"]) + float(marks[2 * k + 1].get("dur", 0.0))
            else:
                ts, end = t0 * 1e6 + offset_us, t1 * 1e6 + offset_us
            events.append({
                "ph": "X", "cat": "user_annotation", "name": name, "pid": pid, "tid": tid,
                "ts": round(ts, 3), "dur": round(end - ts, 3),
                "args": {"launch_log": "bracketed" if paired else "clock"},
            })
            added += 1
    return added


def summarize_profile_dir(log_dir: str, launchers: dict | None = None, top_k: int = 0) -> dict:
    """Find the capture's trace file, parse it, merge the launch log beside
    it (:func:`merge_launch_log`), summarize. Raises ``FileNotFoundError``
    when the directory holds no trace."""
    path = find_trace_file(log_dir)
    if path is None:
        raise FileNotFoundError(f"no *trace.json(.gz) under {log_dir}")
    doc = load_trace(path)
    log_path = os.path.join(os.path.dirname(path), LAUNCH_LOG)
    merged = 0
    if os.path.exists(log_path):
        with open(log_path) as fh:
            merged = merge_launch_log(doc, json.load(fh))
    summary = summarize(doc, launchers=launchers, top_k=top_k)
    summary["trace_file"] = path
    summary["launch_log_windows"] = merged
    return summary
