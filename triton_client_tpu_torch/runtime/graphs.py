"""Capture a function of device tensors once per input signature as a CUDA
graph, and replay it: the port's counterpart of ``jax.jit``.

``CapturedFunction(fn, name)`` wraps ``fn(*tensors)``, which returns a
tensor, or a tuple, list or dict of tensors, with shapes fixed by the
inputs' and no host sync (a sync cannot be captured).

- **On a CUDA device** the first call for a key (the inputs' shapes,
  dtypes and device, plus ``static_key()`` where given: a setting the
  function reads when it runs, as a jitted function reads one when it is
  traced) runs ``WARMUP_CALLS`` eager calls on a side stream (the kernels'
  libraries load, cuDNN picks its algorithms, the caching allocator
  settles), then captures one call into a ``torch.cuda.CUDAGraph`` over
  static input buffers. Every call, the first included, copies its inputs
  into the key's static buffers, replays the graph and returns clones of
  the static outputs, all on the current stream and under the wrapper's
  lock, so two threads never interleave on one graph's buffers and the
  caller owns what it gets: a later replay cannot overwrite it.
- **Graph pools.** The graphs of one wrapper share one memory pool. That
  is safe because their replays never overlap: each call runs under the
  lock, and waits on the stream of the call before it.
- **On the CPU** the wrapper calls ``fn``: there is nothing to capture.
- **Launch counts stay truthful.** A replay runs no Python, so the kernel
  wrappers' ``LaunchCounter.add`` would not see it. A capture records,
  per counter, the launches it captured (``cuda_build.recording``; they
  do not run then and are not counted), and every replay adds them.
- **Capture scopes.** ``capture_scope``, where given, is a context
  manager factory entered around a key's warmup calls and its capture;
  what it yields is kept with the key's graph for as long as the graph
  lives (the ragged route's kernel-6 tickets, ``ops/gpu_segment.
  owned_tickets``: a buffer the warmups allocate and the captured
  launches use).
- **Errors.** A capture or a replay that fails raises
  ``cuda_build.KernelError`` naming the function and the key. There is
  no eager retry: the caller fails, as on any kernel failure.

- **Loops that end on a computed value** (the NMS fixpoint, JAX's
  ``while_loop``) go through :func:`fixed_point`. A graph cannot end a
  loop on a value it computes, so a capture is cut there: the graph up to
  the loop, a graph of a block of passes, the graph after it. A replay
  replays the first, then the block until the host sees (from a flag
  copied behind each block into pinned memory) that a pass changed
  nothing, then the last.

``stats()`` reads ``calls``, ``captures``, ``replays``, ``keys`` and
``pool_bytes`` (the reserved device memory that each capture added,
``torch.cuda.memory_stats`` around it: the graphs' private pool).
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from triton_client_tpu_torch.ops import cuda_build


class _Entry:
    """One key's graph: its static inputs and outputs, its replay, and the
    launches one replay makes per counter."""

    __slots__ = ("replay", "inputs", "outputs", "launches", "keep")

    def __init__(self, replay, inputs, outputs, launches, keep=None) -> None:
        self.replay = replay
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.keep = keep  # what the capture scope yielded, alive with the graph


def _reserved(device: torch.device) -> int:
    return int(torch.cuda.memory_stats(device).get("reserved_bytes.all.current", 0))


def _end_generator_capture(device: torch.device) -> None:
    """Leave the card's random generator out of capture mode after a
    failed capture. ``capture_begin`` puts it in capture mode and a
    successful ``capture_end`` takes it out; an invalidated capture ends
    before that step, and every random op after it would then fail. One
    small capture that completes runs the step."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        graph.capture_begin(capture_error_mode="thread_local")
        torch.zeros(1, device=device).add_(1)
        graph.capture_end()


# the capture this thread has in progress (a _Segments), for fixed_point
_capturing = threading.local()
# passes a loop block of a captured fixed_point runs, and blocks the host
# issues past the last one it has checked
LOOP_BLOCK, LOOP_AHEAD = 8, 2
# eager calls before a capture
WARMUP_CALLS = 2


class _Segments:
    """A capture in progress, cut into graphs where the function runs a
    ``fixed_point`` loop. ``parts`` are the replay callables, in order."""

    def __init__(self, device: torch.device, pool) -> None:
        self.device, self.pool = device, pool
        self.parts: list[Callable[[], None]] = []
        self.graph: torch.cuda.CUDAGraph | None = None

    def begin(self) -> None:
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's sync (a readback, an eager request)
        # does not invalidate this capture; this thread's does
        self.graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def end(self) -> None:
        graph, self.graph = self.graph, None
        graph.capture_end()
        self.parts.append(graph.replay)

    def abort(self) -> None:
        if self.graph is not None:
            graph, self.graph = self.graph, None
            try:
                graph.capture_end()
            except Exception:
                pass  # the capture was already invalid; the caller's error is the cause

    def loop(self, step, state: torch.Tensor, passes: int) -> torch.Tensor:
        """The captured form of :func:`fixed_point`: ends the graph in
        progress, captures a block of passes over a static state buffer,
        adds the host loop over it to ``parts`` and begins the next graph."""
        static = torch.empty_like(state)
        static.copy_(state)  # the last op of the graph before the loop
        self.end()
        record = getattr(cuda_build._recording, "record", None)
        before = dict(record) if record is not None else None
        self.begin()
        x = static
        for _ in range(LOOP_BLOCK - 1):
            x = step(x)
        last = step(x)
        same = (last == x).all()
        static.copy_(last)
        self.end()
        if record is not None and record != before:
            raise RuntimeError("a fixed_point step launches a counted kernel; its replays "
                               "could not be counted")
        block = self.parts.pop()
        blocks = -(-passes // LOOP_BLOCK)

        def run() -> None:
            _poll_loop(block, same, blocks)

        self.parts.append(run)
        self.begin()
        return static


def _poll_loop(block: Callable[[], None], same: torch.Tensor, blocks: int) -> None:
    """Issue ``block`` up to ``blocks`` times, each followed by a copy of
    its ``same`` flag into pinned memory and an event; stop issuing once a
    finished block's flag says its last pass changed nothing. The host
    issues at most ``LOOP_AHEAD`` blocks past the last one it has checked,
    and waits on that block's event only then: a replay is one launch, so
    unchecked the host would issue every block before the card ran one."""
    flags = torch.empty(blocks, dtype=torch.bool, pin_memory=True)
    done: list[torch.cuda.Event] = []
    seen = 0
    for i in range(blocks):
        block()
        flags[i].copy_(same, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        done.append(event)
        while seen <= i and (i - seen >= LOOP_AHEAD or done[seen].query()):
            done[seen].synchronize()
            if bool(flags[seen]):
                return
            seen += 1


def fixed_point(step, state: torch.Tensor, passes: int) -> torch.Tensor:
    """``state = step(state)`` until a pass changes nothing, at most
    ``passes`` times (``lax.while_loop`` of a fixpoint). ``step`` must be
    a pure function of its argument. A pass after the fixpoint leaves the
    state as it is, so every form below gives the same result:

    - on the CPU the loop tests every pass, as the JAX loop does;
    - on the card, inside a capture of this module, the capture is cut
      here (``_Segments.loop``; the replay stops a block or two after the
      card reached the fixpoint);
    - on the card inside another capture, all ``passes`` passes;
    - on the card otherwise, the host never waits: each pass's test is
      copied into pinned memory behind an event, and the host stops issuing
      passes once it sees a finished test that changed nothing."""
    if state.device.type != "cuda":
        for _ in range(passes):
            new = step(state)
            if torch.equal(new, state):
                break
            state = new
        return state
    if torch.cuda.is_current_stream_capturing():
        segments = getattr(_capturing, "segments", None)
        if segments is not None and passes > 0:
            return segments.loop(step, state, passes)
        for _ in range(passes):
            state = step(state)
        return state
    same = torch.empty(passes, dtype=torch.bool, pin_memory=True)
    done: list[torch.cuda.Event] = []
    seen = 0
    for t in range(passes):
        new = step(state)
        same[t].copy_((new == state).all(), non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        done.append(event)
        state = new
        while seen <= t and done[seen].query():
            if bool(same[seen]):
                return state
            seen += 1
    return state


class CUDAGraphBackend:
    """Warmup and capture on the card (the default backend)."""

    def __init__(self) -> None:
        # owner -> {device: pool}, held weakly: a pool handle lives as long
        # as the wrapper whose graphs use it. Keyed by id() instead, a new
        # wrapper that reuses a freed one's id would capture into the freed
        # graphs' released pool (the caching allocator's internal assert
        # ``use_count > 0``)
        self._pools: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()

    def warmup(self, fn, inputs, times: int) -> None:
        device = inputs[0].device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(times):
                fn(*inputs)
        torch.cuda.current_stream(device).wait_stream(side)

    def capture(self, fn, inputs, owner) -> tuple[Callable[[], None], object, int]:
        """Capture ``fn(*inputs)``; returns (replay, static outputs, bytes
        the capture reserved). ``owner`` (the wrapper) keys the shared pool."""
        device = inputs[0].device
        pools = self._pools.setdefault(owner, {})
        pool = pools.get(device)
        if pool is None:
            pool = pools[device] = torch.cuda.graph_pool_handle()
        segments = _Segments(device, pool)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        before = _reserved(device)
        with torch.cuda.stream(stream):
            _capturing.segments = segments
            try:
                segments.begin()
                outputs = fn(*inputs)
                segments.end()
            except BaseException:
                segments.abort()
                # a pool that took part in a failed capture is not reused
                pools.pop(device, None)
                _end_generator_capture(device)
                raise
            finally:
                _capturing.segments = None
        torch.cuda.current_stream(device).wait_stream(stream)
        parts = segments.parts  # each holds its graph (a bound replay or a closure)

        def replay() -> None:
            for part in parts:
                part()

        return (parts[0] if len(parts) == 1 else replay), outputs, _reserved(device) - before


class CapturedFunction:
    """``fn`` captured per input signature and replayed (module docstring)."""

    def __init__(
        self,
        fn: Callable,
        name: str,
        static_key: Callable[[], object] | None = None,
        backend=None,
        capture_scope: Callable | None = None,
    ) -> None:
        """``backend``: what warms up and captures; None takes CUDA graphs
        for CUDA inputs and calls ``fn`` for CPU ones. A stand-in (tests)
        is used for inputs on any device. ``capture_scope``: see the
        module docstring."""
        self._fn = fn
        self.name = name
        self._static_key = static_key
        self._backend = backend
        self._capture_scope = capture_scope
        self._lock = threading.Lock()
        self._entries: dict[tuple, _Entry] = {}
        self._keys: set = set()
        self._last_event = None
        self._stats = {"calls": 0, "captures": 0, "replays": 0, "pool_bytes": 0}

    def key(self, args) -> tuple:
        key = tuple((tuple(a.shape), a.dtype, str(a.device)) for a in args)
        if self._static_key is not None:
            key += (self._static_key(),)
        return key

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["keys"] = len(self._keys)
        return out

    def __call__(self, *args: torch.Tensor):
        key = self.key(args)
        on_card = any(a.device.type == "cuda" for a in args)
        if self._backend is None and not on_card:
            with self._lock:
                self._stats["calls"] += 1
                self._keys.add(key)
            return self._fn(*args)
        backend = self._backend or _default_backend()
        with self._lock:
            self._stats["calls"] += 1
            self._keys.add(key)
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = self._capture(backend, key, args)
            return self._replay(entry, key, args)

    def _capture(self, backend, key, args) -> _Entry:
        scope = self._capture_scope() if self._capture_scope else contextlib.nullcontext()
        try:
            inputs = tuple(a.clone() for a in args)
            with scope as keep:
                backend.warmup(self._fn, inputs, WARMUP_CALLS)
                with cuda_build.recording() as rec:
                    replay, outputs, nbytes = backend.capture(self._fn, inputs, self)
        except Exception as e:
            raise cuda_build.KernelError(
                f"{self.name}: capturing a CUDA graph for key {key} failed: {e!r}"
            ) from e
        self._stats["captures"] += 1
        self._stats["pool_bytes"] += int(nbytes)
        return _Entry(replay, inputs, outputs, dict(rec.record), keep)

    def _replay(self, entry: _Entry, key, args):
        on_card = entry.inputs[0].device.type == "cuda"
        try:
            if on_card and self._last_event is not None:
                torch.cuda.current_stream(entry.inputs[0].device).wait_event(self._last_event)
            for static, arg in zip(entry.inputs, args):
                static.copy_(arg)
            entry.replay()
            for counter, n in entry.launches.items():
                counter.add(n)
            out = pytree.tree_map(torch.clone, entry.outputs)
            if on_card:
                self._last_event = torch.cuda.Event()
                self._last_event.record(torch.cuda.current_stream(entry.inputs[0].device))
        except Exception as e:
            raise cuda_build.KernelError(
                f"{self.name}: replaying the CUDA graph of key {key} failed: {e!r}"
            ) from e
        self._stats["replays"] += 1
        return out


_backend_lock = threading.Lock()
_backend: CUDAGraphBackend | None = None


def _default_backend() -> CUDAGraphBackend:
    global _backend
    with _backend_lock:
        if _backend is None:
            _backend = CUDAGraphBackend()
        return _backend
