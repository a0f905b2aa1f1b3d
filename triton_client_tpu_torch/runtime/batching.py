"""Micro-batching channel: coalesce concurrent requests into one device
call (the port of ``runtime/batching.py``).

Batch formation is two-stage. The admission window (:class:`_PyBatcher`,
a queue and a thread) only signals arrival; the DISPATCHER forms the
device batch at the moment an execution slot frees, merging every
compatible request queued by then, so batch formation clocks itself off
device occupancy. ``pad_to_buckets`` pads each merge to the next power of
two with replicated rows, so the inner channel sees a handful of batch
shapes; ``max_merge`` lets the device batch grow past the admission size.

BatchingChannel is itself a BaseChannel and stacks above ``CUDAChannel``.
Requests merge only when model, version and the non-batch shapes and
dtypes of every input match; the rest run solo. A failed merged call
falls back to running each member alone, so one bad request cannot fail
its neighbours; each fallback is logged and counted
(``stats()["merge_fallbacks"]``). A kernel that fails to build, load or
launch (:class:`~triton_client_tpu_torch.ops.cuda_build.KernelError`)
fails the group's requests instead: a plain path must not hide it.

``serve --batcher window`` builds it; it is also the base of
:class:`~triton_client_tpu_torch.runtime.continuous.ContinuousBatchingChannel`,
and the tests hold the continuous dense path against it.

Not ported yet (ROADMAP Queue 1 item 8): the native C++ admission
window and the native staging arena. ``use_native=True`` or
``arena_slots > 0`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import itertools
import logging
import queue
import threading
import time

import numpy as np

from triton_client_tpu_torch.channel.base import BaseChannel, InferRequest, InferResponse
from triton_client_tpu_torch.obs.trace import MultiTrace
from triton_client_tpu_torch.ops.cuda_build import KernelError
from triton_client_tpu_torch.runtime import faults
from triton_client_tpu_torch.runtime.admission import DeadlineExpiredError, QueueFullError
from triton_client_tpu_torch.runtime.padding import bucket_for, pad_rows

log = logging.getLogger(__name__)

_NOT_PORTED = (
    "the native C++ batcher and its staging arena are not ported yet "
    "(ROADMAP Queue 1 item 8); use use_native=False and arena_slots=0"
)


def _merge_key(request: InferRequest):
    """Requests with equal keys can share one device batch. Session frames
    never merge: a unique key makes each a group of one."""
    if request.sequence_id:
        return ("__session__", id(request))
    return (
        request.model_name,
        request.model_version,
        tuple(
            (name, np.asarray(a).shape[1:], np.asarray(a).dtype.str)
            for name, a in sorted(request.inputs.items())
        ),
    )


class BatchingChannel(BaseChannel):
    def __init__(
        self,
        inner: BaseChannel,
        max_batch: int = 8,
        timeout_us: int = 2000,
        capacity: int = 256,
        use_native: bool = False,
        pipeline_depth: int = 2,
        max_merge: int | None = None,
        pad_to_buckets: bool = False,
        merge_hold_us: int = 0,
        arena_slots: int = 0,
        shed_expired: bool = False,
    ) -> None:
        """``pipeline_depth``: formed batches executing at once against the
        inner channel (batch N+1's upload overlaps batch N's execution at
        the default 2; 1 is strictly serial).

        ``max_merge``: frame cap of one device batch (default
        ``max_batch`` times the inner channel's ``batch_multiple``).

        ``pad_to_buckets``: pad each merged batch to the next power of two
        with replicated rows (their outputs are discarded).

        ``merge_hold_us``: when a slot frees onto a shallow queue, hold the
        dispatch up to this long for the rest of a client burst. 0 keeps
        dispatch eager.

        ``shed_expired``: at dispatch, members whose deadline has passed
        fail with ``DeadlineExpiredError`` and never reach the device, and
        a released window stages highest priority first.

        A slot frees at LAUNCH, not at readback: each group goes through
        ``inner.do_inference_async`` and releases its permit once the call
        returns, so the split and respond work runs outside the permit."""
        if use_native or arena_slots > 0:
            raise NotImplementedError(_NOT_PORTED)
        self._inner = inner
        self._pending: dict[int, tuple[InferRequest, concurrent.futures.Future]] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._py = None
        self._batch_multiple = max(1, int(getattr(inner, "batch_multiple", 1)))
        self._max_merge = int(
            max_merge if max_merge is not None else max_batch * self._batch_multiple
        )
        self._pad_to_buckets = bool(pad_to_buckets)
        self._merge_hold_s = max(0, int(merge_hold_us)) / 1e6
        self._pipeline_depth = max(1, int(pipeline_depth))
        self._inflight = threading.Semaphore(self._pipeline_depth)
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=self._pipeline_depth, thread_name_prefix="batch-exec"
        )
        # requests the admission stage has released, waiting for a slot
        self._ready: collections.deque = collections.deque()
        self._ready_cv = threading.Condition()
        self._dispatch_stop = False
        # dispatcher heartbeat: stamped at the top of each slot and inside
        # the idle wait, so only a wedged dispatcher goes stale
        self.stall_threshold_s = 5.0
        self._hb_ts = time.perf_counter()
        self._stall_logged = False
        self._merge_stats = {
            "merges": 0, "merged_frames": 0, "padded_frames": 0, "launch_frees": 0,
            "merge_fallbacks": 0, "kernel_failures": 0,
        }
        self._padded_by_model: collections.Counter = collections.Counter()
        self._shed_expired = bool(shed_expired)
        # "model|priority|stage" shed counts: "queue" (queue full) and
        # "merge" (deadline expired at dispatch)
        self._shed: collections.Counter = collections.Counter()
        self._merge_occupancy: collections.Counter = collections.Counter()
        # execution slots active at each group launch (1..pipeline_depth)
        self._active_slots = 0
        self._slot_occupancy: collections.Counter = collections.Counter()
        # per-batch wall decomposition sums; stats() reports means
        self._decomp = collections.defaultdict(float)
        if hasattr(inner, "pipeline_depth"):
            try:
                inner.pipeline_depth = self._pipeline_depth
            except (AttributeError, TypeError):
                pass  # read-only attribute on a custom channel
        self._start_admission(max_batch, timeout_us, capacity)
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="batch-dispatch"
        )
        self._dispatcher.start()
        self._watchdog_stop = threading.Event()
        self._watchdog = threading.Thread(
            target=self._watchdog_loop, daemon=True, name="batch-watchdog"
        )
        self._watchdog.start()

    def _start_admission(self, max_batch: int, timeout_us: int, capacity: int) -> None:
        """Bring up the admission window. The continuous scheduler
        overrides this to run without one."""
        self._py = _PyBatcher(self._on_batch, max_batch, timeout_us, capacity)
        self._py.start()

    # -- BaseChannel ----------------------------------------------------------

    @property
    def inner(self) -> BaseChannel:
        """The wrapped channel (``obs.collector.RuntimeCollector`` walks the
        stack through it)."""
        return self._inner

    def register_channel(self) -> None:
        self._inner.register_channel()

    def fetch_channel(self):
        return self._inner.fetch_channel()

    def get_metadata(self, model_name: str, model_version: str = ""):
        return self._inner.get_metadata(model_name, model_version)

    def do_inference(self, request: InferRequest) -> InferResponse:
        future: concurrent.futures.Future = concurrent.futures.Future()
        rid = next(self._ids)
        if request.trace is not None:
            # closed at dispatch (_run_group/_run_solo)
            request.trace.begin("batch_queue")
        with self._lock:
            self._pending[rid] = (request, future)
        try:
            admitted = self._py.enqueue(rid)
        except Exception:
            with self._lock:
                self._pending.pop(rid, None)
            raise
        if not admitted:
            with self._lock:
                self._pending.pop(rid, None)
            # fail fast, never block the submitting thread
            with self._ready_cv:
                self._shed[f"{request.model_name}|{request.priority}|queue"] += 1
            raise QueueFullError(f"model '{request.model_name}': inference queue full")
        return future.result()

    # -- admission release (runs on the admission thread) ---------------------

    def _on_batch(self, ids) -> None:
        """The admission window released some requests: stage them for the
        dispatcher, which merges at slot time."""
        with self._lock:
            work = [(rid, *self._pending.pop(rid)) for rid in ids if rid in self._pending]
        staged = []
        t_now = time.perf_counter()
        for rid, request, future in work:
            try:
                key = _merge_key(request)
                size = next(iter(int(np.asarray(a).shape[0]) for a in request.inputs.values()))
            except Exception:
                key, size = ("__solo__", rid), 1
            staged.append((key, size, request, future, t_now))
        if not staged:
            return
        if self._shed_expired and len(staged) > 1:
            # the high-priority class stages (and dispatches) first
            staged.sort(key=lambda it: -it[2].priority)
        with self._ready_cv:
            self._ready.extend(staged)
            self._ready_cv.notify()

    # -- dispatch (forms the device batch when a slot frees) ------------------

    def _dispatch_loop(self) -> None:
        while True:
            try:
                if self._dispatch_once():
                    return
            except Exception:
                # the failed slot's futures were already failed; an escaped
                # error would stall every later request
                log.exception("dispatcher slot failed; dispatcher continues")

    def _beat(self) -> None:
        """Stamp the dispatcher heartbeat (single writer, lock-free)."""
        self._hb_ts = time.perf_counter()

    def dispatcher_progress_age_s(self) -> float:
        """Seconds since the dispatch loop last made progress."""
        return max(0.0, time.perf_counter() - self._hb_ts)

    def _watchdog_loop(self) -> None:
        """Log once when the dispatcher makes no progress for
        ``stall_threshold_s``, and again when it recovers."""
        poll = max(0.25, self.stall_threshold_s / 4.0)
        while not self._watchdog_stop.wait(poll):
            age = self.dispatcher_progress_age_s()
            if age >= self.stall_threshold_s:
                if not self._stall_logged:
                    self._stall_logged = True
                    log.error(
                        "dispatcher STALLED: no progress for %.1fs (threshold %.1fs) — "
                        "ready_depth=%d, active_slots=%d; requests are queuing",
                        age, self.stall_threshold_s, len(self._ready), self._active_slots,
                    )
            elif self._stall_logged:
                self._stall_logged = False
                log.warning("dispatcher recovered after stall")
            poll = max(0.25, self.stall_threshold_s / 4.0)

    def _dispatch_once(self) -> bool:
        """One dispatcher slot: acquire a permit, form a group, submit it.
        Returns True when the loop should exit (close() requested and the
        ready set drained). An unexpected error fails the group's futures,
        releases the permit and re-raises for the loop to log."""
        self._beat()
        self._inflight.acquire()
        self._beat()
        group = None
        try:
            with self._ready_cv:
                while not self._ready and not self._dispatch_stop:
                    self._ready_cv.wait(timeout=0.1)
                    self._beat()  # idle is progress
                if self._ready:
                    group = self._form_group_locked()
                    if (
                        self._merge_hold_s > 0
                        and not self._dispatch_stop
                        and not self._ready
                        and sum(it[1] for it in group) < self._max_merge
                    ):
                        # hold for the rest of the client burst, absorbing
                        # same-key arrivals until the group fills or the
                        # hold expires
                        deadline = time.perf_counter() + self._merge_hold_s
                        while not self._dispatch_stop:
                            while self._ready:
                                frames = sum(it[1] for it in group)
                                item = self._ready[0]
                                if item[0] != group[0][0] or frames + item[1] > self._max_merge:
                                    break
                                group.append(self._ready.popleft())
                            left = deadline - time.perf_counter()
                            if (
                                left <= 0
                                or sum(it[1] for it in group) >= self._max_merge
                                or self._ready  # an unabsorbable head needs a slot
                            ):
                                break
                            self._ready_cv.wait(timeout=left)
                    self._merge_stats["merges"] += 1
                    frames = sum(it[1] for it in group)
                    self._merge_stats["merged_frames"] += frames
                    self._merge_occupancy[frames] += 1
                elif self._dispatch_stop:
                    self._inflight.release()
                    return True
            if group is None:
                self._inflight.release()
                return False

            with self._ready_cv:
                self._active_slots += 1

            def run(g=group, t_submit=time.perf_counter()):
                t_run = time.perf_counter()
                with self._ready_cv:
                    self._decomp["n"] += 1
                    self._decomp["exec_wait_s"] += t_run - t_submit
                    self._decomp["queue_wait_s"] += t_run - min(it[4] for it in g)
                    self._decomp["members"] += len(g)
                    self._decomp["member_wait_s"] += sum(t_run - it[4] for it in g)
                # the slot frees when the group LAUNCHES; the finally
                # covers groups that never launched (exactly once)
                released = [False]

                def free_slot():
                    if released[0]:
                        return
                    released[0] = True
                    with self._ready_cv:
                        self._slot_occupancy[self._active_slots] += 1
                        self._active_slots -= 1
                        self._merge_stats["launch_frees"] += 1
                    self._inflight.release()

                try:
                    # (t_staged, request, future): each member's staging
                    # time rides along for its merge_wait span
                    self._run_group([(it[4], it[2], it[3]) for it in g], free_slot)
                except Exception as e:
                    # an unresolved future would hang its caller forever
                    for it in g:
                        if not it[3].done():
                            it[3].set_exception(e)
                finally:
                    free_slot()

            try:
                self._exec.submit(run)
            except RuntimeError as e:  # executor shut down mid-close
                with self._ready_cv:
                    self._active_slots -= 1
                self._inflight.release()
                for it in group:
                    if not it[3].done():
                        it[3].set_exception(e)
            return False
        except Exception as e:
            self._inflight.release()
            if group:
                for it in group:
                    if not it[3].done():
                        it[3].set_exception(e)
            raise

    def _form_group_locked(self):
        """Pop the head item plus every queued same-key item that fits
        under max_merge frames (caller holds _ready_cv). Items of other
        keys keep their order for the next slot."""
        first = self._ready.popleft()
        group = [first]
        frames = first[1]
        skipped = []
        while self._ready and frames < self._max_merge:
            item = self._ready.popleft()
            if item[0] == first[0] and frames + item[1] <= self._max_merge:
                group.append(item)
                frames += item[1]
            else:
                skipped.append(item)
        self._ready.extendleft(reversed(skipped))
        return group

    def _pad_target(self, total: int) -> int:
        """Padded device-batch size for a merged total: the power-of-two
        table, divisible by the inner channel's batch multiple. The
        continuous scheduler learns its table from live traffic."""
        return bucket_for(total, self._batch_multiple)

    # -- batch execution (runs on the executor threads) -----------------------

    def _shed_expired_members(self, group) -> list:
        """Fail members whose deadline already passed and return the live
        rest (a merged batch inherits its tightest member's deadline)."""
        now = time.perf_counter()
        live = []
        for item in group:
            _t_staged, request, future = item
            deadline = request.deadline_s
            if deadline is None or now <= deadline:
                live.append(item)
                continue
            if request.trace is not None:
                request.trace.end("batch_queue")
            with self._ready_cv:
                self._shed[f"{request.model_name}|{request.priority}|merge"] += 1
            future.set_exception(
                DeadlineExpiredError(
                    f"model '{request.model_name}': deadline expired "
                    f"{(now - deadline) * 1e3:.1f}ms before dispatch"
                )
            )
        return live

    def _run_group(self, group, free_slot=None) -> None:
        """Execute one formed group. ``free_slot`` (when given) is called
        once the group's device work is enqueued, before the readback."""
        faults.probe("batcher_stall", group[0][1].model_name)
        if self._shed_expired:
            group = self._shed_expired_members(group)
            if not group:
                return  # every member expired; the caller's finally frees
        if len(group) == 1 and (not self._pad_to_buckets or group[0][1].sequence_id):
            # session frames stay solo even under bucket padding: pad rows
            # would read as extra frames of the stream
            t_staged, request, future = group[0]
            self._run_solo(request, future, free_slot, t_staged=t_staged)
            return
        if any(np.ndim(a) == 0 for _t, r, _f in group for a in r.inputs.values()):
            # a 0-d input (a 3D request's num_points) has no batch axis to
            # merge along: each member runs alone, as the JAX batcher's
            # failed merge ends up running them, without a fallback counted.
            # Every member launches before the slot frees, and only then do
            # the readbacks wait, so the pipeline overlap stays
            launched = [(future, self._launch_solo(request, future, t_staged))
                        for t_staged, request, future in group]
            if free_slot is not None:
                free_slot()
            for future, fut in launched:
                self._resolve_solo(future, fut)
            return
        requests = [g[1] for g in group]
        futures = [g[2] for g in group]
        traces = [r.trace for r in requests]
        t_dispatch = time.perf_counter()
        for t_staged, r, _f in group:
            if r.trace is not None and t_staged is not None:
                r.trace.add("merge_wait", t_staged, t_dispatch)
        for tr in traces:
            if tr is not None:
                tr.end("batch_queue")
        try:
            sizes = [next(iter(np.asarray(a).shape[0] for a in r.inputs.values()))
                     for r in requests]
            total = sum(sizes)
            # pad only when the rounded size still fits max_merge (a
            # non-power-of-two max_merge must not round past the cap)
            rounded = self._pad_target(total)
            pad = rounded - total if self._pad_to_buckets and rounded <= self._max_merge else 0
            t_stage0 = time.perf_counter()
            merged = {}
            for name in requests[0].inputs:
                parts = [np.asarray(r.inputs[name]) for r in requests]
                if pad:
                    parts = pad_rows(parts, pad)  # replicate a real row
                merged[name] = np.concatenate(parts)
            t_disp = time.perf_counter()
            for tr in traces:
                if tr is not None:
                    tr.add("batch_merge", t_stage0, t_disp)
            if self._shed_expired:
                # a member live at group formation may have expired during
                # the merge: shed it and rebuild from the survivors
                live = self._shed_expired_members(group)
                if len(live) != len(group):
                    if live:
                        self._run_group([(None, r, f) for (_t, r, f) in live], free_slot)
                    return
            try:
                deadlines = [r.deadline_s for r in requests if r.deadline_s is not None]
                fut = self._inner.do_inference_async(
                    InferRequest(
                        model_name=requests[0].model_name,
                        model_version=requests[0].model_version,
                        inputs=merged,
                        trace=(MultiTrace(traces) if any(t is not None for t in traces)
                               else None),
                        # the batch is late the moment any member is
                        deadline_s=min(deadlines) if deadlines else None,
                        priority=max(r.priority for r in requests),
                    )
                )
                if free_slot is not None:
                    free_slot()
                resp = fut.result()
            finally:
                t_dev_end = time.perf_counter()
                with self._ready_cv:
                    self._decomp["stage_s"] += t_disp - t_stage0
                    self._decomp["device_s"] += t_dev_end - t_disp
            if pad:
                # counted only for a padded call that ran
                with self._ready_cv:
                    self._merge_stats["padded_frames"] += pad
                    self._padded_by_model[requests[0].model_name] += pad
        except KernelError as e:
            self._fail_group(futures, e, "merge")
            return
        except Exception:
            # a merged failure must not take down unrelated requests
            self._count_fallback(self._merge_stats, "merge_fallbacks", requests)
            for request, future in zip(requests, futures):
                self._run_solo(request, future)
            return
        t_resp0 = time.perf_counter()
        splits = np.cumsum(sizes)[:-1]
        per_output = {}
        for name, arr in resp.outputs.items():
            arr = np.asarray(arr)
            if arr.ndim >= 1 and arr.shape[0] == total + pad:
                per_output[name] = np.split(arr[:total], splits)
            elif arr.ndim >= 1 and arr.shape[0] == total:
                per_output[name] = np.split(arr, splits)
            else:  # a non-batched output: replicate
                per_output[name] = [arr] * len(requests)
        for i, (request, future) in enumerate(zip(requests, futures)):
            if request.trace is not None:
                # before set_result: the waiter may finish the trace
                request.trace.add("batch_respond", t_resp0, time.perf_counter())
            future.set_result(
                InferResponse(
                    model_name=resp.model_name,
                    model_version=resp.model_version,
                    outputs={k: v[i] for k, v in per_output.items()},
                    request_id=request.request_id,
                    latency_s=resp.latency_s,
                )
            )

    def _fail_group(self, futures, error: KernelError, what: str) -> None:
        """A kernel failed under a merged or packed call: every member
        fails with it, none reruns on a path without the kernel."""
        log.error("%s group of %d failed in a kernel: %s", what, len(futures), error)
        with self._ready_cv:
            self._merge_stats["kernel_failures"] += 1
        for future in futures:
            future.set_exception(error)

    def _count_fallback(self, counters: dict, key: str, requests) -> None:
        """Log the failure being handled and count the group that falls
        back to solo calls in ``counters[key]``."""
        log.exception("group of %d for model %r failed; running each member alone",
                      len(requests), requests[0].model_name)
        with self._ready_cv:
            counters[key] += 1

    def _run_solo(self, request: InferRequest, future, free_slot=None, t_staged=None) -> None:
        fut = self._launch_solo(request, future, t_staged)
        if free_slot is not None:
            free_slot()  # launched: the slot frees before the readback
        self._resolve_solo(future, fut)

    def _launch_solo(self, request: InferRequest, future, t_staged=None):
        """Enqueue one request alone: the inner future, or None once
        ``future`` has failed at launch."""
        if request.trace is not None:
            if t_staged is not None:
                # None on the merged-failure retry, whose wait was recorded
                request.trace.add("merge_wait", t_staged, time.perf_counter())
            request.trace.end("batch_queue")
        try:
            return self._inner.do_inference_async(request)
        except Exception as e:
            future.set_exception(e)
            return None

    @staticmethod
    def _resolve_solo(future, fut) -> None:
        """Wait for a solo launch's readback into ``future``."""
        if fut is None:
            return
        try:
            future.set_result(fut.result())
        except Exception as e:
            future.set_exception(e)

    # -- stats / lifecycle ----------------------------------------------------

    def stats(self) -> dict:
        out = self._py.stats() if self._py is not None else {}
        with self._ready_cv:
            out.update(self._merge_stats)
            out["merge_occupancy"] = dict(sorted(self._merge_occupancy.items()))
            out["padded_by_model"] = dict(sorted(self._padded_by_model.items()))
            shipped = out["merged_frames"] + out["padded_frames"]
            # share of device rows that were padding
            out["pad_fraction"] = out["padded_frames"] / shipped if shipped else 0.0
            out["slot_occupancy"] = dict(sorted(self._slot_occupancy.items()))
            out["active_slots"] = self._active_slots
            out["ready_depth"] = len(self._ready)
            out["shed"] = dict(self._shed)
            out["max_merge"] = self._max_merge
            out["batch_multiple"] = self._batch_multiple
            out["pipeline_depth"] = self._pipeline_depth
            age = self.dispatcher_progress_age_s()
            out["dispatcher_last_progress_age_s"] = age
            out["dispatcher_stalled"] = 1 if age >= self.stall_threshold_s else 0
            n = self._decomp.get("n", 0.0)
            if n:
                out["decomp_ms"] = {
                    k[:-2]: round(self._decomp[k] / n * 1e3, 2)
                    for k in ("queue_wait_s", "exec_wait_s", "stage_s", "device_s")
                }
                out["decomp_batches"] = int(n)
            members = self._decomp.get("members", 0.0)
            if members:
                out["member_queue_delay_ms"] = round(
                    self._decomp["member_wait_s"] / members * 1e3, 2
                )
                out["merge_members"] = int(members)
        return out

    def close(self) -> None:
        self._watchdog_stop.set()
        # admission first: its close() drains every admitted id into
        # _on_batch, so all work is staged when it returns
        if self._py is not None:
            self._py.close()
        # the dispatcher keeps forming batches until the ready set is
        # empty, then exits: no admitted future is stranded
        with self._ready_cv:
            self._dispatch_stop = True
            self._ready_cv.notify_all()
        waited = 0.0
        while self._dispatcher.is_alive():
            self._dispatcher.join(timeout=30.0)
            if self._dispatcher.is_alive():
                waited += 30.0
                log.warning(
                    "batcher close(): dispatcher still draining after %.0fs "
                    "(device call in flight?)", waited,
                )
        # then drain in-flight groups so every admitted future resolves
        self._exec.shutdown(wait=True)


class _PyBatcher:
    """The admission window: a bounded queue and a thread that releases
    up to ``max_batch`` arrivals at a time, waiting at most ``timeout_us``
    after the first."""

    def __init__(self, on_batch, max_batch, timeout_us, capacity) -> None:
        self._on_batch = on_batch
        self._max_batch = max_batch
        self._timeout_s = timeout_us / 1e6
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="batch-admission")
        self._n_batches = 0
        self._n_requests = 0

    def start(self) -> None:
        self._thread.start()

    def enqueue(self, rid: int) -> bool:
        if self._stop.is_set():
            # never accept work no thread will drain
            raise RuntimeError("server not running")
        try:
            self._q.put_nowait(rid)
            return True
        except queue.Full:
            return False

    def _run(self) -> None:
        while not self._stop.is_set() or not self._q.empty():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            ids = [first]
            deadline = time.perf_counter() + self._timeout_s
            while len(ids) < self._max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    ids.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            self._n_batches += 1
            self._n_requests += len(ids)
            self._on_batch(ids)

    def stats(self) -> dict:
        return {
            "batches": self._n_batches,
            "batched_requests": self._n_requests,
            "mean_batch": self._n_requests / self._n_batches if self._n_batches else 0.0,
            "queue_depth": self._q.qsize(),
        }

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
