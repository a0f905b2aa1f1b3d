"""Continuous batching: windowless EDF admission and packed ragged batches
(the port of ``runtime/continuous.py``).

It keeps the dispatch machinery of :class:`BatchingChannel` (permits,
executor, slot freed at launch, shedding, spans) and replaces its two
policies:

  * **admission** — no window and no admission thread: ``do_inference``
    stages the request straight into the ready set, kept in
    earliest-deadline-first order (ties: higher priority, then arrival),
    so the dispatcher always launches the work closest to its deadline
    and merges compatible later arrivals into it;
  * **batch shape** — a model that registers a segment-aware body
    (``RegisteredModel.ragged_fn`` and ``spec.extra["ragged_inputs"]``)
    runs as PACKED ragged batches: the members' rows concatenate back to
    back and a row -> segment table rides along
    (``parallel/ragged_kernels.py``), so every request runs at its true
    size and the body's ``segment_reduce`` launches kernel 6. Fixed-shape
    models keep the dense padded path, with pad targets from a live
    occupancy table (:class:`LiveBuckets`). The dense path stays equal
    per request to a direct call (pad rows replicate a real row and are
    sliced back off).

``ContinuousBatchingChannel(CUDAChannel(repo))`` is the in-process stack.
It takes none of the window knobs of :class:`BatchingChannel`
(``timeout_us``, ``merge_hold_us``, ``use_native``): there is no window,
and a hold would delay the tightest deadline. The JAX module's
shard-major packing for a mesh waits for the multi-GPU channel.
"""

from __future__ import annotations

import bisect
import collections
import concurrent.futures
import math
import threading
import time

import numpy as np

from triton_client_tpu_torch.channel.base import BaseChannel, InferRequest, InferResponse
from triton_client_tpu_torch.obs.trace import MultiTrace
from triton_client_tpu_torch.ops.cuda_build import KernelError
from triton_client_tpu_torch.parallel.ragged_kernels import RaggedLayout, pack_rows
from triton_client_tpu_torch.runtime.admission import QueueFullError
from triton_client_tpu_torch.runtime.batching import BatchingChannel, _merge_key
from triton_client_tpu_torch.runtime.padding import bucket_for, pad_batch


class LiveBuckets:
    """Pad-bucket table learned from the live merge sizes.

    The power-of-two table pads a steady stream of 6-frame merges to 8
    forever. This table watches the totals the dispatcher forms and
    promotes the frequent ones (>= ``min_share`` of observations, top
    ``max_sizes``) to buckets of their own, so recurring sizes pad to
    themselves; rare sizes fall back to the static table. Every entry is
    a multiple of ``multiple``. Callers synchronize (the batcher's
    ``_ready_cv``)."""

    def __init__(
        self, multiple: int = 1, max_sizes: int = 6, min_share: float = 0.10, warmup: int = 32
    ) -> None:
        self._multiple = max(1, int(multiple))
        self._max_sizes = int(max_sizes)
        self._min_share = float(min_share)
        self._warmup = int(warmup)
        self._seen: collections.Counter = collections.Counter()
        self._n = 0
        self._table: tuple[int, ...] = ()

    def observe(self, total: int) -> None:
        m = self._multiple
        self._seen[((max(1, total) + m - 1) // m) * m] += 1
        self._n += 1
        # re-derived every 16 observations: the table is a snapshot
        if self._n >= self._warmup and self._n % 16 == 0:
            floor = self._min_share * self._n
            self._table = tuple(
                sorted(s for s, c in self._seen.most_common(self._max_sizes) if c >= floor)
            )

    def target(self, total: int) -> int:
        """Smallest learned bucket >= total; else the static table."""
        for size in self._table:
            if size >= total:
                return size
        return bucket_for(total, self._multiple)

    @property
    def table(self) -> tuple[int, ...]:
        return self._table


class ContinuousBatchingChannel(BatchingChannel):
    """Windowless EDF scheduler with packed ragged execution (see the
    module docstring)."""

    def __init__(
        self,
        inner: BaseChannel,
        max_batch: int = 8,
        capacity: int = 256,
        pipeline_depth: int = 2,
        max_merge: int | None = None,
        pad_to_buckets: bool = True,
        arena_slots: int = 0,
        shed_expired: bool = False,
        live_buckets: bool = True,
    ) -> None:
        self._capacity = max(1, int(capacity))
        # (model, version) -> frozenset of packed-input names, or None for
        # a model without a segment-aware body; filled lazily from the
        # caller's and the executor threads, inserts under the lock (the
        # metadata call itself runs outside it)
        self._ragged_inputs_cache: dict = {}
        self._ragged_cache_lock = threading.Lock()
        self._ragged_stats = {
            "ragged_batches": 0, "ragged_segments": 0, "ragged_rows": 0, "ragged_pad_rows": 0,
            "ragged_fallbacks": 0,
        }
        # optional multi-tenant fair share: a duck-typed table with
        # tenant_of(model) and share(tenant), folded into the EDF key as a
        # deficit-round-robin virtual time; None keeps pure EDF
        self._tenant_table = None
        self._fair_quantum_s = 0.005
        self._vtime: dict[str, float] = {}
        self._tenant_frames: collections.Counter = collections.Counter()
        super().__init__(
            inner,
            max_batch=max_batch,
            timeout_us=0,
            capacity=capacity,
            use_native=False,
            pipeline_depth=pipeline_depth,
            max_merge=max_merge,
            pad_to_buckets=pad_to_buckets,
            merge_hold_us=0,
            arena_slots=arena_slots,
            shed_expired=shed_expired,
        )
        self._live_buckets = LiveBuckets(multiple=self._batch_multiple) if live_buckets else None
        with self._ready_cv:
            # the ready set is an EDF-sorted list, not the base FIFO deque;
            # swapped under the cv so the running dispatcher never sees a
            # half state
            self._ready = []

    # -- admission: straight into the EDF ready set ---------------------------

    def _start_admission(self, max_batch, timeout_us, capacity):
        """No admission window: requests stage in ``do_inference``."""

    def attach_tenants(self, table, quantum_s: float = 0.005) -> None:
        """Fold deficit-round-robin fair share over a tenant table into
        the ready order. Each tenant accrues virtual time
        ``frames / share`` as its work dispatches; a tenant ahead of the
        pack by ``lag`` has its requests' deadlines pushed back by
        ``lag * quantum_s``, so a low-share tenant flooding the queue
        cannot starve a high-share tenant (its own requests sort later,
        none are dropped)."""
        with self._ready_cv:
            self._tenant_table = table
            self._fair_quantum_s = float(quantum_s)

    def _edf_key(self, item):
        """Earliest deadline first, deadline-less requests last; higher
        priority breaks ties and ``insort`` keeps arrival order inside a
        class. With a tenant table, a tenant's lag pushes its effective
        deadline back."""
        request = item[2]
        deadline = request.deadline_s if request.deadline_s is not None else math.inf
        table = self._tenant_table
        if table is None:
            return (deadline, -request.priority, 0.0)
        lag = 0.0
        if self._vtime:
            floor = min(self._vtime.values())
            lag = max(0.0, self._vtime.get(table.tenant_of(request.model_name), floor) - floor)
        return (deadline + lag * self._fair_quantum_s, -request.priority, lag)

    def _charge_tenants_locked(self, group) -> None:
        """DRR accounting at group formation (caller holds _ready_cv)."""
        table = self._tenant_table
        floor = min(self._vtime.values()) if self._vtime else 0.0
        for item in group:
            request, frames = item[2], item[1]
            tenant = table.tenant_of(request.model_name)
            self._vtime[tenant] = self._vtime.get(tenant, floor) + frames / table.share(tenant)
            self._tenant_frames[tenant] += frames
        # renormalize so the virtual times stay bounded
        floor = min(self._vtime.values())
        if floor > 1e6:
            for tenant in self._vtime:
                self._vtime[tenant] -= floor

    def do_inference(self, request: InferRequest) -> InferResponse:
        future: concurrent.futures.Future = concurrent.futures.Future()
        if request.trace is not None:
            request.trace.begin("batch_queue")
        ragged_names = self._ragged_names(request.model_name, request.model_version)
        if request.sequence_id:
            # session frames bypass both merge paths
            ragged_names = None
        if ragged_names:
            # one segment a request: same-model ragged requests merge
            # whatever their row counts
            key = ("__ragged__", request.model_name, request.model_version)
            size = 1
        else:
            try:
                key = _merge_key(request)
                size = next(iter(int(np.asarray(a).shape[0]) for a in request.inputs.values()))
            except Exception:
                key, size = ("__solo__", next(self._ids)), 1
        with self._ready_cv:
            if len(self._ready) >= self._capacity:
                self._shed[f"{request.model_name}|{request.priority}|queue"] += 1
                raise QueueFullError(f"model '{request.model_name}': inference queue full")
            bisect.insort(
                self._ready, (key, size, request, future, time.perf_counter()), key=self._edf_key
            )
            self._ready_cv.notify()
        return future.result()

    # -- group formation: EDF head + compatible followers ---------------------

    def _form_group_locked(self):
        """Pop the EDF head, then walk the (still sorted) ready set
        absorbing same-key items under the frame cap. Other items keep
        their EDF positions (caller holds _ready_cv)."""
        first = self._ready.pop(0)
        group = [first]
        frames = first[1]
        i = 0
        while i < len(self._ready) and frames < self._max_merge:
            item = self._ready[i]
            if item[0] == first[0] and frames + item[1] <= self._max_merge:
                group.append(self._ready.pop(i))
                frames += item[1]
            else:
                i += 1
        if self._tenant_table is not None:
            self._charge_tenants_locked(group)
        return group

    # -- dense pad targets from the live table --------------------------------

    def _pad_target(self, total: int) -> int:
        if self._live_buckets is None:
            return super()._pad_target(total)
        with self._ready_cv:
            self._live_buckets.observe(total)
            return self._live_buckets.target(total)

    # -- ragged capability ----------------------------------------------------

    def _ragged_names(self, model_name: str, model_version: str):
        """Packed-input names of a model with a segment-aware body
        (``spec.extra["ragged_inputs"]``), else None. Cached, negative
        answers too; the metadata call runs unlocked and racing fillers
        agree through ``setdefault`` under ``_ragged_cache_lock``."""
        key = (model_name, model_version)
        try:
            return self._ragged_inputs_cache[key]
        except KeyError:
            pass
        names = None
        try:
            spec = self._inner.get_metadata(model_name, model_version)
            declared = (getattr(spec, "extra", None) or {}).get("ragged_inputs")
            if declared:
                names = frozenset(declared)
        except Exception:
            names = None
        with self._ragged_cache_lock:
            return self._ragged_inputs_cache.setdefault(key, names)

    # -- ragged execution -----------------------------------------------------

    def _run_group(self, group, free_slot=None) -> None:
        if self._ragged_names(group[0][1].model_name, group[0][1].model_version):
            if len(group) == 1:
                # a lone ragged request runs solo at its true size, through
                # infer_fn: no packing, so no segment kernel
                if self._shed_expired:
                    group = self._shed_expired_members(group)
                    if not group:
                        return
                t_staged, request, future = group[0]
                self._run_solo(request, future, free_slot, t_staged=t_staged)
            else:
                self._run_ragged_group(group, free_slot)
            return
        super()._run_group(group, free_slot)

    def _run_ragged_group(self, group, free_slot=None) -> None:
        """Execute one ragged group as a PACKED batch: member rows
        concatenate, the segment table rides in ``request.ragged``, and
        the inner channel's ragged route runs every member at true size.
        As in the dense path, futures always resolve, a failure falls back
        to running each member alone (logged, ``ragged_fallbacks``) unless
        a kernel failed, and ``free_slot`` fires at launch."""
        if self._shed_expired:
            group = self._shed_expired_members(group)
            if not group:
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
            ragged_names = self._ragged_names(requests[0].model_name, requests[0].model_version)
            first_ragged = next(n for n in requests[0].inputs if n in ragged_names)
            sizes = tuple(int(np.asarray(r.inputs[first_ragged]).shape[0]) for r in requests)
            layout = RaggedLayout(sizes)
            t_stage0 = time.perf_counter()
            merged = {}
            for name in requests[0].inputs:
                parts = [np.asarray(r.inputs[name]) for r in requests]
                if name in ragged_names:
                    merged[name] = pack_rows(parts, layout)
                else:
                    # per-segment inputs stack to the segment bucket (dead
                    # slots replicate a real entry)
                    merged[name] = pad_batch(np.stack(parts), layout.seg_bucket)
            t_disp = time.perf_counter()
            for tr in traces:
                if tr is not None:
                    tr.add("batch_merge", t_stage0, t_disp)
            if self._shed_expired:
                # a slow pack must not launch already-expired members
                live = self._shed_expired_members(group)
                if len(live) != len(group):
                    if live:
                        self._run_ragged_group([(None, r, f) for (_t, r, f) in live], free_slot)
                    return
            deadlines = [r.deadline_s for r in requests if r.deadline_s is not None]
            try:
                fut = self._inner.do_inference_async(
                    InferRequest(
                        model_name=requests[0].model_name,
                        model_version=requests[0].model_version,
                        inputs=merged,
                        trace=(MultiTrace(traces) if any(t is not None for t in traces)
                               else None),
                        deadline_s=min(deadlines) if deadlines else None,
                        priority=max(r.priority for r in requests),
                        ragged=layout,
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
            with self._ready_cv:
                self._ragged_stats["ragged_batches"] += 1
                self._ragged_stats["ragged_segments"] += len(requests)
                self._ragged_stats["ragged_rows"] += layout.total
                self._ragged_stats["ragged_pad_rows"] += layout.pad_rows
        except KernelError as e:
            self._fail_group(futures, e, "packed")
            return
        except Exception:
            # a packed failure must not take down unrelated requests
            self._count_fallback(self._ragged_stats, "ragged_fallbacks", requests)
            for request, future in zip(requests, futures):
                self._run_solo(request, future)
            return
        t_resp0 = time.perf_counter()
        n = len(requests)
        per_output = {}
        for name, arr in resp.outputs.items():
            arr = np.asarray(arr)
            if arr.ndim >= 1 and arr.shape[0] == n:
                # the channel sliced the dead slots off; member i's output
                # is row i without the segment dim, as its solo output
                per_output[name] = [arr[i] for i in range(n)]
            else:  # a non-segmented output: replicate
                per_output[name] = [arr] * n
        for i, (request, future) in enumerate(zip(requests, futures)):
            if request.trace is not None:
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

    # -- stats ----------------------------------------------------------------

    def stats(self) -> dict:
        out = super().stats()
        out["scheduler"] = "continuous"
        with self._ready_cv:
            out.update(self._ragged_stats)
            if self._live_buckets is not None:
                out["live_bucket_table"] = list(self._live_buckets.table)
            if self._tenant_table is not None:
                out["tenant_served_frames"] = dict(self._tenant_frames)
                out["tenant_vtime"] = dict(self._vtime)
        shipped = (out["merged_frames"] + out["padded_frames"] + out["ragged_rows"]
                   + out["ragged_pad_rows"])
        if shipped:
            # ragged pad rows (bucket slack of the packed rows) and dense
            # pad rows are both rows the device computed for nobody
            out["pad_fraction"] = (out["padded_frames"] + out["ragged_pad_rows"]) / shipped
        return out
