"""Staged dispatch: the stage / launch / resolve engine (port of
``channel/staged.py``, without the device mesh).

- **stage**: validate, take a staging slot, then hand the request to
  :meth:`StagedChannel._place_inputs` (the subclass's placement policy).
  At ``pipeline_depth`` (default 2) request N+1's host-to-device copy
  runs while request N executes; ``pipeline_depth=1`` is the serial path.
- **launch**: enqueue the model through the launcher the subclass builds
  in :meth:`StagedChannel._make_launcher` (a packed ragged request: in
  :meth:`StagedChannel._make_ragged_launcher`, one a segment bucket),
  cached per model identity (``_launcher``, ``_ragged_launcher``) and dropped when the model is unregistered or its
  circuit breaker opens. Outputs stay on the device; a CUDA event is
  recorded behind them.
- **resolve**: lazy. ``launch`` returns an ``InferFuture``; the
  device-to-host copy happens in :meth:`StagedChannel._host_outputs`
  only when the caller resolves it, after waiting on the launch's event
  (the counterpart of ``block_until_ready``, which splits
  ``device_execute`` from ``readback`` in a request's trace), and
  resolving retires the staging slot.

``do_inference`` is stage -> launch -> result; ``do_inference_async``
defers the readback, and any dispatch error, to ``result()``.

Every launcher call runs inside a ``torch.profiler.record_function``
named ``launch:<model>:<version>`` (``obs/roofline.launcher_name``), by
which ``obs/opstats`` attributes the card's ops to the model.
``attach_device_time`` attaches an ``obs/device_time.DeviceTimeLedger``:
each launch then records its device window (see
:meth:`StagedChannel._begin_window`) into it when it resolves, and the
first launch of each model identity measures its flops and bytes
(``obs/roofline.record_launch_cost``) into ``spec.extra``. With no ledger
attached neither happens.

The JAX engine's lifecycle and sessions hooks are not ported:
``attach_lifecycle`` and ``attach_sessions`` raise
``NotImplementedError``.
"""

from __future__ import annotations

import collections
import functools
import logging
import threading
import time

import numpy as np
import torch

from triton_client_tpu_torch.channel.base import (
    BaseChannel,
    InferFuture,
    InferRequest,
    InferResponse,
)
from triton_client_tpu_torch.config import ModelSpec
from triton_client_tpu_torch.obs.roofline import launcher_name, record_launch_cost
from triton_client_tpu_torch.parallel.ragged_kernels import RaggedLayout
from triton_client_tpu_torch.runtime import faults
from triton_client_tpu_torch.runtime.admission import (
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExpiredError,
)
from triton_client_tpu_torch.runtime.precision import bf16_words_to_f32, host_array, is_bf16_words
from triton_client_tpu_torch.runtime.repository import ModelRepository

# the key under which a packed request's segment ids ride with its inputs
SEGMENT_IDS_KEY = "__segment_ids__"

_NOT_PORTED = (
    "the {} hook of the staged channel is not ported yet "
    "(ROADMAP.md Queue 1, 'Serving breadth')"
)

log = logging.getLogger(__name__)


def _batch_rows(device_inputs: dict) -> int:
    """Frames in one dense launch: the largest leading dim among the staged
    tensors (shape metadata only), as JAX counts them; but a request that
    carries a 0-d tensor (the 3D contract's point count beside its padded
    cloud) is one scan, where JAX counts the cloud's padded points."""
    if any(getattr(v, "ndim", 1) == 0 for v in device_inputs.values()):
        return 1
    rows = 1
    for v in device_inputs.values():
        if getattr(v, "ndim", 0) >= 1:
            rows = max(rows, int(v.shape[0]))
    return rows


def cast_wire_input(model, name: str, arr: np.ndarray) -> np.ndarray:
    """Never widen on the host; cast a stray wider dtype down to the spec's.
    A narrower input (uint8 camera frames against an FP32 spec) uploads as
    it is, a quarter of the bytes, and the pipeline widens it on the
    device; a float64 or int64 one casts down to the wire contract. Then
    the registered model's precision policy narrows further
    (``PrecisionPolicy.wire_cast``: a ``bf16`` model's float32 frames stage
    as bfloat16 words, half the bytes; a calibrated ``int8`` model's as int8
    codes, a quarter, dequantized inside its captured body; keep-list inputs
    such as the 3D ``points`` stay float32)."""
    try:
        want = model.spec.input_by_name(name).np_dtype()
    except (KeyError, ValueError):
        want = None  # undeclared or BF16 inputs pass through as they are
    if want is not None and arr.dtype != want and want.itemsize <= arr.dtype.itemsize:
        # BF16 words widen exactly before the cast (numpy would cast the words)
        arr = (bf16_words_to_f32(arr) if is_bf16_words(arr) else arr).astype(want)
    policy = getattr(model, "precision", None)
    if policy is not None:
        arr = policy.wire_cast(name, arr)
    return arr


def _wire_dtypes(spec: ModelSpec) -> dict:
    """Output name -> the numpy dtype of its wire contract."""
    out = {}
    for t in spec.outputs:
        try:
            out[t.name] = t.np_dtype()
        except ValueError:
            pass
    return out


class StagedRequest:
    """A request whose inputs are on the device, awaiting launch: made by
    ``StagedChannel.stage`` and consumed once by ``StagedChannel.launch``.
    ``meta`` carries the subclass's placement state (the staging slot, or
    a packed request's layout)."""

    __slots__ = ("model", "device_inputs", "request", "meta")

    def __init__(self, model, device_inputs, request, meta=None) -> None:
        self.model = model
        self.device_inputs = device_inputs
        self.request = request
        self.meta = meta


class _Inflight:
    """One launched, not yet retired request (a staging slot's occupant).
    ``event`` is recorded behind the launch on the card (None on the CPU,
    where the launch has finished when it returns)."""

    __slots__ = ("event", "retired")

    def __init__(self, event) -> None:
        self.event = event
        self.retired = False

    def wait_device(self) -> None:
        # execution complete, not readback: the outputs stay on the device
        if self.event is not None:
            self.event.synchronize()


class StagedChannel(BaseChannel):
    """Stage / launch / resolve over one device. Subclasses implement the
    placement policy:

    - :meth:`_place_inputs`: the request's host arrays -> device tensors
      (plus ``meta`` carried to the launch and the readback);
    - :meth:`_make_launcher`: the cached launcher over a model's
      ``device_fn``;
    - :meth:`_consumed`: what the launch frees of the placement.
    """

    def __init__(
        self,
        repository: ModelRepository,
        device: torch.device,
        pipeline_depth: int = 2,
        shed_expired: bool = False,
        breaker_threshold: int = 5,
        breaker_reset_s: float = 10.0,
    ) -> None:
        """``pipeline_depth``: launched but unretired requests allowed
        before ``stage`` blocks on the oldest one's execution; 1 is the
        serial path. ``shed_expired``: a request whose deadline has passed at launch
        fails with ``DeadlineExpiredError`` instead of running.
        ``breaker_threshold`` consecutive launch or readback failures open
        a model's circuit for ``breaker_reset_s`` (0 disables the
        breaker)."""
        self._repository = repository
        self.device = device
        self._pipeline_depth = max(1, int(pipeline_depth))
        self._slot_cv = threading.Condition()
        self._inflight: collections.deque[_Inflight] = collections.deque()
        self._slots_active = 0
        self._slot_occupancy: collections.Counter = collections.Counter()
        self._stats = {
            "staged": 0,
            "launched": 0,
            "donated_launches": 0,
            "stage_slot_waits": 0,
            # launches whose deadline had already passed at enqueue time
            "deadline_expired_launches": 0,
            # launch/readback failures seen by the circuit breaker
            "launch_failures": 0,
        }
        self._shed_expired = bool(shed_expired)
        self._breaker = (
            CircuitBreaker(threshold=breaker_threshold, reset_s=breaker_reset_s)
            if breaker_threshold > 0
            else None
        )
        # per "model|priority|stage" shed counts
        self._shed: collections.Counter = collections.Counter()
        # (name, version) -> (model identity, launcher, donate names, wire dtypes)
        self._launch_cache: dict = {}
        self._device_time = None  # obs/device_time.DeviceTimeLedger
        self._cost_measured: set = set()  # model identities whose cost is recorded
        repository.add_unregister_listener(self._on_unregister)
        self.register_channel()

    # -- BaseChannel protocol -------------------------------------------------

    def register_channel(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.init()

    def fetch_channel(self) -> torch.device:
        return self.device

    def get_metadata(self, model_name: str, model_version: str = "") -> ModelSpec:
        return self._repository.metadata(model_name, model_version)

    def do_inference(self, request: InferRequest) -> InferResponse:
        return self.launch(self.stage(request)).result()

    def do_inference_async(self, request: InferRequest) -> InferFuture:
        """Returns once the work is enqueued on the device; the readback
        waits in ``result()``. Dispatch errors (validation, an unknown
        model, staging) are deferred to ``result()`` too, so async callers
        have one place where errors surface."""
        try:
            staged = self.stage(request)
        except Exception as e:
            return InferFuture.failed(e)
        return self.launch(staged)

    # -- subclass placement hooks ---------------------------------------------

    def _place_inputs(self, model, request: InferRequest):
        """Place the request's host arrays on the device; returns
        ``(device_inputs, meta)``. Runs inside the staging slot (a raised
        error releases it)."""
        raise NotImplementedError

    def _place_ragged(self, model, request: InferRequest):
        """Place a packed ragged request; returns ``(device_inputs,
        layout)`` with the segment ids under ``SEGMENT_IDS_KEY``."""
        raise NotImplementedError

    def _make_launcher(self, model):
        """``(launcher, donate_names, out_dtypes)`` for a model with a
        ``device_fn``: ``launcher(device_inputs) -> device outputs``."""
        raise NotImplementedError

    def _consumed(self, staged: StagedRequest) -> None:
        """The launch has consumed ``staged``'s inputs (or failed): free
        what the placement holds. Called once per staged request."""

    def _record_done(self):
        """An event behind the launch (None where there is nothing to wait
        on)."""
        return None

    def _begin_window(self):
        """Open a launch's device window, just before its launcher runs
        (only while a ledger is attached). Here, off the card, the launch
        has finished when the launcher returns, so the window is the
        launcher call's own wall time; ``CUDAChannel`` records a timing CUDA
        event on the launch stream instead. Returns what
        :meth:`_end_window` takes."""
        return time.perf_counter()

    def _end_window(self, start):
        """Close the window behind the launcher: ``(done event, seconds)``,
        ``seconds()`` the window's length, read once the event is done."""
        elapsed = time.perf_counter() - start
        return self._record_done(), lambda: elapsed

    def _host_outputs(self, outputs, out_dtype, meta) -> dict:
        """Device outputs -> host numpy at the wire dtypes: the designed
        readback. A packed request's dead segment slots are sliced off
        first."""
        if isinstance(meta, RaggedLayout):
            outputs = {
                k: v[: meta.n_segments]
                if getattr(v, "ndim", 0) >= 1 and v.shape[0] == meta.seg_bucket
                else v
                for k, v in outputs.items()
            }
        host = {}
        for k, v in outputs.items():
            arr = host_array(v) if isinstance(v, torch.Tensor) else np.asarray(v)
            dt = out_dtype.get(k) if out_dtype else None
            host[k] = arr.astype(dt, copy=False) if dt is not None else arr
        return host

    # -- pipeline knobs -------------------------------------------------------

    @property
    def pipeline_depth(self) -> int:
        return self._pipeline_depth

    @pipeline_depth.setter
    def pipeline_depth(self, depth: int) -> None:
        with self._slot_cv:
            self._pipeline_depth = max(1, int(depth))
            self._slot_cv.notify_all()

    @property
    def batch_multiple(self) -> int:
        """Preferred divisor of device batch sizes: 1 on one device (the
        batcher sizes merge groups and pad buckets off it)."""
        return 1

    @property
    def breaker(self):
        """The per-model circuit breaker (None when disabled)."""
        return self._breaker

    def stats(self) -> dict:
        """Staging-slot counters: ``slot_occupancy`` maps in-flight
        requests at launch -> launches seen at that depth."""
        with self._slot_cv:
            out = dict(self._stats)
            out["slot_occupancy"] = dict(sorted(self._slot_occupancy.items()))
            out["inflight"] = len(self._inflight)
            out["slots_active"] = self._slots_active
            out["pipeline_depth"] = self._pipeline_depth
            out["shed"] = dict(self._shed)
        if self._breaker is not None:
            out["breaker"] = self._breaker.states()
        return out

    # -- stage ----------------------------------------------------------------

    def stage(self, request: InferRequest) -> StagedRequest:
        """Validate the request and place its arrays on the device. Blocks
        while ``pipeline_depth`` launched requests are still executing.
        Must be paired with ``launch``."""
        tr = request.trace
        t_s0 = time.perf_counter() if tr is not None else 0.0
        model = self._repository.get(request.model_name, request.model_version)
        ragged = request.ragged is not None
        if not ragged:
            # packed requests carry packed shapes the per-tensor spec cannot
            # describe; the continuous batcher checked each member
            for tensor_spec in model.spec.inputs:
                if tensor_spec.name not in request.inputs:
                    raise ValueError(
                        f"model '{model.spec.name}' requires input '{tensor_spec.name}'; "
                        f"request has {sorted(request.inputs)}"
                    )
                tensor_spec.validate(np.asarray(request.inputs[tensor_spec.name]))
        if tr is not None:
            t_w0 = time.perf_counter()
            self._acquire_slot()
            tr.add("slot_wait", t_w0, time.perf_counter())
        else:
            self._acquire_slot()
        try:
            if ragged:
                device_inputs, meta = self._place_ragged(model, request)
            else:
                device_inputs, meta = self._place_inputs(model, request)
        except Exception:
            self._release_slot()
            raise
        with self._slot_cv:
            self._stats["staged"] += 1
        if tr is not None:
            tr.add("stage", t_s0, time.perf_counter())
        return StagedRequest(model, device_inputs, request, meta)

    def _acquire_slot(self) -> None:
        waited = False
        while True:
            rec = None
            with self._slot_cv:
                if self._slots_active < self._pipeline_depth:
                    self._slots_active += 1
                    if waited:
                        self._stats["stage_slot_waits"] += 1
                    return
                waited = True
                if self._inflight:
                    rec = self._inflight.popleft()
                else:
                    # every slot is held between stage and launch; the timed
                    # wait covers a missed notify
                    self._slot_cv.wait(timeout=0.05)
                    continue
            # wait for execution outside the lock (the readback stays lazy;
            # a concurrent resolve of the same record is fine: _retire is
            # idempotent)
            rec.wait_device()
            self._retire(rec)

    def _release_slot(self) -> None:
        with self._slot_cv:
            self._slots_active -= 1
            self._slot_cv.notify_all()

    def _retire(self, rec: _Inflight) -> None:
        with self._slot_cv:
            if rec.retired:
                return
            rec.retired = True
            try:
                self._inflight.remove(rec)
            except ValueError:
                pass  # already popped by a staging thread
            self._slots_active -= 1
            self._slot_cv.notify_all()

    # -- launch ---------------------------------------------------------------

    def launch(self, staged: StagedRequest) -> InferFuture:
        """Enqueue the model for a staged request; returns a lazy
        InferFuture over device outputs. The staging slot frees when the
        request has executed (whichever of a later ``stage`` or this
        future's resolution sees it first)."""
        model, request = staged.model, staged.request
        name = model.spec.name
        tr = request.trace
        t0 = time.perf_counter()
        deadline = request.deadline_s
        if self._shed_expired and deadline is not None and t0 > deadline:
            self._abandon(staged)
            self._count_shed(name, request.priority, "launch")
            return InferFuture.failed(
                DeadlineExpiredError(
                    f"model '{name}': deadline expired {(t0 - deadline) * 1e3:.1f}ms before launch"
                )
            )
        if self._breaker is not None and not self._breaker.allow(name, t0):
            self._abandon(staged)
            self._count_shed(name, request.priority, "breaker")
            return InferFuture.failed(
                CircuitOpenError(
                    f"model '{name}': circuit breaker open (recent consecutive launch failures)"
                )
            )
        donate_names = frozenset()
        ledger = self._device_time
        device_seconds = None
        try:
            from torch.profiler import record_function

            faults.probe("slow_launch", name)
            faults.probe("launch", name)
            if request.ragged is not None:
                launcher, out_dtype = self._ragged_launcher(
                    model, request.ragged.launch_segments)
                call = functools.partial(launcher, staged.device_inputs)
                if ledger is not None:
                    self._ensure_launch_cost(model, staged.device_inputs, request.ragged)
            else:
                launcher, donate_names, out_dtype = self._launcher(model)
                call = functools.partial(launcher or model.infer_fn, staged.device_inputs)
                if ledger is not None:
                    self._ensure_launch_cost(model, staged.device_inputs)
            window = self._begin_window() if ledger is not None else None
            with record_function(launcher_name(model)):
                outputs = call()
            if window is None:
                event = self._record_done()
            else:
                event, device_seconds = self._end_window(window)
        except Exception as e:
            # the error goes to THIS request's future only; the slot frees
            # and the channel stays serviceable (the breaker decides whether
            # the model needs a timeout)
            self._abandon(staged)
            self._record_launch_failure(name)
            return InferFuture.failed(e)
        self._consumed(staged)
        rec = _Inflight(event)
        t_launched = time.perf_counter()
        if tr is not None:
            tr.add("launch", t0, t_launched)
        with self._slot_cv:
            self._inflight.append(rec)
            self._stats["launched"] += 1
            if donate_names:
                self._stats["donated_launches"] += 1
            if deadline is not None and t_launched > deadline:
                self._stats["deadline_expired_launches"] += 1
            self._slot_occupancy[len(self._inflight)] += 1

        def resolve() -> InferResponse:
            try:
                # device window: enqueue -> execution complete, then the copy
                rec.wait_device()
                t_ready = time.perf_counter()
                if tr is not None:
                    tr.add("device_execute", t_launched, t_ready)
                if device_seconds is not None:
                    ledger.record(name, device_seconds(), model.spec.extra)
                faults.probe("readback", name)
                host = self._host_outputs(outputs, out_dtype, staged.meta)
                if tr is not None:
                    tr.add("readback", t_ready, time.perf_counter())
            except Exception:
                self._record_launch_failure(name)
                raise
            finally:
                self._retire(rec)
            if self._breaker is not None:
                self._breaker.record_success(name)
            return InferResponse(
                model_name=request.model_name,
                model_version=model.spec.version,
                outputs=host,
                request_id=request.request_id,
                latency_s=time.perf_counter() - t0,
            )

        return InferFuture(resolve)

    def _abandon(self, staged: StagedRequest) -> None:
        """A staged request that will not launch: free its placement and
        its slot."""
        self._consumed(staged)
        self._release_slot()

    def _ragged_launcher(self, model, num_segments: int):
        """(launcher, wire dtypes) of a model's packed route at one segment
        bucket, cached per model identity and bucket as JAX caches its
        ``_ragged_launcher``: ``launcher(device_inputs)`` takes the packed
        inputs with the segment ids under ``SEGMENT_IDS_KEY``."""
        if model.ragged_fn is None:
            raise ValueError(f"model '{model.spec.name}' has no ragged_fn for a packed request")
        key = (model.spec.name, model.spec.version, "ragged", int(num_segments))
        with self._slot_cv:
            cached = self._launch_cache.get(key)
            if cached is not None and cached[0] is model:
                return cached[1], cached[3]
        launcher = self._make_ragged_launcher(model, int(num_segments))
        out_dtype = _wire_dtypes(model.spec)
        with self._slot_cv:
            self._launch_cache[key] = (model, launcher, frozenset(), out_dtype)
        return launcher, out_dtype

    def _make_ragged_launcher(self, model, num_segments: int):
        """``launcher(device_inputs) -> device outputs`` over the model's
        ``ragged_fn`` at ``num_segments``."""
        raise NotImplementedError

    def _launcher(self, model):
        """(launcher | None, donate names, wire dtypes), cached per model
        identity. Models without a ``device_fn`` keep the ``infer_fn``
        call."""
        if model.device_fn is None:
            return None, frozenset(), _wire_dtypes(model.spec)
        key = (model.spec.name, model.spec.version)
        with self._slot_cv:
            cached = self._launch_cache.get(key)
            if cached is not None and cached[0] is model:
                return cached[1], cached[2], cached[3]
        launcher, donate_names, out_dtype = self._make_launcher(model)
        with self._slot_cv:
            self._launch_cache[key] = (model, launcher, donate_names, out_dtype)
        return launcher, donate_names, out_dtype

    def _ensure_launch_cost(self, model, device_inputs: dict, ragged=None) -> None:
        """Record the model's measured flops/bytes into ``spec.extra``
        (``obs/roofline.record_launch_cost``) once per model identity, at
        its first launch with a ledger attached, from one eager run of its
        body on this launch's inputs: ``device_fn``, else the
        ``member_device_fn`` a disk entry offers, else (a host-side
        ``infer_fn`` alone) nothing; a packed launch runs ``ragged_fn`` at
        its segment bucket. JAX counts at the same point from XLA's cost
        model, a trace it pays anyway; the port's count costs an eager run
        and its kernels' launches, so it runs only when a ledger reads it.
        Never under a graph capture, and never fails the launch."""
        key = (model.spec.name, model.spec.version)
        with self._slot_cv:
            if key in self._cost_measured:
                return
        if self.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            return
        if ragged is not None:
            if model.ragged_fn is None:
                return
            inputs = {k: v for k, v in device_inputs.items() if k != SEGMENT_IDS_KEY}
            body = functools.partial(model.ragged_fn, inputs, device_inputs[SEGMENT_IDS_KEY],
                                     ragged.launch_segments)
            rows = ragged.n_segments
        else:
            fn = model.device_fn or model.member_device_fn
            if fn is None:
                return
            body = functools.partial(fn, device_inputs)
            rows = _batch_rows(device_inputs)
        with self._slot_cv:
            if key in self._cost_measured:
                return
            self._cost_measured.add(key)
        try:
            record_launch_cost(model, body, batch_rows=rows)
        except Exception:  # the roofline is observability, not serving
            log.debug("launch-cost measurement failed for %s:%s", *key, exc_info=True)

    # -- device-time attribution (obs/device_time.py) ---------------------------

    def attach_device_time(self, ledger) -> None:
        """Attach a ``DeviceTimeLedger`` (None detaches): every later launch
        records its device window into it from the resolve path."""
        self._device_time = ledger

    @property
    def device_time(self):
        return self._device_time

    # -- hooks of layers not ported -------------------------------------------

    def attach_lifecycle(self, manager) -> None:
        raise NotImplementedError(_NOT_PORTED.format("model lifecycle"))

    def attach_sessions(self, manager) -> None:
        raise NotImplementedError(_NOT_PORTED.format("streaming sessions"))

    # -- failure isolation ----------------------------------------------------

    def _on_unregister(self, name: str, version: str) -> None:
        # an unregistered model must not keep serving from, or holding
        # device memory through, a stale cached launcher
        with self._slot_cv:
            for key in [k for k in self._launch_cache if k[0] == name and k[1] == version]:
                del self._launch_cache[key]

    def _count_shed(self, model: str, priority: int, stage: str) -> None:
        with self._slot_cv:
            self._shed[f"{model}|{int(priority)}|{stage}"] += 1

    def _record_launch_failure(self, model: str) -> None:
        """One launch/readback failure: feed the breaker; when this failure
        OPENS the circuit, drop the model's cached launchers so the
        half-open probe rebuilds them from the repository's model."""
        with self._slot_cv:
            self._stats["launch_failures"] += 1
        if self._breaker is None:
            return
        if self._breaker.record_failure(model):
            with self._slot_cv:
                for key in [k for k in self._launch_cache if k[0] == model]:
                    del self._launch_cache[key]
