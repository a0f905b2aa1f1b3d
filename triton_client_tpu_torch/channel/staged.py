"""Staged dispatch: the stage / launch / resolve engine (port of
``channel/staged.py``, without the device mesh).

- **stage**: validate, take a staging slot, then hand the request to
  :meth:`StagedChannel._place_inputs` (the subclass's placement policy).
  At ``pipeline_depth`` (default 2) request N+1's host-to-device copy
  runs while request N executes; ``pipeline_depth=1`` is the serial path.
- **launch**: enqueue the model through the launcher the subclass builds
  in :meth:`StagedChannel._make_launcher`, cached per model identity
  (``_launcher``) and dropped when the model is unregistered or its
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

The JAX engine's lifecycle, device-time and sessions hooks are not
ported: ``attach_lifecycle``, ``attach_device_time`` and
``attach_sessions`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import collections
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
from triton_client_tpu_torch.parallel.ragged_kernels import RaggedLayout
from triton_client_tpu_torch.runtime import faults
from triton_client_tpu_torch.runtime.admission import (
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExpiredError,
)
from triton_client_tpu_torch.runtime.repository import ModelRepository

# the key under which a packed request's segment ids ride with its inputs
SEGMENT_IDS_KEY = "__segment_ids__"

_NOT_PORTED = (
    "the {} hook of the staged channel is not ported yet "
    "(ROADMAP.md Queue 1, 'Serving breadth')"
)


def cast_wire_input(spec: ModelSpec, name: str, arr: np.ndarray) -> np.ndarray:
    """Never widen on the host; cast a stray wider dtype down to the spec's.
    A narrower input (uint8 camera frames against an FP32 spec) uploads as
    it is, a quarter of the bytes, and the pipeline widens it on the
    device; a float64 or int64 one casts down to the wire contract."""
    try:
        want = spec.input_by_name(name).np_dtype()
    except (KeyError, ValueError):
        return arr  # undeclared or BF16 inputs pass through as they are
    if arr.dtype != want and want.itemsize <= arr.dtype.itemsize:
        arr = arr.astype(want)
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
            arr = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
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
        try:
            faults.probe("slow_launch", name)
            faults.probe("launch", name)
            if request.ragged is not None:
                # the packed route runs eagerly: kernel 6's ticket buffer is
                # keyed by stream, which a capture's private pool would hold
                if model.ragged_fn is None:
                    raise ValueError(f"model '{name}' has no ragged_fn for a packed request")
                inputs = dict(staged.device_inputs)
                ids = inputs.pop(SEGMENT_IDS_KEY)
                outputs = model.ragged_fn(inputs, ids, request.ragged.launch_segments)
                out_dtype = _wire_dtypes(model.spec)
            else:
                launcher, donate_names, out_dtype = self._launcher(model)
                if launcher is not None:
                    outputs = launcher(staged.device_inputs)
                else:
                    outputs = model.infer_fn(staged.device_inputs)
            event = self._record_done()
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

    # -- hooks of layers not ported -------------------------------------------

    def attach_lifecycle(self, manager) -> None:
        raise NotImplementedError(_NOT_PORTED.format("model lifecycle"))

    def attach_device_time(self, ledger) -> None:
        raise NotImplementedError(_NOT_PORTED.format("device-time ledger"))

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
