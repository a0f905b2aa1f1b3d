"""CUDAChannel: the in-process dispatch channel (port of
``channel/tpu_channel.py`` and the in-process part of
``channel/staged.py``).

``do_inference`` is a function call: inputs are copied host -> device
from pinned memory, the registered model runs on the card, and outputs
come back as numpy only at the boundary. ``do_inference_async`` returns
as soon as the work is enqueued on the device; the readback waits in
``result()``.

Dtype policy, as in the JAX channel: a narrower input (uint8 camera
frames against an FP32 spec) uploads as it is and widens on the device,
a quarter of the bytes; a stray wider one (float64) casts down to the
wire contract on the host.

Packed ragged requests (``request.ragged`` set by the continuous batcher,
the port of ``channel/staged.py``'s ragged route): the packed inputs and
the layout's (R,) int32 segment ids upload, the model's ``ragged_fn``
runs at the layout's ``launch_segments``, and the dead segment slots are
sliced off the outputs whose leading dim is the segment bucket. Their
inputs skip the per-tensor spec check: packed rows and per-segment
stacks have other shapes than one request (the batcher checked nothing
either; each member was a request of its own). PyTorch runs eagerly, so
there is nothing to cache. The staged slots, buffer donation and the
mesh are not ported yet.
"""

from __future__ import annotations

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
from triton_client_tpu_torch.device import resolve_device
from triton_client_tpu_torch.runtime.repository import ModelRepository

# the key under which a packed request's segment ids ride with its inputs
SEGMENT_IDS_KEY = "__segment_ids__"


def cast_wire_input(spec: ModelSpec, name: str, arr: np.ndarray) -> np.ndarray:
    """Never widen on the host; cast a stray wider dtype down to the spec's."""
    try:
        want = spec.input_by_name(name).np_dtype()
    except (KeyError, ValueError):
        return arr  # undeclared or BF16 inputs pass through as they are
    if arr.dtype != want and want.itemsize <= arr.dtype.itemsize:
        arr = arr.astype(want)
    return arr


class CUDAChannel(BaseChannel):
    """Single-device in-process serving channel (see module docstring)."""

    def __init__(
        self, repository: ModelRepository, device: str | torch.device | None = None
    ) -> None:
        self._repository = repository
        self.device = resolve_device(device)

    def register_channel(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.init()

    def fetch_channel(self) -> torch.device:
        return self.device

    def get_metadata(self, model_name: str, model_version: str = "") -> ModelSpec:
        return self._repository.metadata(model_name, model_version)

    @property
    def batch_multiple(self) -> int:
        """Preferred divisor of device batch sizes: 1 on one card (the
        batcher sizes merge groups and pad buckets off it)."""
        return 1

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(arr)
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def _stage(self, spec: ModelSpec, request: InferRequest) -> dict[str, torch.Tensor]:
        for t in spec.inputs:
            if t.name not in request.inputs:
                raise KeyError(f"model '{spec.name}' needs input '{t.name}'")
            if request.ragged is None:
                t.validate(np.asarray(request.inputs[t.name]))
        staged = {}
        for name, arr in request.inputs.items():
            # np.require, not np.ascontiguousarray: that one turns a 0-d
            # array (num_points) into shape (1,)
            arr = np.require(cast_wire_input(spec, name, np.asarray(arr)), requirements="C")
            staged[name] = self._upload(arr)
        return staged

    def _place_ragged(self, spec: ModelSpec, request: InferRequest) -> dict[str, torch.Tensor]:
        """A packed request's inputs on the device, with the layout's
        segment ids under ``SEGMENT_IDS_KEY``."""
        if SEGMENT_IDS_KEY in request.inputs:
            raise ValueError(f"input name {SEGMENT_IDS_KEY!r} is reserved")
        staged = self._stage(spec, request)
        staged[SEGMENT_IDS_KEY] = self._upload(
            np.ascontiguousarray(request.ragged.segment_ids, dtype=np.int32)
        )
        return staged

    def _launch(self, request: InferRequest):
        """Stage and enqueue; returns the readback closure."""
        model = self._repository.get(request.model_name, request.model_version)
        t0 = time.perf_counter()
        layout = request.ragged
        if layout is None:
            outputs = model.infer_fn(self._stage(model.spec, request))
        else:
            if model.ragged_fn is None:
                raise ValueError(f"model '{model.spec.name}' has no ragged_fn for a packed request")
            inputs = self._place_ragged(model.spec, request)
            ids = inputs.pop(SEGMENT_IDS_KEY)
            outputs = model.ragged_fn(inputs, ids, layout.launch_segments)
            # drop the dead segment slots before the readback
            outputs = {
                k: v[: layout.n_segments]
                if getattr(v, "ndim", 0) >= 1 and v.shape[0] == layout.seg_bucket else v
                for k, v in outputs.items()
            }

        def resolve() -> InferResponse:
            host = {
                k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in outputs.items()
            }
            return InferResponse(
                model_name=model.spec.name,
                outputs=host,
                model_version=model.spec.version,
                request_id=request.request_id,
                latency_s=time.perf_counter() - t0,
            )

        return resolve

    def do_inference(self, request: InferRequest) -> InferResponse:
        return self._launch(request)()

    def do_inference_async(self, request: InferRequest) -> InferFuture:
        """Errors at dispatch are deferred to ``result()``, so async
        callers have one place where errors surface."""
        try:
            return InferFuture(self._launch(request))
        except Exception as e:
            return InferFuture.failed(e)
