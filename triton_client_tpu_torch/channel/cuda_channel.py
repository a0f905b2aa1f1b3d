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
wire contract on the host. This slice has no batcher, mesh, buffer
donation or admission control.
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

    def _stage(self, spec: ModelSpec, request: InferRequest) -> dict[str, torch.Tensor]:
        for t in spec.inputs:
            if t.name not in request.inputs:
                raise KeyError(f"model '{spec.name}' needs input '{t.name}'")
            t.validate(np.asarray(request.inputs[t.name]))
        staged = {}
        for name, arr in request.inputs.items():
            # np.require, not np.ascontiguousarray: that one turns a 0-d
            # array (num_points) into shape (1,)
            arr = np.require(cast_wire_input(spec, name, np.asarray(arr)), requirements="C")
            host = torch.from_numpy(arr)
            if self.device.type == "cuda":
                host = host.pin_memory()
            staged[name] = host.to(self.device, non_blocking=True)
        return staged

    def _launch(self, request: InferRequest):
        """Stage and enqueue; returns the readback closure."""
        model = self._repository.get(request.model_name, request.model_version)
        t0 = time.perf_counter()
        outputs = model.infer_fn(self._stage(model.spec, request))

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
