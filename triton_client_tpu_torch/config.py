"""Model specs: the served tensor contract of each model.

The port's copy of ``triton_client_tpu.config``, cut to what the
serving path reads: the specs, the dtype table and the wire sizes. The port imports nothing of the JAX
package, so this module stands alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

# KServe v2 dtype strings -> numpy. BF16 has no numpy dtype (the JAX
# package takes it from ml_dtypes) and is refused by TensorSpec.np_dtype:
# the port does not serve bf16 yet.
_DTYPES = {
    "FP64": np.float64,
    "FP32": np.float32,
    "FP16": np.float16,
    "BF16": None,
    "INT64": np.int64,
    "INT32": np.int32,
    "INT16": np.int16,
    "INT8": np.int8,
    "UINT64": np.uint64,
    "UINT32": np.uint32,
    "UINT16": np.uint16,
    "UINT8": np.uint8,
    "BOOL": np.bool_,
}

# Wire width in bytes per dtype string (BF16 travels as 16-bit words).
_ITEMSIZE = {k: (2 if v is None else np.dtype(v).itemsize) for k, v in _DTYPES.items()}

# Headroom for protobuf framing and tensor name/shape metadata on top of
# the raw payloads when sizing gRPC message caps from ``wire_bytes()``.
FRAMING_BYTES = 1 << 20


def config_dtypes() -> dict:
    """The KServe dtype table (BF16 maps to None: the port has no bf16
    numpy dtype and its codec refuses BF16 tensors)."""
    return dict(_DTYPES)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """One input/output tensor contract; -1 dims are dynamic."""

    name: str
    shape: tuple[int, ...]
    dtype: str = "FP32"
    layout: str = ""  # e.g. "NHWC" for image inputs
    # Input-only: the serving channel may hand this tensor's staged device
    # buffer back to its staging slot as soon as the launch has consumed it
    # (channel/cuda_channel.py), so consecutive requests reuse it. Only
    # safe when nothing re-reads the staged buffer after the launch; the
    # request's host arrays are never reused.
    donatable: bool = False

    def np_dtype(self) -> np.dtype:
        if _DTYPES.get(self.dtype) is None:
            raise ValueError(f"no numpy dtype for {self.dtype}")
        return np.dtype(_DTYPES[self.dtype])

    def validate(self, arr: np.ndarray) -> None:
        if len(arr.shape) != len(self.shape):
            raise ValueError(
                f"tensor '{self.name}': rank {len(arr.shape)} != spec rank {len(self.shape)}"
            )
        for got, want in zip(arr.shape, self.shape):
            if want != -1 and got != want:
                raise ValueError(
                    f"tensor '{self.name}': shape {arr.shape} incompatible with spec {self.shape}"
                )


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A model's full serving contract (name, version, tensors, limits)."""

    name: str
    version: str = "1"
    platform: str = "torch"
    inputs: tuple[TensorSpec, ...] = ()
    outputs: tuple[TensorSpec, ...] = ()
    max_batch_size: int = 1
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    def input_by_name(self, name: str) -> TensorSpec:
        for t in self.inputs:
            if t.name == name:
                return t
        raise KeyError(f"model '{self.name}' has no input '{name}'")

    def donatable_inputs(self) -> tuple[str, ...]:
        """Input names whose staged device buffers the serving channel may
        reuse once the launch has consumed them (channel/cuda_channel.py)."""
        return tuple(t.name for t in self.inputs if t.donatable)

    def wire_bytes(self) -> int:
        """Largest raw-tensor payload of one full-batch request and its
        response, or 0 if any dim is dynamic (callers fall back to a
        floor). Sizes the gRPC message caps (``runtime/server.message_limit``)."""
        total = 0
        for t in tuple(self.inputs) + tuple(self.outputs):
            if any(d < 0 for d in t.shape):
                return 0
            total += int(np.prod(t.shape, dtype=np.int64)) * _ITEMSIZE.get(t.dtype, 8)
        return total * max(1, self.max_batch_size)
