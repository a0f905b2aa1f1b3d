"""The ragged pool model: the segment-aware body the continuous batcher
packs (the port of the pool model of ``tests/test_continuous_batching.py``,
the only ragged body of the JAX package).

Per cloud: ``pooled = sum over points of tanh(points @ W) + bias``, with
points (n, 4) (KITTI's x, y, z, intensity), bias (1, 4) and W the fixed
(4, 4) matrix ``POOL_W``. ``ragged_fn`` takes the packed rows of several
clouds and reduces them per cloud through ``segment_reduce`` (kernel 6 on
the card); ``infer_fn`` serves one cloud alone, with no segment kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from triton_client_tpu_torch.config import ModelSpec, TensorSpec
from triton_client_tpu_torch.device import resolve_device, strict_fp32
from triton_client_tpu_torch.parallel.ragged_kernels import segment_reduce
from triton_client_tpu_torch.runtime.repository import ModelRepository

POOL_W = np.linspace(-1.0, 1.0, 16, dtype=np.float32).reshape(4, 4)


def pool_spec(name: str = "pool") -> ModelSpec:
    return ModelSpec(
        name=name,
        version="1",
        inputs=(TensorSpec("points", (-1, 4), "FP32"), TensorSpec("bias", (1, 4), "FP32")),
        outputs=(TensorSpec("pooled", (4,), "FP32"),),
        extra={"ragged_inputs": ["points"]},
    )


class PoolModel:
    """The pool model's two entry points on one device."""

    def __init__(self, device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        strict_fp32()  # the projection is a float32 matrix product
        self.w = torch.from_numpy(POOL_W).to(self.device)

    def ragged_fn(self, inputs, segment_ids: torch.Tensor, num_segments: int) -> dict:
        """Packed points (R, 4), bias stacked (num_segments, 1, 4) ->
        pooled (num_segments, 4)."""
        feat = torch.tanh(inputs["points"] @ self.w)
        pooled = segment_reduce(feat, segment_ids, num_segments, "sum")
        return {"pooled": pooled + inputs["bias"].squeeze(1)}

    def infer_fn(self, inputs) -> dict:
        """One cloud: points (n, 4), bias (1, 4) -> pooled (4,)."""
        pooled = torch.tanh(inputs["points"] @ self.w).sum(0)
        return {"pooled": pooled + inputs["bias"][0]}


def register_pool(
    repo: ModelRepository, device: str | torch.device | None = None, name: str = "pool"
) -> PoolModel:
    """Build the pool model on ``device`` (cuda unless asked) and register
    both of its entry points under ``name``."""
    model = PoolModel(device)
    repo.register(pool_spec(name), model.infer_fn, ragged_fn=model.ragged_fn)
    return model
