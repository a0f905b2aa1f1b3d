"""Standalone image-preprocess model, the classic first ensemble step (port
of ``pipelines/preprocess2d.py``).

A Triton deployment often fronts a detector with a preprocess model
chained through an ensemble: resize and dtype on the server, so clients
ship raw camera bytes. The reference does this work on the client instead
(``utils/preprocess.py`` ``image_adjust``). This family moves it to the
server as a repository entry, and is the image-sized producer of a fused
ensemble (``runtime/ensemble.py``): chained on the host, a full float frame
crosses host memory each way a step; fused, it stays on the card.

Repository entry::

    <root>/preprocess/config.yaml
        family: preprocess
        model: {input_hw: [512, 512]}   # the OUTPUT resolution

No weights: the entry registers without version dirs. Contract: ``images``
(B, H, W, 3) uint8/float RGB in, ``preprocessed`` (B, out_h, out_w, 3)
float32 out, at raw pixel scale (the detectors normalise, so a chain never
normalises twice).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from triton_client_tpu_torch.config import ModelSpec, TensorSpec
from triton_client_tpu_torch.device import resolve_device
from triton_client_tpu_torch.ops.preprocess import resize_bilinear
from triton_client_tpu_torch.runtime.graphs import CapturedFunction


@dataclasses.dataclass(frozen=True)
class Preprocess2DConfig:
    model_name: str = "preprocess"
    # named input_hw, not out_hw, so the disk repository's 2D plumbing
    # (model.input_hw, the warmup shape) applies as it stands; it is the
    # OUTPUT resolution
    input_hw: tuple[int, int] = (512, 512)
    class_names: tuple[str, ...] = ()


class Preprocess2DPipeline:
    """Resize-to-target as a servable model (no parameters). ``run`` is the
    eager body; ``infer`` and ``infer_fn`` go through ``_jit``, the body
    captured as a CUDA graph per input shape and dtype (``runtime/graphs``);
    ``device_fn`` is the body over a dict of device tensors."""

    def __init__(self, config: Preprocess2DConfig, device: str | torch.device | None = None):
        self.config = config
        self.device = resolve_device(device)
        self._jit = CapturedFunction(self.run, config.model_name)

    @torch.no_grad()
    def run(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8/float frames -> (B, h, w, 3) float32, NHWC and
        contiguous, as a frame read back from the host would be: the next
        step then sees the same layout whichever path fed it."""
        x = frames.to(torch.float32)
        if (x.shape[1], x.shape[2]) != tuple(self.config.input_hw):
            return resize_bilinear(x, self.config.input_hw).contiguous()
        return x.clone() if x is frames else x

    def infer(self, frames) -> np.ndarray:
        frames = torch.as_tensor(frames)
        if frames.ndim == 3:
            frames = frames[None]
        return self._jit(frames.to(self.device)).cpu().numpy()

    def infer_fn(self) -> Callable:
        """Repository-facing adapter through the captured body; the output
        stays on the device for the channel to read back."""

        def fn(inputs):
            return {"preprocessed": self._jit(inputs["images"])}

        fn.graph_stats = self.graph_stats
        fn.release_graphs = self._jit.release  # the lifecycle's page-out
        return fn

    def device_fn(self) -> Callable:
        def fn(inputs):
            return {"preprocessed": self.run(inputs["images"])}

        return fn

    def warmup(self, frame_hw: tuple[int, int], batch_sizes=(1,), dtype=torch.float32) -> None:
        """Capture the graph of every batch size at one frame size."""
        for b in batch_sizes:
            self._jit(torch.zeros((b, *frame_hw, 3), dtype=dtype, device=self.device))

    def graph_stats(self) -> dict:
        return self._jit.stats()


def build_preprocess_pipeline(
    rng=None,
    variables=None,
    config: Preprocess2DConfig | None = None,
    input_hw: tuple[int, int] = (512, 512),
    device: str | torch.device | None = None,
    state_dict=None,
):
    """Builder with the ``BUILDERS_2D`` signature. ``rng``, ``variables``
    and ``state_dict`` are taken and ignored (no parameters), so the disk
    repository's flow applies as it stands. Runs on ``cuda`` unless
    ``device="cpu"``."""
    cfg = config or Preprocess2DConfig(input_hw=tuple(input_hw))
    pipeline = Preprocess2DPipeline(cfg, device=device)
    spec = ModelSpec(
        name=cfg.model_name,
        version="1",
        platform="torch",
        inputs=(TensorSpec("images", (-1, -1, -1, 3), "FP32", "NHWC"),),
        outputs=(
            TensorSpec("preprocessed", (-1, cfg.input_hw[0], cfg.input_hw[1], 3), "FP32", "NHWC"),
        ),
        max_batch_size=8,
        extra={"out_hw": list(cfg.input_hw)},
    )
    return pipeline, spec, {}
