"""2D detection pipeline: raw frame(s) in, packed detections out (port
of ``pipelines/detect2d.py``).

cast to the precision policy's compute dtype -> bilinear resize to the
model input -> normalize -> YOLOv5 forward (float32 heads) -> decode ->
float32 (the policy's ``boundary``) -> confidence gate + top-k
-> class-aware NMS (the fused CUDA tail, or the unfused op chain) ->
rescale to original pixels. Output per image: (max_det, 6) rows [x1, y1, x2, y2, conf,
class] plus a validity mask.

``run`` is the eager body. ``infer`` and ``infer_fn`` go through
``_jit``, the body captured as a CUDA graph per input shape and dtype
(``runtime/graphs``, the counterpart of the JAX pipeline's ``jax.jit``):
each camera resolution and batch size is one graph, as it is one trace
in JAX. ``device_fn`` is the body over a dict of device tensors, for a
channel that captures it itself.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from triton_client_tpu_torch.config import ModelSpec, TensorSpec
from triton_client_tpu_torch.device import resolve_device, strict_fp32
from triton_client_tpu_torch.models.convert import fill_model, yolov5_state_dict_from_flax
from triton_client_tpu_torch.models.yolov5 import YoloV5, num_predictions
from triton_client_tpu_torch.ops.boxes import scale_boxes
from triton_client_tpu_torch.ops.detect_postprocess import extract_boxes
from triton_client_tpu_torch.ops.fused import resolve_fused_stages
from triton_client_tpu_torch.ops.nms import route_setting
from triton_client_tpu_torch.ops.preprocess import normalize_image, resize_bilinear
from triton_client_tpu_torch.runtime.graphs import CapturedFunction
from triton_client_tpu_torch.runtime.precision import (
    KEEP_F32_2D,
    PrecisionPolicy,
    apply_cast_params,
    parse_compute_dtype,
    resolve_policy,
    stored_params,
)


@dataclasses.dataclass(frozen=True)
class Detect2DConfig:
    """Pipeline hyperparameters."""

    model_name: str = "yolov5"
    input_hw: tuple[int, int] = (512, 512)
    num_classes: int = 80
    conf_thresh: float = 0.3
    iou_thresh: float = 0.45
    max_det: int = 300
    max_nms: int = 1024
    scaling: str = "yolo"
    multi_label: bool = False
    class_names: tuple[str, ...] = ()
    # Fused decode+NMS routing (ops/fused): "auto" fuses on CUDA (the
    # hand-written kernel), "on" everywhere (the kernel's plain version
    # on the CPU), "off" runs the unfused tail. Published as
    # spec.extra["fused_stages"].
    fused: str = "auto"


class Detect2DPipeline:
    """Wraps a detector forward into the frame -> detections path."""

    def __init__(
        self,
        config: Detect2DConfig,
        forward: Callable[[torch.Tensor], torch.Tensor],
        device: str | torch.device | None = None,
        precision: PrecisionPolicy | str | None = None,
    ) -> None:
        """``forward``: (B, H, W, 3) float input on ``device`` ->
        (B, N, 5+nc) decoded predictions in input-pixel units.
        ``precision``: the serving policy (``runtime/precision.py``): frames
        cast to its compute dtype at ingress, the forward's output back to
        float32 before the keep-list ops (decode, NMS, rescale)."""
        self.config = config
        self.device = resolve_device(device)
        self._forward = forward
        self.precision = PrecisionPolicy.parse(precision)
        self.fused_stages = resolve_fused_stages(config.fused, ("decode_nms",), self.device)
        # the unfused tail routes its NMS on TRITON_CLIENT_TPU_NMS when it
        # runs, so its graphs are captured per setting
        unfused = "decode_nms" not in self.fused_stages
        self._jit = CapturedFunction(
            self.run, config.model_name, static_key=route_setting if unfused else None
        )

    @torch.no_grad()
    def run(self, frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) uint8/float frames on the pipeline's device ->
        ((B, max_det, 6) float32, (B, max_det) bool) on the device."""
        cfg = self.config
        # narrow wire inputs (uint8 frames, bf16 words, a calibrated int8
        # policy's int8 frames, dequantized first) reach the policy's
        # compute dtype here, on the device, inside the captured body
        frames = self.precision.ingest({"images": frames})["images"]
        x = self.precision.cast_in(frames)
        orig_hw = (x.shape[1], x.shape[2])
        if orig_hw != tuple(cfg.input_hw):
            x = resize_bilinear(x, cfg.input_hw)
        x = normalize_image(x, cfg.scaling)
        # keep-list boundary (KEEP_F32_2D): decode, NMS scores and the
        # rescale run in float32 under any policy
        pred = self.precision.boundary(self._forward(x))
        dets, valid = extract_boxes(
            pred,
            conf_thresh=cfg.conf_thresh,
            iou_thresh=cfg.iou_thresh,
            max_det=cfg.max_det,
            max_nms=cfg.max_nms,
            multi_label=cfg.multi_label,
            fused="decode_nms" in self.fused_stages,
        )
        boxes = scale_boxes(dets[..., :4], cfg.input_hw, orig_hw)
        dets = torch.cat([boxes, dets[..., 4:]], dim=-1)
        dets = torch.where(valid[..., None], dets, 0.0)
        return dets, valid

    def infer(self, frames) -> tuple[np.ndarray, np.ndarray]:
        """frames: (B, H, W, 3) or (H, W, 3) uint8/float RGB, numpy or a
        tensor. Returns ((B, max_det, 6), (B, max_det)) numpy; the batch
        dim is dropped again if it was absent."""
        frames = torch.as_tensor(frames)
        squeeze = frames.ndim == 3
        if squeeze:
            frames = frames[None]
        dets, valid = self._jit(frames.to(self.device))
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        return (dets[0], valid[0]) if squeeze else (dets, valid)

    def infer_fn(self):
        """Repository-facing dict -> dict adapter over tensors on the
        pipeline's device, through the captured body; the channel reads
        the outputs back."""

        def fn(inputs):
            dets, valid = self._jit(inputs["images"])
            return {"detections": dets, "valid": valid}

        fn.graph_stats = self.graph_stats  # the captures behind a registered model
        return fn

    def device_fn(self):
        """The eager body over a dict of device tensors, with the wire
        names (the JAX pipeline's ``device_fn``): a channel captures it
        as a graph of its own. ``orig_hw`` comes off the frames' shape."""

        def fn(inputs):
            dets, valid = self.run(inputs["images"])
            return {"detections": dets, "valid": valid}

        return fn

    def warmup(self, frame_hw: tuple[int, int], batch_sizes=(1,), dtype=torch.uint8) -> None:
        """Capture the graph of every batch size for one camera
        resolution, before traffic (``RegisteredModel.warmup``). ``dtype``
        is the staged frames' dtype: a channel stages float32 frames of a
        ``bf16`` model as bfloat16 and of a calibrated ``int8`` one as int8
        (``self.precision.wire_dtype("images")``)."""
        for b in batch_sizes:
            self._jit(torch.zeros((b, *frame_hw, 3), dtype=dtype, device=self.device))

    def graph_stats(self) -> dict:
        return self._jit.stats()


def load_class_names(path: str) -> tuple[str, ...]:
    """data/*.names loader (one class per line)."""
    with open(path) as f:
        return tuple(line.strip() for line in f if line.strip())


def build_yolov5_pipeline(
    variant: str = "n",
    num_classes: int = 80,
    input_hw: tuple[int, int] = (512, 512),
    variables=None,
    config: Detect2DConfig | None = None,
    device: str | torch.device | None = None,
    seed: int = 0,
    dtype: torch.dtype | str = torch.float32,
    s2d: bool = False,
    ch_floor: int = 0,
    precision: PrecisionPolicy | str | None = None,
    state_dict=None,
) -> tuple[Detect2DPipeline, ModelSpec, YoloV5]:
    """Model + pipeline + serving spec in one call.

    Weights (``models/convert.fill_model``): a flax variable tree from the
    JAX package (``variables``, through ``yolov5_state_dict_from_flax``),
    else ``state_dict`` (the port's names, or a function of the model that
    returns them: ``runtime/importers``), else seeded random ones
    (``seed``). ``s2d``/``ch_floor``: the layout of ``examples/yolov5_crop``
    (``models/yolov5.py``). ``dtype``: the body's compute dtype;
    ``precision``: the serving policy, which stores the tensors once, here
    (``runtime/precision.apply_cast_params``: bfloat16, or int8 weights
    quantized from the float32 ones loaded; ``resolve_policy``: ``bf16``
    switches a float32 body to bfloat16, an explicit ``dtype`` wins). Runs
    on ``cuda`` unless ``device="cpu"``, with TF32 off so float32 means
    float32 (``device.strict_fp32``)."""
    dev = resolve_device(device)
    strict_fp32()
    policy, dtype = resolve_policy(precision, parse_compute_dtype(dtype))
    model = YoloV5(num_classes=num_classes, variant=variant, s2d=s2d, ch_floor=ch_floor,
                   dtype=dtype)
    source = fill_model(model, variables, state_dict, seed, yolov5_state_dict_from_flax)
    model = apply_cast_params(model, policy, source).to(dev).eval()

    def forward(x: torch.Tensor) -> torch.Tensor:
        return model.decode(model(x))

    cfg = config or default_detect2d_config(variant, num_classes, input_hw)
    pipeline = Detect2DPipeline(cfg, forward, device=dev, precision=policy)
    spec = _detect2d_spec(cfg, num_predictions(cfg.input_hw))
    spec.extra["fused_stages"] = list(pipeline.fused_stages)
    spec.extra.update(policy.spec_extra(stored_params(model), KEEP_F32_2D))
    return pipeline, spec, model


def default_detect2d_config(
    variant: str = "n", num_classes: int = 80, input_hw: tuple[int, int] = (512, 512)
) -> Detect2DConfig:
    """The config ``build_yolov5_pipeline`` takes when given none."""
    return Detect2DConfig(
        model_name=f"yolov5{variant}", input_hw=tuple(input_hw), num_classes=num_classes
    )


def _detect2d_spec(cfg: Detect2DConfig, n_predictions: int) -> ModelSpec:
    """Serving spec of the 2D detector pipelines (the analogue of
    examples/YOLOv5/config.pbtxt)."""
    return ModelSpec(
        name=cfg.model_name,
        version="1",
        platform="torch",
        # any camera resolution; the pipeline resizes to input_hw
        inputs=(TensorSpec("images", (-1, -1, -1, 3), "FP32", "NHWC"),),
        outputs=(
            TensorSpec("detections", (-1, cfg.max_det, 6), "FP32"),
            TensorSpec("valid", (-1, cfg.max_det), "BOOL"),
        ),
        max_batch_size=8,
        extra={
            "conf_thresh": cfg.conf_thresh,
            "iou_thresh": cfg.iou_thresh,
            "model_input_hw": list(cfg.input_hw),
            "num_predictions": n_predictions,
            "num_classes": cfg.num_classes,
            "class_names": list(cfg.class_names),
        },
    )


# family name -> builder (the JAX table also holds yolov4, retinanet,
# fcos and preprocess; those are not ported yet)
BUILDERS_2D = {"yolov5": build_yolov5_pipeline}
