"""2D detection pipeline: raw frame(s) in, packed detections out (port
of ``pipelines/detect2d.py``).

cast to the precision policy's compute dtype -> bilinear resize to the
model input -> normalize -> forward (float32 heads) -> decode -> float32
(the policy's ``boundary``) -> confidence gate + top-k -> class-aware NMS
(the fused CUDA tail, or the unfused op chain) -> rescale to original
pixels. Output per image: (max_det, 6) rows [x1, y1, x2, y2, conf, class]
plus a validity mask.

Two head styles (``Detect2DConfig.head_style``): ``"yolo"`` (YOLOv5,
YOLOv4: the forward gives (B, N, 5+nc) xywh/obj/cls predictions, the fused
tail decodes xywh in the kernel) and ``"scored"`` (the detectron family,
RetinaNet and FCOS: the model decodes its own xyxy boxes and per-class
scores, and the tail is multi-label by default). A scored pipeline serves
the reference's detectron contract, ``boxes``/``scores``/``classes``/
``dims`` (``examples/RetinaNet_detectron/config.pbtxt``).

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
from triton_client_tpu_torch.models import convert
from triton_client_tpu_torch.models.convert import fill_model, yolov5_state_dict_from_flax
from triton_client_tpu_torch.models.yolov5 import YoloV5, num_predictions
from triton_client_tpu_torch.ops.boxes import scale_boxes
from triton_client_tpu_torch.ops.detect_postprocess import extract_boxes, extract_boxes_scored
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
    # "yolo": the forward gives (B, N, 5+nc) obj/cls predictions; "scored":
    # ((B, N, 4) xyxy boxes, (B, N, nc) scores), the detectron family,
    # which decodes in the model
    head_style: str = "yolo"
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
        (B, N, 5+nc) decoded predictions in input-pixel units, or for a
        ``"scored"`` head ((B, N, 4) xyxy boxes, (B, N, nc) scores).
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
        extract = extract_boxes_scored if cfg.head_style == "scored" else extract_boxes
        dets, valid = extract(
            *(pred if cfg.head_style == "scored" else (pred,)),
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

    def _outputs(self, dets: torch.Tensor, valid: torch.Tensor, classes: torch.dtype) -> dict:
        """The wire contract of the spec the builder registers: packed
        ``detections``/``valid`` for the YOLO family, the detectron
        contract for a scored head (``classes`` in ``classes``' dtype,
        ``dims`` the valid rows an image)."""
        if self.config.head_style != "scored":
            return {"detections": dets, "valid": valid}
        return {"boxes": dets[..., :4], "scores": dets[..., 4],
                "classes": dets[..., 5].to(classes), "dims": valid.sum(-1).to(torch.int32)}

    def infer_fn(self):
        """Repository-facing dict -> dict adapter over tensors on the
        pipeline's device, through the captured body; the channel reads
        the outputs back. A scored head's ``classes`` are int64, as the
        spec declares (the JAX ``infer_fn``'s)."""

        def fn(inputs):
            return self._outputs(*self._jit(inputs["images"]), torch.int64)

        fn.graph_stats = self.graph_stats  # the captures behind a registered model
        fn.release_graphs = self._jit.release  # the lifecycle's page-out
        return fn

    def device_fn(self):
        """The eager body over a dict of device tensors, with the wire
        names (the JAX pipeline's ``device_fn``): a channel captures it
        as a graph of its own. ``orig_hw`` comes off the frames' shape. A
        scored head's ``classes`` are int32 here, as the JAX ``device_fn``
        emits them (its ``infer_fn`` and spec say int64)."""

        def fn(inputs):
            return self._outputs(*self.run(inputs["images"]), torch.int32)

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
    cfg = config or default_config("yolov5", num_classes, input_hw, variant)
    return _finish(model, policy, source, dev, "decode", cfg,
                   lambda c: _detect2d_spec(c, num_predictions(c.input_hw)))


def default_config(family: str, num_classes: int = 80, input_hw=None,
                   variant: str = "n") -> Detect2DConfig:
    """The config a family's builder takes when given none (the JAX
    builders' defaults): YOLOv5 conf 0.3 / IoU 0.45 at 512x512; YOLOv4 conf
    0.4 / IoU 0.6 at 512x512; RetinaNet and FCOS (detectron2's test-time
    settings) conf 0.05, IoU 0.5 and 0.6, 100 rows, raw pixels, multi-label,
    the scored head, at 480x640; the preprocess family its output size,
    512x512 by default."""
    if family == "preprocess":
        from triton_client_tpu_torch.pipelines.preprocess2d import Preprocess2DConfig

        return Preprocess2DConfig(input_hw=tuple(input_hw or (512, 512)))
    if family == "yolov5":
        return Detect2DConfig(model_name=f"yolov5{variant}",
                              input_hw=tuple(input_hw or (512, 512)), num_classes=num_classes)
    if family == "yolov4":
        return Detect2DConfig(model_name="yolov4", input_hw=tuple(input_hw or (512, 512)),
                              num_classes=num_classes, conf_thresh=0.4, iou_thresh=0.6)
    if family in ("retinanet", "fcos"):
        return Detect2DConfig(
            model_name=family, input_hw=tuple(input_hw or (480, 640)), num_classes=num_classes,
            conf_thresh=0.05, iou_thresh=0.5 if family == "retinanet" else 0.6, max_det=100,
            scaling="none", multi_label=True, head_style="scored",
        )
    raise ValueError(f"unknown 2D family {family!r} (of {sorted(BUILDERS_2D)})")


def _detect2d_spec(cfg: Detect2DConfig, n_predictions: int) -> ModelSpec:
    """Serving spec of the YOLO pipelines (the analogue of
    examples/YOLOv5/config.pbtxt and examples/YOLOv4/config.pbtxt)."""
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


def _detectron_spec(cfg: Detect2DConfig) -> ModelSpec:
    """Serving spec of the scored pipelines: the reference's detectron
    contract (examples/RetinaNet_detectron/config.pbtxt), ``boxes``,
    ``scores``, ``classes`` (INT64) and ``dims`` (INT32, valid rows an
    image)."""
    return ModelSpec(
        name=cfg.model_name,
        version="1",
        platform="torch",
        inputs=(TensorSpec("images", (-1, -1, -1, 3), "FP32", "NHWC"),),
        outputs=(
            TensorSpec("boxes", (-1, cfg.max_det, 4), "FP32"),
            TensorSpec("scores", (-1, cfg.max_det), "FP32"),
            TensorSpec("classes", (-1, cfg.max_det), "INT64"),
            TensorSpec("dims", (-1,), "INT32"),
        ),
        max_batch_size=8,
        extra={
            "conf_thresh": cfg.conf_thresh,
            "iou_thresh": cfg.iou_thresh,
            "scaling": cfg.scaling,
            "class_names": list(cfg.class_names),
        },
    )


def _finish(model, policy, source, dev, decode: str, cfg, spec_of):
    """The builders' common end: the policy stores the tensors, the
    pipeline's forward is the model's heads through its ``decode`` method,
    the spec records the route and the policy. Returns (pipeline, spec,
    model)."""
    model = apply_cast_params(model, policy, source).to(dev).eval()

    def forward(x: torch.Tensor):
        return getattr(model, decode)(model(x))

    pipeline = Detect2DPipeline(cfg, forward, device=dev, precision=policy)
    spec = spec_of(cfg)
    spec.extra["fused_stages"] = list(pipeline.fused_stages)
    spec.extra.update(policy.spec_extra(stored_params(model), KEEP_F32_2D))
    return pipeline, spec, model


def build_yolov4_pipeline(
    num_classes: int = 80,
    width: float = 1.0,
    input_hw: tuple[int, int] = (512, 512),
    variables=None,
    config: Detect2DConfig | None = None,
    device: str | torch.device | None = None,
    seed: int = 0,
    dtype: torch.dtype | str = torch.float32,
    precision: PrecisionPolicy | str | None = None,
    state_dict=None,
):
    """YOLOv4 (``models/yolov4.py``, ``width`` through ``make_divisible``)
    + pipeline + serving spec, as ``build_yolov5_pipeline`` (weights,
    ``dtype``, ``precision``, ``device``); the flat v4 decode drops into
    the YOLO tail (default conf 0.4, IoU 0.6)."""
    from triton_client_tpu_torch.models.yolov4 import YoloV4
    from triton_client_tpu_torch.models.yolov4 import num_predictions as v4_num_predictions

    dev = resolve_device(device)
    strict_fp32()
    policy, dtype = resolve_policy(precision, parse_compute_dtype(dtype))
    model = YoloV4(num_classes=num_classes, width=width, dtype=dtype)
    source = fill_model(model, variables, state_dict, seed, convert.yolov4_state_dict_from_flax)
    cfg = config or default_config("yolov4", num_classes, input_hw)
    return _finish(model, policy, source, dev, "decode_flat", cfg,
                   lambda c: _detect2d_spec(c, v4_num_predictions(c.input_hw)))


def _build_detectron(family, num_classes, depth, input_hw, variables, config, device, seed,
                     dtype, precision, state_dict):
    from triton_client_tpu_torch.models.retinanet import FCOS, RetinaNet

    dev = resolve_device(device)
    strict_fp32()
    policy, dtype = resolve_policy(precision, parse_compute_dtype(dtype))
    cls, from_flax = {"retinanet": (RetinaNet, convert.retinanet_state_dict_from_flax),
                      "fcos": (FCOS, convert.fcos_state_dict_from_flax)}[family]
    model = cls(num_classes=num_classes, depth=depth, input_hw=input_hw, dtype=dtype)
    source = fill_model(model, variables, state_dict, seed, from_flax)
    if variables is None and state_dict is None:
        model.head.init_prior_()  # seeded: the class output at the focal-loss prior, as flax's
    cfg = config or default_config(family, num_classes, input_hw)
    return _finish(model, policy, source, dev, "decode", cfg, _detectron_spec)


def build_retinanet_pipeline(
    num_classes: int = 80,
    depth: str = "resnet50",
    input_hw: tuple[int, int] = (480, 640),
    variables=None,
    config: Detect2DConfig | None = None,
    device: str | torch.device | None = None,
    seed: int = 0,
    dtype: torch.dtype | str = torch.float32,
    precision: PrecisionPolicy | str | None = None,
    state_dict=None,
):
    """RetinaNet (``models/retinanet.py``) + the scored pipeline + the
    detectron spec (weights, ``dtype``, ``precision``, ``device`` as
    ``build_yolov5_pipeline``). Raw pixels in (no /255), decode in the
    model against its anchor buffer, multi-label tail: conf 0.05, IoU 0.5,
    100 rows. Seeded weights put the class output's bias at the focal-loss
    prior (sigmoid 0.01), as flax initialises it. The model's ``input_hw``
    must be the config's: the anchors are built for it."""
    return _build_detectron("retinanet", num_classes, depth, input_hw, variables, config,
                            device, seed, dtype, precision, state_dict)


def build_fcos_pipeline(
    num_classes: int = 80,
    depth: str = "resnet50",
    input_hw: tuple[int, int] = (480, 640),
    variables=None,
    config: Detect2DConfig | None = None,
    device: str | torch.device | None = None,
    seed: int = 0,
    dtype: torch.dtype | str = torch.float32,
    precision: PrecisionPolicy | str | None = None,
    state_dict=None,
):
    """FCOS (the anchor-free detectron model; the reference's FCOS_client),
    as :func:`build_retinanet_pipeline` with IoU 0.6."""
    return _build_detectron("fcos", num_classes, depth, input_hw, variables, config, device,
                            seed, dtype, precision, state_dict)


def detectron_infer_fn(pipeline: Detect2DPipeline):
    """The JAX package's alias: a scored pipeline's ``infer_fn`` already
    serves the detectron contract (boxes/scores/classes/dims)."""
    return pipeline.infer_fn()


def _build_preprocess(**kwargs):
    from triton_client_tpu_torch.pipelines.preprocess2d import build_preprocess_pipeline

    return build_preprocess_pipeline(**kwargs)


# family name -> builder, shared by the CLI and the disk repository
BUILDERS_2D = {
    "yolov5": build_yolov5_pipeline,
    "yolov4": build_yolov4_pipeline,
    "retinanet": build_retinanet_pipeline,
    "fcos": build_fcos_pipeline,
    "preprocess": _build_preprocess,
}
