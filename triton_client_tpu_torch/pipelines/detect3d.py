"""3D detection pipeline: raw point cloud in, packed 3D boxes out (port
of ``pipelines/detect3d.py``: PointPillars and SECOND-IoU's dense middle).

padded cloud -> voxel features (the sort-free scatter VFE, the fused
voxelize->scatter stage, or the grouped voxelizer) -> backbone -> anchor
heads -> gate + top-k -> residual decode of the K survivors -> rotated-BEV
NMS + pack. Three stages are hand-written kernels: SECOND's per-cell mean
(``ops/gpu_voxel``, with the ``voxelize_scatter`` stage fused), and the
decode and the suppress+pack (``ops/gpu_decode3d``, ``ops/gpu_suppress3d``,
with ``decode_nms`` fused). The host only pads the raw cloud to a point
bucket (``prepare_points``) and reads back (max_det, 9) rows.

``run`` is the eager body; ``infer`` and ``infer_fn`` go through
``_jit``, the body captured as a CUDA graph per point bucket
(``runtime/graphs``, the counterpart of the JAX pipeline's ``jax.jit``).
``device_fn`` is the body over a dict of device tensors.

The defaults are the reference's ``examples/pointpillar_kitti``
(``data/kitti_pointpillars.yaml``) and ``examples/second_iou``
(``data/kitti_second.yaml``): the configs come from code, since the port
reads no YAML.
"""

from __future__ import annotations

import bisect
import dataclasses
import logging

import numpy as np
import torch

from triton_client_tpu_torch.channel.base import InferFuture
from triton_client_tpu_torch.config import ModelSpec, TensorSpec
from triton_client_tpu_torch.device import resolve_device, strict_fp32
from triton_client_tpu_torch.models.convert import (
    pointpillars_state_dict_from_flax,
    second_state_dict_from_flax,
)
from triton_client_tpu_torch.models.layers import init_random_
from triton_client_tpu_torch.models.pointpillars import (
    PointPillars,
    PointPillarsConfig,
    decode_candidates,
)
from triton_client_tpu_torch.models.second import SECONDConfig, SECONDIoU
from triton_client_tpu_torch.ops.detect3d_postprocess import nms_pack_3d
from triton_client_tpu_torch.ops.fused import resolve_fused_stages
from triton_client_tpu_torch.ops.gpu_decode3d import gather_residual_decode
from triton_client_tpu_torch.ops.gpu_voxel import fused_mean_volume
from triton_client_tpu_torch.ops.voxelize import pad_points, voxelize
from triton_client_tpu_torch.runtime.graphs import CapturedFunction

log = logging.getLogger(__name__)

# The ops the JAX package keeps in float32 under any precision policy
# (runtime/precision.py KEEP_F32_3D); the port serves float32 only.
KEEP_F32_3D = ("voxelize_coords", "box_decode", "nms_scores")


@dataclasses.dataclass(frozen=True)
class Detect3DConfig:
    model_name: str = "pointpillars"
    score_thresh: float = 0.1
    iou_thresh: float = 0.01
    max_det: int = 128
    # NMS candidate width: top-k on the raw logits before any box decode
    pre_max: int = 256
    point_buckets: tuple[int, ...] = (32768, 65536, 131072)
    # sensor-height z correction added to incoming points
    z_offset: float = 0.0
    class_names: tuple[str, ...] = ("Car", "Pedestrian", "Cyclist")
    # "auto": the sort-free scatter VFE on pillar grids (nz == 1) and for
    # models that declare scatter_any_nz (SECOND's mean VFE), which keeps
    # every point and cell; "grouped": the (V, K) voxelizer with the
    # max_voxels / max_points_per_voxel caps of OpenPCDet
    vfe: str = "auto"
    # fused-stage routing (ops/fused): "auto" fuses on CUDA (the kernels),
    # "on" everywhere (their plain versions on the CPU), "off" never
    fused: str = "auto"


def prepare_points(
    points: np.ndarray, point_features: int, buckets, z_offset: float = 0.0
) -> tuple[np.ndarray, int]:
    """Host prep of one raw (M, F) cloud: keep ``point_features`` columns
    (zero-filling missing ones), add the z offset, pad to the smallest
    bucket that fits (the tail past the largest is dropped). Returns
    (padded (bucket, point_features) float32, real count)."""
    buckets = sorted(buckets)
    budget = buckets[min(bisect.bisect_left(buckets, points.shape[0]), len(buckets) - 1)]
    if points.shape[0] > budget:
        log.warning(
            "point cloud (%d pts) exceeds the largest bucket (%d); tail points dropped",
            points.shape[0], budget,
        )
    points = points[:, :point_features].astype(np.float32)  # a copy
    if points.shape[1] < point_features:
        points = np.pad(points, ((0, 0), (0, point_features - points.shape[1])))
    if z_offset:
        points[:, 2] += z_offset
    return pad_points(points, budget)


def unpack_rows(dets: np.ndarray, valid: np.ndarray) -> dict[str, np.ndarray]:
    """Packed (max_det, 9+e) rows [box7, extras..., score, label] -> the
    reference 3D client contract over the live rows: pred_boxes (n, 7),
    pred_scores (n,), pred_labels (n,) int32."""
    live = dets[valid]
    w = dets.shape[-1]
    return {
        "pred_boxes": live[:, :7],
        "pred_scores": live[:, w - 2],
        "pred_labels": live[:, w - 1].astype(np.int32),
    }


class Detect3DPipeline:
    """Wraps a 3D detector into the padded cloud -> packed rows path."""

    def __init__(
        self,
        config: Detect3DConfig,
        model: PointPillars | SECONDIoU,
        device: str | torch.device | None = None,
    ) -> None:
        self.config = config
        self.model = model
        self.device = resolve_device(device)
        if config.vfe not in ("auto", "grouped"):
            raise ValueError(f"unknown vfe mode {config.vfe!r} (auto|grouped)")
        # the pillar scatter VFE merges z cells, so auto takes it only on
        # nz == 1 grids; models whose scatter keys on the full 3D cell
        # (SECOND's mean VFE) declare scatter_any_nz
        self.use_scatter = config.vfe == "auto" and (
            model.cfg.voxel.grid_size[2] == 1 or getattr(model, "scatter_any_nz", False)
        )
        if self.use_scatter:
            log.info(
                "vfe=auto routes %s to the scatter VFE: every point and cell is kept, so "
                "outputs differ from the grouped max_voxels/max_points_per_voxel caps "
                "whenever a scan exceeds them; vfe='grouped' keeps the caps",
                config.model_name,
            )
        # voxelize_scatter replaces the scatter VFE of a model that takes a
        # mean volume (SECOND's dense middle; its config refuses any other),
        # as the JAX package routes it; decode_nms fits every tail
        candidates = ("decode_nms",)
        if self.use_scatter and hasattr(model, "from_volume"):
            candidates = ("voxelize_scatter",) + candidates
        self.fused_stages = resolve_fused_stages(config.fused, candidates, self.device)
        self._jit = CapturedFunction(self.run, config.model_name)
        if "voxelize_scatter" in self.fused_stages:
            log.info(
                "fused voxelize->scatter caps occupied cells at max_voxels (%d), the grouped "
                "budget; the unfused scatter it replaces keeps every occupied cell, so "
                "outputs differ once a scan exceeds the budget",
                model.cfg.voxel.max_voxels,
            )

    @torch.no_grad()
    def run(self, points: torch.Tensor, count: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(N, F) padded cloud and () real count on the pipeline's device ->
        ((max_det, 9) float32 rows, (max_det,) bool valid) on the device."""
        cfg, model = self.config, self.model
        points = points.to(torch.float32)
        if "voxelize_scatter" in self.fused_stages:
            heads = model.from_volume(fused_mean_volume(points, count, model.cfg.voxel))
        elif self.use_scatter:
            heads = model.from_points(points, count)
        else:
            vox = voxelize(points, count, model.cfg.voxel)
            heads = model(
                vox["voxels"][None], vox["num_points_per_voxel"][None], vox["coords"][None]
            )
        fused = "decode_nms" in self.fused_stages
        mc = model.cfg
        if fused:
            # the residual decode as one launch that reads the candidates'
            # rows through top_idx, then suppress + pack as another
            cand = model.topk_indices(heads, pre_max=cfg.pre_max, score_thresh=cfg.score_thresh)
            boxes = gather_residual_decode(*gathered_decode_args(model, heads, cand["top_idx"]))
        else:
            cand = model.topk_candidates(
                heads, pre_max=cfg.pre_max, score_thresh=cfg.score_thresh
            )
            boxes = decode_candidates(cand, mc.num_dir_bins, mc.dir_offset)["boxes"]
        dets, valid = nms_pack_3d(
            boxes, cand["scores"], cand["labels"],
            iou_thresh=cfg.iou_thresh, max_det=cfg.max_det, fused=fused,
        )
        return dets[0], valid[0]

    def infer(self, points: np.ndarray) -> dict[str, np.ndarray]:
        """points: (M, 4+) raw cloud [x, y, z, intensity, ...] -> pred_boxes
        (n, 7), pred_scores (n,), pred_labels (n,) over the n live rows."""
        return self.infer_dispatch(points).result()

    def infer_dispatch(self, points: np.ndarray) -> InferFuture:
        """``infer`` split at the readback: host prep and the graph's replay
        now, the device -> host copy in the returned future's ``result()``
        (the driver's ``--async`` pump)."""
        cfg = self.config
        padded, m = prepare_points(
            points, self.model.cfg.voxel.point_features, cfg.point_buckets, cfg.z_offset
        )
        dets, valid = self._jit(
            torch.from_numpy(padded).to(self.device),
            torch.tensor(m, dtype=torch.int32).to(self.device),
        )
        return InferFuture(lambda: unpack_rows(dets.cpu().numpy(), valid.cpu().numpy()))

    def infer_fn(self):
        """Repository-facing adapter over the padded contract (points,
        num_points), through the captured body; the channel reads the
        outputs back."""

        def fn(inputs):
            dets, valid = self._jit(inputs["points"], inputs["num_points"])
            return {"detections": dets, "valid": valid}

        return fn

    def device_fn(self):
        """The eager body over a dict of device tensors, with the wire
        names (the JAX pipeline's ``device_fn``)."""

        def fn(inputs):
            dets, valid = self.run(inputs["points"], inputs["num_points"])
            return {"detections": dets, "valid": valid}

        return fn

    def warmup(self, buckets=None) -> None:
        """Capture the graph of every point bucket before traffic
        (``RegisteredModel.warmup``)."""
        pf = self.model.cfg.voxel.point_features
        for n in buckets or self.config.point_buckets:
            self._jit(torch.zeros((n, pf), dtype=torch.float32, device=self.device),
                      torch.zeros((), dtype=torch.int32, device=self.device))

    def graph_stats(self) -> dict:
        return self._jit.stats()


def gathered_decode_args(model, heads: dict[str, torch.Tensor], top_idx: torch.Tensor) -> tuple:
    """The arguments of ``gather_residual_decode`` (kernel 3's gathered
    form) for a 3D model's heads (B, h, w, A, c) and its (B, K) top-k
    indices: the (B, N, 7) box head, the (N, 7) anchors, the (B, N, nb)
    direction logits, the indices and the model's direction constants."""
    b, nb = heads["box"].shape[0], model.cfg.num_dir_bins
    return (heads["box"].reshape(b, -1, 7), model.anchors, heads["dir"].reshape(b, -1, nb),
            top_idx, nb, model.cfg.dir_offset)


def _detect3d_spec(
    cfg: Detect3DConfig, model_cfg: PointPillarsConfig | SECONDConfig, extra: dict | None = None
) -> ModelSpec:
    """Serving spec of the 3D pipelines (the analogue of
    examples/pointpillar_kitti/config.pbtxt and examples/second_iou).
    Clients configure their host prep from ``extra`` (buckets, z offset)."""
    pf = model_cfg.voxel.point_features
    return ModelSpec(
        name=cfg.model_name,
        version="1",
        platform="torch",
        inputs=(
            TensorSpec("points", (-1, pf), "FP32"),
            TensorSpec("num_points", (), "INT32"),
        ),
        outputs=(
            TensorSpec("detections", (cfg.max_det, 9), "FP32"),
            TensorSpec("valid", (cfg.max_det,), "BOOL"),
        ),
        extra={
            "score_thresh": cfg.score_thresh,
            "iou_thresh": cfg.iou_thresh,
            "with_velocity": False,
            "class_names": list(cfg.class_names),
            "max_voxels": model_cfg.voxel.max_voxels,
            "point_buckets": list(cfg.point_buckets),
            "z_offset": cfg.z_offset,
            **(extra or {}),
        },
    )


def _serve(
    model: PointPillars | SECONDIoU,
    dev: torch.device,
    cfg: Detect3DConfig,
    extra: dict | None = None,
) -> tuple[Detect3DPipeline, ModelSpec, PointPillars | SECONDIoU]:
    """The shared tail of the builders: model to the device, pipeline, spec."""
    model = model.to(dev).eval()
    pipeline = Detect3DPipeline(cfg, model, device=dev)
    spec = _detect3d_spec(cfg, model.cfg, extra)
    spec.extra["fused_stages"] = list(pipeline.fused_stages)
    spec.extra.update(
        {
            "precision": "f32",
            "precision_keep_f32": list(KEEP_F32_3D),
            "param_bytes": sum(
                t.numel() * t.element_size()
                for k, t in model.state_dict().items()
                if not k.endswith("num_batches_tracked")
            ),
        }
    )
    return pipeline, spec, model


def build_pointpillars_pipeline(
    model_cfg: PointPillarsConfig | None = None,
    config: Detect3DConfig | None = None,
    variables=None,
    device: str | torch.device | None = None,
    seed: int = 0,
) -> tuple[Detect3DPipeline, ModelSpec, PointPillars]:
    """Model + pipeline + serving spec in one call.

    ``variables=None`` draws seeded random weights (``seed``); a flax
    variable tree from the JAX package is carried across through
    ``models/convert.pointpillars_state_dict_from_flax``. Runs on ``cuda``
    unless ``device="cpu"``, in float32 with TF32 off."""
    dev = resolve_device(device)
    strict_fp32()
    model = PointPillars(model_cfg or PointPillarsConfig())
    if variables is None:
        init_random_(model, seed)
    else:
        model.load_state_dict(pointpillars_state_dict_from_flax(variables, model))
    return _serve(model, dev, config or Detect3DConfig())


def build_second_pipeline(
    model_cfg: SECONDConfig | None = None,
    config: Detect3DConfig | None = None,
    variables=None,
    device: str | torch.device | None = None,
    seed: int = 0,
) -> tuple[Detect3DPipeline, ModelSpec, SECONDIoU]:
    """SECOND-IoU (dense middle) over the same seam as PointPillars, with
    the same arguments; flax variables carry across through
    ``models/convert.second_state_dict_from_flax``. The spec's extra
    carries ``iou_alpha``."""
    dev = resolve_device(device)
    strict_fp32()
    model_cfg = model_cfg or SECONDConfig()
    model = SECONDIoU(model_cfg)
    if variables is None:
        init_random_(model, seed)
    else:
        model.load_state_dict(second_state_dict_from_flax(variables, model))
    cfg = config or Detect3DConfig(model_name="second_iou")
    return _serve(model, dev, cfg, {"iou_alpha": model_cfg.iou_alpha})


def default_detect3d_config(model_name: str) -> Detect3DConfig:
    """Per-family pipeline defaults (the JAX table also holds CenterPoint's
    higher IoU gate; CenterPoint is not ported yet)."""
    return Detect3DConfig(model_name=model_name)


# family name -> builder (the JAX table also holds centerpoint, which is
# not ported yet)
BUILDERS_3D = {
    "pointpillars": build_pointpillars_pipeline,
    "second_iou": build_second_pipeline,
}
