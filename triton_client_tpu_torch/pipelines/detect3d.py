"""3D detection pipeline: raw point cloud in, packed 3D boxes out (port
of ``pipelines/detect3d.py``: PointPillars, SECOND-IoU with either middle
encoder and CenterPoint).

padded cloud -> voxel features (the sort-free scatter VFE, the fused
voxelize->scatter stage, or the grouped voxelizer) -> backbone -> heads ->
for the anchor models, gate + top-k -> residual decode of the K survivors;
for CenterPoint, the centre decode (peak test, top-K, gathers) and the
gate + top-k of ``extract_boxes_3d`` -> rotated-BEV NMS + pack. Three
stages are hand-written kernels: SECOND's per-cell mean
(``ops/gpu_voxel``, with the ``voxelize_scatter`` stage fused; the dense
middle only), and the
residual decode and the suppress+pack (``ops/gpu_decode3d``,
``ops/gpu_suppress3d``, with ``decode_nms`` fused); CenterPoint's tail
runs the suppress+pack kernel alone. The host only pads the raw cloud to a
point bucket (``prepare_points``) and reads back (max_det, 9 + e) rows:
CenterPoint's velocity rides as e = 2 extra columns and is served as
``velocities`` too.

``run`` is the eager body; ``infer`` and ``infer_fn`` go through
``_jit``, the body captured as a CUDA graph per point bucket
(``runtime/graphs``, the counterpart of the JAX pipeline's ``jax.jit``).
``device_fn`` is the body over a dict of device tensors.

Every serving precision policy applies (``runtime/precision.py``): the
model's body in bfloat16 under ``bf16`` (or ``dtype``), its weights int8
under ``int8w``/``int8``. ``points`` stays float32 on the wire and into the
voxelizer under any policy (``KEEP_F32_3D``: a rounded coordinate flips
its cell), and the heads re-enter float32 (the policy's ``boundary``)
before every tail, so the kernels receive float32 as they do at ``f32``.

The defaults are the reference's ``examples/pointpillar_kitti``
(``data/kitti_pointpillars.yaml``), ``examples/second_iou``
(``data/kitti_second.yaml``; ``data/kitti_second_sparse005.yaml`` the
sparse middle at the reference's 0.05 m grid) and
``examples/centerpoint_nusc``'s model
(``models/centerpoint.CenterPointConfig``); ``dataset_config`` reads the
``data/*.yaml`` files over them.
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
from triton_client_tpu_torch.models.centerpoint import CenterPoint, CenterPointConfig
from triton_client_tpu_torch.models.convert import (
    centerpoint_state_dict_from_flax,
    fill_model,
    pointpillars_state_dict_from_flax,
    second_state_dict_from_flax,
)
from triton_client_tpu_torch.models.pointpillars import (
    PointPillars,
    PointPillarsConfig,
    decode_candidates,
)
from triton_client_tpu_torch.models.second import SECONDConfig, SECONDIoU
from triton_client_tpu_torch.ops.detect3d_postprocess import extract_boxes_3d, nms_pack_3d
from triton_client_tpu_torch.ops.fused import resolve_fused_stages
from triton_client_tpu_torch.ops.gpu_decode3d import gather_residual_decode
from triton_client_tpu_torch.ops.gpu_voxel import fused_mean_volume
from triton_client_tpu_torch.ops.voxelize import pad_points, voxelize
from triton_client_tpu_torch.runtime.graphs import CapturedFunction
from triton_client_tpu_torch.runtime.precision import (
    KEEP_F32_3D,
    PrecisionPolicy,
    apply_cast_params,
    parse_compute_dtype,
    resolve_policy,
    stored_params,
)

log = logging.getLogger(__name__)


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
    # sweeps aggregated a scan by the stream layer (ops/sweeps.sweep_source):
    # 1 for KITTI, 10 for the reference's nuScenes CenterPoint. The
    # pipeline takes one aggregated cloud; this carries the dataset's
    # default to the CLI
    nsweeps: int = 1
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


def unpack_rows(
    dets: np.ndarray, valid: np.ndarray, with_velocity: bool = False
) -> dict[str, np.ndarray]:
    """Packed (max_det, 9+e) rows [box7, extras..., score, label] -> the
    reference 3D client contract over the live rows: pred_boxes (n, 7),
    pred_scores (n,), pred_labels (n,) int32, and with ``with_velocity``
    (a model-config fact, not a guess from the row width) pred_velocities
    (n, 2), columns 7:9."""
    live = dets[valid]
    w = dets.shape[-1]
    out = {
        "pred_boxes": live[:, :7],
        "pred_scores": live[:, w - 2],
        "pred_labels": live[:, w - 1].astype(np.int32),
    }
    if with_velocity:
        out["pred_velocities"] = live[:, 7:9]
    return out


class Detect3DPipeline:
    """Wraps a 3D detector into the padded cloud -> packed rows path."""

    def __init__(
        self,
        config: Detect3DConfig,
        model: PointPillars | SECONDIoU | CenterPoint,
        device: str | torch.device | None = None,
        precision: PrecisionPolicy | str | None = None,
    ) -> None:
        """``precision``: the serving policy the model was stored under; the
        pipeline adds ``points`` to its float32 inputs (KEEP_F32_3D), so no
        policy narrows the cloud on the wire."""
        self.config = config
        self.model = model
        policy = PrecisionPolicy.parse(precision)
        if "points" not in policy.keep_f32_inputs:
            policy = dataclasses.replace(
                policy, keep_f32_inputs=policy.keep_f32_inputs + ("points",))
        self.precision = policy
        self.with_velocity = getattr(model.cfg, "with_velocity", False)
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
        # mean volume (SECOND's dense middle: a sparse middle would need a
        # dense volume of its whole grid), as the JAX package routes it;
        # decode_nms fits every tail
        candidates = ("decode_nms",)
        if (self.use_scatter and getattr(model.cfg, "middle", None) == "dense"
                and hasattr(model, "from_volume")):
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
        ((max_det, 9 + e) float32 rows, (max_det,) bool valid) on the
        device."""
        return self.tail(self.heads(points, count))

    def heads(self, points: torch.Tensor, count: torch.Tensor) -> dict[str, torch.Tensor]:
        """The voxel stage and the model: the raw heads, float32 (the
        policy's ``boundary``)."""
        model = self.model
        # the voxelizer always sees the float32 cloud (KEEP_F32_3D)
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
        # keep-list boundary: box decode and NMS scoring run in float32
        # whatever the body's dtype
        return self.precision.boundary(heads)

    def tail(self, heads: dict[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        """Float32 heads -> the packed rows and their validity: the gate,
        top-k, decode and suppress + pack (the kernels on the fused route)."""
        cfg, model = self.config, self.model
        fused = "decode_nms" in self.fused_stages
        mc = model.cfg
        if not hasattr(model, "topk_indices"):
            # the centre decode: every kept peak decoded, velocity riding as
            # extra columns through the gate + top-k and suppress + pack
            pred = model.decode(heads)
            boxes = pred["boxes"]
            if "velocity" in pred:
                boxes = torch.cat([boxes, pred["velocity"]], -1)
            dets, valid = extract_boxes_3d(
                boxes, pred["scores"], score_thresh=cfg.score_thresh,
                iou_thresh=cfg.iou_thresh, max_det=cfg.max_det, pre_max=cfg.pre_max,
                fused=fused,
            )
            return dets[0], valid[0]
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
        (n, 7), pred_scores (n,), pred_labels (n,) over the n live rows, and
        pred_velocities (n, 2) for a model with velocity."""
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
        return InferFuture(lambda: unpack_rows(dets.cpu().numpy(), valid.cpu().numpy(),
                                               self.with_velocity))

    def infer_fn(self):
        """Repository-facing adapter over the padded contract (points,
        num_points), through the captured body; the channel reads the
        outputs back. A model with velocity also serves ``velocities``, a
        view of the detections' columns 7:9: the captured body returns
        clones, so no later replay overwrites it."""

        def fn(inputs):
            dets, valid = self._jit(inputs["points"], inputs["num_points"])
            return self._outputs(dets, valid)

        fn.graph_stats = self.graph_stats  # the captures behind a registered model
        fn.release_graphs = self._jit.release  # the lifecycle's page-out
        return fn

    def device_fn(self):
        """The eager body over a dict of device tensors, with the wire
        names (the JAX pipeline's ``device_fn``)."""

        def fn(inputs):
            return self._outputs(*self.run(inputs["points"], inputs["num_points"]))

        return fn

    def _outputs(self, dets: torch.Tensor, valid: torch.Tensor) -> dict[str, torch.Tensor]:
        out = {"detections": dets, "valid": valid}
        if self.with_velocity:
            out["velocities"] = dets[:, 7:9]
        return out

    def warmup(self, buckets=None) -> None:
        """Capture the graph of every point bucket before traffic
        (``RegisteredModel.warmup``), in the dtypes a channel stages
        (``points`` float32 under every policy)."""
        pf = self.model.cfg.voxel.point_features
        dtype = self.precision.wire_dtype("points")
        for n in buckets or self.config.point_buckets:
            self._jit(torch.zeros((n, pf), dtype=dtype, device=self.device),
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
    cfg: Detect3DConfig,
    model_cfg: PointPillarsConfig | SECONDConfig | CenterPointConfig,
    extra: dict | None = None,
) -> ModelSpec:
    """Serving spec of the 3D pipelines (the analogue of
    examples/pointpillar_kitti/config.pbtxt and examples/second_iou).
    Clients configure their host prep from ``extra`` (buckets, z offset).
    Rows are [box7, extras..., score, label]: with ``with_velocity`` in
    ``extra``, 2 velocity columns and a ``velocities`` output."""
    n_extra = 2 if (extra or {}).get("with_velocity") else 0
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
            TensorSpec("detections", (cfg.max_det, 9 + n_extra), "FP32"),
            TensorSpec("valid", (cfg.max_det,), "BOOL"),
        ) + ((TensorSpec("velocities", (cfg.max_det, 2), "FP32"),) if n_extra else ()),
        extra={
            "score_thresh": cfg.score_thresh,
            "iou_thresh": cfg.iou_thresh,
            "with_velocity": n_extra > 0,
            "class_names": list(cfg.class_names),
            "max_voxels": model_cfg.voxel.max_voxels,
            "point_buckets": list(cfg.point_buckets),
            "z_offset": cfg.z_offset,
            **(extra or {}),
        },
    )


def _serve(
    model: PointPillars | SECONDIoU | CenterPoint,
    dev: torch.device,
    cfg: Detect3DConfig,
    policy: PrecisionPolicy,
    source: dict | None,
    extra: dict | None = None,
) -> tuple[Detect3DPipeline, ModelSpec, PointPillars | SECONDIoU | CenterPoint]:
    """The shared tail of the builders: the policy's storage
    (``apply_cast_params``, quantizing ``source``, the float32 tensors
    loaded), model to the device, pipeline, spec."""
    model = apply_cast_params(model, policy, source).to(dev).eval()
    pipeline = Detect3DPipeline(cfg, model, device=dev, precision=policy)
    spec = _detect3d_spec(cfg, model.cfg, extra)
    spec.extra["fused_stages"] = list(pipeline.fused_stages)
    spec.extra.update(pipeline.precision.spec_extra(stored_params(model), KEEP_F32_3D))
    return pipeline, spec, model


def build_pointpillars_pipeline(
    model_cfg: PointPillarsConfig | None = None,
    config: Detect3DConfig | None = None,
    variables=None,
    device: str | torch.device | None = None,
    seed: int = 0,
    state_dict=None,
    dtype: torch.dtype | str = torch.float32,
    precision: PrecisionPolicy | str | None = None,
) -> tuple[Detect3DPipeline, ModelSpec, PointPillars]:
    """Model + pipeline + serving spec in one call.

    Weights (``models/convert.fill_model``): a flax variable tree from the
    JAX package (``variables``, through
    ``pointpillars_state_dict_from_flax``), else ``state_dict`` (the port's
    names, or a function of the model that returns them:
    ``runtime/importers``), else seeded random ones (``seed``). ``dtype``:
    the body's compute dtype; ``precision``: the serving policy
    (``runtime/precision.resolve_policy``: ``bf16`` switches a float32 body
    to bfloat16, an explicit ``dtype`` wins), applied after the fill. Runs
    on ``cuda`` unless ``device="cpu"``, with TF32 off."""
    dev = resolve_device(device)
    strict_fp32()
    policy, dtype = resolve_policy(precision, parse_compute_dtype(dtype))
    model = PointPillars(model_cfg or PointPillarsConfig(), dtype=dtype)
    source = fill_model(model, variables, state_dict, seed, pointpillars_state_dict_from_flax)
    return _serve(model, dev, config or Detect3DConfig(), policy, source)


def build_second_pipeline(
    model_cfg: SECONDConfig | None = None,
    config: Detect3DConfig | None = None,
    variables=None,
    device: str | torch.device | None = None,
    seed: int = 0,
    state_dict=None,
    dtype: torch.dtype | str = torch.float32,
    precision: PrecisionPolicy | str | None = None,
) -> tuple[Detect3DPipeline, ModelSpec, SECONDIoU]:
    """SECOND-IoU (either middle) over the same seam as PointPillars, with
    the same arguments; flax variables carry across through
    ``models/convert.second_state_dict_from_flax``. The spec's extra
    carries ``iou_alpha``."""
    dev = resolve_device(device)
    strict_fp32()
    policy, dtype = resolve_policy(precision, parse_compute_dtype(dtype))
    model_cfg = model_cfg or SECONDConfig()
    model = SECONDIoU(model_cfg, dtype=dtype)
    source = fill_model(model, variables, state_dict, seed, second_state_dict_from_flax)
    cfg = config or Detect3DConfig(model_name="second_iou")
    return _serve(model, dev, cfg, policy, source, {"iou_alpha": model_cfg.iou_alpha})


# CenterNet's heatmap prior, -log((1 - 0.1) / 0.1): the heatmap bias of a
# seeded CenterPoint, as flax initialises it
HEATMAP_PRIOR = -2.19


def build_centerpoint_pipeline(
    model_cfg: CenterPointConfig | None = None,
    config: Detect3DConfig | None = None,
    variables=None,
    device: str | torch.device | None = None,
    seed: int = 0,
    state_dict=None,
    dtype: torch.dtype | str = torch.float32,
    precision: PrecisionPolicy | str | None = None,
) -> tuple[Detect3DPipeline, ModelSpec, CenterPoint]:
    """CenterPoint-pillar (the reference's det3d nuScenes path) over the
    same seam, with the same arguments; flax variables carry across through
    ``models/convert.centerpoint_state_dict_from_flax``, det3d checkpoints
    through ``runtime/importers.load_centerpoint``. The decode emits
    one-hot class scores, so the anchor models' gate + top-k and rotated
    suppress+pack apply unchanged; the velocity rides through the packed
    rows as 2 extra columns and is served as ``velocities``. The config's
    ``class_names`` follow the model's, so a KITTI-default config cannot
    mislabel nuScenes predictions. ``dtype`` and ``precision`` as
    PointPillars'."""
    dev = resolve_device(device)
    strict_fp32()
    policy, dtype = resolve_policy(precision, parse_compute_dtype(dtype))
    model_cfg = model_cfg or CenterPointConfig()
    model = CenterPoint(model_cfg, dtype=dtype)
    source = fill_model(model, variables, state_dict, seed, centerpoint_state_dict_from_flax)
    if source is None:
        with torch.no_grad():
            model.head.heatmap.bias.fill_(HEATMAP_PRIOR)
    cfg = config if config is not None else default_detect3d_config("centerpoint")
    if tuple(cfg.class_names) != tuple(model_cfg.class_names):
        cfg = dataclasses.replace(cfg, class_names=tuple(model_cfg.class_names))
    return _serve(model, dev, cfg, policy, source, {"with_velocity": model_cfg.with_velocity})


def default_detect3d_config(model_name: str) -> Detect3DConfig:
    """Per-family pipeline defaults. Centre-heatmap models pre-suppress by
    local peaks, so box NMS only removes duplicate peaks (a higher IoU
    gate)."""
    if model_name == "centerpoint":
        return Detect3DConfig(model_name=model_name, iou_thresh=0.2)
    return Detect3DConfig(model_name=model_name)


# family name -> builder: the CLIs' and the disk repository's table
BUILDERS_3D = {
    "pointpillars": build_pointpillars_pipeline,
    "second_iou": build_second_pipeline,
    "centerpoint": build_centerpoint_pipeline,
}
