"""CenterPoint (pillar variant) as an ``nn.Module`` (port of
``models/centerpoint.py``): the center-heatmap 3D detector with velocity,
the reference's nuScenes CenterPoint (``data/nusc_centerpoint.yaml``, the
``nusc_centerpoint_pp_02voxel_two_pfn_10sweep`` lineage).

The trunk is PointPillars' (``PillarVFE``, the pillar scatter and
``BEVBackbone``); ``CenterHead`` is a shared 3x3 conv + BN + ReLU with
1x1 branches: the class heatmap and the offset, height, size, sin/cos
rotation and velocity maps. ``decode`` is fixed-shape: a 3x3 max-pool peak
test on the heatmap logits, a flat top-K, and the gathers of the K cells'
regressions, so the whole path captures as one CUDA graph.

Public functions keep the JAX package's layouts: the heads are NHWC
(B, h, w, c), and the flat top-K runs over (h, w, class) with the class
fastest, as the JAX package flattens its NHWC heatmap; the convolutions
run NCHW inside. Submodules carry the flax names (``vfe.linear``,
``backbone.block0_down``, ``head.shared``, ``head.shared_bn``,
``head.heatmap``, ...), so ``models/convert.centerpoint_state_dict_from_flax``
maps by path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from triton_client_tpu_torch.device import scalar_on
from triton_client_tpu_torch.models.pointpillars import (
    BEVBackbone,
    PillarVFE,
    augment_points,
    require_pillar_grid,
    scatter_max_canvas,
    scatter_to_bev,
    validate_bev_divisible,
)
from triton_client_tpu_torch.ops.detect_postprocess import stable_top_k
from triton_client_tpu_torch.ops.voxelize import VoxelConfig

# nuScenes detection classes (data/nuscenes.names, the nusc_centerpoint
# config's class_names)
NUSC_CLASSES = (
    "car",
    "truck",
    "construction_vehicle",
    "bus",
    "trailer",
    "barrier",
    "motorcycle",
    "bicycle",
    "pedestrian",
    "traffic_cone",
)


@dataclasses.dataclass(frozen=True)
class CenterPointConfig:
    # the nuScenes grid: 0.2 m pillars over +-51.2 m, a 512 x 512 canvas
    voxel: VoxelConfig = VoxelConfig(
        point_cloud_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
        voxel_size=(0.2, 0.2, 8.0),
        max_voxels=30000,
        max_points_per_voxel=20,
    )
    vfe_filters: int = 64
    backbone_layers: tuple[int, ...] = (3, 5, 5)
    backbone_strides: tuple[int, ...] = (2, 2, 2)
    backbone_filters: tuple[int, ...] = (64, 128, 256)
    upsample_strides: tuple[int, ...] = (1, 2, 4)
    upsample_filters: tuple[int, ...] = (128, 128, 128)
    class_names: tuple[str, ...] = NUSC_CLASSES
    head_width: int = 64
    max_objects: int = 128  # top-K centres kept a frame
    with_velocity: bool = True

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    @property
    def head_stride(self) -> int:
        return self.backbone_strides[0] // self.upsample_strides[0]

    @property
    def head_hw(self) -> tuple[int, int]:
        nx, ny, _ = self.voxel.grid_size
        s = self.head_stride
        return ny // s, nx // s

    def validate(self) -> None:
        validate_bev_divisible(self.voxel, int(np.prod(self.backbone_strides)))


class CenterHead(nn.Module):
    """Shared 3x3 conv (no bias) + BN (eps 1e-3) + ReLU, then one 1x1
    conv a branch; NCHW in, a dict of NHWC maps out. The heatmap's bias
    starts at -2.19 = -log((1 - 0.1) / 0.1), CenterNet's prior (the seeded
    init keeps it, as flax's ``bias_init`` does)."""

    def __init__(self, cfg: CenterPointConfig, in_channels: int) -> None:
        super().__init__()
        self.cfg = cfg
        hw = cfg.head_width
        self.shared = nn.Conv2d(in_channels, hw, 3, padding=1, bias=False)
        self.shared_bn = nn.BatchNorm2d(hw, eps=1e-3)
        widths = {"heatmap": cfg.num_classes, "offset": 2, "height": 1, "size": 3, "rot": 2}
        if cfg.with_velocity:
            widths["vel"] = 2
        for name, c in widths.items():
            self.add_module(name, nn.Conv2d(hw, c, 1))
        self.branches = tuple(widths)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        shared = F.relu(self.shared_bn(self.shared(x))).to(torch.float32)
        return {n: self._modules[n](shared).permute(0, 2, 3, 1) for n in self.branches}


class CenterPoint(nn.Module):
    """VFE -> scatter -> backbone -> CenterHead. ``forward`` takes the
    grouped voxels (batched), ``from_points`` one padded cloud (the
    sort-free scatter path); both return the raw NHWC heads, which
    ``decode`` turns into the anchor models' flat contract."""

    def __init__(self, cfg: CenterPointConfig = CenterPointConfig()) -> None:
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.vfe = PillarVFE(cfg.vfe_filters, cfg.voxel)
        self.backbone = BEVBackbone(cfg, cfg.vfe_filters)
        self.head = CenterHead(cfg, sum(cfg.upsample_filters))

    def forward(
        self,
        voxels: torch.Tensor,      # (B, V, K, F)
        num_points: torch.Tensor,  # (B, V)
        coords: torch.Tensor,      # (B, V, 3) [z, y, x]
    ) -> dict[str, torch.Tensor]:
        nx, ny, _ = self.cfg.voxel.grid_size
        b, v, k, f = voxels.shape
        feats = self.vfe(
            voxels.reshape(b * v, k, f), num_points.reshape(b * v), coords.reshape(b * v, 3)
        ).reshape(b, v, -1)
        canvas = torch.stack([scatter_to_bev(feats[i], coords[i], (ny, nx)) for i in range(b)])
        return self._heads(canvas)

    def from_points(self, points: torch.Tensor, count: torch.Tensor) -> dict[str, torch.Tensor]:
        """Sort-free scatter path, batch 1, pillar grids only (see
        ``PointPillars.from_points``)."""
        require_pillar_grid(self.cfg.voxel.grid_size)
        nx, ny, _ = self.cfg.voxel.grid_size
        feats, vid, valid, _ = augment_points(points, count, self.cfg.voxel)
        canvas = scatter_max_canvas(self.vfe.encode(feats), vid, valid, (ny, nx))
        return self._heads(canvas[None])

    def _heads(self, canvas: torch.Tensor) -> dict[str, torch.Tensor]:
        """(B, ny, nx, C) NHWC canvas -> NHWC heads."""
        return self.head(self.backbone(canvas.permute(0, 3, 1, 2)))

    def decode(self, heads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Centre decode -> boxes (B, K, 7), scores (B, K, nc) one-hot at the
        peak's class, and velocity (B, K, 2) with ``with_velocity``.

        The peak test runs on the logits, with ``>=`` (a sigmoid saturates,
        so the neighbours of a confident peak would equal it after one):
        a cell keeps its sigmoid where it equals the 3x3 max around it
        (``max_pool2d`` pads with -inf, as flax's ``max_pool`` does), else
        0. The top-K is a stable sort over (h, w, class), so equal scores
        (the zeros that pad K when fewer peaks exist) go to the lowest
        index, as ``jax.lax.top_k``'s do."""
        cfg = self.cfg
        logits = heads["heatmap"]  # (B, H, W, nc)
        pooled = F.max_pool2d(logits.permute(0, 3, 1, 2), 3, stride=1, padding=1)
        heat = torch.where(logits >= pooled.permute(0, 2, 3, 1), torch.sigmoid(logits), 0.0)
        b, h, w, nc = heat.shape
        scores, idx = stable_top_k(heat.reshape(b, -1), cfg.max_objects)
        cls = idx % nc
        cell = idx // nc
        dev = logits.device

        def gather(name: str) -> torch.Tensor:
            m = heads[name]
            return torch.take_along_dim(m.reshape(b, h * w, m.shape[-1]), cell[..., None], dim=1)

        offset, height = gather("offset"), gather("height")
        size, rot = gather("size"), gather("rot")
        stride = scalar_on(cfg.head_stride, torch.float32, dev)
        vs = cfg.voxel.voxel_size
        r = cfg.voxel.point_cloud_range

        def world(cells: torch.Tensor, off: torch.Tensor, axis: int) -> torch.Tensor:
            # ((cell + offset) * stride) * voxel + origin, each step rounded
            # to float32 as the JAX package's weakly typed constants are
            size_f = scalar_on(vs[axis], torch.float32, dev)
            origin = scalar_on(r[axis], torch.float32, dev)
            return (cells.to(torch.float32) + off) * stride * size_f + origin

        dims = torch.exp(torch.clamp(size, -10, 10))
        boxes = torch.stack(
            [world(cell % w, offset[..., 0], 0), world(cell // w, offset[..., 1], 1),
             height[..., 0], dims[..., 0], dims[..., 1], dims[..., 2],
             torch.atan2(rot[..., 0], rot[..., 1])],
            -1,
        )
        classes = torch.arange(nc, device=dev)
        out = {"boxes": boxes, "scores": (cls[..., None] == classes).to(torch.float32)
               * scores[..., None]}
        if cfg.with_velocity:
            out["velocity"] = gather("vel")
        return out
