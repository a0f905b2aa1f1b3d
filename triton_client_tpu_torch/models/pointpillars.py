"""PointPillars as an ``nn.Module`` (port of ``models/pointpillars.py``).

PillarVFE(64) -> dense BEV scatter -> 3-block CNN backbone with
transposed-conv up-samplers, concatenated -> one anchor head (3 classes
x 2 rotations), residual box coding, direction bins: the settings of
the reference's ``examples/pointpillar_kitti`` (``data/pointpillar.yaml``).

Public functions keep the JAX package's layouts: the BEV canvas is NHWC
(B, ny, nx, C), the heads are (B, h, w, A, c) and flatten in (h, w, A)
order; the convolutions run NCHW inside. Submodules carry the flax
names (``vfe.linear``, ``backbone.block0_down_bn``, ``up2``, ...) so
``models/convert.pointpillars_state_dict_from_flax`` maps by path.

Two ways in over the same weights: ``forward`` takes the grouped
(V, K, F) voxel contract; ``from_points`` is the sort-free scatter path,
where pillar mean and max are scatters onto the grid. The pillar xyz
sums are taken in point order on both devices, so the same scan gives
the same canvas every time (``pillar_sums``). The pillar max is a
``scatter_reduce`` ``amax``, exact in any order.

``dtype`` is the body's compute dtype, as in the JAX module: with
``torch.bfloat16`` the VFE's linear layer and BatchNorm, the BEV canvas
and the backbone's convolutions, transposed convolutions and BatchNorms
run in bfloat16, while the points, their augmentation and the pillar
means stay float32, and the three 1x1 heads compute in float32 on float32
features whatever their weights' storage.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from triton_client_tpu_torch.device import scalar_on, values_on
from triton_client_tpu_torch.models.layers import conv_f32
from triton_client_tpu_torch.ops.detect_postprocess import stable_top_k
from triton_client_tpu_torch.ops.voxelize import VoxelConfig, assign_cells


@dataclasses.dataclass(frozen=True)
class AnchorClassConfig:
    """Per-class anchor setup (``data/pointpillar.yaml``)."""

    name: str
    size: tuple[float, float, float]  # dx, dy, dz
    bottom_z: float
    matched_thresh: float = 0.6
    unmatched_thresh: float = 0.45


KITTI_ANCHORS = (
    AnchorClassConfig("Car", (3.9, 1.6, 1.56), -1.78, 0.6, 0.45),
    AnchorClassConfig("Pedestrian", (0.8, 0.6, 1.73), -0.6, 0.5, 0.35),
    AnchorClassConfig("Cyclist", (1.76, 0.6, 1.73), -0.6, 0.5, 0.35),
)
ROTATIONS = (0.0, math.pi / 2)


@dataclasses.dataclass(frozen=True)
class PointPillarsConfig:
    voxel: VoxelConfig = VoxelConfig()
    vfe_filters: int = 64
    backbone_layers: tuple[int, ...] = (3, 5, 5)
    backbone_strides: tuple[int, ...] = (2, 2, 2)
    backbone_filters: tuple[int, ...] = (64, 128, 256)
    upsample_strides: tuple[int, ...] = (1, 2, 4)
    upsample_filters: tuple[int, ...] = (128, 128, 128)
    anchor_classes: tuple[AnchorClassConfig, ...] = KITTI_ANCHORS
    num_dir_bins: int = 2
    dir_offset: float = 0.78539  # pi/4, the OpenPCDet convention

    @property
    def num_classes(self) -> int:
        return len(self.anchor_classes)

    @property
    def anchors_per_loc(self) -> int:
        return len(self.anchor_classes) * len(ROTATIONS)

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


def validate_bev_divisible(voxel: VoxelConfig, stride: int) -> None:
    """The BEV grid must divide the deepest composed downsample, or the
    up-sampled branches cannot be concatenated."""
    nx, ny, _ = voxel.grid_size
    if nx % stride or ny % stride:
        raise ValueError(
            f"BEV grid {nx}x{ny} (from voxel_size {voxel.voxel_size}) must be divisible "
            f"by the deepest composed downsample {stride}; pick a voxel size whose grid "
            "divides it"
        )


def generate_anchors(cfg: PointPillarsConfig) -> torch.Tensor:
    """Dense anchor grid (H, W, A, 7) [x, y, z, dx, dy, dz, rot] in world
    coordinates, centred on the head cells, z at the class's centre
    height. Built in float64 with numpy and rounded to float32, as the
    JAX package builds it."""
    h, w = cfg.head_hw
    r = cfg.voxel.point_cloud_range
    xs = np.linspace(r[0], r[3], w, endpoint=False) + (r[3] - r[0]) / w / 2
    ys = np.linspace(r[1], r[4], h, endpoint=False) + (r[4] - r[1]) / h / 2
    gx, gy = np.meshgrid(xs, ys)  # (h, w)
    anchors = []
    for cls_cfg in cfg.anchor_classes:
        cz = cls_cfg.bottom_z + cls_cfg.size[2] / 2
        for rot in ROTATIONS:
            a = np.zeros((h, w, 7), np.float32)
            a[..., 0], a[..., 1], a[..., 2] = gx, gy, cz
            a[..., 3:6] = cls_cfg.size
            a[..., 6] = rot
            anchors.append(a)
    return torch.from_numpy(np.stack(anchors, axis=2))


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Residual box decode (OpenPCDet ResidualCoder): x = xt * diag + xa,
    z = zt * dza + za, d = exp(clip(dt, -10, 10)) * da, r = rt + ra."""
    xa, ya, za, dxa, dya, dza, ra = anchors.unbind(-1)
    diag = torch.sqrt(dxa * dxa + dya * dya)
    x = deltas[..., 0] * diag + xa
    y = deltas[..., 1] * diag + ya
    z = deltas[..., 2] * dza + za
    dx = torch.exp(torch.clamp(deltas[..., 3], -10, 10)) * dxa
    dy = torch.exp(torch.clamp(deltas[..., 4], -10, 10)) * dya
    dz = torch.exp(torch.clamp(deltas[..., 5], -10, 10)) * dza
    r = deltas[..., 6] + ra
    return torch.stack([x, y, z, dx, dy, dz, r], -1)


def direction_constants(num_dir_bins: int, dir_offset: float) -> tuple[float, float]:
    """(period, dir_offset) as the float32 values JAX computes with: the
    period is taken in double, then both are rounded to float32 (JAX's
    weak typing of Python floats against a float32 array)."""
    period = 2 * math.pi / num_dir_bins
    return float(np.float32(period)), float(np.float32(dir_offset))


def rectify_direction(
    rot: torch.Tensor, dir_bin: torch.Tensor, num_dir_bins: int, dir_offset: float
) -> torch.Tensor:
    """Direction-bin heading rectification: fold the regressed angle into
    one period, then add the classified bin's half turn."""
    period, offset = (
        scalar_on(v, torch.float32, rot.device)
        for v in direction_constants(num_dir_bins, dir_offset)
    )
    out = rot - offset
    out = out - torch.floor(out / period) * period + offset
    return out + period * dir_bin.to(torch.float32)


def decode_residual(
    deltas: torch.Tensor,
    anchors: torch.Tensor,
    dir_bin: torch.Tensor,
    num_dir_bins: int,
    dir_offset: float,
) -> torch.Tensor:
    """(..., 7) deltas and anchors + (...,) direction bins -> (..., 7)
    boxes with rectified headings: the op chain the kernel
    ``ops/gpu_decode3d`` replaces, and that kernel's plain version."""
    decoded = decode_boxes(deltas, anchors)
    rot = rectify_direction(decoded[..., 6], dir_bin, num_dir_bins, dir_offset)
    return torch.cat([decoded[..., :6], rot[..., None]], -1)


def gather_candidates(
    heads: dict[str, torch.Tensor], anchors: torch.Tensor, sel: dict[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """The decode's inputs of a ``topk_indices`` selection, gathered from
    the (B, h, w, A, c) heads and the (N, 7) anchors: deltas/anchors
    (B, K, 7) and dir_bin (B, K), with the selection's scores and labels."""
    b = heads["box"].shape[0]
    idx = sel["top_idx"][..., None]
    dirs = heads["dir"].reshape(b, -1, heads["dir"].shape[-1])
    return {
        "deltas": torch.take_along_dim(heads["box"].reshape(b, -1, 7), idx, dim=1),
        "anchors": anchors[sel["top_idx"]],
        "dir_bin": torch.take_along_dim(dirs, idx, dim=1).argmax(-1),
        "scores": sel["scores"],
        "labels": sel["labels"],
    }


def decode_candidates(
    cand: dict[str, torch.Tensor], num_dir_bins: int, dir_offset: float
) -> dict[str, torch.Tensor]:
    """The unfused residual-decode tail over a ``topk_candidates`` set."""
    boxes = decode_residual(
        cand["deltas"], cand["anchors"], cand["dir_bin"], num_dir_bins, dir_offset
    )
    return {"boxes": boxes, "scores": cand["scores"], "labels": cand["labels"]}


class PillarVFE(nn.Module):
    """Pillar feature encoder: augment -> linear + BN + ReLU -> masked max.

    Augmented features: [x, y, z, i, x - xmean, y - ymean, z - zmean,
    x - xc, y - yc, z - zc] (10 for KITTI). ``forward`` takes the grouped
    (V, K, F) contract; ``encode`` is the per-point MLP alone, used by the
    scatter path."""

    def __init__(self, filters: int = 64, voxel: VoxelConfig = VoxelConfig(),
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.voxel = voxel
        self.dtype = dtype
        self.linear = nn.Linear(voxel.point_features + 6, filters, bias=False, dtype=dtype)
        self.bn = nn.BatchNorm1d(filters, eps=1e-3, dtype=dtype)

    def encode(self, feats: torch.Tensor) -> torch.Tensor:
        """(..., 10) augmented point features -> (..., filters) in the body's
        dtype."""
        x = self.linear(feats.to(self.dtype))
        return F.relu(self.bn(x.reshape(-1, x.shape[-1])).reshape(x.shape))

    def forward(
        self,
        voxels: torch.Tensor,      # (V, K, F>=4)
        num_points: torch.Tensor,  # (V,)
        coords: torch.Tensor,      # (V, 3) [z, y, x]
    ) -> torch.Tensor:
        k = voxels.shape[1]
        dev = voxels.device
        mask = (torch.arange(k, device=dev)[None, :] < num_points[:, None])[..., None]
        xyz = voxels[..., :3]
        cnt = torch.clamp(num_points, min=1)[:, None, None]
        mean = (xyz * mask).sum(1, keepdim=True) / cnt
        vs = values_on(self.voxel.voxel_size, torch.float32, dev)
        r0 = values_on(self.voxel.point_cloud_range[:3], torch.float32, dev)
        centers = (coords.flip(1).to(torch.float32) + 0.5) * vs + r0  # (V, 3) xyz
        feats = torch.cat(
            [voxels[..., : self.voxel.point_features], xyz - mean, xyz - centers[:, None, :]], -1
        )
        feats = torch.where(mask, feats, 0.0)
        x = self.encode(feats)
        x = torch.where(mask, x, float("-inf")).amax(1)  # (V, filters)
        return torch.where(num_points[:, None] > 0, x, 0.0)


def require_pillar_grid(grid_size: tuple[int, int, int]) -> None:
    """The scatter path merges z cells, so it needs nz == 1."""
    nz = grid_size[2]
    if nz != 1:
        raise ValueError(
            f"from_points is a pillar (nz == 1) path; this grid has nz={nz} — use the "
            "grouped voxelizer (vfe='grouped')"
        )


def pillar_sums(acc: torch.Tensor, vid: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``acc[vid[i]] += rows[i]``, each pillar summed in point order, the
    same every run. On CUDA ``index_put_(accumulate=True)`` sorts the ids
    (stably) and sums each run of equal ids in order; ``index_add_`` there
    adds with atomics in no fixed order. On the CPU ``index_add_`` adds
    serially, while ``index_put_`` adds from several threads past a few
    thousand rows."""
    if acc.is_cuda:
        return acc.index_put_((vid,), rows, accumulate=True)
    return acc.index_add_(0, vid, rows)


def augment_points(
    points: torch.Tensor,  # (N, F>=4) padded cloud [x, y, z, i, ...]
    count: torch.Tensor,   # () real rows
    voxel: VoxelConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-point pillar assignment and the 10-feature augmentation, the
    pillar mean taken by a scatter onto the grid. Returns (feats (N, 10),
    vid (N,) flat y*nx+x pillar id with ny*nx as the dump slot, valid
    (N,), cnt (ny*nx+1,) points per pillar)."""
    nx, ny, _ = voxel.grid_size
    dev = points.device
    r = values_on(voxel.point_cloud_range[:3], torch.float32, dev)
    vs = values_on(voxel.voxel_size, torch.float32, dev)
    xyz = points[:, :3]
    ijk, valid = assign_cells(points, count, voxel)
    dump = nx * ny
    vid = torch.where(valid, ijk[:, 1] * nx + ijk[:, 0], dump).long()
    w = valid.to(points.dtype)[:, None]
    # xyz sums and the count in one scatter (column 3 is the weight). The
    # invalid rows (padding, out of range) add zeros; each gets a dump slot
    # of its own past the grid, so that no single slot collects thousands
    # of them (pillar_sums sums each slot's rows one after another on CUDA)
    lane = torch.arange(points.shape[0], device=dev)
    slot = torch.where(valid, vid, dump + 1 + lane)
    acc = torch.zeros((dump + 1 + points.shape[0], 4), dtype=points.dtype, device=dev)
    pillar_sums(acc, slot, torch.cat([xyz, torch.ones_like(w)], 1) * w)
    per_point = acc[slot]
    mean = per_point[:, :3] / torch.clamp(per_point[:, 3:], min=1.0)
    centers = (ijk.to(torch.float32) + 0.5) * vs + r
    feats = torch.cat([points[:, : voxel.point_features], xyz - mean, xyz - centers], 1)
    return torch.where(valid[:, None], feats, 0.0), vid, valid, acc[: dump + 1, 3]


def scatter_max_canvas(
    x: torch.Tensor,      # (N, C) per-point features, NON-NEGATIVE
    vid: torch.Tensor,    # (N,) flat y*nx+x pillar id (ny*nx = dump)
    valid: torch.Tensor,  # (N,)
    grid_hw: tuple[int, int],
) -> torch.Tensor:
    """Pillar max onto a zero (H, W, C) canvas of ``x``'s dtype. ``x`` is
    post-ReLU, so a max onto zeros equals the -inf fill + ``count > 0``
    formulation."""
    h, w = grid_hw
    c = x.shape[-1]
    vid = torch.where(valid, vid, h * w)
    canvas = torch.zeros((h * w + 1, c), dtype=x.dtype, device=x.device)
    canvas.scatter_reduce_(0, vid[:, None].expand(-1, c), x, reduce="amax", include_self=True)
    return canvas[: h * w].reshape(h, w, c)


def scatter_to_bev(
    pillar_feats: torch.Tensor,  # (V, C)
    coords: torch.Tensor,        # (V, 3) [z, y, x], -1 invalid
    grid_hw: tuple[int, int],
) -> torch.Tensor:
    """Dense (H=ny, W=nx, C) canvas of the features' dtype; invalid pillars
    land in a dump row that is sliced off (OpenPCDet's PointPillarScatter)."""
    h, w = grid_hw
    c = pillar_feats.shape[-1]
    yy, xx = coords[:, 1].long(), coords[:, 2].long()
    flat = torch.where((yy >= 0) & (xx >= 0), yy * w + xx, h * w)
    canvas = torch.zeros((h * w + 1, c), dtype=pillar_feats.dtype, device=pillar_feats.device)
    canvas[flat] = pillar_feats  # live pillars are unique
    return canvas[: h * w].reshape(h, w, c)


class BEVBackbone(nn.Module):
    """Multi-scale 2D CNN over the BEV canvas, each scale up-sampled by a
    transposed conv and concatenated (NCHW in, NCHW out). Duck-typed on
    the config's backbone fields, so SECOND shares it; ``in_channels`` is
    the canvas width (PointPillars' VFE filters, SECOND's folded z). Every
    layer holds its tensors in ``dtype``."""

    def __init__(self, cfg: PointPillarsConfig, in_channels: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.cfg = cfg
        cin = in_channels
        for bi, (n_layers, stride, filters, up_stride, up_filters) in enumerate(
            zip(
                cfg.backbone_layers,
                cfg.backbone_strides,
                cfg.backbone_filters,
                cfg.upsample_strides,
                cfg.upsample_filters,
            )
        ):
            self.add_module(
                f"block{bi}_down", nn.Conv2d(cin, filters, 3, stride=stride, padding=1, bias=False)
            )
            self.add_module(f"block{bi}_down_bn", nn.BatchNorm2d(filters, eps=1e-3))
            for li in range(n_layers):
                self.add_module(
                    f"block{bi}_conv{li}", nn.Conv2d(filters, filters, 3, padding=1, bias=False)
                )
                self.add_module(f"block{bi}_bn{li}", nn.BatchNorm2d(filters, eps=1e-3))
            self.add_module(
                f"up{bi}",
                nn.ConvTranspose2d(filters, up_filters, up_stride, stride=up_stride, bias=False),
            )
            self.add_module(f"up{bi}_bn", nn.BatchNorm2d(up_filters, eps=1e-3))
            cin = filters
        self.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ups = []
        for bi, n_layers in enumerate(self.cfg.backbone_layers):
            m = self._modules
            x = F.relu(m[f"block{bi}_down_bn"](m[f"block{bi}_down"](x)))
            for li in range(n_layers):
                x = F.relu(m[f"block{bi}_bn{li}"](m[f"block{bi}_conv{li}"](x)))
            ups.append(F.relu(m[f"up{bi}_bn"](m[f"up{bi}"](x))))
        return torch.cat(ups, 1)


class PointPillars(nn.Module):
    """VFE -> scatter -> backbone -> anchor head. ``forward`` takes the
    grouped voxels (batched), ``from_points`` one padded cloud; both
    return the raw heads, float32. ``dtype``: the body's (module
    docstring)."""

    def __init__(self, cfg: PointPillarsConfig = PointPillarsConfig(),
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.dtype = dtype
        self.vfe = PillarVFE(cfg.vfe_filters, cfg.voxel, dtype)
        self.backbone = BEVBackbone(cfg, cfg.vfe_filters, dtype)
        a, c = cfg.anchors_per_loc, sum(cfg.upsample_filters)
        self.cls_head = nn.Conv2d(c, a * cfg.num_classes, 1)
        self.box_head = nn.Conv2d(c, a * 7, 1)
        self.dir_head = nn.Conv2d(c, a * cfg.num_dir_bins, 1)
        # (h*w*A, 7), on the model's device: built once, not per scan
        self.register_buffer("anchors", generate_anchors(cfg).reshape(-1, 7), persistent=False)

    def forward(
        self,
        voxels: torch.Tensor,      # (B, V, K, F)
        num_points: torch.Tensor,  # (B, V)
        coords: torch.Tensor,      # (B, V, 3)
    ) -> dict[str, torch.Tensor]:
        nx, ny, _ = self.cfg.voxel.grid_size
        b, v, k, f = voxels.shape
        # one VFE call over all B*V pillars (the per-pillar math is
        # batch-independent)
        feats = self.vfe(
            voxels.reshape(b * v, k, f), num_points.reshape(b * v), coords.reshape(b * v, 3)
        ).reshape(b, v, -1)
        canvas = torch.stack([scatter_to_bev(feats[i], coords[i], (ny, nx)) for i in range(b)])
        return self._heads(canvas)

    def from_points(self, points: torch.Tensor, count: torch.Tensor) -> dict[str, torch.Tensor]:
        """Sort-free scatter path, batch 1. Equals ``voxelize`` + ``forward``
        while the voxelizer's budgets are not hit; past them it keeps every
        point and pillar."""
        require_pillar_grid(self.cfg.voxel.grid_size)
        nx, ny, _ = self.cfg.voxel.grid_size
        feats, vid, valid, _ = augment_points(points, count, self.cfg.voxel)
        canvas = scatter_max_canvas(self.vfe.encode(feats), vid, valid, (ny, nx))
        return self._heads(canvas[None])

    def _heads(self, canvas: torch.Tensor) -> dict[str, torch.Tensor]:
        """(B, ny, nx, C) NHWC canvas -> heads (B, h, w, A, c)."""
        cfg = self.cfg
        spatial = self.backbone(canvas.permute(0, 3, 1, 2)).to(torch.float32)
        a = cfg.anchors_per_loc

        def head(conv, c):
            out = conv_f32(conv, spatial).permute(0, 2, 3, 1)
            b, h, w, _ = out.shape
            return out.reshape(b, h, w, a, c)

        return {
            "cls": head(self.cls_head, cfg.num_classes),
            "box": head(self.box_head, 7),
            "dir": head(self.dir_head, cfg.num_dir_bins),
        }

    def topk_indices(
        self, heads: dict[str, torch.Tensor], pre_max: int = 512, score_thresh: float = 0.1
    ) -> dict[str, torch.Tensor]:
        """Gate + top-k on the raw class logits, before any box decode and
        without gathering the decode's inputs: top_idx (B, K) int64 anchor
        indices, scores (B, K) -inf where gated out, labels (B, K)
        1-indexed. Top-k is a stable sort (ties in ascending index order,
        as ``jax.lax.top_k``); the class argmax takes the first maximum.
        The fused route decodes through ``top_idx`` in one launch
        (``ops/gpu_decode3d.gather_residual_decode``)."""
        b, h, w, a, nc = heads["cls"].shape
        n = h * w * a
        cls = heads["cls"].reshape(b, n, nc)
        top_logits, top_idx = stable_top_k(cls.amax(-1), min(pre_max, n))
        scores = torch.sigmoid(top_logits)
        thresh = scalar_on(score_thresh, torch.float32, scores.device)
        return {
            "top_idx": top_idx,
            "scores": torch.where(scores > thresh, scores, float("-inf")),
            "labels": torch.take_along_dim(cls, top_idx[..., None], dim=1).argmax(-1) + 1,
        }

    def topk_candidates(
        self, heads: dict[str, torch.Tensor], pre_max: int = 512, score_thresh: float = 0.1
    ) -> dict[str, torch.Tensor]:
        """``topk_indices``, then the gathers of the decode's inputs:
        deltas/anchors (B, K, 7), dir_bin (B, K) (the first maximum of the
        direction logits), scores (B, K) -inf where gated out, labels
        (B, K) 1-indexed."""
        return gather_candidates(
            heads, self.anchors, self.topk_indices(heads, pre_max, score_thresh)
        )

    def decode_topk(
        self, heads: dict[str, torch.Tensor], pre_max: int = 512, score_thresh: float = 0.1
    ) -> dict[str, torch.Tensor]:
        """``topk_candidates``, then the unfused decode of the K survivors:
        boxes (B, K, 7), scores (B, K), labels (B, K)."""
        cand = self.topk_candidates(heads, pre_max, score_thresh)
        return decode_candidates(cand, self.cfg.num_dir_bins, self.cfg.dir_offset)

    def decode(self, heads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Raw heads -> every anchor decoded: boxes (B, N, 7) with rectified
        headings, scores (B, N, num_classes) sigmoid."""
        cfg = self.cfg
        boxes = decode_residual(
            heads["box"], self.anchors.reshape(heads["box"].shape[1:]),
            heads["dir"].argmax(-1), cfg.num_dir_bins, cfg.dir_offset,
        )
        b = boxes.shape[0]
        return {
            "boxes": boxes.reshape(b, -1, 7),
            "scores": torch.sigmoid(heads["cls"]).reshape(b, -1, cfg.num_classes),
        }
