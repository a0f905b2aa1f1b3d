"""SECOND-IoU with the dense middle encoder as an ``nn.Module`` (port of
``models/second.py``, the dense parts).

Mean VFE -> dense (nz, ny, nx, F) mean volume -> three 3x3x3 conv stages
(the later two stride 2) -> z folded into channels -> the PointPillars
BEV backbone -> anchor heads plus a per-anchor IoU-quality head, whose
prediction rectifies the class score: ``score = cls^(1-a) * q^a``. The
settings are the reference's ``examples/second_iou``
(``data/kitti_second.yaml``) on the JAX package's coarser 0.2 x 0.2 x
0.4 m grid (352 x 400 x 10), where the dense volume fits in memory.

Public functions keep the JAX package's layouts: volumes are
(nz, ny, nx, F) or (B, nz, ny, nx, F), heads (B, h, w, A, c); the
convolutions run NCDHW / NCHW inside. The z fold puts channel
``d * C + c``, as the JAX ``transpose(x, (1, 2, 0, 3))`` does.
Submodules carry the flax names (``middle.conv0``, ``middle.bn0``,
``backbone.block0_down``, ``iou_head``, ...), so
``models/convert.second_state_dict_from_flax`` maps by path.

Three ways in over the same weights: ``forward`` takes the grouped
(V, K, F) voxel contract, ``from_points`` the sort-free scatter of one
padded cloud (every occupied cell kept), ``from_volume`` a mean volume
built elsewhere (the fused stage, ``ops/gpu_voxel.fused_mean_volume``,
which caps cells at ``max_voxels``). The sparse middle encoder and the
training path are not ported.

``dtype`` is the body's compute dtype, as in the JAX module: the mean VFE
and the mean volume stay float32 up to the middle encoder, which casts the
volume to ``dtype`` and runs its Conv3d and BatchNorm3d stages in it, as
does the shared BEV backbone; the four heads, ``iou_head`` included,
compute in float32 on float32 features.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from triton_client_tpu_torch.device import scalar_on
from triton_client_tpu_torch.models.pointpillars import (
    KITTI_ANCHORS,
    ROTATIONS,
    AnchorClassConfig,
    BEVBackbone,
    decode_candidates,
    decode_residual,
    gather_candidates,
    generate_anchors,
    pillar_sums,
    validate_bev_divisible,
)
from triton_client_tpu_torch.models.layers import conv_f32
from triton_client_tpu_torch.ops.detect_postprocess import stable_top_k
from triton_client_tpu_torch.ops.voxelize import VoxelConfig, assign_cells, linearize_zyx


@dataclasses.dataclass(frozen=True)
class SECONDConfig:
    voxel: VoxelConfig = VoxelConfig(
        point_cloud_range=(0.0, -40.0, -3.0, 70.4, 40.0, 1.0),
        voxel_size=(0.2, 0.2, 0.4),
        max_voxels=40000,  # the KITTI test budget
        max_points_per_voxel=5,
    )
    middle_filters: tuple[int, ...] = (16, 32, 64)
    # "dense" only: the sparse middle of the JAX package is not ported
    middle: str = "dense"
    # BEVBackbone fields, duck-typed as PointPillarsConfig's
    backbone_layers: tuple[int, ...] = (5, 5)
    backbone_strides: tuple[int, ...] = (1, 2)
    backbone_filters: tuple[int, ...] = (128, 256)
    upsample_strides: tuple[int, ...] = (1, 2)
    upsample_filters: tuple[int, ...] = (256, 256)
    anchor_classes: tuple[AnchorClassConfig, ...] = KITTI_ANCHORS
    num_dir_bins: int = 2
    dir_offset: float = 0.78539
    # score rectification exponent (OpenPCDet's IOU_RECTIFIER)
    iou_alpha: float = 0.71

    @property
    def num_classes(self) -> int:
        return len(self.anchor_classes)

    @property
    def anchors_per_loc(self) -> int:
        return len(self.anchor_classes) * len(ROTATIONS)

    @property
    def middle_stride(self) -> int:
        """BEV downsample of the middle encoder: 2 per stage after the first."""
        return 2 ** max(0, len(self.middle_filters) - 1)

    @property
    def middle_depth(self) -> int:
        """nz after the middle encoder: each stride-2 stage (kernel 3,
        padding 1) maps d to (d - 1) // 2 + 1."""
        d = self.voxel.grid_size[2]
        for _ in self.middle_filters[1:]:
            d = (d - 1) // 2 + 1
        return d

    @property
    def bev_channels(self) -> int:
        """Width of the folded BEV canvas: depth x last middle filters."""
        return self.middle_depth * self.middle_filters[-1]

    @property
    def head_stride(self) -> int:
        return self.middle_stride * (self.backbone_strides[0] // self.upsample_strides[0])

    @property
    def head_hw(self) -> tuple[int, int]:
        nx, ny, _ = self.voxel.grid_size
        s = self.head_stride
        return ny // s, nx // s

    def validate(self) -> None:
        if self.middle == "sparse":
            raise NotImplementedError(
                "the sparse middle encoder is not ported yet (ROADMAP Queue 1 item 5); "
                "use middle='dense'"
            )
        if self.middle != "dense":
            raise ValueError(
                f"SECONDConfig.middle must be 'dense' or 'sparse', got {self.middle!r}"
            )
        validate_bev_divisible(self.voxel, self.middle_stride * int(np.prod(self.backbone_strides)))


def scatter_mean_volume(
    points: torch.Tensor, count: torch.Tensor, voxel: VoxelConfig
) -> torch.Tensor:
    """(N, F) padded cloud -> dense (nz, ny, nx, F) per-cell mean volume,
    every occupied cell kept: the unfused route. One scatter-add carries
    the feature sums and the count (last column the point's weight), each
    cell summed in point order on both devices (``pillar_sums``). Invalid
    rows add zeros, each to a dump slot of its own past the grid, so no
    slot collects the padding."""
    nx, ny, nz = voxel.grid_size
    n, f = points.shape
    ijk, valid = assign_cells(points, count, voxel)
    vid, n_cells = linearize_zyx(ijk, valid, voxel)
    lane = torch.arange(n, device=points.device)
    slot = torch.where(valid, vid.long(), n_cells + lane)
    w = valid.to(points.dtype)[:, None]
    acc = torch.zeros((n_cells + n, f + 1), dtype=points.dtype, device=points.device)
    pillar_sums(acc, slot, torch.cat([points, torch.ones_like(w)], 1) * w)
    volume = acc[:n_cells, :f] / torch.clamp(acc[:n_cells, f:], min=1.0)
    return volume.reshape(nz, ny, nx, f)


def scatter_to_volume(
    voxel_feats: torch.Tensor,  # (V, C)
    coords: torch.Tensor,       # (V, 3) [z, y, x], -1 invalid
    grid_dhw: tuple[int, int, int],
) -> torch.Tensor:
    """Dense (nz, ny, nx, C) volume of per-voxel features; invalid voxels
    land in a dump row that is sliced off."""
    d, h, w = grid_dhw
    c = voxel_feats.shape[-1]
    zz, yy, xx = (coords[:, i].long() for i in range(3))
    flat = torch.where((zz >= 0) & (yy >= 0) & (xx >= 0), (zz * h + yy) * w + xx, d * h * w)
    canvas = torch.zeros((d * h * w + 1, c), dtype=voxel_feats.dtype, device=voxel_feats.device)
    canvas[flat] = voxel_feats  # live voxels are unique
    return canvas[: d * h * w].reshape(d, h, w, c)


class MeanVFE(nn.Module):
    """Per-voxel mean of the raw point features (OpenPCDet's MeanVFE)."""

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor) -> torch.Tensor:
        k = voxels.shape[1]
        mask = (torch.arange(k, device=voxels.device)[None, :] < num_points[:, None])[..., None]
        cnt = torch.clamp(num_points, min=1)[:, None].to(voxels.dtype)
        return (voxels * mask).sum(1) / cnt


class DenseMiddleEncoder(nn.Module):
    """3x3x3 conv + BatchNorm + ReLU stages over the dense volume (stride 1,
    then 2), then z folded into channels; in ``dtype`` from the volume's
    cast on."""

    def __init__(self, in_channels: int, filters: tuple[int, ...],
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.filters = filters
        self.dtype = dtype
        cin = in_channels
        for si, f in enumerate(filters):
            stride = 2 if si > 0 else 1
            self.add_module(f"conv{si}", nn.Conv3d(cin, f, 3, stride=stride, padding=1, bias=False))
            self.add_module(f"bn{si}", nn.BatchNorm3d(f, eps=1e-3))
            cin = f
        self.to(dtype)

    def forward(self, volume: torch.Tensor) -> torch.Tensor:
        """(B, nz, ny, nx, F) volume -> (B, D*C, H, W) NCHW BEV canvas with
        channel d*C + c."""
        x = volume.to(self.dtype).permute(0, 4, 1, 2, 3)  # NCDHW
        m = self._modules
        for si in range(len(self.filters)):
            x = F.relu(m[f"bn{si}"](m[f"conv{si}"](x)))
        b, c, d, h, w = x.shape
        return x.permute(0, 2, 1, 3, 4).reshape(b, d * c, h, w)


class SECONDIoU(nn.Module):
    """Mean VFE -> dense volume -> middle encoder -> BEV backbone -> anchor
    and IoU-quality heads. ``dtype``: the body's (module docstring)."""

    # the mean VFE keys on the full 3D cell, so the scatter path holds on
    # tall (nz > 1) grids, where the pillar models' does not
    scatter_any_nz = True

    def __init__(self, cfg: SECONDConfig = SECONDConfig(),
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.dtype = dtype
        self.vfe = MeanVFE()
        self.middle = DenseMiddleEncoder(cfg.voxel.point_features, cfg.middle_filters, dtype)
        self.backbone = BEVBackbone(cfg, cfg.bev_channels, dtype)
        a, c = cfg.anchors_per_loc, sum(cfg.upsample_filters)
        self.cls_head = nn.Conv2d(c, a * cfg.num_classes, 1)
        self.box_head = nn.Conv2d(c, a * 7, 1)
        self.dir_head = nn.Conv2d(c, a * cfg.num_dir_bins, 1)
        self.iou_head = nn.Conv2d(c, a, 1)
        # (h*w*A, 7), on the model's device: built once, not per scan
        self.register_buffer("anchors", generate_anchors(cfg).reshape(-1, 7), persistent=False)

    def forward(
        self,
        voxels: torch.Tensor,      # (B, V, K, F)
        num_points: torch.Tensor,  # (B, V)
        coords: torch.Tensor,      # (B, V, 3) [z, y, x]
    ) -> dict[str, torch.Tensor]:
        """The grouped voxel contract: mean VFE, then the volume."""
        nx, ny, nz = self.cfg.voxel.grid_size
        b, v, k, f = voxels.shape
        feats = self.vfe(voxels.reshape(b * v, k, f), num_points.reshape(b * v)).reshape(b, v, f)
        volume = torch.stack(
            [scatter_to_volume(feats[i], coords[i], (nz, ny, nx)) for i in range(b)]
        )
        return self._heads(volume)

    def from_points(self, points: torch.Tensor, count: torch.Tensor) -> dict[str, torch.Tensor]:
        """Sort-free scatter path, batch 1: every occupied cell kept."""
        return self._heads(scatter_mean_volume(points, count, self.cfg.voxel)[None])

    def from_volume(self, volume: torch.Tensor) -> dict[str, torch.Tensor]:
        """A (nz, ny, nx, F) mean volume built elsewhere, batch 1."""
        return self._heads(volume[None])

    def _heads(self, volume: torch.Tensor) -> dict[str, torch.Tensor]:
        """(B, nz, ny, nx, F) volume -> heads (B, h, w, A, c); iou (B, h, w, A)."""
        cfg = self.cfg
        spatial = self.backbone(self.middle(volume)).to(torch.float32)
        a = cfg.anchors_per_loc

        def head(conv, *c):
            out = conv_f32(conv, spatial).permute(0, 2, 3, 1)
            b, h, w, _ = out.shape
            return out.reshape(b, h, w, a, *c)

        return {
            "cls": head(self.cls_head, cfg.num_classes),
            "box": head(self.box_head, 7),
            "dir": head(self.dir_head, cfg.num_dir_bins),
            "iou": head(self.iou_head),
        }

    def rectified_scores(self, heads: dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, h, w, A, nc) ``sigmoid(cls)^(1-a) * q^a`` with the IoU
        quality ``q = clip((clip(iou, -1, 1) + 1) / 2, 1e-6, 1)``."""
        q = torch.clamp((torch.clamp(heads["iou"], -1.0, 1.0) + 1.0) / 2.0, 1e-6, 1.0)
        al = self.cfg.iou_alpha
        return torch.sigmoid(heads["cls"]) ** (1.0 - al) * q[..., None] ** al

    def topk_indices(
        self, heads: dict[str, torch.Tensor], pre_max: int = 512, score_thresh: float = 0.1
    ) -> dict[str, torch.Tensor]:
        """Gate + top-k on the rectified score, before any box decode and
        without gathering the decode's inputs: top_idx (B, K) int64 anchor
        indices, scores (B, K) -inf where gated out, labels (B, K)
        1-indexed. The rectified score is not monotonic in the class logit
        alone, so it is computed over every anchor; only the box decode
        waits for the K survivors. Top-k is a stable sort and the argmaxes
        take the first maximum, as in JAX."""
        b, h, w, a, nc = heads["cls"].shape
        n = h * w * a
        score = self.rectified_scores(heads).reshape(b, n, nc)
        best = score.amax(-1)
        labels = score.argmax(-1) + 1
        top_scores, top_idx = stable_top_k(best, min(pre_max, n))
        thresh = scalar_on(score_thresh, torch.float32, best.device)
        return {
            "top_idx": top_idx,
            "scores": torch.where(top_scores > thresh, top_scores, float("-inf")),
            "labels": torch.take_along_dim(labels, top_idx, dim=1),
        }

    def topk_candidates(
        self, heads: dict[str, torch.Tensor], pre_max: int = 512, score_thresh: float = 0.1
    ) -> dict[str, torch.Tensor]:
        """``topk_indices``, then the gathers of the decode's inputs:
        deltas/anchors (B, K, 7), dir_bin (B, K), scores (B, K) -inf where
        gated out, labels (B, K) 1-indexed."""
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
        headings, rectified scores (B, N, num_classes)."""
        cfg = self.cfg
        boxes = decode_residual(
            heads["box"], self.anchors.reshape(heads["box"].shape[1:]),
            heads["dir"].argmax(-1), cfg.num_dir_bins, cfg.dir_offset,
        )
        b = boxes.shape[0]
        return {
            "boxes": boxes.reshape(b, -1, 7),
            "scores": self.rectified_scores(heads).reshape(b, -1, cfg.num_classes),
        }
