"""SECOND-IoU as an ``nn.Module`` (port of ``models/second.py``), with
either middle encoder.

Mean VFE -> middle encoder -> z folded into channels -> the PointPillars
BEV backbone -> anchor heads plus a per-anchor IoU-quality head, whose
prediction rectifies the class score: ``score = cls^(1-a) * q^a``. Two
middle encoders, as in the JAX package:

  * ``middle="dense"``: a dense (nz, ny, nx, F) mean volume and 3x3x3 conv
    stages (the later ones stride 2). The settings are the reference's
    ``examples/second_iou`` (``data/kitti_second.yaml``) on the JAX
    package's coarser 0.2 x 0.2 x 0.4 m grid (352 x 400 x 10), where the
    dense volume fits in memory;
  * ``middle="sparse"``: the reference's own 0.05 m grid (1408 x 1600 x
    40, ``data/kitti_second_sparse005.yaml``) through
    ``ops/sparse_conv.py``: a submanifold stage, then stride-2 sparse
    stages over fixed occupancy budgets, and from
    ``sparse_dense_tail_from`` on a densified level and real stride-2 3D
    convs (:class:`SparseMiddleEncoder`).

Public functions keep the JAX package's layouts: volumes are
(nz, ny, nx, F) or (B, nz, ny, nx, F), heads (B, h, w, A, c); the
convolutions run NCDHW / NCHW inside. The z fold puts channel
``d * C + c``, as the JAX ``transpose(x, (1, 2, 0, 3))`` does.
Submodules carry the flax names (``middle.conv0``, ``middle.bn0``,
``backbone.block0_down``, ``iou_head``, ...), so
``models/convert.second_state_dict_from_flax`` maps by path.

Three ways in over the same weights: ``forward`` takes the grouped
(V, K, F) voxel contract, ``from_points`` one padded cloud (the dense
middle: the sort-free scatter, every occupied cell kept; the sparse one:
``points_to_voxelset``, the ``sparse_budget`` lowest cells kept),
``from_volume`` a mean volume built elsewhere (the fused stage,
``ops/gpu_voxel.fused_mean_volume``, which caps cells at ``max_voxels``;
dense middle only). The training path is not ported.

``dtype`` is the body's compute dtype, as in the JAX module: the mean VFE
and the mean volume (or the voxel set's features) stay float32 up to the
middle encoder, which casts them to ``dtype`` and runs its stages in it, as
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
from triton_client_tpu_torch.models.layers import GemmConv2d, conv_f32
from triton_client_tpu_torch.ops import sparse_conv as sp
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
    # "dense" (stride-2 3D convs over the densified volume: a coarse grid)
    # or "sparse" (submanifold gather convs over a fixed occupancy budget,
    # ops/sparse_conv.py: the reference's 0.05 m grid)
    middle: str = "dense"
    # sparse: occupied voxels kept at level 0 (0 -> voxel.max_voxels);
    # each later level halves it, to no less than 8192
    sparse_budget: int = 0
    # sparse: densify from this stage on and run real 3D convs (stage i
    # reads level i - 1); 0: no dense tail
    sparse_dense_tail_from: int = 0
    # sparse: the strided stages' kernel, 2 (2^3 offsets) or 3 (spconv's 3^3)
    sparse_stride_kernel: int = 2
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
        if self.middle not in ("dense", "sparse"):
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


class SparseConv3d(nn.Module):
    """The weight of one sparse stage, (k^3, Cin, Cout) in the JAX
    package's layout (the first axis in ``ops/sparse_conv.kernel_offsets``
    order), and its conv: submanifold without a budget, stride 2 with one.
    ``weight_out_axis`` tells ``models/convert`` that the flax leaf carries
    across as it is and ``runtime/precision`` which axis is the output
    channel."""

    weight_out_axis = -1

    def __init__(self, k3: int, cin: int, cout: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(k3, cin, cout))

    def init_random_(self, gen: torch.Generator) -> None:
        """Seeded weights as flax's ``he_normal`` draws them: N(0, 2/fan_in),
        fan_in = k^3 * Cin (the moments; ``models/layers.init_random_``)."""
        w = self.weight
        w.copy_(torch.randn(w.shape, generator=gen) * (2.0 / w[:, :, 0].numel()) ** 0.5)

    def forward(self, vs: sp.VoxelSet, table: torch.Tensor, budget: int | None = None
                ) -> sp.VoxelSet:
        if budget is None:
            return vs._replace(feats=sp.subm_conv(vs, table, self.weight))
        return sp.sparse_strided_conv(vs, table, self.weight, budget)


class SparseMiddleEncoder(nn.Module):
    """The sparse sibling of :class:`DenseMiddleEncoder` (JAX
    ``SparseMiddleEncoder``): stage 0 a submanifold conv, each later stage
    a stride-2 sparse conv whose budget halves (to no less than 8192),
    each followed by BatchNorm (eps 1e-3) and ReLU with the padding rows
    set to 0; from ``dense_tail_from`` on the level is densified and the
    stages are stride-2 3x3x3 ``Conv3d`` (NCDHW inside). A level's slot
    table is built once and serves every stage that reads the level. Ends
    in the same z fold, channel ``d * C + c``."""

    def __init__(self, in_channels: int, filters: tuple[int, ...], grid: tuple[int, int, int],
                 budget: int, dense_tail_from: int = 0, stride_kernel: int = 2,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.filters, self.grid, self.budget = filters, grid, budget
        self.dense_tail_from = dense_tail_from
        self.dtype = dtype
        cin, dense = in_channels, False
        for si, f in enumerate(filters):
            if dense:
                self.add_module(f"conv{si}", nn.Conv3d(cin, f, 3, stride=2, padding=1,
                                                       bias=False))
                self.add_module(f"bn{si}", nn.BatchNorm3d(f, eps=1e-3))
            else:
                k3 = 27 if si == 0 else stride_kernel**3
                self.add_module(f"conv{si}", SparseConv3d(k3, cin, f))
                self.add_module(f"bn{si}", nn.BatchNorm1d(f, eps=1e-3))
            dense = dense or self._densify_after(si)
            cin = f
        self.to(dtype)

    def _densify_after(self, si: int) -> bool:
        return bool(self.dense_tail_from) and self.dense_tail_from <= si + 1 < len(self.filters)

    def forward(self, ijk: torch.Tensor, feats: torch.Tensor, valid: torch.Tensor
                ) -> torch.Tensor:
        """One sample's voxels, ijk (V, 3) [z, y, x], feats (V, F), valid (V,)
        -> (1, D*C, H, W) NCHW BEV canvas with channel d*C + c."""
        m = self._modules
        vs = sp.VoxelSet(ijk.to(torch.int32), feats.to(self.dtype), valid, self.grid)
        budget, table, volume = self.budget, None, None
        for si in range(len(self.filters)):
            conv, bn = m[f"conv{si}"], m[f"bn{si}"]
            if volume is not None:  # a dense tail stage
                volume = F.relu(bn(conv(volume)))
                continue
            if table is None:
                table = sp.slot_table(vs)
            if si == 0:
                vs = conv(vs, table)
            else:
                budget = max(budget // 2, 8192)
                vs, table = conv(vs, table, budget), None  # a new level
            vs = vs._replace(feats=torch.where(vs.valid[:, None], F.relu(bn(vs.feats)), 0.0))
            if self._densify_after(si):
                volume = sp.densify(vs).permute(3, 0, 1, 2)[None]  # NCDHW
        if volume is None:
            volume = sp.densify(vs).permute(3, 0, 1, 2)[None]
        b, c, d, h, w = volume.shape
        return volume.permute(0, 2, 1, 3, 4).reshape(b, d * c, h, w)


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
        if cfg.middle == "sparse":
            nx, ny, nz = cfg.voxel.grid_size
            self.middle = SparseMiddleEncoder(
                cfg.voxel.point_features, cfg.middle_filters, (nz, ny, nx), self.sparse_budget,
                cfg.sparse_dense_tail_from, cfg.sparse_stride_kernel, dtype,
            )
        else:
            self.middle = DenseMiddleEncoder(cfg.voxel.point_features, cfg.middle_filters, dtype)
        self.backbone = BEVBackbone(cfg, cfg.bev_channels, dtype)
        if cfg.middle == "sparse":
            # the first BEV conv of the 0.05 m grid (320 channels in, 200 x
            # 176, fp32 with TF32 off): cuDNN's heuristics pick, from call to
            # call, an FFT engine (146 of a request's 182 device ms on an
            # H100, chip_smoke.py phase 34) or an implicit GEMM, so a captured
            # replay and an eager call ran different algorithms (1 ulp apart)
            down = self.backbone.block0_down
            self.backbone.block0_down = GemmConv2d(
                down.in_channels, down.out_channels, 3, stride=down.stride, padding=1,
                bias=False).to(dtype)
        a, c = cfg.anchors_per_loc, sum(cfg.upsample_filters)
        self.cls_head = nn.Conv2d(c, a * cfg.num_classes, 1)
        self.box_head = nn.Conv2d(c, a * 7, 1)
        self.dir_head = nn.Conv2d(c, a * cfg.num_dir_bins, 1)
        self.iou_head = nn.Conv2d(c, a, 1)
        # (h*w*A, 7), on the model's device: built once, not per scan
        self.register_buffer("anchors", generate_anchors(cfg).reshape(-1, 7), persistent=False)

    @property
    def sparse_budget(self) -> int:
        """Occupied voxels the sparse middle keeps at level 0."""
        return self.cfg.sparse_budget or self.cfg.voxel.max_voxels

    def forward(
        self,
        voxels: torch.Tensor,      # (B, V, K, F)
        num_points: torch.Tensor,  # (B, V)
        coords: torch.Tensor,      # (B, V, 3) [z, y, x]
    ) -> dict[str, torch.Tensor]:
        """The grouped voxel contract: mean VFE, then the volume (dense
        middle) or each sample's voxel set (sparse; valid where z >= 0)."""
        nx, ny, nz = self.cfg.voxel.grid_size
        b, v, k, f = voxels.shape
        feats = self.vfe(voxels.reshape(b * v, k, f), num_points.reshape(b * v)).reshape(b, v, f)
        if self.cfg.middle == "sparse":
            valid = coords[..., 0] >= 0
            return self._heads_from_bev(
                torch.cat([self.middle(coords[i], feats[i], valid[i]) for i in range(b)]))
        volume = torch.stack(
            [scatter_to_volume(feats[i], coords[i], (nz, ny, nx)) for i in range(b)]
        )
        return self._heads_from_bev(self.middle(volume))

    def from_points(self, points: torch.Tensor, count: torch.Tensor) -> dict[str, torch.Tensor]:
        """One padded cloud, batch 1: the sort-free scatter (dense middle,
        every occupied cell kept) or the sparse mean VFE (the
        ``sparse_budget`` lowest cells kept)."""
        if self.cfg.middle == "sparse":
            vs = sp.points_to_voxelset(points, count, self.cfg.voxel, self.sparse_budget)
            return self._heads_from_bev(self.middle(vs.ijk, vs.feats, vs.valid))
        return self._heads_from_bev(
            self.middle(scatter_mean_volume(points, count, self.cfg.voxel)[None]))

    def from_volume(self, volume: torch.Tensor) -> dict[str, torch.Tensor]:
        """A (nz, ny, nx, F) mean volume built elsewhere, batch 1 (dense
        middle only)."""
        if self.cfg.middle == "sparse":
            raise ValueError("from_volume requires the dense middle encoder")
        return self._heads_from_bev(self.middle(volume[None]))

    def _heads_from_bev(self, bev: torch.Tensor) -> dict[str, torch.Tensor]:
        """(B, C, H, W) BEV canvas -> heads (B, h, w, A, c); iou (B, h, w, A)."""
        cfg = self.cfg
        spatial = self.backbone(bev).to(torch.float32)
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
