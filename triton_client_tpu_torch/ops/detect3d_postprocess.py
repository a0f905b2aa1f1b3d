"""3D detection postprocess: per-anchor predictions -> packed detections
(port of ``ops/detect3d_postprocess.py``).

Score gate + top-k prefilter + rotated-BEV NMS, fixed shapes
throughout; rows are [x, y, z, dx, dy, dz, heading, extras..., score,
label] with 1-indexed labels (the OpenPCDet convention). The JAX code
vmaps a single-image tail; here the batch is a leading dimension.

``fused=True`` sends suppression + packing through one kernel launch
(``ops/gpu_suppress3d.fused_suppress_pack_3d``); the unfused route is
``nms_bev`` (the greedy fixpoint) + gathers. The two keep the same rows,
equal by value: the fused rows carry +0.0 where the gathered rows may
carry -0.0 (compare them as ``torch.equal`` does).
"""

from __future__ import annotations

import torch

from triton_client_tpu_torch.device import scalar_on
from triton_client_tpu_torch.ops.boxes3d import nms_bev
from triton_client_tpu_torch.ops.detect_postprocess import stable_top_k
from triton_client_tpu_torch.ops.gpu_suppress3d import fused_suppress_pack_3d


def extract_boxes_3d(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    score_thresh: float = 0.1,
    iou_thresh: float = 0.01,
    max_det: int = 128,
    pre_max: int = 512,
    fused: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """boxes (B, N, 7+e), scores (B, N, nc) -> (detections (B, max_det,
    9+e), valid (B, max_det)). Columns past the canonical 7 ride along;
    the NMS geometry reads the first 7."""
    cls_score = scores.amax(-1)
    label = scores.argmax(-1) + 1
    thresh = scalar_on(score_thresh, torch.float32, scores.device)
    gated = torch.where(cls_score > thresh, cls_score, float("-inf"))
    top_scores, top_idx = stable_top_k(gated, min(pre_max, gated.shape[-1]))
    return nms_pack_3d(
        torch.take_along_dim(boxes, top_idx[..., None], dim=1),
        top_scores,
        label.gather(1, top_idx),
        iou_thresh,
        max_det,
        fused,
    )


def nms_pack_3d(
    cand_boxes: torch.Tensor,
    cand_scores: torch.Tensor,
    cand_labels: torch.Tensor,
    iou_thresh: float = 0.01,
    max_det: int = 128,
    fused: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed NMS over pre-gated candidates: boxes (B, K, 7+e), scores
    (B, K) with -inf padding, labels (B, K) 1-indexed -> packed
    (B, max_det, 9+e) rows + (B, max_det) valid. The path of models with
    ``decode_topk``, and the tail of ``extract_boxes_3d``."""
    if fused:
        return fused_suppress_pack_3d(
            cand_boxes, cand_scores, cand_labels, iou_thresh=iou_thresh, max_det=max_det
        )
    idx, keep = nms_bev(cand_boxes[..., :7], cand_scores, iou_thresh=iou_thresh, max_det=max_det)
    idx = idx.long()
    out = torch.cat(
        [
            torch.take_along_dim(cand_boxes, idx[..., None], dim=1),
            torch.where(keep, cand_scores.gather(1, idx), 0.0)[..., None],
            cand_labels.gather(1, idx).to(cand_boxes.dtype)[..., None],
        ],
        -1,
    )
    return torch.where(keep[..., None], out, 0.0), keep
