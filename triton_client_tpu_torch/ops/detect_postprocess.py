"""2D detection postprocess: raw predictions -> packed detections (port
of ``ops/detect_postprocess.py``).

  (B, N, 5+nc) --conf gate + top-k--> (B, max_nms, ...) --NMS--> (B, max_det, 6)

The JAX code vmaps a single-image tail; here the batch is a leading
dimension, and the fused tail is one kernel launch for the whole batch.

Top-k is a stable descending sort, never ``torch.topk``: ``jax.lax.top_k``
puts equal values in ascending index order, and most gated scores are
-inf, so the tie order decides which boxes fill the invalid slots. Those
boxes enter the adaptive class-offset stride (max |coord| * 2 + 1), so a
different fill could change offset coordinates and flip ``iou > thresh``.
"""

from __future__ import annotations

import torch

from triton_client_tpu_torch.device import scalar_on
from triton_client_tpu_torch.ops.boxes import xywh2xyxy
from triton_client_tpu_torch.ops.gpu_decode import fused_decode_nms_2d
from triton_client_tpu_torch.ops.nms import nms_padded


def stable_top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: descending, ties in
    ascending index order."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _packed_nms(
    boxes, scores, classes, valid, iou_thresh, max_det, class_agnostic,
    box_format: str, fused: bool,
):
    """``nms_padded`` vs the fused single-launch tail. ``box_format``
    says whether xywh -> xyxy is still pending."""
    if fused:
        return fused_decode_nms_2d(
            boxes, scores, classes, valid,
            iou_thresh=iou_thresh, max_det=max_det, box_format=box_format,
            class_agnostic=class_agnostic,
        )
    if box_format == "xywh":
        boxes = xywh2xyxy(boxes)
    return nms_padded(
        boxes, scores, classes, valid,
        iou_thresh=iou_thresh, max_det=max_det, class_agnostic=class_agnostic,
    )


def _gate(scores: torch.Tensor, conf_thresh) -> torch.Tensor:
    thresh = scalar_on(conf_thresh, torch.float32, scores.device)
    return torch.where(scores > thresh, scores, float("-inf"))


def topk_candidates(boxes, scores, classes, conf_thresh, max_nms):
    """Confidence gate -> top-k prefilter over (B, N) best-class scores:
    the candidate set the NMS tail takes, as (B, K, 4) boxes, (B, K)
    scores (0.0 in invalid slots), classes and valid, K = min(max_nms, N)."""
    gated = _gate(scores, conf_thresh)
    top_scores, top_idx = stable_top_k(gated, min(max_nms, gated.shape[-1]))
    top_valid = top_scores > float("-inf")
    return (
        torch.take_along_dim(boxes, top_idx[..., None], dim=1),
        torch.where(top_valid, top_scores, 0.0),
        classes.gather(1, top_idx),
        top_valid,
    )


def _gate_topk_nms(
    boxes, scores, classes, conf_thresh, iou_thresh, max_det, max_nms,
    class_agnostic=False, box_format="xyxy", fused=False,
):
    """Batched tail: gate + top-k -> class-aware NMS -> packed
    (B, max_det, 6) rows."""
    return _packed_nms(
        *topk_candidates(boxes, scores, classes, conf_thresh, max_nms),
        iou_thresh, max_det, class_agnostic, box_format, fused,
    )


def _multilabel_topk_nms(
    boxes, per_class_scores, conf_thresh, iou_thresh, max_det, max_nms,
    class_agnostic=False, box_format="xyxy", fused=False,
):
    """Multi-label tail: every (box, class) pair over the threshold is a
    candidate; boxes/classes come from surviving flat indices."""
    b, n, nc = per_class_scores.shape
    gated = _gate(per_class_scores.reshape(b, n * nc), conf_thresh)
    k = min(max_nms, gated.shape[-1])
    top_scores, top_idx = stable_top_k(gated, k)
    top_valid = top_scores > float("-inf")
    return _packed_nms(
        torch.take_along_dim(boxes, (top_idx // nc)[..., None], dim=1),
        torch.where(top_valid, top_scores, 0.0),
        top_idx % nc,
        top_valid,
        iou_thresh, max_det, class_agnostic, box_format, fused,
    )


def extract_boxes(
    prediction: torch.Tensor,
    conf_thresh: float = 0.3,
    iou_thresh: float = 0.45,
    max_det: int = 300,
    max_nms: int = 1024,
    class_agnostic: bool = False,
    multi_label: bool = False,
    fused: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 5+nc) decoded [cx, cy, w, h, obj, cls...] -> packed
    ((B, max_det, 6) [x1, y1, x2, y2, conf, cls] rows, zeros where
    invalid, and a (B, max_det) bool mask). ``fused`` sends the post-top-k
    tail through ``ops/gpu_decode.fused_decode_nms_2d``, which defers
    xywh -> xyxy into the kernel."""
    nc = prediction.shape[-1] - 5
    boxes = prediction[..., :4] if fused else xywh2xyxy(prediction[..., :4])
    fmt = "xywh" if fused else "xyxy"
    obj = prediction[..., 4]
    cls_conf = prediction[..., 5:] * obj[..., None]  # conf = obj * cls

    if multi_label and nc > 1:
        return _multilabel_topk_nms(
            boxes, cls_conf, conf_thresh, iou_thresh, max_det, max_nms,
            class_agnostic, box_format=fmt, fused=fused,
        )
    return _gate_topk_nms(
        boxes,
        cls_conf.amax(dim=-1),
        cls_conf.argmax(dim=-1),
        conf_thresh, iou_thresh, max_det, max_nms,
        class_agnostic, box_format=fmt, fused=fused,
    )
