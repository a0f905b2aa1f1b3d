"""Fixed-shape greedy NMS on tensors (port of ``ops/nms.py``).

Candidate sets are fixed-size, invalid slots carry score -inf, and the
output is always ``max_det`` indices plus a validity mask. The JAX
functions take one image and are vmapped; these take a leading batch
dimension and run the whole batch at once.

Three formulations give identical kept-index sequences: the
suppression-graph fixpoint (``_nms_fixpoint``), the sequential loop
(``_nms_xla``) and the hand-written CUDA kernel (``ops/gpu_nms``).
``nms`` routes between them as ``_nms_mode`` does in the JAX package and
reads the same ``TRITON_CLIENT_TPU_NMS`` values, so a deployment's
setting carries over: ``pallas`` selects the kernel. Unlike the JAX
route, ``pallas`` never falls back past the kernel's size limit: on a
CUDA tensor the kernel runs or ``nms_greedy`` raises, and on a CPU
tensor its plain version runs at any size.
"""

from __future__ import annotations

import os

import torch

from triton_client_tpu_torch.device import scalar_on
from triton_client_tpu_torch.ops.boxes import box_area
from triton_client_tpu_torch.ops.gpu_nms import greedy_steps, nms_greedy
from triton_client_tpu_torch.runtime.graphs import fixed_point

# The (N, N) IoU matrix the fixpoint formulation materializes: 4 bytes
# x N^2 per image, 64 MB at 4096, past which the sequential loop wins.
_FIXPOINT_MAX_N = 4096


def route_setting() -> str:
    """The ``TRITON_CLIENT_TPU_NMS`` setting as it stands: a captured
    graph keeps the route it was captured with, so the pipelines key their
    graphs on it (``runtime/graphs``)."""
    return os.environ.get("TRITON_CLIENT_TPU_NMS", "auto")


def _nms_mode(n: int, max_det: int) -> str:
    """Route between the formulations (env override
    ``TRITON_CLIENT_TPU_NMS=fixpoint|pallas|xla``); auto takes the
    fixpoint form while its IoU matrix is affordable."""
    mode = route_setting()
    if mode in ("xla", "fixpoint", "pallas"):
        return mode
    return "fixpoint" if n <= _FIXPOINT_MAX_N else "xla"


def _f32(value, device) -> torch.Tensor:
    """A threshold as a float32 scalar, compared as the JAX code compares it."""
    return scalar_on(value, torch.float32, device)


def nms(
    boxes: torch.Tensor, scores: torch.Tensor, iou_thresh=0.45, max_det: int = 300
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over (B, N, 4) xyxy boxes and (B, N) scores.

    Returns ``(indices, valid)``: (B, max_det) int32 indices into the
    input (0 where invalid) and a (B, max_det) bool mask. Slots whose
    score is -inf (padding) are never selected."""
    mode = _nms_mode(boxes.shape[-2], max_det)
    if mode == "pallas":
        return nms_greedy(boxes, scores, iou_thresh=iou_thresh, max_det=max_det)
    if mode == "fixpoint":
        return _nms_fixpoint(boxes, scores, iou_thresh, max_det=max_det)
    return _nms_xla(boxes, scores, iou_thresh, max_det=max_det)


def _nms_fixpoint(
    boxes: torch.Tensor, scores: torch.Tensor, iou_thresh=0.45, max_det: int = 300
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact greedy NMS as the fixpoint of
    ``kept_i = valid_i and not any(edge_ji and kept_j)`` over the
    score-ordered suppression graph; converges in max-chain-depth passes."""
    # Stable descending score order reproduces argmax's first-max-wins
    # tie break; -inf rows (padding) sink to the bottom.
    order = torch.argsort(-scores, dim=-1, stable=True)
    sboxes = torch.take_along_dim(boxes, order[..., None], dim=-2).to(torch.float32)
    valid0 = torch.take_along_dim(scores, order, dim=-1) > float("-inf")

    areas = box_area(sboxes)
    lt = torch.maximum(sboxes[:, :, None, :2], sboxes[:, None, :, :2])
    rb = torch.minimum(sboxes[:, :, None, 2:], sboxes[:, None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / torch.clamp(areas[:, :, None] + areas[:, None, :] - inter, min=1e-9)
    return fixpoint_keep_sorted(iou, valid0, order, iou_thresh, max_det)


def fixpoint_keep_sorted(
    siou: torch.Tensor,
    valid0: torch.Tensor,
    order: torch.Tensor,
    iou_thresh,
    max_det: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixpoint core: ``siou`` (B, N, N) IoU of SCORE-SORTED candidates,
    ``valid0`` (B, N) their live mask, ``order`` (B, N) the
    sorted->original index map. Returns the sequential loop's
    ((B, max_det) indices into the ORIGINAL array, valid) contract."""
    b, n = valid0.shape
    rank = torch.arange(n, device=valid0.device)
    # edge[b, j, i]: j (strictly higher-ranked) suppresses i when kept
    edge = (
        (siou > _f32(iou_thresh, siou.device))
        & (rank[:, None] < rank[None, :])
        & valid0[:, :, None]
    )
    # sup[b, i, j] = edge[b, j, i], so each pass reduces over the innermost
    # dim; valid0 > s is valid0 & ~s on bools, in one op
    sup = edge.transpose(1, 2).contiguous()
    kept = fixed_point(lambda k: valid0 > torch.any(sup & k[:, None, :], dim=2), valid0, n)

    # Pack the first max_det kept (already score-ordered) into the
    # sequential loop's (indices, valid) contract.
    kept_rank = torch.cumsum(kept, dim=-1) - 1
    slot = torch.where(kept & (kept_rank < max_det), kept_rank, max_det)
    indices = torch.zeros((b, max_det + 1), dtype=torch.int32, device=valid0.device)
    # only slot max_det (sliced off below) can be written twice
    indices.scatter_(1, slot, order.to(torch.int32))
    valid = torch.arange(max_det, device=valid0.device)[None, :] < kept.sum(dim=-1, keepdim=True)
    return indices[:, :max_det], valid


def _nms_xla(
    boxes: torch.Tensor, scores: torch.Tensor, iou_thresh=0.45, max_det: int = 300
) -> tuple[torch.Tensor, torch.Tensor]:
    """The sequential greedy loop: ``max_det`` argmax/suppress steps (the
    kernel's loop, over clipped areas as the JAX ``_nms_xla`` takes them)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    chosen, valid = greedy_steps(x1, y1, x2, y2, box_area(boxes), scores, iou_thresh, max_det)
    return chosen.to(torch.int32), valid


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    iou_thresh=0.45,
    max_det: int = 300,
    class_agnostic: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS via the per-class coordinate offset trick. The
    stride adapts to each image's data range (max |coord| * 2 + 1) and
    the offset math runs in float32."""
    boxes32 = boxes.to(torch.float32)
    if not class_agnostic:
        boxes32 = class_offset_boxes(boxes32, classes)
    return nms(boxes32, scores, iou_thresh=iou_thresh, max_det=max_det)


def class_offset_boxes(boxes: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """(B, N, 4) float32 boxes shifted by class * (max |coord| * 2 + 1),
    the stride taken per image over all N boxes: boxes of different
    classes then never overlap."""
    stride = boxes.abs().amax(dim=(1, 2)) * 2.0 + 1.0
    return boxes + (classes.to(torch.float32) * stride[:, None])[..., None]


def nms_padded(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    valid: torch.Tensor,
    iou_thresh=0.45,
    max_det: int = 300,
    class_agnostic: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """NMS over padded candidate sets -> packed (B, max_det, 6) rows
    [x1, y1, x2, y2, score, class] (zeros where invalid) + (B, max_det)
    validity mask."""
    masked_scores = torch.where(valid, scores, float("-inf"))
    idx, keep = batched_nms(
        boxes, masked_scores, classes,
        iou_thresh=iou_thresh, max_det=max_det, class_agnostic=class_agnostic,
    )
    idx = idx.long()
    out = torch.cat(
        [
            torch.take_along_dim(boxes, idx[..., None], dim=1),
            scores.gather(1, idx)[..., None],
            classes.gather(1, idx).to(boxes.dtype)[..., None],
        ],
        dim=-1,
    )
    out = torch.where(keep[..., None], out, 0.0)
    return out, keep
