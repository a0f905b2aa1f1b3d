"""Fused 2D detection tail as a hand-written CUDA kernel (port of the 2D
part of ``ops/pallas_decode.py``).

Replaces the TPU kernel ``triton_client_tpu/ops/pallas_decode.py::
fused_decode_nms_2d`` (body ``_decode_nms_pack_2d_kernel``): candidate
decode (xywh -> xyxy), the adaptive class offset, greedy suppression
and packed ``(max_det, 6)`` rows in one launch for the whole batch.
Source: ``csrc/decode_nms_2d.cu`` over the loop in ``csrc/greedy.cuh``.

What bounds it on an H100: latency, not bytes or operations. The
``max_det`` steps each end in a block-wide argmax that depends on the
step before; the bytes it must move (about 33 KB an image at K = 1024,
max_det = 300) take well under a microsecond at 3.35 TB/s. The design
gives each image one thread block, keeps offset and original
coordinates, areas and live scores in shared memory (40 bytes a
candidate, 40 KB at K = 1024), folds the next step's per-thread argmax
into the suppression pass so a step costs one block reduction, writes
each row straight from shared memory, and stops at the first step whose
best live score is -inf (the rows after it are zero either way).

``fused_decode_nms_2d`` launches the kernel for CUDA tensors and runs
the plain ``decode_nms_2d_reference`` for CPU tensors; nothing falls
back.
"""

from __future__ import annotations

import ctypes

import torch

from triton_client_tpu_torch.ops import cuda_build
from triton_client_tpu_torch.ops.gpu_nms import SMEM_LIMIT, SMEM_STATIC, greedy_steps

SOURCE = "decode_nms_2d.cu"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# decode_nms_2d_launch(boxes, scores, classes, valid, batch, k, thresh,
#                      max_det, xywh, class_agnostic, dets, keep, smem_bytes, stream)
_ARGTYPES = {
    "decode_nms_2d_launch": [_P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _P, _P, _I, _P]
}

launches = cuda_build.LaunchCounter()


def smem_bytes(k: int) -> int:
    """Dynamic shared memory of one block over ``k`` candidates: ten
    float arrays (x1..y2, offset x1..y2, area, live). The launch passes
    this count to the kernel, which carves its arrays from it."""
    return 10 * 4 * k


def smem_fits(k: int) -> bool:
    """Whether ``k`` candidates fit one block's shared memory."""
    return smem_bytes(k) + SMEM_STATIC <= SMEM_LIMIT


def _decode(boxes: torch.Tensor, box_format: str):
    c0, c1, c2, c3 = boxes.unbind(-1)
    if box_format == "xywh":  # ops/boxes.xywh2xyxy, bit for bit
        return c0 - c2 * 0.5, c1 - c3 * 0.5, c0 + c2 * 0.5, c1 + c3 * 0.5
    if box_format == "xyxy":
        return c0, c1, c2, c3
    raise ValueError(f"box_format must be xywh|xyxy, got {box_format!r}")


def decode_nms_2d_reference(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    valid: torch.Tensor,
    iou_thresh=0.45,
    max_det: int = 300,
    box_format: str = "xywh",
    class_agnostic: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, step for step.

    boxes (B, K, 4) in ``box_format``, scores (B, K) 0 on invalid slots,
    classes (B, K), valid (B, K) bool -> ((B, max_det, 6) float32 rows
    [x1, y1, x2, y2, score, class], (B, max_det) bool keep)."""
    x1, y1, x2, y2 = _decode(boxes.to(torch.float32), box_format)
    scores = scores.to(torch.float32)
    clsf = classes.to(torch.float32)
    if class_agnostic:
        ox1, oy1, ox2, oy2 = x1, y1, x2, y2
    else:
        # ops/nms.batched_nms's adaptive stride: max |coord| over all K
        # slots, invalid ones included
        m = torch.maximum(torch.maximum(x1.abs(), y1.abs()), torch.maximum(x2.abs(), y2.abs()))
        stride = m.amax(dim=1, keepdim=True) * 2.0 + 1.0
        off = clsf * stride
        ox1, oy1, ox2, oy2 = x1 + off, y1 + off, x2 + off, y2 + off
    area = (ox2 - ox1) * (oy2 - oy1)
    live = torch.where(valid.to(torch.bool), scores, float("-inf"))
    chosen, keep = greedy_steps(ox1, oy1, ox2, oy2, area, live, iou_thresh, max_det)
    # "+ 0.0": the TPU kernel's masked sum turns -0.0 into +0.0
    rows = torch.stack([c.gather(1, chosen) + 0.0 for c in (x1, y1, x2, y2, scores, clsf)], -1)
    return torch.where(keep[..., None], rows, 0.0), keep


def fused_decode_nms_2d(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    valid: torch.Tensor,
    iou_thresh=0.45,
    max_det: int = 300,
    box_format: str = "xywh",
    class_agnostic: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-launch candidate tail over the batch (the ``nms_padded``
    contract): boxes (B, K, 4), scores (B, K) 0-filled on invalid slots,
    classes (B, K), valid (B, K) -> ((B, max_det, 6) rows, (B, max_det)
    keep).

    CUDA tensors launch ``csrc/decode_nms_2d.cu`` (one block per image);
    CPU tensors run :func:`decode_nms_2d_reference`."""
    tensors = (boxes, scores, classes, valid)
    if all(t.device.type == "cpu" for t in tensors):
        return decode_nms_2d_reference(
            boxes, scores, classes, valid, iou_thresh, max_det, box_format, class_agnostic
        )
    if boxes.device.type != "cuda" or any(t.device != boxes.device for t in tensors):
        raise ValueError(f"fused_decode_nms_2d: inputs on {[str(t.device) for t in tensors]}")
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or any(
        t.shape != boxes.shape[:2] for t in tensors[1:]
    ):
        raise ValueError(
            "fused_decode_nms_2d: boxes (B, K, 4) with scores/classes/valid (B, K), got "
            f"{[tuple(t.shape) for t in tensors]}"
        )
    if box_format not in ("xywh", "xyxy"):
        raise ValueError(f"box_format must be xywh|xyxy, got {box_format!r}")
    b, k = scores.shape
    if not smem_fits(k):
        raise ValueError(f"fused_decode_nms_2d: {k} candidates exceed one block's shared memory")
    boxes = boxes.to(torch.float32).contiguous()
    scores = scores.to(torch.float32).contiguous()
    classes = classes.to(torch.float32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    dets = torch.empty((b, max_det, 6), dtype=torch.float32, device=boxes.device)
    keep = torch.empty((b, max_det), dtype=torch.bool, device=boxes.device)
    if b == 0 or max_det == 0:
        return dets, keep
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    with torch.cuda.device(boxes.device):
        err = cuda_build.load(SOURCE, _ARGTYPES).decode_nms_2d_launch(
            boxes.data_ptr(), scores.data_ptr(), classes.data_ptr(), valid.data_ptr(),
            b, k, float(iou_thresh), max_det, int(box_format == "xywh"), int(class_agnostic),
            dets.data_ptr(), keep.data_ptr(), smem_bytes(k), stream,
        )
    cuda_build.check_launch("decode_nms_2d", err)
    launches.add()
    return dets, keep
