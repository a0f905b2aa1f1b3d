"""Fused 2D detection tail as a hand-written CUDA kernel (port of the 2D
part of ``ops/pallas_decode.py``).

Replaces the TPU kernel ``triton_client_tpu/ops/pallas_decode.py::
fused_decode_nms_2d`` (body ``_decode_nms_pack_2d_kernel``): candidate
decode (xywh -> xyxy), the adaptive class offset, greedy suppression
and packed ``(max_det, 6)`` rows for the whole batch. Source:
``csrc/decode_nms_2d.cu`` over ``csrc/mask_scan.cuh``.

What bounds it on an H100: latency, not bytes or operations (about 33 KB
an image at K = 1024, max_det = 300, well under a microsecond at
3.35 TB/s). The greedy loop's ``max_det`` dependent block-wide argmax
steps were the time, so the kernel does not run that loop. It keeps the
same candidates by another route (``ops/mask_scan.py`` states the
equivalence): an order pass (one block an image: decode, class offset,
the visiting order, taken as it stands when the scores are already in
order, as ``topk_candidates`` hands them over), a mask pass (every IoU
test at once, in 64 x 64 tiles across the card, into a bitmask of who
suppresses whom) and a scan (one warp an image walks the order with the
removed set in registers; a suppressed box costs nothing). Three launches
on one stream, counted as one call. The workspace (the mask, the order,
the offset boxes) comes from ``torch.empty`` in the wrapper.

``fused_decode_nms_2d`` launches the kernel for CUDA tensors and runs
the plain ``decode_nms_2d_reference`` (the greedy loop, step for step)
for CPU tensors; nothing falls back. ``decode_nms_2d_mask_scan_reference``
is the kernel's own algorithm in plain PyTorch, held equal to it on the
CPU by ``tests/test_torch_nms_scan.py``.
"""

from __future__ import annotations

import ctypes

import torch

from triton_client_tpu_torch.ops import cuda_build, mask_scan
from triton_client_tpu_torch.ops.gpu_nms import SMEM_LIMIT, SMEM_STATIC, greedy_steps

SOURCE = "decode_nms_2d.cu"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# decode_nms_2d_launch(boxes, scores, classes, valid, batch, k, thresh, max_det,
#                      xywh, class_agnostic, dets, keep, mask, order, live_n,
#                      obox, oarea, order_smem_bytes, stream); the launch sizes
#                      the scan pass's shared memory itself
_ARGTYPES = {
    "decode_nms_2d_launch": [_P, _P, _P, _P, _I, _I, _F, _I, _I, _I, *[_P] * 7, _I, _P]
}

launches = cuda_build.LaunchCounter()


def smem_bytes(k: int) -> int:
    """Dynamic shared memory of the larger one-block pass over ``k``
    candidates (``ops/mask_scan.smem_bytes``)."""
    return mask_scan.smem_bytes(k)


def smem_fits(k: int) -> bool:
    """Whether the passes' shared memory over ``k`` candidates fits a
    block: up to K = 16,384, where the order pass's sort fills it (the
    mask workspace there is 32 MB an image)."""
    return smem_bytes(k) + SMEM_STATIC <= SMEM_LIMIT


def _workspace_sizes(b: int, k: int) -> tuple[int, ...]:
    """int32 elements of the mask rows, the order, the live counts and
    own-order flags (``mask_scan.took_own_order``), the offset boxes (4
    floats each) and their areas."""
    return (b * k * mask_scan.row_stride(k), b * k, 2 * b, 4 * b * k, b * k)


def workspace_bytes(b: int, k: int) -> int:
    """Device memory a call over (B, K) candidates takes beside its
    inputs and outputs (1.2 MB at B = 8, K = 1024)."""
    return mask_scan.workspace_bytes(_workspace_sizes(b, k))


def _decode(boxes: torch.Tensor, box_format: str):
    c0, c1, c2, c3 = boxes.unbind(-1)
    if box_format == "xywh":  # ops/boxes.xywh2xyxy, bit for bit
        return c0 - c2 * 0.5, c1 - c3 * 0.5, c0 + c2 * 0.5, c1 + c3 * 0.5
    if box_format == "xyxy":
        return c0, c1, c2, c3
    raise ValueError(f"box_format must be xywh|xyxy, got {box_format!r}")


def _tail_inputs(boxes, scores, classes, valid, box_format, class_agnostic):
    """Decoded boxes, float scores and classes, offset boxes and areas,
    and live scores (-inf where invalid), as the kernel's order pass takes
    them."""
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
    return (x1, y1, x2, y2, scores, clsf), (ox1, oy1, ox2, oy2, area), live


def _pack(out_cols, chosen, keep):
    # "+ 0.0": the TPU kernel's masked sum turns -0.0 into +0.0
    rows = torch.stack([c.gather(1, chosen) + 0.0 for c in out_cols], -1)
    return torch.where(keep[..., None], rows, 0.0), keep


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
    """Plain PyTorch version of the kernel: the greedy loop of the TPU
    kernel, step for step.

    boxes (B, K, 4) in ``box_format``, scores (B, K) 0 on invalid slots,
    classes (B, K), valid (B, K) bool -> ((B, max_det, 6) float32 rows
    [x1, y1, x2, y2, score, class], (B, max_det) bool keep)."""
    out_cols, (ox1, oy1, ox2, oy2, area), live = _tail_inputs(
        boxes, scores, classes, valid, box_format, class_agnostic
    )
    chosen, keep = greedy_steps(ox1, oy1, ox2, oy2, area, live, iou_thresh, max_det)
    return _pack(out_cols, chosen, keep)


def decode_nms_2d_mask_scan_reference(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    valid: torch.Tensor,
    iou_thresh=0.45,
    max_det: int = 300,
    box_format: str = "xywh",
    class_agnostic: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's algorithm in plain PyTorch, with the contract of
    :func:`decode_nms_2d_reference`: the visiting order, the suppression
    bitmask over it (row p's box as the chosen one, "+ 0.0" on its values
    as the loop picks them), then the scan."""
    out_cols, offset, live = _tail_inputs(boxes, scores, classes, valid, box_format, class_agnostic)
    order, live_n = mask_scan.visiting_order(live)
    mask = mask_scan.box_mask(*(t.gather(1, order) for t in offset), iou_thresh)
    kept, keep = mask_scan.scan(mask, live_n, max_det)
    return _pack(out_cols, order.gather(1, kept), keep)


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
    """One call's candidate tail over the batch (the ``nms_padded``
    contract): boxes (B, K, 4), scores (B, K) 0-filled on invalid slots,
    classes (B, K), valid (B, K) -> ((B, max_det, 6) rows, (B, max_det)
    keep).

    CUDA tensors launch ``csrc/decode_nms_2d.cu`` (three passes, one
    count); CPU tensors run :func:`decode_nms_2d_reference`."""
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
        raise ValueError(
            f"fused_decode_nms_2d: {k} candidates need {smem_bytes(k)} B of a block's "
            "shared memory (the order pass's sort), more than it has"
        )
    boxes = boxes.to(torch.float32).contiguous()
    scores = scores.to(torch.float32).contiguous()
    classes = classes.to(torch.float32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    dets = torch.empty((b, max_det, 6), dtype=torch.float32, device=boxes.device)
    keep = torch.empty((b, max_det), dtype=torch.bool, device=boxes.device)
    if b == 0 or max_det == 0:
        return dets, keep
    _ws, ptrs = mask_scan.workspace(boxes.device, _workspace_sizes(b, k))
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    with torch.cuda.device(boxes.device):
        err = cuda_build.load(SOURCE, _ARGTYPES).decode_nms_2d_launch(
            boxes.data_ptr(), scores.data_ptr(), classes.data_ptr(), valid.data_ptr(),
            b, k, float(iou_thresh), max_det, int(box_format == "xywh"), int(class_agnostic),
            dets.data_ptr(), keep.data_ptr(), *ptrs,
            mask_scan.order_smem_bytes(k), stream,
        )
    cuda_build.check_launch("decode_nms_2d", err)
    launches.add()
    return dets, keep
