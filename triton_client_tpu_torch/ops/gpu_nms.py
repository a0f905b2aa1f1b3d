"""Greedy NMS as a hand-written CUDA kernel (port of ``ops/pallas_nms.py``).

Replaces the TPU kernel ``triton_client_tpu/ops/pallas_nms.py::nms_pallas``
(body ``_nms_kernel``). Source: ``csrc/greedy_nms.cu`` over
``csrc/mask_scan.cuh`` and ``csrc/box_iou.cuh``.

What bounds it on an H100: latency, not bytes or operations (about 20 KB
an image at N = 1024, well under a microsecond at 3.35 TB/s). The greedy
loop's ``max_det`` dependent block-wide argmax steps were the time, so the
kernel does not run that loop. It keeps the same candidates by another
route (``ops/mask_scan.py`` states the equivalence), as the decode+NMS
kernel (``ops/gpu_decode.py``) does: an order pass (one block an image:
the visiting order, taken as it stands when the scores are already in
order, as the unfused 2D route hands them over after its top-k, else a
bitonic sort; the boxes and areas written in that order), a mask pass
(every IoU test at once, in 64 x 64 tiles across the card) and a scan (one
warp an image walks the order with the removed set in registers). Three
launches on one stream, counted as one call. The workspace (the mask, the
order, the ordered boxes) comes from ``torch.empty`` in the wrapper.

``nms_greedy`` launches the kernel for CUDA tensors and runs the plain
``nms_greedy_reference`` (the greedy loop, step for step) for CPU tensors;
nothing falls back. ``nms_greedy_mask_scan_reference`` is the kernel's own
algorithm in plain PyTorch, held equal to the loop on the CPU by
``tests/test_torch_nms_scan.py``.
"""

from __future__ import annotations

import ctypes

import torch

from triton_client_tpu_torch.device import scalar_on
from triton_client_tpu_torch.ops import cuda_build, mask_scan

SOURCE = "greedy_nms.cu"
# Shared memory one block may use on Hopper: 227 KB (232,448 bytes).
SMEM_LIMIT = 232448
# Static shared memory beside the dynamic arrays: the reduction slots,
# with room to spare.
SMEM_STATIC = 1024

launches = cuda_build.LaunchCounter()


def smem_bytes(n: int) -> int:
    """Dynamic shared memory of the larger one-block pass over ``n``
    candidates (``ops/mask_scan.smem_bytes``)."""
    return mask_scan.smem_bytes(n)


def smem_fits(n: int) -> bool:
    """Whether the passes' shared memory over ``n`` candidates fits a
    block (the counterpart of ``pallas_nms.vmem_fits``): up to N = 16,384,
    where the order pass's sort fills it (the mask workspace there is
    32 MB an image)."""
    return smem_bytes(n) + SMEM_STATIC <= SMEM_LIMIT


def _workspace_sizes(b: int, n: int) -> tuple[int, ...]:
    """int32 elements of the mask rows, the order, the live counts and
    own-order flags (``mask_scan.took_own_order``), the boxes in visiting
    order (4 floats each), their areas, and each image's index for the
    invalid slots."""
    return (b * n * mask_scan.row_stride(n), b * n, 2 * b, 4 * b * n, b * n, b)


def workspace_bytes(b: int, n: int) -> int:
    """Device memory a call over (B, N) candidates takes beside its inputs
    and outputs (1.2 MB at B = 8, N = 1024)."""
    return mask_scan.workspace_bytes(_workspace_sizes(b, n))


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# greedy_nms_launch(boxes, scores, batch, n, thresh, max_det, indices, valid,
#                   mask, order, live_n, obox, oarea, fill, order_smem_bytes,
#                   stream); the launch sizes the scan pass's shared memory
#                   itself
_ARGTYPES = {"greedy_nms_launch": [_P, _P, _I, _I, _F, _I, *[_P] * 8, _I, _P]}


def greedy_steps(x1, y1, x2, y2, area, live, iou_thresh, max_det: int):
    """The greedy loop of the TPU kernels in plain PyTorch, over (B, N)
    coordinates, areas and live scores (-inf = dead). Each step takes
    the argmax live score (ties to the lowest index, as ``jnp.argmax``)
    and kills it and every candidate with IoU > thresh against it.
    Returns the (B, max_det) chosen indices and whether each was live.
    ``argmax`` ranks a NaN above every number, so a live NaN is the first
    pick and an invalid one, and every step after it picks it again; a
    step with nothing live chooses index 0, as ``jnp.argmax`` of an all
    -inf row does."""
    b, n = live.shape
    dev = live.device
    thresh = scalar_on(iou_thresh, torch.float32, dev)
    neg_inf = scalar_on(float("-inf"), torch.float32, dev)
    lane = torch.arange(n, device=dev)
    chosen = torch.zeros((b, max_det), dtype=torch.int64, device=dev)
    valid = torch.zeros((b, max_det), dtype=torch.bool, device=dev)

    def pick(t, best):  # "+ 0.0": the TPU kernels' masked sum turns -0.0 into +0.0
        return t.gather(1, best[:, None]) + 0.0

    for i in range(max_det):
        best = live.argmax(dim=1)
        is_valid = live.gather(1, best[:, None])[:, 0] > neg_inf
        chosen[:, i] = best
        valid[:, i] = is_valid
        iw = torch.clamp(torch.minimum(x2, pick(x2, best)) - torch.maximum(x1, pick(x1, best)), min=0.0)
        ih = torch.clamp(torch.minimum(y2, pick(y2, best)) - torch.maximum(y1, pick(y1, best)), min=0.0)
        inter = iw * ih
        iou = inter / torch.clamp(area + pick(area, best) - inter, min=1e-9)
        suppress = (iou > thresh) | (lane[None, :] == best[:, None])
        live = torch.where(suppress & is_valid[:, None], neg_inf, live)
    return chosen, valid


def nms_greedy_reference(
    boxes: torch.Tensor, scores: torch.Tensor, iou_thresh=0.45, max_det: int = 300
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, step for step.

    boxes (B, N, 4) xyxy, scores (B, N) with -inf as padding ->
    ((B, max_det) int32 indices, (B, max_det) bool valid). Invalid slots
    hold the index ``jnp.argmax`` gives there: 0, or the first NaN when a
    score is NaN."""
    x1, y1, x2, y2 = boxes.to(torch.float32).unbind(-1)
    area = (x2 - x1) * (y2 - y1)  # unclipped, as pallas_nms.py:129
    chosen, valid = greedy_steps(
        x1, y1, x2, y2, area, scores.to(torch.float32), iou_thresh, max_det
    )
    return chosen.to(torch.int32), valid


def nms_greedy_mask_scan_reference(
    boxes: torch.Tensor, scores: torch.Tensor, iou_thresh=0.45, max_det: int = 300
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's algorithm in plain PyTorch, with the contract of
    :func:`nms_greedy_reference`: the visiting order of the scores, the
    suppression bitmask over it (row p's box as the chosen one, "+ 0.0" on
    its values as the loop picks them), then the scan. Invalid slots hold
    the first NaN's index when a score is NaN (nothing is kept then), else
    0."""
    live = scores.to(torch.float32)
    x1, y1, x2, y2 = boxes.to(torch.float32).unbind(-1)
    area = (x2 - x1) * (y2 - y1)  # unclipped, as pallas_nms.py:129
    order, live_n = mask_scan.visiting_order(live)
    mask = mask_scan.box_mask(*(t.gather(1, order) for t in (x1, y1, x2, y2, area)), iou_thresh)
    kept, valid = mask_scan.scan(mask, live_n, max_det)
    nan = torch.isnan(live)
    fill = torch.where(nan.any(1), nan.to(torch.int8).argmax(1), 0)
    indices = torch.where(valid, order.gather(1, kept), fill[:, None])
    return indices.to(torch.int32), valid


def nms_greedy(
    boxes: torch.Tensor, scores: torch.Tensor, iou_thresh=0.45, max_det: int = 300
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over (B, N, 4) xyxy boxes and (B, N) scores (-inf =
    padding) -> ((B, max_det) int32 indices, (B, max_det) bool valid).

    CUDA tensors launch ``csrc/greedy_nms.cu`` (three passes, one count);
    CPU tensors run :func:`nms_greedy_reference`."""
    if boxes.device.type == "cpu" and scores.device.type == "cpu":
        return nms_greedy_reference(boxes, scores, iou_thresh, max_det)
    if boxes.device.type != "cuda" or scores.device != boxes.device:
        raise ValueError(f"nms_greedy: boxes on {boxes.device}, scores on {scores.device}")
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"nms_greedy: boxes {tuple(boxes.shape)} / scores {tuple(scores.shape)}")
    b, n = scores.shape
    if not smem_fits(n):
        raise ValueError(
            f"nms_greedy: {n} candidates need {smem_bytes(n)} B of a block's shared memory "
            "(the order pass's sort), more than it has"
        )
    boxes = boxes.to(torch.float32).contiguous()
    scores = scores.to(torch.float32).contiguous()
    indices = torch.empty((b, max_det), dtype=torch.int32, device=boxes.device)
    valid = torch.empty((b, max_det), dtype=torch.bool, device=boxes.device)
    if b == 0 or max_det == 0:
        return indices, valid
    _ws, ptrs = mask_scan.workspace(boxes.device, _workspace_sizes(b, n))
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    with torch.cuda.device(boxes.device):
        err = cuda_build.load(SOURCE, _ARGTYPES).greedy_nms_launch(
            boxes.data_ptr(), scores.data_ptr(), b, n, float(iou_thresh), max_det,
            indices.data_ptr(), valid.data_ptr(), *ptrs, mask_scan.order_smem_bytes(n), stream,
        )
    cuda_build.check_launch("greedy_nms", err)
    launches.add()
    return indices, valid
