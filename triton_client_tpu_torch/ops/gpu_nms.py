"""Greedy NMS as a hand-written CUDA kernel (port of ``ops/pallas_nms.py``).

Replaces the TPU kernel ``triton_client_tpu/ops/pallas_nms.py::nms_pallas``
(body ``_nms_kernel``). Source: ``csrc/greedy_nms.cu`` over the loop in
``csrc/greedy.cuh``.

What bounds it on an H100: latency, not bytes or operations. Each of up
to ``max_det`` steps is a block-wide argmax that depends on the step
before; the bytes it must move (about 20 KB an image at N = 1024) take
well under a microsecond at 3.35 TB/s. The design gives each image one
thread block, keeps every candidate in shared memory (24 bytes each),
folds the next step's per-thread argmax into the suppression pass so a
step costs one block reduction, and stops at the first step with no
live candidate. The whole batch is one launch.

``nms_greedy`` launches the kernel for CUDA tensors and runs the plain
``nms_greedy_reference`` for CPU tensors; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from triton_client_tpu_torch.ops import cuda_build

SOURCE = "greedy_nms.cu"
# Shared memory one block may use on Hopper: 227 KB (232,448 bytes).
SMEM_LIMIT = 232448
# Static shared memory beside the dynamic arrays: the reduction slots,
# with room to spare.
SMEM_STATIC = 1024

launches = cuda_build.LaunchCounter()


def smem_bytes(n: int) -> int:
    """Dynamic shared memory of one block over ``n`` candidates: six
    float arrays (x1, y1, x2, y2, area, live). The launch passes this
    count to the kernel, which carves its arrays from it."""
    return 6 * 4 * n


def smem_fits(n: int) -> bool:
    """Whether ``n`` candidates fit one block's shared memory (the
    counterpart of ``pallas_nms.vmem_fits``)."""
    return smem_bytes(n) + SMEM_STATIC <= SMEM_LIMIT


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# greedy_nms_launch(boxes, scores, batch, n, thresh, max_det, indices, valid,
#                   smem_bytes, stream)
_ARGTYPES = {"greedy_nms_launch": [_P, _P, _I, _I, _F, _I, _P, _P, _I, _P]}


def greedy_steps(x1, y1, x2, y2, area, live, iou_thresh, max_det: int):
    """The loop of ``csrc/greedy.cuh`` in plain PyTorch, over (B, N)
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
    thresh = torch.tensor(iou_thresh, dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
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


def nms_greedy(
    boxes: torch.Tensor, scores: torch.Tensor, iou_thresh=0.45, max_det: int = 300
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over (B, N, 4) xyxy boxes and (B, N) scores (-inf =
    padding) -> ((B, max_det) int32 indices, (B, max_det) bool valid).

    CUDA tensors launch ``csrc/greedy_nms.cu`` (one block per image);
    CPU tensors run :func:`nms_greedy_reference`."""
    if boxes.device.type == "cpu" and scores.device.type == "cpu":
        return nms_greedy_reference(boxes, scores, iou_thresh, max_det)
    if boxes.device.type != "cuda" or scores.device != boxes.device:
        raise ValueError(f"nms_greedy: boxes on {boxes.device}, scores on {scores.device}")
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"nms_greedy: boxes {tuple(boxes.shape)} / scores {tuple(scores.shape)}")
    b, n = scores.shape
    if not smem_fits(n):
        raise ValueError(f"nms_greedy: {n} candidates exceed one block's shared memory")
    boxes = boxes.to(torch.float32).contiguous()
    scores = scores.to(torch.float32).contiguous()
    indices = torch.empty((b, max_det), dtype=torch.int32, device=boxes.device)
    valid = torch.empty((b, max_det), dtype=torch.bool, device=boxes.device)
    if b == 0 or max_det == 0:
        return indices, valid
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    with torch.cuda.device(boxes.device):
        err = cuda_build.load(SOURCE, _ARGTYPES).greedy_nms_launch(
            boxes.data_ptr(), scores.data_ptr(), b, n, float(iou_thresh), max_det,
            indices.data_ptr(), valid.data_ptr(), smem_bytes(n), stream,
        )
    cuda_build.check_launch("greedy_nms", err)
    launches.add()
    return indices, valid
