"""Rotated-BEV suppression + packing as a hand-written CUDA kernel (port
of the 3D tail of ``ops/pallas_decode.py``).

Replaces the TPU kernel ``triton_client_tpu/ops/pallas_decode.py::
fused_suppress_pack_3d`` (body ``_suppress_pack_3d_kernel``). Two
wrappers, split where the TPU function's kernel begins:

  * ``suppress_pack_3d(iou_sorted, rows_sorted, thresh, max_det)`` is the
    call of ``csrc/suppress_pack_3d.cu``: greedy suppression over a
    precomputed (K, K) IoU matrix of score-sorted candidates, and the
    packed rows;
  * ``fused_suppress_pack_3d(boxes, scores, labels, iou_thresh, max_det)``
    does what the TPU function does outside its kernel: a stable score
    sort, the gathers and ``rotated_iou_bev`` on the sorted BEV boxes, in
    plain PyTorch (the JAX package leaves that matrix to XLA, outside any
    Pallas kernel), then calls ``suppress_pack_3d``.

What bounds it on an H100: latency. The bytes the kernel must read (the
256 KB matrix and 9 KB of rows at K = 256) take about 0.08 us at
3.35 TB/s; the greedy loop's ``max_det`` dependent block-wide argmax
steps were the time. So the kernel keeps the same candidates by another
route (``ops/mask_scan.py`` states the equivalence), in three launches
on one stream counted as one call: an order pass (one block an image;
the rows' own order when the scores are already sorted, as
``sorted_candidates`` leaves them, else a bitonic sort), a mask pass
(``iou[chosen][j] > thresh`` thresholded 32 columns a ballot, one warp a
row, across the card) and a one-warp scan. The workspace (the mask and
the order) comes from ``torch.empty`` in the wrapper.

CUDA tensors launch the kernel; CPU tensors run the plain
``suppress_pack_3d_reference`` (the greedy loop, step for step); nothing
falls back. ``suppress_pack_3d_mask_scan_reference`` is the kernel's own
algorithm in plain PyTorch, held equal to it on the CPU by
``tests/test_torch_nms_scan.py``.
"""

from __future__ import annotations

import ctypes

import torch

from triton_client_tpu_torch.device import scalar_on
from triton_client_tpu_torch.ops import cuda_build, mask_scan
from triton_client_tpu_torch.ops.boxes3d import boxes7_to_bev, rotated_iou_bev
from triton_client_tpu_torch.ops.gpu_nms import SMEM_LIMIT, SMEM_STATIC

SOURCE = "suppress_pack_3d.cu"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# suppress_pack_3d_launch(iou, rows, batch, k, cols, thresh, max_det, dets,
#                         keep, mask, order, live_n, order_smem_bytes, stream); the
#                         launch sizes the scan pass's shared memory itself
_ARGTYPES = {"suppress_pack_3d_launch": [_P, _P, _I, _I, _I, _F, _I, *[_P] * 5, _I, _P]}

launches = cuda_build.LaunchCounter()


def smem_bytes(k: int, cols: int) -> int:
    """Dynamic shared memory of the larger one-block pass over ``k``
    candidates (``ops/mask_scan.smem_bytes``; the rows stay in device
    memory, so ``cols`` does not enter)."""
    return mask_scan.smem_bytes(k)


def smem_fits(k: int, cols: int) -> bool:
    """Whether the passes' shared memory over ``k`` candidates of ``cols``
    columns fits a block: up to K = 16,384, where the order pass's sort
    fills it."""
    return smem_bytes(k, cols) + SMEM_STATIC <= SMEM_LIMIT


def _workspace_sizes(b: int, k: int) -> tuple[int, ...]:
    """int32 elements of the mask rows, the order, and the live counts and
    own-order flags (``mask_scan.took_own_order``)."""
    return (b * k * mask_scan.row_stride(k), b * k, 2 * b)


def workspace_bytes(b: int, k: int) -> int:
    """Device memory a call over (B, K) candidates takes beside its
    inputs and outputs (9 KB at B = 1, K = 256)."""
    return mask_scan.workspace_bytes(_workspace_sizes(b, k))


def suppress_pack_3d_reference(
    iou: torch.Tensor, rows: torch.Tensor, iou_thresh=0.01, max_det: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, step for step.

    iou (B, K, K) rotated IoU of score-sorted candidates, rows (B, K,
    cols) sorted rows [box7, extras..., score (-inf where gated), label]
    -> ((B, max_det, cols) packed rows, zeros where not kept, (B, max_det)
    bool keep)."""
    b, k, cols = rows.shape
    dev = rows.device
    thresh = scalar_on(iou_thresh, torch.float32, dev)
    lane = torch.arange(k, device=dev)
    image = torch.arange(b, device=dev)
    live = rows[..., cols - 2].to(torch.float32)
    chosen = torch.zeros((b, max_det), dtype=torch.int64, device=dev)
    keep = torch.zeros((b, max_det), dtype=torch.bool, device=dev)
    for i in range(max_det):
        best = live.argmax(1)  # ties to the lowest index, as jnp.argmax
        is_valid = live[image, best] > float("-inf")
        suppress = (iou[image, best] > thresh) | (lane[None, :] == best[:, None])
        live = torch.where(suppress & is_valid[:, None], float("-inf"), live)
        chosen[:, i] = best
        keep[:, i] = is_valid
    # "+ 0.0": the TPU kernel's masked sum turns -0.0 into +0.0
    out = torch.take_along_dim(rows.to(torch.float32), chosen[..., None], dim=1) + 0.0
    return torch.where(keep[..., None], out, 0.0), keep


def suppress_pack_3d_mask_scan_reference(
    iou: torch.Tensor, rows: torch.Tensor, iou_thresh=0.01, max_det: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's algorithm in plain PyTorch, with the contract of
    :func:`suppress_pack_3d_reference`: the visiting order of the score
    column, the bitmask ``iou[order[p], order[q]] > thresh`` (row p the
    chosen candidate, as the loop reads its row), then the scan."""
    live = rows[..., rows.shape[-1] - 2].to(torch.float32)
    order, live_n = mask_scan.visiting_order(live)
    rows_in_order = torch.take_along_dim(iou, order[:, :, None], 1)
    sup = torch.take_along_dim(rows_in_order, order[:, None, :], 2)
    thresh = scalar_on(iou_thresh, torch.float32, rows.device)
    kept, keep = mask_scan.scan(mask_scan.pack_bits(sup > thresh), live_n, max_det)
    chosen = order.gather(1, kept)
    # "+ 0.0": the TPU kernel's masked sum turns -0.0 into +0.0
    out = torch.take_along_dim(rows.to(torch.float32), chosen[..., None], dim=1) + 0.0
    return torch.where(keep[..., None], out, 0.0), keep


def suppress_pack_3d(
    iou: torch.Tensor, rows: torch.Tensor, iou_thresh=0.01, max_det: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launch over score-sorted candidates (see
    :func:`suppress_pack_3d_reference` for the contract).

    CUDA tensors launch ``csrc/suppress_pack_3d.cu`` (three passes, one
    count); CPU tensors run :func:`suppress_pack_3d_reference`."""
    if iou.device.type == "cpu" and rows.device.type == "cpu":
        return suppress_pack_3d_reference(iou, rows, iou_thresh, max_det)
    if rows.device.type != "cuda" or iou.device != rows.device:
        raise ValueError(f"suppress_pack_3d: iou on {iou.device}, rows on {rows.device}")
    if rows.ndim != 3 or rows.shape[-1] < 3 or iou.shape != (*rows.shape[:2], rows.shape[1]):
        raise ValueError(
            f"suppress_pack_3d: iou (B, K, K) with rows (B, K, cols), got "
            f"{tuple(iou.shape)} / {tuple(rows.shape)}"
        )
    b, k, cols = rows.shape
    if not smem_fits(k, cols):
        raise ValueError(
            f"suppress_pack_3d: {k} candidates need {smem_bytes(k, cols)} B of a block's "
            "shared memory (the order pass's sort), more than it has"
        )
    iou = iou.to(torch.float32).contiguous()
    rows = rows.to(torch.float32).contiguous()
    dets = torch.empty((b, max_det, cols), dtype=torch.float32, device=rows.device)
    keep = torch.empty((b, max_det), dtype=torch.bool, device=rows.device)
    if b == 0 or max_det == 0:
        return dets, keep
    _ws, ptrs = mask_scan.workspace(rows.device, _workspace_sizes(b, k))
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    with torch.cuda.device(rows.device):
        err = cuda_build.load(SOURCE, _ARGTYPES).suppress_pack_3d_launch(
            iou.data_ptr(), rows.data_ptr(), b, k, cols, float(iou_thresh), max_det,
            dets.data_ptr(), keep.data_ptr(), *ptrs,
            mask_scan.order_smem_bytes(k), stream,
        )
    cuda_build.check_launch("suppress_pack_3d", err)
    launches.add()
    return dets, keep


def sorted_candidates(
    boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's inputs, built as the TPU function builds them: a stable
    descending score sort (-inf padding sinks), the sorted rows
    [box7, extras..., score, label], and the rotated BEV IoU matrix of the
    sorted boxes. Returns (iou (B, K, K), rows (B, K, 7+e+2))."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    sb = torch.take_along_dim(boxes, order[..., None], dim=1).to(torch.float32)
    ss = scores.gather(1, order).to(torch.float32)
    sl = labels.gather(1, order).to(torch.float32)
    bev = boxes7_to_bev(sb[..., :7])
    rows = torch.cat([sb, ss[..., None], sl[..., None]], -1)
    return rotated_iou_bev(bev, bev), rows


def fused_suppress_pack_3d(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    iou_thresh=0.01,
    max_det: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, K, 7+e) candidates + (B, K) -inf-gated scores + (B, K) 1-indexed
    labels -> packed ((B, max_det, 9+e) rows [box7, extras..., score,
    label], (B, max_det) keep): the ``_nms_pack_one`` contract. Sort and
    IoU matrix in PyTorch, suppression and packing in one kernel call."""
    iou, rows = sorted_candidates(boxes, scores, labels)
    return suppress_pack_3d(iou, rows, iou_thresh, max_det)
