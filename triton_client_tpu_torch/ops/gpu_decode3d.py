"""3D residual box decode + heading rectification as a hand-written CUDA
kernel (port of the 3D decode part of ``ops/pallas_decode.py``).

Replaces the TPU kernel ``triton_client_tpu/ops/pallas_decode.py::
fused_residual_decode`` (body ``_residual_decode_kernel``): the K top-k
candidates' anchor-residual decode (``models/pointpillars.decode_boxes``)
and direction-bin rectification (``rectify_direction``) in one launch.
Source: ``csrc/residual_decode_3d.cu``, in two forms:

  * ``fused_residual_decode(deltas, anchors, dir_bin)`` takes the
    candidates' rows as the TPU kernel takes them;
  * ``gather_residual_decode(box_head, anchors, dir_logits, top_idx)``
    reads them itself through the top-k indices: each candidate's box-head
    row, anchor and direction logits, whose argmax is its bin. The fused 3D
    route calls it, so no gather runs between the top-k and the kernel (on
    the TPU, XLA fuses those gathers into the program around the Pallas
    call).

What bounds it on an H100: launch latency. It is elementwise, one thread
per candidate over the whole batch; its bytes (92 a candidate: 7 + 7
floats in, an int64 bin, 7 floats out; 23.5 KB at K = 256; gathered, 28 +
28 + 4 nb + 8 + 28) take about 7 ns at 3.35 TB/s. The design is one pass
with no shared memory, and the gathered form takes the four gathers'
launches off the stage.

Both wrappers launch the kernel for CUDA tensors and run a plain version
for CPU tensors (``residual_decode_reference``, and
``gather_residual_decode_reference`` over the same gathers as
``topk_candidates``); nothing falls back. ``launches`` counts the
kernel's launches in either form, ``gathered_launches`` those of the
gathered form.
"""

from __future__ import annotations

import ctypes

import torch

from triton_client_tpu_torch.models.pointpillars import decode_residual, direction_constants
from triton_client_tpu_torch.ops import cuda_build

SOURCE = "residual_decode_3d.cu"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# residual_decode_3d_launch(deltas, anchors, dir_bin, n, period, dir_offset,
#                           boxes, stream);
# gather_residual_decode_3d_launch(box_head, anchors, dir_logits, top_idx,
#                                  batch, n_rows, k, nb, period, dir_offset,
#                                  boxes, stream)
_ARGTYPES = {
    "residual_decode_3d_launch": [_P, _P, _P, _I, _F, _F, _P, _P],
    "gather_residual_decode_3d_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _P],
}

launches = cuda_build.LaunchCounter()
gathered_launches = cuda_build.LaunchCounter()


def residual_decode_reference(
    deltas: torch.Tensor,
    anchors: torch.Tensor,
    dir_bin: torch.Tensor,
    num_dir_bins: int = 2,
    dir_offset: float = 0.78539,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, operation for operation: the
    unfused op chain ``models/pointpillars.decode_residual``.

    deltas and anchors (..., 7) float32, dir_bin (...,) integer ->
    (..., 7) boxes [x, y, z, dx, dy, dz, heading]. Each product and sum
    rounds on its own, as in the kernel built with ``--fmad=false``."""
    return decode_residual(
        deltas.to(torch.float32), anchors.to(torch.float32), dir_bin, num_dir_bins, dir_offset
    )


def fused_residual_decode(
    deltas: torch.Tensor,
    anchors: torch.Tensor,
    dir_bin: torch.Tensor,
    num_dir_bins: int = 2,
    dir_offset: float = 0.78539,
) -> torch.Tensor:
    """(..., 7) deltas + (..., 7) anchors + (...,) direction bins ->
    (..., 7) decoded boxes with rectified headings, in one launch.

    CUDA tensors launch ``csrc/residual_decode_3d.cu``; CPU tensors run
    :func:`residual_decode_reference`."""
    tensors = (deltas, anchors, dir_bin)
    if all(t.device.type == "cpu" for t in tensors):
        return residual_decode_reference(deltas, anchors, dir_bin, num_dir_bins, dir_offset)
    if deltas.device.type != "cuda" or any(t.device != deltas.device for t in tensors):
        raise ValueError(f"fused_residual_decode: inputs on {[str(t.device) for t in tensors]}")
    if (
        deltas.shape[-1:] != (7,)
        or anchors.shape != deltas.shape
        or dir_bin.shape != deltas.shape[:-1]
    ):
        raise ValueError(
            "fused_residual_decode: deltas and anchors (..., 7) with dir_bin (...,), got "
            f"{[tuple(t.shape) for t in tensors]}"
        )
    deltas = deltas.to(torch.float32).contiguous()
    anchors = anchors.to(torch.float32).contiguous()
    dir_bin = dir_bin.to(torch.int64).contiguous()
    boxes = torch.empty_like(deltas)
    n = dir_bin.numel()
    if n == 0:
        return boxes
    period, offset = direction_constants(num_dir_bins, dir_offset)
    stream = torch.cuda.current_stream(deltas.device).cuda_stream
    with torch.cuda.device(deltas.device):
        err = cuda_build.load(SOURCE, _ARGTYPES).residual_decode_3d_launch(
            deltas.data_ptr(), anchors.data_ptr(), dir_bin.data_ptr(), n, period, offset,
            boxes.data_ptr(), stream,
        )
    cuda_build.check_launch("residual_decode_3d", err)
    launches.add()
    return boxes


def gather_residual_decode_reference(
    box_head: torch.Tensor,
    anchors: torch.Tensor,
    dir_logits: torch.Tensor,
    top_idx: torch.Tensor,
    num_dir_bins: int = 2,
    dir_offset: float = 0.78539,
) -> torch.Tensor:
    """Plain PyTorch version of the gathered form: the gathers of
    ``topk_candidates`` (``take_along_dim`` of the box head and of the
    direction logits, whose ``argmax`` takes the first maximum with a NaN
    above every number; ``anchors[top_idx]``), then
    :func:`residual_decode_reference`."""
    idx = top_idx[..., None]
    return residual_decode_reference(
        torch.take_along_dim(box_head, idx, dim=1),
        anchors[top_idx],
        torch.take_along_dim(dir_logits, idx, dim=1).argmax(-1),
        num_dir_bins,
        dir_offset,
    )


def gather_residual_decode(
    box_head: torch.Tensor,
    anchors: torch.Tensor,
    dir_logits: torch.Tensor,
    top_idx: torch.Tensor,
    num_dir_bins: int = 2,
    dir_offset: float = 0.78539,
) -> torch.Tensor:
    """(B, N, 7) box head + (N, 7) anchors + (B, N, nb) direction logits
    + (B, K) top-k indices -> (B, K, 7) decoded boxes with rectified
    headings, in one launch that reads each candidate's rows through
    ``top_idx``. An index outside [0, N) gives a NaN row on the card
    (the CPU's gathers raise).

    CUDA tensors launch ``csrc/residual_decode_3d.cu``'s gathered form;
    CPU tensors run :func:`gather_residual_decode_reference`."""
    tensors = (box_head, anchors, dir_logits, top_idx)
    if all(t.device.type == "cpu" for t in tensors):
        return gather_residual_decode_reference(
            box_head, anchors, dir_logits, top_idx, num_dir_bins, dir_offset
        )
    if box_head.device.type != "cuda" or any(t.device != box_head.device for t in tensors):
        raise ValueError(f"gather_residual_decode: inputs on {[str(t.device) for t in tensors]}")
    if (
        box_head.ndim != 3
        or box_head.shape[-1] != 7
        or anchors.shape != (box_head.shape[1], 7)
        or dir_logits.shape != (*box_head.shape[:2], num_dir_bins)
        or top_idx.ndim != 2
        or top_idx.shape[0] != box_head.shape[0]
        or top_idx.dtype.is_floating_point
    ):
        raise ValueError(
            "gather_residual_decode: box_head (B, N, 7), anchors (N, 7), dir_logits "
            f"(B, N, {num_dir_bins}) and integer top_idx (B, K), got "
            f"{[(tuple(t.shape), str(t.dtype)) for t in tensors]}"
        )
    box_head = box_head.to(torch.float32).contiguous()
    anchors = anchors.to(torch.float32).contiguous()
    dir_logits = dir_logits.to(torch.float32).contiguous()
    top_idx = top_idx.to(torch.int64).contiguous()
    b, n_rows = box_head.shape[:2]
    k = top_idx.shape[1]
    boxes = torch.empty((b, k, 7), dtype=torch.float32, device=box_head.device)
    if b * k == 0:
        return boxes
    period, offset = direction_constants(num_dir_bins, dir_offset)
    stream = torch.cuda.current_stream(box_head.device).cuda_stream
    with torch.cuda.device(box_head.device):
        err = cuda_build.load(SOURCE, _ARGTYPES).gather_residual_decode_3d_launch(
            box_head.data_ptr(), anchors.data_ptr(), dir_logits.data_ptr(), top_idx.data_ptr(),
            b, n_rows, k, num_dir_bins, period, offset, boxes.data_ptr(), stream,
        )
    cuda_build.check_launch("gather_residual_decode_3d", err)
    launches.add()
    gathered_launches.add()
    return boxes
