"""3D residual box decode + heading rectification as a hand-written CUDA
kernel (port of the 3D decode part of ``ops/pallas_decode.py``).

Replaces the TPU kernel ``triton_client_tpu/ops/pallas_decode.py::
fused_residual_decode`` (body ``_residual_decode_kernel``): the K top-k
candidates' anchor-residual decode (``models/pointpillars.decode_boxes``)
and direction-bin rectification (``rectify_direction``) in one launch.
Source: ``csrc/residual_decode_3d.cu``.

What bounds it on an H100: launch latency. It is elementwise, one thread
per candidate over the whole batch; its bytes (92 a candidate: 7 + 7
floats in, an int64 bin, 7 floats out; 23.5 KB at K = 256) take about
7 ns at 3.35 TB/s. The design is one pass with no shared memory, reading
the AoS rows the top-k gather leaves, so no transposes are added around
it.

``fused_residual_decode`` launches the kernel for CUDA tensors and runs
the plain ``residual_decode_reference`` for CPU tensors; nothing falls
back.
"""

from __future__ import annotations

import ctypes

import torch

from triton_client_tpu_torch.models.pointpillars import decode_residual, direction_constants
from triton_client_tpu_torch.ops import cuda_build

SOURCE = "residual_decode_3d.cu"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# residual_decode_3d_launch(deltas, anchors, dir_bin, n, period, dir_offset,
#                           boxes, stream)
_ARGTYPES = {"residual_decode_3d_launch": [_P, _P, _P, _I, _F, _F, _P, _P]}

launches = cuda_build.LaunchCounter()


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
