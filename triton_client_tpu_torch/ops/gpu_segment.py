"""The segment sum of packed ragged batches (kernel 6).

Kernel: ``segment_sum`` replaces the TPU kernel
``triton_client_tpu/parallel/ragged_kernels.py::segment_sum_pallas``.
Source: ``csrc/segment_sum.cu``. Given values (R, F) and segment ids (R,)
in any order, it returns ``out[s, f] = sum of v[r, f] over the rows r
with ids[r] == s`` for ``0 <= s < num_segments``, float32; rows whose id
lies outside [0, num_segments) are dropped (the packing's pad id among
them). R = 0 and ``num_segments`` = 0 are allowed.

What bounds it on an H100: bytes, every row's id and the kept rows'
values read once. R is 10^5-10^6 on the ragged path while S x F is ~32, so
the kernel gets its parallelism from the rows: pass 1 gives each block a
chunk of ``CHUNK`` rows and each thread a (segment, feature) sum over the
chunk in row order; pass 2 adds the chunk sums in chunk order. No atomics,
so the result is the same on every run (``index_add_`` on CUDA sums with
atomics in an order that changes from run to run).

``segment_sum_reference`` is the plain version in that order: it equals
the kernel bit for bit. On the CPU it is what ``segment_sum`` runs.
``segment_sum`` launches the kernel for CUDA tensors; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from triton_client_tpu_torch.ops import cuda_build

SOURCE = "segment_sum.cu"
CHUNK = 1024  # rows a pass-1 block sums (kChunk in the source)
_F_TILE, _THREADS, _GRID_YZ = 8, 256, 65535

_P, _I = ctypes.c_void_p, ctypes.c_int
# segment_sum_launch(vals, ids, r, f, s, partial, out, stream)
_ARGTYPES = {"segment_sum_launch": [_P, _P, _I, _I, _I, _P, _P, _P]}

launches = cuda_build.LaunchCounter()


def segment_sum_reference(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its summation order.

    values (R, F) float32, segment_ids (R,) integer -> (num_segments, F)
    float32. Rows are cut into chunks of ``CHUNK``; step j adds row j of
    every chunk into that chunk's sum of the row's segment (an index_put
    with one index per chunk, so no two writes meet; rows with an
    out-of-range id go to a dump slot), then the chunk sums are added in
    chunk order, each sum from +0.0."""
    r, f = values.shape
    dev = values.device
    out = torch.zeros((num_segments, f), dtype=torch.float32, device=dev)
    if r == 0 or num_segments == 0 or f == 0:
        return out
    chunks = -(-r // CHUNK)
    pad = chunks * CHUNK - r
    ids = segment_ids.to(torch.int64)
    slot = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    slot = torch.nn.functional.pad(slot, (0, pad), value=num_segments).view(chunks, CHUNK)
    vals = torch.nn.functional.pad(values.to(torch.float32), (0, 0, 0, pad)).view(chunks, CHUNK, f)
    part = torch.zeros((chunks, num_segments + 1, f), dtype=torch.float32, device=dev)
    chunk = torch.arange(chunks, device=dev)
    for j in range(min(CHUNK, r)):
        idx = slot[:, j]
        part[chunk, idx] = part[chunk, idx] + vals[:, j]
    for c in range(chunks):
        out = out + part[c, :num_segments]
    return out


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(R, F) values (cast to float32) + (R,) integer segment ids (cast to
    int32, as the TPU kernel casts them) -> (num_segments, F) float32
    segment sums, out-of-range ids dropped.

    CUDA tensors launch ``csrc/segment_sum.cu`` on the current stream;
    CPU tensors run :func:`segment_sum_reference`."""
    if values.dim() != 2 or segment_ids.dim() != 1 or segment_ids.shape[0] != values.shape[0]:
        raise ValueError(
            f"segment_sum: values (R, F) with segment_ids (R,), got {tuple(values.shape)}, "
            f"{tuple(segment_ids.shape)}"
        )
    if segment_ids.dtype.is_floating_point or segment_ids.dtype == torch.bool:
        raise ValueError(f"segment_sum: integer segment_ids, got {segment_ids.dtype}")
    r, f = values.shape
    s_tile = min(num_segments, _THREADS // max(1, min(f, _F_TILE)))
    if (num_segments < 0 or r >= 2**31 or num_segments * f >= 2**31
            or (s_tile and -(-num_segments // s_tile) > _GRID_YZ)
            or -(-f // _F_TILE) > _GRID_YZ):
        raise ValueError(f"segment_sum: num_segments {num_segments}, values {tuple(values.shape)}")
    if values.device.type == "cpu" and segment_ids.device.type == "cpu":
        return segment_sum_reference(values, segment_ids, num_segments)
    if values.device.type != "cuda" or segment_ids.device != values.device:
        raise ValueError(f"segment_sum: inputs on {values.device} and {segment_ids.device}")
    vals = values.to(torch.float32).contiguous()
    ids = segment_ids.to(torch.int32).contiguous()
    out = torch.empty((num_segments, f), dtype=torch.float32, device=vals.device)
    if num_segments == 0 or f == 0:
        return out
    partial = torch.empty((-(-r // CHUNK), num_segments, f), dtype=torch.float32,
                          device=vals.device)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    with torch.cuda.device(vals.device):
        err = cuda_build.load(SOURCE, _ARGTYPES).segment_sum_launch(
            vals.data_ptr(), ids.data_ptr(), r, f, num_segments, partial.data_ptr(),
            out.data_ptr(), stream,
        )
    cuda_build.check_launch("segment_sum", err)
    launches.add()
    return out
