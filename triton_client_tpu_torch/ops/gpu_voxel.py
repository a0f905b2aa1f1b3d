"""The fused voxelize->scatter stage of SECOND-IoU's dense middle (port of
``ops/pallas_voxel.py``): a per-cell mean volume built from one stable
sort, a hand-written CUDA sorted-segment mean and one unique-index
scatter.

Kernel: ``sorted_segment_mean`` replaces the TPU kernel
``triton_client_tpu/ops/pallas_voxel.py::sorted_segment_mean_pallas``.
Source: ``csrc/segment_mean.cu``. Given (8, N) value rows and (N,)
non-decreasing slot ids, it returns for every slot ``s < num_slots`` the
slot's row sums divided by ``max(sum of row 7, 1)``: row 7 is each row's
weight. Rows at the dump id ``num_slots`` are never read (the TPU kernel
reduces that slot as well and its caller slices it off).

What bounds it on an H100: bytes. It must read each live row's 8 values
and slot id and write 8 means a slot: at a 120k-point scan's ~41,700 live
rows (of 131,072) and 40,000 slots, about 2.8 MB (9 x 41,700 x 4 in,
8 x 40,000 x 4 out), 0.83 us at 3.35 TB/s. The design is two launches,
counted as one call: one zeroes the whole output (every empty slot's 0,
written across the card), then one thread a row finds where a slot begins
(its id differs from the previous row's, one coalesced pass, no search)
and walks that slot's rows in row order, its warp taking over 32 rows a
step past the first 32, so the sums are the same on every run and equal
the plain version's bit for bit. The second launch starts while the
first runs and waits for it before its first store.

``sorted_segment_mean`` launches the kernel for CUDA tensors and runs the
plain ``sorted_segment_mean_reference`` for CPU tensors; nothing falls
back.

``fused_mean_volume`` is the whole stage, the port of the JAX function of
that name: cell assignment, a stable sort by z-major cell id, dense slot
ranks capped at ``max_voxels`` (the grouped voxelizer's budget: past it
the overflow cells are dropped, where the unfused scatter of
``models/second.scatter_mean_volume`` keeps them), the (8, N) value rows
with the weight in row 7, the kernel, and the set-scatter of the slot
means into the (nz, ny, nx, F) volume. The TPU's padding of N to a
1024-row block is a tiling need and is not copied.
"""

from __future__ import annotations

import ctypes

import torch

from triton_client_tpu_torch.ops import cuda_build
from triton_client_tpu_torch.ops.voxelize import VoxelConfig, assign_cells, linearize_zyx

SOURCE = "segment_mean.cu"
ROWS = 8
COUNT_ROW = ROWS - 1  # the weight row, fixed so the mean never depends on F

_P, _I = ctypes.c_void_p, ctypes.c_int
# segment_mean_launch(vals, slots, n, num_slots, out, stream)
_ARGTYPES = {"segment_mean_launch": [_P, _P, _I, _I, _P, _P]}

launches = cuda_build.LaunchCounter()


def sorted_segment_mean_reference(
    valsT: torch.Tensor, slots: torch.Tensor, num_slots: int
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its summation order.

    valsT (8, N) float32, slots (N,) int32 non-decreasing -> (8, num_slots)
    float32 means. Each slot's rows are found by ``searchsorted``; the
    loop over the longest slot adds row ``start + j`` to every slot still
    that long, from +0.0, so each sum runs serially in row order as in the
    kernel."""
    n = valsT.shape[1]
    ids = torch.arange(num_slots, dtype=slots.dtype, device=slots.device)
    start = torch.searchsorted(slots, ids)
    length = torch.searchsorted(slots, ids, right=True) - start
    sums = torch.zeros((ROWS, num_slots), dtype=torch.float32, device=valsT.device)
    longest = int(length.max()) if num_slots else 0
    for j in range(longest):
        rows = valsT[:, torch.clamp(start + j, max=n - 1)]
        sums = torch.where(j < length, sums + rows, sums)
    return sums / torch.clamp(sums[COUNT_ROW:], min=1.0)


def sorted_segment_mean(valsT: torch.Tensor, slots: torch.Tensor, num_slots: int) -> torch.Tensor:
    """(8, N) float32 value rows (row 7 the weight) + (N,) int32 slot ids,
    non-decreasing, ``num_slots`` the dump id -> (8, num_slots) float32
    per-slot means. Sortedness is the caller's contract (checking it would
    cost a device sync).

    CUDA tensors launch ``csrc/segment_mean.cu``; CPU tensors run
    :func:`sorted_segment_mean_reference`."""
    if valsT.dtype != torch.float32 or slots.dtype != torch.int32:
        raise ValueError(
            f"sorted_segment_mean: valsT float32 and slots int32, got {valsT.dtype}, {slots.dtype}"
        )
    if valsT.dim() != 2 or valsT.shape[0] != ROWS or slots.shape != valsT.shape[1:]:
        raise ValueError(
            f"sorted_segment_mean: valsT ({ROWS}, N) with slots (N,), got "
            f"{tuple(valsT.shape)}, {tuple(slots.shape)}"
        )
    if num_slots < 0 or num_slots >= 2**30 or valsT.shape[1] >= 2**31:
        raise ValueError(f"sorted_segment_mean: num_slots {num_slots}, N {valsT.shape[1]}")
    if valsT.device.type == "cpu" and slots.device.type == "cpu":
        return sorted_segment_mean_reference(valsT, slots, num_slots)
    if valsT.device.type != "cuda" or slots.device != valsT.device:
        raise ValueError(f"sorted_segment_mean: inputs on {valsT.device} and {slots.device}")
    if not (valsT.is_contiguous() and slots.is_contiguous()):
        raise ValueError("sorted_segment_mean: valsT and slots must be contiguous")
    out = torch.empty((ROWS, num_slots), dtype=torch.float32, device=valsT.device)
    if num_slots == 0:
        return out
    stream = torch.cuda.current_stream(valsT.device).cuda_stream
    with torch.cuda.device(valsT.device):
        err = cuda_build.load(SOURCE, _ARGTYPES).segment_mean_launch(
            valsT.data_ptr(), slots.data_ptr(), valsT.shape[1], num_slots, out.data_ptr(), stream
        )
    cuda_build.check_launch("segment_mean", err)
    launches.add()
    return out


def slot_rows(
    points: torch.Tensor, count: torch.Tensor, voxel: VoxelConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused stage up to the kernel: (N, F<=7) padded cloud + () real
    count -> the kernel's inputs, valsT (8, N) float32 (the features times
    the weight, the weight in row 7) and slots (N,) int32 (dump id
    ``max_voxels``), and cells (max_voxels,) int64, each slot's z-major
    cell id (n_cells for an empty slot)."""
    n, f = points.shape
    if f > COUNT_ROW:
        raise ValueError(
            f"fused_mean_volume takes at most {COUNT_ROW} point features (the weight rides "
            f"row {COUNT_ROW}), got {f}"
        )
    v_cap = voxel.max_voxels
    dev = points.device
    ijk, valid = assign_cells(points, count, voxel)
    vid, n_cells = linearize_zyx(ijk, valid, voxel)

    # stable sort by cell id; a point's slot is the rank of its cell among
    # the occupied ones, and ranks past the cap go to the dump id
    order = torch.argsort(vid, stable=True)
    vid_s = vid[order]
    pts_s = points[order].to(torch.float32)
    valid_s = vid_s < n_cells
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = vid_s[1:] != vid_s[:-1]
    first &= valid_s
    slot_raw = torch.cumsum(first, 0) - 1
    keep = valid_s & (slot_raw < v_cap)
    slots = torch.where(keep, slot_raw, v_cap).to(torch.int32)
    w = keep.to(torch.float32)

    valsT = torch.zeros((ROWS, n), dtype=torch.float32, device=dev)
    valsT[:f] = (pts_s * w[:, None]).T
    valsT[COUNT_ROW] = w
    # each kept slot's cell id; the dump index v_cap takes the rest
    cslot = torch.where(first & keep, slot_raw, v_cap)
    cells = torch.full((v_cap + 1,), n_cells, dtype=torch.int64, device=dev)
    cells[cslot] = vid_s.to(torch.int64)
    return valsT, slots, cells[:v_cap]


def fused_mean_volume(
    points: torch.Tensor, count: torch.Tensor, voxel: VoxelConfig
) -> torch.Tensor:
    """(N, F<=7) padded cloud + () real count -> dense (nz, ny, nx, F)
    float32 per-cell mean volume, occupied cells capped at
    ``voxel.max_voxels`` (the lowest z-major cell ids are kept)."""
    nx, ny, nz = voxel.grid_size
    f = points.shape[1]
    valsT, slots, cells = slot_rows(points, count, voxel)
    means = sorted_segment_mean(valsT, slots, voxel.max_voxels)[:f].T  # (max_voxels, f)
    n_cells = nx * ny * nz
    canvas = torch.zeros((n_cells + 1, f), dtype=torch.float32, device=points.device)
    canvas[cells] = means  # live cells are unique; empty slots write zeros to the dump row
    return canvas[:n_cells].reshape(nz, ny, nx, f)
