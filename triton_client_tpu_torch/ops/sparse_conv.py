"""Submanifold sparse 3D convolution over a fixed occupancy budget (port of
``ops/sparse_conv.py``).

The reference serves SECOND-IoU through spconv at 0.05 m voxels, a
(40, 1600, 1408) grid of 90,112,000 cells of which a KITTI scan occupies
about 60,000. The JAX package runs that grid with static shapes: each
level is a fixed-budget voxel set, neighbours are looked up in a dense
int32 slot table over the whole grid (90,112,001 x 4 bytes = 360 MB at
level 0), and a convolution is, per kernel offset, a row gather and a
(V, Cin) x (Cin, Cout) product. This module keeps that design and its
numbers: every function takes and returns tensors of static shapes, and
nothing here reads a tensor back to the host (no ``.item()``, no
``torch.unique``, no ``nonzero``, no boolean-mask indexing), so a CUDA
graph captures the whole middle encoder.

Representation of one level, :class:`VoxelSet`:
  * ``ijk (V, 3)`` int32 cell coordinates [z, y, x] (padding rows anything),
  * ``feats (V, C)``,
  * ``valid (V,)`` bool,
  * ``grid`` (nz, ny, nx).

Operators (MinkowskiEngine semantics, as in the JAX package):
  * :func:`subm_conv`: outputs at the input sites only (spconv's
    SubMConv3d);
  * :func:`sparse_strided_conv`: a stride-2 conv whose output sites are
    unique(floor(ijk / 2)), with a 3^3 (padding 1) or 2^3 (padding 0)
    kernel.

Cell ids stay int32 values, as JAX's (the largest, 90,111,999, and the
dump id nz*ny*nx fit); they index as int64. Where JAX scatters with
``mode="drop"``, the rows past a budget are first sent to a dump row that
is sliced off, since ``index_put_`` raises (CPU) or asserts (CUDA) on an
index out of range. The sorts are stable (``jnp.argsort`` is). Sums over
the kernel's offsets run in offset order from zeros, as the JAX package's
``lax.scan``; the per-point sums of the mean VFE go through
``models/pointpillars.pillar_sums`` (each cell summed in point order on
either device).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from triton_client_tpu_torch.ops.voxelize import VoxelConfig, assign_cells


class VoxelSet(NamedTuple):
    """One sparse level: fixed-budget voxel coordinates and features."""

    ijk: torch.Tensor    # (V, 3) int32 [z, y, x]
    feats: torch.Tensor  # (V, C)
    valid: torch.Tensor  # (V,) bool
    grid: tuple[int, int, int]  # (nz, ny, nx) cell extents


def linear_ids(ijk: torch.Tensor, valid: torch.Tensor, grid) -> torch.Tensor:
    """(V,) int32 linear ids (z * ny + y) * nx + x; invalid or
    out-of-grid rows -> n_cells (the dump slot)."""
    nz, ny, nx = grid
    z, y, x = ijk.to(torch.int32).unbind(1)
    inb = valid & (z >= 0) & (z < nz) & (y >= 0) & (y < ny) & (x >= 0) & (x < nx)
    return torch.where(inb, (z * ny + y) * nx + x, nz * ny * nx)


def slot_table(vs: VoxelSet) -> torch.Tensor:
    """Dense (n_cells + 1,) int32 table: cell id -> row in the voxel set,
    -1 where unoccupied. Every invalid row writes the dump entry (in any
    order on the card), which is then reset to -1, so an out-of-grid
    neighbour never resolves to a row."""
    nz, ny, nx = vs.grid
    ids = linear_ids(vs.ijk, vs.valid, vs.grid).long()
    table = torch.full((nz * ny * nx + 1,), -1, dtype=torch.int32, device=ids.device)
    table[ids] = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)
    table[-1:].fill_(-1)  # a fill, not a host copy, so a CUDA graph captures it
    return table


def kernel_offsets(k: int = 3) -> np.ndarray:
    """(k^3, 3) [dz, dy, dx] offsets, the last dim fastest: the order of the
    sparse weights' first axis, which the importer's reshape relies on."""
    r = np.arange(k) - (k - 1) // 2
    return np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)


def offsets_on(k: int, device) -> torch.Tensor:
    """:func:`kernel_offsets` as an int32 tensor made on ``device`` from an
    arange, with no host copy (one would stop a CUDA graph's capture)."""
    i = torch.arange(k**3, dtype=torch.int32, device=device)
    c = (k - 1) // 2
    return torch.stack([i // (k * k) - c, (i // k) % k - c, i % k - c], 1)


def gather_neighbor_slots(
    table: torch.Tensor,
    vs: VoxelSet,
    offsets,
    base_scale: int = 1,
) -> torch.Tensor:
    """(K, V) int32 neighbour rows (-1 = missing). ``offsets`` (K, 3): a
    tensor on the table's device (:func:`offsets_on`) or an array.
    ``base_scale`` maps output coordinates to the finer input lattice (2
    for stride-2 convs): the neighbour of output site o is input cell
    base_scale * o + offset."""
    off = torch.as_tensor(offsets, dtype=torch.int32).to(table.device)
    k, v = off.shape[0], vs.ijk.shape[0]
    n_ijk = vs.ijk.to(torch.int32)[None] * base_scale + off[:, None, :]  # (K, V, 3)
    ids = linear_ids(n_ijk.reshape(k * v, 3), vs.valid.repeat(k), vs.grid)
    return table[ids.long()].reshape(k, v)


def offset_matmul_sum(
    in_feats: torch.Tensor,   # (V_in, Cin)
    nbr_slots: torch.Tensor,  # (K, V_out)
    weights: torch.Tensor,    # (K, Cin, Cout)
) -> torch.Tensor:
    """sum_k gather(in_feats, nbr_slots[k]) @ weights[k], the sparse conv's
    compute core. A missing neighbour (-1) reads a zero row, the zeros a
    dense conv sees at an unoccupied cell. The K products are one batched
    product over one gather; they are summed one after another from zeros,
    in offset order."""
    v_in, cin = in_feats.shape
    padded = torch.cat([in_feats, in_feats.new_zeros((1, cin))])
    slots = torch.where(nbr_slots < 0, v_in, nbr_slots).long()
    terms = torch.bmm(padded[slots], weights)  # (K, V_out, Cout)
    out = in_feats.new_zeros(terms.shape[1:])
    for term in terms:
        out = out + term
    return out


def _compact_unique(ids: torch.Tensor, budget: int, dump: int):
    """The sorted unique compaction of the downsampler and the sparse VFE:
    ``ids`` with ``dump`` marking invalid rows -> (out_ids (budget,) int32
    padded with dump, valid (budget,), order, s_ids, first, rank), rank
    being each sorted row's unique-cell index. Cells past the budget (the
    highest ids) are dropped."""
    order = torch.argsort(ids, stable=True)
    s_ids = ids[order]
    first = torch.cat([torch.ones_like(s_ids[:1], dtype=torch.bool), s_ids[1:] != s_ids[:-1]])
    first = first & (s_ids < dump)
    rank = torch.cumsum(first, 0) - 1
    # unique cells past the budget go to a dump row that is sliced off
    target = torch.where(first & (rank < budget), rank, budget)
    out_ids = torch.full((budget + 1,), dump, dtype=torch.int32, device=ids.device)
    out_ids[target] = s_ids.to(torch.int32)
    out_ids = out_ids[:budget]
    return out_ids, out_ids < dump, order, s_ids, first, rank


def _unflatten(ids: torch.Tensor, valid: torch.Tensor, grid) -> torch.Tensor:
    """(V,) linear ids -> (V, 3) int32 [z, y, x] (invalid rows zeroed)."""
    _, ny, nx = grid
    safe = torch.where(valid, ids.to(torch.int32), 0)
    return torch.stack([safe // (ny * nx), (safe // nx) % ny, safe % nx], 1)


def downsample_sites(vs: VoxelSet, budget: int) -> VoxelSet:
    """The unique(floor(ijk / 2)) output sites of a stride-2 conv, compacted
    into ``budget`` rows (the lowest ids kept). The coarse extent is
    ceil(n / 2) an axis, the dense stride-2 padding-1 output size, so an
    odd extent keeps its top plane. Features are empty (the conv fills
    them)."""
    nz, ny, nx = vs.grid
    cgrid = ((nz + 1) // 2, (ny + 1) // 2, (nx + 1) // 2)
    coarse = torch.div(vs.ijk.to(torch.int32), 2, rounding_mode="floor")
    ids = linear_ids(coarse, vs.valid, cgrid)
    dump = cgrid[0] * cgrid[1] * cgrid[2]
    out_ids, o_valid, *_ = _compact_unique(ids, budget, dump)
    o_ijk = _unflatten(out_ids, o_valid, cgrid)
    empty = torch.zeros((budget, 0), dtype=torch.float32, device=o_ijk.device)
    return VoxelSet(o_ijk, empty, o_valid, cgrid)


def subm_conv(vs: VoxelSet, table: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Submanifold 3x3x3 conv, ``weights`` (27, Cin, Cout): (V, Cout) at the
    same sites, each equal to a dense conv's there (unoccupied neighbours
    give the same zeros); padding rows 0."""
    nbr = gather_neighbor_slots(table, vs, offsets_on(3, table.device))
    out = offset_matmul_sum(vs.feats, nbr, weights)
    return torch.where(vs.valid[:, None], out, 0.0)


def sparse_strided_conv(
    vs: VoxelSet,
    table: torch.Tensor,
    weights: torch.Tensor,  # (k^3, Cin, Cout)
    budget: int,
) -> VoxelSet:
    """Stride-2 sparse conv onto the sites floor(ijk / 2). The kernel size
    comes from the weights' first axis: 27 -> 3x3x3 with padding 1
    (offsets [-1, 1]^3 around 2o, the dense stride-2 conv's values at those
    sites); 8 -> 2x2x2 with padding 0 (offsets {0, 1}^3: each input feeds
    one output, a third of the 27-offset gathers)."""
    k3 = weights.shape[0]
    k = {8: 2, 27: 3}.get(k3)
    if k is None:
        raise ValueError(f"strided conv kernel must be 2^3 or 3^3, got {k3}")
    sites = downsample_sites(vs, budget)
    scaled = VoxelSet(sites.ijk, sites.feats, sites.valid, vs.grid)
    nbr = gather_neighbor_slots(table, scaled, offsets_on(k, table.device), base_scale=2)
    out = offset_matmul_sum(vs.feats, nbr, weights)
    out = torch.where(sites.valid[:, None], out, 0.0)
    return VoxelSet(sites.ijk, out, sites.valid, sites.grid)


def densify(vs: VoxelSet) -> torch.Tensor:
    """(nz, ny, nx, C) dense volume of a voxel set: the hand-off to the
    dense tail, whose levels are small enough for real 3D convs (level 2 of
    the 0.05 m grid: 10 x 400 x 352 x 64 x 4 bytes = 360 MB). Stored
    channel-major: the result is a view of a contiguous (C, nz, ny, nx)
    volume, which ``Conv3d`` reads without a copy (``.permute(3, 0, 1,
    2)``); an invalid row's features land in a dump entry of their channel
    past the volume."""
    nz, ny, nx = vs.grid
    n, c = nz * ny * nx, vs.feats.shape[-1]
    ids = linear_ids(vs.ijk, vs.valid, vs.grid).long()
    lane = torch.arange(c, device=ids.device)
    # live sites are unique; invalid rows (id n) share each channel's dump entry
    flat = torch.where(ids[:, None] < n, lane * n + ids[:, None], c * n + lane)
    canvas = vs.feats.new_zeros(c * n + c)
    canvas[flat.reshape(-1)] = vs.feats.reshape(-1)
    return canvas[: c * n].reshape(c, nz, ny, nx).permute(1, 2, 3, 0)


def scatter_bev(vs: VoxelSet) -> torch.Tensor:
    """The z fold of the last level: (ny, nx, nz * C), channel d * C + c."""
    nz, ny, nx = vs.grid
    return densify(vs).permute(1, 2, 0, 3).reshape(ny, nx, nz * vs.feats.shape[-1])


def points_to_voxelset(
    points: torch.Tensor,  # (N, F) padded cloud
    count: torch.Tensor,   # () real rows
    voxel_cfg: VoxelConfig,
    budget: int,
) -> VoxelSet:
    """The sparse mean VFE: the occupied cells (sorted compaction, the
    ``budget`` lowest ids kept) with each cell's mean point. Each point
    past the budget or invalid adds zeros to a dump row of its own past
    the budget, so no row collects thousands of them (``pillar_sums`` sums
    a row's points one after another on the card)."""
    from triton_client_tpu_torch.models.pointpillars import pillar_sums

    nx, ny, nz = voxel_cfg.grid_size
    n, f = points.shape
    dev = points.device
    ijk_xyz, valid = assign_cells(points, count, voxel_cfg)
    ijk = ijk_xyz.flip(1)  # [x, y, z] -> [z, y, x]
    ids = linear_ids(ijk, valid, (nz, ny, nx))
    dump = nz * ny * nx
    out_ids, o_valid, order, s_ids, _, rank = _compact_unique(ids, budget, dump)
    # the voxel row of each point, in sorted order, then scattered back
    slot_sorted = torch.where((s_ids < dump) & (rank < budget), rank, budget)
    slot = torch.empty(n, dtype=torch.int64, device=dev).scatter_(0, order, slot_sorted)
    lane = torch.arange(n, device=dev)
    slot = torch.where(slot < budget, slot, budget + lane)
    w = valid.to(points.dtype)[:, None]
    acc = torch.zeros((budget + n, f + 1), dtype=points.dtype, device=dev)
    pillar_sums(acc, slot, torch.cat([points, torch.ones_like(w)], 1) * w)
    feats = acc[:budget, :f] / torch.clamp(acc[:budget, f:], min=1.0)
    v_ijk = _unflatten(out_ids, o_valid, (nz, ny, nx))
    return VoxelSet(v_ijk, torch.where(o_valid[:, None], feats, 0.0), o_valid, (nz, ny, nx))
