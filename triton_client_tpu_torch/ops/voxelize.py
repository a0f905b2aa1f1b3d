"""Static-shape point-cloud voxelization (port of ``ops/voxelize.py``).

Fixed budgets as in the JAX package: N points in (padded), V voxels
out, K points per voxel; overflow past V voxels or K points a voxel is
dropped, the budget semantics of the OpenPCDet voxel generators. Points
are grouped by a stable sort on their linearized cell id; segment starts
come from neighbour comparison and the rank within a segment from a
running max (``torch.cummax`` where the JAX code uses
``associative_scan``). Every write is a vectorized scatter whose live
indices are unique, so the result is the same on the CPU and on CUDA.

Returns the grouped wire contract: voxels (V, K, F), coords (V, 3)
[z, y, x], num_points_per_voxel (V,), voxel_valid (V,).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class VoxelConfig:
    """Grid geometry; the defaults are KITTI PointPillars'
    (``data/kitti_pointpillars.yaml``)."""

    point_cloud_range: tuple[float, float, float, float, float, float] = (
        0.0, -39.68, -3.0, 69.12, 39.68, 1.0,
    )
    voxel_size: tuple[float, float, float] = (0.16, 0.16, 4.0)
    max_voxels: int = 16000
    max_points_per_voxel: int = 32
    # raw per-point features fed to the VFE: 4 = [x, y, z, intensity]
    point_features: int = 4

    @property
    def grid_size(self) -> tuple[int, int, int]:
        """(nx, ny, nz) voxel grid dims."""
        r, v = self.point_cloud_range, self.voxel_size
        return (
            int(round((r[3] - r[0]) / v[0])),
            int(round((r[4] - r[1]) / v[1])),
            int(round((r[5] - r[2]) / v[2])),
        )


def _f32(values, device) -> torch.Tensor:
    """Config floats as a float32 tensor, as ``jnp.asarray`` rounds them."""
    return torch.tensor(values, dtype=torch.float32, device=device)


_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def xla_f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 by XLA's rule (``jnp.astype(jnp.int32)``), the same
    on every device: truncation toward zero, NaN to 0, values at or past
    2^31 to 2147483647 and below -2^31 to -2147483648. PyTorch's own cast
    leaves those cases to the hardware (-2147483648 for all of them on an
    x86 CPU). 2147483647 is not a float32, so the saturated cases are
    chosen on the float comparison and only values in range are cast."""
    hi, lo = x >= 2.0**31, x < -(2.0**31)
    inside = torch.where(hi | lo | torch.isnan(x), torch.zeros_like(x), x)
    out = inside.to(torch.int32)
    out = torch.where(hi, torch.full_like(out, _I32_MAX), out)
    return torch.where(lo, torch.full_like(out, _I32_MIN), out)


def assign_cells(
    points: torch.Tensor, num_points: torch.Tensor, config: VoxelConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, F>=3) padded cloud -> (ijk (N, 3) int32 [x, y, z] cell, valid
    (N,) bool). The one source of the grid-boundary rule for the grouped
    voxelizer and the scatter VFE. The cell index converts as JAX converts
    it (:func:`xla_f32_to_i32`): a NaN coordinate lands in cell 0 of its
    axis and stays in, as in the reference."""
    n = points.shape[0]
    dev = points.device
    r = _f32(config.point_cloud_range, dev)
    vs = _f32(config.voxel_size, dev)
    ijk = xla_f32_to_i32(torch.floor((points[:, :3] - r[:3]) / vs))
    hi = torch.tensor(config.grid_size, dtype=torch.int32, device=dev)
    valid = ((ijk >= 0) & (ijk < hi)).all(dim=1)
    valid &= torch.arange(n, device=dev) < num_points
    return ijk, valid


def linearize_zyx(
    ijk: torch.Tensor, valid: torch.Tensor, config: VoxelConfig
) -> tuple[torch.Tensor, int]:
    """[x, y, z] cells -> the z-major cell id ((z*ny + y)*nx + x); invalid
    rows get the dump id n_cells. Returns (vid, n_cells)."""
    nx, ny, nz = config.grid_size
    n_cells = nx * ny * nz
    vid = (ijk[:, 2] * ny + ijk[:, 1]) * nx + ijk[:, 0]
    return torch.where(valid, vid, n_cells), n_cells


def voxelize(
    points: torch.Tensor, num_points: torch.Tensor, config: VoxelConfig
) -> dict[str, torch.Tensor]:
    """points (N, F) padded cloud (xyz first), num_points () real rows ->
    voxels (V, K, F), coords (V, 3) [z, y, x] (-1 where invalid),
    num_points_per_voxel (V,) int32, voxel_valid (V,) bool."""
    n, f = points.shape
    dev = points.device
    v_cap, k_cap = config.max_voxels, config.max_points_per_voxel

    ijk, in_range = assign_cells(points, num_points, config)
    vid, sentinel = linearize_zyx(ijk, in_range, config)

    order = torch.argsort(vid, stable=True)
    vid_s = vid[order]
    pts_s = points[order]
    valid_s = vid_s < sentinel

    # segment starts -> voxel slots; rank within the segment -> point slots
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = vid_s[1:] != vid_s[:-1]
    first &= valid_s
    voxel_slot = torch.cumsum(first, 0) - 1
    lane = torch.arange(n, device=dev)
    start_of_mine = torch.cummax(torch.where(first, lane, 0), 0).values
    point_slot = lane - start_of_mine

    keep = valid_s & (voxel_slot < v_cap) & (point_slot < k_cap)
    vslot = torch.where(keep, voxel_slot, v_cap)  # overflow -> dropped row
    pslot = torch.where(keep, point_slot, k_cap)

    voxels = torch.zeros((v_cap + 1, k_cap + 1, f), dtype=points.dtype, device=dev)
    voxels[vslot, pslot] = pts_s  # live (vslot, pslot) pairs are unique
    counts = torch.bincount(vslot, minlength=v_cap + 1)[:v_cap].to(torch.int32)

    ijk_s = ijk[order]
    coords = torch.full((v_cap + 1, 3), -1, dtype=torch.int32, device=dev)
    cslot = torch.where(first & (voxel_slot < v_cap), voxel_slot, v_cap)
    coords[cslot] = ijk_s.flip(1)  # [z, y, x], the 3D wire contract
    return {
        "voxels": voxels[:v_cap, :k_cap],
        "coords": coords[:v_cap],
        "num_points_per_voxel": counts,
        "voxel_valid": counts > 0,
    }


def pad_points(points: np.ndarray, n_budget: int) -> tuple[np.ndarray, int]:
    """Host-side: pad or truncate a raw (M, F) cloud to the static
    (n_budget, F) input; returns (padded, real_count)."""
    m = min(points.shape[0], n_budget)
    out = np.zeros((n_budget, points.shape[1]), points.dtype)
    out[:m] = points[:m]
    return out, m
