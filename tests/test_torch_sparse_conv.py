"""The port's ``ops/sparse_conv.py`` against the JAX package's, op by op,
on the CPU, on inputs made from a seed with numpy.

Bars and why:
  * integers exactly equal: linear ids, slot tables, neighbour slots, the
    compaction's outputs (ids, validity, sort order, sorted ids, first
    flags, ranks), unflattened coordinates and site sets, including a budget
    that overflows and an odd extent's top plane;
  * data movement bitwise (``densify``, ``scatter_bev``): it copies rows;
  * features of a convolution within rtol 1e-5, atol 1e-6: both sum the K
    offsets in the same order from zeros, but each (V, Cin) x (Cin, Cout)
    product is summed over Cin in the order of its own library (XLA's dot
    against PyTorch's batched product);
  * the mean VFE's features bitwise: both sum each cell in point order
    from +0.0 and divide once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_client_tpu.ops import sparse_conv as jsp
from triton_client_tpu.ops import voxelize as jvox

from triton_client_tpu_torch.ops import sparse_conv as tsp
from triton_client_tpu_torch.ops import voxelize as tvox
from torch_threads import one_torch_thread  # noqa: F401

GRID = (4, 6, 8)  # (nz, ny, nx)
RTOL, ATOL = 1e-5, 1e-6


def voxel_pair(seed, n_occ, c=5, budget=64, grid=GRID, junk_padding=False):
    """One seeded voxel set in both packages: ``n_occ`` distinct occupied
    cells, then padding rows (zeros, or with ``junk_padding`` coordinates
    out of the grid and features that must not leak)."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = grid
    cells = rng.choice(nz * ny * nx, size=n_occ, replace=False)
    ijk = np.zeros((budget, 3), np.int32)
    ijk[:n_occ] = np.stack([cells // (ny * nx), (cells // nx) % ny, cells % nx], 1)
    feats = np.zeros((budget, c), np.float32)
    feats[:n_occ] = rng.normal(size=(n_occ, c))
    if junk_padding:
        ijk[n_occ:] = rng.integers(-3, max(grid) + 3, size=(budget - n_occ, 3))
        feats[n_occ:] = rng.normal(size=(budget - n_occ, c))
    valid = np.arange(budget) < n_occ
    j = jsp.VoxelSet(jnp.asarray(ijk), jnp.asarray(feats), jnp.asarray(valid), grid)
    t = tsp.VoxelSet(torch.from_numpy(ijk), torch.from_numpy(feats), torch.from_numpy(valid), grid)
    return j, t


def eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def sites(vs) -> set:
    ijk, valid = np.asarray(vs.ijk), np.asarray(vs.valid)
    return {tuple(r) for r in ijk[valid]}


@pytest.mark.parametrize("junk", [False, True])
def test_linear_ids_and_slot_table_equal_jax(junk):
    j, t = voxel_pair(0, 20, junk_padding=junk)
    ids = tsp.linear_ids(t.ijk, t.valid, GRID)
    assert ids.dtype == torch.int32
    eq(ids, jsp.linear_ids(j.ijk, j.valid, GRID))
    table = tsp.slot_table(t)
    assert table.dtype == torch.int32 and int(table[-1]) == -1
    eq(table, jsp.slot_table(j))


@pytest.mark.parametrize("k", [2, 3])
def test_kernel_offsets_in_the_jax_order(k):
    np.testing.assert_array_equal(tsp.kernel_offsets(k), jsp.kernel_offsets(k))
    eq(tsp.offsets_on(k, "cpu"), jsp.kernel_offsets(k).astype(np.int32))


@pytest.mark.parametrize("k,base_scale", [(3, 1), (3, 2), (2, 2)])
def test_gather_neighbor_slots_equal_jax(k, base_scale):
    j, t = voxel_pair(1, 30, junk_padding=True)
    jt, tt = jsp.slot_table(j), tsp.slot_table(t)
    if base_scale == 2:  # output sites on the coarse lattice, read against the fine table
        j = j._replace(ijk=j.ijk // 2)
        t = t._replace(ijk=t.ijk // 2)
    want = jsp.gather_neighbor_slots(jt, j, jsp.kernel_offsets(k), base_scale)
    eq(tsp.gather_neighbor_slots(tt, t, tsp.offsets_on(k, "cpu"), base_scale), want)
    eq(tsp.gather_neighbor_slots(tt, t, tsp.kernel_offsets(k), base_scale), want)


def test_offset_matmul_sum_within_rtol():
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(50, 6)).astype(np.float32)
    slots = rng.integers(-1, 50, size=(27, 40)).astype(np.int32)
    w = rng.normal(size=(27, 6, 9)).astype(np.float32)
    want = jsp.offset_matmul_sum(jnp.asarray(feats), jnp.asarray(slots), jnp.asarray(w))
    got = tsp.offset_matmul_sum(torch.from_numpy(feats), torch.from_numpy(slots),
                                torch.from_numpy(w))
    close(got, want)
    # a slot of -1 reads zeros: an all-missing row is exactly 0
    slots[:, 0] = -1
    got = tsp.offset_matmul_sum(torch.from_numpy(feats), torch.from_numpy(slots),
                                torch.from_numpy(w))
    assert not got[0].any()


@pytest.mark.parametrize("budget", [4, 16, 64])
def test_compact_unique_equals_jax_with_ties_and_overflow(budget):
    """Repeated ids (the stable sort's ties), dump rows and a budget the
    unique cells overflow at 4 and 16."""
    rng = np.random.default_rng(3)
    dump = 100
    ids = rng.integers(0, 30, size=48).astype(np.int32)
    ids[rng.random(48) < 0.25] = dump
    want = jsp._compact_unique(jnp.asarray(ids), budget, dump)
    got = tsp._compact_unique(torch.from_numpy(ids), budget, dump)
    for g, w in zip(got, want):
        eq(g, w)
    assert int(got[1].sum()) == min(budget, len(set(ids.tolist()) - {dump}))


def test_unflatten_equals_jax():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 4 * 6 * 8 + 1, size=40).astype(np.int32)
    valid = ids < 4 * 6 * 8
    eq(tsp._unflatten(torch.from_numpy(ids), torch.from_numpy(valid), GRID),
       jsp._unflatten(jnp.asarray(ids), jnp.asarray(valid), GRID))


@pytest.mark.parametrize("n_occ,budget", [(24, 64), (40, 4)])
def test_downsample_sites_equal_jax(n_occ, budget):
    """The budget overflow keeps the same lowest cells in both packages."""
    j, t = voxel_pair(5, n_occ, junk_padding=True)
    want, got = jsp.downsample_sites(j, budget), tsp.downsample_sites(t, budget)
    assert got.grid == want.grid == (2, 3, 4)
    eq(got.ijk, want.ijk)
    eq(got.valid, want.valid)
    assert got.feats.shape == want.feats.shape == (budget, 0)
    assert int(got.valid.sum()) == min(budget, len({tuple(r // 2) for r in
                                                    np.asarray(j.ijk)[:n_occ]}))


def test_downsample_odd_extent_keeps_the_top_plane():
    """After tests/test_sparse_conv.py: coarse extents are ceil(n / 2), so a
    site whose floor(ijk / 2) lands in the last plane stays."""
    grid = (5, 6, 8)
    ijk = np.array([[4, 5, 7], [0, 0, 0]], np.int32)
    j = jsp.VoxelSet(jnp.asarray(ijk), jnp.zeros((2, 3)), jnp.ones((2,), bool), grid)
    t = tsp.VoxelSet(torch.from_numpy(ijk), torch.zeros((2, 3)), torch.ones(2, dtype=torch.bool),
                     grid)
    want, got = jsp.downsample_sites(j, 8), tsp.downsample_sites(t, 8)
    assert got.grid == want.grid == (3, 3, 4)
    eq(got.ijk, want.ijk)
    eq(got.valid, want.valid)
    assert sites(got) == {(2, 2, 3), (0, 0, 0)}


@pytest.mark.parametrize("junk", [False, True])
def test_subm_conv_equals_jax(junk):
    j, t = voxel_pair(6, 20, junk_padding=junk)
    w = np.random.default_rng(7).normal(size=(27, 5, 7)).astype(np.float32)
    want = jsp.subm_conv(j, jsp.slot_table(j), jnp.asarray(w))
    got = tsp.subm_conv(t, tsp.slot_table(t), torch.from_numpy(w))
    close(got, want)
    assert not got[20:].any()  # padding rows stay 0


@pytest.mark.parametrize("k3,budget", [(27, 64), (8, 64), (8, 6)])
def test_sparse_strided_conv_equals_jax(k3, budget):
    j, t = voxel_pair(8, 24, junk_padding=True)
    w = np.random.default_rng(9).normal(size=(k3, 5, 6)).astype(np.float32)
    want = jsp.sparse_strided_conv(j, jsp.slot_table(j), jnp.asarray(w), budget)
    got = tsp.sparse_strided_conv(t, tsp.slot_table(t), torch.from_numpy(w), budget)
    assert got.grid == want.grid
    eq(got.ijk, want.ijk)
    eq(got.valid, want.valid)
    close(got.feats, want.feats)


def test_sparse_strided_conv_refuses_other_kernels():
    _, t = voxel_pair(10, 8)
    for mod, vs, w in ((tsp, t, torch.zeros((64, 5, 4))), (jsp, voxel_pair(10, 8)[0],
                                                            jnp.zeros((64, 5, 4)))):
        with pytest.raises(ValueError, match="2\\^3 or 3\\^3"):
            mod.sparse_strided_conv(vs, mod.slot_table(vs), w, 16)


@pytest.mark.parametrize("junk", [False, True])
def test_densify_and_scatter_bev_bitwise(junk):
    j, t = voxel_pair(11, 30, junk_padding=junk)
    eq(tsp.densify(t), jsp.densify(j))
    bev = tsp.scatter_bev(t)
    assert bev.shape == (6, 8, 4 * 5)
    eq(bev, jsp.scatter_bev(j))


TINY_VOXEL = dict(point_cloud_range=(0.0, -4.0, -2.0, 8.0, 4.0, 2.0), voxel_size=(1.0, 1.0, 1.0),
                  max_voxels=64, max_points_per_voxel=8)


def tiny_cloud(seed, n, bucket=256):
    rng = np.random.default_rng(seed)
    pts = np.zeros((bucket, 4), np.float32)
    pts[:n] = np.column_stack([rng.uniform(-1, 9, n), rng.uniform(-5, 5, n),
                               rng.uniform(-2.5, 2.5, n), rng.uniform(0, 1, n)])
    return pts


@pytest.mark.parametrize("n,budget", [(40, 64), (200, 64), (200, 16)])
def test_points_to_voxelset_equals_jax(n, budget):
    """Points outside the range and a budget the occupied cells overflow
    (200 points, 16 rows): the same cells kept, the same means."""
    pts = tiny_cloud(12 + n, n)
    want = jsp.points_to_voxelset(jnp.asarray(pts), jnp.asarray(n), jvox.VoxelConfig(**TINY_VOXEL),
                                  budget)
    got = tsp.points_to_voxelset(torch.from_numpy(pts), torch.tensor(n),
                                 tvox.VoxelConfig(**TINY_VOXEL), budget)
    assert got.grid == want.grid == (4, 8, 8)
    eq(got.ijk, want.ijk)
    eq(got.valid, want.valid)
    eq(got.feats, want.feats)
    if budget == 16:
        assert bool(got.valid.all())


def test_points_to_voxelset_and_slot_table_at_the_reference_grid():
    """The 0.05 m grid of data/kitti_second_sparse005.yaml, (40, 1600, 1408)
    cells, a seeded 20,000-point cloud in a 32,768-row bucket: the level-0
    voxel set and its 90,112,001-entry slot table equal JAX's."""
    voxel = dict(point_cloud_range=(0.0, -40.0, -3.0, 70.4, 40.0, 1.0),
                 voxel_size=(0.05, 0.05, 0.1), max_voxels=65536, max_points_per_voxel=5)
    rng = np.random.default_rng(20)
    n = 20000
    pts = np.zeros((32768, 4), np.float32)
    pts[:n] = np.column_stack([rng.uniform(0, 70, n), rng.uniform(-40, 40, n),
                               rng.uniform(-3, 1, n), rng.uniform(0, 1, n)])
    want = jsp.points_to_voxelset(jnp.asarray(pts), jnp.asarray(n), jvox.VoxelConfig(**voxel),
                                  65536)
    got = tsp.points_to_voxelset(torch.from_numpy(pts), torch.tensor(n),
                                 tvox.VoxelConfig(**voxel), 65536)
    assert got.grid == want.grid == (40, 1600, 1408)
    eq(got.ijk, want.ijk)
    eq(got.valid, want.valid)
    eq(got.feats, want.feats)
    assert 19000 < int(got.valid.sum()) <= n
    want_table = np.asarray(jsp.slot_table(want))
    got_table = tsp.slot_table(got)
    assert got_table.shape == (40 * 1600 * 1408 + 1,) == want_table.shape
    assert np.array_equal(got_table.numpy(), want_table)
    del want_table
