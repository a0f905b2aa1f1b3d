"""Cell assignment of non-finite and huge coordinates, against the JAX
package, on the CPU.

The port converts the floored cell index to int32 by XLA's rule
(``ops/voxelize.xla_f32_to_i32``): NaN to 0, saturation at the int32
limits, truncation in range. PyTorch's own cast on an x86 CPU maps all of
those cases to -2147483648, which dropped a point with a NaN x where the
reference keeps it in cell x = 0. The cases here hold the rule at the
cast, at ``assign_cells`` and ``voxelize``, and end to end: one NaN point
spreads its NaN through the convolutions to every score, so both packages
keep no detection (the reference's semantics; nothing filters NaN).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_client_tpu.ops import voxelize as jvox
from triton_client_tpu_torch.ops import kernel_cases
from triton_client_tpu_torch.ops import voxelize as tvox
from tests.test_torch_pointpillars import TINY_VOXEL, cloud


def test_cast_follows_xla_on_special_and_random_values():
    rng = np.random.default_rng(0)
    wide = (rng.standard_normal(4000) * 10.0 ** rng.uniform(0, 12, 4000)).astype(np.float32)
    x = np.concatenate([kernel_cases.SPECIAL_COORDS, wide])
    got = tvox.xla_f32_to_i32(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(x).astype(jnp.int32)))


def _special_cloud():
    return kernel_cases.special_cloud(64, TINY_VOXEL["point_cloud_range"], seed=3)


def _voxel_configs():
    kw = dict(point_cloud_range=TINY_VOXEL["point_cloud_range"],
              voxel_size=TINY_VOXEL["voxel_size"], max_voxels=128, max_points_per_voxel=4)
    return jvox.VoxelConfig(**kw), tvox.VoxelConfig(**kw)


@pytest.mark.parametrize("num_points", [64, 60])
def test_assign_cells_equals_jax_on_special_coordinates(num_points):
    jcfg, tcfg = _voxel_configs()
    pts = _special_cloud()
    ijk, valid = tvox.assign_cells(torch.from_numpy(pts), torch.tensor(num_points), tcfg)
    want_ijk, want_valid = jvox.assign_cells(jnp.asarray(pts), jnp.asarray(num_points), jcfg)
    np.testing.assert_array_equal(ijk.numpy(), np.asarray(want_ijk))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    assert ijk[0, 0] == 0 and bool(valid[0])  # a NaN x lands in cell x = 0 and stays in


def test_voxelize_equals_jax_on_special_coordinates():
    """Rows 3 (x, y and z) and 5 (x) NaN besides the special rows: before
    the repair the port dropped every NaN row that JAX keeps, so its valid
    voxels fell short of JAX's."""
    jcfg, tcfg = _voxel_configs()
    pts = _special_cloud()
    pts[3, :3] = np.nan
    pts[5, 0] = np.nan
    got = tvox.voxelize(torch.from_numpy(pts), torch.tensor(60), tcfg)
    want = jvox.voxelize(jnp.asarray(pts), jnp.asarray(60), jcfg)
    for key in ("voxels", "coords", "num_points_per_voxel", "voxel_valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def _nan_cloud(make, seed, n):
    pts = make(seed, n)
    pts[7, 0] = np.nan
    return pts


@pytest.mark.parametrize("fused", ["on", "off"])
def test_pointpillars_nan_point_gives_what_jax_gives(fused):
    """One NaN x in a 500-point cloud: JAX keeps no detection, and so does
    the port (it kept 13 before the repair), fused and unfused."""
    from tests.test_torch_detect3d import _build_pair

    jpipe, _, tpipe, _ = _build_pair(fused)
    pts = _nan_cloud(cloud, 0, 500)
    got, want = tpipe.infer(pts), jpipe.infer(pts)
    assert len(want["pred_scores"]) == 0
    assert len(got["pred_scores"]) == len(want["pred_scores"])
    assert got["pred_boxes"].shape == want["pred_boxes"].shape


def test_second_fused_route_nan_point_gives_what_jax_gives():
    """The fused SECOND voxel stage (the sorted segment mean) takes the NaN
    point into its cell as JAX's does; both keep no detection."""
    from tests.test_torch_detect3d_second import _build_pair
    from tests.test_torch_second import second_cloud

    jpipe, jspec, tpipe, tspec = _build_pair("on")
    assert tspec.extra["fused_stages"] == jspec.extra["fused_stages"]
    assert "voxelize_scatter" in tspec.extra["fused_stages"]
    pts = _nan_cloud(second_cloud, 300, 600)
    got, want = tpipe.infer(pts), jpipe.infer(pts)
    assert len(got["pred_scores"]) == len(want["pred_scores"])
    assert got["pred_boxes"].shape == want["pred_boxes"].shape
