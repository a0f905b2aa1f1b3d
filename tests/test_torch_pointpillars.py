"""The port's PointPillars, voxelizer and rotated-box geometry against the
JAX package's, on the CPU, with the flax weights carried across by
``models/convert.pointpillars_state_dict_from_flax``.

Bars: the voxelizer's outputs are equal (integer slots and copied
points); anchors and top-k candidates are equal; heads agree to 1e-5
(the two frameworks sum convolutions in other orders; measured 1.1e-6).
``rotated_iou_bev`` is float32 geometry at world coordinates (tens of
metres against boxes under a metre), where both implementations lose
digits to cancellation: the port is held to 2e-3 of the JAX function and
to 1e-3 of a float64 evaluation of the same algorithm.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_client_tpu.models import pointpillars as jpp
from triton_client_tpu.ops import boxes3d as jb3
from triton_client_tpu.ops import voxelize as jvox

from triton_client_tpu_torch.models import pointpillars as tpp
from triton_client_tpu_torch.models.convert import (
    _kernel_to_torch,
    pointpillars_state_dict_from_flax,
)
from triton_client_tpu_torch.ops import boxes3d as tb3
from triton_client_tpu_torch.ops import kernel_cases
from triton_client_tpu_torch.ops import voxelize as tvox

TINY_VOXEL = dict(
    point_cloud_range=(0.0, -6.4, -3.0, 12.8, 6.4, 1.0),
    voxel_size=(0.2, 0.2, 4.0),
    max_voxels=512,
    max_points_per_voxel=8,
)


def tiny_configs(**voxel):
    """The tiny grid of tests/test_pointpillars.py (64 x 64 pillars, one
    layer a block), as the JAX config and the port's."""
    v = {**TINY_VOXEL, **voxel}
    return (
        jpp.PointPillarsConfig(voxel=jvox.VoxelConfig(**v), backbone_layers=(1, 1, 1)),
        tpp.PointPillarsConfig(voxel=tvox.VoxelConfig(**v), backbone_layers=(1, 1, 1)),
    )


def cloud(seed, n, r=TINY_VOXEL["point_cloud_range"]):
    rng = np.random.default_rng(seed)
    return np.column_stack(
        [rng.uniform(r[0], r[3], n), rng.uniform(r[1], r[4], n), rng.uniform(r[2], r[5], n),
         rng.uniform(0, 1, n)]
    ).astype(np.float32)


@pytest.fixture(scope="module")
def carried():
    jcfg, tcfg = tiny_configs()
    jmodel, variables = jpp.init_pointpillars(jax.random.PRNGKey(0), jcfg)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    tmodel = tpp.PointPillars(tcfg)
    tmodel.load_state_dict(pointpillars_state_dict_from_flax(variables, tmodel))
    return jmodel, variables, tmodel.eval()


def test_strict_conversion_rejects_missing_and_extra_leaves(carried):
    _, variables, tmodel = carried
    missing = copy.deepcopy(variables)
    del missing["batch_stats"]["backbone"]["up1_bn"]["var"]
    with pytest.raises(KeyError, match="unfilled"):
        pointpillars_state_dict_from_flax(missing, tmodel)
    extra = copy.deepcopy(variables)
    extra["params"]["vfe"]["linear"]["bias"] = np.zeros(64, np.float32)
    with pytest.raises(KeyError, match="no such tensor"):
        pointpillars_state_dict_from_flax(extra, tmodel)
    stray = copy.deepcopy(variables)
    stray["params"]["cls_head"]["offset"] = np.zeros(18, np.float32)
    with pytest.raises(KeyError, match="unexpected flax leaf"):
        pointpillars_state_dict_from_flax(stray, tmodel)
    wrong = copy.deepcopy(variables)
    wrong["params"]["backbone"]["up2"]["kernel"] = np.zeros((2, 2, 256, 128), np.float32)
    with pytest.raises(ValueError, match="shape"):
        pointpillars_state_dict_from_flax(wrong, tmodel)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_conv_transpose_kernel_is_flipped(stride):
    """flax's ConvTranspose does not flip its kernel and PyTorch's does:
    carried with the flip, the up-samplers agree exactly; without it, the
    stride-2 and stride-4 ones do not."""
    import flax.linen as fnn

    conv = fnn.ConvTranspose(6, (stride, stride), strides=(stride, stride), use_bias=False)
    x = np.random.default_rng(stride).normal(size=(1, 5, 7, 3)).astype(np.float32)
    params = conv.init(jax.random.PRNGKey(stride), x)
    want = np.asarray(conv.apply(params, x))
    kernel = np.asarray(params["params"]["kernel"])
    tconv = torch.nn.ConvTranspose2d(3, 6, stride, stride=stride, bias=False)

    def run(weight):
        with torch.no_grad():
            tconv.weight.copy_(torch.tensor(weight))
            return tconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()

    np.testing.assert_allclose(run(_kernel_to_torch(tconv, kernel)), want, rtol=0, atol=1e-6)
    unflipped = np.ascontiguousarray(kernel.transpose(2, 3, 0, 1))
    assert np.allclose(run(unflipped), want, atol=1e-6) == (stride == 1)


@pytest.mark.parametrize("voxel", [{}, {"voxel_size": (0.16, 0.16, 4.0)}])
def test_anchors_equal_jax(voxel):
    jcfg, tcfg = tiny_configs(**voxel)
    want = np.asarray(jpp.generate_anchors(jcfg))
    np.testing.assert_array_equal(tpp.generate_anchors(tcfg).numpy(), want)


def test_anchors_equal_jax_at_kitti_width():
    want = np.asarray(jpp.generate_anchors(jpp.PointPillarsConfig()))
    got = tpp.generate_anchors(tpp.PointPillarsConfig()).numpy()
    assert got.shape == (248, 216, 6, 7)
    np.testing.assert_array_equal(got, want)


# (points, max_voxels, max_points_per_voxel, where): under both budgets
# over the whole grid, and over both in a 2 m x 2 m patch (100 pillars of
# ~30 points each)
VOXEL_CASES = [
    (400, 512, 8, TINY_VOXEL["point_cloud_range"]),
    (3000, 64, 4, (0.0, -1.0, -3.0, 2.0, 1.0, 1.0)),
]


@pytest.mark.parametrize("n,max_voxels,max_points,where", VOXEL_CASES)
def test_voxelize_equals_jax(n, max_voxels, max_points, where):
    jcfg, tcfg = tiny_configs(max_voxels=max_voxels, max_points_per_voxel=max_points)
    padded, m = jvox.pad_points(cloud(1, n, where), n + 100)
    want = jvox.voxelize(jnp.asarray(padded), jnp.asarray(m), jcfg.voxel)
    got = tvox.voxelize(torch.from_numpy(padded), torch.tensor(m), tcfg.voxel)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == getattr(torch, str(np.asarray(want[k]).dtype)), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    counts = np.asarray(want["num_points_per_voxel"])
    over = bool(np.asarray(want["voxel_valid"]).all()) and int(counts.min()) == max_points
    assert over == (n > 1000)  # the second case really overflows both budgets


def _heads_jax(jmodel, variables, padded, m, grouped):
    if grouped:
        vox = jvox.voxelize(jnp.asarray(padded), jnp.asarray(m), jmodel.cfg.voxel)
        return jmodel.apply(
            variables, vox["voxels"][None], vox["num_points_per_voxel"][None],
            vox["coords"][None], train=False,
        )
    return jmodel.apply(
        variables, jnp.asarray(padded), jnp.asarray(m), train=False, method=jmodel.from_points
    )


def _heads_port(tmodel, padded, m, grouped):
    with torch.no_grad():
        if grouped:
            vox = tvox.voxelize(torch.from_numpy(padded), torch.tensor(m), tmodel.cfg.voxel)
            return tmodel(
                vox["voxels"][None], vox["num_points_per_voxel"][None], vox["coords"][None]
            )
        return tmodel.from_points(torch.from_numpy(padded), torch.tensor(m))


@pytest.mark.parametrize("grouped", [False, True])
def test_heads_match_jax(carried, grouped):
    jmodel, variables, tmodel = carried
    padded, m = jvox.pad_points(cloud(2, 400), 512)
    want = _heads_jax(jmodel, variables, padded, m, grouped)
    got = _heads_port(tmodel, padded, m, grouped)
    a = jmodel.cfg.anchors_per_loc
    assert got["cls"].shape == (1, 32, 32, a, 3)
    assert got["box"].shape == (1, 32, 32, a, 7)
    assert got["dir"].shape == (1, 32, 32, a, 2)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_scatter_and_grouped_routes_agree_below_the_budget(carried):
    _, _, tmodel = carried
    padded, m = jvox.pad_points(cloud(3, 400), 512)
    scatter = _heads_port(tmodel, padded, m, grouped=False)
    grouped = _heads_port(tmodel, padded, m, grouped=True)
    for k in scatter:
        np.testing.assert_allclose(scatter[k].numpy(), grouped[k].numpy(), rtol=0, atol=1e-5)


def test_topk_candidates_equal_and_decode_within_ulps(carried):
    """Same heads in: identical candidate sets (stable top-k, first-max
    argmaxes); the unfused decode differs from XLA's only where XLA
    contracts a product and a sum into an FMA."""
    jmodel, variables, tmodel = carried
    padded, m = jvox.pad_points(cloud(4, 400), 512)
    heads = _heads_jax(jmodel, variables, padded, m, grouped=False)
    want = jmodel.apply(variables, heads, 64, 0.1, method=jmodel.topk_candidates)
    theads = {k: torch.from_numpy(np.array(v)) for k, v in heads.items()}
    got = tmodel.topk_candidates(theads, 64, 0.1)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert np.isfinite(got["scores"].numpy()).any()
    want_dec = jmodel.apply(variables, heads, 64, 0.1, method=jmodel.decode_topk)
    got_dec = tmodel.decode_topk(theads, 64, 0.1)
    np.testing.assert_allclose(got_dec["boxes"].numpy(), np.asarray(want_dec["boxes"]), rtol=1e-6,
                               atol=1e-5)
    # the full-grid decode agrees as well
    full_want = jmodel.apply(variables, heads, method=jmodel.decode)
    full_got = tmodel.decode(theads)
    np.testing.assert_allclose(full_got["boxes"].numpy(), np.asarray(full_want["boxes"]),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(full_got["scores"].numpy(), np.asarray(full_want["scores"]),
                               rtol=0, atol=1e-6)


def _bev_pairs(seed, k=96):
    boxes, _, _ = kernel_cases.suppress3d_inputs("random", k, seed)
    return np.array(jb3.boxes7_to_bev(jnp.asarray(boxes)))


@pytest.mark.parametrize("seed", [0, 1])
def test_rotated_iou_bev_against_jax_and_float64(seed):
    bev = _bev_pairs(seed)
    want = np.asarray(jb3.rotated_iou_bev(jnp.asarray(bev), jnp.asarray(bev)))
    got = tb3.rotated_iou_bev(torch.from_numpy(bev), torch.from_numpy(bev)).numpy()
    exact = tb3.rotated_iou_bev(torch.from_numpy(bev).double(), torch.from_numpy(bev).double())
    assert got.shape == want.shape == (96, 96)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    np.testing.assert_allclose(got, exact.numpy(), rtol=0, atol=1e-3)
    assert 0.02 < (got > 0.01).mean() < 0.5  # the clusters overlap, not all pairs
    # batched leading dimensions equal the unbatched call
    batched = tb3.rotated_iou_bev(torch.from_numpy(np.stack([bev, bev[::-1].copy()])),
                                  torch.from_numpy(np.stack([bev, bev[::-1].copy()])))
    np.testing.assert_array_equal(batched[0].numpy(), got)


def test_nms_bev_equals_jax_where_no_iou_is_near_the_threshold():
    """nms_bev keeps the same indices as the JAX function wherever no IoU
    between live candidates lies within the float32 noise (2e-3) of the
    threshold: checked first, on the float64 evaluation, for this seed."""
    boxes, scores, _ = kernel_cases.suppress3d_inputs("random", 48, 7)
    bev = torch.from_numpy(boxes[:, [0, 1, 3, 4, 6]]).double()
    live = np.isfinite(scores)
    exact = tb3.rotated_iou_bev(bev, bev).numpy()[live][:, live]
    thresh = 0.01
    assert not (np.abs(exact - thresh) < 2e-3).any()
    want_idx, want_valid = jb3.nms_bev(jnp.asarray(boxes), jnp.asarray(scores), thresh, max_det=32)
    idx, valid = tb3.nms_bev(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
                             thresh, max_det=32)
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(want_idx))
    assert 5 < int(valid.sum()) < live.sum()  # suppression did real work
