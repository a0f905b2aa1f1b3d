"""The port's SECOND-IoU (dense middle) and its voxel stage against the JAX
package's, on the CPU, with the flax weights carried across by
``models/convert.second_state_dict_from_flax``. The grid is the tiny one
of tests/test_fused_parity.py (32 x 32 x 8 cells, ``max_voxels`` 1024, so
the capped fused route equals the unfused one).

Bars and why:
  * heads within 1e-5: the two frameworks sum 3D and 2D convolutions in
    other orders (the same bar as PointPillars');
  * top-k candidates: equal indices, labels, deltas, anchors and bins,
    scores within 1e-6 (the rectified score's ``pow`` is another
    polynomial in XLA than in PyTorch, a few ulps apart);
  * the plain sorted-segment mean within rtol 1e-5 of the Pallas kernel
    (interpret mode) and of ``_scatter_mean_volume``: the module's own
    contract (``ops/pallas_voxel.py``), since the Pallas kernel sums each
    slot through a one-hot matrix product in the contraction's order. The
    inputs keep features in [3, 5] (and points in one cell share a sign),
    so no sum cancels and the relative bar holds;
  * the port's two routes (fused and unfused) on the CPU: bitwise, since
    both sum each cell serially in point order from +0.0.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_client_tpu.models import second as jsec
from triton_client_tpu.ops import pallas_voxel as jpv
from triton_client_tpu.ops import voxelize as jvox

from triton_client_tpu_torch.models import second as tsec
from triton_client_tpu_torch.models.convert import _kernel_to_torch, second_state_dict_from_flax
from triton_client_tpu_torch.ops import gpu_voxel, kernel_cases
from triton_client_tpu_torch.ops import voxelize as tvox
from tests.test_fused_parity import TINY_SECOND
from tests.test_torch_pointpillars import cloud
from torch_threads import one_torch_thread  # noqa: F401

TINY_RANGE = TINY_SECOND.voxel.point_cloud_range


def port_config(jcfg: jsec.SECONDConfig = TINY_SECOND, **voxel) -> tsec.SECONDConfig:
    """The port's SECONDConfig with the fields of a JAX one."""
    v = jcfg.voxel
    return tsec.SECONDConfig(
        voxel=tvox.VoxelConfig(
            point_cloud_range=v.point_cloud_range, voxel_size=v.voxel_size,
            max_voxels=v.max_voxels, max_points_per_voxel=v.max_points_per_voxel, **voxel,
        ),
        middle_filters=jcfg.middle_filters,
        backbone_layers=jcfg.backbone_layers,
        backbone_strides=jcfg.backbone_strides,
        backbone_filters=jcfg.backbone_filters,
        upsample_strides=jcfg.upsample_strides,
        upsample_filters=jcfg.upsample_filters,
        iou_alpha=jcfg.iou_alpha,
    )


def second_cloud(seed, n):
    return cloud(seed, n, TINY_RANGE)


@pytest.fixture(scope="module")
def carried():
    jmodel, variables = jsec.init_second(jax.random.PRNGKey(0), TINY_SECOND)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    tmodel = tsec.SECONDIoU(port_config())
    tmodel.load_state_dict(second_state_dict_from_flax(variables, tmodel))
    return jmodel, variables, tmodel.eval()


def test_strict_conversion_rejects_missing_and_extra_leaves(carried):
    _, variables, tmodel = carried
    missing = copy.deepcopy(variables)
    del missing["batch_stats"]["middle"]["bn1"]["mean"]
    with pytest.raises(KeyError, match="unfilled"):
        second_state_dict_from_flax(missing, tmodel)
    extra = copy.deepcopy(variables)
    extra["params"]["middle"]["conv0"]["bias"] = np.zeros(8, np.float32)
    with pytest.raises(KeyError, match="no such tensor"):
        second_state_dict_from_flax(extra, tmodel)
    wrong = copy.deepcopy(variables)
    wrong["params"]["middle"]["conv1"]["kernel"] = np.zeros((3, 3, 3, 16, 8), np.float32)
    with pytest.raises(ValueError, match="shape"):
        second_state_dict_from_flax(wrong, tmodel)


def test_conversion_at_full_width_against_the_flax_shapes():
    """The full KITTI SECOND-IoU: every leaf of ``init_second``'s tree
    (zeros of the shapes ``jax.eval_shape`` gives, no forward) fills the
    port's model exactly once."""
    shapes = jax.eval_shape(lambda: jsec.init_second(jax.random.PRNGKey(0))[1])
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model = tsec.SECONDIoU(tsec.SECONDConfig())
    sd = second_state_dict_from_flax(zeros, model)
    assert set(sd) == set(model.state_dict())
    assert sd["middle.conv2.weight"].shape == (64, 32, 3, 3, 3)
    assert sd["backbone.block0_down.weight"].shape == (128, 192, 3, 3)  # 3 x 64 folded
    assert model.anchors.shape == (100 * 88 * 6, 7)
    assert model.cfg.head_hw == (100, 88) and model.cfg.bev_channels == 192


def test_conv3d_kernel_layout():
    import flax.linen as fnn

    conv = fnn.Conv(5, (3, 3, 3), strides=(2, 2, 2), padding=1, use_bias=False)
    x = np.random.default_rng(0).normal(size=(1, 6, 9, 7, 3)).astype(np.float32)
    params = conv.init(jax.random.PRNGKey(1), x)
    want = np.asarray(conv.apply(params, x))
    tconv = torch.nn.Conv3d(3, 5, 3, stride=2, padding=1, bias=False)
    kernel = np.asarray(params["params"]["kernel"])
    with torch.no_grad():
        tconv.weight.copy_(torch.tensor(_kernel_to_torch(tconv, kernel)))
        got = tconv(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == want.shape == (1, 3, 5, 4, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_sparse_middle_is_not_ported():
    """The sparse middle is ported now (tests/test_torch_second_sparse.py
    holds it to JAX): the config builds the sparse encoder, and a middle of
    neither kind still raises."""
    model = tsec.SECONDIoU(dataclasses.replace(port_config(), middle="sparse"))
    assert isinstance(model.middle, tsec.SparseMiddleEncoder)
    with pytest.raises(ValueError, match="'dense' or 'sparse'"):
        tsec.SECONDIoU(tsec.SECONDConfig(middle="hash"))


def test_middle_encoder_folds_z_as_jax(carried):
    """The z fold puts channel d*C + c: the port's NCHW canvas equals the
    JAX (h, w, d*C) one after a plain NHWC permute."""
    jmodel, variables, tmodel = carried
    nx, ny, nz = TINY_SECOND.voxel.grid_size
    vol = np.random.default_rng(3).normal(size=(1, nz, ny, nx, 4)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(vol), method=lambda m, v: m.middle(v)))
    with torch.no_grad():
        got = tmodel.middle(torch.from_numpy(vol)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 16, 16, 4 * 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _heads_jax(jmodel, variables, padded, m, route):
    if route == "grouped":
        vox = jvox.voxelize(jnp.asarray(padded), jnp.asarray(m), jmodel.cfg.voxel)
        return jmodel.apply(variables, vox["voxels"][None], vox["num_points_per_voxel"][None],
                            vox["coords"][None], train=False)
    return jmodel.apply(variables, jnp.asarray(padded), jnp.asarray(m), train=False,
                        method=jmodel.from_points)


def _heads_port(tmodel, padded, m, route):
    pts, cnt = torch.from_numpy(padded), torch.tensor(m)
    with torch.no_grad():
        if route == "grouped":
            vox = tvox.voxelize(pts, cnt, tmodel.cfg.voxel)
            return tmodel(vox["voxels"][None], vox["num_points_per_voxel"][None],
                          vox["coords"][None])
        if route == "volume":
            return tmodel.from_volume(gpu_voxel.fused_mean_volume(pts, cnt, tmodel.cfg.voxel))
        return tmodel.from_points(pts, cnt)


@pytest.mark.parametrize("route", ["scatter", "grouped", "volume"])
def test_heads_match_jax(carried, route):
    """Each way into the port's model against JAX's scatter (or grouped)
    route; 600 points occupy fewer cells than either budget."""
    jmodel, variables, tmodel = carried
    padded, m = jvox.pad_points(second_cloud(2, 600), 1024)
    want = _heads_jax(jmodel, variables, padded, m, route)
    got = _heads_port(tmodel, padded, m, route)
    assert got["cls"].shape == (1, 16, 16, 6, 3) and got["iou"].shape == (1, 16, 16, 6)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_topk_candidates_and_decode_match_jax(carried):
    jmodel, variables, tmodel = carried
    padded, m = jvox.pad_points(second_cloud(4, 600), 1024)
    heads = _heads_jax(jmodel, variables, padded, m, "scatter")
    theads = {k: torch.from_numpy(np.array(v)) for k, v in heads.items()}
    want = jmodel.apply(variables, heads, 64, 0.1, method=jmodel.topk_candidates)
    got = tmodel.topk_candidates(theads, 64, 0.1)
    assert set(got) == set(want)
    for k in ("deltas", "anchors", "dir_bin", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0,
                               atol=1e-6)
    assert np.isfinite(got["scores"].numpy()).sum() > 0
    want_dec = jmodel.apply(variables, heads, 64, 0.1, method=jmodel.decode_topk)
    got_dec = tmodel.decode_topk(theads, 64, 0.1)
    np.testing.assert_allclose(got_dec["boxes"].numpy(), np.asarray(want_dec["boxes"]),
                               rtol=1e-6, atol=1e-5)
    full_want = jmodel.apply(variables, heads, method=jmodel.decode)
    full_got = tmodel.decode(theads)
    np.testing.assert_allclose(full_got["boxes"].numpy(), np.asarray(full_want["boxes"]),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(full_got["scores"].numpy(), np.asarray(full_want["scores"]),
                               rtol=0, atol=1e-6)


# num_slots per kind: singletons needs a slot for each of the first rows
SEGMENT_SLOTS = {"singletons": 1500, "overflow": 300}


@pytest.mark.parametrize("kind", kernel_cases.SEGMENT_KINDS)
def test_segment_mean_plain_matches_tpu_kernel(kind):
    """2 x 1024 rows (two of the TPU kernel's blocks), compared over the
    live slots [0, num_slots)."""
    num_slots = SEGMENT_SLOTS.get(kind, 600)
    valsT, slots = kernel_cases.segment_inputs(kind, 2 * jpv.POINT_BLOCK, num_slots, seed=16)
    want = np.asarray(jpv.sorted_segment_mean_pallas(
        jnp.asarray(valsT), jnp.asarray(slots), num_slots=num_slots, interpret=True,
    ))[:, :num_slots]
    got = gpu_voxel.sorted_segment_mean_reference(
        torch.from_numpy(valsT), torch.from_numpy(slots), num_slots
    ).numpy()
    assert got.shape == (8, num_slots)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    live = np.unique(slots[slots < num_slots])
    assert (got[:, np.setdiff1d(np.arange(num_slots), live)] == 0).all()  # empty slots give 0
    if kind == "all_dump":
        assert len(live) == 0 and not got.any()
    else:
        assert (got[0, live] > 0).all()


def test_fused_mean_volume_matches_jax_and_the_unfused_scatter():
    """The port's fused route against the JAX one (Pallas in interpret
    mode) and against ``_scatter_mean_volume``, on a 600-point cloud whose
    occupied cells fit the cap; the port's own unfused route against
    JAX's."""
    jcfg = TINY_SECOND.voxel
    tcfg = port_config().voxel
    padded, m = jvox.pad_points(second_cloud(5, 600), 1024)
    pts, cnt = torch.from_numpy(padded), torch.tensor(m)
    fused = gpu_voxel.fused_mean_volume(pts, cnt, tcfg).numpy()
    unfused = tsec.scatter_mean_volume(pts, cnt, tcfg).numpy()
    want_fused = np.asarray(jpv.fused_mean_volume(jnp.asarray(padded), jnp.asarray(m), jcfg,
                                                  interpret=True))
    want_unfused = np.asarray(jsec._scatter_mean_volume(jnp.asarray(padded), jnp.asarray(m), jcfg))
    assert fused.shape == want_fused.shape == (8, 32, 32, 4)
    occupied = int((want_unfused != 0).any(-1).sum())
    assert 400 < occupied < jcfg.max_voxels
    for got, want in ((fused, want_fused), (fused, want_unfused), (unfused, want_unfused)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(fused, unfused)  # the port's two routes, bitwise


def test_fused_route_caps_cells_where_the_unfused_keeps_them():
    """Past ``max_voxels`` the fused route keeps the lowest z-major cell ids
    only, as the JAX one does; the unfused scatter keeps every cell."""
    tcfg = port_config().voxel
    capped = dataclasses.replace(tcfg, max_voxels=256)
    padded, m = jvox.pad_points(second_cloud(6, 900), 1024)
    pts, cnt = torch.from_numpy(padded), torch.tensor(m)
    fused = gpu_voxel.fused_mean_volume(pts, cnt, capped)
    unfused = tsec.scatter_mean_volume(pts, cnt, capped)
    kept = (fused != 0).any(-1).flatten()
    occupied = (unfused != 0).any(-1).flatten()
    assert int(occupied.sum()) > 256 and int(kept.sum()) == 256
    first = torch.nonzero(occupied).flatten()[:256]
    assert torch.equal(torch.nonzero(kept).flatten(), first)  # the lowest cell ids
    assert torch.equal(fused.flatten(0, 2)[first], unfused.flatten(0, 2)[first])
    want = jpv.fused_mean_volume(
        jnp.asarray(padded), jnp.asarray(m),
        jvox.VoxelConfig(**{**dataclasses.asdict(TINY_SECOND.voxel), "max_voxels": 256}),
        interpret=True,
    )
    np.testing.assert_allclose(fused.numpy(), np.asarray(want), rtol=1e-5, atol=0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    gpu_voxel.launches.reset()
    valsT, slots = (torch.from_numpy(a) for a in kernel_cases.segment_inputs("random", 512, 200))
    assert torch.equal(gpu_voxel.sorted_segment_mean(valsT, slots, 200),
                       gpu_voxel.sorted_segment_mean_reference(valsT, slots, 200))
    padded, m = jvox.pad_points(second_cloud(7, 300), 512)
    gpu_voxel.fused_mean_volume(torch.from_numpy(padded), torch.tensor(m), port_config().voxel)
    assert gpu_voxel.launches.count == 0


def test_segment_mean_wrapper_checks_its_inputs():
    valsT, slots = torch.zeros(8, 16), torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        gpu_voxel.sorted_segment_mean(valsT, slots.long(), 4)
    with pytest.raises(ValueError, match=r"\(8, N\)"):
        gpu_voxel.sorted_segment_mean(valsT[:7], slots, 4)
    with pytest.raises(ValueError, match="sorted_segment_mean"):  # not the CPU, not CUDA
        gpu_voxel.sorted_segment_mean(valsT.to("meta"), slots.to("meta"), 4)
    with pytest.raises(ValueError, match="sorted_segment_mean"):  # mixed devices
        gpu_voxel.sorted_segment_mean(valsT, slots.to("meta"), 4)
