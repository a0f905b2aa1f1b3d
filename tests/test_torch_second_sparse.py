"""SECOND-IoU's sparse middle in the port against the JAX package's, on the
CPU: the encoder, the model through both ways in, the pipeline on the
golden config and cloud of tests/test_golden_outputs.py, the bf16 and int8w
policies, the OpenPCDet importer, the configuration file of the reference's
0.05 m grid, a disk entry and the ``detect3d`` CLI. Weights are the JAX
package's, carried across by ``models/convert.second_state_dict_from_flax``
(flax trees filled from a seeded generator over ``jax.eval_shape``).

Bars and why:
  * the middle's BEV canvas and the heads within 1e-5 absolute: the two
    frameworks sum each (V, Cin) x (Cin, Cout) product and the dense
    convolutions in other orders (the dense SECOND's bar);
  * the pipeline's rows: equal counts, labels and order, boxes and scores
    within 1e-5;
  * ``int8w``: ``q`` and ``scale`` equal JAX's per leaf, the sparse
    (k^3, cin, cout) leaves quantized over their last axis; the heads within
    the float32 bar of JAX's int8w heads; ``param_bytes`` equal;
  * ``bf16``: max |port bf16 heads - JAX f32 heads| <= 2 x max |JAX bf16
    heads - JAX f32 heads| (tests/test_torch_precision_3d.py's bar);
  * integers (cells, slots, imported weights) exactly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_client_tpu import dataset_config as jds
from triton_client_tpu.models import second as jsec
from triton_client_tpu.ops import voxelize as jvox
from triton_client_tpu.pipelines import detect3d as jdet
from triton_client_tpu.runtime import importers as jimp
from triton_client_tpu.runtime import precision as jprec

from triton_client_tpu_torch import dataset_config as tds
from triton_client_tpu_torch.cli import detect3d, serve
from triton_client_tpu_torch.models import second as tsec
from triton_client_tpu_torch.models.convert import second_state_dict_from_flax
from triton_client_tpu_torch.ops import voxelize as tvox
from triton_client_tpu_torch.pipelines import detect3d as tdet
from triton_client_tpu_torch.runtime import importers as timp
from triton_client_tpu_torch.runtime import precision as tprec
from tests.test_import_fidelity import _randomize, _state
from tests.test_import_fidelity_families import TSECONDDense, _second_cfg
from tests.test_torch_disk_repository import _fields
from tests.test_torch_precision_3d import flax_init_variables
from tests.test_torch_server import seeded_variables
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
ATOL = 1e-5

# tests/test_golden_outputs.py::test_sparse_second_pipeline_golden: the 2^3
# strided kernel and a dense tail from stage 2
GOLDEN = jsec.SECONDConfig(
    voxel=jvox.VoxelConfig(point_cloud_range=(0.0, -12.8, -2.0, 25.6, 12.8, 2.0),
                           voxel_size=(0.4, 0.4, 0.5), max_voxels=2048, max_points_per_voxel=8),
    middle="sparse", sparse_budget=2048, sparse_dense_tail_from=2, middle_filters=(8, 8, 8),
    backbone_layers=(1,), backbone_strides=(1,), backbone_filters=(16,), upsample_strides=(1,),
    upsample_filters=(16,),
)
GOLDEN_PIPE = dict(model_name="second_iou", point_buckets=(8192,), max_det=16, pre_max=64)


def port_config(jcfg: jsec.SECONDConfig) -> tsec.SECONDConfig:
    """The port's SECONDConfig with every field of a JAX one."""
    v = jcfg.voxel
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
              if f.name not in ("voxel", "anchor_classes")}
    return tsec.SECONDConfig(
        voxel=tvox.VoxelConfig(point_cloud_range=v.point_cloud_range, voxel_size=v.voxel_size,
                               max_voxels=v.max_voxels,
                               max_points_per_voxel=v.max_points_per_voxel),
        **fields)


def golden_cloud(n=3000):
    """The golden test's cloud: its ``rng`` fixture is default_rng(0)."""
    rng = np.random.default_rng(0)
    return np.stack([rng.uniform(0, 25.6, n), rng.uniform(-12.8, 12.8, n),
                     rng.uniform(-1.8, 1.8, n), rng.uniform(0, 1, n)], axis=1).astype(np.float32)


def cloud(seed, n, jcfg=GOLDEN):
    r = jcfg.voxel.point_cloud_range
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.uniform(r[0], r[3], n), rng.uniform(r[1], r[4], n),
                            rng.uniform(r[2], r[5], n), rng.uniform(0, 1, n)]
                           ).astype(np.float32)


def padded(pc, bucket=8192):
    out = np.zeros((bucket, 4), np.float32)
    out[: len(pc)] = pc
    return out, len(pc)


_VARIABLES: dict = {}


def variables_of(jcfg, stats="seeded"):
    """A flax tree of ``init_second(jcfg)``: ``seeded`` BatchNorm statistics
    (tests/test_torch_server.seeded_variables) or flax's ``init`` ones
    (identity BatchNorm, for the precision bars), once a module."""
    key = (jcfg, stats)
    if key not in _VARIABLES:
        init = lambda k: jsec.init_second(k, jcfg)[1]  # noqa: E731
        _VARIABLES[key] = (seeded_variables(init, seed=7) if stats == "seeded"
                           else flax_init_variables(init, seed=13))
    return _VARIABLES[key]


def port_model(jcfg, variables, dtype=torch.float32):
    model = tsec.SECONDIoU(port_config(jcfg), dtype=dtype)
    model.load_state_dict(second_state_dict_from_flax(variables, model))
    return model.eval()


def np_heads(heads) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in heads.items()}


def assert_heads_close(got, want, atol=ATOL):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)


# -- configuration ------------------------------------------------------------------------


def test_config_accepts_the_sparse_middle_and_refuses_others():
    tsec.SECONDConfig(middle="sparse").validate()
    with pytest.raises(ValueError, match="'dense' or 'sparse'"):
        tsec.SECONDConfig(middle="hash").validate()
    assert {f.name for f in dataclasses.fields(tsec.SECONDConfig)} == \
        {f.name for f in dataclasses.fields(jsec.SECONDConfig)}
    for name in ("sparse_budget", "sparse_dense_tail_from", "sparse_stride_kernel"):
        assert getattr(tsec.SECONDConfig(), name) == getattr(jsec.SECONDConfig(), name)


def test_sparse005_yaml_equals_jax_and_sizes_the_reference_grid():
    path = str(ROOT / "data" / "kitti_second_sparse005.yaml")
    jmodel, jmcfg, jpcfg = jds.detect3d_from_yaml(path)
    tmodel, tmcfg, tpcfg = tds.detect3d_from_yaml(path)
    assert tmodel == jmodel == "second_iou"
    for got, want in ((tmcfg, jmcfg), (tpcfg, jpcfg)):
        got, want = _fields(got), _fields(want)
        for k, v in got.items():
            assert want[k] == v, k
    assert tmcfg.middle == "sparse" and tmcfg.sparse_budget == 65536
    assert tmcfg.voxel.grid_size == (1408, 1600, 40)
    assert tmcfg.head_hw == (200, 176) and tmcfg.bev_channels == 320
    assert tmcfg.head_hw[0] * tmcfg.head_hw[1] * tmcfg.anchors_per_loc == 211200
    assert tpcfg.pre_max == 256 and tpcfg.point_buckets[-1] == 131072


def test_conversion_at_the_reference_grid_against_the_flax_shapes():
    """Every leaf of ``init_second`` at the 0.05 m grid (zeros of the shapes
    ``jax.eval_shape`` gives, no forward) fills the port's model once: the
    bare (k^3, cin, cout) sparse leaves and the dense tail's 3D kernel."""
    _, jcfg, _ = jds.detect3d_from_yaml(str(ROOT / "data" / "kitti_second_sparse005.yaml"))
    shapes = jax.eval_shape(lambda: jsec.init_second(jax.random.PRNGKey(0), jcfg)[1])
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    assert zeros["params"]["middle"]["conv1"].shape == (8, 16, 32)
    model = tsec.SECONDIoU(port_config(jcfg))
    sd = second_state_dict_from_flax(zeros, model)
    assert set(sd) == set(model.state_dict())
    assert sd["middle.conv0.weight"].shape == (27, 4, 16)
    assert sd["middle.conv2.weight"].shape == (8, 32, 64)
    assert sd["middle.conv3.weight"].shape == (64, 64, 3, 3, 3)
    assert sd["backbone.block0_down.weight"].shape == (128, 320, 3, 3)
    assert model.anchors.shape == (211200, 7)


def test_conversion_is_strict_on_the_sparse_leaves():
    variables = variables_of(GOLDEN)
    model = tsec.SECONDIoU(port_config(GOLDEN))
    wrong = jax.tree_util.tree_map(lambda x: x, variables)
    wrong["params"]["middle"]["conv1"] = np.zeros((27, 8, 8), np.float32)  # a 3^3 leaf
    with pytest.raises(ValueError, match="shape"):
        second_state_dict_from_flax(wrong, model)
    missing = jax.tree_util.tree_map(lambda x: x, variables)
    del missing["params"]["middle"]["conv0"]
    with pytest.raises(KeyError, match="unfilled"):
        second_state_dict_from_flax(missing, model)


# -- the encoder and the model ---------------------------------------------------------------


ENCODERS = [(0, 2), (0, 3), (2, 2), (2, 3)]  # (dense_tail_from, stride_kernel)


@pytest.mark.parametrize("tail,k", ENCODERS, ids=[f"tail{t}_k{k}" for t, k in ENCODERS])
def test_sparse_encoder_equals_jax(tail, k):
    """Three stages at an odd-extent grid with a budget that binds at the
    strided levels (8192 is the floor, so the budget here is the floor's
    territory: 900 occupied cells into 512 rows at level 0), with and
    without the dense tail, with the 2^3 and 3^3 strided kernels, seeded
    BatchNorm statistics: the BEV canvas within 1e-5."""
    grid, budget, filters = (5, 12, 16), 512, (8, 16, 16)
    enc = jsec.SparseMiddleEncoder(filters, grid=grid, budget=budget, dense_tail_from=tail,
                                   stride_kernel=k)
    rng = np.random.default_rng(30 + 10 * tail + k)
    cells = rng.choice(int(np.prod(grid)), size=900, replace=False)
    nz, ny, nx = grid
    ijk = np.full((1024, 3), -1, np.int32)
    ijk[:900] = np.stack([cells // (ny * nx), (cells // nx) % ny, cells % nx], 1)
    feats = rng.normal(size=(1024, 4)).astype(np.float32)
    valid = ijk[:, 0] >= 0
    args = (jnp.asarray(ijk), jnp.asarray(feats), jnp.asarray(valid))
    variables = seeded_variables(lambda key: enc.init(key, *args), seed=k + tail)
    want = np.asarray(jax.jit(enc.apply)(variables, *args))

    holder = torch.nn.Module()
    holder.middle = tsec.SparseMiddleEncoder(4, filters, grid, budget, tail, k)
    holder.load_state_dict(second_state_dict_from_flax(
        {c: {"middle": t} for c, t in variables.items()}, holder))
    with torch.no_grad():
        got = holder.middle.eval()(*(torch.from_numpy(a) for a in (ijk, feats, valid)))
    assert got.shape[0] == 1
    got = got[0].permute(1, 2, 0).numpy()  # (H, W, D*C), JAX's layout
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def golden_models():
    variables = variables_of(GOLDEN)
    return jsec.SECONDIoU(GOLDEN), variables, port_model(GOLDEN, variables)


def test_from_points_heads_equal_jax(golden_models):
    jmodel, variables, tmodel = golden_models
    from_points = jax.jit(lambda v, p, c: jmodel.apply(v, p, c, method=jmodel.from_points))
    for seed in (0, 1):
        pc, n = padded(cloud(seed, 2500))
        want = from_points(variables, jnp.asarray(pc), jnp.asarray(n))
        with torch.no_grad():
            got = tmodel.from_points(torch.from_numpy(pc), torch.tensor(n))
        assert_heads_close(np_heads(got), np_heads(want))


def test_grouped_forward_heads_equal_jax(golden_models):
    """The (V, K, F) voxel contract, each side's own voxelizer on the same
    cloud: the sparse encoder reads the voxels valid where z >= 0."""
    jmodel, variables, tmodel = golden_models
    pc, n = padded(cloud(5, 2000))
    jv = jvox.voxelize(jnp.asarray(pc), jnp.asarray(n), GOLDEN.voxel)
    want = jax.jit(jmodel.apply)(variables, jv["voxels"][None], jv["num_points_per_voxel"][None],
                                 jv["coords"][None])
    tv = tvox.voxelize(torch.from_numpy(pc), torch.tensor(n), tmodel.cfg.voxel)
    np.testing.assert_array_equal(tv["coords"].numpy(), np.asarray(jv["coords"]))
    with torch.no_grad():
        got = tmodel(tv["voxels"][None], tv["num_points_per_voxel"][None], tv["coords"][None])
    assert_heads_close(np_heads(got), np_heads(want))


def test_from_volume_refuses_the_sparse_middle(golden_models):
    jmodel, variables, tmodel = golden_models
    vol = np.zeros((8, 64, 64, 4), np.float32)
    with pytest.raises(ValueError, match="dense middle"):
        tmodel.from_volume(torch.from_numpy(vol))
    with pytest.raises(ValueError, match="dense middle"):
        jmodel.apply(variables, jnp.asarray(vol), method=jmodel.from_volume)


# -- the pipeline ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden_pipes():
    """The live JAX pipeline of the golden test (its own seeded weights,
    PRNGKey(0): ``init_second`` jitted, the same values as its eager call in
    a quarter of the time) and the port's on the same weights, fused on and
    off."""
    variables = jax.jit(lambda k: jsec.init_second(k, GOLDEN)[1])(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    jpipe, jspec, _ = jdet.build_second_pipeline(
        model_cfg=GOLDEN, config=jdet.Detect3DConfig(**GOLDEN_PIPE), variables=variables)
    tpipes = {f: tdet.build_second_pipeline(
        model_cfg=port_config(GOLDEN), config=tdet.Detect3DConfig(fused=f, **GOLDEN_PIPE),
        variables=variables, device="cpu")[:2] for f in ("on", "off")}
    return jpipe, jspec, tpipes


@pytest.mark.parametrize("fused", ["on", "off"])
def test_pipeline_rows_equal_the_live_jax_pipeline(golden_pipes, fused):
    """The golden cloud (whose JAX rows tests/test_golden_outputs.py pins)
    and two more: the same rows."""
    jpipe, _, tpipes = golden_pipes
    tpipe = tpipes[fused][0]
    for pts in (golden_cloud(), cloud(7, 4000), cloud(8, 900)):
        want, got = jpipe.infer(pts), tpipe.infer(pts)
        assert 0 < len(got["pred_scores"]) == len(want["pred_scores"]) <= GOLDEN_PIPE["max_det"]
        np.testing.assert_array_equal(got["pred_labels"], want["pred_labels"])
        np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], rtol=0, atol=ATOL)
        np.testing.assert_allclose(got["pred_scores"], want["pred_scores"], rtol=0, atol=ATOL)
    golden = json.loads((ROOT / "tests" / "golden" / "second_sparse_tiny.json").read_text())
    got = tpipe.infer(golden_cloud())
    assert len(got["pred_scores"]) == golden["n_det"][0]
    np.testing.assert_allclose(got["pred_scores"][:4], golden["scores"], rtol=0, atol=1e-4)


def test_a_sparse_second_never_takes_voxelize_scatter(golden_pipes):
    """The fused route of a sparse SECOND is the tail alone, as JAX routes
    it, and runs kernel 3 (gathered form) and kernel 4 once a request and
    the mean-volume stage never; a dense SECOND still fuses both stages."""
    from triton_client_tpu_torch.ops import detect3d_postprocess as post

    _, jspec, tpipes = golden_pipes
    tpipe, tspec = tpipes["on"]
    assert tpipe.fused_stages == ("decode_nms",) and tspec.extra["fused_stages"] == ["decode_nms"]
    jon = jdet.Detect3DPipeline(jdet.Detect3DConfig(fused="on", **GOLDEN_PIPE),
                                jsec.SECONDIoU(GOLDEN), {})
    assert jon.fused_stages == tpipe.fused_stages
    assert tpipes["off"][0].fused_stages == () and jspec.extra["fused_stages"] == []
    dense = tdet.build_second_pipeline(
        model_cfg=dataclasses.replace(port_config(GOLDEN), middle="dense"),
        config=tdet.Detect3DConfig(fused="on", **GOLDEN_PIPE), device="cpu")[0]
    assert dense.fused_stages == ("voxelize_scatter", "decode_nms")

    calls = {"decode": 0, "suppress": 0, "mean_volume": 0}
    originals = (tdet.gather_residual_decode, post.fused_suppress_pack_3d, tdet.fused_mean_volume)

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    tdet.gather_residual_decode = counted("decode", originals[0])
    post.fused_suppress_pack_3d = counted("suppress", originals[1])
    tdet.fused_mean_volume = counted("mean_volume", originals[2])
    try:
        for seed in (1, 2, 3):
            tpipe.infer(cloud(seed, 1500))
    finally:
        tdet.gather_residual_decode, post.fused_suppress_pack_3d, tdet.fused_mean_volume = \
            originals
    assert calls == {"decode": 3, "suppress": 3, "mean_volume": 0}


# -- precision ---------------------------------------------------------------------------------


_PAIRS: dict = {}


def policy_pair(policy):
    """(JAX pipeline, JAX spec, port pipeline, port spec) of the golden
    config on flax's init statistics under ``policy``, once a module."""
    if policy not in _PAIRS:
        variables = variables_of(GOLDEN, "init")
        jpipe, jspec, _ = jdet.build_second_pipeline(
            jax.random.PRNGKey(0), model_cfg=GOLDEN, config=jdet.Detect3DConfig(**GOLDEN_PIPE),
            variables=variables, precision=policy)
        tpipe, tspec, _ = tdet.build_second_pipeline(
            model_cfg=port_config(GOLDEN), config=tdet.Detect3DConfig(**GOLDEN_PIPE),
            variables=variables, device="cpu", precision=policy)
        _PAIRS[policy] = (jpipe, jspec, tpipe, tspec)
    return _PAIRS[policy]


def jax_heads(jpipe, pc, n):
    m = jpipe.model
    heads = jax.jit(lambda v, p, c: jpipe.precision.boundary(
        m.apply(jprec.realize(v), p, c, method=m.from_points)))(
            jpipe.variables, jnp.asarray(pc), jnp.asarray(n))
    return np_heads(heads)


def port_heads(tpipe, pc, n):
    with torch.no_grad():
        return np_heads({k: v.numpy() for k, v in
                         tpipe.heads(torch.from_numpy(pc), torch.tensor(n)).items()})


def test_int8w_stores_the_jax_bytes_and_matches_its_heads():
    """Fault 3 of the int8 walk: the sparse (k^3, cin, cout) weights
    quantize over their last axis, as every flax leaf of rank >= 2 does."""
    from torch.nn.utils import parametrize

    jpipe, jspec, tpipe, tspec = policy_pair("int8w")
    for key in ("precision", "precision_keep_f32", "param_bytes"):
        assert tspec.extra[key] == jspec.extra[key], key
    middle = jpipe.variables["params"]["middle"]
    model = tpipe.model
    for si in range(3):
        leaf = middle[f"conv{si}"]
        leaf = leaf["kernel"] if isinstance(leaf, dict) else leaf
        assert isinstance(leaf, jprec.QuantizedParam)
        mod = model.middle.get_submodule(f"conv{si}")
        assert parametrize.is_parametrized(mod, "weight")
        p = mod.parametrizations.weight
        q, scale = np.asarray(leaf.q), np.asarray(leaf.scale)
        if si < 2:  # the sparse stages: the JAX layout, scale over Cout
            assert scale.shape == (1, 1, q.shape[-1])
            np.testing.assert_array_equal(p.original0.numpy(), q)
            np.testing.assert_array_equal(p.original1.numpy(), scale)
        else:  # the dense tail: DHWIO -> OIDHW
            np.testing.assert_array_equal(p.original0.numpy(), q.transpose(4, 3, 0, 1, 2))
            np.testing.assert_array_equal(p.original1.numpy().ravel(), scale.ravel())
    for seed in (0, 1):
        pc, n = padded(cloud(40 + seed, 2500))
        assert_heads_close(port_heads(tpipe, pc, n), jax_heads(jpipe, pc, n))


def test_bf16_heads_within_twice_the_references_own_bf16_distance():
    jpipe, jspec, tpipe, tspec = policy_pair("bf16")
    jf32 = policy_pair(None)[0]
    assert tspec.extra["param_bytes"] == jspec.extra["param_bytes"]
    assert tpipe.model.middle.conv0.weight.dtype == torch.bfloat16
    assert tpipe.model.middle.conv2.weight.dtype == torch.bfloat16
    pc, n = padded(cloud(44, 2500))
    ref, ref_bf16, got = jax_heads(jf32, pc, n), jax_heads(jpipe, pc, n), port_heads(tpipe, pc, n)
    for k in ref:
        jax_dist = float(np.abs(ref_bf16[k] - ref[k]).max())
        port_dist = float(np.abs(got[k] - ref[k]).max())
        assert 0 < port_dist <= 2 * jax_dist, (k, port_dist, jax_dist)


def test_int8w_walk_quantizes_the_sparse_weight_over_its_output_axis():
    """The walk alone, on one seeded sparse model: the stored q and scale
    are ``quantize_channelwise`` over axis -1 of the float32 weight."""
    model = tsec.SECONDIoU(port_config(GOLDEN)).eval()
    from triton_client_tpu_torch.models.layers import init_random_

    init_random_(model, 3)
    w = model.middle.conv1.weight.detach().clone()
    tprec.apply_cast_params(model, tprec.PrecisionPolicy.parse("int8w"))
    p = model.middle.conv1.parametrizations.weight
    want = jprec.quantize_channelwise(w.numpy())
    np.testing.assert_array_equal(p.original0.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(p.original1.numpy(), np.asarray(want.scale))


# -- the importer ------------------------------------------------------------------------------


def test_one_openpcdet_checkpoint_fills_the_sparse_template():
    """After tests/test_import_fidelity_families.py: the dense model's
    OpenPCDet checkpoint loads into the sparse template with the 3^3
    strided kernel, each (27, cin, cout) weight the row-major reshape of the
    Conv3d kernel, equal to what JAX's importer fills; a 2^3 stage refuses,
    naming stride_kernel=2, in both packages."""
    jcfg = _second_cfg()
    tmodel = TSECONDDense(jcfg).eval()
    _randomize(tmodel, 21)
    state = _state(tmodel)
    sparse = dataclasses.replace(jcfg, middle="sparse", sparse_stride_kernel=3, sparse_budget=48)
    svars = seeded_variables(lambda k: jsec.init_second(k, sparse)[1])  # the template's shapes
    jimported = jimp.load_second(state, svars, strict=True)
    port = tsec.SECONDIoU(port_config(sparse))
    sd = timp.load_second({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}, port)
    assert set(sd) == set(port.state_dict())
    for si in range(len(jcfg.middle_filters)):
        w27 = sd[f"middle.conv{si}.weight"].numpy()
        dense = np.asarray(state[f"backbone_3d.conv{si}.0.weight"])
        np.testing.assert_array_equal(w27, dense.transpose(2, 3, 4, 1, 0).reshape(w27.shape))
        np.testing.assert_array_equal(w27, np.asarray(jimported["params"]["middle"][f"conv{si}"]))
    port.load_state_dict(sd)

    k2 = dataclasses.replace(sparse, sparse_stride_kernel=2)
    k2vars = seeded_variables(lambda k: jsec.init_second(k, k2)[1])
    with pytest.raises(ValueError, match="stride_kernel=2"):
        jimp.load_second(state, k2vars, strict=True)
    with pytest.raises(ValueError, match="stride_kernel=2"):
        timp.load_second(dict(state), tsec.SECONDIoU(port_config(k2)))


def test_importer_keys_of_the_sparse_stages():
    for key, want in (("middle.conv0.weight", "backbone_3d.conv0.0.weight"),
                      ("middle.bn1.running_var", "backbone_3d.conv1.1.running_var"),
                      ("middle.conv3.weight", "backbone_3d.conv3.0.weight")):
        assert timp.second_torch_key(key) == want
    assert jimp.second_torch_key(("params", "middle", "conv0")) == "backbone_3d.conv0.0.weight"


# -- a disk entry, serve and the detect3d CLI -------------------------------------------------


TINY_SPARSE_YAML = """model: second_iou
voxel:
  point_cloud_range: [0.0, -12.8, -2.0, 25.6, 12.8, 2.0]
  voxel_size: [0.4, 0.4, 0.5]
  max_voxels: 2048
  max_points_per_voxel: 8
middle: sparse
sparse_budget: 2048
middle_filters: [8, 8, 8]
sparse_dense_tail_from: 2
sparse_stride_kernel: 2
backbone_layers: [1]
backbone_strides: [1]
backbone_filters: [16]
upsample_strides: [1]
upsample_filters: [16]
pipeline:
  point_buckets: [4096]
  max_det: 16
  pre_max: 64
"""


def run(cli, argv, out: pathlib.Path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main([*argv, "--sink", "jsonl", "-o", str(out)])
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    rows = [{k: v for k, v in json.loads(line).items() if k != "ts"}
            for line in open(out / "detections.jsonl")]
    return report, rows


def test_disk_entry_serve_and_detect3d_config(tmp_path):
    """A disk entry whose ``dataset:`` names a sparse YAML builds and serves;
    ``detect3d --config <yaml>`` in-process, ``-r`` over the entry and
    ``-u grpc:`` against ``serve`` give the same rows on the same seeded
    weights, and the config equals JAX's field by field."""
    from triton_client_tpu_torch.runtime.disk_repository import _Entry, scan_disk

    yaml_path = tmp_path / "tiny_sparse.yaml"
    yaml_path.write_text(TINY_SPARSE_YAML)
    _, jmcfg, _ = jds.detect3d_from_yaml(str(yaml_path))
    _, tmcfg, tpcfg = tds.detect3d_from_yaml(str(yaml_path))
    assert _fields(tmcfg) == _fields(jmcfg) and tmcfg.middle == "sparse"
    repo = tmp_path / "repo"
    (repo / "sparse" / "1").mkdir(parents=True)
    (repo / "sparse" / "config.yaml").write_text(f"family: second_iou\ndataset: {yaml_path}\n")
    _, _, model = _Entry(repo / "sparse", device="cpu")._build()  # seeded, as --config's
    torch.save({"model_state": {timp.second_torch_key(k): v for k, v in model.state_dict().items()
                                if not k.endswith("num_batches_tracked")}},
               repo / "sparse" / "1" / "weights.pth")
    scanned = scan_disk(str(repo), device="cpu")
    extra = scanned.metadata("sparse").extra
    assert extra["fused_stages"] == [] and extra["point_buckets"] == [4096]
    clouds = tmp_path / "clouds"
    clouds.mkdir()
    for i, n in enumerate((1500, 3000)):
        np.save(clouds / f"{i:03d}.npy", cloud(60 + i, n))
    _, local = run(detect3d, ["--config", str(yaml_path), "-i", str(clouds), "--device", "cpu"],
                   tmp_path / "config")
    _, repo_rows = run(detect3d, ["-r", str(repo), "-m", "sparse", "-i", str(clouds), "--device",
                                  "cpu"], tmp_path / "repo_run")
    assert local == repo_rows and len(local) == 2
    assert all(len(r["pred_scores"]) > 0 for r in local)
    args = serve.parser().parse_args(["-r", str(repo), "-a", "127.0.0.1:0", "--device", "cpu",
                                      "--max-workers", "2", "--uds", "off"])
    with contextlib.redirect_stdout(io.StringIO()):
        server = serve.build_server(args)
    server.start()
    try:
        report, remote = run(detect3d, ["-m", "sparse", "-i", str(clouds), "-u",
                                        f"grpc:127.0.0.1:{server.port}", "--no-shm"],
                             tmp_path / "remote")
    finally:
        server.stop()
    assert report["transport"] == "grpc" and remote == local
