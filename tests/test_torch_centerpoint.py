"""The port's CenterPoint (with velocity) against the JAX package's, on the
CPU, with the flax weights carried across by
``models/convert.centerpoint_state_dict_from_flax``.

A tiny nuScenes-shaped grid (64 x 64 pillars over +-6.4 m, 5 point
features with the sweep Δt as the fifth, one layer a block, narrow widths)
stands for the 512 x 512 one. Bars: heads within 1e-5 (the two frameworks
sum convolutions in other orders; measured 2.4e-7); the decode's picked
cells and classes equal, boxes, scores and velocities within 1e-5 (XLA
and PyTorch differ by ulps in ``exp``, ``atan2`` and the contraction of
the world transform; measured 6e-8); the pipeline's labels equal and its
rows within 1e-5 on both tail routes (the JAX route ``fused="on"`` runs
its suppress+pack kernel in interpret mode, the port's the kernel's plain
version). The det3d importer is held to the JAX importer on the det3d-named
mirror of tests/test_import_fidelity_families.py, its shared-conv bias
folded into the BatchNorm mean.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_client_tpu.models import centerpoint as jcp
from triton_client_tpu.ops import detect3d_postprocess as jpost
from triton_client_tpu.ops.voxelize import VoxelConfig as JVoxel
from triton_client_tpu.pipelines import detect3d as jdet
from triton_client_tpu.runtime import importers as jimp

from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.drivers.driver import channel_infer3d
from triton_client_tpu_torch.models import centerpoint as tcp
from triton_client_tpu_torch.models.convert import centerpoint_state_dict_from_flax
from triton_client_tpu_torch.ops import detect3d_postprocess as tpost
from triton_client_tpu_torch.ops.voxelize import VoxelConfig as TVoxel
from triton_client_tpu_torch.pipelines import detect3d as tdet
from triton_client_tpu_torch.runtime import importers as timp
from triton_client_tpu_torch.runtime.repository import ModelRepository
from tests.test_import_fidelity import _randomize, _state
from tests.test_import_fidelity_families import TCenterPoint, _voxel_inputs
from tests.test_torch_server import seeded_variables

RANGE = (-6.4, -6.4, -5.0, 6.4, 6.4, 3.0)
TINY_VOXEL = dict(point_cloud_range=RANGE, voxel_size=(0.2, 0.2, 8.0), max_voxels=512,
                  max_points_per_voxel=8, point_features=5)
TINY = dict(backbone_layers=(1, 1, 1), backbone_filters=(16, 32, 64),
            upsample_filters=(16, 16, 16), vfe_filters=16, head_width=16, max_objects=32)
CFG = dict(model_name="centerpoint", iou_thresh=0.2, point_buckets=(1024,), max_det=16)


def tiny_configs(**fields):
    return (jcp.CenterPointConfig(voxel=JVoxel(**TINY_VOXEL), **{**TINY, **fields}),
            tcp.CenterPointConfig(voxel=TVoxel(**TINY_VOXEL), **{**TINY, **fields}))


def sweep_cloud(seed, n=600, cols=5):
    """A cloud over the tiny range with a Δt column in [0, 0.45] s."""
    rng = np.random.default_rng(seed)
    r = RANGE
    pc = np.column_stack([rng.uniform(r[0], r[3], n), rng.uniform(r[1], r[4], n),
                          rng.uniform(r[2], r[5], n), rng.uniform(0, 1, n),
                          rng.integers(0, 10, n) * 0.05]).astype(np.float32)
    return pc[:, :cols]


@pytest.fixture(scope="module")
def carried():
    jcfg, tcfg = tiny_configs()
    variables = seeded_variables(lambda k: jcp.init_centerpoint(k, jcfg)[1])
    tmodel = tcp.CenterPoint(tcfg)
    tmodel.load_state_dict(centerpoint_state_dict_from_flax(variables, tmodel))
    return jcp.CenterPoint(jcfg), variables, tmodel.eval()


def _padded(seed, n=600):
    pc = np.zeros((1024, 5), np.float32)
    pc[:n] = sweep_cloud(seed, n)
    return pc, n


def _assert_heads(got, want):
    assert set(got) == set(want) == {"heatmap", "offset", "height", "size", "rot", "vel"}
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_from_points_heads_match_jax(carried, seed):
    jmodel, variables, tmodel = carried
    pc, n = _padded(seed)
    want = jmodel.apply(variables, jnp.asarray(pc), jnp.asarray(n), method=jmodel.from_points)
    with torch.no_grad():
        got = tmodel.from_points(torch.from_numpy(pc), torch.tensor(n))
    _assert_heads(got, want)


def test_grouped_forward_heads_match_jax(carried):
    jmodel, variables, tmodel = carried
    rng = np.random.default_rng(3)
    voxels, num_points, coords = _voxel_inputs(tmodel.cfg, rng, use_z=False)
    voxels = np.concatenate([voxels, rng.uniform(0, 0.5, voxels.shape[:2] + (1,))
                             .astype(np.float32)], -1)
    want = jmodel.apply(variables, *(jnp.asarray(a)[None] for a in (voxels, num_points, coords)))
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(a)[None] for a in (voxels, num_points, coords)))
    _assert_heads(got, want)


def _cells(boxes, cfg):
    """The head cell (y, x) each decoded box sits in (offsets in [0, 1))."""
    s = cfg.head_stride * np.asarray(cfg.voxel.voxel_size[:2])
    xy = (np.asarray(boxes)[..., :2] - np.asarray(cfg.voxel.point_cloud_range[:2])) / s
    return np.floor(xy + 1e-3).astype(np.int64)


def _decode_both(carried, heads):
    jmodel, _, tmodel = carried
    want = jmodel.decode(heads)  # decode reads no parameters
    got = tmodel.decode({k: torch.from_numpy(np.array(v)) for k, v in heads.items()})
    assert set(got) == set(want) == {"boxes", "scores", "velocity"}
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=0, atol=1e-5, err_msg=k)
    cfg = tmodel.cfg
    np.testing.assert_array_equal(_cells(got["boxes"], cfg), _cells(want["boxes"], cfg))
    np.testing.assert_array_equal(got["scores"].numpy().argmax(-1),
                                  np.asarray(want["scores"]).argmax(-1))
    return got


def _flat_heads(cfg, heat, offset=0.25):
    h, w = cfg.head_hw
    return {
        "heatmap": heat,
        "offset": jnp.full((1, h, w, 2), offset),
        "height": jnp.full((1, h, w, 1), -1.0),
        "size": jnp.log(jnp.broadcast_to(jnp.asarray([4.0, 2.0, 1.5]), (1, h, w, 3))),
        "rot": jnp.broadcast_to(jnp.asarray([np.sin(0.3), np.cos(0.3)]), (1, h, w, 2)),
        "vel": jnp.full((1, h, w, 2), 0.25),
    }


def test_decode_planted_peak_matches_jax(carried):
    """One peak (class 3): the top row is its box. The flat -10 logits
    around it are a plateau of local maxima, all of one score: the 31 rows
    that fill K tie, and both packages take them from the lowest flat
    index (cell 0, class 0 upward)."""
    cfg = carried[2].cfg
    h, w = cfg.head_hw
    heat = jnp.full((1, h, w, cfg.num_classes), -10.0).at[0, 5, 7, 3].set(6.0)
    got = _decode_both(carried, _flat_heads(cfg, heat))
    scores = got["scores"].numpy()[0]
    assert scores[0, 3] == pytest.approx(float(jax.nn.sigmoid(6.0)), rel=1e-6)
    assert (_cells(got["boxes"], cfg)[0, 0] == [7, 5]).all()
    np.testing.assert_array_equal(scores[1:].argmax(-1), np.arange(31) % 10)
    assert (scores[1:].max(-1) < 1e-4).all()


def test_decode_plateau_and_neighbours_match_jax(carried):
    """A dominant peak with a weaker 8-neighbour (pooled away), two equal
    peaks side by side (a plateau: both pass ``>=``), and a peak on the
    border (the -inf padding)."""
    cfg = carried[2].cfg
    h, w = cfg.head_hw
    heat = jnp.full((1, h, w, cfg.num_classes), -10.0)
    heat = heat.at[0, 5, 7, 0].set(6.0).at[0, 5, 8, 0].set(5.0)
    heat = heat.at[0, 20, 10, 2].set(3.0).at[0, 20, 11, 2].set(3.0)
    heat = heat.at[0, 0, w - 1, 9].set(1.0)
    got = _decode_both(carried, _flat_heads(cfg, heat, offset=0.0))
    scores = got["scores"].numpy()[0].max(-1)
    assert (scores > 0.9).sum() == 3 and (scores > 0.5).sum() == 4


def test_decode_on_the_models_heads_matches_jax(carried):
    jmodel, variables, _ = carried
    pc, n = _padded(2)
    heads = jmodel.apply(variables, jnp.asarray(pc), jnp.asarray(n), method=jmodel.from_points)
    got = _decode_both(carried, heads)
    assert (got["scores"].numpy().max(-1) > 0).sum() > 10


def test_strict_conversion_rejects_missing_and_extra_leaves(carried):
    _, variables, tmodel = carried
    missing = copy.deepcopy(variables)
    del missing["params"]["head"]["vel"]["bias"]
    with pytest.raises(KeyError, match="unfilled"):
        centerpoint_state_dict_from_flax(missing, tmodel)
    extra = copy.deepcopy(variables)
    extra["params"]["head"]["shared"]["bias"] = np.zeros(16, np.float32)
    with pytest.raises(KeyError, match="no such tensor"):
        centerpoint_state_dict_from_flax(extra, tmodel)
    wrong = copy.deepcopy(variables)
    wrong["params"]["head"]["heatmap"]["kernel"] = np.zeros((1, 1, 16, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        centerpoint_state_dict_from_flax(wrong, tmodel)
    no_vel = tcp.CenterPoint(tiny_configs(with_velocity=False)[1])
    with pytest.raises(KeyError, match="no such tensor"):  # the vel branch has no home
        centerpoint_state_dict_from_flax(variables, no_vel)


# -- the pipeline ------------------------------------------------------------------


def _build_pair(fused, variables):
    jcfg, tcfg = tiny_configs()
    jpipe, jspec, _ = jdet.build_centerpoint_pipeline(
        model_cfg=jcfg, config=jdet.Detect3DConfig(fused=fused, **CFG), variables=variables)
    tpipe, tspec, _ = tdet.build_centerpoint_pipeline(
        model_cfg=tcfg, config=tdet.Detect3DConfig(fused=fused, **CFG), variables=variables,
        device="cpu")
    return jpipe, jspec, tpipe, tspec


@pytest.fixture(scope="module", params=["on", "off"])
def pair(request, carried):
    return _build_pair(request.param, carried[1])


def _assert_rows(got, want):
    assert set(got) == set(want) == {"pred_boxes", "pred_scores", "pred_labels",
                                     "pred_velocities"}
    assert got["pred_boxes"].shape == want["pred_boxes"].shape
    np.testing.assert_array_equal(got["pred_labels"], want["pred_labels"])
    for k in ("pred_boxes", "pred_scores", "pred_velocities"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pipeline_matches_jax(pair, seed):
    jpipe, jspec, tpipe, tspec = pair
    assert tspec.extra["fused_stages"] == jspec.extra["fused_stages"]
    pc = sweep_cloud(seed)
    got = tpipe.infer(pc)
    _assert_rows(got, jpipe.infer(pc))
    assert 0 < len(got["pred_scores"]) <= CFG["max_det"]
    assert got["pred_labels"].min() >= 1 and got["pred_labels"].max() <= 10


def test_pipeline_four_column_cloud_and_empty_cloud_match_jax(pair):
    """A single sweep of 4 columns is zero-filled to Δt = 0 (the
    reference's single-sweep pad) in both packages."""
    jpipe, _, tpipe, _ = pair
    four = sweep_cloud(4, cols=4)
    got = tpipe.infer(four)
    _assert_rows(got, jpipe.infer(four))
    five = tpipe.infer(np.pad(four, ((0, 0), (0, 1))))
    for k in got:
        np.testing.assert_array_equal(got[k], five[k])
    empty = np.zeros((0, 5), np.float32)
    _assert_rows(tpipe.infer(empty), jpipe.infer(empty))


def test_spec_matches_the_jax_spec(pair):
    _, jspec, _, tspec = pair
    assert (tspec.name, tspec.version, tspec.platform) == (jspec.name, jspec.version, "torch")
    assert [(t.name, t.shape, t.dtype) for t in tspec.inputs + tspec.outputs] == \
        [(t.name, t.shape, t.dtype) for t in jspec.inputs + jspec.outputs]
    assert tspec.outputs[0].shape == (16, 11) and tspec.outputs[2].name == "velocities"
    for key, value in tspec.extra.items():
        if key != "param_bytes":
            assert jspec.extra[key] == value, key
    assert tspec.extra["with_velocity"] is True


def test_fused_and_unfused_routes_equal_by_value(carried):
    _, tcfg = tiny_configs()
    pipes = {f: tdet.build_centerpoint_pipeline(
        model_cfg=tcfg, config=tdet.Detect3DConfig(fused=f, **CFG), variables=carried[1],
        device="cpu")[0] for f in ("on", "off")}
    assert pipes["on"].fused_stages == ("decode_nms",) and pipes["off"].fused_stages == ()
    for seed in (5, 6):
        padded, m = tdet.prepare_points(sweep_cloud(seed), 5, (1024,))
        rows = {f: p.run(torch.from_numpy(padded), torch.tensor(m, dtype=torch.int32))
                for f, p in pipes.items()}
        assert torch.equal(rows["on"][1], rows["off"][1]) and bool(rows["on"][1].any())
        assert torch.equal(rows["on"][0], rows["off"][0])


def test_captured_body_and_served_outputs_on_the_cpu(pair):
    """On the CPU ``_jit`` is the eager body; ``infer_fn`` and ``device_fn``
    serve ``velocities`` as the detections' columns 7:9."""
    _, _, tpipe, tspec = pair
    padded, m = tdet.prepare_points(sweep_cloud(7), 5, (1024,))
    args = torch.from_numpy(padded), torch.tensor(m, dtype=torch.int32)
    eager = tpipe.run(*args)
    captured = tpipe._jit(*args)
    for e, c in zip(eager, captured):
        assert torch.equal(e, c)
    for fn in (tpipe.infer_fn(), tpipe.device_fn()):
        out = fn({"points": args[0], "num_points": args[1]})
        assert set(out) == {o.name for o in tspec.outputs}
        assert torch.equal(out["detections"], eager[0]) and torch.equal(out["valid"], eager[1])
        assert torch.equal(out["velocities"], eager[0][:, 7:9])


def test_default_config_and_class_names_follow_the_model():
    cfg = tdet.default_detect3d_config("centerpoint")
    jcfg = jdet.default_detect3d_config("centerpoint")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.iou_thresh == 0.2 and cfg.nsweeps == 1
    _, tcfg = tiny_configs()
    pipe, spec, _ = tdet.build_centerpoint_pipeline(
        model_cfg=tcfg, config=tdet.Detect3DConfig(point_buckets=(1024,)), device="cpu")
    assert pipe.config.class_names == tcp.NUSC_CLASSES == tuple(spec.extra["class_names"])
    assert "centerpoint" in tdet.BUILDERS_3D


def test_the_builder_and_the_cli_run_on_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdet.build_centerpoint_pipeline()
    from triton_client_tpu_torch.cli import detect3d as tcli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["-m", "centerpoint", "-i", "synthetic:1"])


@pytest.mark.parametrize("fused", [False, True])
def test_extract_boxes_3d_on_one_hot_scores_with_velocity_matches_jax(fused):
    """The decode's contract into the tail: (B, K, 9) boxes with the
    velocity as 2 extra columns and one-hot scores (rows of zeros take
    label 1 and are gated out), K = 128 candidates of 11-column rows."""
    rng = np.random.default_rng(9)
    k, nc = 128, 10
    centers = rng.uniform(-40, 40, (16, 2))
    boxes = np.column_stack(
        [centers[rng.integers(0, 16, k)] + rng.normal(0, 1.0, (k, 2)), rng.uniform(-2, 0, k),
         rng.uniform(1, 4, k), rng.uniform(0.5, 2, k), rng.uniform(1, 2, k),
         rng.uniform(-np.pi, np.pi, k), rng.normal(0, 3, (k, 2))]).astype(np.float32)[None]
    scores = np.zeros((1, k, nc), np.float32)
    cls = rng.integers(0, nc, k)
    scores[0, np.arange(k), cls] = rng.uniform(0, 1, k)
    scores[0, 100:] = 0.0  # the zero rows that pad K
    kw = dict(score_thresh=0.1, iou_thresh=0.2, max_det=128, pre_max=256)
    want_rows, want_valid = jpost.extract_boxes_3d(
        jnp.asarray(boxes), jnp.asarray(scores), fused=fused, interpret=True, **kw)
    rows, valid = tpost.extract_boxes_3d(torch.from_numpy(boxes), torch.from_numpy(scores),
                                         fused=fused, **kw)
    assert rows.shape == (1, 128, 11)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    assert 10 < int(valid.sum()) < 90


def test_channel_round_trip_carries_velocities(pair):
    _, _, tpipe, tspec = pair
    repo = ModelRepository()
    repo.register(tspec, tpipe.infer_fn())
    channel = CUDAChannel(repo, device="cpu")
    infer = channel_infer3d(channel, tspec.name)
    for seed in (0, 8):
        pc = sweep_cloud(seed, 700)
        got, want = infer(pc), tpipe.infer(pc)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_a_server_without_the_flag_is_read_by_its_row_width(pair):
    """JAX's fallback for servers that publish no ``with_velocity``: 11
    columns carry a velocity, 9 do not."""
    _, _, tpipe, tspec = pair
    extra = {k: v for k, v in tspec.extra.items() if k != "with_velocity"}
    pc = sweep_cloud(3)
    repo = ModelRepository()
    repo.register(dataclasses.replace(tspec, extra=extra), tpipe.infer_fn())
    got = channel_infer3d(CUDAChannel(repo, device="cpu"), tspec.name)(pc)
    np.testing.assert_array_equal(got["pred_velocities"], tpipe.infer(pc)["pred_velocities"])
    rows = np.zeros((4, 9), np.float32)
    assert "pred_velocities" not in tdet.unpack_rows(rows, np.ones(4, bool))


# -- the det3d importer --------------------------------------------------------------


MIRROR_VOXEL = dict(point_cloud_range=(0.0, -1.6, -5.0, 3.2, 1.6, 3.0),
                    voxel_size=(0.2, 0.2, 8.0), max_voxels=48, max_points_per_voxel=8)
MIRROR = dict(vfe_filters=16, backbone_layers=(1, 1), backbone_strides=(1, 2),
              backbone_filters=(16, 32), upsample_strides=(1, 2), upsample_filters=(16, 16),
              head_width=16, max_objects=8)


@pytest.fixture(scope="module")
def mirror():
    jcfg = jcp.CenterPointConfig(voxel=JVoxel(**MIRROR_VOXEL), **MIRROR)
    tcfg = tcp.CenterPointConfig(voxel=TVoxel(**MIRROR_VOXEL), **MIRROR)
    tmirror = TCenterPoint(jcfg).eval()
    _randomize(tmirror, 31)
    template = seeded_variables(lambda k: jcp.init_centerpoint(k, jcfg)[1])
    return jcfg, tcfg, _state(tmirror), template


def test_load_centerpoint_equals_the_jax_importer_with_the_bias_fold(mirror):
    """The same det3d state dict through both importers: the port's
    state_dict equals the JAX tree carried across, bit for bit (the
    shared-conv bias folded into the BN mean in float32 on both sides),
    and the two models give the same heads."""
    jcfg, tcfg, state, template = mirror
    assert "bbox_head.shared_conv.0.bias" in state
    jtree = jimp.load_centerpoint(state, template, strict=True)
    model = tcp.CenterPoint(tcfg)
    got = timp.load_centerpoint(state, model)
    want = centerpoint_state_dict_from_flax(jtree, tcp.CenterPoint(tcfg))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(torch.as_tensor(got[k]), want[k]), k
    folded = state["bbox_head.shared_conv.1.running_mean"] - state["bbox_head.shared_conv.0.bias"]
    np.testing.assert_array_equal(got["head.shared_bn.running_mean"].numpy(), folded)
    model.load_state_dict(got)
    model.eval()
    voxels, num_points, coords = _voxel_inputs(tcfg, np.random.default_rng(33), use_z=False)
    jheads = jcp.CenterPoint(jcfg).apply(
        jtree, *(jnp.asarray(a)[None] for a in (voxels, num_points, coords)))
    with torch.no_grad():
        theads = model(*(torch.from_numpy(a)[None] for a in (voxels, num_points, coords)))
    _assert_heads(theads, jheads)


def test_load_centerpoint_raises_on_a_missing_key(mirror):
    _, tcfg, state, _ = mirror
    model = tcp.CenterPoint(tcfg)
    no_mean = {k: v for k, v in state.items() if k != "bbox_head.shared_conv.1.running_mean"}
    with pytest.raises(KeyError, match="cannot fold"):
        timp.load_centerpoint(no_mean, model)
    no_vel = {k: v for k, v in state.items() if k != "bbox_head.tasks.0.vel.0.weight"}
    with pytest.raises(KeyError, match="vel"):
        timp.load_centerpoint(no_vel, model)
    no_neck = {k: v for k, v in state.items() if k != "neck.deblocks.1.1.running_var"}
    with pytest.raises(KeyError, match="neck.deblocks.1.1.running_var"):
        timp.load_centerpoint(no_neck, model)
    assert timp.centerpoint_torch_key("backbone.block1_conv0.weight") == "neck.blocks.1.4.weight"
    assert timp.centerpoint_torch_key("head.shared_bn.bias") == "bbox_head.shared_conv.1.bias"
    assert timp.IMPORTERS["centerpoint"] is timp.load_centerpoint
