"""Every serving precision policy on the port's 3D families (PointPillars,
SECOND-IoU with the dense middle, CenterPoint with velocity) against the
JAX package's, on the CPU, at tiny sizes, on the same flax variables.

Weights carry flax's init statistics (BatchNorm the identity, biases 0,
CenterPoint's heatmap bias at its -2.19 prior, kernels N(0, 1/fan_in)),
filled from a seeded generator over ``jax.eval_shape``: with random
BatchNorm statistics JAX's own bf16 misses its budget (ROADMAP Queue 3).

Bars:
- ``int8w``/``int8``: ``q`` and ``scale`` equal JAX's per flax leaf,
  through the kernel layout map (the ``ConvTranspose2d`` up-samplers and
  SECOND's ``Conv3d`` stages included); the int8w heads within the
  float32 bar (1e-5) of JAX's int8w heads; ``param_bytes``, ``precision``
  and ``precision_keep_f32`` equal JAX's specs;
- ``bf16``: max |port bf16 heads - JAX f32 heads| <= 2 x max |JAX bf16
  heads - JAX f32 heads| (flax normalises in bfloat16, PyTorch in float32
  and rounds, so the two are not bitwise);
- the tails (gate, top-k, decode, suppress + pack) fed the same JAX bf16
  heads, boundary-cast to float32: the valid mask, scores, labels and their
  order bitwise equal, the box columns within 4e-7 relative or 1e-7
  absolute (PyTorch's and XLA's float32 ``exp`` differ by an ulp);
- each policy's detections, scored by the port's ``Detection3DEvaluator``
  against its own f32 detections: at least the f32 self-score less
  ``MAP_BUDGETS[policy]``;
- ``points`` stays float32 on the wire under every policy.

The CLIs, a remote client and full KITTI width:
tests/test_torch_precision_serving.py.
"""

from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_client_tpu.models import centerpoint as jcp
from triton_client_tpu.models import pointpillars as jpp
from triton_client_tpu.models import second as jsec
from triton_client_tpu.ops.detect3d_postprocess import extract_boxes_3d as jextract
from triton_client_tpu.ops.detect3d_postprocess import nms_pack_3d as jnms_pack
from triton_client_tpu.ops.pallas_decode import fused_residual_decode
from triton_client_tpu.pipelines import detect3d as jdet
from triton_client_tpu.runtime import precision as jprec

from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.channel.staged import cast_wire_input
from triton_client_tpu_torch.eval.detection_map import Detection3DEvaluator
from triton_client_tpu_torch.pipelines import detect3d as tdet
from triton_client_tpu_torch.runtime import precision as tprec
from triton_client_tpu_torch.runtime.repository import ModelRepository
from tests.test_fused_parity import TINY_SECOND
from tests.test_torch_centerpoint import sweep_cloud
from tests.test_torch_centerpoint import tiny_configs as cp_configs
from tests.test_torch_pointpillars import cloud
from tests.test_torch_pointpillars import tiny_configs as pp_configs
from tests.test_torch_precision import quantized_leaves_equal_jax
from tests.test_torch_second import TINY_RANGE, port_config
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
FAMILIES = ("pointpillars", "second_iou", "centerpoint")
BUCKET = 1024


def flax_init_variables(init, seed=0):
    """A flax tree of ``init``'s structure with flax's init statistics."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "var" in name or "scale" in name:
            return np.ones(s.shape, s.dtype)
        if "heatmap" in name and "bias" in name:
            return np.full(s.shape, -2.19, s.dtype)
        if "mean" in name or "bias" in name:
            return np.zeros(s.shape, s.dtype)
        fan_in = max(1, int(np.prod(s.shape[:-1])))
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _setup(family):
    """(JAX model cfg, port model cfg, pipeline kwargs, cloud maker, JAX
    model class, JAX init) of one family at its tiny size."""
    if family == "pointpillars":
        jcfg, tcfg = pp_configs()
        return (jcfg, tcfg, dict(point_buckets=(BUCKET,), max_det=16, pre_max=64),
                lambda seed: cloud(seed, 600), jpp.PointPillars,
                lambda k: jpp.init_pointpillars(k, jcfg)[1])
    if family == "second_iou":
        return (TINY_SECOND, port_config(),
                dict(model_name="second_iou", point_buckets=(BUCKET,), max_det=16, pre_max=64),
                lambda seed: cloud(seed, 600, TINY_RANGE), jsec.SECONDIoU,
                lambda k: jsec.init_second(k, TINY_SECOND)[1])
    jcfg, tcfg = cp_configs()
    return (jcfg, tcfg, dict(model_name="centerpoint", iou_thresh=0.2,
                             point_buckets=(BUCKET,), max_det=16),
            lambda seed: sweep_cloud(seed), jcp.CenterPoint,
            lambda k: jcp.init_centerpoint(k, jcfg)[1])


_VARIABLES: dict = {}


def variables_of(family):
    if family not in _VARIABLES:
        _VARIABLES[family] = flax_init_variables(_setup(family)[5], seed=13)
    return _VARIABLES[family]


_PAIRS: dict = {}


def build_pair(family, precision, fused="off", dtype="fp32"):
    """(JAX pipeline, JAX spec, port pipeline, port spec) on the same
    variables under one policy, once a module."""
    key = (family, precision, fused, dtype)
    if key not in _PAIRS:
        _PAIRS[key] = _build_pair(*key)
    return _PAIRS[key]


def _build_pair(family, precision, fused, dtype):
    jcfg, tcfg, kw, *_ = _setup(family)
    variables = variables_of(family)
    jdtype = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jpipe, jspec, _ = jdet.BUILDERS_3D[family](
        jax.random.PRNGKey(0), model_cfg=jcfg, config=jdet.Detect3DConfig(fused=fused, **kw),
        variables=variables, dtype=jdtype, precision=precision)
    tpipe, tspec, _ = tdet.BUILDERS_3D[family](
        model_cfg=tcfg, config=tdet.Detect3DConfig(fused=fused, **kw), variables=variables,
        device="cpu", dtype=dtype, precision=precision)
    return jpipe, jspec, tpipe, tspec


def padded(family, seed):
    pc = _setup(family)[3](seed)
    out = np.zeros((BUCKET, pc.shape[1]), np.float32)
    out[: len(pc)] = pc
    return out, len(pc)


def jax_heads(jpipe, pc, n):
    """The JAX pipeline's raw heads (its scatter route), as its body takes
    them: the realized variables through the model, then the boundary."""
    if not hasattr(jpipe, "_test_heads"):
        m = jpipe.model
        jpipe._test_heads = jax.jit(lambda v, p, c: jpipe.precision.boundary(
            m.apply(jprec.realize(v), p, c, method=m.from_points)))
    heads = jpipe._test_heads(jpipe.variables, jnp.asarray(pc), jnp.asarray(n))
    return {k: np.array(v) for k, v in heads.items()}


def port_heads(tpipe, pc, n):
    with torch.no_grad():
        return {k: v.numpy() for k, v in tpipe.heads(torch.from_numpy(pc), torch.tensor(n)).items()}


def jax_tail(jpipe, heads):
    """The JAX pipeline body from its heads on (``Detect3DPipeline._pipeline``
    after ``boundary``), with the Pallas kernels in interpret mode."""
    cfg, model = jpipe.config, jpipe.model
    fuse = "decode_nms" in jpipe.fused_stages
    if hasattr(model, "decode_topk"):
        if fuse:
            tc = model.topk_candidates(heads, pre_max=cfg.pre_max, score_thresh=cfg.score_thresh)
            mc = model.cfg
            boxes = jax.vmap(lambda d, a, db: fused_residual_decode(
                d, a, db, num_dir_bins=mc.num_dir_bins, dir_offset=mc.dir_offset,
                interpret=True))(tc["deltas"], tc["anchors"], tc["dir_bin"])
            cand = {"boxes": boxes, "scores": tc["scores"], "labels": tc["labels"]}
        else:
            cand = model.decode_topk(heads, pre_max=cfg.pre_max, score_thresh=cfg.score_thresh)
        dets, valid = jnms_pack(cand["boxes"], cand["scores"], cand["labels"],
                                iou_thresh=cfg.iou_thresh, max_det=cfg.max_det, fused=fuse,
                                interpret=True)
    else:
        pred = model.decode(heads)
        boxes = pred["boxes"]
        if "velocity" in pred:
            boxes = jnp.concatenate([boxes, pred["velocity"]], axis=-1)
        dets, valid = jextract(boxes, pred["scores"], score_thresh=cfg.score_thresh,
                               iou_thresh=cfg.iou_thresh, max_det=cfg.max_det,
                               pre_max=cfg.pre_max, fused=fuse, interpret=True)
    return np.asarray(dets[0]), np.asarray(valid[0])


# -- storage and specs -----------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["bf16", "int8w", "int8"])
@pytest.mark.parametrize("family", FAMILIES)
def test_specs_and_int8_leaves_agree_with_jax(family, policy):
    """precision, KEEP_F32_3D and param_bytes as JAX's builder records them;
    under the int8 policies every quantized kernel equals JAX's."""
    _, jspec, tpipe, tspec = build_pair(family, policy)
    for key in ("precision", "precision_keep_f32", "param_bytes", "fused_stages"):
        assert tspec.extra[key] == jspec.extra[key], key
    assert tspec.extra["precision_keep_f32"] == list(tprec.KEEP_F32_3D)
    assert tpipe.precision.keep_f32_inputs == ("points",) == jdet.Detect3DPipeline(
        jdet.Detect3DConfig(), None, {}, precision=policy).precision.keep_f32_inputs
    if policy != "bf16":
        jtree = jprec.PrecisionPolicy.parse(policy).cast_params(variables_of(family))
        assert quantized_leaves_equal_jax(tpipe.model, jtree) >= 10
        assert tspec.extra["param_bytes"] == jprec.tree_bytes(jtree)


@pytest.mark.parametrize("family", FAMILIES)
def test_dtype_bf16_keeps_the_f32_policy(family):
    """``dtype="bf16"`` with the f32 policy: a bfloat16 body, float32 heads,
    the f32 policy and its wire. JAX keeps the float32 tree under a
    bfloat16 module; the port stores the body in bfloat16 (ROADMAP Queue 3:
    its param_bytes is the body's half plus the float32 heads)."""
    _, jspec, tpipe, tspec = build_pair(family, None, dtype="bf16")
    _, f32_spec, f32_pipe, _ = build_pair(family, None)
    assert tspec.extra["precision"] == jspec.extra["precision"] == "f32"
    model = tpipe.model
    heads = [m for n, m in model.named_modules()
             if n.endswith(("_head", "heatmap", "offset", "height", "size", "rot", "vel"))]
    head_bytes = sum(tprec.tree_bytes(dict(m.state_dict())) for m in heads)
    assert all(p.dtype == torch.float32 for m in heads for p in m.parameters())
    assert model.backbone.block0_down.weight.dtype == torch.bfloat16
    assert jspec.extra["param_bytes"] == f32_spec.extra["param_bytes"]
    assert tspec.extra["param_bytes"] == (f32_spec.extra["param_bytes"] - head_bytes) // 2 \
        + head_bytes
    assert tpipe.precision.wire_dtype("points") == torch.float32


@pytest.mark.parametrize("policy", ["bf16", "int8w"])
@pytest.mark.parametrize("family", FAMILIES)
def test_upstream_weights_import_into_every_policy(family, policy):
    """An upstream-named checkpoint (OpenPCDet's names for the anchor
    models, det3d's for CenterPoint) loads into the policy's model as the
    flax tree does: the importer fills float32, then the policy stores it,
    the same tensors bit for bit."""
    from triton_client_tpu_torch.runtime import importers

    key = {"pointpillars": importers.pointpillars_torch_key,
           "second_iou": importers.second_torch_key,
           "centerpoint": importers.centerpoint_torch_key}[family]
    f32_model = build_pair(family, None)[2].model
    state = {key(k): v.clone() for k, v in f32_model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    _, tcfg, kw, *_ = _setup(family)
    _, spec, model = tdet.BUILDERS_3D[family](
        model_cfg=tcfg, config=tdet.Detect3DConfig(**kw), device="cpu", precision=policy,
        state_dict=lambda m: importers.IMPORTERS[family](state, m))
    want = build_pair(family, policy)[2].model.state_dict()
    got = model.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert spec.extra["param_bytes"] == build_pair(family, policy)[3].extra["param_bytes"]


# -- heads --------------------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_int8w_heads_match_jax_int8w(family):
    jpipe, _, tpipe, _ = build_pair(family, "int8w")
    for seed in (0, 1):
        pc, n = padded(family, seed)
        want, got = jax_heads(jpipe, pc, n), port_heads(tpipe, pc, n)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_heads_within_twice_the_references_own_bf16_distance(family):
    jpipe, _, tpipe, _ = build_pair(family, "bf16")
    jf32, _, _, _ = build_pair(family, None)
    model = tpipe.model
    assert model.backbone.block0_down.weight.dtype == torch.bfloat16
    pc, n = padded(family, 2)
    ref, ref_bf16 = jax_heads(jf32, pc, n), jax_heads(jpipe, pc, n)
    got = port_heads(tpipe, pc, n)
    for k in ref:
        jax_dist = float(np.abs(np.asarray(ref_bf16[k]) - np.asarray(ref[k])).max())
        port_dist = float(np.abs(got[k] - np.asarray(ref[k])).max())
        assert got[k].dtype == np.float32
        assert 0 < port_dist <= 2 * jax_dist, (k, port_dist, jax_dist)


@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("family", FAMILIES)
def test_tails_equal_jax_on_identical_bf16_heads(family, fused):
    """JAX's bf16 heads, boundary-cast to float32, fed to both tails: the
    rounded logits tie far more often (CenterPoint's >= peak plateaus, the
    anchor models' top-k), and both break ties to the lowest index."""
    jpipe, _, tpipe, _ = build_pair(family, "bf16", fused=fused)
    live = 0
    for seed in (3, 4):
        heads = jax_heads(jpipe, *padded(family, seed))
        want_rows, want_valid = jax_tail(jpipe, heads)
        with torch.no_grad():
            rows, valid = tpipe.tail({k: torch.from_numpy(v) for k, v in heads.items()})
        rows, valid = rows.numpy(), valid.numpy()
        np.testing.assert_array_equal(valid, want_valid)
        np.testing.assert_array_equal(rows[:, -2:], want_rows[:, -2:])  # scores, labels, order
        np.testing.assert_allclose(rows, want_rows, rtol=4e-7, atol=1e-7)
        live += int(valid.sum())
    assert live > 0


# -- detections -------------------------------------------------------------------------------

_F32_ROWS: dict = {}


def _detections(tpipe, family, seeds=(5, 6, 7)):
    return [tpipe.infer(_setup(family)[3](seed)) for seed in seeds]


@pytest.mark.parametrize("policy", ["bf16", "int8w", "int8"])
@pytest.mark.parametrize("family", FAMILIES)
def test_policy_detections_hold_the_map_budget(family, policy):
    """The port's detections under ``policy`` scored against its own f32
    detections on the same clouds and variables."""
    if family not in _F32_ROWS:
        _F32_ROWS[family] = _detections(build_pair(family, None)[2], family)
    ref = _F32_ROWS[family]
    gts = [np.concatenate([r["pred_boxes"], r["pred_labels"][:, None] - 1.0], 1) for r in ref]
    assert sum(len(g) for g in gts) > 0, "parity needs live boxes"

    def score(rows):
        ev = Detection3DEvaluator()
        for r, gt in zip(rows, gts):
            ev.add_frame3d(r["pred_boxes"], r["pred_scores"], r["pred_labels"], gt)
        return float(ev.summary()["map"])

    got = score(_detections(build_pair(family, policy)[2], family))
    assert got >= score(ref) - tprec.MAP_BUDGETS[policy], (got, score(ref))


# -- the wire ------------------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["f32", "bf16", "int8w", "int8"])
def test_points_stage_float32_under_every_policy(policy):
    """A 3D entry's channel stages ``points`` float32 whatever the policy
    (KEEP_F32_3D), even a calibrated one, and serves the pipeline's rows."""
    _, _, tpipe, tspec = build_pair("pointpillars", policy)
    pc, n = padded("pointpillars", 8)
    pol = tpipe.precision
    if pol.quantize_acts:
        pol = pol.calibrated({"points": pc})
        assert pol.act_scales == () and pol.keep_f32_inputs == ("points",)
    repo = ModelRepository()
    repo.register(tspec, tpipe.infer_fn(), precision=pol)
    model = repo.get(tspec.name)
    assert cast_wire_input(model, "points", pc) is pc
    chan = CUDAChannel(repo, device="cpu")
    staged, _ = chan._place_inputs(model, InferRequest(
        tspec.name, {"points": pc, "num_points": np.asarray(n, np.int32)}))
    assert staged["points"].dtype == torch.float32 == pol.wire_dtype("points")
    out = chan.do_inference(InferRequest(tspec.name, {
        "points": pc, "num_points": np.asarray(n, np.int32)})).outputs
    with torch.no_grad():
        rows, valid = tpipe.run(torch.from_numpy(pc), torch.tensor(n, dtype=torch.int32))
    np.testing.assert_array_equal(out["detections"], rows.numpy())
    np.testing.assert_array_equal(out["valid"], valid.numpy())
