"""The layout and precision of ``examples/yolov5_crop`` in the port: the
``s2d`` stem, the ``ch_floor`` of 32 and a bfloat16 body, against the JAX
package on the same flax variables and frames (YOLOv5n, 64x64, 2 classes).

Bars:
- float32 heads at tests/test_torch_yolov5.py's (atol 5e-4, rtol 1e-4);
- plain-layout weights imported into s2d + ch_floor give the plain
  model's heads within 5e-4 (JAX's
  ``test_yolov5_mxu_import_exact_function_parity``);
- bfloat16, from the reference itself: max |port bf16 heads - JAX f32
  heads| <= 2 x max |JAX bf16 heads - JAX f32 heads|. flax computes
  BatchNorm in bfloat16, PyTorch in float32 on bfloat16 tensors, so the
  two are not bitwise;
- detections: the port's bf16 detections scored against its own f32
  ones hold the f32 self-score less ``MAP_BUDGETS["bf16"]``, as
  tests/test_precision.py scores the JAX policies; ``serve --precision
  bf16`` held to the JAX server's bf16 detections at the same budget.
"""

import pathlib

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_client_tpu.channel.grpc_channel import GRPCChannel as JGRPCChannel
from triton_client_tpu.channel.base import InferRequest as JInferRequest
from triton_client_tpu.channel.tpu_channel import TPUChannel
from triton_client_tpu.models.yolov5 import YoloV5 as JYoloV5
from triton_client_tpu.pipelines import detect2d as jdet2d
from triton_client_tpu.runtime import server as jserver
from triton_client_tpu.runtime.repository import ModelRepository as JRepository

from triton_client_tpu_torch.cli import serve
from triton_client_tpu_torch.eval.detection_map import DetectionEvaluator
from triton_client_tpu_torch.models.convert import yolov5_state_dict_from_flax
from triton_client_tpu_torch.models.yolov5 import YoloV5
from triton_client_tpu_torch.pipelines import detect2d as tdet2d
from triton_client_tpu_torch.runtime.importers import load_yolov5
from triton_client_tpu_torch.runtime.precision import MAP_BUDGETS
from tests.test_import_fidelity import TYoloV5N, _randomize
from tests.test_torch_server import seeded_variables
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
HW = (64, 64)
NC = 2
# max_det stays at its 300, above the 252 boxes of a 64x64 head, as in
# tests/test_precision.py: no cut through near-tied scores
CFG = dict(model_name="yolov5n", num_classes=NC, input_hw=HW, conf_thresh=0.05)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flax_init_like(model, seed):
    """Variables with flax's init statistics, as tests/test_precision.py's
    ``init`` draws them (kernels N(0, 1/fan_in); BatchNorm the identity,
    biases 0), filled from a seeded generator over ``jax.eval_shape``
    (the init itself costs more than the rest of the file)."""
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, *HW, 3)), train=False),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "var" in name or "scale" in name:
            return np.ones(s.shape, s.dtype)
        if "mean" in name or "bias" in name:
            return np.zeros(s.shape, s.dtype)
        fan_in = max(1, int(np.prod(s.shape[:-1])))
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def layout():
    """JAX s2d/ch_floor model, its seeded variables, and frames."""
    jmodel = JYoloV5(num_classes=NC, variant="n", s2d=True, ch_floor=32)
    variables = _np(seeded_variables(
        lambda k: jmodel.init(k, jnp.zeros((1, *HW, 3)), train=False), seed=3))
    x = np.random.default_rng(1).uniform(0, 1, (2, *HW, 3)).astype(np.float32)
    return jmodel, variables, x


def _port(variables, dtype=torch.float32, **kw):
    model = YoloV5(num_classes=NC, variant="n", dtype=dtype, **kw)
    model.load_state_dict(yolov5_state_dict_from_flax(variables, model))
    return model.eval()


def _heads(model, x):
    with torch.no_grad():
        return [h.numpy() for h in model(torch.from_numpy(x))]


def test_s2d_ch_floor_f32_heads_match_jax(layout):
    jmodel, variables, x = layout
    want = jmodel.apply(variables, x, train=False)
    got = _heads(_port(variables, s2d=True, ch_floor=32), x)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=5e-4, rtol=1e-4)


def test_s2d_matches_jax_on_a_non_square_frame():
    """The block order on a 64 x 96 frame (rows and columns differ), with
    the reference's own seeded weights."""
    jmodel = JYoloV5(num_classes=NC, variant="n", s2d=True, ch_floor=32)
    variables = _np(seeded_variables(
        lambda k: jmodel.init(k, jnp.zeros((1, 64, 96, 3)), train=False), seed=5))
    x = np.random.default_rng(2).uniform(0, 1, (1, 64, 96, 3)).astype(np.float32)
    want = jmodel.apply(variables, x, train=False)
    for g, w in zip(_heads(_port(variables, s2d=True, ch_floor=32), x), want):
        np.testing.assert_allclose(g, np.asarray(w), atol=5e-4, rtol=1e-4)


def test_imported_plain_weights_keep_the_function():
    """An upstream plain-layout checkpoint imported into s2d + ch_floor 32
    gives the plain import's heads (the padded channels stay zero)."""
    tmodel = TYoloV5N(NC).eval()
    _randomize(tmodel, 4)
    state = tmodel.state_dict()
    x = np.random.default_rng(1).uniform(0, 1, (2, *HW, 3)).astype(np.float32)
    plain = YoloV5(num_classes=NC)
    plain.load_state_dict(load_yolov5(state, plain))
    mxu = YoloV5(num_classes=NC, s2d=True, ch_floor=32)
    mxu.load_state_dict(load_yolov5(state, mxu))
    assert tuple(mxu.stem.conv.weight.shape) == (32, 12, 3, 3)
    for p, o in zip(_heads(plain.eval(), x), _heads(mxu.eval(), x)):
        np.testing.assert_allclose(o, p, atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("s2d,ch_floor", [(True, 32), (False, 0)])
def test_bf16_heads_within_twice_the_references_own_bf16_distance(s2d, ch_floor):
    jmodel = JYoloV5(num_classes=NC, variant="n", s2d=s2d, ch_floor=ch_floor)
    variables = _np(seeded_variables(
        lambda k: jmodel.init(k, jnp.zeros((1, *HW, 3)), train=False), seed=3))
    x = np.random.default_rng(1).uniform(0, 1, (2, *HW, 3)).astype(np.float32)
    jbf16 = JYoloV5(num_classes=NC, variant="n", s2d=s2d, ch_floor=ch_floor,
                    dtype=jnp.bfloat16)
    ref = jmodel.apply(variables, x, train=False)
    ref_bf16 = jbf16.apply(variables, x, train=False)
    port = _port(variables, torch.bfloat16, s2d=s2d, ch_floor=ch_floor)
    assert port.stem.conv.weight.dtype == torch.bfloat16
    assert port.detect0.weight.dtype == torch.float32
    got = _heads(port, x)
    for g, w, wb in zip(got, ref, ref_bf16):
        assert g.dtype == np.float32
        jax_dist = float(np.abs(np.asarray(wb, np.float32) - np.asarray(w)).max())
        port_dist = float(np.abs(g - np.asarray(w)).max())
        assert 0 < port_dist <= 2 * jax_dist, (port_dist, jax_dist)


def _map(dets, valid, gts) -> float:
    ev = DetectionEvaluator()
    for d, v, gt in zip(dets, valid, gts):
        ev.add_frame(d, v, gt)
    return float(ev.summary()["map"])


def _gts(dets, valid):
    return [d[v.astype(bool)][:, [0, 1, 2, 3, 5]] for d, v in zip(dets, valid)]


def test_bf16_detections_hold_the_map_budget(layout):
    """The port's bf16 policy on the s2d/ch_floor layout, scored against its
    own f32 detections (the JAX package's tests/test_precision.py form)."""
    variables = flax_init_like(layout[0], seed=3)
    frames = np.random.default_rng(0).integers(0, 255, (4, *HW, 3)).astype(np.float32)
    cfg = tdet2d.Detect2DConfig(**CFG)
    kw = dict(variant="n", num_classes=NC, input_hw=HW, variables=variables, config=cfg,
              device="cpu", s2d=True, ch_floor=32)
    f32, f32_spec, _ = tdet2d.build_yolov5_pipeline(**kw)
    bf16, spec, model = tdet2d.build_yolov5_pipeline(precision="bf16", **kw)
    dets, valid = f32.infer(frames)
    assert int(valid.sum()) > 0, "parity needs live boxes"
    gts = _gts(dets, valid)
    ref_map = _map(dets, valid, gts)
    bdets, bvalid = bf16.infer(frames)
    assert bdets.dtype == np.float32
    assert _map(bdets, bvalid, gts) >= ref_map - MAP_BUDGETS["bf16"]
    # the spec: the policy, and the bytes as stored (every tensor bf16)
    assert spec.extra["precision"] == "bf16" and f32_spec.extra["precision"] == "f32"
    assert model.detect0.weight.dtype == torch.bfloat16
    assert spec.extra["param_bytes"] == f32_spec.extra["param_bytes"] // 2


def test_serve_precision_bf16_is_held_to_the_jax_servers_bf16(tmp_path, monkeypatch):
    """``serve --precision bf16`` over a repository whose version dir holds
    the variables as ``weights.msgpack`` answers FP32 requests with float32
    detections; the JAX server serves the same variables under its bf16
    policy, and the port's detections score within the budget against
    JAX's."""
    variables = flax_init_like(JYoloV5(num_classes=NC, variant="n"), seed=7)
    monkeypatch.chdir(ROOT)
    entry = tmp_path / "tiny"
    (entry / "1").mkdir(parents=True)
    (entry / "config.yaml").write_text(
        "family: yolov5\nmodel:\n  variant: n\n  input_hw: [64, 64]\n"
        "pipeline:\n  class_names_file: data/crop.names\n  conf_thresh: 0.05\n"
        "max_batch_size: 4\n")
    (entry / "1" / "weights.msgpack").write_bytes(flax.serialization.to_bytes(variables))
    args = serve.parser().parse_args(["-r", str(tmp_path), "-a", "127.0.0.1:0", "--device",
                                      "cpu", "--max-workers", "2", "--precision", "bf16"])
    tserver = serve.build_server(args)
    jrepo = JRepository()
    jpipe, jspec, _ = jdet2d.build_yolov5_pipeline(
        jax.random.PRNGKey(0), variant="n", num_classes=NC, input_hw=HW, variables=variables,
        config=jdet2d.Detect2DConfig(**{**CFG, "model_name": "tiny"}), precision="bf16")
    jrepo.register(jspec, jpipe.infer_fn(), precision=jpipe.precision)
    jsrv = jserver.InferenceServer(jrepo, TPUChannel(jrepo), address="127.0.0.1:0",
                                   max_workers=2)
    frames = np.random.default_rng(0).integers(0, 255, (4, *HW, 3)).astype(np.float32)
    tserver.start()
    jsrv.start()
    try:
        out = {}
        for label, srv in (("port", tserver), ("jax", jsrv)):
            chan = JGRPCChannel(f"127.0.0.1:{srv.port}", timeout_s=60, use_shared_memory=False)
            assert chan.get_metadata("tiny").extra["precision"] == "bf16"
            out[label] = chan.do_inference(JInferRequest("tiny", {"images": frames})).outputs
            chan.close()
    finally:
        tserver.stop()
        jsrv.stop()
    port, ref = out["port"], out["jax"]
    assert port["detections"].dtype == np.float32 and port["detections"].shape == (4, 300, 6)
    assert int(ref["valid"].sum()) > 0
    gts = _gts(ref["detections"], ref["valid"])
    ref_map = _map(ref["detections"], ref["valid"], gts)
    assert _map(port["detections"], port["valid"], gts) >= ref_map - MAP_BUDGETS["bf16"]
