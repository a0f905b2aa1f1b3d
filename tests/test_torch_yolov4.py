"""The port's YOLOv4 against the JAX package's, on the CPU, with the flax
weights carried across by ``models/convert.yolov4_state_dict_from_flax``.

Bars: ``mish`` within 1e-6 of JAX's (the formula is JAX's; ``F.mish``
agrees to the same bar and is not used); heads of ``width=0.125`` at 64x64
within 1e-5 of the largest head value; ``decode_flat`` and
``decode_wire`` on the same heads within 1e-6 relative; the tails
(``extract_boxes`` of the pipeline, ``extract_boxes_yolov4`` of the wire
contract) on the same predictions bitwise, fused (the kernel's plain
version against the Pallas kernel in interpret mode) and unfused; whole
pipelines on the same frames with ``valid``, labels and order equal, scores
within 1e-5 and boxes within 1e-5 of each box's largest coordinate. The
full-width model (CSPDarknet53, 80 classes) is held to the JAX tree's
shapes through ``jax.eval_shape``: nothing is initialised.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_client_tpu.models import yolov4 as jv4
from triton_client_tpu.models.layers import mish as jmish
from triton_client_tpu.ops.detect_postprocess import extract_boxes as jextract
from triton_client_tpu.ops.detect_postprocess import extract_boxes_yolov4 as jextract_v4
from triton_client_tpu.pipelines import detect2d as jdet

from triton_client_tpu_torch.models import convert
from triton_client_tpu_torch.models import yolov4 as tv4
from triton_client_tpu_torch.models.layers import ConvBnAct, mish
from triton_client_tpu_torch.ops.detect_postprocess import extract_boxes, extract_boxes_yolov4
from triton_client_tpu_torch.pipelines import detect2d as tdet
from tests.test_torch_server import seeded_variables
from torch_threads import one_torch_thread  # noqa: F401

NC, WIDTH, HW = 3, 0.125, (64, 64)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _carried():
    jmodel = jv4.YoloV4(num_classes=NC, width=WIDTH)
    variables = _numpy(seeded_variables(
        lambda k: jmodel.init(k, jnp.zeros((1, *HW, 3)), train=False), seed=21))
    tmodel = tv4.YoloV4(num_classes=NC, width=WIDTH)
    tmodel.load_state_dict(convert.yolov4_state_dict_from_flax(variables, tmodel))
    return jmodel, variables, tmodel.eval()


@functools.lru_cache(maxsize=None)
def _heads():
    jmodel, variables, tmodel = _carried()
    x = np.random.default_rng(1).uniform(0, 1, (2, *HW, 3)).astype(np.float32)
    return x, [np.asarray(h) for h in jax.jit(functools.partial(jmodel.apply, train=False))(
        variables, x)]


def test_mish_and_leaky_match_jax():
    x = np.concatenate([np.linspace(-30, 30, 4001), [-1e4, 1e4, 0.0]]).astype(np.float32)
    got, want = mish(torch.from_numpy(x)).numpy(), np.asarray(jmish(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(torch.nn.functional.mish(torch.from_numpy(x)).numpy(), want,
                               rtol=1e-6, atol=1e-7)
    layer = ConvBnAct(2, 2, act="leaky", eps=1e-5)
    assert layer.bn.eps == 1e-5 and ConvBnAct(2, 2).bn.eps == 1e-3
    t = torch.from_numpy(x)
    assert torch.equal(layer.act(t), torch.where(t >= 0, t, 0.1 * t))
    with pytest.raises(ValueError, match="unknown activation"):
        ConvBnAct(2, 2, act="gelu")


def test_heads_and_decodes_match_jax():
    jmodel, variables, tmodel = _carried()
    x, want = _heads()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert [tuple(h.shape) for h in got] == [h.shape for h in want] == [
        (2, 8, 8, 3, 5 + NC), (2, 4, 4, 3, 5 + NC), (2, 2, 2, 3, 5 + NC)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    heads = [torch.from_numpy(w) for w in want]
    np.testing.assert_allclose(tmodel.decode_flat(heads).numpy(),
                               np.asarray(jmodel.decode_flat(want)), rtol=1e-6, atol=1e-6)
    boxes, confs = tmodel.decode_wire(heads, HW)
    jboxes, jconfs = jmodel.decode_wire(want, HW)
    assert tuple(boxes.shape) == jboxes.shape == (2, tv4.num_predictions(HW), 1, 4)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(confs.numpy(), np.asarray(jconfs), rtol=1e-6, atol=1e-7)
    assert tv4.num_predictions((512, 512)) == jv4.num_predictions((512, 512)) == 16128


def test_full_width_tree_shapes_equal_jax():
    """The full CSPDarknet53 at 80 classes: every tensor the JAX init tree
    holds (traced, not run), with its shape, and no other."""
    jmodel = jv4.YoloV4(num_classes=80)
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.zeros((1, 512, 512, 3)), train=False),
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    tmodel = tv4.YoloV4(num_classes=80)
    sd = convert.yolov4_state_dict_from_flax(zeros, tmodel)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert n == sum(v.numel() for k, v in tmodel.state_dict().items()
                    if not k.endswith("num_batches_tracked"))


def test_strict_conversion_rejects_missing_and_extra_leaves():
    _, variables, tmodel = _carried()
    missing = copy.deepcopy(variables)
    del missing["params"]["detect1"]["bias"]
    with pytest.raises(KeyError, match="unfilled"):
        convert.yolov4_state_dict_from_flax(missing, tmodel)
    stray = copy.deepcopy(variables)
    stray["params"]["spp2"] = copy.deepcopy(stray["params"]["spp"])
    with pytest.raises(KeyError, match="no such tensor"):
        convert.yolov4_state_dict_from_flax(stray, tmodel)


@pytest.mark.parametrize("fused", [True, False])
def test_pipeline_tail_bitwise_given_the_same_predictions(fused):
    jmodel, _, _ = _carried()
    _, heads = _heads()
    pred = np.asarray(jmodel.decode_flat(heads))
    kw = dict(conf_thresh=0.05, iou_thresh=0.6, max_det=100, max_nms=256)
    want_rows, want_valid = jextract(pred, fused=fused, interpret=True, **kw)
    rows, valid = extract_boxes(torch.from_numpy(pred), fused=fused, **kw)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    assert valid.sum() > 20


@pytest.mark.parametrize("rank", [3, 4])
@pytest.mark.parametrize("fused", [True, False])
def test_extract_boxes_yolov4_bitwise_on_the_wire_contract(fused, rank):
    """The reference's (B, N, 1, 4) boxes and its (B, N, 4) squeeze, the
    best class a box, class-aware: rows and valid equal JAX's bit for bit."""
    jmodel, _, _ = _carried()
    _, heads = _heads()
    boxes, confs = (np.asarray(a) for a in jmodel.decode_wire(heads, HW))
    if rank == 3:
        boxes = boxes[:, :, 0]
    kw = dict(conf_thresh=0.05, iou_thresh=0.6, max_det=100, max_nms=256)
    want_rows, want_valid = jextract_v4(boxes, confs, fused=fused, interpret=True, **kw)
    rows, valid = extract_boxes_yolov4(torch.from_numpy(boxes), torch.from_numpy(confs),
                                       fused=fused, **kw)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    assert valid.sum() > 20


@functools.lru_cache(maxsize=None)
def _pipelines(fused):
    _, variables, _ = _carried()
    kw = dict(num_classes=NC, width=WIDTH, input_hw=HW, variables=variables)
    jcfg = jdet.Detect2DConfig(model_name="yolov4", input_hw=HW, num_classes=NC,
                               conf_thresh=0.05, iou_thresh=0.6, max_nms=256, fused=fused)
    tcfg = dataclasses.replace(tdet.default_config("yolov4", NC, HW), conf_thresh=0.05,
                               max_nms=256, fused=fused)
    jpipe, jspec, _ = jdet.build_yolov4_pipeline(jax.random.PRNGKey(0), config=jcfg, **kw)
    tpipe, tspec, _ = tdet.build_yolov4_pipeline(config=tcfg, device="cpu", **kw)
    return jpipe, jspec, tpipe, tspec


@pytest.mark.parametrize("fused", ["on", "off"])
def test_pipeline_rows_match_jax(fused):
    jpipe, _, tpipe, tspec = _pipelines(fused)
    frames = np.random.default_rng(2).integers(0, 255, (2, *HW, 3), dtype=np.uint8)
    want_dets, want_valid = jpipe.infer(frames)
    dets, valid = tpipe.infer(frames)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_array_equal(dets[..., 5], want_dets[..., 5])
    np.testing.assert_allclose(dets[..., 4], want_dets[..., 4], rtol=0, atol=1e-5)
    scale = np.maximum(np.abs(want_dets[..., :4]).max(-1, keepdims=True), 1.0)
    assert np.all(np.abs(dets[..., :4] - want_dets[..., :4]) <= 1e-5 * scale)
    assert valid.sum() > 20
    assert tspec.extra["fused_stages"] == (["decode_nms"] if fused == "on" else [])


def test_spec_and_defaults_are_jax():
    _, jspec, _, tspec = _pipelines("on")
    assert (tspec.name, tspec.version, tspec.max_batch_size, tspec.platform) == (
        jspec.name, jspec.version, jspec.max_batch_size, "torch")
    assert [(t.name, t.shape, t.dtype, t.layout) for t in tspec.inputs + tspec.outputs] == \
        [(t.name, t.shape, t.dtype, t.layout) for t in jspec.inputs + jspec.outputs]
    assert tspec.extra == jspec.extra
    cfg = tdet.default_config("yolov4")
    assert (cfg.conf_thresh, cfg.iou_thresh, cfg.max_det, cfg.head_style, cfg.input_hw) == (
        0.4, 0.6, 300, "yolo", (512, 512))
