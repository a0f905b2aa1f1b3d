"""The port's detectron family (RetinaNet, FCOS) against the JAX package's,
on the CPU, with the flax weights carried across by
``models/convert.retinanet_state_dict_from_flax`` /
``fcos_state_dict_from_flax``.

Bars:

- anchor and location tables: bitwise (both are the same numpy code);
- ``decode_deltas`` (at the clamp too) and ``fcos_decode``: within 1e-6
  of each box's largest coordinate (XLA's ``exp`` and PyTorch's differ by
  an ulp; where x1 = cx - w/2 nearly cancels, an ulp of ``w`` is most of
  the coordinate itself, never more than an ulp of the box);
- forwards of the ``tiny`` depth: heads within 1e-5 of the largest head
  value (the two frameworks sum convolutions in other orders), at a 2x
  size and at an odd one, where ``_upsample2`` must pick JAX's rows;
- the tail on the same decoded boxes and scores: rows and ``valid``
  bitwise, fused (the kernel's plain version against the Pallas kernel in
  interpret mode) and unfused, multi-label and best-class;
- whole pipelines on the same uint8 frames (raw pixels, resized in):
  ``valid``, labels and the row order equal, scores within 2e-5 and boxes
  within 5e-5 of each box's largest coordinate: the forward's difference
  (1e-5 of the largest head value, which raw pixels make large) reaches a
  box through ``exp(dw)``.

The JAX variables are a seeded fill of the flax tree's shapes
(``tests/test_torch_server.seeded_variables``): the init costs more than
the rest of the file.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_client_tpu.models import retinanet as jret
from triton_client_tpu.ops import anchor_decode as janc
from triton_client_tpu.ops.detect_postprocess import extract_boxes_scored as jextract_scored
from triton_client_tpu.pipelines import detect2d as jdet

from triton_client_tpu_torch.models import convert
from triton_client_tpu_torch.models import retinanet as tret
from triton_client_tpu_torch.ops import anchor_decode as tanc
from triton_client_tpu_torch.ops.detect_postprocess import extract_boxes_scored
from triton_client_tpu_torch.pipelines import detect2d as tdet
from tests.test_torch_server import seeded_variables
from torch_threads import one_torch_thread  # noqa: F401

NC = 3
FAMILIES = {
    "retinanet": (jret.RetinaNet, tret.RetinaNet, convert.retinanet_state_dict_from_flax),
    "fcos": (jret.FCOS, tret.FCOS, convert.fcos_state_dict_from_flax),
}
SIZES = {"even": (64, 64), "odd": (72, 100)}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _carry(family, size):
    jcls, tcls, from_flax = FAMILIES[family]
    hw = SIZES[size]
    jmodel = jcls(num_classes=NC, depth="tiny", input_hw=hw)
    variables = _numpy(seeded_variables(
        lambda k: jmodel.init(k, jnp.zeros((1, *hw, 3)), train=False), seed=11))
    tmodel = tcls(num_classes=NC, depth="tiny", input_hw=hw)
    tmodel.load_state_dict(from_flax(variables, tmodel))
    return family, hw, jmodel, variables, tmodel.eval()


@pytest.fixture(params=[(f, s) for f in FAMILIES for s in SIZES], ids=lambda p: f"{p[0]}-{p[1]}")
def carried(request):
    return _carry(*request.param)


# -- anchors and decode --------------------------------------------------------------


@pytest.mark.parametrize("hw", [(64, 64), (72, 100), (96, 128), (480, 640), (500, 500)])
def test_anchor_and_location_tables_are_bitwise_jax(hw):
    for size in janc.RETINA_SIZES:
        assert np.array_equal(tanc.cell_anchors(size), janc.cell_anchors(size))
    assert np.array_equal(tanc.level_anchors((3, 5), 8, tanc.cell_anchors(32.0)),
                          janc.level_anchors((3, 5), 8, janc.cell_anchors(32.0)))
    got, want = tanc.pyramid_anchors(hw), janc.pyramid_anchors(hw)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    got, want = tanc.fcos_locations(hw), janc.fcos_locations(hw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert tret.num_locations(hw, 9) == jret.num_locations(hw, 9) == len(tanc.pyramid_anchors(hw))


def _within_box_scale(got, want, rel):
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= rel * scale), float(np.max(np.abs(got - want) / scale))


@pytest.mark.parametrize("spread", ["normal", "clamped"])
def test_decode_deltas_within_1e6_of_the_box(spread):
    """At ``clamped`` a quarter of the dw/dh exceed log(1000/16) (boxes tens of
    thousands of pixels wide on P7's anchors): both clamp from above only."""
    anchors = janc.pyramid_anchors((480, 640))
    rng = np.random.default_rng(3)
    deltas = rng.normal(0.0, 1.0 if spread == "normal" else 6.0,
                        (2, len(anchors), 4)).astype(np.float32)
    want = np.asarray(janc.decode_deltas(jnp.asarray(anchors), jnp.asarray(deltas)))
    got = tanc.decode_deltas(torch.from_numpy(anchors), torch.from_numpy(deltas)).numpy()
    _within_box_scale(got, want, 1e-6)
    if spread == "clamped":
        assert (deltas[..., 2:] > tanc.SCALE_CLAMP).mean() > 0.2
        width = got[..., 2] - got[..., 0]
        assert width.max() > 1e4 and np.isfinite(got).all()
        # dw far past the clamp decodes as the clamp itself
        big = deltas.copy()
        big[..., 2:] = 50.0
        capped = deltas.copy()
        capped[..., 2:] = tanc.SCALE_CLAMP
        assert torch.equal(tanc.decode_deltas(torch.from_numpy(anchors), torch.from_numpy(big)),
                           tanc.decode_deltas(torch.from_numpy(anchors), torch.from_numpy(capped)))


def test_fcos_decode_within_1e6_of_the_box():
    locations = janc.fcos_locations((72, 100))
    ltrb = np.random.default_rng(4).uniform(0, 300, (2, len(locations), 4)).astype(np.float32)
    want = np.asarray(janc.fcos_decode(jnp.asarray(locations), jnp.asarray(ltrb)))
    got = tanc.fcos_decode(torch.from_numpy(locations), torch.from_numpy(ltrb)).numpy()
    _within_box_scale(got, want, 1e-6)


def test_upsample2_picks_jax_rows_at_odd_sizes():
    """``jax.image.resize(..., "nearest")`` (half-pixel centres) is
    ``nearest-exact``; plain ``nearest`` picks other rows at 32 -> 63."""
    x = np.random.default_rng(5).normal(size=(1, 5, 32, 16)).astype(np.float32)
    like = torch.zeros((1, 5, 63, 31))
    want = np.asarray(jret._upsample2(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                      jnp.zeros((1, 63, 31, 5))))
    got = tret._upsample2(torch.from_numpy(x), like).numpy().transpose(0, 2, 3, 1)
    assert np.array_equal(got, want)
    plain = torch.nn.functional.interpolate(torch.from_numpy(x), size=(63, 31), mode="nearest")
    assert not np.array_equal(plain.numpy().transpose(0, 2, 3, 1), want)


# -- forwards ------------------------------------------------------------------------


def test_heads_and_decode_match_jax(carried):
    family, hw, jmodel, variables, tmodel = carried
    x = np.random.default_rng(6).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    want = jmodel.apply(variables, x, train=False)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert len(got) == len(want) == (2 if family == "retinanet" else 3)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    # decode on the same heads
    dec = tmodel.decode(tuple(torch.from_numpy(np.array(w)) for w in want))
    jdec = jmodel.decode(want)
    _within_box_scale(dec[0].numpy(), np.asarray(jdec[0]), 1e-6)
    np.testing.assert_allclose(dec[1].numpy(), np.asarray(jdec[1]), rtol=1e-6, atol=1e-7)
    n = jret.num_locations(hw, 9 if family == "retinanet" else 1)
    assert tuple(dec[0].shape) == (2, n, 4) and tuple(dec[1].shape) == (2, n, NC)


def test_strict_conversion_rejects_missing_and_extra_leaves(carried):
    family, _, _, variables, tmodel = carried
    from_flax = FAMILIES[family][2]
    missing = copy.deepcopy(variables)
    del missing["params"]["head"]["cls_out"]["bias"]
    with pytest.raises(KeyError, match="unfilled"):
        from_flax(missing, tmodel)
    extra = copy.deepcopy(variables)
    extra["params"]["backbone"]["stem"]["bn"]["offset"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unexpected flax leaf"):
        from_flax(extra, tmodel)
    if family == "fcos":  # the per-level scales are leaves of the head
        wrong = copy.deepcopy(variables)
        wrong["params"]["head"]["scale2"] = np.full(2, 3.0, np.float32)
        with pytest.raises(ValueError, match="scale2"):
            from_flax(wrong, tmodel)


def test_dtype_bf16_keeps_the_heads_float32():
    model = tret.FCOS(num_classes=NC, depth="tiny", input_hw=(64, 64), dtype=torch.bfloat16)
    assert model.backbone.stem.conv.weight.dtype == torch.bfloat16
    assert model.head.cls0.weight.dtype == torch.bfloat16
    assert all(c.weight.dtype == torch.float32 for c in model.head.out_convs())
    assert model.locations.dtype == torch.float32 and "locations" not in model.state_dict()
    with torch.no_grad():
        out = model(torch.rand((1, 64, 64, 3)))
    assert all(o.dtype == torch.float32 for o in out)


# -- the tail and the pipelines --------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("multi_label", [True, False])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_scored_tail_bitwise_given_the_same_boxes_and_scores(family, fused, multi_label):
    _, hw, jmodel, variables, _ = _carry(family, "even")
    x = np.random.default_rng(7).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    boxes, scores = (np.array(a) for a in jmodel.decode(jmodel.apply(variables, x, train=False)))
    kw = dict(conf_thresh=0.05, iou_thresh=0.5, max_det=100, max_nms=256,
              multi_label=multi_label)
    want_rows, want_valid = jextract_scored(boxes, scores, fused=fused, interpret=True, **kw)
    rows, valid = extract_boxes_scored(torch.from_numpy(boxes), torch.from_numpy(scores),
                                       fused=fused, **kw)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    assert valid.sum() > 20
    if multi_label:  # a box may be kept under two classes
        assert len(np.unique(rows.numpy()[valid.numpy()][:, 5])) > 1


@functools.lru_cache(maxsize=None)
def _pipelines(family, fused, hw=(64, 64)):
    jbuild = {"retinanet": jdet.build_retinanet_pipeline, "fcos": jdet.build_fcos_pipeline}
    tbuild = {"retinanet": tdet.build_retinanet_pipeline, "fcos": tdet.build_fcos_pipeline}
    jcls = FAMILIES[family][0]
    jmodel = jcls(num_classes=NC, depth="tiny", input_hw=hw)
    variables = _numpy(seeded_variables(
        lambda k: jmodel.init(k, jnp.zeros((1, *hw, 3)), train=False), seed=12))
    kw = dict(num_classes=NC, depth="tiny", input_hw=hw, variables=variables)
    jcfg = dataclass_replace(jdet_default(family, hw), fused=fused, max_nms=256)
    tcfg = tdet.default_config(family, NC, hw)
    tcfg = dataclass_replace(tcfg, fused=fused, max_nms=256)
    jpipe, jspec, _ = jbuild[family](jax.random.PRNGKey(0), config=jcfg, **kw)
    tpipe, tspec, _ = tbuild[family](config=tcfg, device="cpu", **kw)
    return jpipe, jspec, tpipe, tspec


def dataclass_replace(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, **kw)


def jdet_default(family, hw):
    """The JAX builder's default config (it has no function for it)."""
    return jdet.Detect2DConfig(
        model_name=family, input_hw=hw, num_classes=NC, conf_thresh=0.05,
        iou_thresh=0.5 if family == "retinanet" else 0.6, max_det=100, scaling="none",
        multi_label=True, head_style="scored")


@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_pipeline_rows_match_jax(family, fused):
    """uint8 frames of another size than the model's (resized in, rescaled
    out): valid, labels and order equal; scores within 2e-5, boxes within
    5e-5 of the box (the module docstring). The detectron contract of ``infer_fn``
    (classes int64, dims int32) and ``device_fn`` (classes int32, as
    JAX's) over the same rows."""
    jpipe, jspec, tpipe, tspec = _pipelines(family, fused)
    frames = np.random.default_rng(8).integers(0, 255, (2, 48, 80, 3), dtype=np.uint8)
    want_dets, want_valid = jpipe.infer(frames)
    dets, valid = tpipe.infer(frames)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_array_equal(dets[..., 5], want_dets[..., 5])
    np.testing.assert_allclose(dets[..., 4], want_dets[..., 4], rtol=0, atol=2e-5)
    scale = np.maximum(np.abs(want_dets[..., :4]).max(-1, keepdims=True), 1.0)
    assert np.all(np.abs(dets[..., :4] - want_dets[..., :4]) <= 5e-5 * scale)
    assert valid.sum() > 20
    out = tpipe.infer_fn()({"images": torch.from_numpy(frames)})
    jout = jpipe.infer_fn()({"images": frames})
    assert [k for k in out] == [k for k in jout] == ["boxes", "scores", "classes", "dims"]
    assert out["classes"].dtype == torch.int64 and out["dims"].dtype == torch.int32
    assert np.array_equal(out["dims"].numpy(), jout["dims"]) and jout["dims"].dtype == np.int32
    assert np.array_equal(out["classes"].numpy(), jout["classes"])
    assert tdet.detectron_infer_fn(tpipe)({"images": torch.from_numpy(frames)}).keys() == out.keys()
    dev = tpipe.device_fn()({"images": torch.from_numpy(frames)})
    assert dev["classes"].dtype == torch.int32
    assert torch.equal(dev["classes"].long(), out["classes"])
    assert tspec.extra["fused_stages"] == (["decode_nms"] if fused == "on" else [])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_spec_is_the_jax_detectron_spec(family):
    _, jspec, _, tspec = _pipelines(family, "on")
    assert (tspec.name, tspec.version, tspec.max_batch_size, tspec.platform) == (
        jspec.name, jspec.version, jspec.max_batch_size, "torch")
    assert [(t.name, t.shape, t.dtype, t.layout) for t in tspec.inputs + tspec.outputs] == \
        [(t.name, t.shape, t.dtype, t.layout) for t in jspec.inputs + jspec.outputs]
    assert set(tspec.extra) == set(jspec.extra)
    for key, value in tspec.extra.items():
        if key != "param_bytes":
            assert jspec.extra[key] == value, key
    assert tspec.extra["param_bytes"] == jspec.extra["param_bytes"]


def test_seeded_weights_sit_at_the_focal_loss_prior():
    """Seeded class outputs start at sigmoid 0.01, as flax's bias init."""
    for build in (tdet.build_retinanet_pipeline, tdet.build_fcos_pipeline):
        _, _, model = build(num_classes=NC, depth="tiny", input_hw=(64, 64), device="cpu")
        bias = model.head.cls_out.bias
        assert torch.allclose(torch.sigmoid(bias), torch.full_like(bias, 0.01))
    assert tdet.default_config("retinanet").head_style == "scored"
