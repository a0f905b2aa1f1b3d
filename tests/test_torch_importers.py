"""The port's weight importers and readers, which need no JAX, against the
JAX package's (``runtime/importers.py``, ``checkpoint.py``,
``onnx_reader.py``, ``flax.serialization``).

- Upstream-named state_dicts, from the torch mirrors of
  tests/test_import_fidelity.py and tests/test_import_fidelity_families.py
  (imported, not edited), go through the port's importer into the port's
  model and through the JAX importer into the JAX model: YOLOv5 plain and
  s2d + ch_floor 32, PointPillars and SECOND-IoU's dense middle. The heads
  agree at atol 5e-4, rtol 1e-4 (the fidelity tests' bar). The s2d stem
  kernel the port derives on (out, cin, 6, 6) is the JAX one transposed,
  bit for bit.
- Shape mismatches that are not stem-local raise, as in JAX.
- ``onnx_reader`` and ``flax_msgpack`` read bytes written here (by hand,
  and by ``flax.serialization.to_bytes``) as the JAX package does.
- A disk repository's version dirs serve ``weights.pt``, ``weights.onnx``
  and ``weights.msgpack`` of the same weights identically, through
  ``scan_disk`` and ``load_pipeline``; ``.pth`` reaches both 3D families.
"""

import pathlib

import flax.serialization
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from triton_client_tpu.models import pointpillars as jpp
from triton_client_tpu.models import second as jsec
from triton_client_tpu.models.yolov5 import YoloV5 as JYoloV5
from triton_client_tpu.ops import voxelize as jvox
from triton_client_tpu.runtime import importers as jimp
from triton_client_tpu.runtime import onnx_reader as jonnx

from triton_client_tpu_torch.config import BF16
from triton_client_tpu_torch.models import pointpillars as tpp
from triton_client_tpu_torch.models import second as tsec
from triton_client_tpu_torch.models.yolov5 import YoloV5
from triton_client_tpu_torch.ops import voxelize as tvox
from triton_client_tpu_torch.runtime import disk_repository as tdr
from triton_client_tpu_torch.runtime import importers as timp
from triton_client_tpu_torch.runtime import onnx_reader as tonnx
from triton_client_tpu_torch.runtime.checkpoint import convert_state_dict, load_torch_checkpoint
from triton_client_tpu_torch.runtime.flax_msgpack import read_flax_msgpack
from tests.test_import_fidelity import TPointPillars, TYoloV5N, _randomize, _state
from tests.test_import_fidelity_families import TSECONDDense, _second_cfg, _voxel_inputs
from tests.test_importers import _ld, _tag, _tensor_raw, _varint
from tests.test_torch_second import port_config
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
HW = (64, 64)
NC = 2
BAR = dict(atol=5e-4, rtol=1e-4)


def _shapes_of(init):
    """The JAX importer's template tree: the init's shapes, nothing run."""
    return jax.eval_shape(init, jax.random.PRNGKey(0))


def _template(jmodel, hw=HW):
    return _shapes_of(lambda k: jmodel.init(k, jnp.zeros((1, *hw, 3)), train=False))


@pytest.fixture(scope="module")
def upstream_yolo():
    tmodel = TYoloV5N(NC).eval()
    _randomize(tmodel, 0)
    return tmodel.state_dict()


# -- YOLOv5 -----------------------------------------------------------------------------


@pytest.mark.parametrize("s2d,ch_floor", [(False, 0), (True, 32)])
def test_yolov5_import_matches_the_jax_import(upstream_yolo, s2d, ch_floor):
    x = np.random.default_rng(0).uniform(0, 1, (2, *HW, 3)).astype(np.float32)
    jmodel = JYoloV5(num_classes=NC, variant="n", s2d=s2d, ch_floor=ch_floor)
    imported = jimp.load_yolov5(_state_np(upstream_yolo), _template(jmodel), strict=True)
    want = jmodel.apply(imported, x, train=False)
    model = YoloV5(num_classes=NC, s2d=s2d, ch_floor=ch_floor)
    model.load_state_dict(timp.load_yolov5(upstream_yolo, model))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BAR)


def _state_np(state):
    return {k: v.numpy() for k, v in state.items() if "num_batches_tracked" not in k}


def test_stem_s2d_kernel_is_the_jax_kernel_transposed():
    natural = np.random.default_rng(1).normal(size=(6, 6, 3, 16)).astype(np.float32)
    want = jimp._stem_s2d_kernel(natural)  # (3, 3, 12, 16)
    got = timp.stem_s2d_kernel(torch.from_numpy(natural.transpose(3, 2, 0, 1).copy()))
    assert tuple(got.shape) == (16, 12, 3, 3)
    np.testing.assert_array_equal(got.numpy(), want.transpose(3, 2, 0, 1))
    with pytest.raises(ValueError, match="6x6 source kernel"):
        timp.stem_s2d_kernel(torch.zeros(16, 3, 5, 5))


def test_ch_floor_padding_is_neutral(upstream_yolo):
    model = YoloV5(num_classes=NC, s2d=True, ch_floor=32)
    sd = timp.load_yolov5(upstream_yolo, model)
    assert torch.equal(sd["stem.bn.weight"][16:], torch.ones(16))
    assert torch.equal(sd["stem.bn.running_var"][16:], torch.ones(16))
    for key in ("stem.bn.bias", "stem.bn.running_mean"):
        assert torch.equal(sd[key][16:], torch.zeros(16))
    assert not sd["stem.conv.weight"][16:].any() and not sd["down2.conv.weight"][:, 16:].any()


def test_yolov5_import_refusals_match_jax(upstream_yolo):
    """A wrong class count, a ch_floor that pads concatenated stages, a
    one-channel stem and a missing tensor raise in both packages."""
    cases = [
        (dict(num_classes=5), ValueError, "does not fit the template"),
        (dict(num_classes=NC, ch_floor=64), ValueError, "does not fit the template"),
    ]
    for kw, exc, match in cases:
        jmodel = JYoloV5(variant="n", **kw)
        with pytest.raises(exc, match=match):
            jimp.load_yolov5(_state_np(upstream_yolo), _template(jmodel), strict=True)
        with pytest.raises(exc, match=match):
            timp.load_yolov5(upstream_yolo, YoloV5(**kw))
    gray = dict(upstream_yolo)
    gray["model.0.conv.weight"] = gray["model.0.conv.weight"][:, :1]
    with pytest.raises(ValueError, match="does not fit the template"):
        timp.load_yolov5(gray, YoloV5(num_classes=NC, s2d=True, ch_floor=32))
    missing = {k: v for k, v in upstream_yolo.items() if k != "model.24.m.1.bias"}
    for load in (lambda: jimp.load_yolov5(_state_np(missing), _template(JYoloV5(NC))),
                 lambda: timp.load_yolov5(missing, YoloV5(NC))):
        with pytest.raises(KeyError, match="missing"):
            load()


def test_yolov5_prefixes_and_a_missing_head_raises(upstream_yolo):
    model = YoloV5(num_classes=NC)
    want = timp.load_yolov5(upstream_yolo, model)
    wrapped = {"model." + k: v for k, v in upstream_yolo.items()}  # model.model.N
    got = timp.load_yolov5(wrapped, model)
    assert all(torch.equal(got[k], want[k]) for k in want)
    partial = {k: v for k, v in upstream_yolo.items() if not k.startswith("model.24.")}
    with pytest.raises(KeyError, match="missing"):
        timp.load_yolov5(partial, model)


def test_convert_state_dict_takes_each_source_once():
    template = {"a.weight": torch.zeros(2), "b.weight": torch.zeros(2)}
    with pytest.raises(KeyError, match="would fill both"):
        convert_state_dict({"x": np.ones(2, np.float32)}, template, lambda k: "x")


# -- PointPillars and SECOND ----------------------------------------------------------

PP_FIELDS = dict(vfe_filters=16, backbone_layers=(1, 1), backbone_strides=(2, 2),
                 backbone_filters=(16, 32), upsample_strides=(1, 2), upsample_filters=(16, 16))
PP_VOXEL = dict(point_cloud_range=(0.0, -3.2, -3.0, 6.4, 3.2, 1.0), voxel_size=(0.2, 0.2, 4.0),
                max_voxels=64, max_points_per_voxel=8)


def _pp_configs():
    return (jpp.PointPillarsConfig(voxel=jvox.VoxelConfig(**PP_VOXEL), **PP_FIELDS),
            tpp.PointPillarsConfig(voxel=tvox.VoxelConfig(**PP_VOXEL), **PP_FIELDS))


def _heads_match(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **BAR)


def test_pointpillars_import_matches_the_jax_import():
    jcfg, tcfg = _pp_configs()
    tmirror = TPointPillars(jcfg).eval()
    _randomize(tmirror, 1)
    voxels, num_points, coords = _voxel_inputs(jcfg, np.random.default_rng(3), use_z=False)
    jmodel = jpp.PointPillars(jcfg)
    variables = _shapes_of(lambda k: jpp.init_pointpillars(k, jcfg)[1])
    imported = jimp.load_pointpillars(_state(tmirror), variables, strict=True)
    want = jmodel.apply(imported, *(jnp.asarray(a)[None] for a in (voxels, num_points, coords)),
                        train=False)
    model = tpp.PointPillars(tcfg)
    model.load_state_dict(timp.load_pointpillars(tmirror.state_dict(), model))
    with torch.no_grad():
        got = model.eval()(*(torch.from_numpy(a)[None] for a in (voxels, num_points, coords)))
    _heads_match(got, want)


def test_second_import_matches_the_jax_import():
    jcfg = _second_cfg()
    tmirror = TSECONDDense(jcfg).eval()
    _randomize(tmirror, 11)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(99)
        for m in tmirror.modules():  # the Conv3d stages and their BN, as the fidelity test
            if isinstance(m, torch.nn.Conv3d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * 0.1)
            elif isinstance(m, torch.nn.BatchNorm3d):
                m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=gen))
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.1)
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=gen))
    voxels, num_points, coords = _voxel_inputs(jcfg, np.random.default_rng(13), use_z=True)
    jmodel = jsec.SECONDIoU(jcfg)
    variables = _shapes_of(lambda k: jsec.init_second(k, jcfg)[1])
    imported = jimp.load_second(_state(tmirror), variables, strict=True)
    want = jmodel.apply(imported, *(jnp.asarray(a)[None] for a in (voxels, num_points, coords)),
                        train=False)
    model = tsec.SECONDIoU(port_config(jcfg))
    sd = timp.load_second(tmirror.state_dict(), model)
    assert torch.equal(sd["middle.conv0.weight"],
                       tmirror.state_dict()["backbone_3d.conv0.0.weight"])
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model.eval()(*(torch.from_numpy(a)[None] for a in (voxels, num_points, coords)))
    _heads_match(got, want)


def test_3d_import_refusals():
    jcfg, tcfg = _pp_configs()
    tmirror = TPointPillars(jcfg).eval()
    wider = tpp.PointPillars(tpp.PointPillarsConfig(voxel=tvox.VoxelConfig(**PP_VOXEL),
                                                    **{**PP_FIELDS, "vfe_filters": 32}))
    with pytest.raises(ValueError, match="cannot map torch tensor"):
        timp.load_pointpillars(tmirror.state_dict(), wider)
    partial = {k: v for k, v in tmirror.state_dict().items() if "dense_head" not in k}
    with pytest.raises(KeyError, match="missing"):
        timp.load_pointpillars(partial, tpp.PointPillars(tcfg))
    scfg = _second_cfg()
    smirror = TSECONDDense(scfg).eval()
    other = port_config(scfg)
    other = tsec.SECONDIoU(type(other)(**{**other.__dict__, "middle_filters": (8, 8)}))
    with pytest.raises(ValueError, match="cannot map torch tensor"):
        timp.load_second(smirror.state_dict(), other)
    with pytest.raises(KeyError, match="unmapped PointPillars key"):
        timp.pointpillars_torch_key("backbone.nothing.weight")


def test_load_torch_checkpoint_unwraps_as_jax(tmp_path):
    state = {"a.weight": torch.arange(6.0).reshape(2, 3), "a.bias": torch.ones(2)}
    for i, wrap in enumerate((lambda s: s, lambda s: {"state_dict": s, "epoch": 3},
                              lambda s: {"model_state": s, "optimizer_state": {}},
                              lambda s: {"model": s, "version": "x"})):
        path = tmp_path / f"w{i}.pth"
        torch.save(wrap(state), path)
        got = load_torch_checkpoint(path)
        want = jimp.load_torch_checkpoint(path)
        assert sorted(got) == sorted(want) == sorted(state)
        for k in state:
            np.testing.assert_array_equal(got[k].numpy(), want[k])


# -- the readers ----------------------------------------------------------------------------


def test_onnx_reader_matches_jax_on_bytes_written_here():
    rng = np.random.default_rng(5)
    w = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
    half = rng.normal(size=(5,)).astype(np.float16)
    bf = rng.normal(size=(2, 3)).astype(np.float32).astype(ml_dtypes.bfloat16)
    typed = _tag(1, 0) + _varint(3) + _tag(2, 0) + _varint(1) + _ld(8, b"/typed::f")
    typed += _ld(4, np.asarray([3.0, -4.5, 5.25], np.float32).tobytes())
    ints = _tag(1, 0) + _varint(3) + _tag(2, 0) + _varint(7) + _ld(8, b"ints")
    ints += _ld(7, b"".join(_varint(v & (2**64 - 1)) for v in (5, -1, 2**40)))
    graph = b"".join(_ld(5, t) for t in (
        _tensor_raw("model.0.conv.weight", w, 1), _tensor_raw("half", half, 10),
        _tensor_raw("bf", bf, 16), typed, ints))
    blob = _ld(7, graph)
    got = tonnx.onnx_to_state_dict(tonnx.read_onnx_initializers(blob))
    want = jonnx.onnx_to_state_dict(jonnx.read_onnx_initializers(blob))
    assert sorted(got) == sorted(want) == sorted(
        ["model.0.conv.weight", "half", "bf", "typed.f", "ints"])
    for k in want:
        if want[k].dtype == ml_dtypes.bfloat16:
            assert got[k].dtype == BF16
            np.testing.assert_array_equal(got[k].view(np.uint16), want[k].view(np.uint16))
        else:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_flax_msgpack_reads_flax_to_bytes(monkeypatch):
    rng = np.random.default_rng(6)
    tree = {"params": {"stem": {"conv": {"kernel": rng.normal(size=(3, 3, 12, 16)).astype(
        np.float32)}, "bn": {"scale": np.ones(16, np.float32)}},
        "half": rng.normal(size=(4,)).astype(ml_dtypes.bfloat16),
        "ints": np.arange(-3, 5, dtype=np.int64), "scalar": np.float32(2.5)},
        "batch_stats": {}, "n": 7, "neg": -300, "big": 2**40, "f": 1.25, "s": "x" * 40,
        "flag": True, "none": None, "lst": [1, 2.0, "three"]}
    for chunk in (None, 64):  # as written, and with arrays cut into chunks
        if chunk:
            monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
        blob = flax.serialization.to_bytes(tree)
        got = read_flax_msgpack(blob)
        want = flax.serialization.msgpack_restore(blob)
        _assert_tree_equal(got, want)
    with pytest.raises(ValueError, match="truncated"):
        read_flax_msgpack(blob[:-3])


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, np.ndarray) and want.dtype == ml_dtypes.bfloat16:
        assert got.dtype == BF16
        np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert list(got) == list(want)
    else:
        assert got == want and type(got) is type(want)


# -- the disk repository ------------------------------------------------------------------

TINY = """family: yolov5
model:
  variant: n
  input_hw: [64, 64]
  s2d: true
  ch_floor: 32
pipeline:
  class_names_file: data/crop.names
  conf_thresh: 0.05
max_batch_size: 4
"""


def _onnx_bytes(state) -> bytes:
    return _ld(7, b"".join(_ld(5, _tensor_raw(k, v.numpy(), 1)) for k, v in state.items()
                           if "num_batches_tracked" not in k))


def test_version_dir_artifacts_serve_identically(tmp_path, monkeypatch, upstream_yolo):
    """weights.pt, weights.onnx and weights.msgpack (the JAX import of the
    same checkpoint, written by flax) of one upstream checkpoint serve the
    same detections, through scan_disk and load_pipeline alike."""
    monkeypatch.chdir(ROOT)
    entry = tmp_path / "crop"
    for v in ("1", "2", "3"):
        (entry / v).mkdir(parents=True)
    (entry / "config.yaml").write_text(TINY)
    torch.save({"model": upstream_yolo}, entry / "1" / "weights.pt")
    (entry / "2" / "weights.onnx").write_bytes(_onnx_bytes(upstream_yolo))
    jmodel = JYoloV5(num_classes=NC, variant="n", s2d=True, ch_floor=32)
    flax_tree = jimp.load_yolov5(_state_np(upstream_yolo), _template(jmodel), strict=True)
    (entry / "3" / "weights.msgpack").write_bytes(flax.serialization.to_bytes(flax_tree))
    repo = tdr.scan_disk(tmp_path, device="cpu")
    assert repo.versions("crop") == ["1", "2", "3"]
    frames = torch.rand((2, *HW, 3)) * 255
    outs = [repo.get("crop", v).infer_fn({"images": frames}) for v in ("1", "2", "3")]
    assert bool(outs[0]["valid"].any())
    for out in outs[1:]:
        for k in ("detections", "valid"):
            assert torch.equal(out[k], outs[0][k])
    pipe, spec = tdr.load_pipeline(entry, version="2", device="cpu")
    assert spec.version == "2"
    assert torch.equal(pipe.infer_fn()({"images": frames})["detections"], outs[0]["detections"])
    _, latest = tdr.load_pipeline(entry, device="cpu")
    assert latest.version == "3"


def test_pth_reaches_both_3d_families(tmp_path):
    jcfg, tcfg = _pp_configs()
    mirror = TPointPillars(jcfg).eval()
    _randomize(mirror, 2)
    torch.save({"model_state": mirror.state_dict()}, tmp_path / "weights.pth")
    model = tpp.PointPillars(tcfg)
    got = tdr.load_weights(tmp_path / "weights.pth", "pointpillars", model)
    want = timp.load_pointpillars(mirror.state_dict(), model)
    assert all(torch.equal(got[k], want[k]) for k in want)
    scfg = _second_cfg()
    smirror = TSECONDDense(scfg).eval()
    _randomize(smirror, 3)
    torch.save({"state_dict": smirror.state_dict()}, tmp_path / "second.pth")
    smodel = tsec.SECONDIoU(port_config(scfg))
    got = tdr.load_weights(tmp_path / "second.pth", "second_iou", smodel)
    want = timp.load_second(smirror.state_dict(), smodel)
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="unrecognized weight artifact"):
        tdr.load_weights(tmp_path / "weights.bin", "second_iou", smodel)


# -- the detectron family and YOLOv4 -------------------------------------------------------


def _flax_small_detectron(head_cls, nc):
    """The JAX package's ResNetFPN ``tiny`` with FPN and head width 32 under
    a head, as tests/test_import_fidelity_families.py builds it."""
    from flax import linen as nn

    from triton_client_tpu.models.retinanet import ResNetFPN

    class Small(nn.Module):
        @nn.compact
        def __call__(self, x, train=False):
            pyr = ResNetFPN("tiny", fpn_width=32, name="backbone")(x, train)
            return head_cls(nc, width=32, name="head")(pyr)

    return Small()


def _port_small_detectron(head):
    from triton_client_tpu_torch.models.retinanet import _Detectron

    return _Detectron(head, "tiny", HW, torch.float32, 32).eval()


def _equal_state(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(want[k])), k


def test_retinanet_import_equals_the_jax_import():
    """detectron2 names (tests/test_import_fidelity_families.TRetinaNetD2)
    through the port's importer equal, tensor for tensor, the JAX import
    carried across by the converter; the imported model's heads equal the
    mirror's own forward at the fidelity bar (the NCHW head flattened in
    the mirror's permute order)."""
    from tests.test_import_fidelity_families import TRetinaNetD2

    from triton_client_tpu.models.retinanet import RetinaNetHead as JHead

    from triton_client_tpu_torch.models import convert
    from triton_client_tpu_torch.models.retinanet import RetinaNetHead

    nc = 4
    mirror = TRetinaNetD2(nc).eval()
    _randomize(mirror, 41)
    jtree = jimp.load_retinanet(_state(mirror), _template(_flax_small_detectron(JHead, nc)),
                                strict=True)
    model = _port_small_detectron(RetinaNetHead(nc, 32, 32))
    got = timp.load_retinanet({f"model.{k}": v for k, v in mirror.state_dict().items()}, model)
    _equal_state(got, convert.retinanet_state_dict_from_flax(_numpy_tree(jtree), model))
    model.load_state_dict(got)
    x = np.random.default_rng(43).uniform(0, 1, (2, *HW, 3)).astype(np.float32)
    with torch.no_grad():
        want = mirror(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        heads = model(torch.from_numpy(x))
    for g, w in zip(heads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **BAR)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fcos_state(nc, seed):
    """RetinaNet's detectron2 names with FCOS's outputs: cls_score at nc a
    location, bbox_pred 4, ctrness 1 (as the fidelity test builds them)."""
    from tests.test_import_fidelity_families import TRetinaNetD2

    mirror = TRetinaNetD2(nc, fpn=32).eval()
    _randomize(mirror, seed)
    state = _state(mirror)
    gen = torch.Generator().manual_seed(seed + 1)
    for name, cout in (("cls_score", nc), ("bbox_pred", 4), ("ctrness", 1)):
        state[f"head.{name}.weight"] = torch.randn(cout, 32, 3, 3, generator=gen).numpy() * 0.1
        state[f"head.{name}.bias"] = torch.randn(cout, generator=gen).numpy() * 0.1
    return state


@pytest.mark.parametrize("scales", ["stock", "adelaidet"])
def test_fcos_import_equals_jax_and_missing_scales_are_one(scales):
    """Stock detectron2 FCOS has no ``head.scales.{l}.scale``: both importers
    fill 1.0; AdelaiDet's scales land on ``head.scale{l}``."""
    from triton_client_tpu.models.retinanet import FCOSHead as JHead

    from triton_client_tpu_torch.models import convert
    from triton_client_tpu_torch.models.retinanet import FCOSHead

    nc = 3
    state = _fcos_state(nc, 51)
    if scales == "adelaidet":
        for level in range(5):
            state[f"head.scales.{level}.scale"] = np.array([0.5 + level], np.float32)
    jtree = jimp.load_fcos(state, _template(_flax_small_detectron(JHead, nc)), strict=True)
    model = _port_small_detectron(FCOSHead(nc, 32, 32))
    got = timp.load_fcos(state, model)
    _equal_state(got, convert.fcos_state_dict_from_flax(_numpy_tree(jtree), model))
    want = [1.0] * 5 if scales == "stock" else [0.5 + level for level in range(5)]
    assert [float(got[f"head.scale{level}.weight"]) for level in range(5)] == want
    del state["head.ctrness.bias"]
    with pytest.raises(KeyError, match="missing"):
        timp.load_fcos(state, model)


def _yolov4_mirror(nc, width, seed):
    from tests.test_import_fidelity_families import TYoloV4

    mirror = TYoloV4(nc, width).eval()
    _randomize(mirror, seed)
    return mirror


def test_yolov4_import_equals_the_jax_import():
    """pytorch-YOLOv4 names (tests/test_import_fidelity_families.TYoloV4)
    through the port's importer equal the JAX import carried across, the
    SPP merge conv's input blocks reversed on axis 1 (upstream's [p13, p9,
    p5, x] onto [x, p5, p9, p13]); the imported heads equal the mirror's
    forward at the fidelity test's relative bar (mish is unbounded, and
    seeded activations reach O(1e3))."""
    from triton_client_tpu.models.yolov4 import YoloV4 as JYoloV4

    from triton_client_tpu_torch.models import convert
    from triton_client_tpu_torch.models.yolov4 import YoloV4

    nc, width = 3, 0.25
    mirror = _yolov4_mirror(nc, width, 61)
    jtree = jimp.load_yolov4(_state(mirror), _template(JYoloV4(num_classes=nc, width=width)),
                             strict=True)
    model = YoloV4(num_classes=nc, width=width).eval()
    got = timp.load_yolov4(mirror.state_dict(), model)
    _equal_state(got, convert.yolov4_state_dict_from_flax(_numpy_tree(jtree), model))
    upstream = mirror.state_dict()["neek.conv4.conv.0.weight"]
    blocks = upstream.shape[1] // 4
    merge = got["spp.merge.conv.weight"]
    for i in range(4):  # port block i is upstream block 3 - i
        assert torch.equal(merge[:, i * blocks:(i + 1) * blocks],
                           upstream[:, (3 - i) * blocks:(4 - i) * blocks])
    assert not torch.equal(merge, upstream)
    model.load_state_dict(got)
    x = np.random.default_rng(63).uniform(0, 1, (1, *HW, 3)).astype(np.float32)
    with torch.no_grad():
        want = mirror(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        heads = model(torch.from_numpy(x))
    for h, w in zip(heads, want):
        b, ch, hh, ww = w.shape
        ref = w.numpy().reshape(b, 3, ch // 3, hh, ww).transpose(0, 3, 4, 1, 2)
        np.testing.assert_allclose(h.numpy(), ref, atol=5e-2, rtol=1e-3)


def test_yolov4_import_accepts_neck_and_refuses_a_wrong_width():
    from triton_client_tpu_torch.models.yolov4 import YoloV4

    mirror = _yolov4_mirror(2, 0.25, 71)
    state = {("neck." + k[len("neek."):] if k.startswith("neek.") else k): v
             for k, v in mirror.state_dict().items()}
    assert any(k.startswith("neck.") for k in state)
    model = YoloV4(num_classes=2, width=0.25)
    _equal_state(timp.load_yolov4(state, model), timp.load_yolov4(mirror.state_dict(), model))
    with pytest.raises(ValueError, match=r"yolov4 import: stem\.conv\.weight .* does not fit"):
        timp.load_yolov4(mirror.state_dict(), YoloV4(num_classes=2, width=0.5))
    with pytest.raises(ValueError, match="detect0.weight .* does not fit"):
        timp.load_yolov4(mirror.state_dict(), YoloV4(num_classes=5, width=0.25))


TINY_V4 = """family: yolov4
model:
  width: 0.25
  input_hw: [64, 64]
pipeline:
  class_names_file: data/crop.names
  conf_thresh: 0.05
"""
TINY_RETINA = """family: retinanet
model:
  depth: tiny
  input_hw: [64, 64]
pipeline:
  class_names_file: data/crop.names
"""


def test_new_families_version_dirs_serve_identically(tmp_path, monkeypatch):
    """A YOLOv4 entry's weights.pth, weights.onnx and weights.msgpack (the
    JAX import of the same checkpoint, written by flax) serve the same
    detections; a RetinaNet entry's detectron2 ``.pt`` serves as
    ``load_pipeline`` gives it in-process."""
    from tests.test_import_fidelity_families import TRetinaNetD2

    from triton_client_tpu.models.yolov4 import YoloV4 as JYoloV4

    monkeypatch.chdir(ROOT)
    v4 = tmp_path / "v4"
    for v in ("1", "2", "3"):
        (v4 / v).mkdir(parents=True)
    (v4 / "config.yaml").write_text(TINY_V4)
    mirror = _yolov4_mirror(NC, 0.25, 81)
    state = {k: v for k, v in mirror.state_dict().items() if "num_batches_tracked" not in k}
    torch.save(state, v4 / "1" / "weights.pth")
    (v4 / "2" / "weights.onnx").write_bytes(_onnx_bytes(state))
    jtree = jimp.load_yolov4(_state(mirror), _template(JYoloV4(num_classes=NC, width=0.25)),
                             strict=True)
    (v4 / "3" / "weights.msgpack").write_bytes(flax.serialization.to_bytes(jtree))
    retina = tmp_path / "retina"
    (retina / "1").mkdir(parents=True)
    (retina / "config.yaml").write_text(TINY_RETINA)
    rmirror = TRetinaNetD2(NC, fpn=256).eval()
    _randomize(rmirror, 82)
    torch.save({"model": {f"model.{k}": v for k, v in rmirror.state_dict().items()}},
               retina / "1" / "weights.pt")
    repo = tdr.scan_disk(tmp_path, device="cpu")
    frames = torch.rand((2, *HW, 3)) * 255
    outs = [repo.get("v4", v).infer_fn({"images": frames}) for v in ("1", "2", "3")]
    assert bool(outs[0]["valid"].any())
    for out in outs[1:]:
        for k in ("detections", "valid"):
            assert torch.equal(out[k], outs[0][k])
    served = repo.get("retina").infer_fn({"images": frames})
    pipe, _ = tdr.load_pipeline(retina, device="cpu")
    direct = pipe.infer_fn()({"images": frames})
    assert int(served["dims"].sum()) > 0
    for k in ("boxes", "scores", "classes", "dims"):
        assert torch.equal(served[k], direct[k])
