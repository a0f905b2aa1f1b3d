"""The port's precision policies (``runtime/precision.py``) against the JAX
package's, on the same inputs: ``parse``, ``resolve_policy``,
``cast_params``, ``boundary``, ``wire_cast``, ``quantize_channelwise``,
``realize``, ``tree_bytes``, ``calibrated`` and ``ingest``; the host
bfloat16 words byte-equal to ``ml_dtypes`` casts (NaN payloads aside); the
codec's BF16 round trip; the staged channel narrowing a bf16 model's FP32
frames and a calibrated int8 model's to int8; int8 storage on modules
(``apply_cast_params``: ``q`` and ``scale`` behind a parametrization, equal
to JAX's per flax leaf on YOLOv5n in both layouts, the int8w heads within
the float32 bar of JAX's int8w heads); and YOLOv5n's detections under
``int8w`` and calibrated ``int8`` holding ``MAP_BUDGETS`` against f32."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from triton_client_tpu.runtime import precision as jprec

from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.channel.kserve import codec
from triton_client_tpu_torch.config import BF16, ModelSpec, TensorSpec
from triton_client_tpu_torch.runtime import precision as tprec
from triton_client_tpu_torch.runtime.repository import ModelRepository
from torch_threads import one_torch_thread  # noqa: F401

TORCH_OF = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _ml_words(x: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore"):  # NaN inputs
        return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).view(np.uint16)


def _words(x) -> np.ndarray:
    return np.asarray(x).view(np.uint16)


# -- parse and resolve ----------------------------------------------------------


@pytest.mark.parametrize("value", [None, "", "f32", "bf16", "int8w", "int8"])
def test_parse_agrees_with_jax(value):
    got, want = tprec.PrecisionPolicy.parse(value), jprec.PrecisionPolicy.parse(value)
    assert got.name == want.name
    assert TORCH_OF[want.compute_dtype] == got.compute_dtype
    assert got.map_budget == want.map_budget
    assert tprec.PrecisionPolicy.parse(got) is got


def test_tables_agree_with_jax():
    assert tprec.POLICIES == jprec.POLICIES
    assert tprec.MAP_BUDGETS == jprec.MAP_BUDGETS
    assert tprec.KEEP_F32_2D == jprec.KEEP_F32_2D
    assert tprec.KEEP_F32_3D == jprec.KEEP_F32_3D


def test_unknown_policy_raises_as_in_jax():
    for parse in (jprec.PrecisionPolicy.parse, tprec.PrecisionPolicy.parse):
        with pytest.raises(ValueError, match="unknown precision policy 'fp8'"):
            parse("fp8")


@pytest.mark.parametrize("name", ["int8w", "int8"])
def test_int8_policies_parse_with_the_jax_properties(name):
    got, want = tprec.PrecisionPolicy.parse(name), jprec.PrecisionPolicy.parse(name)
    for attr in ("quantize_weights", "quantize_acts", "wire_ingest_needed", "map_budget"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.compute_dtype == torch.float32 and got.act_scales == () == want.act_scales
    assert got.wire_dtype("images") == torch.float32  # no scales: the float32 wire


@pytest.mark.parametrize("precision", [None, "f32", "bf16", "int8w", "int8"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_resolve_policy_agrees_with_jax(precision, dtype):
    jpol, jdtype = jprec.resolve_policy(precision, dtype)
    tpol, tdtype = tprec.resolve_policy(precision, TORCH_OF[dtype])
    assert tpol.name == jpol.name and tdtype == TORCH_OF[jdtype]


@pytest.mark.parametrize("name", ["fp32", "float32", "bf16", "bfloat16"])
def test_compute_dtype_names(name):
    from triton_client_tpu.config import parse_compute_dtype

    assert tprec.parse_compute_dtype(name) == TORCH_OF[parse_compute_dtype(name)]


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="unknown model dtype 'fp16'"):
        tprec.parse_compute_dtype("fp16")


# -- the words ------------------------------------------------------------------------

SPECIALS = np.array(
    [0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 3.0e38, -3.4e38, np.finfo(np.float32).max,
     np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny, 1e-40, -1e-40, 1e-45, 9.2e-41,
     np.finfo(np.float32).smallest_subnormal],
    np.float32,
)


def _midpoints(rng, n=256):
    """float32 bit patterns exactly halfway between two bfloat16 values,
    with even and odd upper halves (ties to even both ways), normal and
    subnormal, and one ulp either side of the midpoint."""
    upper = rng.integers(0, 0x7F7F, n, dtype=np.uint32)
    upper[: n // 4] = rng.integers(0, 0x007F, n // 4)  # subnormal range
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    base = sign | (upper << 16) | 0x8000
    return np.concatenate([base, base - 1, base + 1]).view(np.float32)


def test_words_are_byte_equal_to_ml_dtypes():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        SPECIALS,
        _midpoints(rng),
        rng.normal(0, 1, 4096).astype(np.float32),
        (rng.normal(0, 1, 1024) * 10.0 ** rng.integers(-44, 38, 1024)).astype(np.float32),
        rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32).view(np.float32),
    ])
    finite_or_inf = ~np.isnan(x)
    words = tprec.to_bf16_words(x)
    assert words.dtype == BF16
    np.testing.assert_array_equal(_words(words)[finite_or_inf], _ml_words(x)[finite_or_inf])
    # a NaN stays a NaN (its payload is PyTorch's, not ml_dtypes')
    back = tprec.bf16_words_to_f32(words)
    assert np.isnan(back[~finite_or_inf]).all() and (~finite_or_inf).any()
    # widening is exact, and the tensor view reads the same values
    np.testing.assert_array_equal(back[finite_or_inf], x[finite_or_inf].astype(
        ml_dtypes.bfloat16).astype(np.float32))
    t = tprec.host_tensor(words)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy()[finite_or_inf], back[finite_or_inf])
    np.testing.assert_array_equal(_words(tprec.host_array(t)), _words(words))


def test_nan_stays_nan():
    x = np.array([np.nan, -np.nan, np.float32(np.nan) * 0], np.float32)
    x = np.concatenate([x, np.array([0x7F800001, 0xFFFFFFFF, 0x7FC00000], np.uint32).view(
        np.float32)])
    assert np.isnan(tprec.bf16_words_to_f32(tprec.to_bf16_words(x))).all()


def test_words_survive_the_serving_paths_numpy_ops():
    w = tprec.to_bf16_words(np.arange(12, dtype=np.float32).reshape(3, 4))
    for op in (lambda a: np.concatenate([a, a]), lambda a: np.stack([a, a]),
               lambda a: np.require(a[:, ::2], requirements="C"), np.copy,
               lambda a: np.frombuffer(a.tobytes(), BF16).reshape(a.shape)):
        assert op(w).dtype == BF16
    with pytest.raises(TypeError):
        w + 1  # no arithmetic on the words


def test_channel_casts_words_down_to_a_narrower_spec_exactly():
    """A BF16 wire input against an FP16 spec widens exactly, then casts
    (numpy would cast the words as integers); against FP32 it passes."""
    from triton_client_tpu_torch.channel.staged import cast_wire_input
    from triton_client_tpu_torch.runtime.repository import RegisteredModel

    x = np.array([1.5, -2.25, 3e4], np.float32)
    w = tprec.to_bf16_words(x)
    for dtype, want in (("FP16", x.astype(ml_dtypes.bfloat16).astype(np.float16)), ("FP32", w)):
        spec = ModelSpec(name="m", inputs=(TensorSpec("x", (-1,), dtype),))
        got = cast_wire_input(RegisteredModel(spec, None), "x", w)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


# -- cast_params, boundary, wire_cast ---------------------------------------------------


def _tree(rng):
    return {"params": {"conv": {"kernel": rng.normal(0, 1, (3, 3, 4, 8)).astype(np.float32),
                                "bias": rng.normal(0, 1, (8,)).astype(np.float32)},
                       "step": np.arange(4, dtype=np.int32)},
            "batch_stats": {"bn": {"mean": rng.normal(0, 1, (8,)).astype(np.float32),
                                   "var": rng.uniform(0.5, 2, (8,)).astype(np.float32)}}}


@pytest.mark.parametrize("name", ["f32", "bf16", "int8w", "int8"])
def test_cast_params_agrees_with_jax(name):
    tree = _tree(np.random.default_rng(1))
    want = jprec.PrecisionPolicy.parse(name).cast_params(tree)
    got = tprec.PrecisionPolicy.parse(name).cast_params(tree)
    flat_w = dict(_flatten(want))
    assert tprec.tree_bytes(got) == jprec.tree_bytes(want)
    for path, leaf in _flatten(got):
        if isinstance(flat_w[path], jprec.QuantizedParam):
            assert isinstance(leaf, tprec.QuantizedParam)
            for g, w in ((leaf.q, flat_w[path].q), (leaf.scale, flat_w[path].scale)):
                assert g.dtype == np.asarray(w).dtype and g.shape == np.asarray(w).shape
                np.testing.assert_array_equal(g, np.asarray(w))
            continue
        ref = np.asarray(flat_w[path])
        if ref.dtype == jnp.bfloat16:
            assert leaf.dtype == BF16
            np.testing.assert_array_equal(_words(leaf), ref.view(np.uint16))
        else:
            assert leaf.dtype == ref.dtype
            np.testing.assert_array_equal(leaf, ref)
    # on tensors: every float leaf to torch.bfloat16, the same words
    ttree = {"w": torch.from_numpy(tree["params"]["conv"]["kernel"]),
             "n": torch.arange(3)}
    cast = tprec.PrecisionPolicy.parse(name).cast_params(ttree)
    assert cast["n"].dtype == torch.int64
    if name in ("int8w", "int8"):
        qp = cast["w"]  # a tensor leaf quantizes into tensors, over its last axis
        jq = flat_w[("params", "conv", "kernel")]
        assert qp.q.dtype == torch.int8 and qp.scale.dtype == torch.float32
        np.testing.assert_array_equal(qp.q.numpy(), np.asarray(jq.q))
        np.testing.assert_array_equal(qp.scale.numpy(), np.asarray(jq.scale))
        assert tprec.tree_bytes(cast) == qp.nbytes + 3 * 8
        return
    if name == "bf16":
        assert cast["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _words(tprec.host_array(cast["w"])),
            np.asarray(flat_w[("params", "conv", "kernel")]).view(np.uint16))
    assert tprec.tree_bytes(cast) == sum(t.numel() * t.element_size() for t in cast.values())


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, (*prefix, k))
        else:
            yield (*prefix, k), v


@pytest.mark.parametrize("name", ["f32", "bf16", "int8w"])
def test_boundary_agrees_with_jax(name):
    rng = np.random.default_rng(2)
    heads = [rng.normal(0, 4, (2, 4, 4, 3, 7)).astype(np.float32) for _ in range(3)]
    jheads = [jnp.asarray(h).astype(jprec.PrecisionPolicy.parse(name).compute_dtype)
              for h in heads]
    theads = [torch.from_numpy(h).to(tprec.PrecisionPolicy.parse(name).compute_dtype)
              for h in heads]
    want = jprec.PrecisionPolicy.parse(name).boundary(jheads)
    got = tprec.PrecisionPolicy.parse(name).boundary(theads)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and np.asarray(w).dtype == np.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ["f32", "bf16", "int8w"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16, np.uint8, np.int32])
def test_wire_cast_agrees_with_jax(name, dtype):
    rng = np.random.default_rng(3)
    arr = (rng.uniform(0, 255, (2, 8, 8, 3))).astype(dtype)
    jpol, tpol = jprec.PrecisionPolicy(name=name), tprec.PrecisionPolicy(name=name)
    want, got = jpol.wire_cast("images", arr), tpol.wire_cast("images", arr)
    if want.dtype == jprec.BF16:
        assert got.dtype == BF16
        np.testing.assert_array_equal(_words(got), want.view(np.uint16))
    else:
        assert got is arr and want is arr  # never widened, passed as it is
    words = tprec.to_bf16_words(arr.astype(np.float32))
    assert tpol.wire_cast("images", words) is words


def test_spec_extra_counts_stored_bytes():
    params = {"a": torch.zeros(4, 3, dtype=torch.bfloat16), "b": torch.zeros(5)}
    extra = tprec.PrecisionPolicy.parse("bf16").spec_extra(params)
    assert extra == {"precision": "bf16", "precision_keep_f32": list(tprec.KEEP_F32_2D),
                     "param_bytes": 4 * 3 * 2 + 5 * 4}


def test_apply_cast_params_stores_bf16_tensors():
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    tprec.apply_cast_params(model, tprec.PrecisionPolicy.parse("bf16"))
    sd = model.state_dict()
    assert all(v.dtype == torch.bfloat16 for k, v in sd.items() if "num_batches" not in k)
    assert sd["1.num_batches_tracked"].dtype == torch.int64
    assert isinstance(model[0].weight, torch.nn.Parameter)


# -- the codec and the staged channel -------------------------------------------------------


def test_codec_round_trips_bf16_words():
    x = np.random.default_rng(4).normal(0, 100, (2, 3, 4)).astype(np.float32)
    words = tprec.to_bf16_words(x)
    req = codec.build_infer_request("m", {"images": words})
    assert req.inputs[0].datatype == "BF16"
    back = codec.parse_infer_request(req)["images"]
    assert back.dtype == BF16 and back.shape == x.shape
    np.testing.assert_array_equal(_words(back), _words(words))
    resp = codec.parse_infer_response(codec.build_infer_response("m", {"o": words}))
    np.testing.assert_array_equal(_words(resp["o"]), _words(words))


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_channel_stages_a_bf16_models_fp32_frames_as_bf16(name):
    """A registered policy narrows FP32 frames on the host (the JAX staged
    channel's ``cast_wire_input``); uint8 frames pass as they are; outputs
    come back at their wire dtype."""
    seen = []

    def infer(inputs):
        seen.append(inputs["images"].dtype)
        return {"out": inputs["images"].float().sum(dim=(1, 2, 3))}

    spec = ModelSpec(name="m", inputs=(TensorSpec("images", (-1, -1, -1, 3), "FP32"),),
                     outputs=(TensorSpec("out", (-1,), "FP32"),), max_batch_size=4)
    repo = ModelRepository()
    repo.register(spec, infer, precision=tprec.PrecisionPolicy.parse(name))
    chan = CUDAChannel(repo, device="cpu")
    x = np.random.default_rng(5).uniform(0, 255, (2, 4, 4, 3)).astype(np.float32)
    out = chan.do_inference(InferRequest("m", {"images": x})).outputs["out"]
    chan.do_inference(InferRequest("m", {"images": x.astype(np.uint8)}))
    want_dtype = torch.bfloat16 if name == "bf16" else torch.float32
    assert seen == [want_dtype, torch.uint8]
    assert out.dtype == np.float32
    staged = x if name == "f32" else x.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_allclose(out, staged.sum(axis=(1, 2, 3)), rtol=1e-6)


def test_detection_map_copy_agrees_with_jax():
    """The port's copy of eval/detection_map.py scores seeded detections
    as the JAX package's does."""
    from triton_client_tpu.eval.detection_map import DetectionEvaluator as JEvaluator

    from triton_client_tpu_torch.eval.detection_map import DetectionEvaluator

    rng = np.random.default_rng(9)
    port, ref = DetectionEvaluator(), JEvaluator()
    for _ in range(4):
        xy = rng.uniform(0, 50, (12, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 20, (12, 2))], axis=1)
        dets = np.concatenate([boxes + rng.normal(0, 2, boxes.shape), rng.uniform(0, 1, (12, 1)),
                               rng.integers(0, 2, (12, 1))], axis=1).astype(np.float32)
        valid = rng.random(12) > 0.2
        gts = np.concatenate([boxes[:8], rng.integers(0, 2, (8, 1))], axis=1)
        port.add_frame(dets, valid, gts)
        ref.add_frame(dets, valid, gts)
    assert port.summary() == ref.summary()


# -- int8: quantization, calibration, the int8 wire -------------------------------------------


def _channels(rng, shape, axis):
    """A float32 array whose channels along ``axis`` span orders of
    magnitude, with one all-zero channel and values on the .5 rounding
    boundary of their scale."""
    x = rng.normal(0, 1, shape).astype(np.float32)
    x = x * (10.0 ** rng.integers(-3, 3, shape[axis])).reshape(
        [-1 if i == axis % len(shape) else 1 for i in range(len(shape))]).astype(np.float32)
    idx = [slice(None)] * len(shape)
    idx[axis] = 0
    x[tuple(idx)] = 0.0
    idx[axis] = 1
    x[tuple(idx)] = 0.0
    x[tuple(idx)].flat[0] = 127.0
    x[tuple(idx)].flat[-1] = 2.5  # 2.5 / 1.0 rounds half to even
    return x


@pytest.mark.parametrize("shape,axis", [((3, 3, 4, 8), -1), ((8, 4, 3, 3), 0), ((4, 8, 2, 2), 1),
                                        ((64, 10), -1), ((3, 3, 3, 5, 16), -1)])
def test_quantize_channelwise_is_bitwise_jax(shape, axis):
    x = _channels(np.random.default_rng(len(shape) + axis), shape, axis)
    want = jprec.quantize_channelwise(x, axis=axis)
    got = tprec.quantize_channelwise(x, axis=axis)
    for g, w in ((got.q, want.q), (got.scale, want.scale)):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got.nbytes == want.nbytes and got.shape == tuple(want.shape)
    zero = np.take(np.asarray(got.scale), 0, axis=axis)
    assert (zero == 1.0).all()  # an all-zero channel dequantizes by 1.0
    # a tensor gives tensors, the same values
    tq = tprec.quantize_channelwise(torch.from_numpy(x), axis=axis)
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(tq.q.numpy(), got.q)
    np.testing.assert_array_equal(tq.scale.numpy(), got.scale)
    # realize: q * scale in float32, as JAX's dequant
    np.testing.assert_array_equal(tprec.realize({"k": got})["k"],
                                  np.asarray(jprec.realize({"k": want})["k"]))
    np.testing.assert_array_equal(tq.dequant().numpy(), np.asarray(want.dequant()))


def test_quantize_reads_bf16_words_as_their_float32_values():
    x = _channels(np.random.default_rng(9), (3, 3, 4, 8), -1)
    words = tprec.to_bf16_words(x)
    want = jprec.quantize_channelwise(x.astype(ml_dtypes.bfloat16))
    got = tprec.quantize_channelwise(words)
    np.testing.assert_array_equal(got.q, np.asarray(want.q))
    np.testing.assert_array_equal(got.scale, np.asarray(want.scale))


def _samples(rng):
    return {"images": rng.uniform(-3, 250, (2, 8, 8, 3)).astype(np.float32),
            "zeros": np.zeros((2, 4), np.float32),
            "points": rng.normal(0, 20, (16, 4)).astype(np.float32),
            "frames": rng.integers(0, 255, (2, 4), dtype=np.uint8),
            "empty": np.zeros((0, 3), np.float32)}


@pytest.mark.parametrize("name", ["f32", "bf16", "int8w", "int8"])
def test_calibrated_wire_cast_and_ingest_agree_with_jax(name):
    """Scales from the same samples (``points`` exempt as a keep-list input,
    integer frames skipped), the host quantize byte-equal, and the device
    dequantize equal to JAX's on the wire codes."""
    rng = np.random.default_rng(11)
    samples = _samples(rng)
    jpol = jprec.PrecisionPolicy(name=name, keep_f32_inputs=("points",)).calibrated(samples)
    tpol = tprec.PrecisionPolicy(name=name, keep_f32_inputs=("points",)).calibrated(samples)
    assert tpol.act_scales == jpol.act_scales
    assert tpol.wire_ingest_needed == jpol.wire_ingest_needed == (name == "int8")
    if name == "int8":
        assert dict(tpol.act_scales).keys() == {"images", "zeros", "empty"}
        assert tpol.scale_for("zeros") == 1.0 and tpol.scale_for("points") is None
    for key, arr in {**samples, "other": samples["images"]}.items():
        want, got = jpol.wire_cast(key, arr), tpol.wire_cast(key, arr)
        if want.dtype == jprec.BF16:
            np.testing.assert_array_equal(_words(got), want.view(np.uint16))
            assert tpol.wire_dtype(key) == torch.bfloat16
            continue
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), key
        if np.issubdtype(arr.dtype, np.floating) and arr.size:
            assert tpol.wire_dtype(key) == TORCH_OF.get(got.dtype.type, torch.int8), key
    got = tpol.ingest({k: tprec.host_tensor(tpol.wire_cast(k, v)) for k, v in samples.items()})
    want = jpol.ingest({k: jnp.asarray(jpol.wire_cast(k, v)) for k, v in samples.items()})
    for k in samples:
        w = np.asarray(want[k])
        assert got[k].dtype == {np.dtype(np.float32): torch.float32, np.dtype(np.uint8): torch.uint8,
                                np.dtype(np.int8): torch.int8}.get(w.dtype, torch.bfloat16), k
        np.testing.assert_array_equal(got[k].float().numpy(), w.astype(np.float32))
    # a float32 input of a calibrated name passes the ingest untouched
    f32 = torch.from_numpy(samples["images"])
    assert tpol.ingest({"images": f32})["images"] is f32


def test_keep_list_inputs_and_uncalibrated_int8_stage_float32():
    pol = tprec.PrecisionPolicy(name="bf16", keep_f32_inputs=("points",))
    pts = np.ones((4, 4), np.float32)
    assert pol.wire_cast("points", pts) is pts and pol.wire_dtype("points") == torch.float32
    assert pol.wire_dtype("images") == torch.bfloat16
    int8 = tprec.PrecisionPolicy.parse("int8")
    assert int8.wire_cast("images", pts) is pts and int8.ingest({"x": 1}) == {"x": 1}


def _conv_zoo():
    torch.manual_seed(0)
    return torch.nn.ModuleDict({
        "conv": torch.nn.Conv2d(3, 8, 3, bias=True), "bn": torch.nn.BatchNorm2d(8),
        "up": torch.nn.ConvTranspose2d(8, 5, 2, stride=2, bias=False),
        "lin": torch.nn.Linear(6, 7, bias=False), "vol": torch.nn.Conv3d(2, 4, 3, bias=False),
    }).eval()


def test_apply_cast_params_stores_int8_weights_behind_a_parametrization():
    """Each kernel becomes ``q`` (int8) and ``scale`` (float32) over its
    output-channel axis (1 on the transposed conv), with no float32 copy;
    the module computes with ``q * scale``; 1-D tensors stay float32; the
    stored bytes are JAX's ``tree_bytes`` of the same quantized leaves."""
    from torch.nn.utils import parametrize

    zoo = _conv_zoo()
    plain = {k: v.clone() for k, v in zoo.state_dict().items()}
    tprec.apply_cast_params(zoo, tprec.PrecisionPolicy.parse("int8w"))
    stored = tprec.stored_params(zoo)
    want_bytes = 0
    for name, axis in (("conv", 0), ("up", 1), ("lin", 0), ("vol", 0)):
        mod = zoo[name]
        assert parametrize.is_parametrized(mod, "weight")
        q = stored[f"{name}.parametrizations.weight.original0"]
        scale = stored[f"{name}.parametrizations.weight.original1"]
        want = tprec.quantize_channelwise(plain[f"{name}.weight"].numpy(), axis)
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), want.q)
        np.testing.assert_array_equal(scale.numpy(), want.scale)
        np.testing.assert_array_equal(mod.weight.numpy(), want.dequant())
        want_bytes += want.nbytes
        assert not any(k.startswith(f"{name}.weight") for k in stored)
    rest = {k: v for k, v in stored.items() if ".parametrizations." not in k}
    assert all(v.dtype == torch.float32 for v in rest.values())
    assert tprec.tree_bytes(stored) == want_bytes + sum(v.numel() * 4 for v in rest.values())
    x = torch.randn(1, 3, 6, 6)
    with torch.no_grad():
        want = torch.nn.functional.conv2d(x, zoo["conv"].weight, zoo["conv"].bias)
        np.testing.assert_array_equal(zoo["conv"](x).numpy(), want.numpy())


def test_int8_on_a_bf16_body_quantizes_the_float32_source():
    """A bfloat16 module quantizes the float32 weights it was filled from
    and dequantizes to bfloat16 (flax casts the realized float32 kernel to
    the module's dtype); its 1-D tensors return to float32."""
    src = _conv_zoo().state_dict()
    zoo = _conv_zoo().to(torch.bfloat16)
    tprec.apply_cast_params(zoo, tprec.PrecisionPolicy.parse("int8w"), source=src)
    want = tprec.quantize_channelwise(src["conv.weight"].numpy(), 0)
    assert zoo["conv"].weight.dtype == torch.bfloat16
    np.testing.assert_array_equal(zoo["conv"].weight.float().numpy(), np.asarray(
        jnp.asarray(want.dequant()).astype(jnp.bfloat16).astype(jnp.float32)))
    np.testing.assert_array_equal(zoo["bn"].weight.numpy(), src["bn.weight"].numpy())
    assert zoo["bn"].running_var.dtype == torch.float32


# -- YOLOv5n: q and scale per flax leaf, int8w heads, detections ------------------------------

HW2D = (64, 64)


def _yolo_pair(s2d, ch_floor, seed=3):
    from tests.test_torch_server import seeded_variables
    from triton_client_tpu.models.yolov5 import YoloV5 as JYoloV5

    jmodel = JYoloV5(num_classes=2, variant="n", s2d=s2d, ch_floor=ch_floor)
    variables = jax.tree_util.tree_map(np.asarray, seeded_variables(
        lambda k: jmodel.init(k, jnp.zeros((1, *HW2D, 3)), train=False), seed=seed))
    return jmodel, variables


def quantized_leaves_equal_jax(model, jtree, module_path=".".join) -> int:
    """Every flax kernel JAX quantizes equals the port's ``q``/``scale`` at
    the mapped module, through the kernel layout map; returns the count."""
    from torch.nn.utils import parametrize

    from triton_client_tpu_torch.models.convert import _kernel_to_torch

    n = 0
    for path, leaf in _flatten(jtree["params"]):
        if not isinstance(leaf, jprec.QuantizedParam):
            assert np.asarray(leaf).ndim == 1, path
            continue
        mod = model.get_submodule(module_path(path[:-1]))
        assert parametrize.is_parametrized(mod, "weight"), path
        p = mod.parametrizations.weight
        np.testing.assert_array_equal(p.original0.cpu().numpy(),
                                      _kernel_to_torch(mod, np.asarray(leaf.q)), err_msg=str(path))
        np.testing.assert_array_equal(p.original1.cpu().numpy().ravel(),
                                      np.asarray(leaf.scale).ravel(), err_msg=str(path))
        n += 1
    assert n == sum(parametrize.is_parametrized(m, "weight") for m in model.modules())
    return n


@pytest.mark.parametrize("s2d,ch_floor,dtype", [(False, 0, "fp32"), (True, 32, "bf16")])
def test_yolov5_int8_leaves_and_bytes_equal_jax(s2d, ch_floor, dtype):
    """Both layouts (the s2d stem and the 32-channel floor on a bf16 body:
    examples/yolov5_crop under --precision int8w): q and scale per leaf,
    param_bytes equal to the JAX builder's; int8w heads within the f32 bar
    of JAX's int8w heads (on the bf16 body, within twice JAX's own bf16
    distance)."""
    from triton_client_tpu.pipelines import detect2d as jdet2d

    from triton_client_tpu_torch.models.convert import _yolov5_module_path
    from triton_client_tpu_torch.pipelines import detect2d as tdet2d

    jmodel, variables = _yolo_pair(s2d, ch_floor)
    jdtype = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    kw = dict(variant="n", num_classes=2, input_hw=HW2D, s2d=s2d, ch_floor=ch_floor)
    _, jspec, _ = jdet2d.build_yolov5_pipeline(jax.random.PRNGKey(0), variables=variables,
                                              dtype=jdtype, precision="int8w", **kw)
    _, spec, model = tdet2d.build_yolov5_pipeline(variables=variables, dtype=dtype,
                                                  precision="int8w", device="cpu", **kw)
    jtree = jprec.PrecisionPolicy.parse("int8w").cast_params(variables)
    assert quantized_leaves_equal_jax(model, jtree, _yolov5_module_path) > 50
    assert spec.extra["param_bytes"] == jspec.extra["param_bytes"] == jprec.tree_bytes(jtree)
    assert spec.extra["precision"] == jspec.extra["precision"] == "int8w"
    x = np.random.default_rng(1).uniform(0, 1, (2, *HW2D, 3)).astype(np.float32)
    jq = type(jmodel)(num_classes=2, variant="n", s2d=s2d, ch_floor=ch_floor, dtype=jdtype)
    want = jq.apply(jprec.realize(jtree), x, train=False)
    with torch.no_grad():
        got = [h.numpy() for h in model(torch.from_numpy(x))]
    if dtype == "fp32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), atol=5e-4, rtol=1e-4)
        return
    ref = type(jmodel)(num_classes=2, variant="n", s2d=s2d, ch_floor=ch_floor).apply(
        jprec.realize(jtree), x, train=False)
    for g, w, r in zip(got, want, ref):
        jax_dist = float(np.abs(np.asarray(w, np.float32) - np.asarray(r)).max())
        assert 0 < float(np.abs(g - np.asarray(r)).max()) <= 2 * jax_dist


@pytest.fixture(scope="module")
def yolo_policies():
    """f32, int8w and calibrated int8 YOLOv5n pipelines on flax-init
    weights (BatchNorm the identity, biases 0), and the evaluation frames."""
    from tests.test_torch_yolov5_layout import flax_init_like
    from triton_client_tpu.models.yolov5 import YoloV5 as JYoloV5

    from triton_client_tpu_torch.pipelines import detect2d as tdet2d

    variables = flax_init_like(JYoloV5(num_classes=2, variant="n"), seed=3)
    frames = np.random.default_rng(0).integers(0, 255, (4, *HW2D, 3)).astype(np.float32)
    cfg = tdet2d.Detect2DConfig(model_name="yolov5_prec", num_classes=2, input_hw=HW2D,
                                conf_thresh=0.05)
    out = {}
    for name in ("f32", "int8w", "int8"):
        policy = tprec.PrecisionPolicy.parse(name)
        if policy.quantize_acts:
            policy = policy.calibrated({"images": frames})  # calibrate, then register
        out[name] = tdet2d.build_yolov5_pipeline(
            variant="n", num_classes=2, input_hw=HW2D, variables=variables, config=cfg,
            device="cpu", precision=policy)
    return out, frames


@pytest.mark.parametrize("name", ["int8w", "int8"])
def test_yolov5_int8_detections_hold_the_map_budget(yolo_policies, name):
    """The port's int8w and calibrated int8 detections, through the channel
    as served (int8 frames for the calibrated policy), scored against its
    f32 detections: at least the f32 self-score less MAP_BUDGETS[name]."""
    from triton_client_tpu_torch.eval.detection_map import DetectionEvaluator

    pipes, frames = yolo_policies
    dets, valid = pipes["f32"][0].infer(frames)
    assert int(valid.sum()) > 0, "parity needs live boxes"
    gts = [d[v][:, [0, 1, 2, 3, 5]] for d, v in zip(dets, valid)]

    def score(d, v):
        ev = DetectionEvaluator()
        for a, b, gt in zip(d, v, gts):
            ev.add_frame(a, b, gt)
        return float(ev.summary()["map"])

    pipe, spec, _ = pipes[name]
    repo = ModelRepository()
    repo.register(spec, pipe.infer_fn(), precision=pipe.precision)
    chan = CUDAChannel(repo, device="cpu")
    out = chan.do_inference(InferRequest(spec.name, {"images": frames})).outputs
    assert out["detections"].dtype == np.float32
    assert score(out["detections"], out["valid"]) >= score(dets, valid) - tprec.MAP_BUDGETS[name]
    assert spec.extra["precision"] == name
    assert spec.extra["param_bytes"] < pipes["f32"][1].extra["param_bytes"] * 0.3


def test_int8_channel_stages_int8_frames_and_warms_their_key(yolo_policies):
    """A calibrated int8 model's FP32 frames stage as int8 (a quarter of the
    bytes), dequantized inside the captured body; the int8w model's stay
    float32; warmup captures the key the channel stages."""
    from triton_client_tpu_torch.channel.staged import cast_wire_input

    pipes, frames = yolo_policies
    for name, want in (("int8", torch.int8), ("int8w", torch.float32)):
        pipe, spec, _ = pipes[name]
        repo = ModelRepository()
        repo.register(spec, pipe.infer_fn(), precision=pipe.precision)
        chan = CUDAChannel(repo, device="cpu")
        staged, _ = chan._place_inputs(repo.get(spec.name), InferRequest(
            spec.name, {"images": frames[:2]}))
        assert staged["images"].dtype == want == pipe.precision.wire_dtype("images")
        wire = cast_wire_input(repo.get(spec.name), "images", frames[:2])
        assert wire.nbytes == frames[:2].nbytes // (4 if name == "int8" else 1)
        with torch.no_grad():
            served = pipe.run(staged["images"])
            ingested = pipe.run(pipe.precision.ingest({"images": staged["images"]})["images"])
        for a, b in zip(served, ingested):
            assert torch.equal(a, b)
        pipe.warmup(HW2D, dtype=pipe.precision.wire_dtype("images"))
        assert pipe._jit.key((staged["images"][:1],)) in pipe._jit._keys
