"""The port's precision policies (``runtime/precision.py``) against the JAX
package's, on the same inputs: ``parse``, ``resolve_policy``,
``cast_params``, ``boundary`` and ``wire_cast``; the host bfloat16 words
byte-equal to ``ml_dtypes`` casts (NaN payloads aside); the codec's BF16
round trip; the staged channel narrowing a bf16 model's FP32 frames; and
the int8 policies raising, naming their ROADMAP item."""

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

TORCH_OF = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _ml_words(x: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore"):  # NaN inputs
        return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).view(np.uint16)


def _words(x) -> np.ndarray:
    return np.asarray(x).view(np.uint16)


# -- parse and resolve ----------------------------------------------------------


@pytest.mark.parametrize("value", [None, "", "f32", "bf16"])
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
def test_int8_policies_parse_then_raise_naming_item_10(name):
    jprec.PrecisionPolicy.parse(name)  # served by the JAX package
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md Queue 1 item 10 "):
        tprec.PrecisionPolicy.parse(name)


@pytest.mark.parametrize("precision", [None, "f32", "bf16"])
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


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_cast_params_agrees_with_jax(name):
    tree = _tree(np.random.default_rng(1))
    want = jprec.PrecisionPolicy.parse(name).cast_params(tree)
    got = tprec.PrecisionPolicy.parse(name).cast_params(tree)
    flat_w = dict(_flatten(want))
    for path, leaf in _flatten(got):
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


@pytest.mark.parametrize("name", ["f32", "bf16"])
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


@pytest.mark.parametrize("name", ["f32", "bf16"])
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
