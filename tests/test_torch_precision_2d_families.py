"""Every serving precision policy on YOLOv4, RetinaNet and FCOS against
the JAX package's, on the CPU, at a tiny size (YOLOv4 ``width=0.125``, the
detectron family's ``tiny`` depth, 64x64), on the same seeded flax tree.

The three families take ``KEEP_F32_2D`` as YOLOv5 does: their final head
convolutions, the decode, the tail and the rescale run in float32 under
every policy. Held here, per family:

- ``int8w`` and ``int8``: each kernel JAX quantizes is the port's ``q`` and
  ``scale`` bit for bit, ``param_bytes`` is the JAX builder's, and the
  int8w heads are within the float32 bar (1e-5 of the largest head value)
  of JAX's int8w heads; a calibrated int8 pipeline serves int8 frames
  through the channel;
- ``bf16``: ``param_bytes`` is the JAX builder's (half the float32 tree),
  and the heads are within twice JAX's own bf16 distance from float32
  (flax normalises in bfloat16, PyTorch in float32 and then rounds, as on
  YOLOv5 and the 3D bodies).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_client_tpu.models import retinanet as jret
from triton_client_tpu.models import yolov4 as jv4
from triton_client_tpu.pipelines import detect2d as jdet
from triton_client_tpu.runtime import precision as jprec

from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.pipelines import detect2d as tdet
from triton_client_tpu_torch.runtime import precision as tprec
from triton_client_tpu_torch.runtime.repository import ModelRepository
from tests.test_torch_precision import quantized_leaves_equal_jax
from tests.test_torch_server import seeded_variables
from torch_threads import one_torch_thread  # noqa: F401

NC, HW = 3, (64, 64)
FAMILIES = ("yolov4", "retinanet", "fcos")


def _jax_model(family, dtype=jnp.float32):
    if family == "yolov4":
        return jv4.YoloV4(num_classes=NC, width=0.125, dtype=dtype)
    cls = jret.RetinaNet if family == "retinanet" else jret.FCOS
    return cls(num_classes=NC, depth="tiny", input_hw=HW, dtype=dtype)


def _extra(family):
    return {"width": 0.125} if family == "yolov4" else {"depth": "tiny"}


@functools.lru_cache(maxsize=None)
def _variables(family):
    model = _jax_model(family)
    return jax.tree_util.tree_map(np.asarray, seeded_variables(
        lambda k: model.init(k, jnp.zeros((1, *HW, 3)), train=False), seed=41))


def _frames():
    return np.random.default_rng(5).uniform(0, 1, (2, *HW, 3)).astype(np.float32)


def _jax_heads(family, tree, dtype=jnp.float32):
    model = _jax_model(family, dtype)
    out = jax.jit(functools.partial(model.apply, train=False))(jprec.realize(tree), _frames())
    return [np.asarray(h, np.float32) for h in out]


@functools.lru_cache(maxsize=None)
def _f32_heads(family):
    return _jax_heads(family, _variables(family))


def _port(family, policy, dtype="fp32"):
    build = tdet.BUILDERS_2D[family]
    return build(num_classes=NC, input_hw=HW, variables=_variables(family), device="cpu",
                 precision=policy, dtype=dtype, **_extra(family))


def _port_heads(model):
    with torch.no_grad():
        return [h.float().numpy() for h in model(torch.from_numpy(_frames()))]


def _jax_spec(family, policy):
    build = {"yolov4": jdet.build_yolov4_pipeline, "retinanet": jdet.build_retinanet_pipeline,
             "fcos": jdet.build_fcos_pipeline}[family]
    _, spec, _ = build(jax.random.PRNGKey(0), num_classes=NC, input_hw=HW,
                       variables=_variables(family), precision=policy, **_extra(family))
    return spec


@pytest.mark.parametrize("policy", ["int8w", "int8"])
@pytest.mark.parametrize("family", FAMILIES)
def test_int8_leaves_bytes_and_heads_equal_jax(family, policy):
    jtree = jprec.PrecisionPolicy.parse(policy).cast_params(_variables(family))
    _, spec, model = _port(family, policy)
    assert quantized_leaves_equal_jax(model, jtree) > 10
    jspec = _jax_spec(family, policy)
    assert spec.extra["param_bytes"] == jspec.extra["param_bytes"] == jprec.tree_bytes(jtree)
    for key in ("precision", "precision_keep_f32"):
        assert spec.extra[key] == jspec.extra[key], key
    if policy == "int8w":
        for g, w in zip(_port_heads(model), _jax_heads(family, jtree)):
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_bytes_and_heads_within_twice_jax_bf16_distance(family):
    _, spec, model = _port(family, "bf16")
    jspec = _jax_spec(family, "bf16")
    assert spec.extra["param_bytes"] == jspec.extra["param_bytes"]
    assert spec.extra["precision"] == "bf16"
    jtree = jprec.PrecisionPolicy.parse("bf16").cast_params(_variables(family))
    want_bf16 = _jax_heads(family, jtree, jnp.bfloat16)
    for g, w, ref in zip(_port_heads(model), want_bf16, _f32_heads(family)):
        jax_dist = float(np.abs(w - ref).max())
        assert 0 < float(np.abs(g - ref).max()) <= 2 * jax_dist


@pytest.mark.parametrize("family", FAMILIES)
def test_calibrated_int8_serves_int8_frames(family):
    """A calibrated int8 pipeline through the channel: its frames staged as
    int8, detections float32 and finite in the family's contract."""
    frames = np.random.default_rng(6).integers(0, 255, (2, *HW, 3)).astype(np.float32)
    policy = tprec.PrecisionPolicy.parse("int8").calibrated({"images": frames})
    pipe, spec, _ = _port(family, policy)
    seen = []
    fn = pipe.infer_fn()
    repo = ModelRepository()
    repo.register(spec, lambda inputs: seen.append(inputs["images"].dtype) or fn(inputs),
                  precision=pipe.precision)
    out = CUDAChannel(repo, device="cpu").do_inference(
        InferRequest(spec.name, {"images": frames})).outputs
    assert seen == [torch.int8]
    rows = out["detections"] if "detections" in out else out["boxes"]
    assert rows.dtype == np.float32 and np.isfinite(rows).all()
