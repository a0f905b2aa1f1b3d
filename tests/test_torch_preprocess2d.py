"""The port's preprocess pipeline (``pipelines/preprocess2d.py``) against
the JAX package's, on the CPU: the same seeded frames through both, with
and without a resize, at atol 1e-3 on the 0..255 scale (the bar of
``ops/preprocess.resize_bilinear`` against ``jax.image.resize``,
tests/test_torch_ops.py); the spec, the builder's table entry and the
three callables (``infer``, ``infer_fn``, ``device_fn``)."""

import dataclasses

import numpy as np
import pytest
import torch

from triton_client_tpu.pipelines import detect2d as jdet2d
from triton_client_tpu.pipelines import preprocess2d as jpre

from triton_client_tpu_torch.pipelines import detect2d as tdet2d
from triton_client_tpu_torch.pipelines import preprocess2d as tpre
from torch_threads import one_torch_thread  # noqa: F401

OUT_HW = (64, 64)


def _pair(out_hw=OUT_HW):
    jpipe, jspec, _ = jpre.build_preprocess_pipeline(input_hw=out_hw)
    tpipe, tspec, params = tpre.build_preprocess_pipeline(input_hw=out_hw, device="cpu",
                                                          variables={"ignored": 1})
    return jpipe, jspec, tpipe, tspec, params


def _frames(dtype, hw, n=2, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8)
    return (rng.random((n, *hw, 3)) * 255).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("hw", [(48, 80), (96, 128), OUT_HW], ids=["up", "down", "same"])
def test_pipeline_matches_jax(dtype, hw):
    jpipe, _, tpipe, _, _ = _pair()
    frames = _frames(dtype, hw)
    want = jpipe.infer(frames)
    got = tpipe.infer(frames)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (2, *OUT_HW, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    if hw == OUT_HW:  # no resize: a cast, exact
        np.testing.assert_array_equal(got, frames.astype(np.float32))
    # raw pixel scale: nothing normalises
    assert got.max() > 200


def test_single_frame_gains_the_batch_dim():
    jpipe, _, tpipe, _, _ = _pair()
    frame = _frames(np.uint8, (48, 80), n=1)[0]
    want = jpipe.infer(frame)
    got = tpipe.infer(frame)
    assert got.shape == want.shape == (1, *OUT_HW, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_spec_and_builder_match_jax():
    _, jspec, _, tspec, params = _pair((32, 48))
    assert params == {}
    assert dataclasses.asdict(tspec) == {**dataclasses.asdict(jspec), "platform": "torch"}
    assert tspec.extra == {"out_hw": [32, 48]}
    assert "preprocess" in tdet2d.BUILDERS_2D and "preprocess" in jdet2d.BUILDERS_2D
    pipe, spec, _ = tdet2d.BUILDERS_2D["preprocess"](input_hw=(32, 48), device="cpu")
    assert spec == tspec and pipe.config == tpre.Preprocess2DConfig(input_hw=(32, 48))
    assert tdet2d.default_config("preprocess", input_hw=[32, 48]) == pipe.config


def test_infer_fn_and_device_fn_match_infer():
    """The captured ``infer_fn`` and the eager ``device_fn`` give ``infer``'s
    rows, as contiguous NHWC float32 tensors, and keep no reference to a
    float32 input (the identity case copies)."""
    _, _, tpipe, _, _ = _pair()
    frames = torch.from_numpy(_frames(np.float32, (48, 80)))
    want = tpipe.infer(frames.numpy())
    for fn in (tpipe.infer_fn(), tpipe.device_fn()):
        out = fn({"images": frames})["preprocessed"]
        assert out.is_contiguous() and out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), want)
    same = torch.from_numpy(_frames(np.float32, OUT_HW))
    out = tpipe.device_fn()({"images": same})["preprocessed"]
    assert torch.equal(out, same) and out.data_ptr() != same.data_ptr()
    keys = tpipe.graph_stats()["keys"]
    tpipe.warmup(OUT_HW, batch_sizes=(1, 3))
    assert tpipe.graph_stats()["keys"] == keys + 2
