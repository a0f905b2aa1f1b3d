"""The slice end to end: the port's 2D detection pipeline, repository,
channel and CLI against the JAX package's, on the CPU with the same
carried weights and the same frames."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from triton_client_tpu.ops.detect_postprocess import extract_boxes as jax_extract_boxes
from triton_client_tpu.pipelines import detect2d as jdet

from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.ops.detect_postprocess import extract_boxes
from triton_client_tpu_torch.pipelines import detect2d as tdet
from triton_client_tpu_torch.runtime.repository import ModelRepository
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"


def _build_pair(hw, nc=2, fused="on", **cfg_kwargs):
    """The JAX pipeline from PRNGKey(0) and the port's with those
    variables carried across (CPU)."""
    jcfg = jdet.Detect2DConfig(num_classes=nc, input_hw=hw, fused=fused, **cfg_kwargs)
    jpipe, jspec, variables = jdet.build_yolov5_pipeline(
        jax.random.PRNGKey(0), variant="n", num_classes=nc, input_hw=hw, config=jcfg
    )
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    tcfg = tdet.Detect2DConfig(num_classes=nc, input_hw=hw, fused=fused, **cfg_kwargs)
    tpipe, tspec, tmodel = tdet.build_yolov5_pipeline(
        variant="n", num_classes=nc, input_hw=hw, variables=variables, config=tcfg, device="cpu"
    )
    return jpipe, jspec, variables, tpipe, tspec, tmodel


@pytest.fixture(scope="module")
def pair128():
    return _build_pair((128, 128), conf_thresh=0.05, max_det=100)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("multi_label", [False, True])
def test_tail_bitwise_given_the_same_predictions(pair128, fused, multi_label):
    """Same decoded predictions in -> identical packed rows and valid
    out, through the fused tail (plain version of the CUDA kernel vs the
    Pallas kernel in interpret mode) and the unfused op chain."""
    _, _, variables, _, _, _ = pair128
    from triton_client_tpu.models.yolov5 import YoloV5 as JYoloV5

    jmodel = JYoloV5(num_classes=2, variant="n")
    x = np.random.default_rng(2).uniform(0, 1, (3, 128, 128, 3)).astype(np.float32)
    pred = np.array(jmodel.decode(jmodel.apply(variables, x, train=False)))
    kw = dict(conf_thresh=0.05, iou_thresh=0.45, max_det=100, max_nms=512, multi_label=multi_label)
    want_rows, want_valid = jax_extract_boxes(pred, fused=fused, interpret=True, **kw)
    rows, valid = extract_boxes(torch.from_numpy(pred), fused=fused, **kw)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    assert valid.numpy().sum() > 50  # NMS did real work


def test_pipeline_matches_jax(pair128):
    """Whole pipeline on uint8 frames of another resolution than the
    model's (96x128 -> 128x128, resized on the way in and rescaled on the
    way out): equal valid, rows within 1e-3 relative / 1e-2 pixels. The
    forward differs at the 5e-4 head bar, the tail does not."""
    jpipe, _, _, tpipe, _, _ = pair128
    frames = np.random.default_rng(4).integers(0, 255, (2, 96, 128, 3), dtype=np.uint8)
    want_dets, want_valid = jpipe.infer(frames)
    dets, valid = tpipe.infer(frames)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_allclose(dets, want_dets, rtol=1e-3, atol=1e-2)
    assert valid.sum() > 20


def test_reproduces_the_yolov5n_128_golden(rng):
    """tests/golden/yolov5n_128.json (read only) from carried PRNGKey(0)
    variables, with tests/test_golden_outputs.py's frame and bar."""
    *_, tpipe, _, _ = _build_pair((128, 128), conf_thresh=0.05, max_det=64, fused="auto")
    frame = (
        np.linspace(0, 255, 128 * 128 * 3).reshape(128, 128, 3)
        + rng.uniform(0, 30, (128, 128, 3))
    ).astype(np.float32)
    dets, valid = tpipe.infer(frame[None])
    dets, valid = dets[0], valid[0].astype(bool)
    got = {"n_det": [float(valid.sum())], "top5_rows": dets[valid][:5]}
    want = json.loads((GOLDEN / "yolov5n_128.json").read_text())
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(
            np.asarray(got[k], np.float64).round(4), np.asarray(want[k]), rtol=1e-2, atol=1e-2
        )


def test_spec_matches_detect2d_spec(pair128):
    _, jspec, _, _, tspec, _ = pair128
    assert (tspec.name, tspec.version, tspec.max_batch_size) == (
        jspec.name, jspec.version, jspec.max_batch_size
    )
    assert tspec.platform == "torch"
    for got, want in zip(tspec.inputs + tspec.outputs, jspec.inputs + jspec.outputs):
        assert (got.name, got.shape, got.dtype, got.layout) == (
            want.name, want.shape, want.dtype, want.layout
        )
    assert len(tspec.inputs + tspec.outputs) == len(jspec.inputs + jspec.outputs)
    for key, value in tspec.extra.items():
        assert jspec.extra[key] == value, key
    assert tspec.extra["fused_stages"] == ["decode_nms"]  # fused="on"


def test_fused_auto_follows_the_device():
    cfg = tdet.Detect2DConfig(num_classes=2, input_hw=(64, 64))
    pipe, spec, _ = tdet.build_yolov5_pipeline(
        num_classes=2, input_hw=(64, 64), config=cfg, device="cpu"
    )
    assert pipe.fused_stages == () and spec.extra["fused_stages"] == []


def test_channel_round_trip_equals_infer_and_keeps_uint8(pair128):
    _, _, _, tpipe, tspec, _ = pair128
    seen = []
    fn = tpipe.infer_fn()

    def recording_fn(inputs):
        seen.append(inputs["images"].dtype)
        return fn(inputs)

    repo = ModelRepository()
    repo.register(tspec, recording_fn)
    channel = CUDAChannel(repo, device="cpu")
    channel.register_channel()
    assert channel.get_metadata(tspec.name) is tspec
    frames = np.random.default_rng(6).integers(0, 255, (2, 96, 128, 3), dtype=np.uint8)
    resp = channel.do_inference(InferRequest(tspec.name, {"images": frames}, request_id="r1"))
    fut = channel.do_inference_async(InferRequest(tspec.name, {"images": frames[:1]}))
    want_dets, want_valid = tpipe.infer(frames)
    np.testing.assert_array_equal(resp.outputs["detections"], want_dets)
    np.testing.assert_array_equal(resp.outputs["valid"], want_valid)
    assert resp.request_id == "r1" and resp.outputs["valid"].dtype == np.bool_
    # (batch 1 on its own: CPU convolutions are not batch-invariant)
    np.testing.assert_array_equal(fut.result().outputs["detections"], tpipe.infer(frames[:1])[0])
    assert seen == [torch.uint8, torch.uint8]  # never widened on the host
    bad = channel.do_inference_async(InferRequest("missing", {"images": frames}))
    with pytest.raises(KeyError):
        bad.result()
    with pytest.raises(ValueError, match="rank"):
        channel.do_inference(InferRequest(tspec.name, {"images": frames[0]}))


def test_cli_runs_on_cpu_and_prints_its_summary():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "triton_client_tpu_torch", "detect2d", "-i", "synthetic:2:48x80",
         "--input-size", "64", "--device", "cpu", "-c", "2", "--conf", "0.05"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["frames"] == 2 and summary["device"] == "cpu"
    assert summary["detections"] > 0
    assert summary["kernel_launches"] == {"decode_nms_2d": 0, "greedy_nms": 0}
