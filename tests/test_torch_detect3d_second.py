"""SECOND-IoU end to end: the port's pipeline, repository, channel, driver
adapter and CLI against the JAX package's, on the CPU with the same
carried weights and the same clouds, at the tiny grid of
tests/test_fused_parity.py (``max_voxels`` 1024: the fused voxel stage's
cap is not reached, so fused equals unfused).

The JAX side runs its Pallas kernels in interpret mode (``fused="on"``);
the port's wrappers run the kernels' plain versions on CPU tensors. Bar:
equal live-row counts and labels, boxes and scores within 1e-5 (the heads
differ at the 1e-6 level, the decode by XLA's FMA contraction).
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from triton_client_tpu.pipelines import detect3d as jdet

from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.drivers.driver import channel_infer3d
from triton_client_tpu_torch.pipelines import detect3d as tdet
from triton_client_tpu_torch.runtime.repository import ModelRepository
from tests.test_fused_parity import TINY_SECOND
from tests.test_torch_second import TINY_RANGE, port_config, second_cloud
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
CFG = dict(model_name="second_iou", point_buckets=(1024,), max_det=16, pre_max=64)


def _build_pair(fused):
    jpipe, jspec, variables = jdet.build_second_pipeline(
        jax.random.PRNGKey(0), model_cfg=TINY_SECOND,
        config=jdet.Detect3DConfig(fused=fused, **CFG),
    )
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    tpipe, tspec, _ = tdet.build_second_pipeline(
        model_cfg=port_config(), config=tdet.Detect3DConfig(fused=fused, **CFG),
        variables=variables, device="cpu",
    )
    return jpipe, jspec, tpipe, tspec


@pytest.fixture(scope="module", params=["on", "off"])
def pair(request):
    return _build_pair(request.param)


def _assert_close(got, want):
    assert set(got) == set(want)
    assert got["pred_boxes"].shape == want["pred_boxes"].shape
    np.testing.assert_array_equal(got["pred_labels"], want["pred_labels"])
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["pred_scores"], want["pred_scores"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pipeline_matches_jax(pair, seed):
    jpipe, jspec, tpipe, tspec = pair
    assert tspec.extra["fused_stages"] == jspec.extra["fused_stages"]
    pts = second_cloud(300 + seed, 600)
    got, want = tpipe.infer(pts), jpipe.infer(pts)
    _assert_close(got, want)
    assert 0 < len(got["pred_scores"]) <= CFG["max_det"]
    assert got["pred_labels"].dtype == np.int32 and got["pred_labels"].min() >= 1


def test_spec_matches_jax(pair):
    _, jspec, _, tspec = pair
    assert (tspec.name, tspec.version, tspec.platform) == ("second_iou", jspec.version, "torch")
    for got, want in zip(tspec.inputs + tspec.outputs, jspec.inputs + jspec.outputs):
        assert (got.name, got.shape, got.dtype) == (want.name, want.shape, want.dtype)
    assert len(tspec.inputs + tspec.outputs) == len(jspec.inputs + jspec.outputs)
    for key, value in tspec.extra.items():
        assert jspec.extra[key] == value, key
    assert tspec.extra["iou_alpha"] == 0.71


def test_fused_stages_and_routes_agree_on_the_cpu():
    """Both stages fuse under "on" (the plain versions here) and none under
    "off"; below the cap both routes give the same rows, bitwise. The
    grouped route (the (V, K) voxelizer, under both budgets here) agrees
    within 1e-5."""
    pipes = {
        f: tdet.build_second_pipeline(
            model_cfg=port_config(), config=tdet.Detect3DConfig(fused=f, **CFG), device="cpu",
            seed=3,
        )[0]
        for f in ("on", "off")
    }
    assert pipes["on"].fused_stages == ("voxelize_scatter", "decode_nms")
    assert pipes["off"].fused_stages == () and pipes["off"].use_scatter
    for seed in range(2):
        padded, m = tdet.prepare_points(second_cloud(20 + seed, 600), 4, (1024,))
        rows = {
            f: p.run(torch.from_numpy(padded), torch.tensor(m, dtype=torch.int32))
            for f, p in pipes.items()
        }
        assert torch.equal(rows["on"][1], rows["off"][1]) and bool(rows["on"][1].any())
        assert torch.equal(rows["on"][0], rows["off"][0])
    model = pipes["off"].model
    grouped = tdet.Detect3DPipeline(tdet.Detect3DConfig(vfe="grouped", fused="on", **CFG), model,
                                    "cpu")
    assert not grouped.use_scatter and grouped.fused_stages == ("decode_nms",)
    pts = second_cloud(30, 500)
    a, g = pipes["off"].infer(pts), grouped.infer(pts)
    np.testing.assert_array_equal(a["pred_labels"], g["pred_labels"])
    np.testing.assert_allclose(a["pred_boxes"], g["pred_boxes"], rtol=0, atol=1e-5)


def test_channel_round_trip_through_channel_infer3d(pair):
    _, _, tpipe, tspec = pair
    repo = ModelRepository()
    repo.register(tspec, tpipe.infer_fn())
    channel = CUDAChannel(repo, device="cpu")
    channel.register_channel()
    infer = channel_infer3d(channel, tspec.name)
    for seed in (0, 4):
        pts = second_cloud(seed, 700)
        got, want = infer(pts), tpipe.infer(pts)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="rank"):
        channel.do_inference(InferRequest(tspec.name, {
            "points": np.zeros((1024, 4), np.float32), "num_points": np.zeros(1, np.int32),
        }))


def test_cli_second_iou_runs_on_cpu_and_prints_its_summary():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "triton_client_tpu_torch", "detect3d", "-m", "second_iou",
         "-i", "synthetic:2", "--device", "cpu", "--pc-range", ",".join(map(str, TINY_RANGE)),
         "--voxel-size", "0.5,0.5,0.5", "--score", "0.05"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["model"] == "second_iou" and summary["device"] == "cpu"
    assert summary["grid"] == [32, 32, 8] and summary["vfe"] == "scatter"
    assert summary["fused_stages"] == []  # "auto" fuses on CUDA only
    assert summary["scans"] == 2 and summary["detections"] > 0
    assert summary["kernel_launches"] == {
        "segment_mean": 0, "residual_decode_3d": 0, "suppress_pack_3d": 0,
    }
