"""The 3D slice end to end: the port's PointPillars pipeline, repository,
channel, driver adapter and CLI against the JAX package's, on the CPU
with the same carried weights and the same clouds.

The JAX side runs its Pallas kernels in interpret mode (``fused="on"``),
as tests/test_fused_parity.py does; the port's wrappers run the kernels'
plain versions on CPU tensors. Bar: equal live-row counts and labels,
boxes and scores within 1e-5 (the heads differ at the 1e-6 level and the
decode by XLA's FMA contraction; measured 2.4e-6).
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_client_tpu.ops import detect3d_postprocess as jpost
from triton_client_tpu.pipelines import detect3d as jdet

from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.drivers.driver import channel_infer3d
from triton_client_tpu_torch.io.sources import SyntheticPointCloudSource, open_source
from triton_client_tpu_torch.ops import detect3d_postprocess as tpost
from triton_client_tpu_torch.pipelines import detect3d as tdet
from triton_client_tpu_torch.runtime.repository import ModelRepository
from tests.test_torch_pointpillars import TINY_VOXEL, cloud, tiny_configs

ROOT = pathlib.Path(__file__).resolve().parent.parent
CFG = dict(point_buckets=(1024,), max_det=16, pre_max=64)


def _build_pair(fused):
    jcfg, tcfg = tiny_configs()
    jpipe, jspec, variables = jdet.build_pointpillars_pipeline(
        jax.random.PRNGKey(0), model_cfg=jcfg, config=jdet.Detect3DConfig(fused=fused, **CFG)
    )
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    tpipe, tspec, _ = tdet.build_pointpillars_pipeline(
        model_cfg=tcfg, config=tdet.Detect3DConfig(fused=fused, **CFG), variables=variables,
        device="cpu",
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
    pts = cloud(seed, 500)
    got, want = tpipe.infer(pts), jpipe.infer(pts)
    _assert_close(got, want)
    assert 0 < len(got["pred_scores"]) <= CFG["max_det"]
    assert got["pred_labels"].dtype == np.int32 and got["pred_labels"].min() >= 1


def test_pipeline_empty_cloud(pair):
    jpipe, _, tpipe, _ = pair
    empty = np.zeros((0, 4), np.float32)
    got = tpipe.infer(empty)
    assert got["pred_boxes"].shape[1] == 7
    _assert_close(got, jpipe.infer(empty))


def test_spec_matches_detect3d_spec(pair):
    _, jspec, _, tspec = pair
    assert (tspec.name, tspec.version) == (jspec.name, jspec.version)
    assert tspec.platform == "torch"
    for got, want in zip(tspec.inputs + tspec.outputs, jspec.inputs + jspec.outputs):
        assert (got.name, got.shape, got.dtype) == (want.name, want.shape, want.dtype)
    assert len(tspec.inputs + tspec.outputs) == len(jspec.inputs + jspec.outputs)
    for key, value in tspec.extra.items():
        assert jspec.extra[key] == value, key


def test_fused_and_unfused_routes_equal_by_value():
    """The fused rows carry +0.0 where the gathered rows may carry -0.0:
    equal by value, as torch.equal compares."""
    _, tcfg = tiny_configs()
    pipes = {
        f: tdet.build_pointpillars_pipeline(
            model_cfg=tcfg, config=tdet.Detect3DConfig(fused=f, **CFG), device="cpu", seed=3
        )[0]
        for f in ("on", "off")
    }
    assert pipes["on"].fused_stages == ("decode_nms",) and pipes["off"].fused_stages == ()
    for seed in range(3):
        padded, m = tdet.prepare_points(cloud(10 + seed, 600), 4, (1024,))
        rows = {
            f: p.run(torch.from_numpy(padded), torch.tensor(m, dtype=torch.int32))
            for f, p in pipes.items()
        }
        assert torch.equal(rows["on"][1], rows["off"][1]) and bool(rows["on"][1].any())
        assert torch.equal(rows["on"][0], rows["off"][0])


def test_vfe_routes_agree_below_the_budget_and_unknown_modes_fail():
    _, tcfg = tiny_configs()
    auto, _, model = tdet.build_pointpillars_pipeline(
        model_cfg=tcfg, config=tdet.Detect3DConfig(**CFG), device="cpu"
    )
    grouped = tdet.Detect3DPipeline(tdet.Detect3DConfig(vfe="grouped", **CFG), model, "cpu")
    assert auto.use_scatter and not grouped.use_scatter
    pts = cloud(5, 400)
    a, g = auto.infer(pts), grouped.infer(pts)
    np.testing.assert_array_equal(a["pred_labels"], g["pred_labels"])
    np.testing.assert_allclose(a["pred_boxes"], g["pred_boxes"], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="unknown vfe mode"):
        tdet.Detect3DPipeline(tdet.Detect3DConfig(vfe="nope"), model, "cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_extract_boxes_3d_matches_jax(fused):
    """The full-decode tail (gate + top-k + rotated NMS over every anchor)
    on the same boxes and scores."""
    rng = np.random.default_rng(8)
    centers = rng.uniform([0, -20], [40, 20], (24, 2))
    n = 400
    boxes = np.column_stack(
        [centers[rng.integers(0, 24, n)] + rng.normal(0, 1.0, (n, 2)),
         rng.uniform(-2, 0, n), rng.uniform(1, 4, n), rng.uniform(0.5, 2, n),
         rng.uniform(1, 2, n), rng.uniform(-np.pi, np.pi, n)]
    ).astype(np.float32)[None]
    scores = rng.uniform(0, 1, (1, n, 3)).astype(np.float32)
    kw = dict(score_thresh=0.3, iou_thresh=0.1, max_det=128, pre_max=128)
    want_rows, want_valid = jpost.extract_boxes_3d(
        jnp.asarray(boxes), jnp.asarray(scores), fused=fused, interpret=True, **kw
    )
    rows, valid = tpost.extract_boxes_3d(torch.from_numpy(boxes), torch.from_numpy(scores),
                                         fused=fused, **kw)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    assert 5 < int(valid.sum()) < 128  # suppression did real work


def test_channel_round_trip_through_channel_infer3d(pair):
    _, _, tpipe, tspec = pair
    repo = ModelRepository()
    repo.register(tspec, tpipe.infer_fn())
    channel = CUDAChannel(repo, device="cpu")
    channel.register_channel()
    infer = channel_infer3d(channel, tspec.name)
    for seed in (0, 4):
        pts = cloud(seed, 700)
        got, want = infer(pts), tpipe.infer(pts)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the 0-d num_points survives staging with its shape
    with pytest.raises(ValueError, match="rank"):
        from triton_client_tpu_torch.channel.base import InferRequest

        channel.do_inference(InferRequest(tspec.name, {
            "points": np.zeros((1024, 4), np.float32), "num_points": np.zeros(1, np.int32),
        }))


def test_prepare_points_buckets_and_z_offset():
    pts = np.arange(30, dtype=np.float32).reshape(10, 3)
    padded, m = tdet.prepare_points(pts, 4, (8, 16), z_offset=1.5)
    assert padded.shape == (16, 4) and m == 10 and padded.dtype == np.float32
    np.testing.assert_array_equal(padded[:10, 2], pts[:, 2] + 1.5)
    assert not padded[:10, 3].any() and not padded[10:].any()
    padded, m = tdet.prepare_points(np.ones((40, 5), np.float32), 4, (8, 16))
    assert padded.shape == (16, 4) and m == 16  # past the largest bucket: tail dropped


def test_point_cloud_sources(tmp_path):
    from triton_client_tpu.io.sources import SyntheticPointCloudSource as JSource

    got = [f.data for f in SyntheticPointCloudSource(2, points=500, seed=3)]
    want = [f.data for f in JSource(2, points=500, seed=3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(open_source("synthetic:5", limit=2, kind="pointcloud")) == 2
    for i, g in enumerate(got):
        np.save(tmp_path / f"{i:03d}.npy", g)
    src = open_source(str(tmp_path), kind="pointcloud")
    assert len(src) == 2
    np.testing.assert_array_equal(next(iter(src)).data, got[0])


def test_cli_runs_on_cpu_and_prints_its_summary():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = TINY_VOXEL["point_cloud_range"]
    out = subprocess.run(
        [sys.executable, "-m", "triton_client_tpu_torch", "detect3d", "-i", "synthetic:2",
         "--device", "cpu", "--pc-range", ",".join(map(str, r)), "--voxel-size", "0.2,0.2,4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["scans"] == 2 and summary["device"] == "cpu"
    assert summary["grid"] == [64, 64, 1] and summary["vfe"] == "scatter"
    assert summary["detections"] > 0
    assert summary["kernel_launches"] == {
        "segment_mean": 0, "residual_decode_3d": 0, "suppress_pack_3d": 0,
    }
