"""Package rules of the PyTorch/CUDA port: it imports nothing of JAX or
of the JAX package, its entry points refuse to run on the CPU unless
asked, and its kernels build for Hopper with the flags their bitwise
contract needs."""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from triton_client_tpu_torch.ops import cuda_build
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent

_BLOCKER = r"""
import importlib, json, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "yaml", "ml_dtypes", "triton_client_tpu", "grpc", "google",
           "msgpack", "onnx", "cv2", "PIL", "prometheus_client", "lz4", "rospy", "cv_bridge",
           "open3d")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"the port must not import {name}")
        return None

sys.meta_path.insert(0, Blocker())
import triton_client_tpu_torch as pkg

names = [pkg.__name__] + [
    m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
]
for name in names:
    importlib.import_module(name)
print(json.dumps(sorted(names)))
"""


def test_no_module_imports_jax_flax_yaml_or_the_jax_package():
    """Also grpc, protobuf, msgpack and onnx: every module imports on a host
    without them (grpc is imported where a socket opens; the weight readers
    parse msgpack and ONNX bytes themselves); and the optional packages of
    replay and display (cv2, PIL, prometheus_client, lz4, rospy, cv_bridge,
    open3d), which are imported inside the functions that use them."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    names = json.loads(out.stdout.strip().splitlines()[-1])
    for must in (
        "triton_client_tpu_torch.pipelines.detect2d",
        "triton_client_tpu_torch.channel.cuda_channel",
        "triton_client_tpu_torch.ops.gpu_decode",
        "triton_client_tpu_torch.ops.gpu_nms",
        "triton_client_tpu_torch.cli.detect2d",
        "triton_client_tpu_torch.__main__",
        "triton_client_tpu_torch.pipelines.detect3d",
        "triton_client_tpu_torch.models.pointpillars",
        "triton_client_tpu_torch.ops.gpu_decode3d",
        "triton_client_tpu_torch.ops.gpu_suppress3d",
        "triton_client_tpu_torch.drivers.driver",
        "triton_client_tpu_torch.cli.detect3d",
        "triton_client_tpu_torch.models.second",
        "triton_client_tpu_torch.ops.sparse_conv",
        "triton_client_tpu_torch.ops.gpu_voxel",
        "triton_client_tpu_torch.ops.gpu_segment",
        "triton_client_tpu_torch.parallel.ragged_kernels",
        "triton_client_tpu_torch.runtime.padding",
        "triton_client_tpu_torch.runtime.admission",
        "triton_client_tpu_torch.runtime.faults",
        "triton_client_tpu_torch.runtime.batching",
        "triton_client_tpu_torch.runtime.continuous",
        "triton_client_tpu_torch.obs.trace",
        "triton_client_tpu_torch.obs.collector",
        "triton_client_tpu_torch.obs.histogram",
        "triton_client_tpu_torch.obs.history",
        "triton_client_tpu_torch.obs.http",
        "triton_client_tpu_torch.obs.sampler",
        "triton_client_tpu_torch.obs.slo",
        "triton_client_tpu_torch.models.pool",
        "triton_client_tpu_torch.ops.mask_scan",
        "triton_client_tpu_torch.channel.kserve.pb",
        "triton_client_tpu_torch.channel.kserve.codec",
        "triton_client_tpu_torch.channel.kserve.service",
        "triton_client_tpu_torch.channel.grpc_channel",
        "triton_client_tpu_torch.runtime.server",
        "triton_client_tpu_torch.runtime.disk_repository",
        "triton_client_tpu_torch.dataset_config",
        "triton_client_tpu_torch.yaml_subset",
        "triton_client_tpu_torch.obs.logs",
        "triton_client_tpu_torch.cli.serve",
        "triton_client_tpu_torch.runtime.precision",
        "triton_client_tpu_torch.runtime.checkpoint",
        "triton_client_tpu_torch.runtime.importers",
        "triton_client_tpu_torch.runtime.onnx_reader",
        "triton_client_tpu_torch.runtime.flax_msgpack",
        "triton_client_tpu_torch.eval.detection_map",
        "triton_client_tpu_torch.channel.transport",
        "triton_client_tpu_torch.runtime.shared_memory",
        "triton_client_tpu_torch.runtime.wire_encoding",
        "triton_client_tpu_torch.obs.profiling",
        "triton_client_tpu_torch.cli.common",
        "triton_client_tpu_torch.models.centerpoint",
        "triton_client_tpu_torch.ops.sweeps",
        "triton_client_tpu_torch.io.bag_io",
        "triton_client_tpu_torch.io.rosbag",
        "triton_client_tpu_torch.io.sources",
        "triton_client_tpu_torch.io.sinks",
        "triton_client_tpu_torch.io.synthdata",
        "triton_client_tpu_torch.io.draw",
        "triton_client_tpu_torch.io.draw3d",
        "triton_client_tpu_torch.io.viz3d",
        "triton_client_tpu_torch.eval.prometheus_export",
        "triton_client_tpu_torch.cli.evaluate",
        "triton_client_tpu_torch.cli.tools",
        "triton_client_tpu_torch.drivers.ros",
        "triton_client_tpu_torch.models.retinanet",
        "triton_client_tpu_torch.models.yolov4",
        "triton_client_tpu_torch.models.layers",
        "triton_client_tpu_torch.ops.anchor_decode",
        "triton_client_tpu_torch.ops.detect_postprocess",
        "triton_client_tpu_torch.models.convert",
        "triton_client_tpu_torch.pipelines.preprocess2d",
        "triton_client_tpu_torch.runtime.ensemble",
        "triton_client_tpu_torch.utils.loadgen",
        "triton_client_tpu_torch.runtime.router",
        "triton_client_tpu_torch.obs.roofline",
        "triton_client_tpu_torch.obs.device_time",
        "triton_client_tpu_torch.obs.opstats",
    ):
        assert must in names


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_default_device_entry_points_raise_without_cuda(no_cuda):
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.models.pool import PoolModel
    from triton_client_tpu_torch.pipelines.detect2d import build_yolov5_pipeline
    from triton_client_tpu_torch.pipelines.detect3d import (
        build_pointpillars_pipeline,
        build_second_pipeline,
    )
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_yolov5_pipeline(num_classes=2, input_hw=(64, 64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUDAChannel(ModelRepository())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_pointpillars_pipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_second_pipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PoolModel()
    for argv in (["detect2d", "-i", "synthetic:1", "--input-size", "64"],
                 ["detect3d", "-i", "synthetic:1"],
                 ["detect3d", "-m", "second_iou", "-i", "synthetic:1"],
                 ["serve", "--model-repository", "examples"]):
        out = subprocess.run(
            [sys.executable, "-m", "triton_client_tpu_torch", *argv],
            cwd=ROOT, capture_output=True, text=True, timeout=120,
        )
        assert out.returncode != 0 and "no CUDA device" in out.stderr, argv


def test_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """Tensors anywhere but the CPU never reach the plain version: a
    wrapper launches its kernel on CUDA or raises."""
    from triton_client_tpu_torch.ops import gpu_decode, gpu_nms

    boxes, scores = torch.zeros(1, 8, 4, device="meta"), torch.zeros(1, 8, device="meta")
    with pytest.raises(ValueError, match="nms_greedy"):
        gpu_nms.nms_greedy(boxes, scores)
    with pytest.raises(ValueError, match="fused_decode_nms_2d"):
        gpu_decode.fused_decode_nms_2d(boxes, scores, scores, scores.bool())
    with pytest.raises(ValueError, match="nms_greedy"):  # mixed devices
        gpu_nms.nms_greedy(torch.zeros(1, 8, 4), scores)


def test_3d_wrappers_take_the_plain_version_only_for_cpu_tensors():
    from triton_client_tpu_torch.ops import gpu_decode3d, gpu_suppress3d

    d7, bins = torch.zeros(1, 8, 7, device="meta"), torch.zeros(1, 8, dtype=torch.int64,
                                                                device="meta")
    with pytest.raises(ValueError, match="fused_residual_decode"):
        gpu_decode3d.fused_residual_decode(d7, d7, bins)
    with pytest.raises(ValueError, match="fused_residual_decode"):  # mixed devices
        gpu_decode3d.fused_residual_decode(torch.zeros(1, 8, 7), d7, bins)
    iou, rows = torch.zeros(1, 8, 8, device="meta"), torch.zeros(1, 8, 9, device="meta")
    with pytest.raises(ValueError, match="suppress_pack_3d"):
        gpu_suppress3d.suppress_pack_3d(iou, rows)
    with pytest.raises(ValueError, match="suppress_pack_3d"):
        gpu_suppress3d.fused_suppress_pack_3d(d7, bins.float(), bins)
    with pytest.raises(ValueError, match="suppress_pack_3d"):  # mixed devices
        gpu_suppress3d.suppress_pack_3d(torch.zeros(1, 8, 8), rows)


def test_build_command_targets_hopper_with_exact_float_rules():
    cmd = cuda_build.build_command("greedy_nms.cu", pathlib.Path("/tmp/x.so"))
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "--fmad=false" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert "-shared" in cmd and "-fPIC" in cmd
    assert set(cuda_build.SOURCES) == {
        p.name for p in (ROOT / "triton_client_tpu_torch" / "csrc").glob("*.cu")
    } == {
        "decode_nms_2d.cu", "greedy_nms.cu", "residual_decode_3d.cu", "suppress_pack_3d.cu",
        "segment_mean.cu", "segment_sum.cu",
    }


def test_build_and_launch_failures_are_kernel_errors(monkeypatch, tmp_path):
    """The batchers let a KernelError fail its group instead of falling
    back, so every build, load and launch failure must be one."""
    cuda_build.check_launch("segment_sum", 0)
    with pytest.raises(cuda_build.KernelError, match="error 9"):
        cuda_build.check_launch("segment_sum", 9)
    monkeypatch.setattr(cuda_build, "nvcc", lambda: "false")  # a compiler that always fails
    monkeypatch.setattr(cuda_build, "library_path", lambda src: tmp_path / f"lib{src}.so")
    with pytest.raises(cuda_build.KernelError, match="nvcc segment_sum.cu failed"):
        cuda_build.build_all(("segment_sum.cu",))
    assert issubclass(cuda_build.KernelError, RuntimeError)
    assert not list(tmp_path.iterdir())  # no half-built library is left
