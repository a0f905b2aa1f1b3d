"""The port's counterpart of ``jax.jit``: ``runtime/graphs.CapturedFunction``.

On the CPU the wrapper calls its function; the capture/replay logic
(keys, clones, the lock, the launch-count replay arithmetic, errors) is
held here with a stand-in backend that needs no card. The ``cuda``-marked
tests capture real CUDA graphs of every served path at a small size and
hold them bitwise to the eager body, with launch counts equal to eager
(``python -m pytest --noconftest -m cuda tests/test_torch_graphs.py`` on
the card; they import no JAX).
"""

from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from triton_client_tpu_torch.ops import cuda_build
from triton_client_tpu_torch.runtime.graphs import WARMUP_CALLS, CapturedFunction
from torch_threads import one_torch_thread  # noqa: F401


class StandIn:
    """Captures by running ``fn`` once under the launch recording (as a CUDA
    capture does: the launches are recorded, not counted); a replay
    recomputes the outputs into the static buffers with ``compute``, a
    body without the counter, as a graph replay runs no Python."""

    def __init__(self, compute, replay_sleep: float = 0.0) -> None:
        self.compute = compute
        self.replay_sleep = replay_sleep
        self.captures = 0
        self.warmups = 0
        self.active = 0
        self.max_active = 0

    def warmup(self, fn, inputs, times):
        for _ in range(times):
            self.warmups += 1
            fn(*inputs)

    def capture(self, fn, inputs, owner):
        self.captures += 1
        outputs = fn(*inputs)

        def replay():
            self.active += 1
            self.max_active = max(self.max_active, self.active)
            if self.replay_sleep:
                time.sleep(self.replay_sleep)
            for out, new in zip(outputs, self.compute(*inputs)):
                out.copy_(new)
            self.active -= 1

        return replay, outputs, 1024


def _compute(x, y):
    return (x * 2.0 + y, (x - y).sum(-1))


@pytest.fixture
def counter():
    return cuda_build.LaunchCounter()


def _fn_with(counter, launches_per_call=2):
    def fn(x, y):
        for _ in range(launches_per_call):
            counter.add()
        return _compute(x, y)

    return fn


def test_cpu_calls_pass_through_and_keys_count_shapes_and_dtypes(counter):
    captured = CapturedFunction(_fn_with(counter), "f")
    x, y = torch.ones(3, 4), torch.zeros(3, 4)
    out = captured(x, y)
    torch.testing.assert_close(out[0], _compute(x, y)[0], rtol=0, atol=0)
    captured(x + 1, y)  # same key
    captured(torch.ones(5, 4), torch.zeros(5, 4))  # new shape
    captured(x.double(), y.double())  # new dtype
    stats = captured.stats()
    assert stats == {"calls": 4, "captures": 0, "replays": 0, "pool_bytes": 0, "keys": 3}
    assert counter.count == 8  # every CPU call runs the function


def test_key_holds_shape_dtype_device_and_the_static_key():
    settings = {"route": "auto"}
    captured = CapturedFunction(lambda x: x, "f", static_key=lambda: settings["route"])
    x = torch.zeros(2, 3, dtype=torch.uint8)
    assert captured.key((x,)) == (((2, 3), torch.uint8, "cpu"), "auto")
    settings["route"] = "pallas"
    assert captured.key((x,)) != captured.key((x.float(),))
    assert captured.key((x,))[-1] == "pallas"


def test_stand_in_captures_once_per_key_and_replays_with_clones(counter):
    backend = StandIn(_compute)
    captured = CapturedFunction(_fn_with(counter), "f", backend=backend)
    xa, ya = torch.arange(8.0).reshape(2, 4), torch.ones(2, 4)
    xb, yb = -xa, 2 * ya
    a = captured(xa, ya)
    b = captured(xb, yb)
    # each call gets its own input's result, in buffers it owns
    for got, want in zip(a, _compute(xa, ya)):
        assert torch.equal(got, want)
    for got, want in zip(b, _compute(xb, yb)):
        assert torch.equal(got, want)
    assert a[0].data_ptr() != b[0].data_ptr()
    a2 = captured(xa, ya)
    assert all(torch.equal(p, q) for p, q in zip(a, a2))
    assert backend.captures == 1 and backend.warmups == WARMUP_CALLS
    stats = captured.stats()
    assert (stats["captures"], stats["replays"], stats["keys"]) == (1, 3, 1)
    assert stats["pool_bytes"] == 1024
    captured(torch.ones(3, 4), torch.ones(3, 4))
    assert captured.stats()["captures"] == 2


@pytest.mark.parametrize("calls", [1, 3, 7])
@pytest.mark.parametrize("per_call", [1, 2])
def test_replays_add_the_launches_the_capture_recorded(counter, calls, per_call):
    other = cuda_build.LaunchCounter()
    backend = StandIn(_compute)
    captured = CapturedFunction(_fn_with(counter, per_call), "f", backend=backend)
    x = torch.ones(2, 4)
    for _ in range(calls):
        captured(x, x)
    # the warmup calls ran the kernels for real; the capture recorded its
    # launches without counting them; each replay adds them
    assert counter.count == per_call * (WARMUP_CALLS + calls)
    assert other.count == 0


def test_recording_keeps_a_threads_launches_out_of_the_counts(counter):
    seen = []

    def other_thread():
        counter.add()  # not recorded: another thread's launch counts
        seen.append(counter.count)

    with cuda_build.recording() as rec:
        counter.add(3)
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
        with pytest.raises(RuntimeError, match="already open"):
            cuda_build.recording().__enter__()
    assert rec.record == {counter: 3}
    assert seen == [1] and counter.count == 1
    counter.add()
    assert counter.count == 2


def test_the_lock_serialises_copy_in_replay_and_clone_out(counter):
    backend = StandIn(_compute, replay_sleep=0.01)
    captured = CapturedFunction(_fn_with(counter), "f", backend=backend)
    inputs = [(torch.full((2, 4), float(i)), torch.ones(2, 4)) for i in range(6)]
    results = [None] * len(inputs)

    def call(i):
        results[i] = captured(*inputs[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(inputs))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert backend.max_active == 1
    for (x, y), got in zip(inputs, results):
        assert all(torch.equal(p, q) for p, q in zip(got, _compute(x, y)))


def test_a_failed_capture_raises_kernel_error_naming_the_function_and_key():
    class Broken(StandIn):
        def capture(self, fn, inputs, owner):
            raise RuntimeError("operation not permitted when stream is capturing")

    captured = CapturedFunction(lambda x: (x,), "yolov5n", backend=Broken(lambda x: (x,)))
    with pytest.raises(cuda_build.KernelError, match=r"yolov5n.*\(\(2,\), torch.float32"):
        captured(torch.zeros(2))
    assert captured.stats()["captures"] == 0


def test_a_failed_replay_raises_kernel_error():
    class Failing(StandIn):
        def capture(self, fn, inputs, owner):
            outputs = fn(*inputs)

            def replay():
                raise RuntimeError("device lost")

            return replay, outputs, 0

    captured = CapturedFunction(lambda x: (x,), "m", backend=Failing(lambda x: (x,)))
    with pytest.raises(cuda_build.KernelError, match="replaying"):
        captured(torch.zeros(2))


def test_dict_outputs_are_cloned_too(counter):
    def compute(x):
        return {"a": x + 1, "b": x * 3}

    class DictStandIn(StandIn):
        def capture(self, fn, inputs, owner):
            outputs = fn(*inputs)

            def replay():
                for k, v in compute(*inputs).items():
                    outputs[k].copy_(v)

            return replay, outputs, 0

    captured = CapturedFunction(compute, "d", backend=DictStandIn(compute))
    x = torch.arange(4.0)
    out = captured(x)
    assert set(out) == {"a", "b"} and torch.equal(out["b"], x * 3)
    out2 = captured(x + 1)
    assert torch.equal(out["a"], x + 1) and torch.equal(out2["a"], x + 2)


def test_the_capture_scope_wraps_warmup_and_capture_and_lives_with_the_graph(counter):
    """``capture_scope`` is entered once a key, around its warmup calls and
    its capture, and what it yields is kept with the key's graph."""
    import contextlib

    events = []

    class Recording(StandIn):
        def warmup(self, fn, inputs, times):
            events.append("warmup")
            super().warmup(fn, inputs, times)

        def capture(self, fn, inputs, owner):
            events.append("capture")
            return super().capture(fn, inputs, owner)

    @contextlib.contextmanager
    def scope():
        held = object()
        events.append(("enter", id(held)))
        yield held
        events.append("exit")

    captured = CapturedFunction(_fn_with(counter), "f", backend=Recording(_compute),
                                capture_scope=scope)
    x = torch.ones(2, 3)
    for _ in range(3):
        captured(x, x)
    captured(torch.ones(4, 3), torch.ones(4, 3))
    assert [e if isinstance(e, str) else e[0] for e in events] == [
        "enter", "warmup", "capture", "exit"] * 2
    keeps = [entry.keep for entry in captured._entries.values()]
    assert [id(k) for k in keeps] == [e[1] for e in events if not isinstance(e, str)]


def test_owned_tickets_are_one_a_thread_and_cleared():
    from triton_client_tpu_torch.ops import gpu_segment

    with gpu_segment.owned_tickets() as held:
        assert gpu_segment._owned.tickets is held and held.buf is None
        with pytest.raises(RuntimeError, match="already open"):
            with gpu_segment.owned_tickets():
                pass
        seen = []
        t = threading.Thread(target=lambda: seen.append(getattr(gpu_segment._owned, "tickets",
                                                                 None)))
        t.start()
        t.join()
        assert seen == [None]  # another thread's launches keep the per-stream buffers
    assert gpu_segment._owned.tickets is None


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: pytest -m cuda, chip_smoke.py)")
    cuda_build.build_all()
    return torch.device("cuda")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
    return torch.equal(a, b)


def _first_difference(got, want) -> str:
    """Where two outputs of one body first differ: the flat index, both
    values and their bit patterns, and how many elements differ."""
    g, w = got.detach().cpu().reshape(-1), want.detach().cpu().reshape(-1)
    if g.dtype == torch.float32:
        gb, wb = g.view(torch.int32), w.view(torch.int32)
    else:
        gb, wb = g, w
    diff = (gb != wb).nonzero().reshape(-1)
    i = int(diff[0])
    return (f"{len(diff)} of {g.numel()} elements differ; first at flat index {i} of shape "
            f"{tuple(got.shape)}: {g[i].item()!r} (bits {int(gb[i])}) against {w[i].item()!r} "
            f"(bits {int(wb[i])})")


def _assert_outputs_equal(got, want, label):
    for j, (g, e) in enumerate(zip(got, want)):
        assert _bits_equal(g, e), f"{label}, output {j}: {_first_difference(g, e)}"


def _counts():
    return [c.count for c in cuda_build.all_counters()]


def _hold_captured_to_eager(pipe, inputs_a, inputs_b, replays=3):
    """The captured body bitwise equal to the eager ``run`` on two inputs,
    and its launches through ``replays`` replays equal to as many eager calls."""
    pipe.run(*inputs_a)
    torch.cuda.synchronize()
    c0 = _counts()
    eager_a = pipe.run(*inputs_a)
    torch.cuda.synchronize()
    eager_launches = [b - a for a, b in zip(c0, _counts())]
    eager_b = pipe.run(*inputs_b)
    pipe._jit(*inputs_a)  # captures
    torch.cuda.synchronize()
    c0 = _counts()
    got_a = [pipe._jit(*inputs_a) for _ in range(replays)]
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(c0, _counts())] == [replays * n for n in eager_launches]
    got_b = pipe._jit(*inputs_b)
    for r, got in enumerate(got_a):
        _assert_outputs_equal(got, eager_a, f"replay {r} of input a")
    _assert_outputs_equal(got_b, eager_b, "input b")
    assert pipe.graph_stats()["captures"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("fused,route", [("auto", None), ("off", None), ("off", "pallas")])
@pytest.mark.parametrize("batch", [1, 3])
def test_2d_capture_equals_eager_bitwise_on_card(cuda_device, fused, route, batch):
    from triton_client_tpu_torch.pipelines.detect2d import Detect2DConfig, build_yolov5_pipeline

    cfg = Detect2DConfig(model_name="y", input_hw=(128, 128), num_classes=2,
                         conf_thresh=0.05, max_det=100, fused=fused)
    pipe, _, _ = build_yolov5_pipeline(num_classes=2, config=cfg, device="cuda", seed=0)
    rng = np.random.default_rng(batch)
    frames = [torch.from_numpy(rng.integers(0, 255, (batch, 96, 160, 3), dtype=np.uint8))
              .to(cuda_device) for _ in range(2)]
    old = os.environ.pop("TRITON_CLIENT_TPU_NMS", None)
    try:
        if route:
            os.environ["TRITON_CLIENT_TPU_NMS"] = route
        _hold_captured_to_eager(pipe, (frames[0],), (frames[1],))
    finally:
        os.environ.pop("TRITON_CLIENT_TPU_NMS", None)
        if old is not None:
            os.environ["TRITON_CLIENT_TPU_NMS"] = old


@pytest.mark.cuda
@pytest.mark.parametrize("fused,route", [("auto", None), ("off", None), ("off", "pallas")])
@pytest.mark.parametrize("family", ["yolov4", "retinanet", "fcos"])
def test_new_2d_families_capture_equals_eager_bitwise_on_card(cuda_device, family, fused, route):
    """YOLOv4 (width 0.25) and the detectron family (``resnet18``) at
    128x128: kernel 1 on the fused route (the scored head: multi-label
    xyxy, max_det 100), kernel 2 under the ``pallas`` route, the captured
    body bitwise equal to the eager one."""
    import dataclasses

    from triton_client_tpu_torch.pipelines import detect2d

    cfg = dataclasses.replace(detect2d.default_config(family, 3, (128, 128)), fused=fused,
                              conf_thresh=0.05 if family == "yolov4" else 0.0)
    extra = {"width": 0.25} if family == "yolov4" else {"depth": "resnet18"}
    pipe, _, _ = detect2d.BUILDERS_2D[family](num_classes=3, input_hw=(128, 128), config=cfg,
                                             device="cuda", seed=0, **extra)
    rng = np.random.default_rng(3)
    frames = [torch.from_numpy(rng.integers(0, 255, (2, 96, 160, 3), dtype=np.uint8))
              .to(cuda_device) for _ in range(2)]
    old = os.environ.pop("TRITON_CLIENT_TPU_NMS", None)
    try:
        if route:
            os.environ["TRITON_CLIENT_TPU_NMS"] = route
        _hold_captured_to_eager(pipe, (frames[0],), (frames[1],))
    finally:
        os.environ.pop("TRITON_CLIENT_TPU_NMS", None)
        if old is not None:
            os.environ["TRITON_CLIENT_TPU_NMS"] = old


TINY_3D = {"point_cloud_range": (0.0, -6.4, -3.0, 12.8, 6.4, 1.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["pointpillars", "second_iou"])
@pytest.mark.parametrize("fused", ["auto", "off"])
def test_3d_capture_equals_eager_bitwise_on_card(cuda_device, family, fused):
    import dataclasses

    from triton_client_tpu_torch.io.sources import SyntheticPointCloudSource
    from triton_client_tpu_torch.models.pointpillars import PointPillarsConfig
    from triton_client_tpu_torch.models.second import SECONDConfig
    from triton_client_tpu_torch.pipelines.detect3d import (
        BUILDERS_3D,
        Detect3DConfig,
        prepare_points,
    )

    base = SECONDConfig() if family == "second_iou" else PointPillarsConfig()
    size = (0.4, 0.4, 0.5) if family == "second_iou" else (0.2, 0.2, 4.0)
    voxel = dataclasses.replace(base.voxel, voxel_size=size, **TINY_3D)
    pipe, spec, model = BUILDERS_3D[family](
        model_cfg=dataclasses.replace(base, voxel=voxel),
        config=Detect3DConfig(model_name=family, fused=fused), device="cuda", seed=0,
    )
    inputs = []
    for seed in (1, 2):
        pc = next(iter(SyntheticPointCloudSource(1, points=20000, seed=seed))).data
        pc[:, 0] /= 5.0  # into the tiny range
        pc[:, 1] /= 6.0
        padded, m = prepare_points(pc, model.cfg.voxel.point_features, spec.extra["point_buckets"])
        inputs.append((torch.from_numpy(padded).to(cuda_device),
                       torch.tensor(m, dtype=torch.int32).to(cuda_device)))
    _hold_captured_to_eager(pipe, *inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["bf16", "int8w"])
@pytest.mark.parametrize("family", ["pointpillars", "second_iou", "centerpoint"])
def test_3d_capture_equals_eager_bitwise_under_each_policy_on_card(cuda_device, family, policy):
    """The bfloat16 body (bf16 convolutions, BatchNorm and the bf16 canvas's
    16-bit atomic max) and the int8 weights dequantized inside the graph:
    the captured body bitwise equal to the eager one, with equal launches.
    The anchor models on the tiny range of the test above, CenterPoint at
    full nuScenes width in its 131,072 bucket."""
    import dataclasses
    import pathlib

    from triton_client_tpu_torch.dataset_config import detect3d_from_yaml
    from triton_client_tpu_torch.models.pointpillars import PointPillarsConfig
    from triton_client_tpu_torch.models.second import SECONDConfig
    from triton_client_tpu_torch.pipelines.detect3d import (
        BUILDERS_3D,
        Detect3DConfig,
        prepare_points,
    )

    rng = np.random.default_rng(3)
    if family == "centerpoint":
        path = pathlib.Path(__file__).resolve().parent.parent / "data" / "nusc_centerpoint.yaml"
        _, model_cfg, cfg = detect3d_from_yaml(str(path))
        clouds = [np.column_stack([rng.uniform(-51.2, 51.2, (30000, 2)),
                                   rng.uniform(-5, 3, 30000), rng.uniform(0, 1, 30000),
                                   rng.integers(0, 10, 30000) * 0.05]) for _ in range(2)]
    else:
        base = SECONDConfig() if family == "second_iou" else PointPillarsConfig()
        size = (0.4, 0.4, 0.5) if family == "second_iou" else (0.2, 0.2, 4.0)
        model_cfg = dataclasses.replace(base, voxel=dataclasses.replace(
            base.voxel, voxel_size=size, **TINY_3D))
        cfg = Detect3DConfig(model_name=family)
        r = TINY_3D["point_cloud_range"]
        clouds = [np.column_stack([rng.uniform(r[0], r[3], 20000), rng.uniform(r[1], r[4], 20000),
                                   rng.uniform(r[2], r[5], 20000), rng.uniform(0, 1, 20000)])
                  for _ in range(2)]
    pipe, spec, model = BUILDERS_3D[family](model_cfg=model_cfg, config=cfg, device="cuda",
                                            seed=0, precision=policy)
    assert spec.extra["precision"] == policy
    inputs = []
    for pc in clouds:
        padded, m = prepare_points(pc.astype(np.float32), model.cfg.voxel.point_features,
                                   spec.extra["point_buckets"])
        inputs.append((torch.from_numpy(padded).to(cuda_device),
                       torch.tensor(m, dtype=torch.int32).to(cuda_device)))
    _hold_captured_to_eager(pipe, *inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", ["auto", "off"])
@pytest.mark.parametrize("points", [30000, 260000], ids=["bucket131072", "bucket262144"])
def test_centerpoint_capture_equals_eager_bitwise_on_card(cuda_device, points, fused):
    """Full-width nuScenes CenterPoint (data/nusc_centerpoint.yaml: the 512 x
    512 canvas, 5 features, buckets 131,072 and 262,144) on 5-column
    clouds over its range, at each bucket."""
    from triton_client_tpu_torch.dataset_config import detect3d_from_yaml
    from triton_client_tpu_torch.pipelines.detect3d import (
        build_centerpoint_pipeline,
        prepare_points,
    )

    import dataclasses
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "data" / "nusc_centerpoint.yaml"
    _, model_cfg, cfg = detect3d_from_yaml(str(path))
    pipe, spec, _ = build_centerpoint_pipeline(
        model_cfg=model_cfg, config=dataclasses.replace(cfg, fused=fused), device="cuda", seed=0)
    assert model_cfg.voxel.grid_size == (512, 512, 1)
    inputs = []
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        pc = np.column_stack([rng.uniform(-51.2, 51.2, (points, 2)), rng.uniform(-5, 3, points),
                              rng.uniform(0, 1, points), rng.integers(0, 10, points) * 0.05])
        padded, m = prepare_points(pc, 5, spec.extra["point_buckets"])
        inputs.append((torch.from_numpy(padded).to(cuda_device),
                       torch.tensor(m, dtype=torch.int32).to(cuda_device)))
    assert inputs[0][0].shape[0] == (131072 if points < 131072 else 262144)
    _hold_captured_to_eager(pipe, *inputs)


def _sparse_second_inputs(cuda_device, spec, points, seeds=(1, 2)):
    from triton_client_tpu_torch.io.sources import SyntheticPointCloudSource
    from triton_client_tpu_torch.pipelines.detect3d import prepare_points

    inputs = []
    for seed in seeds:
        pc = next(iter(SyntheticPointCloudSource(1, points=points, seed=seed))).data
        padded, m = prepare_points(pc, 4, spec.extra["point_buckets"])
        inputs.append((torch.from_numpy(padded).to(cuda_device),
                       torch.tensor(m, dtype=torch.int32).to(cuda_device)))
    return inputs


@pytest.mark.cuda
@pytest.mark.parametrize("fused", ["auto", "off"])
@pytest.mark.parametrize("points", [20000, 120000], ids=["bucket32768", "bucket131072"])
def test_sparse_second_capture_equals_eager_bitwise_on_card(cuda_device, points, fused):
    """SECOND-IoU's sparse middle at the reference's 0.05 m grid
    (data/kitti_second_sparse005.yaml, full width, seeded) on synthetic KITTI
    scans: the captured body bitwise equal to the eager one; an eager scan
    launches kernels 3 (gathered form) and 4 once on the fused route, no
    kernel on the unfused one, and kernel 5 never (no voxelize_scatter)."""
    import dataclasses
    import pathlib

    from triton_client_tpu_torch.dataset_config import detect3d_from_yaml
    from triton_client_tpu_torch.pipelines.detect3d import build_second_pipeline

    path = pathlib.Path(__file__).resolve().parent.parent / "data" / "kitti_second_sparse005.yaml"
    _, model_cfg, cfg = detect3d_from_yaml(str(path))
    pipe, spec, _ = build_second_pipeline(
        model_cfg=model_cfg, config=dataclasses.replace(cfg, fused=fused), device="cuda", seed=0)
    assert model_cfg.voxel.grid_size == (1408, 1600, 40)
    assert pipe.fused_stages == (("decode_nms",) if fused == "auto" else ())
    from triton_client_tpu_torch.ops import gpu_decode3d, gpu_suppress3d

    inputs = _sparse_second_inputs(cuda_device, spec, points)
    pipe.run(*inputs[0])
    torch.cuda.synchronize()
    c0 = _counts()
    k3, k3g, k4 = (c.count for c in (gpu_decode3d.launches, gpu_decode3d.gathered_launches,
                                      gpu_suppress3d.launches))
    pipe.run(*inputs[0])
    torch.cuda.synchronize()
    want = 1 if fused == "auto" else 0
    assert (gpu_decode3d.launches.count - k3, gpu_decode3d.gathered_launches.count - k3g,
            gpu_suppress3d.launches.count - k4) == (want, want, want)
    assert sum(b - a for a, b in zip(c0, _counts())) == 3 * want  # kernels 3 (twice) and 4 only
    _hold_captured_to_eager(pipe, *inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["bf16", "int8w"])
def test_sparse_second_capture_under_each_policy_on_card(cuda_device, policy):
    """The sparse middle's bfloat16 body and its int8 (k^3, cin, cout)
    weights dequantized inside the graph, at the tests' golden config: the
    captured body bitwise equal to the eager one."""
    from triton_client_tpu_torch.models.second import SECONDConfig
    from triton_client_tpu_torch.ops.voxelize import VoxelConfig
    from triton_client_tpu_torch.pipelines.detect3d import Detect3DConfig, build_second_pipeline

    model_cfg = SECONDConfig(
        voxel=VoxelConfig(point_cloud_range=(0.0, -12.8, -2.0, 25.6, 12.8, 2.0),
                          voxel_size=(0.4, 0.4, 0.5), max_voxels=2048, max_points_per_voxel=8),
        middle="sparse", sparse_budget=2048, sparse_dense_tail_from=2, middle_filters=(8, 8, 8),
        backbone_layers=(1,), backbone_strides=(1,), backbone_filters=(16,),
        upsample_strides=(1,), upsample_filters=(16,))
    pipe, spec, model = build_second_pipeline(
        model_cfg=model_cfg, config=Detect3DConfig(model_name="second_iou",
                                                   point_buckets=(8192,)),
        device="cuda", seed=0, precision=policy)
    assert spec.extra["precision"] == policy
    rng = np.random.default_rng(4)
    inputs = []
    for _ in range(2):
        pc = np.column_stack([rng.uniform(0, 25.6, 3000), rng.uniform(-12.8, 12.8, 3000),
                              rng.uniform(-1.8, 1.8, 3000), rng.uniform(0, 1, 3000)])
        padded = np.zeros((8192, 4), np.float32)
        padded[:3000] = pc
        inputs.append((torch.from_numpy(padded).to(cuda_device),
                       torch.tensor(3000, dtype=torch.int32).to(cuda_device)))
    _hold_captured_to_eager(pipe, *inputs)


@pytest.mark.cuda
def test_a_host_sync_in_the_body_fails_its_capture_on_card(cuda_device):
    def body(x):
        return (x * float(x.sum()),)  # float(): a host sync

    captured = CapturedFunction(body, "syncing")
    with pytest.raises(cuda_build.KernelError, match="syncing"):
        captured(torch.ones(4, device=cuda_device))
    # the card stays usable, its random generator too
    assert float(torch.ones(3, device=cuda_device).sum()) == 3.0
    assert torch.rand(3, device=cuda_device).shape == (3,)


def _yolo_channel(cuda_device, depth=2, sync_in_body=False):
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.pipelines.detect2d import Detect2DConfig, build_yolov5_pipeline
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    cfg = Detect2DConfig(model_name="y", input_hw=(128, 128), num_classes=2,
                         conf_thresh=0.05, max_det=100)
    pipe, spec, _ = build_yolov5_pipeline(num_classes=2, config=cfg, device="cuda", seed=0)
    body = pipe.device_fn()
    if sync_in_body:
        def device_fn(inputs):  # a readback inside the body: cannot be captured
            out = body(inputs)
            out["valid"] = out["valid"] & bool(out["valid"].any())
            return out
    else:
        device_fn = body
    repo = ModelRepository()
    repo.register(spec, pipe.infer_fn(), device_fn=device_fn)
    return pipe, CUDAChannel(repo, pipeline_depth=depth)


@pytest.mark.cuda
def test_two_requests_in_flight_get_their_own_outputs_on_card(cuda_device):
    from triton_client_tpu_torch.channel.base import InferRequest

    pipe, chan = _yolo_channel(cuda_device, depth=2)
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 255, (2, 96, 160, 3), dtype=np.uint8) for _ in range(3)]
    eager = [pipe.run(torch.from_numpy(f).to(cuda_device)) for f in frames]
    chan.do_inference(InferRequest("y", {"images": frames[0]}))  # captures
    for _ in range(3):
        futs = [chan.do_inference_async(InferRequest("y", {"images": f})) for f in frames]
        outs = [fut.result().outputs for fut in reversed(futs)][::-1]
        for out, (dets, valid) in zip(outs, eager):
            assert out["detections"].tobytes() == dets.cpu().numpy().tobytes()
            assert out["valid"].tobytes() == valid.cpu().numpy().tobytes()
    assert not all(np.array_equal(a[0].cpu().numpy(), b[0].cpu().numpy())
                   for a, b in zip(eager, eager[1:]))
    stats = chan.stats()
    assert max(stats["slot_occupancy"]) == 2 and stats["inflight"] == 0
    assert chan._launch_cache[("y", "1")][1].graphs.stats()["captures"] == 1


@pytest.mark.cuda
def test_a_device_fn_that_syncs_fails_its_capture_and_counts_a_launch_failure(cuda_device):
    from triton_client_tpu_torch.channel.base import InferRequest

    _, chan = _yolo_channel(cuda_device, sync_in_body=True)
    frames = np.zeros((1, 96, 160, 3), dtype=np.uint8)
    fut = chan.do_inference_async(InferRequest("y", {"images": frames}))
    with pytest.raises(cuda_build.KernelError, match="capturing a CUDA graph"):
        fut.result()
    stats = chan.stats()
    assert stats["launch_failures"] == 1 and stats["launched"] == 0
    assert stats["inflight"] == 0 and stats["slots_active"] == 0
    # no eager retry happened: the card stays usable and the next call fails again
    with pytest.raises(cuda_build.KernelError):
        chan.do_inference(InferRequest("y", {"images": frames}))
    assert chan.stats()["launch_failures"] == 2
    assert torch.rand(3, device=cuda_device).shape == (3,)


def _pool_channel(cuda_device, capture):
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.models.pool import register_pool
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    repo = ModelRepository()
    register_pool(repo, cuda_device)
    return CUDAChannel(repo, capture_ragged=capture)


def _packed_request(sizes, seed):
    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.parallel.ragged_kernels import RaggedLayout, pack_rows

    rng = np.random.default_rng(seed)
    layout = RaggedLayout(tuple(sizes))
    clouds = [rng.normal(0, 10, (n, 4)).astype(np.float32) for n in sizes]
    bias = rng.normal(0, 1, (layout.seg_bucket, 1, 4)).astype(np.float32)
    return InferRequest("pool", {"points": pack_rows(clouds, layout), "bias": bias},
                        ragged=layout)


@pytest.mark.cuda
def test_ragged_route_capture_equals_eager_bitwise_on_card(cuda_device):
    """The packed route through its graphs (one a segment bucket and
    packed-row bucket) equals the eager route bit for bit; each replay
    counts kernel 6's one launch; the graphs own their tickets, left at
    zero, and the per-stream buffers gain no entry from a capture."""
    from triton_client_tpu_torch.ops import gpu_segment

    captured, eager = _pool_channel(cuda_device, True), _pool_channel(cuda_device, False)
    groups = [(20_000, 120_000, 45_000), (3, 11, 8, 40, 5), (20_000, 119_000, 46_000),
              (7, 9), (20_000, 120_000, 45_000)]
    reqs = [_packed_request(sizes, seed) for seed, sizes in enumerate(groups)]
    for req in reqs:  # every graph captured before the counted window
        captured.do_inference(req)
    torch.cuda.synchronize()
    streams = set(gpu_segment._tickets_by_stream)
    gpu_segment.launches.reset()
    for _ in range(2):
        for req in reqs:
            got, want = captured.do_inference(req).outputs, eager.do_inference(req).outputs
            assert got["pooled"].tobytes() == want["pooled"].tobytes()
    assert gpu_segment.launches.count == 2 * 2 * len(reqs)  # replays and eager calls
    stats = captured.ragged_graph_stats()
    keys = {(r.ragged.seg_bucket, r.ragged.padded_rows) for r in reqs}
    assert sum(s["captures"] for s in stats.values()) == len(keys)
    assert sum(s["replays"] for s in stats.values()) == 3 * len(reqs)
    assert set(gpu_segment._tickets_by_stream) <= streams | {
        (cuda_device.index or 0, torch.cuda.current_stream().cuda_stream)}
    for launcher in (v[1] for k, v in captured._launch_cache.items() if k[2:3] == ("ragged",)):
        for entry in launcher.graphs._entries.values():
            assert entry.keep.buf is not None and int(entry.keep.buf.abs().sum()) == 0


@pytest.mark.cuda
def test_kernel6_captured_without_owned_tickets_raises_on_card(cuda_device):
    from triton_client_tpu_torch.ops import gpu_segment

    def body(values, ids):
        return (gpu_segment.segment_sum(values, ids, 4),)

    values = torch.ones(3000, 4, device=cuda_device)
    ids = torch.arange(3000, device=cuda_device, dtype=torch.int32) % 4
    bare = CapturedFunction(body, "bare")
    with pytest.raises(cuda_build.KernelError, match="no owned ticket buffer"):
        bare(values, ids)
    owned = CapturedFunction(body, "owned", capture_scope=gpu_segment.owned_tickets)
    assert torch.equal(owned(values, ids)[0], gpu_segment.segment_sum(values, ids, 4))
    assert torch.rand(3, device=cuda_device).shape == (3,)


def _fused_ensemble_repo(fuse: str):
    """preprocess (128x128) -> YOLOv5n 128x128 (conf 0.05, seeded) as an
    ensemble over members that serve through their ``infer_fn`` and offer
    their device forms aside, as disk entries do."""
    import dataclasses

    from triton_client_tpu_torch.pipelines.detect2d import Detect2DConfig, build_yolov5_pipeline
    from triton_client_tpu_torch.pipelines.preprocess2d import build_preprocess_pipeline
    from triton_client_tpu_torch.runtime.ensemble import EnsembleStep, build_ensemble
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    repo = ModelRepository()
    pre, spec, _ = build_preprocess_pipeline(input_hw=(128, 128), device="cuda")
    repo.register(dataclasses.replace(spec, name="pre"), pre.infer_fn(),
                  member_device_fn=pre.device_fn())
    cfg = Detect2DConfig(model_name="det", input_hw=(128, 128), num_classes=2,
                         conf_thresh=0.05, max_det=100)
    det, spec, _ = build_yolov5_pipeline(num_classes=2, config=cfg, device="cuda", seed=0)
    repo.register(spec, det.infer_fn(), member_device_fn=det.device_fn())
    steps = [EnsembleStep("pre", {"images": "raw"}, {"preprocessed": "frame"}),
             EnsembleStep("det", {"images": "frame"}, {"detections": "boxes", "valid": "valid"})]
    ens = build_ensemble(repo, "ens", steps, outputs=["boxes", "valid"], fuse=fuse, device="cuda")
    repo.register(ens.spec, ens.infer_fn, device_fn=ens.device_fn)
    return repo, ens


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3])
def test_fused_ensemble_capture_equals_eager_bitwise_on_card(cuda_device, batch):
    """The channel captures the fused DAG as one graph: each request replays
    exactly one kernel-1 launch and no other counted kernel, and its rows
    equal the eager composition's and the host path's bit for bit."""
    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.ops import gpu_decode

    repo, ens = _fused_ensemble_repo("always")
    host_repo, host = _fused_ensemble_repo("never")
    assert ens.spec.extra["data_path"] == "fused" and host.spec.extra["data_path"] == "host"
    rng = np.random.default_rng(batch)
    frames = [rng.integers(0, 255, (batch, 96, 160, 3), dtype=np.uint8) for _ in range(2)]
    chan, host_chan = CUDAChannel(repo), CUDAChannel(host_repo)
    eager = [ens.device_fn({"raw": torch.from_numpy(f).to(cuda_device)}) for f in frames]
    chan.do_inference(InferRequest("ens", {"raw": frames[0]}))  # captures
    torch.cuda.synchronize()
    k1 = list(cuda_build.all_counters()).index(gpu_decode.launches)
    c0 = _counts()
    got = [chan.do_inference(InferRequest("ens", {"raw": f})).outputs for f in frames * 2]
    torch.cuda.synchronize()
    delta = [b - a for a, b in zip(c0, _counts())]
    assert delta[k1] == len(got) and sum(delta) == len(got), delta
    graphs = chan._launch_cache[("ens", "1")][1].graphs.stats()
    assert graphs["captures"] == 1 and graphs["replays"] == 1 + len(got)
    for i, out in enumerate(got):
        want = eager[i % 2]
        _assert_outputs_equal((torch.from_numpy(out["boxes"]), torch.from_numpy(out["valid"])),
                              (want["boxes"].cpu(), want["valid"].cpu()), f"request {i}")
        hosted = host_chan.do_inference(InferRequest("ens", {"raw": frames[i % 2]})).outputs
        _assert_outputs_equal((torch.from_numpy(out["boxes"]), torch.from_numpy(out["valid"])),
                              (torch.from_numpy(hosted["boxes"]), torch.from_numpy(hosted["valid"])),
                              f"request {i} against the host path")
    assert any(int(out["valid"].sum()) > 0 for out in got)


@pytest.mark.cuda
def test_release_frees_the_graph_pool_on_card(cuda_device):
    """``release`` drops every key's graph: ``keys`` and ``pool_bytes`` read
    0, the pool's blocks go back to CUDA at ``graphs.empty_cache``
    (reserved falls by at least the pool's bytes), and the next call
    captures into a new pool and answers bitwise as before, with the
    replayed launches counted again."""
    from triton_client_tpu_torch.pipelines.detect2d import Detect2DConfig, build_yolov5_pipeline
    from triton_client_tpu_torch.runtime import graphs

    cfg = Detect2DConfig(model_name="y", input_hw=(256, 256), num_classes=2, conf_thresh=0.05,
                         max_det=100)
    pipe, _, _ = build_yolov5_pipeline(num_classes=2, config=cfg, device="cuda", seed=0)
    frames = torch.from_numpy(np.random.default_rng(5).integers(
        0, 255, (2, 256, 256, 3), dtype=np.uint8)).to(cuda_device)
    first = [t.clone() for t in pipe._jit(frames)]
    stats = pipe._jit.stats()
    assert stats["keys"] == 1 and stats["pool_bytes"] > 0
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_stats()["reserved_bytes.all.current"]
    pipe._jit.release()
    graphs.empty_cache()
    freed = reserved - torch.cuda.memory_stats()["reserved_bytes.all.current"]
    assert pipe._jit.stats()["keys"] == pipe._jit.stats()["pool_bytes"] == 0
    assert freed >= stats["pool_bytes"], (freed, stats["pool_bytes"])
    c0 = _counts()
    again = pipe._jit(frames)
    torch.cuda.synchronize()
    after = pipe._jit.stats()
    assert after["captures"] == 2 and after["keys"] == 1 and after["pool_bytes"] > 0
    assert sum(b - a for a, b in zip(c0, _counts())) == graphs.WARMUP_CALLS + 1
    _assert_outputs_equal(tuple(again), tuple(first), "after a release")
