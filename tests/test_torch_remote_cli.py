"""The port's detect CLIs as remote clients of its ``serve``, on the CPU.

A tiny repository (a 64x64 YOLOv5n with a seeded ``weights.pt``, a 64 x 64
pillar PointPillars and a 64 x 64 pillar CenterPoint with velocity, each
with a seeded ``weights.pth``, det3d-named with a shared-conv bias for
CenterPoint) is served by
``cli/serve.build_server`` on loopback and a unix socket. ``detect2d`` and
``detect3d -u grpc:`` over the wire (``--no-shm``), shared memory
(``--shm``) and the unix socket (``grpc:unix:``, auto -> shm) write the
same ``detections.jsonl`` rows, bit for bit, as the in-process run with
``-r`` on the same frames and weights; each report names its transport.
CenterPoint's rows carry ``pred_velocities`` through ``--sweeps 3 --poses``
(aggregated on the client). ``--streaming``, the JAX CLI's remote-mode guards, the ``--repo``
conflict and kind guards, the refusals that name their ROADMAP item (and
the replay options that named item 6, now run),
``--profile`` and ``--profile-trace`` are covered, and the ``--gt``
summary equals the JAX package's evaluator fed the same detections and
ground truth.
"""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import types

import numpy as np
import pytest
import torch

from triton_client_tpu.eval.detection_map import Detection3DEvaluator as JDetection3DEvaluator
from triton_client_tpu.eval.detection_map import DetectionEvaluator as JDetectionEvaluator

from triton_client_tpu_torch.cli import detect2d, detect3d, serve
from triton_client_tpu_torch.models.layers import init_random_
from triton_client_tpu_torch.models.yolov5 import YoloV5
from triton_client_tpu_torch.runtime import importers
from triton_client_tpu_torch.runtime.disk_repository import _Entry
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG_2D = f"""family: yolov5
model:
  variant: n
  input_hw: [64, 64]
pipeline:
  class_names_file: {ROOT}/data/crop.names
  conf_thresh: 0.05
max_batch_size: 8
"""
CONFIG_3D = """family: pointpillars
model:
  voxel:
    point_cloud_range: [0.0, -6.4, -3.0, 12.8, 6.4, 1.0]
    voxel_size: [0.2, 0.2, 4.0]
    max_voxels: 512
    max_points_per_voxel: 8
  backbone_layers: [1, 1, 1]
pipeline:
  point_buckets: [1024, 4096]
  score_thresh: 0.05
  max_det: 16
  pre_max: 64
max_batch_size: 1
"""
CONFIG_CP = """family: centerpoint
model:
  voxel:
    point_cloud_range: [-6.4, -6.4, -5.0, 6.4, 6.4, 3.0]
    voxel_size: [0.2, 0.2, 8.0]
    max_voxels: 512
    max_points_per_voxel: 8
    point_features: 5
  backbone_layers: [1, 1, 1]
  backbone_filters: [16, 32, 64]
  upsample_filters: [16, 16, 16]
  vfe_filters: 16
  head_width: 16
  max_objects: 32
pipeline:
  point_buckets: [1024, 4096]
  iou_thresh: 0.2
  max_det: 16
max_batch_size: 1
"""
FRAMES = ["-i", "synthetic:5:48x80"]


def _det3d_state(model) -> dict:
    """A seeded CenterPoint's weights under det3d's names, with a shared-conv
    bias that the importer folds back into the BN mean it was added to."""
    state = {importers.centerpoint_torch_key(k): v.clone() for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    bias = torch.linspace(-0.1, 0.1, model.cfg.head_width)
    state["bbox_head.shared_conv.0.bias"] = bias
    state["bbox_head.shared_conv.1.running_mean"] += bias
    return state


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(server, repo root, clouds dir, tmp root): the tiny repository behind
    ``serve``, listening on loopback and ``--uds auto``."""
    tmp = tmp_path_factory.mktemp("remote")
    repo = tmp / "repo"
    (repo / "tiny2d" / "1").mkdir(parents=True)
    (repo / "tiny2d" / "config.yaml").write_text(CONFIG_2D)
    model = init_random_(YoloV5(num_classes=2, variant="n"), 3)
    torch.save({"model": {importers.yolov5_torch_key(k): v for k, v in model.state_dict().items()
                          if not k.endswith("num_batches_tracked")}},
               repo / "tiny2d" / "1" / "weights.pt")
    (repo / "tiny3d" / "1").mkdir(parents=True)
    (repo / "tiny3d" / "config.yaml").write_text(CONFIG_3D)
    _, _, model3 = _Entry(repo / "tiny3d", device="cpu")._build()  # seeded
    torch.save({"model_state": {importers.pointpillars_torch_key(k): v
                                for k, v in model3.state_dict().items()
                                if not k.endswith("num_batches_tracked")}},
               repo / "tiny3d" / "1" / "weights.pth")
    (repo / "tinycp" / "1").mkdir(parents=True)
    (repo / "tinycp" / "config.yaml").write_text(CONFIG_CP)
    _, _, model_cp = _Entry(repo / "tinycp", device="cpu")._build()  # seeded
    torch.save({"state_dict": _det3d_state(model_cp)}, repo / "tinycp" / "1" / "weights.pth")
    clouds = tmp / "clouds"
    clouds.mkdir()
    rng = np.random.default_rng(0)
    for i, n in enumerate((800, 1500, 600)):
        pc = np.column_stack([rng.uniform(0, 12.8, n), rng.uniform(-6.4, 6.4, n),
                              rng.uniform(-3, 1, n), rng.uniform(0, 1, n)]).astype(np.float32)
        np.save(clouds / f"{i:03d}.npy", pc)
    (tmp / "sweeps").mkdir()
    with open(tmp / "poses.jsonl", "w") as f:
        for i, n in enumerate((500, 700, 400, 900)):
            pc = np.column_stack([rng.uniform(-6.4, 6.4, (n, 2)), rng.uniform(-5, 3, n),
                                  rng.uniform(0, 1, n)]).astype(np.float32)
            np.save(tmp / "sweeps" / f"{i:03d}.npy", pc)
            yaw = 0.02 * i
            f.write(json.dumps({"frame_id": i, "pose": [0.4 * i, 0.0, 0.0, 0.0, 0.0,
                                                        np.sin(yaw / 2), np.cos(yaw / 2)]}) + "\n")
    args = serve.parser().parse_args(["-r", str(repo), "-a", "127.0.0.1:0", "--device", "cpu",
                                      "--max-workers", "4"])
    with contextlib.redirect_stdout(io.StringIO()):
        server = serve.build_server(args)
    server.start()
    yield server, repo, clouds, tmp
    server.stop()


def run(cli, argv, out: pathlib.Path):
    """``cli.main`` with a jsonl sink into ``out`` -> (report, rows without
    their wall-clock ``ts``)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main([*argv, "--sink", "jsonl", "-o", str(out)])
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    rows = [{k: v for k, v in json.loads(line).items() if k != "ts"}
            for line in open(out / "detections.jsonl")]
    return report, rows


def _remote(server, transport):
    return {
        "wire": ["-u", f"grpc:127.0.0.1:{server.port}", "--no-shm"],
        "shm": ["-u", f"grpc:127.0.0.1:{server.port}", "--shm"],
        "uds": ["-u", f"grpc:{server.uds_address}"],
    }[transport]


WANT_TRANSPORT = {"wire": "grpc", "shm": "shm", "uds": "uds+shm"}
_LOCAL: dict = {}


def _local(cli, served, argv, tag):
    """The in-process ``-r`` run of ``argv``, once a module."""
    if tag not in _LOCAL:
        _, repo, _, tmp = served
        _LOCAL[tag] = run(cli, [*argv, "-r", str(repo), "--device", "cpu"], tmp / f"local_{tag}")
    return _LOCAL[tag]


@pytest.mark.parametrize("flags", [[], ["-b", "2"], ["--async", "--inflight", "2"]],
                         ids=["b1", "b2", "async"])
@pytest.mark.parametrize("transport", ["wire", "shm", "uds"])
def test_detect2d_remote_equals_in_process(served, tmp_path, transport, flags):
    server = served[0]
    argv = ["-m", "tiny2d", *FRAMES, *flags]
    want_report, want = _local(detect2d, served, argv, "2d_" + "_".join(flags))
    report, got = run(detect2d, [*argv, *_remote(server, transport)], tmp_path)
    assert report["transport"] == WANT_TRANSPORT[transport]
    assert [r["frame_id"] for r in got] == list(range(5))
    assert got == want
    assert report["detections"] == want_report["detections"] > 0
    assert report["driver"]["frames"] == 5 and report["driver"]["ticks"] == \
        want_report["driver"]["ticks"]
    assert "kernel_launches" not in report  # the client launches nothing
    assert server.shm_registry.status() == {}  # the client unregistered on close


@pytest.mark.parametrize("transport", ["wire", "shm", "uds"])
def test_detect2d_streaming_equals_in_process(served, tmp_path, transport):
    argv = ["-m", "tiny2d", *FRAMES]
    _, want = _local(detect2d, served, argv, "2d_")
    report, got = run(detect2d, [*argv, *_remote(served[0], transport), "--streaming"], tmp_path)
    assert report["streaming"] is True and report["driver"]["frames"] == 5
    assert report["transport"] == WANT_TRANSPORT[transport]
    assert got == want


@pytest.mark.parametrize("flags", [[], ["--async"]], ids=["sync", "async"])
@pytest.mark.parametrize("transport", ["wire", "shm", "uds"])
def test_detect3d_remote_equals_in_process(served, tmp_path, transport, flags):
    server, _, clouds, _ = served
    argv = ["-m", "tiny3d", "-i", str(clouds), *flags]
    want_report, want = _local(detect3d, served, argv, "3d_" + "_".join(flags))
    report, got = run(detect3d, [*argv, *_remote(server, transport)], tmp_path)
    assert report["transport"] == WANT_TRANSPORT[transport]
    assert got == want and len(got) == 3
    assert report["detections"] == want_report["detections"] > 0
    assert report["scans"] == 3


@pytest.mark.parametrize("transport", ["wire", "shm", "uds"])
def test_centerpoint_sweeps_remote_equals_in_process(served, tmp_path, transport):
    """CenterPoint behind serve: the client aggregates 3 sweeps with their
    poses on a 0.05 s replay clock and sends 5-column clouds; the rows,
    ``pred_velocities`` included, equal the in-process -r run's bit for
    bit."""
    server, _, _, tmp = served
    argv = ["-m", "tinycp", "-i", str(tmp / "sweeps"), "--sweeps", "3", "--poses",
            str(tmp / "poses.jsonl"), "--scan-period", "0.05"]
    want_report, want = _local(detect3d, served, argv, "cp_sweeps")
    report, got = run(detect3d, [*argv, *_remote(server, transport)], tmp_path)
    assert report["transport"] == WANT_TRANSPORT[transport]
    assert got == want and len(got) == 4
    assert all(len(r["pred_velocities"]) == len(r["pred_scores"]) for r in got)
    assert report["detections"] == want_report["detections"] > 0
    assert want_report["sweeps"] == 3


def test_a_separate_client_process_equals_in_process(served, tmp_path):
    """``python -m triton_client_tpu_torch detect2d -u grpc:unix:...`` as its
    own process, as a robot's client runs."""
    argv = ["-m", "tiny2d", *FRAMES]
    _, want = _local(detect2d, served, argv, "2d_")
    out = subprocess.run(
        [sys.executable, "-m", "triton_client_tpu_torch", "detect2d", *argv, "-u",
         f"grpc:{served[0].uds_address}", "--sink", "jsonl", "-o", str(tmp_path)],
        cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1])["transport"] == "uds+shm"
    got = [{k: v for k, v in json.loads(line).items() if k != "ts"}
           for line in open(tmp_path / "detections.jsonl")]
    assert got == want


def _gt_2d(rows, path):
    """Ground truth near the detections, one class flipped a frame."""
    with open(path, "w") as f:
        for r in rows:
            dets = np.asarray(r["detections"])[np.asarray(r["valid"])][:6]
            boxes = np.column_stack([dets[:, :4] + 0.7, dets[:, 5]])
            boxes[:1, 4] = 1 - boxes[:1, 4]
            f.write(json.dumps({"frame_id": r["frame_id"], "boxes": boxes.tolist()}) + "\n")


@pytest.mark.parametrize("where", ["remote", "local"])
def test_detect2d_gt_summary_equals_the_jax_evaluator(served, tmp_path, where):
    server, repo = served[0], served[1]
    argv = ["-m", "tiny2d", *FRAMES]
    _, rows = _local(detect2d, served, argv, "2d_")
    gt = tmp_path / "gt.jsonl"
    _gt_2d(rows, gt)
    extra = (_remote(server, "shm") if where == "remote"
             else ["-r", str(repo), "--device", "cpu"])
    report, got = run(detect2d, [*argv, *extra, "--gt", str(gt)], tmp_path / "out")
    table = {json.loads(line)["frame_id"]: json.loads(line)["boxes"] for line in open(gt)}
    ev = JDetectionEvaluator()
    for r in got:
        ev.add_frame(np.asarray(r["detections"], np.float32), np.asarray(r["valid"]),
                     np.asarray(table[r["frame_id"]], np.float64).reshape(-1, 5))
    want = json.loads(json.dumps(ev.summary()))
    assert report["eval"] == want
    assert 0 < want["map50"] < 1


def test_detect3d_gt_summary_equals_the_jax_evaluator(served, tmp_path):
    server, _, clouds, _ = served
    argv = ["-m", "tiny3d", "-i", str(clouds)]
    _, rows = _local(detect3d, served, argv, "3d_")
    gt = tmp_path / "gt3d.jsonl"
    with open(gt, "w") as f:
        for r in rows:
            boxes = np.column_stack([np.asarray(r["pred_boxes"]).reshape(-1, 7)[:4],
                                     np.asarray(r["pred_labels"])[:4] - 1])  # 0-indexed
            f.write(json.dumps({"frame_id": r["frame_id"], "boxes": boxes.tolist()}) + "\n")
    report, got = run(detect3d, [*argv, *_remote(server, "wire"), "--gt", str(gt)],
                      tmp_path / "out")
    table = {json.loads(line)["frame_id"]: json.loads(line)["boxes"] for line in open(gt)}
    ev = JDetection3DEvaluator()
    for r in got:
        ev.add_frame3d(np.asarray(r["pred_boxes"], np.float32).reshape(-1, 7),
                       np.asarray(r["pred_scores"], np.float32),
                       np.asarray(r["pred_labels"], np.int32),
                       np.asarray(table[r["frame_id"]], np.float64).reshape(-1, 8))
    assert report["eval"] == json.loads(json.dumps(ev.summary()))
    assert report["eval"]["map50"] > 0


def test_centerpoint_gt_with_velocity_labels_equals_the_jax_evaluator(served, tmp_path):
    """10-column ground truth ([box7, cls, vx, vy]) against CenterPoint's
    rows over shm: the report's ``eval`` equals the JAX evaluator's on the
    same rows (the box metric reads the first 8 columns)."""
    server, _, _, tmp = served
    argv = ["-m", "tinycp", "-i", str(tmp / "sweeps"), "--sweeps", "3", "--poses",
            str(tmp / "poses.jsonl"), "--scan-period", "0.05"]
    _, rows = _local(detect3d, served, argv, "cp_sweeps")
    gt = tmp_path / "gt3d.jsonl"
    with open(gt, "w") as f:
        for r in rows:
            boxes = np.column_stack([np.asarray(r["pred_boxes"]).reshape(-1, 7)[:5],
                                     np.asarray(r["pred_labels"])[:5] - 1,
                                     np.asarray(r["pred_velocities"]).reshape(-1, 2)[:5]])
            f.write(json.dumps({"frame_id": r["frame_id"], "boxes": boxes.tolist()}) + "\n")
    report, got = run(detect3d, [*argv, *_remote(server, "shm"), "--gt", str(gt)],
                      tmp_path / "out")
    assert got == rows
    table = {json.loads(line)["frame_id"]: json.loads(line)["boxes"] for line in open(gt)}
    ev = JDetection3DEvaluator()
    for r in got:
        ev.add_frame3d(np.asarray(r["pred_boxes"], np.float32).reshape(-1, 7),
                       np.asarray(r["pred_scores"], np.float32),
                       np.asarray(r["pred_labels"], np.int32),
                       np.asarray(table[r["frame_id"]], np.float64).reshape(-1, 10))
    assert report["eval"] == json.loads(json.dumps(ev.summary()))
    assert report["eval"]["map50"] > 0


def test_profile_table_and_trace(served, tmp_path, capsys):
    server = served[0]
    argv = ["-m", "tiny2d", "-i", "synthetic:2:48x80", *_remote(server, "shm"), "--profile",
            "--profile-trace", str(tmp_path / "trace")]
    detect2d.main(argv)
    err = capsys.readouterr().err
    assert "stage" in err and "infer" in err and "source" in err
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


# -- guards ------------------------------------------------------------------------------


def test_remote_guards_match_the_jax_cli(served, tmp_path):
    """tests/test_remote_cli.py's guards: -m required, and the server owns
    the repository, the thresholds and the mesh; --streaming is unary-only
    for --gt and remote-only."""
    server = served[0]
    ep = ["-u", f"grpc:127.0.0.1:{server.port}"]
    cases = [
        (detect2d, [*ep, "-i", "synthetic:1"], "model-name"),
        (detect2d, [*ep, "-m", "tiny2d", "-r", "x"], "SERVER loads the repository"),
        (detect2d, [*ep, "-m", "tiny2d", "--conf", "0.5"], "server-side in remote mode"),
        (detect2d, [*ep, "-m", "tiny2d", "--mesh", "data=2"], "serve --mesh"),
        (detect2d, [*ep, "-m", "tiny2d", "--streaming", "--gt", str(tmp_path / "g")],
         "unary-mode"),
        (detect2d, [*ep, "-m", "tiny2d", "--streaming", "--profile"], "streaming path"),
        (detect2d, ["--streaming", "-i", "synthetic:2:64x64"], "remote ModelStreamInfer"),
        (detect2d, [*ep, "-m", "tiny2d", "--async", "--streaming"], "pick one"),
        (detect3d, [*ep, "-i", "synthetic:1"], "model-name"),
        (detect3d, [*ep, "-m", "tiny3d", "-r", "x"], "SERVER loads the repository"),
        (detect3d, [*ep, "-m", "tiny3d", "--score", "0.2"], "server-side in remote mode"),
    ]
    for cli, argv, match in cases:
        with pytest.raises(SystemExit, match=match):
            cli.main(argv)


def test_repo_guards(served):
    """--repo: -m required, the entry's config owns the shape, and an entry
    of the other kind is refused, as in the JAX CLIs."""
    repo = str(served[1])
    cases = [
        (detect2d, ["-r", repo], "requires -m"),
        (detect2d, ["-r", repo, "-m", "tiny2d", "--input-size", "64"], "--input-size conflict"),
        (detect2d, ["-r", repo, "-m", "tiny2d", "-c", "2", "--dtype", "fp32"],
         "--classes, --dtype conflict"),
        (detect2d, ["-r", repo, "-m", "tiny2d", "--mxu-opt"], "--mxu-opt conflict"),
        (detect2d, ["-r", repo, "-m", "tiny3d", "--device", "cpu"], "use the detect3d CLI"),
        (detect3d, ["-r", repo, "-m", "tiny2d", "--device", "cpu"], "use the detect2d CLI"),
        (detect3d, ["-r", repo, "-m", "tiny3d", "--voxel-size", "1,1,1"], "conflict with --repo"),
        (detect2d, ["-r", repo, "-m", "nope", "--device", "cpu"], "config.yaml"),
        (detect2d, ["-r", repo, "-m", "tiny2d", "-x", "7", "--device", "cpu"],
         "no version dir '7'"),
    ]
    for cli, argv, match in cases:
        with pytest.raises(SystemExit, match=match):
            cli.main(argv)


def test_repo_overrides_reach_the_pipeline(served, tmp_path):
    """--conf overrides the entry's threshold in-process (JAX's
    config_overrides): fewer rows at 0.3 than at the entry's 0.05."""
    _, rows = _local(detect2d, served, ["-m", "tiny2d", *FRAMES], "2d_")
    _, strict = run(detect2d, ["-m", "tiny2d", *FRAMES, "-r", str(served[1]), "--device", "cpu",
                               "--conf", "0.3"], tmp_path)
    assert sum(map(sum, (r["valid"] for r in strict))) < sum(map(sum, (r["valid"] for r in rows)))


def _quiet(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _writes_pngs(cli, argv, served, tmp_path, monkeypatch):
    """--sink images: one {frame_id:04d}.png a frame, the frame's size."""
    from PIL import Image

    report = _quiet(cli, [*argv, "-r", str(served[1]), "-m", "tiny2d", "-i", "synthetic:2:48x80",
                          "--device", "cpu", "-o", str(tmp_path)])
    assert report["frames"] == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["0000.png", "0001.png"]
    assert np.asarray(Image.open(tmp_path / "0001.png")).shape == (48, 80, 3)


def _writes_a_bag(cli, argv, served, tmp_path, monkeypatch):
    """--sink bag (3D): output.bag holds each input cloud and a box array."""
    from triton_client_tpu_torch.io import rosbag

    report = _quiet(cli, [*argv, "-r", str(served[1]), "-m", "tiny3d", "-i", str(served[2]),
                          "--device", "cpu", "-o", str(tmp_path)])
    with rosbag.BagReader(str(tmp_path / "output.bag")) as r:
        msgs = [(topic, msg) for topic, msg, _ in r.read_messages()]
    assert [t for t, _ in msgs] == ["/points", "/tpu_detections/boxes3d"] * 3
    assert sum(len(m.boxes) for t, m in msgs if t != "/points") == report["detections"]


def _serves_metrics(cli, argv, served, tmp_path, monkeypatch):
    """--prometheus-port with --gt: the five Summaries are served after the
    run until interrupted (a patched sleep scrapes, then interrupts)."""
    import socket
    import time
    import urllib.request

    pytest.importorskip("prometheus_client")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    gt = tmp_path / "gt.jsonl"
    gt.write_text("".join(json.dumps({"frame_id": i, "boxes": [[4, 4, 30, 20, 0]]}) + "\n"
                          for i in range(2)))
    scraped = []

    def sleep(seconds):
        scraped.append(urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                              timeout=10).read().decode())
        raise KeyboardInterrupt

    monkeypatch.setattr(time, "sleep", sleep)
    argv = [a if a != "9000" else str(port) for a in argv]
    with pytest.warns(DeprecationWarning):
        report = _quiet(cli, [*argv, "-r", str(served[1]), "-m", "tiny2d", "--gt", str(gt),
                              "-i", "synthetic:2:48x80", "--device", "cpu"])
    assert report["eval"]["frames"] == 2 and len(scraped) == 1
    for name in ("precision", "recall", "ap", "f1", "ap_class"):
        assert f"model_{name}_count" in scraped[0]


def _runs_yolov4(cli, argv, served, tmp_path, monkeypatch):
    """-m yolov4 runs (it exited naming item 7 before the family was
    ported): its rows equal the JAX CLI's on the same weights and frames."""
    from tests.test_torch_driver import assert_rows_match_jax, run_new_family_against_the_jax_cli

    report, got, jreport, want = run_new_family_against_the_jax_cli(
        "yolov4", tmp_path, lambda main, a: _quiet(types.SimpleNamespace(main=main), a),
        monkeypatch, argv)
    assert report["frames"] == 3 and report["driver"]["ticks"] == jreport["driver"]["ticks"] == 2
    assert_rows_match_jax(got, want)


def _runs_on_a_bag(cli, argv, served, tmp_path, monkeypatch):
    """--poses odom on a bag with odometry runs: the sweeps move by the
    bag's poses (rows differ from the untransformed stack's)."""
    from triton_client_tpu_torch.io import synthdata

    bag = str(tmp_path / "drive.bag")
    synthdata.write_scene_bag(bag, 3, seed=4, odom_topic="/odom",
                              pc_range=(-6.4, -6.4, -5.0, 6.4, 6.4, 3.0), n_clutter=400,
                              n_objects=2)
    common = ["-r", str(served[1]), "-m", "tinycp", "-i", bag, "--sweeps", "2", "--device", "cpu"]
    report, rows = run(cli, [*argv, *common], tmp_path / "odom")
    _, static = run(cli, common, tmp_path / "static")
    assert report["scans"] == 3 and report["sweeps"] == 2
    assert rows[0] == static[0] and rows[1:] != static[1:]


_ID = "triton_client_tpu_torch.cli.{}-argv{}-{}"


@pytest.mark.parametrize("cli,argv,match", [
    (detect2d, ["-u", "tpu"], "-u tpu is the JAX package's"),
    (detect2d, ["-u", "http://x"], "use 'cuda' or 'grpc:"),
    pytest.param(detect2d, ["--sink", "images"], _writes_pngs,
                 id=_ID.format("detect2d", 2, "item 6 ")),
    pytest.param(detect3d, ["--sink", "bag"], _writes_a_bag,
                 id=_ID.format("detect3d", 3, "item 6 ")),
    pytest.param(detect2d, ["--prometheus-port", "9000"], _serves_metrics,
                 id=_ID.format("detect2d", 4, "item 6 ")),
    pytest.param(detect2d, ["-i", "ros:/camera"], "rospy is not installed",
                 id=_ID.format("detect2d", 5, "item 6 ")),
    (detect2d, ["--cameras", "2"], "item 8 "),
    (detect2d, ["--mesh", "data=2", "--device", "cpu"], "item 8 "),
    pytest.param(detect2d, ["-b", "2"], _runs_yolov4, id=_ID.format("detect2d", 8, "item 7 ")),
    pytest.param(detect3d, ["--poses", "odom:/odom"], "the input must be a .bag",
                 id=_ID.format("detect3d", 9, "item 6 ")),
    pytest.param(detect3d, ["--poses", "odom"], _runs_on_a_bag,
                 id=_ID.format("detect3d", 10, "item 6 ")),
    pytest.param(detect3d, ["-i", "ros:/points"], "rospy is not installed",
                 id=_ID.format("detect3d", 11, "item 6 ")),
    (detect3d, ["--streaming"], "2D remote path"),
])
def test_unported_options_exit_naming_their_item(cli, argv, match, served, tmp_path, monkeypatch):
    """Options of layers still to port exit naming their ROADMAP item. The
    cases that named item 6 (replay and evaluation) keep their ids and now
    hold the behaviour: the image and bag sinks, --prometheus-port and
    --poses odom on a bag run; ros: without ROS and --poses odom on a
    non-bag input exit with the JAX CLIs' messages. So does the case that
    named item 7: -m yolov4 runs, its rows the JAX CLI's."""
    if callable(match):
        match(cli, argv, served, tmp_path, monkeypatch)
        return
    with pytest.raises(SystemExit, match=match):
        cli.main(argv)


def test_stage_profiler_equals_jax():
    """The --profile table: the same samples give JAX's summary and report."""
    from triton_client_tpu.obs.profiling import StageProfiler as JStageProfiler

    from triton_client_tpu_torch.obs.profiling import StageProfiler

    rng = np.random.default_rng(4)
    profilers = (StageProfiler(window=50), JStageProfiler(window=50))
    for stage, seconds in zip(rng.choice(["source", "infer", "sink"], 200), rng.random(200)):
        for p in profilers:
            p.record(str(stage), float(seconds) * 0.02)
    assert profilers[0].summary() == profilers[1].summary()
    assert profilers[0].report() == profilers[1].report()
    assert StageProfiler().report() == JStageProfiler().report()


CONFIG_V4 = f"""family: yolov4
model:
  width: 0.125
  input_hw: [64, 64]
pipeline:
  class_names_file: {ROOT}/data/crop.names
  conf_thresh: 0.05
max_batch_size: 4
"""
CONFIG_RETINA = f"""family: retinanet
model:
  depth: tiny
  input_hw: [64, 64]
pipeline:
  class_names_file: {ROOT}/data/crop.names
max_batch_size: 4
"""


def test_remote_clients_of_the_new_families(tmp_path):
    """``detect2d -u grpc:`` against a YOLOv4 and a RetinaNet entry of
    ``serve``: the YOLOv4 entry answers ``detections``/``valid`` and the
    RetinaNet entry the detectron contract (``boxes``, ``scores``, INT64
    ``classes``, INT32 ``dims``), which the client passes through untouched,
    as the JAX client does (``drivers/driver.channel_infer``). The port's
    remote rows equal its in-process ``-r`` rows bit for bit, and the JAX
    client's rows against the same server equal the port client's."""
    from triton_client_tpu.cli import detect2d as jdetect2d

    repo = tmp_path / "repo"
    for name, config, key in (("tinyv4", CONFIG_V4, importers.yolov4_torch_key),
                              ("tinyretina", CONFIG_RETINA, importers.detectron_torch_key)):
        (repo / name / "1").mkdir(parents=True)
        (repo / name / "config.yaml").write_text(config)
        _, _, model = _Entry(repo / name, device="cpu")._build()  # seeded
        torch.save({key(k): v for k, v in model.state_dict().items()
                    if not k.endswith("num_batches_tracked")}, repo / name / "1" / "weights.pth")
    args = serve.parser().parse_args(["-r", str(repo), "-a", "127.0.0.1:0", "--device", "cpu",
                                      "--max-workers", "4", "--uds", "off"])
    with contextlib.redirect_stdout(io.StringIO()):
        server = serve.build_server(args)
    server.start()
    try:
        endpoint = ["-u", f"grpc:127.0.0.1:{server.port}", "--no-shm"]
        for name, keys in (("tinyv4", ["detections", "valid"]),
                           ("tinyretina", ["boxes", "scores", "classes", "dims"])):
            argv = ["-m", name, "-i", "synthetic:3:48x80"]
            local_report, local = run(detect2d, [*argv, "-r", str(repo), "--device", "cpu"],
                                      tmp_path / f"local_{name}")
            report, rows = run(detect2d, [*argv, *endpoint], tmp_path / f"remote_{name}")
            _, jrows = run(jdetect2d, [*argv, "-u", f"grpc:127.0.0.1:{server.port}", "--no-shm"],
                           tmp_path / f"jax_{name}")
            assert rows == local and jrows == rows
            assert sorted(rows[0]) == sorted(["frame_id", *keys])
            assert report["detections"] == local_report["detections"] > 0
            if name == "tinyretina":  # batched as served: (1, 100, ...) a frame
                assert np.asarray(rows[0]["boxes"]).shape == (1, 100, 4)
                assert isinstance(rows[0]["classes"][0][0], int) and rows[0]["dims"][0] > 0
    finally:
        server.stop()
