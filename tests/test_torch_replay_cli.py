"""The port's replay and evaluation entry points against the JAX CLIs, on
bags written from a seed with ``io/synthdata``, with tiny models (a 64²
YOLOv5n, a 64 x 64 pillar PointPillars and CenterPoint, one layer a
block) on JAX's seeded weights carried across through ``models/convert.py``.

- ``evaluate -i <bag> --gt``: the JAX CLI's rows, summary and Prometheus
  observations (scraped from both exporters once, then interrupted).
- ``detect2d -i <bag> --sink images``: PNGs of the rows drawn as JAX draws.
- ``detect3d -i <bag> --sink bag|jsonl``: JAX's rows; the output bag holds
  the rows' boxes and the input clouds.
- ``detect3d --sweeps 3 --poses odom`` on a bag with odometry: JAX's rows,
  and bit for bit the rows of the same clouds extracted with
  ``pc-extract`` and replayed with the pose file at the bag's period.
"""

import json
import pathlib
import socket
import time
import urllib.request

import numpy as np
import pytest
from test_torch_pointpillars import tiny_configs
from test_torch_server import pointpillars_variables, seeded_variables, yolo_variables
from test_torch_sweeps import TINY_NUSC

from triton_client_tpu.eval.detection_map import DetectionEvaluator as JDetectionEvaluator

from triton_client_tpu_torch.io import rosbag as trb
from triton_client_tpu_torch.io import synthdata

NAMES = pathlib.Path(__file__).resolve().parent.parent / "data" / "crop.names"
KITTI_TINY = dict(pc_range=(0.0, -6.4, -3.0, 12.8, 6.4, 1.0), n_clutter=800, n_objects=2)
NUSC_TINY = dict(pc_range=(-6.4, -6.4, -5.0, 6.4, 6.4, 3.0), n_clutter=300, n_objects=2)


@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    pytest.importorskip("cv2")  # the 2D frames are drawn with cv2
    tmp = tmp_path_factory.mktemp("replay")
    frames = str(tmp / "frames.bag")
    gt = synthdata.write_detection_bag(frames, 3, (64, 64), seed=1)
    kitti = str(tmp / "kitti.bag")
    synthdata.write_scene_bag(kitti, 3, seed=2, **KITTI_TINY)
    nusc = str(tmp / "nusc.bag")
    synthdata.write_scene_bag(nusc, 4, seed=3, odom_topic="/odom", **NUSC_TINY)
    return tmp, frames, gt, kitti, nusc


def _report(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _rows(path):
    return [json.loads(line) for line in open(path / "detections.jsonl")]


@pytest.fixture
def yolo_weights(monkeypatch):
    """Both packages' YOLOv5 builders take the same seeded flax tree."""
    from triton_client_tpu.pipelines import detect2d as jdet

    from triton_client_tpu_torch.pipelines import detect2d as tdet

    variables = yolo_variables()
    jbuild, tbuild = jdet.build_yolov5_pipeline, tdet.build_yolov5_pipeline
    monkeypatch.setattr(jdet, "build_yolov5_pipeline",
                        lambda *a, **kw: jbuild(*a, **{**kw, "variables": variables}))
    monkeypatch.setattr(tdet, "build_yolov5_pipeline",
                        lambda **kw: tbuild(**{**kw, "variables": variables}))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _scrape_then_interrupt(monkeypatch, scraped):
    """time.sleep -> scrape the exporter the CLI just started, then raise
    KeyboardInterrupt (its Ctrl-C exit)."""
    real_sleep = time.sleep

    def sleep(seconds):
        if seconds < 100:
            return real_sleep(seconds)
        port = scraped["ports"].pop(0)
        text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read()
        scraped["texts"].append(text.decode())
        raise KeyboardInterrupt

    monkeypatch.setattr(time, "sleep", sleep)


def _model_samples(text):
    """The five Summaries' _count and _sum samples of a scrape."""
    return sorted(line for line in text.splitlines()
                  if line.startswith("model_") and ("_count " in line or "_sum " in line))


def test_evaluate_on_a_bag_equals_the_jax_cli(bags, capsys, monkeypatch, yolo_weights):
    pytest.importorskip("prometheus_client")
    from triton_client_tpu.cli import evaluate as jeval

    from triton_client_tpu_torch.cli import evaluate as teval

    tmp, frames, gt, _, _ = bags
    scraped = {"ports": [_free_port(), _free_port()], "texts": []}
    _scrape_then_interrupt(monkeypatch, scraped)
    common = ["-i", frames, "--gt", gt, "-c", "2", "--input-size", "64", "--conf", "0.05",
              "--sink", "jsonl"]
    with pytest.warns(DeprecationWarning, match="7658"):
        jeval.main([*common, "-o", str(tmp / "jeval"), "--prometheus-port",
                    str(scraped["ports"][0])])
    jreport = _report(capsys)
    with pytest.warns(DeprecationWarning, match="7658"):
        teval.main([*common, "-o", str(tmp / "teval"), "--device", "cpu", "--prometheus-port",
                    str(scraped["ports"][0])])
    report = _report(capsys)
    assert report["driver"]["frames"] == jreport["driver"]["frames"] == 3
    got, want = _rows(tmp / "teval"), _rows(tmp / "jeval")
    assert [r["frame_id"] for r in got] == [r["frame_id"] for r in want] == [0, 1, 2]
    assert [r["ts"] for r in got] == [r["ts"] for r in want] == [0.125, 0.25, 0.375]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["valid"], w["valid"])
        np.testing.assert_allclose(g["detections"], w["detections"], rtol=1e-3, atol=1e-2)
    # the summary is the JAX evaluator's on the port's rows and the same GT
    jev = JDetectionEvaluator()
    table = {json.loads(line)["frame_id"]: np.asarray(json.loads(line)["boxes"]).reshape(-1, 5)
             for line in open(gt)}
    for r in got:
        jev.add_frame(np.asarray(r["detections"], np.float32), np.asarray(r["valid"]),
                      table[r["frame_id"]])
    assert report["eval"] == json.loads(json.dumps(jev.summary()))
    assert report["eval"]["frames"] == jreport["eval"]["frames"] == 3
    assert len(scraped["texts"]) == 2
    port_samples, jax_samples = (_model_samples(t) for t in scraped["texts"][::-1])
    assert port_samples == jax_samples and len(port_samples) == 10


def test_evaluate_requires_gt_and_defaults_the_port(monkeypatch):
    from triton_client_tpu_torch.cli import detect2d, evaluate

    with pytest.raises(SystemExit):
        evaluate.main(["-i", "synthetic:1"])
    seen = []
    monkeypatch.setattr(detect2d, "main", seen.append)
    evaluate.main(["--gt", "gt.jsonl", "-i", "x.bag"])
    evaluate.main(["--gt", "gt.jsonl", "--prometheus-port", "9100"])
    assert seen == [["--gt", "gt.jsonl", "-i", "x.bag", "--prometheus-port", "7658"],
                    ["--gt", "gt.jsonl", "--prometheus-port", "9100"]]


def test_detect2d_image_sink_draws_the_rows(bags, capsys, yolo_weights):
    from PIL import Image

    from triton_client_tpu.io.draw import draw_boxes as jdraw_boxes

    from triton_client_tpu_torch.cli import detect2d
    from triton_client_tpu_torch.io.sources import open_source

    tmp, frames, _, _, _ = bags
    common = ["-i", frames, "-c", "2", "--input-size", "64", "--conf", "0.05", "--device", "cpu",
              "--names", str(NAMES)]
    detect2d.main([*common, "--sink", "images", "-o", str(tmp / "png")])
    detect2d.main([*common, "--sink", "jsonl", "-o", str(tmp / "rows")])
    capsys.readouterr()
    names = [line.strip() for line in open(NAMES) if line.strip()]
    for frame, row in zip(open_source(frames), _rows(tmp / "rows")):
        png = np.asarray(Image.open(tmp / "png" / f"{frame.frame_id:04d}.png").convert("RGB"))
        want = jdraw_boxes(frame.data, np.asarray(row["detections"], np.float32),
                           np.asarray(row["valid"]), tuple(names))
        np.testing.assert_array_equal(png, want)


@pytest.fixture
def pointpillars_weights(monkeypatch):
    from triton_client_tpu.pipelines import detect3d as jdet

    from triton_client_tpu_torch.pipelines import detect3d as tdet

    jcfg, tcfg = tiny_configs()
    variables = pointpillars_variables(jcfg)
    jbuild, tbuild = jdet.BUILDERS_3D["pointpillars"], tdet.BUILDERS_3D["pointpillars"]
    monkeypatch.setitem(jdet.BUILDERS_3D, "pointpillars", lambda rng, model_cfg=None, **kw: jbuild(
        rng, model_cfg=jcfg, variables=variables, **kw))
    monkeypatch.setitem(tdet.BUILDERS_3D, "pointpillars", lambda model_cfg=None, **kw: tbuild(
        model_cfg=tcfg, variables=variables, **kw))


def _assert_rows_close(got, want):
    assert [r["frame_id"] for r in got] == [r["frame_id"] for r in want]
    assert [r["ts"] for r in got] == [r["ts"] for r in want]
    for g, w in zip(got, want):
        assert g["pred_labels"] == w["pred_labels"]
        for k in ("pred_boxes", "pred_scores"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5, err_msg=k)


def _bag_boxes(path):
    with trb.BagReader(str(path)) as r:
        topics = r.topics()
        arrays = [m for _, m, _ in r.read_messages(topics=["/tpu_detections/boxes3d"])]
        clouds = [trb.pointcloud2_to_xyzi(m) for _, m, _ in r.read_messages(topics=["/points"])]
    return topics, arrays, clouds


def test_detect3d_on_a_bag_equals_the_jax_cli_and_writes_its_bag(bags, capsys,
                                                                 pointpillars_weights):
    from triton_client_tpu.cli import detect3d as jcli

    from triton_client_tpu_torch.cli import detect3d as tcli
    from triton_client_tpu_torch.io.sources import open_source

    tmp, _, _, kitti, _ = bags
    common = ["-i", kitti, "--score", "0.05"]
    jcli.main([*common, "--sink", "jsonl", "-o", str(tmp / "j3d")])
    tcli.main([*common, "--sink", "jsonl", "--device", "cpu", "-o", str(tmp / "t3d")])
    tcli.main([*common, "--sink", "bag", "--device", "cpu", "-o", str(tmp / "t3dbag")])
    report = _report(capsys)
    rows = _rows(tmp / "t3d")
    _assert_rows_close(rows, _rows(tmp / "j3d"))
    assert [r["ts"] for r in rows] == [0.125, 0.25, 0.375]
    assert report["scans"] == 3 and report["detections"] == sum(len(r["pred_scores"])
                                                               for r in rows) > 0
    topics, arrays, clouds = _bag_boxes(tmp / "t3dbag" / "kitti.bag_output.bag")
    assert topics == {"/points": "sensor_msgs/PointCloud2",
                      "/tpu_detections/boxes3d": "jsk_recognition_msgs/BoundingBoxArray"}
    for arr, row, cloud, frame in zip(arrays, rows, clouds, open_source(kitti, kind="pointcloud")):
        np.testing.assert_array_equal(cloud, frame.data)
        assert [b.label for b in arr.boxes] == row["pred_labels"]
        assert [b.value for b in arr.boxes] == [float(np.float32(s)) for s in row["pred_scores"]]
        centers = [[b.pose.position.x, b.pose.position.y, b.pose.position.z] for b in arr.boxes]
        np.testing.assert_array_equal(np.asarray(centers).reshape(-1, 3),
                                      np.asarray(row["pred_boxes"], np.float32)[:, :3])


def test_detect3d_odometry_sweeps_equal_jax_and_the_npy_replay(bags, capsys, monkeypatch):
    """--sweeps 3 --poses odom on the bag: the JAX CLI's rows within 1e-5,
    and the port's rows bit for bit those of the pc-extract clouds with the
    pose file at the bag's period."""
    from triton_client_tpu.cli import detect3d as jcli
    from triton_client_tpu.dataset_config import detect3d_from_yaml as jyaml
    from triton_client_tpu.models.centerpoint import init_centerpoint
    from triton_client_tpu.pipelines import detect3d as jdet

    from triton_client_tpu_torch.cli import detect3d as tcli
    from triton_client_tpu_torch.cli import tools
    from triton_client_tpu_torch.pipelines import detect3d as tdet

    tmp, _, _, _, nusc = bags
    cfg = tmp / "nusc_tiny.yaml"
    cfg.write_text(TINY_NUSC)
    _, jmodel_cfg, _ = jyaml(str(cfg))
    variables = seeded_variables(lambda k: init_centerpoint(k, jmodel_cfg)[1])
    jbuild, tbuild = jdet.BUILDERS_3D["centerpoint"], tdet.BUILDERS_3D["centerpoint"]
    monkeypatch.setitem(jdet.BUILDERS_3D, "centerpoint",
                        lambda rng, **kw: jbuild(rng, variables=variables, **kw))
    monkeypatch.setitem(tdet.BUILDERS_3D, "centerpoint",
                        lambda **kw: tbuild(variables=variables, **kw))
    common = ["--config", str(cfg), "--sweeps", "3", "--sink", "jsonl"]
    jcli.main(["-i", nusc, "--poses", "odom", *common, "-o", str(tmp / "jcp")])
    tcli.main(["-i", nusc, "--poses", "odom:/odom", *common, "--device", "cpu",
               "-o", str(tmp / "tcp")])
    report = _report(capsys)
    assert report["sweeps"] == 3 and report["scans"] == 4
    got = _rows(tmp / "tcp")
    _assert_rows_close(got, _rows(tmp / "jcp"))
    for k in ("pred_velocities",):
        for g, w in zip(got, _rows(tmp / "jcp")):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5)
    tools.pc_extract([nusc, "-o", str(tmp / "nusc_npy")])
    tcli.main(["-i", str(tmp / "nusc_npy"), "--poses", nusc + ".poses.jsonl", "--scan-period",
               str(synthdata.REPLAY_PERIOD), *common, "--device", "cpu", "-o", str(tmp / "npy")])
    capsys.readouterr()
    from_npy = _rows(tmp / "npy")
    assert [r["ts"] for r in from_npy] == [0.0, 0.125, 0.25, 0.375]
    for g, n in zip(got, from_npy):
        assert {k: v for k, v in g.items() if k != "ts"} == {k: v for k, v in n.items()
                                                             if k != "ts"}
    assert sum(len(r["pred_scores"]) for r in got) > 0
