"""The port's inference driver and entry points against the JAX ones.

``drivers/driver.InferenceDriver`` runs beside the JAX driver on the
same synthetic source with a deterministic numpy ``infer``: the same
frame count, ticks, sink records and order, sync, batched and with
futures in flight, plus source errors, the empty source and
``max_frames`` (as ``tests/test_io_driver.py`` holds the JAX driver).
The port's ``cli/detect2d`` and ``cli/detect3d`` run at a tiny size on
the CPU (``--async --inflight 2``, ``-b 2``, ``--sink jsonl``) against
the JAX CLIs' jsonl on the same seed and the same weights, at the
pipeline tests' bars.
"""

from __future__ import annotations

import contextlib
import io
import json

import jax
import numpy as np
import pytest

from triton_client_tpu.drivers import driver as jdriver
from triton_client_tpu.io import sources as jsources

from triton_client_tpu_torch.channel.base import InferFuture
from triton_client_tpu_torch.drivers import driver as tdriver
from triton_client_tpu_torch.io import sources as tsources
from triton_client_tpu_torch.io.sinks import DetectionLogSink, ImageFileSink, NullSink
from torch_threads import one_torch_thread  # noqa: F401


def _infer(data):
    """Deterministic, shape-generic: a per-frame marker from the pixels."""
    data = np.asarray(data)
    batched = data.ndim == 4
    x = data if batched else data[None]
    b = x.shape[0]
    dets = np.zeros((b, 4, 6), np.float32)
    dets[:, 0, 4] = x.reshape(b, -1).astype(np.float64).mean(axis=1)
    dets[:, 1, :4] = x.reshape(b, -1)[:, :4]
    out = {"detections": dets, "valid": dets[..., 4] > 0}
    return out if batched else {k: v[0] for k, v in out.items()}


class _Recorder:
    def __init__(self):
        self.rows = []

    def write(self, frame, result):
        self.rows.append((frame.frame_id, {k: np.asarray(v).tolist() for k, v in result.items()}))

    def close(self):
        self.rows.append("closed")


def _future(result):
    return InferFuture(lambda: result)


class _JFuture:
    def __init__(self, value):
        self.value = value

    def result(self):
        return self.value


@pytest.mark.parametrize("mode", ["sync", "batch4", "inflight2", "inflight3"])
@pytest.mark.parametrize("n", [1, 7, 12])
def test_driver_matches_jax_on_the_same_source(mode, n):
    runs = []
    for drv, src, fut in ((tdriver, tsources, _future), (jdriver, jsources, _JFuture)):
        calls = []

        def infer(data, calls=calls):
            calls.append(np.shape(data))
            out = _infer(data)
            return fut(out) if mode.startswith("inflight") else out

        kw = {"batch_size": 4} if mode == "batch4" else {}
        if mode.startswith("inflight"):
            kw = {"inflight": int(mode[-1])}
        sink = _Recorder()
        stats = drv.InferenceDriver(infer, src.SyntheticImageSource(n, (16, 16), seed=5),
                                    sink=sink, warmup=1, **kw).run()
        runs.append((stats.frames, stats.ticks, calls, sink.rows))
    assert runs[0] == runs[1]
    frames, ticks, calls, rows = runs[0]
    assert frames == n and [r[0] for r in rows[:-1]] == list(range(n)) and rows[-1] == "closed"
    assert ticks == (-(-n // 4) if mode == "batch4" else n)


def _infer3d(data):
    """Deterministic 3D contract from a cloud: a few boxes a frame."""
    pts = np.asarray(data, np.float64)
    c = pts[:4, :3].mean(0)
    boxes = np.array([[c[0] + i, c[1], c[2], 2 + i % 2, 1.5, 1.5, 0.1 * i] for i in range(4)])
    return {"pred_boxes": boxes.astype(np.float32),
            "pred_scores": np.linspace(0.9, 0.3, 4).astype(np.float32),
            "pred_labels": np.array([1, 2, 1, 3], np.int32)}


@pytest.mark.parametrize("kind", ["2d", "3d"])
@pytest.mark.parametrize("mode", ["sync", "batch3", "inflight2"])
def test_driver_scores_frames_through_the_evaluator_as_jax(kind, mode):
    """``evaluator`` + ``gt_lookup`` score every frame with ground truth
    through the evaluator's adapter; the summary equals the JAX driver's
    with the JAX evaluator on the same seeded frames and GT (frame 2 has
    none and is skipped)."""
    from triton_client_tpu.eval import detection_map as jdm

    from triton_client_tpu_torch.eval import detection_map as tdm

    rng = np.random.default_rng(8)
    if kind == "2d":
        gts = {i: np.column_stack([rng.uniform(0, 8, (3, 2)), rng.uniform(8, 16, (3, 2)),
                                   rng.integers(0, 2, 3)]) for i in range(7) if i != 2}
    else:
        gts = {i: np.column_stack([rng.uniform(0, 4, (3, 3)), rng.uniform(1, 3, (3, 3)),
                                   rng.uniform(0, 1, 3), rng.integers(0, 3, 3)])
               for i in range(7) if i != 2}
    summaries = []
    for drv, src, dm, fut in ((tdriver, tsources, tdm, _future),
                              (jdriver, jsources, jdm, _JFuture)):
        if kind == "2d":
            source = src.SyntheticImageSource(7, (16, 16), seed=5)
            evaluator, base = dm.DetectionEvaluator(), _infer
        else:
            source = src.SyntheticPointCloudSource(7)
            evaluator, base = dm.Detection3DEvaluator(), _infer3d
        kw = {}
        if mode == "batch3" and kind == "2d":
            kw = {"batch_size": 3}
        infer = base
        if mode == "inflight2":
            kw = {"inflight": 2}
            infer = (lambda data, base=base, fut=fut: fut(base(data)))
        drv.InferenceDriver(infer, source, evaluator=evaluator,
                            gt_lookup=lambda frame: gts.get(frame.frame_id), warmup=0,
                            **kw).run()
        assert len(evaluator.frames) == 6
        summaries.append(json.loads(json.dumps(evaluator.summary())))
    assert summaries[0] == summaries[1]


def test_driver_stats_and_latency_stats_match_jax():
    lat = [0.002, 0.004, 0.003, 0.010]
    assert tdriver.latency_stats(lat, 8, 0.5, 4).to_dict() == \
        jdriver.latency_stats(lat, 8, 0.5, 4).to_dict()
    assert tdriver.DriverStats().to_dict() == jdriver.DriverStats().to_dict()


def test_driver_propagates_source_errors():
    class BadSource:
        def __iter__(self):
            raise RuntimeError("boom")
            yield

    for drv in (tdriver, jdriver):
        with pytest.raises(RuntimeError, match="boom"):
            drv.InferenceDriver(lambda x: {}, BadSource()).run()

    class LateError:
        def __iter__(self):
            yield tsources.Frame(np.zeros((4, 4, 3), np.uint8), 0, 0.0)
            raise ValueError("late")

    sink = _Recorder()
    with pytest.raises(ValueError, match="late"):
        tdriver.InferenceDriver(_infer, LateError(), sink=sink, warmup=0).run()
    assert sink.rows[-1] == "closed"  # the sink closes on the error path


def test_driver_empty_source_and_max_frames():
    assert tdriver.InferenceDriver(lambda x: {}, tsources.SyntheticImageSource(0)).run() == \
        tdriver.DriverStats()
    stats = tdriver.InferenceDriver(
        lambda x: {"n": 1}, tsources.SyntheticImageSource(100, (8, 8)), warmup=0
    ).run(max_frames=3)
    assert stats.frames == 3


def test_driver_guards():
    with pytest.raises(ValueError, match="pick one"):
        tdriver.InferenceDriver(_infer, [], batch_size=2, inflight=2)

    class Ragged:
        def __iter__(self):
            yield tsources.Frame(np.zeros((8, 8, 3)), 0, 0.0)
            yield tsources.Frame(np.zeros((16, 8, 3)), 1, 1.0)

    with pytest.raises(ValueError, match="uniform frame shapes"):
        tdriver.InferenceDriver(_infer, Ragged(), warmup=0, batch_size=2).run()


def test_sinks(tmp_path):
    frame = tsources.Frame(np.zeros((2, 2, 3), np.uint8), 3, 1.5)
    sink = DetectionLogSink(str(tmp_path / "d" / "log.jsonl"))
    sink.write(frame, {"detections": np.array([[0, 0, 1, 1, 0.5, 0]]), "n": 2, "skip": object()})
    sink.close()
    row = json.loads((tmp_path / "d" / "log.jsonl").read_text())
    assert row == {"frame_id": 3, "ts": 1.5, "detections": [[0, 0, 1, 1, 0.5, 0]], "n": 2}
    NullSink().write(frame, {})
    # ImageFileSink draws the rows and writes {frame_id:04d}.png
    images = ImageFileSink(str(tmp_path / "png"))
    images.write(frame, {"detections": np.zeros((1, 6), np.float32), "valid": np.array([True])})
    images.close()
    assert [p.name for p in (tmp_path / "png").iterdir()] == ["0003.png"]


def _jsonl(path):
    return [json.loads(line) for line in open(path)]


CLI_FLAGS = [["--async", "--inflight", "2"], ["-b", "2"]]


def _jax_cli_runs(tmp_path_factory, jcli, module, attr, common, keep):
    """The JAX CLI run once per ``CLI_FLAGS`` case on one JAX pipeline: the
    builder ``module.attr`` (a function, or a ``BUILDERS_3D`` key) is
    wrapped so the first run's pipeline, its weights and its compiled
    programs serve the second run too. ``keep(kw)`` adjusts the builder's
    arguments. Returns (the weights as numpy, {flags: (report, rows)})."""
    built = {}
    table = isinstance(module, dict)
    jbuild = module[attr] if table else getattr(module, attr)

    def jax_builder(*args, **kw):
        if "pipeline" not in built:
            built["pipeline"] = jbuild(*args, **keep(kw))
            built["variables"] = jax.tree_util.tree_map(
                np.asarray, jax.device_get(built["pipeline"][2]))
        return built["pipeline"]

    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        (mp.setitem if table else mp.setattr)(module, attr, jax_builder)
        for flags in CLI_FLAGS:
            out = tmp_path_factory.mktemp("jax")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                jcli.main([*common, *flags, "-o", str(out)])
            report = json.loads(buf.getvalue().strip().splitlines()[-1])
            runs[tuple(flags)] = (report, _jsonl(out / "detections.jsonl"))
    return built["variables"], runs


@pytest.fixture(scope="module")
def jax_cli_2d(tmp_path_factory):
    from triton_client_tpu.cli import detect2d as jcli
    from triton_client_tpu.pipelines import detect2d as jdet

    return _jax_cli_runs(tmp_path_factory, jcli, jdet, "build_yolov5_pipeline", CLI_2D,
                         lambda kw: kw)


@pytest.fixture(scope="module")
def jax_cli_3d(tmp_path_factory):
    from test_torch_pointpillars import tiny_configs

    from triton_client_tpu.cli import detect3d as jcli
    from triton_client_tpu.pipelines import detect3d as jdet

    jcfg, _ = tiny_configs()
    return _jax_cli_runs(tmp_path_factory, jcli, jdet.BUILDERS_3D, "pointpillars", CLI_3D,
                         lambda kw: {**kw, "model_cfg": jcfg})


CLI_2D = ["-c", "2", "--input-size", "64", "-i", "synthetic:5:48x80", "--conf", "0.05",
          "--sink", "jsonl"]
CLI_3D = ["-i", "synthetic:3", "--sink", "jsonl"]


@pytest.mark.parametrize("flags", CLI_FLAGS)
def test_cli_detect2d_jsonl_matches_the_jax_cli(tmp_path, capsys, monkeypatch, flags, jax_cli_2d):
    """The JAX CLI's runs come from ``jax_cli_2d`` (one JAX pipeline for
    both cases)."""
    from triton_client_tpu_torch.cli import detect2d as tcli
    from triton_client_tpu_torch.pipelines import detect2d as tdet

    variables, runs = jax_cli_2d
    jreport, want = runs[tuple(flags)]
    build = tdet.build_yolov5_pipeline
    monkeypatch.setattr(tdet, "build_yolov5_pipeline",
                        lambda **kw: build(**kw, variables=variables))
    tcli.main([*CLI_2D, *flags, "--device", "cpu", "--pipeline-depth", "2",
               "-o", str(tmp_path / "port")])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["driver"]["frames"] == jreport["driver"]["frames"] == 5
    assert report["driver"]["ticks"] == jreport["driver"]["ticks"]
    got = _jsonl(tmp_path / "port" / "detections.jsonl")
    assert [r["frame_id"] for r in got] == [r["frame_id"] for r in want] == list(range(5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["valid"], w["valid"])
        np.testing.assert_allclose(g["detections"], w["detections"], rtol=1e-3, atol=1e-2)
    assert report["detections"] == sum(sum(r["valid"]) for r in got) > 0
    # every request went through the captured body, as did the registration warmup
    assert report["graphs"]["calls"] == report["channel"]["launched"] + 1


@pytest.mark.parametrize("flags", CLI_FLAGS)
def test_cli_detect3d_jsonl_matches_the_jax_cli(tmp_path, capsys, monkeypatch, flags, jax_cli_3d):
    """The JAX CLI's runs come from ``jax_cli_3d`` (one JAX pipeline for
    both cases)."""
    from test_torch_pointpillars import tiny_configs

    from triton_client_tpu_torch.cli import detect3d as tcli
    from triton_client_tpu_torch.pipelines import detect3d as tdet

    _, tcfg = tiny_configs()
    variables, runs = jax_cli_3d
    jreport, want = runs[tuple(flags)]
    tbuild = tdet.BUILDERS_3D["pointpillars"]
    monkeypatch.setitem(tdet.BUILDERS_3D, "pointpillars", lambda model_cfg=None, **kw: tbuild(
        model_cfg=tcfg, variables=variables, **kw))
    tcli.main([*CLI_3D, *flags, "--device", "cpu", "-o", str(tmp_path / "port")])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["driver"]["frames"] == jreport["driver"]["frames"] == 3
    got = _jsonl(tmp_path / "port" / "detections.jsonl")
    assert [r["frame_id"] for r in got] == [r["frame_id"] for r in want] == [0, 1, 2]
    for g, w in zip(got, want):
        assert g["pred_labels"] == w["pred_labels"]
        np.testing.assert_allclose(g["pred_boxes"], w["pred_boxes"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["pred_scores"], w["pred_scores"], rtol=0, atol=1e-5)
    assert report["detections"] == sum(len(r["pred_scores"]) for r in got) > 0
    assert report["graphs"]["keys"] == 3  # one a point bucket, captured at registration


def test_cli_async_guards():
    from triton_client_tpu_torch.cli import detect2d as tcli

    with pytest.raises(SystemExit, match="batch-size"):
        tcli.main(["--async", "-b", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="inflight"):
        tcli.main(["--async", "--inflight", "1", "--device", "cpu"])


def test_pipeline_adapters_equal_the_pipelines():
    from test_torch_pointpillars import TINY_VOXEL, cloud

    from triton_client_tpu_torch.models.pointpillars import PointPillarsConfig
    from triton_client_tpu_torch.ops.voxelize import VoxelConfig
    from triton_client_tpu_torch.pipelines import detect2d as tdet2
    from triton_client_tpu_torch.pipelines import detect3d as tdet3

    pipe2, _, _ = tdet2.build_yolov5_pipeline(
        num_classes=2, config=tdet2.Detect2DConfig(num_classes=2, input_hw=(64, 64),
                                                   conf_thresh=0.05), device="cpu")
    frame = np.random.default_rng(1).integers(0, 255, (48, 80, 3), dtype=np.uint8)
    got = tdriver.detect2d_infer(pipe2)(frame)
    dets, valid = pipe2.infer(frame)
    assert np.array_equal(got["detections"], dets) and np.array_equal(got["valid"], valid)
    pipe3, _, _ = tdet3.build_pointpillars_pipeline(
        PointPillarsConfig(voxel=VoxelConfig(**TINY_VOXEL), backbone_layers=(1, 1, 1)),
        tdet3.Detect3DConfig(point_buckets=(1024,), max_det=16, pre_max=64), device="cpu")
    pts = cloud(3, 500)
    sync = tdriver.detect3d_infer(pipe3)(pts)
    fut = tdriver.detect3d_infer_async(pipe3)(pts)
    assert isinstance(fut, InferFuture)
    out = fut.result()
    assert all(np.array_equal(out[k], sync[k]) for k in sync) and len(sync["pred_scores"]) > 0


NEW_2D_MODELS = {"yolov4": ["--width", "0.125", "--conf", "0.05"], "retinanet_tiny": [],
                 "fcos_tiny": []}


def run_new_family_against_the_jax_cli(name, tmp_path, call, monkeypatch, flags=()):
    """``detect2d -m <name>`` in-process through the JAX CLI and the port's
    on the same seeded weights (a fill of the flax tree's shapes, handed to
    both builders) and frames: the port's report and jsonl rows, and JAX's.
    ``call(main, argv)`` runs a CLI's ``main`` and returns its report."""
    from triton_client_tpu.cli import detect2d as jcli
    from triton_client_tpu.models import retinanet as jret
    from triton_client_tpu.models import yolov4 as jv4
    from triton_client_tpu.pipelines import detect2d as jdet

    from triton_client_tpu_torch.cli import detect2d as tcli
    from triton_client_tpu_torch.pipelines import detect2d as tdet
    from tests.test_torch_server import seeded_variables

    family = name.partition("_")[0]
    builder = {"yolov4": "build_yolov4_pipeline", "retinanet": "build_retinanet_pipeline",
               "fcos": "build_fcos_pipeline"}[family]
    carried = {}
    jbuild, tbuild = getattr(jdet, builder), getattr(tdet, builder)

    def jax_builder(rng, **kw):
        if family == "yolov4":
            model = jv4.YoloV4(num_classes=kw["num_classes"], width=kw["width"])
        else:
            cls = jret.RetinaNet if family == "retinanet" else jret.FCOS
            model = cls(num_classes=kw["num_classes"], depth=kw["depth"], input_hw=kw["input_hw"])
        hw = kw["input_hw"]
        carried["variables"] = jax.tree_util.tree_map(np.asarray, seeded_variables(
            lambda k: model.init(k, jax.numpy.zeros((1, *hw, 3)), train=False), seed=31))
        return jbuild(rng, variables=carried["variables"], **kw)

    monkeypatch.setattr(jdet, builder, jax_builder)
    monkeypatch.setattr(tdet, builder, lambda **kw: tbuild(variables=carried["variables"], **kw))
    common = ["-m", name, *NEW_2D_MODELS[name], "-c", "2", "--input-size", "64", "-i",
              "synthetic:3:48x80", "--sink", "jsonl", *flags]
    jreport = call(jcli.main, [*common, "-o", str(tmp_path / "jax")])
    report = call(tcli.main, [*common, "--device", "cpu", "-o", str(tmp_path / "port")])
    return (report, _jsonl(tmp_path / "port" / "detections.jsonl"), jreport,
            _jsonl(tmp_path / "jax" / "detections.jsonl"))


def assert_rows_match_jax(got, want):
    """The pipeline tests' bars (tests/test_torch_yolov4.py,
    tests/test_torch_retinanet.py): valid or dims, labels and order equal,
    scores within 2e-5, boxes within 5e-5 of each box's largest coordinate."""
    assert [r["frame_id"] for r in got] == [r["frame_id"] for r in want]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        if "detections" in w:
            gd, wd = np.asarray(g["detections"]), np.asarray(w["detections"])
            np.testing.assert_array_equal(g["valid"], w["valid"])
            gb, wb, gs, ws, gl, wl = (a[..., cols] for cols in (slice(0, 4), 4, 5)
                                      for a in (gd, wd))
        else:
            assert g["dims"] == w["dims"]
            gb, wb, gs, ws, gl, wl = (np.asarray(r[k]) for k in ("boxes", "scores", "classes")
                                      for r in (g, w))
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=2e-5)
        scale = np.maximum(np.abs(wb).max(-1, keepdims=True), 1.0)
        assert np.all(np.abs(gb - wb) <= 5e-5 * scale)


@pytest.mark.parametrize("name", sorted(NEW_2D_MODELS))
def test_cli_detect2d_new_families_match_the_jax_cli(tmp_path, capsys, monkeypatch, name):
    """``-m yolov4`` (``--width``), ``retinanet_tiny`` and ``fcos_tiny``: the
    JAX CLI's rows on the same weights and frames; a detectron model's rows
    are the detectron contract (boxes, scores, classes, dims) as in JAX."""
    def call(main, argv):
        main(argv)
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    report, got, jreport, want = run_new_family_against_the_jax_cli(name, tmp_path, call,
                                                                    monkeypatch)
    assert report["driver"]["frames"] == jreport["driver"]["frames"] == 3
    assert_rows_match_jax(got, want)
    dets = sum(sum(r["valid"]) if "valid" in r else sum(r["dims"]) for r in got)
    assert report["detections"] == dets > 0
    assert report["model"] == jreport["model"] == name
