"""The port's drawing and display code against the JAX package's:
``io/draw.draw_boxes`` (with cv2 and with the numpy strokes), the
``io/draw3d`` canvases, ``ImageFileSink``'s PNGs and ``io/viz3d`` against
the fake open3d of ``tests/test_viz3d.py``; pixels equal, bit for bit."""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest

from triton_client_tpu.io import draw as jdraw
from triton_client_tpu.io import draw3d as jdraw3d
from triton_client_tpu.io import sinks as jsinks
from triton_client_tpu.io import sources as jsources

from triton_client_tpu_torch.io import draw as tdraw
from triton_client_tpu_torch.io import draw3d as tdraw3d
from triton_client_tpu_torch.io import sinks as tsinks
from triton_client_tpu_torch.io import sources as tsources
from torch_threads import one_torch_thread  # noqa: F401

_spec = importlib.util.spec_from_file_location(
    "viz3d_fakes", pathlib.Path(__file__).with_name("test_viz3d.py"))
_fakes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fakes)


def _detections(rng, n, hw):
    h, w = hw
    x1, y1 = rng.uniform(-10, w, n), rng.uniform(-10, h, n)
    dets = np.stack([x1, y1, x1 + rng.uniform(-5, 60, n), y1 + rng.uniform(-5, 60, n),
                     rng.random(n), rng.integers(0, 4, n)], 1).astype(np.float32)
    return dets, rng.random(n) > 0.3


@pytest.mark.parametrize("with_cv2", [True, False])
def test_draw_boxes_pixels_equal_jax(monkeypatch, with_cv2):
    if with_cv2:
        pytest.importorskip("cv2")
    else:
        monkeypatch.setitem(sys.modules, "cv2", None)
        monkeypatch.setattr(jdraw, "_HAVE_CV2", False)
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (72, 96, 3), dtype=np.uint8)
    dets, valid = _detections(rng, 12, (72, 96))
    for names, thickness in (((), 2), (("crop", "weed"), 1)):
        got = tdraw.draw_boxes(img, dets, valid, names, thickness)
        want = jdraw.draw_boxes(img, dets, valid, names, thickness)
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, img)
    assert tdraw.class_color(7) == jdraw.class_color(7)


def _scene(rng):
    pts = np.concatenate([rng.uniform([0, -40, -3, 0], [70, 40, 1, 1], (3000, 4))]).astype(
        np.float32)
    boxes = np.stack([rng.uniform(5, 60, 5), rng.uniform(-30, 30, 5), rng.uniform(-2, 0, 5),
                      rng.uniform(1, 5, 5), rng.uniform(0.5, 2, 5), rng.uniform(1, 2, 5),
                      rng.uniform(-3, 3, 5)], 1)
    return pts, boxes, rng.integers(0, 3, 5), rng.random(5)


def test_draw3d_canvases_equal_jax():
    rng = np.random.default_rng(2)
    pts, boxes, labels, scores = _scene(rng)
    np.testing.assert_array_equal(tdraw3d.corners_3d(boxes), jdraw3d.corners_3d(boxes))
    np.testing.assert_array_equal(
        tdraw3d.draw_scene_bev(pts, boxes, labels, scores, gt_boxes7=boxes[:2] + 0.5),
        jdraw3d.draw_scene_bev(pts, boxes, labels, scores, gt_boxes7=boxes[:2] + 0.5))
    np.testing.assert_array_equal(
        tdraw3d.draw_scene_bev(pts[:, :3], None, xlim=(0, 40), ylim=(-20, 20), px_per_m=4.0),
        jdraw3d.draw_scene_bev(pts[:, :3], None, xlim=(0, 40), ylim=(-20, 20), px_per_m=4.0))
    for pt, pj in zip(tdraw3d.project_pinhole(pts[:, :3], np.array([-5.0, 0, 3]),
                                              np.array([20.0, 0, 0])),
                      jdraw3d.project_pinhole(pts[:, :3], np.array([-5.0, 0, 3]),
                                              np.array([20.0, 0, 0]))):
        np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(tdraw3d.draw_scene_3d(pts, boxes, labels, size=(200, 160)),
                                  jdraw3d.draw_scene_3d(pts, boxes, labels, size=(200, 160)))
    canvas_t, canvas_j = tdraw3d.BEVCanvas(), jdraw3d.BEVCanvas()
    xy = rng.uniform(-50, 80, (20, 2))
    np.testing.assert_array_equal(canvas_t.world_to_px(xy), canvas_j.world_to_px(xy))


@pytest.mark.parametrize("with_cv2", [True, False])
def test_image_file_sink_pngs_decode_to_jaxs_pixels(tmp_path, monkeypatch, with_cv2):
    """Numbered {frame_id:04d}.png files; without cv2 both packages write
    them with PIL."""
    from PIL import Image

    if with_cv2:
        pytest.importorskip("cv2")
    else:
        monkeypatch.setitem(sys.modules, "cv2", None)
        monkeypatch.setattr(jdraw, "_HAVE_CV2", False)
    for pkg, sinks, sources in (("t", tsinks, tsources), ("j", jsinks, jsources)):
        sink = sinks.ImageFileSink(str(tmp_path / pkg), ("crop", "weed"))
        r = np.random.default_rng(3)
        for fid in (0, 7, 1234):
            img = r.integers(0, 255, (40, 64, 3), dtype=np.uint8)
            dets, valid = _detections(r, 6, (40, 64))
            sink.write(sources.Frame(img, fid, 0.0), {"detections": dets, "valid": valid})
        sink.close()
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == ["0000.png", "0007.png", "1234.png"]
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    for name in names:
        got = np.asarray(Image.open(tmp_path / "t" / name).convert("RGB"))
        want = np.asarray(Image.open(tmp_path / "j" / name).convert("RGB"))
        np.testing.assert_array_equal(got, want)


def _geometry(g):
    """A fake open3d geometry as plain data."""
    if isinstance(g, tuple):
        return g
    out = {"type": type(g).__name__}
    for k, v in vars(g).items():
        out[k] = v.data.tolist() if hasattr(v, "data") else v
    return out


def test_viz3d_draws_what_jax_draws(monkeypatch):
    drawn = []
    monkeypatch.setitem(sys.modules, "open3d", _fakes._fake_open3d(drawn))
    from triton_client_tpu.io import viz3d as jviz
    from triton_client_tpu_torch.io import viz3d as tviz

    rng = np.random.default_rng(4)
    pts, boxes, _, scores = _scene(rng)
    gts = np.concatenate([boxes[:2], np.zeros((2, 1))], 1)
    for viz, sources in ((tviz, tsources), (jviz, jsources)):
        sink = viz.ShowSink3D(gt_lookup=lambda frame: gts)
        sink.write(sources.Frame(pts, 5, 0.0), {"pred_boxes": boxes, "pred_scores": scores})
        sink.write(sources.Frame(pts[:10], 6, 0.0), {"pred_scores": scores[:0]})
        sink.close()
        viz.draw_detections_3d(pts, boxes, window_name="w")
    assert len(drawn) == 6
    for (geoms_t, window_t), (geoms_j, window_j) in zip(drawn[:3], drawn[3:]):
        assert window_t == window_j
        assert [_geometry(g) for g in geoms_t] == [_geometry(g) for g in geoms_j]
    assert [w for _, w in drawn[:3]] == ["frame 5", "frame 6", "w"]


def test_viz3d_without_open3d_refuses_as_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "open3d", None)
    from triton_client_tpu.io import viz3d as jviz
    from triton_client_tpu_torch.cli import detect3d
    from triton_client_tpu_torch.io import viz3d as tviz

    errors = []
    for viz in (tviz, jviz):
        with pytest.raises(ImportError) as e:
            viz.ShowSink3D()
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "open3d" in errors[0]
    with pytest.raises(SystemExit, match="open3d"):
        detect3d.main(["-i", "synthetic:1", "--show", "--limit", "1"])
