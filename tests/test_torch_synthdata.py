"""The port's accuracy oracle (``io/synthdata.py``) against the JAX
package's: the same seed gives the same frames, ground truth and dataset
files, and the replay bags hold the datasets' frames."""

import numpy as np
import pytest

from triton_client_tpu.io import synthdata as jsyn

from triton_client_tpu_torch.io import synthdata as tsyn
from triton_client_tpu_torch.io.sources import open_source


@pytest.mark.parametrize("hw,classes,objects,distractors", [
    ((64, 64), 2, 6, True), ((48, 80), 5, 3, False), ((512, 512), 2, 6, True)])
def test_detection_frames_equal_jax(hw, classes, objects, distractors):
    pytest.importorskip("cv2")
    rt, rj = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):
        img_t, boxes_t = tsyn.synth_detection_frame(rt, hw, classes, objects, distractors)
        img_j, boxes_j = jsyn.synth_detection_frame(rj, hw, classes, objects, distractors)
        np.testing.assert_array_equal(img_t, img_j)
        np.testing.assert_array_equal(boxes_t, boxes_j)


@pytest.mark.parametrize("kwargs", [
    {},
    {"n_clutter": 120_000, "n_objects": 4},
    {"pc_range": (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0), "n_sweeps": 3, "velocity_max": 5.0,
     "class_names": ("Car", "Pedestrian"), "yaw_mode": "axis", "front_bias": 0.5},
])
def test_scene_frames_equal_jax(kwargs):
    rt, rj = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(2):
        pts_t, boxes_t = tsyn.synth_scene_frame(rt, **kwargs)
        pts_j, boxes_j = jsyn.synth_scene_frame(rj, **kwargs)
        assert pts_t.dtype == pts_j.dtype and boxes_t.dtype == boxes_j.dtype
        np.testing.assert_array_equal(pts_t, pts_j)
        np.testing.assert_array_equal(boxes_t, boxes_j)


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in root.rglob("*") if p.is_file()}


def test_dataset_files_equal_jax(tmp_path):
    pytest.importorskip("cv2")
    for pkg, syn in (("t", tsyn), ("j", jsyn)):
        images, gt = syn.write_detection_dataset(str(tmp_path / pkg / "2d"), 3, (40, 56), seed=5)
        assert images.endswith("images") and gt.endswith("gt.jsonl")
        clouds, gt3 = syn.write_scene_dataset(str(tmp_path / pkg / "3d"), 2, seed=5,
                                              n_clutter=500)
        assert clouds.endswith("clouds") and gt3.endswith("gt3d.jsonl")
    got, want = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert sorted(got) == sorted(want) and len(got) == 7
    assert got == want


def test_gt3d_lookup_moved_here_equals_jax(tmp_path):
    tsyn.write_scene_dataset(str(tmp_path), 2, seed=1, n_clutter=100, n_sweeps=2,
                             velocity_max=3.0)
    (tmp_path / "empty.jsonl").write_text('{"frame_id": 4, "boxes": []}\n\n')
    from triton_client_tpu_torch.io.sources import Frame

    for name in ("gt3d.jsonl", "empty.jsonl"):
        got = tsyn.load_gt3d_lookup(str(tmp_path / name))
        want = jsyn.load_gt3d_lookup(str(tmp_path / name))
        for fid in range(5):
            frame = Frame(np.zeros((1, 4), np.float32), fid, 0.0)
            g, w = got(frame), want(frame)
            assert (g is None) == (w is None)
            if g is not None:
                assert g.shape == w.shape and g.shape[1] in (8, 10)
                np.testing.assert_array_equal(g, w)
    (tmp_path / "bad.jsonl").write_text('{"frame_id": 0, "boxes": [[1, 2, 3]]}\n')
    with pytest.raises(ValueError, match="8 or 10 columns"):
        tsyn.load_gt3d_lookup(str(tmp_path / "bad.jsonl"))


def test_detection_bag_holds_the_datasets_frames(tmp_path):
    """``write_detection_bag``: the dataset's frames (same seed) as rgb8
    Image messages stamped (i + 1) / 8 s, and the same ground truth."""
    pytest.importorskip("cv2")
    gt = tsyn.write_detection_bag(str(tmp_path / "f.bag"), 3, (40, 56), seed=9)
    _, gt_ds = jsyn.write_detection_dataset(str(tmp_path / "ds"), 3, (40, 56), seed=9)
    assert open(gt).read() == open(gt_ds).read()
    frames = list(open_source(str(tmp_path / "f.bag")))
    assert [f.frame_id for f in frames] == [0, 1, 2]
    assert [f.timestamp for f in frames] == [0.125, 0.25, 0.375]
    for f, png in zip(frames, sorted((tmp_path / "ds" / "images").iterdir())):
        import cv2

        np.testing.assert_array_equal(f.data, cv2.imread(str(png))[..., ::-1])
