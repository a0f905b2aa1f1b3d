"""The port's replay sources, the bag sink, the odometry pose lookup and the
bag tools against the JAX package's, on bags written from a seed.

Bag frames carry their header stamps, so the port's and JAX's sources give
equal frames, ids and stamps; ``OutputBagSink`` fed those frames writes the
same bytes; ``bag_pose_lookup`` gives equal matrices between and beyond
the odometry samples; ``pc-extract``, ``bag-stitch``, ``bag-info`` and
``repo-index`` give equal files and text.
"""

import json

import numpy as np
import pytest

from triton_client_tpu.cli import tools as jtools
from triton_client_tpu.io import bag_io as jbag
from triton_client_tpu.io import sources as jsources

from triton_client_tpu_torch.cli import tools as ttools
from triton_client_tpu_torch.io import bag_io as tbag
from triton_client_tpu_torch.io import rosbag as trb
from triton_client_tpu_torch.io import sources as tsources
from triton_client_tpu_torch.io import synthdata


@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    """A mixed bag (clouds, rgb8 and bgr8 images, odometry; seq from 100)
    and a scene bag with odometry written by ``synthdata.write_scene_bag``."""
    tmp = tmp_path_factory.mktemp("bags")
    rng = np.random.default_rng(11)
    mixed = str(tmp / "mixed.bag")
    with trb.BagWriter(mixed) as w:
        for i in range(5):
            t = 10.0 + 0.1 * i
            pts = rng.normal(0, 15, (40 + 9 * i, 4)).astype(np.float32)
            w.write("/lidar/points", trb.xyzi_to_pointcloud2(pts, stamp=t, seq=100 + i), t=t + 0.02)
            img = rng.integers(0, 255, (12, 20, 3), dtype=np.uint8)
            msg = trb.numpy_to_image(img, stamp=t, seq=0 if i == 2 else 200 + i)
            if i % 2:
                msg.encoding = "bgr8"
            w.write("/camera/image_raw", msg, t=t + 0.03)
            odom = trb.make("nav_msgs/Odometry")
            odom.header.stamp = trb._split_time(t - 0.05)
            odom.pose.pose.position.x = 2.0 * i
            odom.pose.pose.position.y = -0.5 * i * i
            odom.pose.pose.orientation.z = float(np.sin(0.2 * i))
            odom.pose.pose.orientation.w = float(np.cos(0.2 * i)) * (-1 if i == 3 else 1)
            w.write("/odom", odom, t=t)
    scene = str(tmp / "scene.bag")
    synthdata.write_scene_bag(scene, 3, seed=2, odom_topic="/odom", n_clutter=300,
                              n_objects=2)
    return tmp, mixed, scene


def _frames(source):
    return [(f.frame_id, f.timestamp, f.path, f.data) for f in source]


def _assert_frames_equal(got, want):
    assert [g[:3] for g in got] == [w[:3] for w in want]
    for g, w in zip(got, want):
        assert g[3].dtype == w[3].dtype
        np.testing.assert_array_equal(g[3], w[3])


@pytest.mark.parametrize("limit", [0, 3])
def test_bag_sources_give_jaxs_frames_and_stamps(bags, limit):
    _, mixed, scene = bags
    for spec in (mixed, scene):
        got = _frames(tsources.open_source(spec, limit, kind="pointcloud"))
        want = _frames(jsources.open_source(spec, limit, kind="pointcloud"))
        _assert_frames_equal(got, want)
        assert len(got) == (limit or (5 if spec == mixed else 3))
    got = tsources.open_source(mixed, limit)
    want = jsources.open_source(mixed, limit)
    assert got.topic == want.topic == "/camera/image_raw" and len(got) == len(want)
    _assert_frames_equal(_frames(got), _frames(want))
    assert got.hw == (12, 20)
    # a bag's frames carry header stamps: the first scan's capture time
    assert next(iter(tsources.open_source(mixed, kind="pointcloud"))).timestamp == 10.0


def test_image_dir_source_gives_jaxs_frames(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"{i:06d}.png"), rng.integers(0, 255, (8, 12, 3), np.uint8))
    (tmp_path / "notes.txt").write_text("skip me")
    got, want = tsources.open_source(str(tmp_path)), jsources.open_source(str(tmp_path))
    assert type(got).__name__ == type(want).__name__ == "ImageDirSource"
    assert got.paths == want.paths and got.hw == (8, 12)
    for g, w in zip(got, want):
        assert (g.frame_id, g.path) == (w.frame_id, w.path)
        np.testing.assert_array_equal(g.data, w.data)


def test_video_source_gives_jaxs_frames(tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (32, 16))
    if not writer.isOpened():
        pytest.skip("cv2 has no MJPG writer here")
    for i in range(4):
        writer.write(np.full((16, 32, 3), 40 * i, np.uint8))
    writer.release()
    got, want = tsources.open_source(path, 3), jsources.open_source(path, 3)
    assert len(got) == len(want) == 3 and got.hw == (16, 32)
    frames_got, frames_want = list(got), list(want)
    assert [f.frame_id for f in frames_got] == [f.frame_id for f in frames_want] == [0, 1, 2]
    for g, w in zip(frames_got, frames_want):
        np.testing.assert_array_equal(g.data, w.data)
    with pytest.raises(FileNotFoundError):
        tsources.open_source(str(tmp_path / "missing.mp4"))


def _boxes_result(rng, n):
    return {"pred_boxes": rng.normal(0, 5, (n, 7)).astype(np.float32),
            "pred_scores": rng.random(n).astype(np.float32),
            "pred_labels": rng.integers(0, 3, n).astype(np.int32)}


def test_output_bag_sink_writes_jaxs_bytes(bags, tmp_path):
    """Frames from a bag (their messages copied through), a .npy-style
    frame with a stamp, and the packed (dets, valid) form: equal bytes."""
    _, mixed, _ = bags
    paths = []
    for pkg, bag_io, sources in (("t", tbag, tsources), ("j", jbag, jsources)):
        rng = np.random.default_rng(8)
        path = str(tmp_path / f"{pkg}_{bag_io.default_output_bag(mixed)}")
        sink = bag_io.OutputBagSink(path)
        for frame in sources.open_source(mixed, kind="pointcloud"):
            sink.write(frame, _boxes_result(rng, 1 + frame.frame_id % 3))
        pts = rng.normal(0, 3, (9, 4)).astype(np.float32)
        dets = rng.normal(0, 2, (4, 9)).astype(np.float32)
        dets[:, 8] = [0, 2, 1, 1]  # labels
        sink.write(sources.Frame(pts, 7, 12.5), {"detections": dets[None],
                                                  "valid": np.array([1, 0, 1, 1], bool)})
        sink.close()
        paths.append(path)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    assert tbag.default_output_bag("/a/b/drive.bag") == jbag.default_output_bag("/a/b/drive.bag")
    with trb.BagReader(paths[0]) as r:
        boxes = [m for _, m, _ in r.read_messages(topics=["/tpu_detections/boxes3d"])]
    assert [len(m.boxes) for m in boxes] == [2, 3, 1, 2, 3, 3]  # seq 100-104, then packed


def test_bag_pose_lookup_gives_jaxs_matrices(bags):
    _, mixed, scene = bags
    got, want = tbag.bag_pose_lookup(mixed), jbag.bag_pose_lookup(mixed, "/odom")
    for t in (0.0, 9.95, 9.99, 10.05, 10.2123, 10.33, 10.35, 99.0):
        frame = tsources.Frame(np.zeros((1, 4), np.float32), 0, t)
        np.testing.assert_array_equal(got(frame), want(frame))
    # the scene bag's odometry sits at the scans' stamps: the pose file and
    # the bag give the same matrices, bit for bit
    from_file = tbag.pose_lookup_from_jsonl(scene + ".poses.jsonl")
    from_bag = tbag.bag_pose_lookup(scene)
    for frame in tsources.open_source(scene, kind="pointcloud"):
        np.testing.assert_array_equal(from_bag(frame), from_file(frame))
    with pytest.raises(ValueError, match="no topic of type"):
        tbag.bag_pose_lookup(_empty_bag(bags[0]))


def _empty_bag(tmp):
    path = str(tmp / "no_odom.bag")
    with trb.BagWriter(path) as w:
        w.write("/points", trb.xyzi_to_pointcloud2(np.zeros((1, 4), np.float32), stamp=1.0), t=1.0)
    return path


@pytest.mark.parametrize("scale", ["1.0", "255"])
def test_pc_extract_writes_jaxs_clouds(bags, tmp_path, capsys, scale):
    _, mixed, _ = bags
    for pkg, tools in (("t", ttools), ("j", jtools)):
        tools.pc_extract([mixed, "-o", str(tmp_path / pkg), "--intensity-scale", scale])
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace(str(tmp_path / "t"), "") == out[1].replace(str(tmp_path / "j"), "")
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir()) and len(names) == 5
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


@pytest.mark.parametrize("argv", [["-n", "7"], ["--topics", "/odom", "/camera/image_raw"],
                                  ["--topics"]])
def test_bag_stitch_and_bag_info_equal_jax(bags, tmp_path, capsys, argv):
    _, mixed, _ = bags
    ttools.bag_stitch([mixed, str(tmp_path / "t.bag"), *argv])
    jtools.bag_stitch([mixed, str(tmp_path / "j.bag"), *argv])
    assert (tmp_path / "t.bag").read_bytes() == (tmp_path / "j.bag").read_bytes()
    capsys.readouterr()
    for tools in (ttools, jtools):
        tools.bag_info([str(tmp_path / "t.bag")])
    lines = capsys.readouterr().out.splitlines()
    half = len(lines) // 2
    assert lines[:half] == lines[half:] and "messages:" in lines[0]


def test_repo_index_equals_jax(tmp_path, capsys, monkeypatch):
    (tmp_path / "m1" / "2").mkdir(parents=True)
    (tmp_path / "m1" / "config.yaml").write_text("family: yolov5\n")
    (tmp_path / "m1" / "2" / "weights.pt").write_bytes(b"x")
    (tmp_path / "m1" / "3").mkdir()
    (tmp_path / "m2").mkdir()
    (tmp_path / "m2" / "config.yaml").write_text("family: pointpillars\n")
    for target in (str(tmp_path), "examples"):
        for tools in (ttools, jtools):
            tools.repo_index([target])
        lines = capsys.readouterr().out.splitlines()
        half = len(lines) // 2
        assert lines[:half] == lines[half:] and half >= 2
    assert "yolov5_crop:1  family=yolov5" in " ".join(lines)

    class FakeChannel:
        def __init__(self, target, *a, **k):
            self.target = target

        def repository_index(self):
            return [("yolov5_crop", "1", "READY"), ("pointpillar_kitti", "1", "READY")]

        def close(self):
            pass

    import triton_client_tpu.channel.grpc_channel as jgc
    import triton_client_tpu_torch.channel.grpc_channel as tgc

    monkeypatch.setattr(jgc, "GRPCChannel", FakeChannel)
    monkeypatch.setattr(tgc, "GRPCChannel", FakeChannel)
    for tools in (ttools, jtools):
        tools.repo_index(["grpc:127.0.0.1:1"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == lines[2:] == ["yolov5_crop:1  READY", "pointpillar_kitti:1  READY"]
    with pytest.raises(SystemExit, match="not a directory"):
        ttools.repo_index([str(tmp_path / "nope")])


def test_scene_bag_matches_the_scene_dataset(bags, tmp_path):
    """``write_scene_bag`` holds ``write_scene_dataset``'s clouds (same
    seed) and ground truth, stamped (i + 1) / 8 s."""
    _, _, scene = bags
    clouds, gt = synthdata.write_scene_dataset(str(tmp_path), 3, seed=2, n_clutter=300,
                                               n_objects=2)
    frames = list(tsources.open_source(scene, kind="pointcloud"))
    assert [f.timestamp for f in frames] == [0.125, 0.25, 0.375]
    for f, npy in zip(frames, sorted((tmp_path / "clouds").iterdir())):
        np.testing.assert_array_equal(f.data, np.load(npy)[:, :4])
    assert open(scene + ".gt3d.jsonl").read() == open(gt).read()
    poses = [json.loads(line)["pose"] for line in open(scene + ".poses.jsonl")]
    assert poses[0] == synthdata.ego_pose(0) and len(poses) == 3
