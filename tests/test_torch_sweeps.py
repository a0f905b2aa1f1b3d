"""Multi-sweep aggregation (``ops/sweeps.py``) and the pose file
(``io/bag_io.pose_lookup_from_jsonl``) against the JAX package's, bit for
bit (numpy on both sides), after tests/test_sweeps.py; then ``detect3d
--config <nuScenes-shaped yaml> --sweeps 3 --poses`` over a directory of
``.npy`` clouds against the JAX CLI on the same weights and the same
frame stamps, rows within 1e-5, and the CLI's sweep guards.

The JAX CLI stamps each ``.npy`` frame with the wall clock when it is
read, so its Δt differs run to run; the test gives its source a replay
clock of 0.05 s a frame, which the port's CLI takes as ``--scan-period
0.05``.
"""

import json
import types

import numpy as np
import pytest

from triton_client_tpu.io import bag_io as jbag
from triton_client_tpu.io import sources as jsources
from triton_client_tpu.ops import sweeps as jsw

from triton_client_tpu_torch.io import bag_io as tbag
from triton_client_tpu_torch.io.sources import Frame
from triton_client_tpu_torch.ops import sweeps as tsw
from tests.test_torch_server import seeded_variables

PERIOD = 0.05


def _scene(rng, n=400, lo=-20, hi=20, cols=4):
    pts = np.column_stack([rng.uniform(lo, hi, n), rng.uniform(lo, hi, n),
                           rng.uniform(-2, 2, n), rng.uniform(0, 1, n)]).astype(np.float32)
    return pts[:, :cols]


def _yaw_pose(yaw, t):
    return [*t, 0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)]


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", ["times", "no_times", "transforms", "three_columns"])
def test_aggregate_sweeps_equals_jax(case):
    rng = np.random.default_rng(1)
    sweeps = [_scene(rng, 10 + i, cols=3 if case == "three_columns" else 4) for i in range(3)]
    kw = {}
    if case != "no_times":
        kw["times"] = [10.0, 9.95, 9.9]
    if case == "transforms":
        kw["transforms"] = tsw.relative_transforms(
            [tsw.pose_to_matrix(p[:3], p[3:]) for p in
             (_yaw_pose(0.1, (1, 2, 0)), _yaw_pose(0.05, (0.5, 1.9, 0)), _yaw_pose(0, (0, 2, 0)))])
    _bitwise(tsw.aggregate_sweeps(sweeps, **kw), jsw.aggregate_sweeps(sweeps, **kw))


@pytest.mark.parametrize("bad", ["empty", "times", "transforms", "shape"])
def test_aggregate_sweeps_refuses_as_jax(bad):
    rng = np.random.default_rng(2)
    args = {"empty": ([],), "times": ([_scene(rng, 3)], [1.0, 2.0]),
            "transforms": ([_scene(rng, 3)], None, [np.eye(4)] * 2),
            "shape": ([np.zeros((4, 2), np.float32)],)}[bad]
    for mod in (tsw, jsw):
        with pytest.raises(ValueError) as err:
            mod.aggregate_sweeps(*args)
        if mod is tsw:
            want = str(err.value)
        else:
            assert str(err.value) == want


@pytest.mark.parametrize("quat", [(0, 0, 0, 1), (0.1, -0.2, 0.3, 0.9), (1, 2, 3, 4)])
def test_pose_to_matrix_and_rigid_inverse_equal_jax(quat):
    t = (1.5, -2.0, 0.25)
    got, want = tsw.pose_to_matrix(t, quat), jsw.pose_to_matrix(t, quat)
    _bitwise(got, want)
    _bitwise(tsw._rigid_inverse(got), jsw._rigid_inverse(want))
    np.testing.assert_allclose(tsw._rigid_inverse(got) @ got, np.eye(4), atol=1e-12)
    for mod in (tsw, jsw):
        with pytest.raises(ValueError, match="zero-norm"):
            mod.pose_to_matrix(t, (0, 0, 0, 0))


def test_relative_transforms_equal_jax():
    poses = [tsw.pose_to_matrix(p[:3], p[3:]) for p in
             (_yaw_pose(0.3, (4, 1, 0)), _yaw_pose(0.2, (3, 0.5, 0.1)), _yaw_pose(0, (0, 0, 0)))]
    got, want = tsw.relative_transforms(poses), jsw.relative_transforms(poses)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _bitwise(g, w)
    np.testing.assert_allclose(got[0], np.eye(4), atol=1e-12)


@pytest.mark.parametrize("posed", [False, True])
def test_sweep_buffer_equals_jax(posed):
    rng = np.random.default_rng(3)
    bufs = tsw.SweepBuffer(3), jsw.SweepBuffer(3)
    for i in range(5):
        scan = _scene(rng, 20 + i)
        pose = tsw.pose_to_matrix(*np.split(np.asarray(_yaw_pose(0.1 * i, (i, 0, 0))), [3])) \
            if posed else None
        got, want = (b.push(scan, i * 0.1, pose) for b in bufs)
        _bitwise(got, want)
        assert len(bufs[0]) == len(bufs[1]) == min(i + 1, 3)
    for b in bufs:  # a window of one kind refuses the other, and is not poisoned
        with pytest.raises(ValueError, match="mixes posed and poseless"):
            b.push(_scene(rng, 5), 9.0, None if posed else np.eye(4))
        assert len(b) == 3
    with pytest.raises(ValueError, match="nsweeps"):
        tsw.SweepBuffer(0)


@pytest.mark.parametrize("nsweeps", [1, 2, 3])
def test_sweep_source_equals_jax(nsweeps):
    rng = np.random.default_rng(4)
    data = [_scene(rng, 7 + i) for i in range(4)]
    poses = {i: tsw.pose_to_matrix((0.3 * i, 0, 0), (0, 0, 0, 1)) for i in range(4)}
    got = list(tsw.sweep_source(iter([Frame(d, i, i * 0.1) for i, d in enumerate(data)]), nsweeps,
                                lambda f: poses[f.frame_id]))
    want = list(jsw.sweep_source(
        iter([jsources.Frame(d, i, i * 0.1) for i, d in enumerate(data)]), nsweeps,
        lambda f: poses[f.frame_id]))
    assert [f.frame_id for f in got] == [f.frame_id for f in want] == [0, 1, 2, 3]
    for g, w in zip(got, want):
        _bitwise(g.data, w.data)
        assert g.timestamp == w.timestamp
    with pytest.raises(ValueError, match="no pose for frame_id 0"):
        next(tsw.sweep_source(iter([Frame(data[0], 0, 0.0)]), 2, lambda f: None))


def test_pose_lookup_from_jsonl_equals_jax(tmp_path):
    p = tmp_path / "poses.jsonl"
    rows = [{"frame_id": i, "pose": _yaw_pose(0.2 * i, (i, 2 * i, 0.1))} for i in range(3)]
    p.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    got, want = tbag.pose_lookup_from_jsonl(str(p)), jbag.pose_lookup_from_jsonl(str(p))
    for i in range(3):
        _bitwise(got(Frame(np.zeros((1, 4)), i, 0.0)),
                 want(jsources.Frame(np.zeros((1, 4)), i, 0.0)))
    assert got(Frame(np.zeros((1, 4)), 7, 0.0)) is None
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"frame_id": 0, "pose": [1, 2, 3]}) + "\n")
    for mod in (tbag, jbag):
        with pytest.raises(ValueError, match=r"\[x, y, z, qx, qy, qz, qw\]"):
            mod.pose_lookup_from_jsonl(str(bad))


# -- detect3d --sweeps ---------------------------------------------------------------

TINY_NUSC = """model: centerpoint
voxel:
  point_cloud_range: [-6.4, -6.4, -5.0, 6.4, 6.4, 3.0]
  voxel_size: [0.2, 0.2, 8.0]
  max_points_per_voxel: 8
  max_voxels: 512
  point_features: 5
backbone_layers: [1, 1, 1]
backbone_filters: [16, 32, 64]
upsample_filters: [16, 16, 16]
vfe_filters: 16
head_width: 16
max_objects: 32
with_velocity: true
pipeline:
  score_thresh: 0.1
  iou_thresh: 0.2
  nsweeps: 10
  point_buckets: [4096]
  max_det: 16
"""


def _replay(tmp_path):
    """Four .npy scans of a platform moving 0.5 m a frame, and their poses."""
    clouds = tmp_path / "clouds"
    clouds.mkdir()
    rng = np.random.default_rng(5)
    for i in range(4):
        np.save(clouds / f"{i:03d}.npy", _scene(rng, 300 + 50 * i, -6.4, 6.4))
    poses = tmp_path / "poses.jsonl"
    rows = [{"frame_id": i, "pose": _yaw_pose(0.02 * i, (0.5 * i, 0, 0))} for i in range(4)]
    poses.write_text("".join(json.dumps(r) + "\n" for r in rows))
    cfg = tmp_path / "nusc_tiny.yaml"
    cfg.write_text(TINY_NUSC)
    return clouds, poses, cfg


def _rows(path):
    return [json.loads(line) for line in open(path / "detections.jsonl")]


def test_detect3d_sweeps_and_poses_equal_the_jax_cli(tmp_path, capsys, monkeypatch):
    from triton_client_tpu.cli import detect3d as jcli
    from triton_client_tpu.dataset_config import detect3d_from_yaml as jyaml
    from triton_client_tpu.models.centerpoint import init_centerpoint
    from triton_client_tpu.pipelines import detect3d as jdet

    from triton_client_tpu_torch.cli import detect3d as tcli
    from triton_client_tpu_torch.pipelines import detect3d as tdet

    clouds, poses, cfg = _replay(tmp_path)
    _, jmodel_cfg, _ = jyaml(str(cfg))
    variables = seeded_variables(lambda k: init_centerpoint(k, jmodel_cfg)[1])
    jbuild, tbuild = jdet.BUILDERS_3D["centerpoint"], tdet.BUILDERS_3D["centerpoint"]
    monkeypatch.setitem(jdet.BUILDERS_3D, "centerpoint",
                        lambda rng, **kw: jbuild(rng, variables=variables, **kw))
    monkeypatch.setitem(tdet.BUILDERS_3D, "centerpoint",
                        lambda **kw: tbuild(variables=variables, **kw))
    clock = iter(np.arange(100) * PERIOD)
    monkeypatch.setattr(jsources, "time", types.SimpleNamespace(time=lambda: float(next(clock))))
    common = ["-i", str(clouds), "--config", str(cfg), "--sweeps", "3", "--poses", str(poses),
              "--sink", "jsonl"]
    jcli.main([*common, "-o", str(tmp_path / "jax")])
    jreport = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tcli.main([*common, "--scan-period", str(PERIOD), "--device", "cpu",
               "-o", str(tmp_path / "port")])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["driver"]["frames"] == jreport["driver"]["frames"] == 4
    assert report["sweeps"] == 3 and report["model"] == "centerpoint"
    got, want = _rows(tmp_path / "port"), _rows(tmp_path / "jax")
    assert [r["frame_id"] for r in got] == [r["frame_id"] for r in want] == [0, 1, 2, 3]
    assert [r["ts"] for r in want] == [0.0, PERIOD, 2 * PERIOD, 3 * PERIOD]
    for g, w in zip(got, want):
        assert g["pred_labels"] == w["pred_labels"] and len(g["pred_labels"]) > 0
        for k in ("pred_boxes", "pred_scores", "pred_velocities"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5, err_msg=k)
    assert report["detections"] == sum(len(r["pred_scores"]) for r in got)


def test_the_config_sets_nsweeps_and_the_replay_clock_repeats(tmp_path, capsys):
    """Without --sweeps the config's nsweeps (10) applies; with
    --scan-period two runs write the same rows, bit for bit."""
    from triton_client_tpu_torch.cli import detect3d as tcli

    clouds, poses, cfg = _replay(tmp_path)
    runs = []
    for out in ("a", "b"):
        tcli.main(["-i", str(clouds), "--config", str(cfg), "--poses", str(poses),
                   "--scan-period", "0.1", "--device", "cpu", "--sink", "jsonl",
                   "-o", str(tmp_path / out)])
        report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert report["sweeps"] == 10
        runs.append([{k: v for k, v in r.items()} for r in _rows(tmp_path / out)])
    assert runs[0] == runs[1] and [r["ts"] for r in runs[0]] == [0.0, 0.1, 0.2, 0.30000000000000004]


@pytest.mark.parametrize("argv,match", [
    (["--poses", "{poses}", "--sweeps", "1"], "add --sweeps N"),
    (["--poses", "missing.jsonl", "--sweeps", "3"], "no such pose file"),
    pytest.param(["--poses", "odom", "--sweeps", "3"], "the input must be a .bag",
                 id="argv2-item 6 "),
    pytest.param(["--poses", "odom:/odom", "--sweeps", "3"], "the input must be a .bag",
                 id="argv3-item 6 "),
    (["-i", "ros:/points", "--sweeps", "2"], "replay-only"),
    (["--poses", "{poses}", "-m", "pointpillars", "--device", "cpu", "--pc-range",
      "0,-6.4,-3,12.8,6.4,1", "--voxel-size", "0.2,0.2,4"], "add --sweeps N"),
])
def test_sweep_guards_match_the_jax_cli(tmp_path, argv, match):
    """The JAX CLI's guards: --poses needs more than one sweep (decided
    early from --sweeps, later from the config's nsweeps: PointPillars'
    is 1), a pose file that exists, and live input stays single-sweep;
    a bag's odometry (--poses odom) needs a .bag input."""
    from triton_client_tpu_torch.cli import detect3d as tcli

    poses = tmp_path / "p.jsonl"
    poses.write_text("")
    argv = [a.replace("{poses}", str(poses)) for a in argv]
    if "-i" not in argv:
        argv = ["-i", "synthetic:1", *argv]
    with pytest.raises(SystemExit, match=match):
        tcli.main([*argv, "--sink", "null"])
