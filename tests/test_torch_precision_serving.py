"""Every serving precision policy through the port's entry points, against
the JAX package's, on the CPU: ``detect3d --dtype bf16`` held to the JAX
CLI's bf16 rows by mAP, a remote ``detect3d -u grpc:`` against a served
bf16 3D entry (FP32 clouds staged float32, rows bit for bit those of the
in-process ``-r`` run), and full-width KITTI PointPillars on flax-init
weights, where JAX's own bf16 and int8w detections miss their budgets
against its f32 ones and the port's score what JAX's score."""

from __future__ import annotations

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from triton_client_tpu.models import pointpillars as jpp
from triton_client_tpu.pipelines import detect3d as jdet

from triton_client_tpu_torch.channel.staged import cast_wire_input
from triton_client_tpu_torch.eval.detection_map import Detection3DEvaluator
from triton_client_tpu_torch.pipelines import detect3d as tdet
from triton_client_tpu_torch.runtime import precision as tprec
from tests.test_torch_pointpillars import cloud
from tests.test_torch_pointpillars import tiny_configs as pp_configs
from tests.test_torch_precision_3d import flax_init_variables
from torch_threads import one_torch_thread  # noqa: F401


def _jsonl(path):
    return [json.loads(line) for line in open(path)]


def _map_against(rows, ref_rows):
    gts = [np.concatenate([np.asarray(r["pred_boxes"], np.float32).reshape(-1, 7),
                           np.asarray(r["pred_labels"], np.float32)[:, None] - 1.0], 1)
           for r in ref_rows]
    ev = Detection3DEvaluator()
    for r, gt in zip(rows, gts):
        ev.add_frame3d(np.asarray(r["pred_boxes"]).reshape(-1, 7), r["pred_scores"],
                       r["pred_labels"], gt)
    return float(ev.summary()["map"])


def test_detect3d_dtype_bf16_is_held_to_the_jax_cli(tmp_path, capsys, monkeypatch):
    """``detect3d --dtype bf16 --device cpu`` runs in-process (the body in
    bfloat16, the f32 policy), on the JAX CLI's own variables: its rows
    score within MAP_BUDGETS["bf16"] of the JAX CLI's bf16 rows, against
    them as ground truth."""
    from triton_client_tpu.cli import detect3d as jcli

    from triton_client_tpu_torch.cli import detect3d as tcli

    jcfg, tcfg = pp_configs()
    carried, dtypes = {}, {}
    jbuild, tbuild = jdet.BUILDERS_3D["pointpillars"], tdet.BUILDERS_3D["pointpillars"]

    def jax_builder(rng, model_cfg=None, **kw):
        pipe, spec, variables = jbuild(rng, model_cfg=jcfg, **kw)
        carried["variables"] = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
        return pipe, spec, variables

    def port_builder(model_cfg=None, **kw):
        pipe, spec, model = tbuild(model_cfg=tcfg, variables=carried["variables"], **kw)
        dtypes["body"] = model.backbone.block0_down.weight.dtype
        dtypes["spec"] = spec
        return pipe, spec, model

    monkeypatch.setitem(jdet.BUILDERS_3D, "pointpillars", jax_builder)
    monkeypatch.setitem(tdet.BUILDERS_3D, "pointpillars", port_builder)
    common = ["-i", "synthetic:2", "--sink", "jsonl", "--dtype", "bf16"]
    jcli.main([*common, "-o", str(tmp_path / "jax")])
    capsys.readouterr()
    tcli.main([*common, "--device", "cpu", "-o", str(tmp_path / "port")])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert dtypes["body"] == torch.bfloat16 and report["driver"]["frames"] == 2
    # the f32 policy and KEEP_F32_3D, as the JAX CLI's spec records them
    # (param_bytes: the bf16 body, ROADMAP Queue 3)
    extra = dtypes["spec"].extra
    assert extra["precision"] == "f32"
    assert extra["precision_keep_f32"] == list(tprec.KEEP_F32_3D)
    got, want = _jsonl(tmp_path / "port" / "detections.jsonl"), _jsonl(
        tmp_path / "jax" / "detections.jsonl")
    assert sum(len(r["pred_scores"]) for r in want) > 0
    floor = _map_against(want, want) - tprec.MAP_BUDGETS["bf16"]
    assert _map_against(got, want) >= floor


CONFIG_BF16 = """family: pointpillars
model:
  precision: bf16
  voxel:
    point_cloud_range: [0.0, -6.4, -3.0, 12.8, 6.4, 1.0]
    voxel_size: [0.2, 0.2, 4.0]
    max_voxels: 512
    max_points_per_voxel: 8
  backbone_layers: [1, 1, 1]
pipeline:
  point_buckets: [1024, 4096]
  max_det: 16
  pre_max: 64
max_batch_size: 1
"""


@pytest.mark.parametrize("transport", ["wire", "shm"])
def test_remote_detect3d_against_a_bf16_entry_sends_float32_points(tmp_path, transport):
    """``detect3d -u grpc:`` against a served bf16 PointPillars entry: the
    client sends FP32 clouds, the server stages them float32, and the rows
    equal the in-process ``-r`` run's bit for bit."""
    from triton_client_tpu_torch.cli import detect3d as tcli
    from triton_client_tpu_torch.cli import serve
    from triton_client_tpu_torch.runtime import importers
    from triton_client_tpu_torch.runtime.disk_repository import _Entry

    repo = tmp_path / "repo"
    (repo / "tiny3d_bf16" / "1").mkdir(parents=True)
    (repo / "tiny3d_bf16" / "config.yaml").write_text(CONFIG_BF16)
    _, _, model = _Entry(repo / "tiny3d_bf16", device="cpu")._build()  # seeded
    state = {importers.pointpillars_torch_key(k): v.float() for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    torch.save({"model_state": state}, repo / "tiny3d_bf16" / "1" / "weights.pth")
    clouds = tmp_path / "clouds"
    clouds.mkdir()
    for i in range(2):
        np.save(clouds / f"{i:03d}.npy", cloud(20 + i, 900))
    args = serve.parser().parse_args(["-r", str(repo), "-a", "127.0.0.1:0", "--device", "cpu",
                                      "--max-workers", "2"])
    with contextlib.redirect_stdout(io.StringIO()):
        server = serve.build_server(args)
    server.start()
    try:
        entry = server._servicer._repo.get("tiny3d_bf16")
        assert entry.spec.extra["precision"] == "bf16" and entry.spec.inputs[0].dtype == "FP32"
        pc = np.load(clouds / "000.npy")
        assert cast_wire_input(entry, "points", pc) is pc
        argv = ["-m", "tiny3d_bf16", "-i", str(clouds), "--sink", "jsonl"]
        remote = {"wire": "--no-shm", "shm": "--shm"}[transport]
        rows = {}
        for tag, extra in (("remote", ["-u", f"grpc:127.0.0.1:{server.port}", remote]),
                           ("local", ["-r", str(repo), "--device", "cpu"])):
            with contextlib.redirect_stdout(io.StringIO()):
                tcli.main([*argv, *extra, "-o", str(tmp_path / tag)])
            rows[tag] = [{k: v for k, v in r.items() if k != "ts"}
                         for r in _jsonl(tmp_path / tag / "detections.jsonl")]
        assert rows["remote"] == rows["local"] and len(rows["remote"]) == 2
        assert sum(len(r["pred_scores"]) for r in rows["local"]) > 0
    finally:
        server.stop()


def test_full_width_pointpillars_policies_track_the_reference():
    """At full KITTI width (the 432 x 496 grid, backbone 3/5/5) on flax-init
    weights, two seeded 20,000-point scans: the budgets are not a property
    of random weights at this depth. JAX's own bf16 and int8w detections
    score below their floors against its f32 ones, and the port's score
    what JAX's score (within 0.01), their detections equal to JAX's under
    the same policy (the f32 self-score against them)."""
    jcfg, tcfg = jpp.PointPillarsConfig(), tdet.PointPillarsConfig()
    variables = flax_init_variables(lambda k: jpp.init_pointpillars(k, jcfg)[1], seed=13)
    rng = np.random.default_rng(0)
    r = jcfg.voxel.point_cloud_range
    clouds = [np.column_stack([rng.uniform(r[0], r[3], 20000), rng.uniform(r[1], r[4], 20000),
                               rng.uniform(r[2], r[5], 20000), rng.uniform(0, 1, 20000)]
                              ).astype(np.float32) for _ in range(2)]
    rows = {}
    for policy in ("f32", "bf16", "int8w"):
        jpipe = jdet.build_pointpillars_pipeline(
            jax.random.PRNGKey(0), model_cfg=jcfg, variables=variables, precision=policy)[0]
        tpipe = tdet.build_pointpillars_pipeline(model_cfg=tcfg, variables=variables,
                                                 precision=policy, device="cpu")[0]
        rows["jax", policy] = [jpipe.infer(pc) for pc in clouds]
        rows["port", policy] = [tpipe.infer(pc) for pc in clouds]

    def score(got, want):
        gts = [np.concatenate([w["pred_boxes"], w["pred_labels"][:, None] - 1.0], 1)
               for w in want]
        ev = Detection3DEvaluator()
        for g, gt in zip(got, gts):
            ev.add_frame3d(g["pred_boxes"], g["pred_scores"], g["pred_labels"], gt)
        return float(ev.summary()["map"])

    self_map = score(rows["jax", "f32"], rows["jax", "f32"])
    for policy in ("bf16", "int8w"):
        jax_map = score(rows["jax", policy], rows["jax", "f32"])
        port_map = score(rows["port", policy], rows["port", "f32"])
        assert jax_map < self_map - tprec.MAP_BUDGETS[policy], (policy, jax_map)
        assert abs(port_map - jax_map) <= 0.01, (policy, port_map, jax_map)
        assert score(rows["port", policy], rows["jax", policy]) == self_map
