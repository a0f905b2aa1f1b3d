"""The port's roofline (``obs/roofline.py``) against the JAX package's, and
the ``roofline`` tool.

Bars: ``classify`` and ``model_row`` give JAX's rows exactly when JAX's
peak tables are set to the port's H100 values (for the test only); the
``roofline`` tool prints and emits the same rows for the same results
JSON. ``measure_launch_cost`` on the tiny YOLOv5 and PointPillars of the
server tests (flax weights carried across by ``models/convert.py``) counts
exactly ``FlopCounterMode``'s flops of the network; JAX's count (XLA's cost
model on the CPU) differs, and the ratio is pinned at the value found,
within 1% (ROADMAP.md Queue 3, "Disagreements").
"""

from __future__ import annotations

import json
import types

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from triton_client_tpu.cli import tools as jtools
from triton_client_tpu.obs import roofline as jroof
from triton_client_tpu.pipelines import detect2d as jdet2d
from triton_client_tpu.pipelines import detect3d as jdet3d

from triton_client_tpu_torch.cli import tools as ttools
from triton_client_tpu_torch.obs import roofline as troof
from triton_client_tpu_torch.pipelines import detect2d as tdet2d
from triton_client_tpu_torch.pipelines import detect3d as tdet3d
from tests.test_torch_pointpillars import tiny_configs
from tests.test_torch_server import (
    CFG_2D,
    CFG_3D,
    HW,
    frames,
    pointpillars_variables,
    scan,
    yolo_variables,
)

#: port / JAX counts of one call, found on this tree (CPU, the tiny models):
#: (flops, bytes). The port counts 2 x MACs of every convolution and matrix
#: product and nothing else; XLA's model counts its own HLO after its
#: passes. Bytes: per aten op against per HLO op before fusion.
COST_RATIOS = {"yolov5n": (1.05712, 0.51349), "pointpillars": (1.03390, 0.54717)}


@pytest.fixture
def h100_peaks(monkeypatch):
    """JAX's peak tables set to the port's values, for one test."""
    monkeypatch.setattr(jroof, "POLICY_PEAK_FLOPS", dict(troof.POLICY_PEAK_FLOPS))
    monkeypatch.setattr(jroof, "POLICY_PEAK_BYTES", dict(troof.POLICY_PEAK_BYTES))
    monkeypatch.setattr(jroof, "V5E_PEAK_FLOPS", troof.H100_PEAK_FP32_FLOPS)
    monkeypatch.setattr(jroof, "V5E_PEAK_HBM_BPS", troof.H100_PEAK_HBM_BPS)


CASES = [
    (1e12, 1e9, "bf16", 8),
    (1e12, 1e9, "f32", 8),
    (1e9, 1e9, "f32", 1),
    (2.5e10, 4e8, "int8w", 4),
    (2.5e10, 4e8, "int8", 4),
    (2.5e10, 4e8, None, 0),
    (0, 0, "f32", 1),
    (1e9, 0, "bf16", 1),
    (0, 1e6, "f32", 2),
    (-5, -5, "f32", 1),
    (3e9, 2e7, "fp8?", 1),
]


@pytest.mark.parametrize("flops,nbytes,precision,batch", CASES)
def test_classify_matches_jax_under_equal_peaks(h100_peaks, flops, nbytes, precision, batch):
    assert troof.classify(flops, nbytes, precision, batch).as_dict() == \
           jroof.classify(flops, nbytes, precision, batch).as_dict()


@pytest.mark.parametrize("extra,fps", [
    ({"measured_flops_per_call": 1e12, "measured_bytes_per_call": 1e9,
      "measured_batch": 8, "precision": "bf16", "analytic_flops_per_call": 9e11}, 500.0),
    ({"measured_flops_per_call": 8.3e9, "measured_bytes_per_call": 2.1e7}, 120.0),
    ({"measured_flops_per_call": 8.3e9, "measured_bytes_per_call": 2.1e7,
      "precision": "int8"}, None),
    ({}, 10.0),
])
def test_model_row_matches_jax_under_equal_peaks(h100_peaks, extra, fps):
    assert troof.model_row(extra, fps) == jroof.model_row(extra, fps)


def test_peaks_are_the_h100_data_sheet_figures():
    assert troof.POLICY_PEAK_FLOPS == {"f32": 67e12, "bf16": 989e12, "int8w": 67e12,
                                       "int8": 67e12}
    assert set(troof.POLICY_PEAK_BYTES.values()) == {3.35e12}
    row = troof.classify(67e9, 3.35e9)  # 1 ms of each ceiling: the knee
    assert row.knee == pytest.approx(67e12 / 3.35e12)
    assert row.attainable_calls_per_s == pytest.approx(1000.0)


def _model(name="m", version="1", extra=None):
    return types.SimpleNamespace(spec=types.SimpleNamespace(name=name, version=version,
                                                            extra=dict(extra or {})))


def test_launcher_names_are_the_launch_annotation():
    m = _model("yolov5_crop", "2")
    assert troof.launcher_name(m) == troof.hlo_module_for(m) == "launch:yolov5_crop:2"
    fn = troof.name_launcher(lambda x: x, m)
    assert fn.__name__ == fn.__qualname__ == "launch:yolov5_crop:2"


def test_record_launch_cost_keys():
    w = torch.ones(64, 64)
    m = _model(extra={"flops_per_call": 123.0})
    measured = troof.record_launch_cost(m, lambda x: (x @ w).relu().t(), torch.ones(64, 64),
                                        batch_rows=64)
    # mm: 2 x 64^3 flops; bytes: mm (2 inputs + output) and relu (in + out),
    # the transpose view moves none
    assert measured == {"flops": 2 * 64**3, "bytes": 5 * 64 * 64 * 4, "batch": 64,
                        "compute_precision": "f32"}
    extra = m.spec.extra
    assert extra["analytic_flops_per_call"] == 123.0
    assert extra["flops_per_call"] == extra["measured_flops_per_call"] == 2 * 64**3
    assert extra["measured_bytes_per_call"] == 5 * 64 * 64 * 4
    assert extra["measured_batch"] == 64
    assert extra["launch_annotation"] == "launch:m:1"
    assert extra["compute_precision"] == "f32"
    assert "hlo_module" not in extra


def test_compute_precision_follows_the_flops_not_the_policy():
    """A ``dtype: bf16`` body under the ``f32`` wire policy divides by the
    bf16 peak; mostly-f32 flops (a bf16 body's f32 heads alone) do not."""
    wb = torch.ones(64, 64, dtype=torch.bfloat16)
    m = _model(extra={"precision": "f32"})
    troof.record_launch_cost(m, lambda x: (x @ wb).float(), torch.ones(8, 64,
                                                                       dtype=torch.bfloat16))
    assert m.spec.extra["compute_precision"] == "bf16"
    assert troof.model_row(m.spec.extra)["precision"] == "bf16"
    mixed = troof.measure_launch_cost(
        lambda x: ((x @ wb).float() @ torch.ones(64, 512)), torch.ones(8, 64,
                                                                        dtype=torch.bfloat16))
    assert mixed["compute_precision"] == "f32"


@pytest.fixture(scope="module")
def tiny_pairs():
    """{name: (JAX device_fn, port device_fn, the port's network, inputs)}."""
    yv = yolo_variables()
    jpipe, _, _ = jdet2d.build_yolov5_pipeline(
        jax.random.PRNGKey(0), variant="n", num_classes=2, input_hw=HW, variables=yv,
        config=jdet2d.Detect2DConfig(**CFG_2D))
    tpipe, _, tmodel = tdet2d.build_yolov5_pipeline(
        variant="n", num_classes=2, input_hw=HW, variables=yv,
        config=tdet2d.Detect2DConfig(**CFG_2D), device="cpu")
    x = frames(0, 2)
    out = {"yolov5n": (jpipe.device_fn(), tpipe.device_fn(),
                       lambda: tmodel(torch.zeros((2, *HW, 3))), {"images": x})}
    jcfg, tcfg = tiny_configs()
    pv = pointpillars_variables(jcfg)
    jpipe, _, _ = jdet3d.build_pointpillars_pipeline(
        jax.random.PRNGKey(0), model_cfg=jcfg, config=jdet3d.Detect3DConfig(**CFG_3D),
        variables=pv)
    tpipe, _, _ = tdet3d.build_pointpillars_pipeline(
        model_cfg=tcfg, config=tdet3d.Detect3DConfig(**CFG_3D), variables=pv, device="cpu")
    s = scan(0)
    ts = {k: torch.from_numpy(np.asarray(v)) for k, v in s.items()}
    out["pointpillars"] = (jpipe.device_fn(), tpipe.device_fn(),
                           lambda: tpipe.heads(ts["points"], ts["num_points"]), s)
    return out


@pytest.mark.parametrize("name", sorted(COST_RATIOS))
def test_measure_launch_cost_counts_the_network_and_pins_the_ratio_to_jax(tiny_pairs, name,
                                                                          record_property):
    jfn, tfn, network, inputs = tiny_pairs[name]
    tin = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}
    port = troof.measure_launch_cost(tfn, tin, batch_rows=2)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        network()
    assert port["flops"] == counter.get_total_flops() > 0
    assert port["batch"] == 2
    ref = jroof.measure_launch_cost(jax.jit(jfn), inputs)
    record_property("port", port)
    record_property("jax", ref)
    flops_ratio, bytes_ratio = COST_RATIOS[name]
    assert port["flops"] / ref["flops"] == pytest.approx(flops_ratio, rel=0.01)
    assert port["bytes"] / ref["bytes"] == pytest.approx(bytes_ratio, rel=0.01)


def _results_doc():
    return {"rows": [
        {"metric": "yolov5n_fps", "precision": "bf16", "flops_per_call": 8.2e9,
         "bytes_per_call": 6.1e7, "arithmetic_intensity": 134.4, "roofline_bound": "compute",
         "attainable_fps": 120000.0, "value": 1685.0, "roofline_attained_ratio": 0.014},
        {"metric": "pillars_fps", "flops_per_frame": 6.3e10, "bytes_per_frame": 9e8,
         "roofline_bound": "bandwidth", "attainable_fps": 3600.0, "value": 95.0},
        {"metric": "no_roofline", "value": 3.0},
    ]}


@pytest.mark.parametrize("as_json", [True, False])
def test_roofline_tool_matches_jax_on_a_results_json(tmp_path, capsys, as_json):
    path = tmp_path / "results.json"
    path.write_text(json.dumps(_results_doc()))
    argv = [str(path)] + (["--json"] if as_json else [])
    jtools.roofline(argv)
    jout = capsys.readouterr().out
    ttools.roofline(argv)
    tout = capsys.readouterr().out
    assert tout == jout
    if as_json:
        assert [r["model"] for r in json.loads(tout)["rows"]] == ["yolov5n_fps", "pillars_fps"]


def test_roofline_tool_reads_a_model_snapshot_file(tmp_path, capsys):
    extra = {"measured_flops_per_call": 8.3e9, "measured_bytes_per_call": 2.1e7,
             "measured_batch": 1, "precision": "bf16"}
    snapshot = {"models": [
        {"model": "yolov5_crop", "version": "1", "roofline": troof.model_row(extra, 600.0)},
        {"model": "bare", "version": "1"},
    ]}
    path = tmp_path / "models.json"
    path.write_text(json.dumps(snapshot))
    ttools.roofline([str(path), "--json"])
    rows = json.loads(capsys.readouterr().out)["rows"]
    assert len(rows) == 1 and rows[0]["model"] == "yolov5_crop:1"
    assert rows[0]["bound"] == "compute"
    assert rows[0]["attained_fraction"] == pytest.approx(600.0 * 8.3e9 / 989e12)
    ttools.roofline([str(path)])
    assert "yolov5_crop:1" in capsys.readouterr().out


def test_roofline_tool_live_url_is_not_ported_and_empty_file_exits(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 8"):
        ttools.roofline(["http://127.0.0.1:8002"])
    path = tmp_path / "empty.json"
    path.write_text("{}")
    with pytest.raises(SystemExit, match="no roofline rows"):
        ttools.roofline([str(path)])
