"""The 3D candidate stage, fused route against unfused, on the CPU.

The fused route selects the top-k candidates without gathering the
decode's inputs (``topk_indices``) and decodes them in one call that reads
their rows through ``top_idx`` (``ops/gpu_decode3d.gather_residual_decode``,
kernel 3's gathered form; on CPU tensors its plain version). The unfused
route is the reference chain: ``topk_candidates`` (the same selection, then
the gathers) and ``decode_candidates``. On PointPillars and SECOND-IoU at
their tiny grids, one layer a block, the two must give the same boxes,
scores and labels BITWISE, also when the direction logits tie or hold NaNs;
the pipelines' rows are equal by value (the fused packing writes +0.0 where
the unfused one keeps -0.0, tests/test_torch_detect3d.py).
"""

import numpy as np
import pytest
import torch

from triton_client_tpu_torch.models.pointpillars import decode_candidates
from triton_client_tpu_torch.ops import gpu_decode3d
from triton_client_tpu_torch.pipelines import detect3d as tdet
from tests.test_torch_pointpillars import cloud, tiny_configs
from tests.test_torch_second import port_config, second_cloud

CFG = dict(point_buckets=(1024,), max_det=16, pre_max=64)


def _build(model: str, fused: str):
    if model == "pointpillars":
        return tdet.build_pointpillars_pipeline(
            model_cfg=tiny_configs()[1], config=tdet.Detect3DConfig(fused=fused, **CFG),
            device="cpu", seed=3,
        )[0]
    return tdet.build_second_pipeline(
        model_cfg=port_config(),
        config=tdet.Detect3DConfig(model_name="second_iou", fused=fused, **CFG), device="cpu",
        seed=3,
    )[0]


def _points(model: str, seed: int):
    pc = cloud(seed, 600) if model == "pointpillars" else second_cloud(seed, 600)
    padded, m = tdet.prepare_points(pc, 4, (1024,))
    return torch.from_numpy(padded), torch.tensor(m, dtype=torch.int32)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("dirs", ["as_computed", "ties", "nan"])
@pytest.mark.parametrize("model", ["pointpillars", "second"])
def test_fused_candidate_stage_equals_unfused_bitwise(model, dirs):
    pipe = _build(model, "off")
    net, mc = pipe.model, pipe.model.cfg
    with torch.no_grad():
        heads = net.from_points(*_points(model, seed=40))
    if dirs != "as_computed":
        rng = np.random.default_rng(41)
        d = heads["dir"]
        pick = torch.from_numpy(rng.uniform(size=d.shape[:-1]) < 0.3)
        if dirs == "ties":  # equal logits: the first bin is taken
            d[..., 1] = torch.where(pick, d[..., 0], d[..., 1])
        else:  # a NaN ranks above every number
            d[..., 1] = torch.where(pick, float("nan"), d[..., 1])
    sel = net.topk_indices(heads, CFG["pre_max"], pipe.config.score_thresh)
    boxes = gpu_decode3d.gather_residual_decode(
        *tdet.gathered_decode_args(net, heads, sel["top_idx"]))
    cand = net.topk_candidates(heads, CFG["pre_max"], pipe.config.score_thresh)
    want = decode_candidates(cand, mc.num_dir_bins, mc.dir_offset)
    assert boxes.shape == (1, CFG["pre_max"], 7) and sel["top_idx"].dtype == torch.int64
    assert torch.equal(_bits(boxes), _bits(want["boxes"]))
    assert torch.equal(_bits(sel["scores"]), _bits(want["scores"]))
    assert torch.equal(sel["labels"], want["labels"])
    assert bool(torch.isfinite(sel["scores"]).any())
    if dirs != "as_computed":  # both bins were taken
        assert 0 < int(cand["dir_bin"].sum()) < cand["dir_bin"].numel()


@pytest.mark.parametrize("model", ["pointpillars", "second"])
def test_fused_route_decodes_through_top_idx(model, monkeypatch):
    """The fused pipeline decodes through ``gather_residual_decode`` once a
    scan, handing it the top-k indices and not gathered rows, and its rows
    equal the unfused pipeline's by value."""
    calls = []

    def spy(box_head, anchors, dir_logits, top_idx, *args):
        calls.append((tuple(box_head.shape), tuple(anchors.shape), tuple(top_idx.shape)))
        return gpu_decode3d.gather_residual_decode(box_head, anchors, dir_logits, top_idx, *args)

    monkeypatch.setattr(tdet, "gather_residual_decode", spy)
    pipes = {f: _build(model, f) for f in ("on", "off")}
    assert "decode_nms" in pipes["on"].fused_stages and pipes["off"].fused_stages == ()
    n_anchors = pipes["on"].model.anchors.shape[0]
    for seed in range(2):
        points = _points(model, seed=50 + seed)
        rows = {f: p.run(*points) for f, p in pipes.items()}
        assert torch.equal(rows["on"][1], rows["off"][1]) and bool(rows["on"][1].any())
        assert torch.equal(rows["on"][0], rows["off"][0])
    assert calls == [((1, n_anchors, 7), (n_anchors, 7), (1, CFG["pre_max"]))] * 2
