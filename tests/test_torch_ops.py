"""The port's tensor ops against the JAX package's, on the same numpy
inputs: boxes, preprocessing, the YOLO grid decode, the NMS
formulations and the stable top-k."""

import importlib
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_client_tpu.ops import boxes as jboxes
from triton_client_tpu.ops import preprocess as jpre
from triton_client_tpu.ops import yolo_decode as jdecode

from triton_client_tpu_torch.ops import boxes as tboxes
from triton_client_tpu_torch.ops import gpu_nms
from triton_client_tpu_torch.ops import kernel_cases
from triton_client_tpu_torch.ops import nms as tnms
from triton_client_tpu_torch.ops import preprocess as tpre
from triton_client_tpu_torch.ops import yolo_decode as tdecode
from triton_client_tpu_torch.ops.detect_postprocess import stable_top_k
from torch_threads import one_torch_thread  # noqa: F401

# the module: the package's __init__ re-exports a function of this name
jnms = importlib.import_module("triton_client_tpu.ops.nms")

GOLDEN = pathlib.Path(__file__).parent / "golden"


def _boxes(rng, n):
    centers = rng.uniform(30, 480, (n, 2))
    wh = rng.uniform(10, 120, (n, 2))
    return np.concatenate([centers - wh / 2, centers + wh / 2], 1).astype(np.float32)


def test_boxes_match_jax(rng):
    xywh = rng.uniform(-50, 600, (3, 40, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tboxes.xywh2xyxy(torch.from_numpy(xywh)).numpy(), np.asarray(jboxes.xywh2xyxy(xywh))
    )
    xyxy = rng.uniform(-50, 600, (3, 40, 4)).astype(np.float32)  # some degenerate
    np.testing.assert_array_equal(
        tboxes.box_area(torch.from_numpy(xyxy)).numpy(), np.asarray(jboxes.box_area(xyxy))
    )
    np.testing.assert_array_equal(
        tboxes.scale_boxes(torch.from_numpy(xyxy), (512, 512), (480, 640)).numpy(),
        np.asarray(jboxes.scale_boxes(jnp.asarray(xyxy), (512, 512), (480, 640))),
    )


@pytest.mark.parametrize("scaling", ["yolo", "inception", "vgg", "none"])
def test_normalize_matches_jax(rng, scaling):
    img = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        tpre.normalize_image(torch.from_numpy(img), scaling).numpy(),
        np.asarray(jpre.normalize_image(jnp.asarray(img), scaling)),
    )


@pytest.mark.parametrize(
    "in_hw,out_hw",
    [
        ((480, 640), (512, 512)),  # the camera frame: H up, W down
        ((600, 800), (512, 512)),  # both down (antialiased)
        ((48, 80), (64, 64)),
    ],
)
def test_resize_matches_jax_image_resize(rng, in_hw, out_hw):
    """Against ``jax.image.resize(..., "bilinear")`` as
    ``pipelines/detect2d.py`` calls it. Both use half-pixel centres and
    widen the triangle kernel when downscaling, and both renormalise the
    weights where the kernel leaves the image; they may differ in float
    rounding and in the edge rows and columns. At these shapes the
    largest difference is 3.1e-5 on the 0..255 scale (an ulp or two),
    edges included; the bound is atol 1e-3."""
    frames = rng.integers(0, 256, (2, *in_hw, 3), dtype=np.uint8).astype(np.float32)
    got = tpre.resize_bilinear(torch.from_numpy(frames), out_hw).numpy()
    want = np.asarray(
        jax.image.resize(jnp.asarray(frames), (2, *out_hw, 3), method="bilinear")
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("variant,normalize_hw", [("v5", None), ("v4", None), ("v4", (64, 96))])
def test_decode_yolo_grid_matches_jax(rng, variant, normalize_hw):
    raw = rng.normal(0, 2, (2, 4, 6, 3, 7)).astype(np.float32)
    anchors = np.asarray([(10, 13), (16, 30), (33, 23)], np.float32)
    got = tdecode.decode_yolo_grid(torch.from_numpy(raw), anchors, 16, variant, normalize_hw)
    want = jdecode.decode_yolo_grid(jnp.asarray(raw), anchors, 16, variant, normalize_hw)
    # sigmoid/exp differ in the last ulps between the two libraries
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def _nms_inputs(kind, n=96, b=2):
    parts = [kernel_cases.nms_inputs(kind, n, seed=9 + i) for i in range(b)]
    return np.stack([p[0] for p in parts]), np.stack([p[1] for p in parts])


@pytest.mark.parametrize("kind", ["random", "ties", "chain", "all_invalid"])
@pytest.mark.parametrize("form", ["_nms_fixpoint", "_nms_xla"])
def test_nms_formulations_match_jax(kind, form):
    boxes, scores = _nms_inputs(kind)
    idx, valid = getattr(tnms, form)(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, 40)
    for i in range(boxes.shape[0]):
        want_idx, want_valid = getattr(jnms, form)(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.45, max_det=40
        )
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(want_valid))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(want_idx))


@pytest.mark.parametrize("mode", ["auto", "fixpoint", "xla", "pallas"])
def test_nms_routes_agree_on_golden(monkeypatch, rng, mode):
    """Every route (pallas = the kernel's plain version on CPU tensors)
    reproduces tests/golden/nms_256.json, whose inputs are drawn as
    tests/test_golden_outputs.py draws them."""
    monkeypatch.setenv("TRITON_CLIENT_TPU_NMS", mode)
    centers = rng.uniform(30, 480, (256, 2))
    wh = rng.uniform(10, 120, (256, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], 1).astype(np.float32)
    scores = rng.uniform(0.01, 1, 256).astype(np.float32)
    idx, valid = tnms.nms(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None], 0.45, 64)
    kept = idx[0][valid[0]].numpy()
    want = json.loads((GOLDEN / "nms_256.json").read_text())["kept"]
    np.testing.assert_array_equal(kept, np.asarray(want))


def test_nms_mode_routes_like_jax(monkeypatch):
    for mode in ("auto", "fixpoint", "xla", "pallas"):
        monkeypatch.setenv("TRITON_CLIENT_TPU_NMS", mode)
        for n in (1024, 5000, 16128):
            # pallas stays pallas at every size: past a block's shared
            # memory the kernel's wrapper raises on a CUDA tensor instead
            # of falling back, as the JAX route does past its VMEM budget
            want = "pallas" if mode == "pallas" else jnms._nms_mode(n, 300)
            assert tnms._nms_mode(n, 300) == want
    monkeypatch.setenv("TRITON_CLIENT_TPU_NMS", "pallas")
    assert jnms._nms_mode(1024, 300) == "pallas"


def test_nms_pallas_past_shared_memory_runs_plain_on_cpu(monkeypatch, rng):
    """On CPU tensors ``pallas`` is the kernel's plain version, which has
    no shared-memory limit: past it, the indices equal the sequential
    loop's."""
    n = 16385  # one past the largest N the kernel takes
    assert not gpu_nms.smem_fits(n)
    centers = rng.uniform(0, 2000, (n, 2))
    wh = rng.uniform(5, 80, (n, 2))
    boxes = torch.from_numpy(
        np.concatenate([centers - wh / 2, centers + wh / 2], 1).astype(np.float32)
    )[None]
    scores = torch.from_numpy(rng.uniform(0.01, 1, n).astype(np.float32))[None]
    monkeypatch.setenv("TRITON_CLIENT_TPU_NMS", "pallas")
    idx, valid = tnms.nms(boxes, scores, 0.45, 50)
    want_idx, want_valid = tnms._nms_xla(boxes, scores, 0.45, 50)
    assert torch.equal(idx, want_idx) and torch.equal(valid, want_valid)


@pytest.mark.parametrize("agnostic", [False, True])
def test_batched_nms_and_nms_padded_match_jax(rng, agnostic):
    b, n = 2, 128
    boxes = np.stack([_boxes(rng, n) for _ in range(b)])
    scores = rng.uniform(0.01, 1, (b, n)).astype(np.float32)
    classes = rng.integers(0, 3, (b, n)).astype(np.int32)
    valid = rng.uniform(size=(b, n)) < 0.7
    t = [torch.from_numpy(a) for a in (boxes, scores, classes, valid)]
    idx, keep = tnms.batched_nms(t[0], t[1], t[2], 0.45, 50, agnostic)
    rows, rkeep = tnms.nms_padded(*t, iou_thresh=0.45, max_det=50, class_agnostic=agnostic)
    for i in range(b):
        want_idx, want_keep = jnms.batched_nms(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(classes[i]),
            0.45, max_det=50, class_agnostic=agnostic,
        )
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(want_keep))
        want_rows, want_rkeep = jnms.nms_padded(
            *(jnp.asarray(a[i]) for a in (boxes, scores, classes, valid)),
            iou_thresh=0.45, max_det=50, class_agnostic=agnostic,
        )
        np.testing.assert_array_equal(rkeep[i].numpy(), np.asarray(want_rkeep))
        np.testing.assert_array_equal(rows[i].numpy(), np.asarray(want_rows))


def test_stable_top_k_fills_invalid_slots_like_lax_top_k(rng):
    """Most gated scores are -inf and many valid ones tie: the order of
    equal values (ascending index, as jax.lax.top_k) decides which
    boxes fill the slots, so it must match exactly."""
    scores = np.round(rng.uniform(0, 1, (3, 500)) * 3) / 3
    scores = np.where(rng.uniform(size=(3, 500)) < 0.9, -np.inf, scores).astype(np.float32)
    values, indices = stable_top_k(torch.from_numpy(scores), 128)
    want_values, want_indices = jax.lax.top_k(jnp.asarray(scores), 128)
    np.testing.assert_array_equal(indices.numpy(), np.asarray(want_indices))
    np.testing.assert_array_equal(values.numpy(), np.asarray(want_values))
    assert np.isinf(values.numpy()).any()  # invalid slots were filled
