"""The port's CUDA kernels against the JAX package's TPU kernels.

On the CPU each wrapper runs its plain PyTorch version, which must equal
the Pallas kernel run in interpret mode BITWISE: rows and keep for the
fused decode+NMS tail, index sequences (invalid slots included) and
valid for greedy NMS, rows and keep for the 3D suppress+pack given the
same IoU matrix. The 3D residual decode is the exception: XLA's CPU code
contracts a product and a sum into an FMA where the port (and the CUDA
kernel, built with ``--fmad=false``) rounds twice, and its ``exp`` is
another polynomial, so the plain version is held to 4 ulps of the
operands' magnitude there. The sorted-segment mean of SECOND's voxel
stage is held to its Pallas kernel in tests/test_torch_second.py, the
segment sum of packed ragged batches in tests/test_torch_ragged.py. The CUDA
kernels themselves are held against the plain versions on the card (``cuda``-marked tests here, and
``chip_smoke.py``). The JAX package is imported inside the tests that
use it, so the card's machine, which has no JAX, runs the ``cuda`` tests
with ``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

from triton_client_tpu_torch.ops import (
    cuda_build,
    gpu_decode,
    gpu_decode3d,
    gpu_nms,
    gpu_segment,
    gpu_suppress3d,
    gpu_voxel,
    kernel_cases,
)
from torch_threads import one_torch_thread  # noqa: F401

B = 2

# (kind, K, max_det, box_format, class_agnostic)
DECODE_CASES = [
    ("random", 1024, 300, "xywh", False),  # the main path's shapes
    ("random", 100, 32, "xyxy", True),
    ("ties", 1024, 32, "xywh", True),
    ("ties", 100, 300, "xyxy", False),
    ("all_invalid", 100, 32, "xywh", False),
    ("chain", 100, 300, "xyxy", False),
    ("large", 1024, 32, "xywh", False),
    ("nan", 100, 32, "xywh", False),
    ("nan", 1024, 300, "xyxy", True),
]


def _jax_decode(boxes, scores, classes, valid, max_det, fmt, agnostic, iou=0.45):
    import jax.numpy as jnp
    from triton_client_tpu.ops.pallas_decode import fused_decode_nms_2d as jax_fused

    rows, keep = [], []
    for i in range(boxes.shape[0]):
        r, k = jax_fused(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(classes[i]),
            jnp.asarray(valid[i]), iou_thresh=iou, max_det=max_det, box_format=fmt,
            class_agnostic=agnostic, interpret=True,
        )
        rows.append(np.asarray(r))
        keep.append(np.asarray(k))
    return np.stack(rows), np.stack(keep)


@pytest.mark.parametrize("kind,k,max_det,fmt,agnostic", DECODE_CASES)
def test_decode_nms_2d_plain_matches_tpu_kernel_bitwise(kind, k, max_det, fmt, agnostic):
    boxes, scores, classes, valid = kernel_cases.batch(kind, B, k, seed=11, box_format=fmt)
    want_rows, want_keep = _jax_decode(boxes, scores, classes, valid, max_det, fmt, agnostic)
    rows, keep = gpu_decode.decode_nms_2d_reference(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(classes),
        torch.from_numpy(valid), iou_thresh=0.45, max_det=max_det, box_format=fmt,
        class_agnostic=agnostic,
    )
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    if kind in ("all_invalid", "nan"):  # a live NaN is the first pick, an invalid one
        assert not want_keep.any()
    elif kind == "chain":
        # greedy keeps every second box of the chain
        assert want_keep.sum(1).tolist() == [50, 50]


@pytest.mark.parametrize("nc,iou", [(80, 0.5), (2, 0.6)], ids=["retinanet_coco", "fcos_crop"])
def test_decode_nms_2d_plain_matches_tpu_kernel_on_the_scored_tail(nc, iou):
    """The detectron family's tail (``kernel_cases.scored_candidates``):
    multi-label xyxy candidates, class-aware over 80 or 2 classes, max_det
    100, K = 1024, with boxes past the decode's clamp whose class offsets
    reach ~1e7: rows and keep bitwise equal to the Pallas kernel's."""
    arrays = kernel_cases.scored_candidates(B, 1024, nc, seed=31)
    boxes, scores, classes, valid = arrays
    assert np.abs(boxes[valid]).max() > 1e4 and len(np.unique(classes)) == nc
    want_rows, want_keep = _jax_decode(*arrays, 100, "xyxy", False, iou)
    rows, keep = gpu_decode.decode_nms_2d_reference(
        *(torch.from_numpy(a) for a in arrays), iou_thresh=iou, max_det=100, box_format="xyxy",
        class_agnostic=False,
    )
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    assert want_keep.sum(1).min() == 100 and np.abs(want_rows[..., :4]).max() > 1e4


NMS_CASES = [
    ("random", 1024, 300),
    ("ties", 1024, 300),
    ("random", 100, 32),
    ("all_invalid", 100, 32),
    ("chain", 100, 300),
    ("nan", 100, 32),
]


@pytest.mark.parametrize("kind,n,max_det", NMS_CASES)
def test_nms_greedy_plain_matches_tpu_kernel(kind, n, max_det):
    import jax.numpy as jnp
    from triton_client_tpu.ops.pallas_nms import nms_pallas as jax_nms_pallas

    parts = [kernel_cases.nms_inputs(kind, n, seed=5 + i) for i in range(B)]
    boxes = np.stack([p[0] for p in parts])
    scores = np.stack([p[1] for p in parts])
    idx, valid = gpu_nms.nms_greedy_reference(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, max_det
    )
    for i in range(B):
        want_idx, want_valid = jax_nms_pallas(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.45, max_det=max_det,
            interpret=True,
        )
        # identical sequences, invalid slots (index 0) included
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(want_valid))
        if kind == "nan":  # every slot invalid, at the first NaN's index
            assert not valid[i].any()
            assert (idx[i] == int(np.flatnonzero(np.isnan(scores[i]))[0])).all()


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    gpu_decode.launches.reset()
    gpu_nms.launches.reset()
    boxes, scores, classes, valid = kernel_cases.batch("random", B, 64, seed=3)
    args = [torch.from_numpy(a) for a in (boxes, scores, classes, valid)]
    rows, keep = gpu_decode.fused_decode_nms_2d(*args, max_det=16)
    want = gpu_decode.decode_nms_2d_reference(*args, max_det=16)
    assert torch.equal(rows, want[0]) and torch.equal(keep, want[1])
    nb, ns = kernel_cases.nms_inputs("random", 64)
    idx, val = gpu_nms.nms_greedy(torch.from_numpy(nb)[None], torch.from_numpy(ns)[None], 0.45, 16)
    want_idx, want_val = gpu_nms.nms_greedy_reference(
        torch.from_numpy(nb)[None], torch.from_numpy(ns)[None], 0.45, 16
    )
    assert torch.equal(idx, want_idx) and torch.equal(val, want_val)
    assert gpu_decode.launches.count == 0
    assert gpu_nms.launches.count == 0


def test_smem_limits():
    # the main path's K = 1024 fits with room to spare; past the 227 KB
    # a block may use (for kernels 1 and 2: past K = 16,384, where the
    # order pass's sort fills it), the wrappers raise on CUDA tensors.
    # Kernel 2 takes the reference's 16,128-box YOLO heads.
    assert gpu_decode.smem_bytes(1024) == 70656 and gpu_nms.smem_bytes(1024) == 70656
    assert gpu_decode.smem_fits(1024) and gpu_nms.smem_fits(1024)
    assert gpu_decode.smem_fits(8192) and gpu_decode.smem_bytes(16384) == 196608
    assert gpu_decode.smem_fits(16384) and not gpu_decode.smem_fits(16385)
    assert gpu_nms.smem_fits(16128) and gpu_nms.smem_fits(16384)
    assert not gpu_nms.smem_fits(16385) and gpu_nms.smem_bytes(16384) == 196608
    assert not gpu_decode.smem_fits(32768) and not gpu_nms.smem_fits(32768)


# -- 3D: residual decode (kernel 3) and rotated suppress+pack (kernel 4) --


def _decode_tolerance(deltas, anchors, want):
    """4 ulps of each column's operand magnitude: |d * diag| + |xa| for the
    centres, |d * dza| + |za| for z, the result for the exp columns, and
    |rot| + 2 pi for the heading."""
    d = deltas.astype(np.float64)
    a = anchors.astype(np.float64)
    diag = np.sqrt(a[:, 3] ** 2 + a[:, 4] ** 2)
    scale = np.column_stack(
        [
            np.abs(d[:, 0] * diag) + np.abs(a[:, 0]),
            np.abs(d[:, 1] * diag) + np.abs(a[:, 1]),
            np.abs(d[:, 2] * a[:, 5]) + np.abs(a[:, 2]),
            np.abs(want[:, 3:6]),
            np.abs(d[:, 6] + a[:, 6]) + 2 * np.pi,
        ]
    )
    return 4 * np.spacing(scale.astype(np.float32))


@pytest.mark.parametrize("kind", kernel_cases.DECODE3D_KINDS)
def test_residual_decode_plain_matches_tpu_kernel(kind):
    import jax.numpy as jnp
    from triton_client_tpu.ops.pallas_decode import fused_residual_decode as jax_decode

    deltas, anchors, dir_bin = kernel_cases.decode3d_inputs(kind, 256, seed=12)
    want = np.asarray(
        jax_decode(jnp.asarray(deltas), jnp.asarray(anchors), jnp.asarray(dir_bin),
                   num_dir_bins=2, dir_offset=0.78539, interpret=True)
    )
    got = gpu_decode3d.residual_decode_reference(
        torch.from_numpy(deltas), torch.from_numpy(anchors), torch.from_numpy(dir_bin)
    ).numpy()
    err = np.abs(got.astype(np.float64) - want)
    tol = _decode_tolerance(deltas, anchors, want)
    assert (err <= tol).all(), f"max excess {np.max(err - tol)} in columns {np.where(err > tol)[1]}"
    # the plain version equals the unfused op chain of the pipeline bit for bit
    from triton_client_tpu_torch.models.pointpillars import decode_candidates

    chain = decode_candidates(
        {"deltas": torch.from_numpy(deltas), "anchors": torch.from_numpy(anchors),
         "dir_bin": torch.from_numpy(dir_bin), "scores": None, "labels": None},
        2, 0.78539,
    )["boxes"]
    assert torch.equal(chain, torch.from_numpy(got))


@pytest.mark.parametrize("dir_kind", kernel_cases.DIR_KINDS)
@pytest.mark.parametrize("kind", kernel_cases.DECODE3D_KINDS)
def test_gather_residual_decode_plain_matches_tpu_kernel(kind, dir_kind):
    """The gathered form's plain version against the JAX package's fused
    route: its gathers (``take_along_axis`` of the box head and direction
    logits, ``anchors[top_idx]``, ``jnp.argmax``) and the Pallas kernel in
    interpret mode, vmapped over the batch as ``pipelines/detect3d.py``
    runs it. Equal direction bins (ties to the first maximum, a NaN above
    every number); boxes within the 4 ulps of the ungathered test."""
    import jax
    import jax.numpy as jnp
    from triton_client_tpu.ops.pallas_decode import fused_residual_decode as jax_decode

    box_head, anchors, logits, top_idx = kernel_cases.gather_decode3d_inputs(
        kind, 2, 300, 64, dir_kind, seed=13)
    idx = jnp.asarray(top_idx)[..., None]
    deltas = jnp.take_along_axis(jnp.asarray(box_head), idx, axis=1)
    anchors_k = jnp.asarray(anchors)[jnp.asarray(top_idx)]
    bins = jnp.argmax(jnp.take_along_axis(jnp.asarray(logits), idx, axis=1), axis=-1)
    want = np.asarray(jax.vmap(
        lambda d, a, db: jax_decode(d, a, db, num_dir_bins=2, dir_offset=0.78539, interpret=True)
    )(deltas, anchors_k, bins))
    t = [torch.from_numpy(x) for x in (box_head, anchors, logits, top_idx)]
    got = gpu_decode3d.gather_residual_decode_reference(*t, 2, 0.78539).numpy()
    port_bins = torch.take_along_dim(t[2], t[3][..., None], dim=1).argmax(-1)
    np.testing.assert_array_equal(port_bins.numpy(), np.asarray(bins))
    if dir_kind != "random":  # the rule was exercised: a tie or a NaN decided a bin
        assert 0 < int(port_bins.sum()) < port_bins.numel()
    d_np, a_np = np.asarray(deltas).reshape(-1, 7), np.asarray(anchors_k).reshape(-1, 7)
    err = np.abs(got.reshape(-1, 7).astype(np.float64) - want.reshape(-1, 7))
    tol = _decode_tolerance(d_np, a_np, want.reshape(-1, 7))
    assert (err <= tol).all(), f"max excess {np.max(err - tol)} in columns {np.where(err > tol)[1]}"
    # the gathered form's plain version is the topk_candidates chain, bit for bit
    chain = gpu_decode3d.residual_decode_reference(
        torch.from_numpy(np.array(deltas)), torch.from_numpy(np.array(anchors_k)),
        torch.from_numpy(np.array(bins)), 2, 0.78539)
    assert torch.equal(chain.view(torch.int32), torch.from_numpy(got).view(torch.int32))


def _jax_sorted_matrix(boxes, scores, labels):
    """The JAX package's kernel inputs, built as its fused_suppress_pack_3d
    builds them: stable score sort, gathers, rotated IoU of the sorted
    BEV boxes."""
    import jax.numpy as jnp
    from triton_client_tpu.ops.boxes3d import boxes7_to_bev, rotated_iou_bev

    order = np.argsort(-scores, kind="stable")
    bev = boxes7_to_bev(jnp.asarray(boxes[order]))
    iou = np.array(rotated_iou_bev(bev, bev))
    rows = np.column_stack([boxes[order], scores[order], labels[order].astype(np.float32)])
    return iou, rows.astype(np.float32)


@pytest.mark.parametrize("kind", kernel_cases.SUPPRESS3D_KINDS)
def test_suppress_pack_3d_plain_matches_tpu_kernel_bitwise(kind):
    """The plain version fed the JAX-built sorted IoU matrix equals the
    Pallas kernel (interpret mode) bit for bit: rows and keep. K = 128
    keeps interpret mode fast."""
    import jax.numpy as jnp
    from triton_client_tpu.ops.pallas_decode import fused_suppress_pack_3d as jax_pack

    max_det = 64
    boxes, scores, labels = kernel_cases.suppress3d_inputs(kind, 128, seed=13)
    want_rows, want_keep = jax_pack(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels), iou_thresh=0.01,
        max_det=max_det, interpret=True,
    )
    iou, rows = _jax_sorted_matrix(boxes, scores, labels)
    got_rows, got_keep = gpu_suppress3d.suppress_pack_3d_reference(
        torch.from_numpy(iou)[None], torch.from_numpy(rows)[None], 0.01, max_det
    )
    np.testing.assert_array_equal(got_keep[0].numpy(), np.asarray(want_keep))
    np.testing.assert_array_equal(got_rows[0].numpy(), np.asarray(want_rows))
    kept = int(got_keep.sum())
    live = int(np.isfinite(scores).sum())
    if kind in ("all_gated", "nan"):  # a live NaN is the first pick, an invalid one
        assert kept == 0 and not got_rows.any()
    elif kind == "few":
        assert 0 < kept <= live < max_det
    elif kind == "disjoint":
        assert kept == max_det < live  # more kept than max_det
    elif kind == "identical":
        assert kept <= (live + 3) // 4 + 1


def _with_velocity(kind, k, seed):
    """Kernel 4's candidates as CenterPoint hands them over: (k, 9) boxes
    whose columns 7:9 are a velocity riding through, 11-column rows."""
    boxes, scores, labels = kernel_cases.suppress3d_inputs(kind, k, seed=seed)
    vel = np.random.default_rng(seed + 1).normal(0, 3, (k, 2)).astype(boxes.dtype)
    return np.concatenate([boxes, vel], 1), scores, labels


@pytest.mark.parametrize("kind", kernel_cases.SUPPRESS3D_KINDS)
def test_suppress_pack_3d_plain_matches_tpu_kernel_with_velocity_columns(kind):
    """CenterPoint's shape: K = 128 candidates of 11-column rows, max_det
    128; the velocity columns come through untouched, bit for bit."""
    import jax.numpy as jnp
    from triton_client_tpu.ops.pallas_decode import fused_suppress_pack_3d as jax_pack

    boxes, scores, labels = _with_velocity(kind, 128, seed=16)
    want_rows, want_keep = jax_pack(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels), iou_thresh=0.2,
        max_det=128, interpret=True,
    )
    got_rows, got_keep = gpu_suppress3d.fused_suppress_pack_3d(
        *(torch.from_numpy(a)[None] for a in (boxes, scores, labels)), 0.2, 128)
    assert got_rows.shape == (1, 128, 11)
    np.testing.assert_array_equal(got_keep[0].numpy(), np.asarray(want_keep))
    np.testing.assert_array_equal(got_rows[0].numpy(), np.asarray(want_rows))
    assert gpu_suppress3d.smem_fits(128, 11)
    assert gpu_suppress3d.smem_bytes(128, 11) < gpu_suppress3d.smem_bytes(256, 9)


def test_suppress_pack_3d_plain_matches_tpu_kernel_at_the_threshold(monkeypatch):
    """IoUs equal to the float32 threshold (and one ulp either side) in the
    matrix: ``iou > thresh`` suppresses only those above. The JAX function
    is fed the planted matrix in place of its rotated IoU."""
    import jax.numpy as jnp
    from triton_client_tpu.ops import boxes3d as jax_boxes3d
    from triton_client_tpu.ops.pallas_decode import fused_suppress_pack_3d as jax_pack

    k, max_det = 96, 48  # a shape no other test traces, so the patch is what jit sees
    iou, rows = kernel_cases.planted_iou(k, seed=14)
    monkeypatch.setattr(jax_boxes3d, "rotated_iou_bev", lambda a, b: jnp.asarray(iou))
    want_rows, want_keep = jax_pack(
        jnp.asarray(rows[:, :7]), jnp.asarray(rows[:, 7]), jnp.asarray(rows[:, 8]),
        iou_thresh=0.01, max_det=max_det, interpret=True,
    )
    got_rows, got_keep = gpu_suppress3d.suppress_pack_3d_reference(
        torch.from_numpy(iou)[None], torch.from_numpy(rows)[None], 0.01, max_det
    )
    np.testing.assert_array_equal(got_keep[0].numpy(), np.asarray(want_keep))
    np.testing.assert_array_equal(got_rows[0].numpy(), np.asarray(want_rows))
    assert 1 < int(got_keep.sum()) < max_det


def test_3d_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    gpu_decode3d.launches.reset()
    gpu_suppress3d.launches.reset()
    gpu_decode3d.gathered_launches.reset()
    d, a, b = (torch.from_numpy(x) for x in kernel_cases.decode3d_inputs("random", 32))
    assert torch.equal(gpu_decode3d.fused_residual_decode(d, a, b),
                       gpu_decode3d.residual_decode_reference(d, a, b))
    g = [torch.from_numpy(x) for x in kernel_cases.gather_decode3d_inputs("random", 2, 64, 16)]
    assert torch.equal(gpu_decode3d.gather_residual_decode(*g),
                       gpu_decode3d.gather_residual_decode_reference(*g))
    boxes, scores, labels = (torch.from_numpy(x)[None]
                             for x in kernel_cases.suppress3d_inputs("random", 32))
    rows, keep = gpu_suppress3d.fused_suppress_pack_3d(boxes, scores, labels, 0.01, 16)
    iou, srows = gpu_suppress3d.sorted_candidates(boxes, scores, labels)
    want_rows, want_keep = gpu_suppress3d.suppress_pack_3d_reference(iou, srows, 0.01, 16)
    assert torch.equal(rows, want_rows) and torch.equal(keep, want_keep)
    assert rows.shape == (1, 16, 9) and bool(keep.any())
    assert gpu_decode3d.launches.count == 0 and gpu_suppress3d.launches.count == 0
    assert gpu_decode3d.gathered_launches.count == 0


def test_suppress_pack_3d_smem_limit():
    # K = 256 takes 66 KB of the scan pass's shared memory; past K = 16,384,
    # where the order pass's sort fills the 227 KB a block may use, the
    # wrapper raises on CUDA tensors
    assert gpu_suppress3d.smem_bytes(256, 9) == 67584
    assert gpu_suppress3d.smem_fits(256, 9) and gpu_suppress3d.smem_fits(4096, 9)
    assert gpu_suppress3d.smem_fits(8192, 9) and gpu_suppress3d.smem_fits(16384, 9)
    assert not gpu_suppress3d.smem_fits(16385, 9) and not gpu_suppress3d.smem_fits(32768, 9)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: pytest -m cuda, chip_smoke.py)")
    cuda_build.build_all()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,k,max_det,fmt,agnostic", DECODE_CASES)
def test_decode_nms_2d_kernel_matches_plain_on_card(cuda_device, kind, k, max_det, fmt, agnostic):
    arrays = kernel_cases.batch(kind, 8, k, seed=21, box_format=fmt)
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    before = gpu_decode.launches.count
    rows, keep = gpu_decode.fused_decode_nms_2d(
        *args, iou_thresh=0.45, max_det=max_det, box_format=fmt, class_agnostic=agnostic
    )
    want_rows, want_keep = gpu_decode.decode_nms_2d_reference(
        *args, iou_thresh=0.45, max_det=max_det, box_format=fmt, class_agnostic=agnostic
    )
    torch.cuda.synchronize()
    assert gpu_decode.launches.count == before + 1
    assert torch.equal(keep, want_keep)
    assert torch.equal(rows, want_rows)


def _decode_on_card(arrays, device, max_det=300, iou=0.45, **kw):
    """Kernel 1 against its plain version on the card, bitwise, with one
    launch count per call."""
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]
    before = gpu_decode.launches.count
    rows, keep = gpu_decode.fused_decode_nms_2d(*args, iou_thresh=iou, max_det=max_det, **kw)
    want_rows, want_keep = gpu_decode.decode_nms_2d_reference(
        *args, iou_thresh=iou, max_det=max_det, **kw
    )
    torch.cuda.synchronize()
    assert gpu_decode.launches.count == before + 1
    assert torch.equal(keep, want_keep)
    assert torch.equal(rows.view(torch.int32), want_rows.view(torch.int32))
    return keep


@pytest.mark.cuda
@pytest.mark.parametrize("kind", kernel_cases.KINDS)
def test_decode_nms_2d_kernel_on_sorted_candidates_on_card(cuda_device, kind):
    """The order pass's other branch: candidates already in score order, as
    topk_candidates hands them over, are taken as they stand."""
    arrays = kernel_cases.score_sorted(*kernel_cases.batch(kind, 8, 1024, seed=26))
    _decode_on_card(arrays, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("nc,iou", [(80, 0.5), (2, 0.6)], ids=["retinanet_coco", "fcos_crop"])
def test_decode_nms_2d_kernel_on_the_scored_tail_on_card(cuda_device, nc, iou):
    """The detectron family's multi-label xyxy candidates (B = 4, K = 1024,
    max_det 100, class-aware, boxes past the clamp) on the card."""
    keep = _decode_on_card(kernel_cases.scored_candidates(4, 1024, nc, seed=32), cuda_device,
                           max_det=100, iou=iou, box_format="xyxy", class_agnostic=False)
    assert int(keep.sum()) == 400


@pytest.mark.cuda
@pytest.mark.parametrize("k,max_det", [(1025, 1025), (16384, 300), (16384, 16384)])
@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
def test_decode_nms_2d_kernel_past_one_word_group_on_card(cuda_device, k, max_det, sort):
    """K past 1024 (the scan's removed set spans several groups of 32
    words), up to the largest K the wrapper takes."""
    arrays = kernel_cases.batch("random", 2, k, seed=27)
    if sort:
        arrays = kernel_cases.score_sorted(*arrays)
    _decode_on_card(arrays, cuda_device, max_det=max_det)


@pytest.mark.cuda
def test_decode_nms_2d_past_shared_memory_raises_on_card(cuda_device):
    k = 16385  # one past the largest K the order pass's sort fits
    boxes = torch.zeros((1, k, 4), device=cuda_device)
    scores = torch.zeros((1, k), device=cuda_device)
    before = gpu_decode.launches.count
    with pytest.raises(ValueError, match="shared memory"):
        gpu_decode.fused_decode_nms_2d(boxes, scores, scores, scores > 0)
    assert gpu_decode.launches.count == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,max_det", NMS_CASES)
def test_nms_greedy_kernel_matches_plain_on_card(cuda_device, kind, n, max_det):
    parts = [kernel_cases.nms_inputs(kind, n, seed=31 + i) for i in range(8)]
    boxes = torch.from_numpy(np.stack([p[0] for p in parts])).to(cuda_device)
    scores = torch.from_numpy(np.stack([p[1] for p in parts])).to(cuda_device)
    idx, valid = gpu_nms.nms_greedy(boxes, scores, 0.45, max_det)
    want_idx, want_valid = gpu_nms.nms_greedy_reference(boxes, scores, 0.45, max_det)
    torch.cuda.synchronize()
    assert torch.equal(idx, want_idx) and torch.equal(valid, want_valid)


def _nms_on_card(boxes, scores, max_det, device):
    """Kernel 2 against its plain version on the card, bitwise (indices of
    the invalid slots included), with one launch count per call."""
    boxes, scores = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (boxes, scores))
    before = gpu_nms.launches.count
    idx, valid = gpu_nms.nms_greedy(boxes, scores, 0.45, max_det)
    want_idx, want_valid = gpu_nms.nms_greedy_reference(boxes, scores, 0.45, max_det)
    torch.cuda.synchronize()
    assert gpu_nms.launches.count == before + 1
    assert torch.equal(valid, want_valid) and torch.equal(idx, want_idx)
    return valid


@pytest.mark.cuda
@pytest.mark.parametrize("kind", kernel_cases.KINDS)
def test_nms_greedy_kernel_on_sorted_candidates_on_card(cuda_device, kind):
    """The order pass's other branch: scores already in order are taken as
    they stand."""
    _nms_on_card(*kernel_cases.nms_batch(kind, 8, 1024, 36, sort=True), 300, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,max_det", [(1025, 1025), (16128, 300), (16384, 300), (16384, 16384)])
@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
def test_nms_greedy_kernel_past_one_word_group_on_card(cuda_device, n, max_det, sort):
    """N past 1024 (the scan's removed set spans several groups of 32
    words), the reference's 16,128-box YOLO heads, and the largest N the
    wrapper takes."""
    _nms_on_card(*kernel_cases.nms_batch("random", 2, n, 37, sort), max_det, cuda_device)


@pytest.mark.cuda
def test_pallas_route_past_shared_memory_raises_on_card(cuda_device, monkeypatch):
    """TRITON_CLIENT_TPU_NMS=pallas on a CUDA tensor launches the kernel
    or raises: past a block's shared memory (N = 16,384, where the order
    pass's sort fills it) it raises, and nothing runs."""
    from triton_client_tpu_torch.ops import nms as tnms

    n = 16385
    assert not gpu_nms.smem_fits(n)
    monkeypatch.setenv("TRITON_CLIENT_TPU_NMS", "pallas")
    boxes = torch.rand((1, n, 2), device=cuda_device).repeat(1, 1, 2)
    scores = torch.rand((1, n), device=cuda_device)
    before = gpu_nms.launches.count
    with pytest.raises(ValueError, match="shared memory"):
        tnms.nms(boxes, scores, 0.45, 300)
    assert gpu_nms.launches.count == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", kernel_cases.DECODE3D_KINDS)
def test_residual_decode_kernel_matches_plain_on_card(cuda_device, kind):
    args = [torch.from_numpy(x).to(cuda_device)
            for x in kernel_cases.decode3d_inputs(kind, 256, seed=22)]
    args = [t.reshape(1, 256, *t.shape[1:]) for t in args]
    before = gpu_decode3d.launches.count
    got = gpu_decode3d.fused_residual_decode(*args)
    want = gpu_decode3d.residual_decode_reference(*args)
    torch.cuda.synchronize()
    assert gpu_decode3d.launches.count == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))  # -0.0 too


@pytest.mark.cuda
@pytest.mark.parametrize("dir_kind", kernel_cases.DIR_KINDS)
@pytest.mark.parametrize("kind", kernel_cases.DECODE3D_KINDS)
def test_gather_residual_decode_kernel_matches_plain_on_card(cuda_device, kind, dir_kind):
    """The gathered form at the PointPillars head's shape (B = 2 here, K =
    256 of N = 321,408 anchors), bitwise, one launch of either count."""
    args = [torch.from_numpy(x).to(cuda_device)
            for x in kernel_cases.gather_decode3d_inputs(kind, 2, 321408, 256, dir_kind, seed=23)]
    before = (gpu_decode3d.launches.count, gpu_decode3d.gathered_launches.count)
    got = gpu_decode3d.gather_residual_decode(*args)
    want = gpu_decode3d.gather_residual_decode_reference(*args)
    torch.cuda.synchronize()
    assert (gpu_decode3d.launches.count, gpu_decode3d.gathered_launches.count) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == (2, 256, 7)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_gather_residual_decode_index_outside_the_head_on_card(cuda_device):
    """An index outside [0, N) reads nothing past the head: its row is NaN,
    the other rows as the plain version gives them."""
    box_head, anchors, logits, top_idx = (
        torch.from_numpy(x).to(cuda_device)
        for x in kernel_cases.gather_decode3d_inputs("random", 1, 64, 8, seed=24))
    bad = top_idx.clone()
    bad[0, 3], bad[0, 5] = 64, -1
    got = gpu_decode3d.gather_residual_decode(box_head, anchors, logits, bad)
    want = gpu_decode3d.gather_residual_decode_reference(box_head, anchors, logits, top_idx)
    torch.cuda.synchronize()
    assert torch.isnan(got[0, [3, 5]]).all()
    rest = [0, 1, 2, 4, 6, 7]
    assert torch.equal(got[0, rest].view(torch.int32), want[0, rest].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", kernel_cases.SUPPRESS3D_KINDS)
def test_suppress_pack_3d_kernel_matches_plain_on_card(cuda_device, kind):
    parts = [kernel_cases.suppress3d_inputs(kind, 256, seed=32 + i) for i in range(2)]
    boxes, scores, labels = (torch.from_numpy(np.stack(p)).to(cuda_device) for p in zip(*parts))
    iou, rows = gpu_suppress3d.sorted_candidates(boxes, scores, labels)
    before = gpu_suppress3d.launches.count
    got_rows, got_keep = gpu_suppress3d.suppress_pack_3d(iou, rows, 0.01, 128)
    want_rows, want_keep = gpu_suppress3d.suppress_pack_3d_reference(iou, rows, 0.01, 128)
    torch.cuda.synchronize()
    assert gpu_suppress3d.launches.count == before + 1
    assert torch.equal(got_keep, want_keep)
    assert torch.equal(got_rows.view(torch.int32), want_rows.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", kernel_cases.SUPPRESS3D_KINDS)
@pytest.mark.parametrize("shuffle", [False, True], ids=["sorted", "shuffled"])
def test_suppress_pack_3d_kernel_with_velocity_columns_on_card(cuda_device, kind, shuffle):
    """CenterPoint's shape on the card: K = 128, 11 columns, max_det 128,
    through the wrapper the pipeline calls and on shuffled sorted rows."""
    parts = [_with_velocity(kind, 128, seed=38 + i) for i in range(2)]
    boxes, scores, labels = (torch.from_numpy(np.stack(p)).to(cuda_device) for p in zip(*parts))
    if not shuffle:
        before = gpu_suppress3d.launches.count
        got_rows, got_keep = gpu_suppress3d.fused_suppress_pack_3d(boxes, scores, labels, 0.2,
                                                                   128)
        iou, rows = gpu_suppress3d.sorted_candidates(boxes, scores, labels)
        want_rows, want_keep = gpu_suppress3d.suppress_pack_3d_reference(iou, rows, 0.2, 128)
        torch.cuda.synchronize()
        assert gpu_suppress3d.launches.count == before + 1 and got_rows.shape == (2, 128, 11)
        assert torch.equal(got_keep, want_keep)
        assert torch.equal(got_rows.view(torch.int32), want_rows.view(torch.int32))
        return
    iou, rows = gpu_suppress3d.sorted_candidates(boxes, scores, labels)
    perm = torch.from_numpy(np.random.default_rng(39).permutation(128)).to(cuda_device)
    _suppress3d_on_card(iou[:, perm][:, :, perm].contiguous(), rows[:, perm].contiguous())


def _suppress3d_on_card(iou, rows, max_det=128):
    before = gpu_suppress3d.launches.count
    got_rows, got_keep = gpu_suppress3d.suppress_pack_3d(iou, rows, 0.01, max_det)
    want_rows, want_keep = gpu_suppress3d.suppress_pack_3d_reference(iou, rows, 0.01, max_det)
    torch.cuda.synchronize()
    assert gpu_suppress3d.launches.count == before + 1
    assert torch.equal(got_keep, want_keep)
    assert torch.equal(got_rows.view(torch.int32), want_rows.view(torch.int32))
    return got_keep


@pytest.mark.cuda
@pytest.mark.parametrize("kind", kernel_cases.SUPPRESS3D_KINDS)
def test_suppress_pack_3d_kernel_on_unsorted_rows_on_card(cuda_device, kind):
    """The order pass's sort: the sorted candidates shuffled, rows and the
    IoU matrix alike."""
    parts = [kernel_cases.suppress3d_inputs(kind, 256, seed=34 + i) for i in range(2)]
    boxes, scores, labels = (torch.from_numpy(np.stack(p)).to(cuda_device) for p in zip(*parts))
    iou, rows = gpu_suppress3d.sorted_candidates(boxes, scores, labels)
    perm = torch.from_numpy(np.random.default_rng(35).permutation(256)).to(cuda_device)
    _suppress3d_on_card(iou[:, perm][:, :, perm].contiguous(), rows[:, perm].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("k,max_det,walks_all", [
    (1300, 1300, True), (16384, 128, False), (16384, 16384, True),
])
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
def test_suppress_pack_3d_kernel_past_one_word_group_on_card(cuda_device, k, max_det, walks_all,
                                                            sort):
    """K past 1024 up to the largest the wrapper takes at 9 columns, on a
    sparse planted IoU matrix: with few suppressions the scan walks all
    1,040 (13,108) live positions, past the first group of 32 words, unless
    max_det stops it."""
    iou, rows = (torch.from_numpy(a)[None].to(cuda_device)
                 for a in kernel_cases.sparse_iou(k, 4.0 / k, seed=36))
    if not sort:
        perm = torch.from_numpy(np.random.default_rng(37).permutation(k)).to(cuda_device)
        iou, rows = iou[:, perm][:, :, perm].contiguous(), rows[:, perm].contiguous()
    keep = _suppress3d_on_card(iou, rows, max_det)
    assert (int(keep.sum()) < max_det) == walks_all


@pytest.mark.cuda
def test_suppress_pack_3d_kernel_at_the_threshold_on_card(cuda_device):
    iou, rows = kernel_cases.planted_iou(256, seed=15)
    iou, rows = (torch.from_numpy(a)[None].to(cuda_device) for a in (iou, rows))
    got = gpu_suppress3d.suppress_pack_3d(iou, rows, 0.01, 128)
    want = gpu_suppress3d.suppress_pack_3d_reference(iou, rows, 0.01, 128)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.cuda
def test_suppress_pack_3d_past_shared_memory_raises_on_card(cuda_device):
    k = 16385  # one past the largest K the order pass's sort fits
    rows = torch.zeros((1, k, 9), device=cuda_device)
    iou = torch.zeros((1, 1, 1), device=cuda_device).expand(1, k, k)
    before = gpu_suppress3d.launches.count
    with pytest.raises(ValueError, match="shared memory"):
        gpu_suppress3d.suppress_pack_3d(iou, rows)
    assert gpu_suppress3d.launches.count == before


# -- cell assignment: the float -> int32 cast of every 3D path --


@pytest.mark.cuda
def test_assign_cells_on_card_equals_the_cpu(cuda_device):
    """NaN, +-inf, +-1e10 and +-2^31 coordinates convert by XLA's rule on
    both devices, so the card's cells and valid rows equal the CPU's."""
    from triton_client_tpu_torch.ops.voxelize import VoxelConfig, assign_cells, xla_f32_to_i32

    cfg = VoxelConfig()
    pts = kernel_cases.special_cloud(200, cfg.point_cloud_range, seed=5)
    x = torch.from_numpy(np.concatenate([kernel_cases.SPECIAL_COORDS, pts[:, :3].ravel()]))
    assert torch.equal(xla_f32_to_i32(x.to(cuda_device)).cpu(), xla_f32_to_i32(x))
    p, n = torch.from_numpy(pts), torch.tensor(190)
    ijk, valid = assign_cells(p.to(cuda_device), n.to(cuda_device), cfg)
    want_ijk, want_valid = assign_cells(p, n, cfg)
    assert torch.equal(ijk.cpu(), want_ijk) and torch.equal(valid.cpu(), want_valid)
    assert int(want_ijk[0, 0]) == 0 and bool(want_valid[0])  # the NaN x row stays in


# -- SECOND's sorted-segment mean (kernel 5), at the main path's shapes --

SEGMENT_N, SEGMENT_SLOTS = 131072, 40000


@pytest.mark.cuda
@pytest.mark.parametrize("kind", kernel_cases.SEGMENT_KINDS)
def test_segment_mean_kernel_matches_plain_on_card(cuda_device, kind):
    """Bitwise: both sum each slot's rows serially in row order from +0.0."""
    n = 4096 if kind == "one_slot" else SEGMENT_N  # the plain version loops over the slot
    valsT, slots = (torch.from_numpy(a).to(cuda_device)
                    for a in kernel_cases.segment_inputs(kind, n, SEGMENT_SLOTS, seed=23))
    before = gpu_voxel.launches.count
    got = gpu_voxel.sorted_segment_mean(valsT, slots, SEGMENT_SLOTS)
    want = gpu_voxel.sorted_segment_mean_reference(valsT, slots, SEGMENT_SLOTS)
    torch.cuda.synchronize()
    assert gpu_voxel.launches.count == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_fused_mean_volume_on_card_equals_the_cpu(cuda_device):
    """The whole fused stage at the KITTI SECOND grid on a 20k-point scan:
    the card's volume equals the CPU's bit for bit (one stable sort, serial
    sums, unique-index scatters)."""
    from triton_client_tpu_torch.io.sources import SyntheticPointCloudSource
    from triton_client_tpu_torch.models.second import SECONDConfig
    from triton_client_tpu_torch.pipelines.detect3d import prepare_points

    voxel = SECONDConfig().voxel
    pc = next(iter(SyntheticPointCloudSource(1, points=20000, seed=5))).data
    padded, m = prepare_points(pc, 4, (32768,))
    pts, cnt = torch.from_numpy(padded), torch.tensor(m, dtype=torch.int32)
    before = gpu_voxel.launches.count
    got = gpu_voxel.fused_mean_volume(pts.to(cuda_device), cnt.to(cuda_device), voxel)
    torch.cuda.synchronize()
    assert gpu_voxel.launches.count == before + 1
    assert torch.equal(got.cpu(), gpu_voxel.fused_mean_volume(pts, cnt, voxel))


@pytest.mark.cuda
def test_segment_mean_wrapper_raises_on_card(cuda_device):
    valsT = torch.zeros((8, 64), device=cuda_device)
    slots = torch.zeros(64, dtype=torch.int32, device=cuda_device)
    before = gpu_voxel.launches.count
    with pytest.raises(ValueError, match="contiguous"):
        gpu_voxel.sorted_segment_mean(torch.zeros((64, 8), device=cuda_device).T, slots, 4)
    with pytest.raises(ValueError, match="sorted_segment_mean"):  # mixed devices
        gpu_voxel.sorted_segment_mean(valsT, slots.cpu(), 4)
    assert gpu_voxel.launches.count == before


# -- the segment sum of packed ragged batches (kernel 6) --


@pytest.mark.cuda
@pytest.mark.parametrize("kind,r,f,s", kernel_cases.SEGSUM_CASES)
def test_segment_sum_kernel_matches_plain_on_card(cuda_device, kind, r, f, s):
    """Bitwise: both sum each lane's 4 rows of a 128-row sub-chunk, the 32
    lane sums by the butterfly, each chunk's 8 sub-chunk sums, the chunk
    sums in 8 groups, then the group sums, each from +0.0."""
    v, ids = (torch.from_numpy(a).to(cuda_device)
              for a in kernel_cases.segsum_inputs(kind, r, f, s, seed=31))
    before = gpu_segment.launches.count
    got = gpu_segment.segment_sum(v, ids, s)
    want = gpu_segment.segment_sum_reference(v, ids, s)
    torch.cuda.synchronize()
    assert gpu_segment.launches.count == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.cpu(), gpu_segment.segment_sum_reference(v.cpu(), ids.cpu(), s))


@pytest.mark.cuda
@pytest.mark.parametrize("r,f,s", kernel_cases.SEGSUM_BOUNDARY_SHAPES)
def test_segment_sum_kernel_at_order_boundaries_on_card(cuda_device, r, f, s):
    """Bitwise at R around every boundary of the summation order, on values
    where another grouping changes the bits."""
    v, ids = (torch.from_numpy(a).to(cuda_device)
              for a in kernel_cases.segsum_inputs("decades", r, f, s, seed=32))
    got = gpu_segment.segment_sum(v, ids, s)
    want = gpu_segment.segment_sum_reference(v, ids, s)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_segment_sum_tickets_reset_between_calls_and_streams(cuda_device):
    """The last block of each tile resets its ticket: calls of other chunk
    and tile counts in a row, and on a second stream, each equal the plain
    version bit for bit, and every ticket is 0 afterwards."""
    shapes = [(560_000, 4, 8), (1000, 4, 8), (131072, 130, 64), (7, 1, 1), (560_000, 4, 8)]
    side = torch.cuda.Stream(cuda_device)
    for stream in (torch.cuda.current_stream(cuda_device), side):
        with torch.cuda.stream(stream):
            for i, (r, f, s) in enumerate(shapes):
                v, ids = (torch.from_numpy(a).to(cuda_device)
                          for a in kernel_cases.segsum_inputs("unsorted", r, f, s, seed=40 + i))
                got = gpu_segment.segment_sum(v, ids, s)
                want = gpu_segment.segment_sum_reference(v, ids, s)
                stream.synchronize()
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (r, f, s)
            tickets = gpu_segment._tickets(v.device, stream.cuda_stream, 1)
            stream.synchronize()
            assert not tickets.any()


class _EndOfMapping:
    """A float32 or int32 array on the card whose last byte is the last
    byte of mapped device memory: the pages after it are reserved but not
    mapped, so a kernel that reads past its end faults (an illegal address
    at the next synchronize) instead of reading a neighbour's bytes, which
    the caching allocator's rounding would hide. Built with the driver's
    virtual memory calls through ctypes; ``tensor`` views it through
    ``__cuda_array_interface__``."""

    class _Location(ctypes.Structure):
        _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]

    class _Prop(ctypes.Structure):
        pass

    class _Access(ctypes.Structure):
        pass

    _Prop._fields_ = [("type", ctypes.c_int), ("handle_types", ctypes.c_int),
                      ("location", _Location), ("win32", ctypes.c_void_p),
                      ("compression", ctypes.c_ubyte), ("rdma", ctypes.c_ubyte),
                      ("usage", ctypes.c_ushort), ("reserved", ctypes.c_ubyte * 4)]
    _Access._fields_ = [("location", _Location), ("flags", ctypes.c_int)]

    def __init__(self, array: np.ndarray, device: torch.device):
        cu = ctypes.CDLL("libcuda.so.1")
        self._cu = cu
        ull = ctypes.c_ulonglong
        loc = self._Location(1, device.index or 0)  # CU_MEM_LOCATION_TYPE_DEVICE
        prop = self._Prop(1, 0, loc, None, 0, 0, 0)  # CU_MEM_ALLOCATION_TYPE_PINNED
        gran = ctypes.c_size_t()
        self._ok(cu.cuMemGetAllocationGranularity(ctypes.byref(gran), ctypes.byref(prop), 0))
        nbytes = array.nbytes
        self.mapped = -(-max(nbytes, 1) // gran.value) * gran.value
        self.base = ull()
        self._ok(cu.cuMemAddressReserve(ctypes.byref(self.base), ctypes.c_size_t(2 * self.mapped),
                                        ctypes.c_size_t(0), ull(0), ull(0)))
        self.handle = ull()
        self._ok(cu.cuMemCreate(ctypes.byref(self.handle), ctypes.c_size_t(self.mapped),
                                ctypes.byref(prop), ull(0)))
        self._ok(cu.cuMemMap(self.base, ctypes.c_size_t(self.mapped), ctypes.c_size_t(0),
                             self.handle, ull(0)))
        access = self._Access(loc, 3)  # CU_MEM_ACCESS_FLAGS_PROT_READWRITE
        self._ok(cu.cuMemSetAccess(self.base, ctypes.c_size_t(self.mapped), ctypes.byref(access),
                                   ctypes.c_size_t(1)))
        self.__cuda_array_interface__ = {
            "shape": array.shape, "typestr": array.dtype.str, "strides": None, "version": 2,
            "data": (self.base.value + self.mapped - nbytes, False),
        }
        self.tensor = torch.as_tensor(self, device=device)
        self.tensor.copy_(torch.from_numpy(array))
        torch.cuda.synchronize()

    @staticmethod
    def _ok(err: int):
        assert err == 0, f"CUDA driver error {err}"

    def close(self):
        torch.cuda.synchronize()
        del self.tensor
        ull = ctypes.c_ulonglong
        self._ok(self._cu.cuMemUnmap(self.base, ctypes.c_size_t(self.mapped)))
        self._ok(self._cu.cuMemRelease(self.handle))
        self._ok(self._cu.cuMemAddressFree(self.base, ctypes.c_size_t(2 * self.mapped)))


@pytest.mark.cuda
@pytest.mark.parametrize("r,f,s", [(1025, 12, 8), (1025, 20, 3), (1025, 40, 3), (1025, 4, 8),
                                   (4099, 130, 64), (7, 1, 1)])
def test_segment_sum_reads_nothing_past_its_rows(cuda_device, r, f, s):
    """Values and ids that end where mapped memory ends: the kernel's loads,
    16 bytes wide where F allows, stop at the last row's last column."""
    v, ids = kernel_cases.segsum_inputs("unsorted", r, f, s, seed=90)
    gv, gi = _EndOfMapping(v, cuda_device), _EndOfMapping(ids, cuda_device)
    try:
        got = gpu_segment.segment_sum(gv.tensor, gi.tensor, s)
        torch.cuda.synchronize()  # a read past the end faults here
        want = gpu_segment.segment_sum_reference(torch.from_numpy(v), torch.from_numpy(ids), s)
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    finally:
        gv.close()
        gi.close()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "one_slot", "long_slot", "single_row"])
def test_segment_mean_reads_nothing_past_its_rows(cuda_device, kind):
    """Value rows and slot ids that end where mapped memory ends: the
    walks, the warp's loads a step ahead among them, stop at the last row."""
    valsT, slots = kernel_cases.segment_inputs(kind, 4096, 3000, seed=91)
    gv, gs = _EndOfMapping(valsT, cuda_device), _EndOfMapping(slots, cuda_device)
    try:
        got = gpu_voxel.sorted_segment_mean(gv.tensor, gs.tensor, 3000)
        torch.cuda.synchronize()  # a read past the end faults here
        want = gpu_voxel.sorted_segment_mean_reference(torch.from_numpy(valsT),
                                                       torch.from_numpy(slots), 3000)
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    finally:
        gv.close()
        gs.close()


@pytest.mark.cuda
def test_segment_sum_edge_sizes_on_card(cuda_device):
    v = torch.ones((0, 4), device=cuda_device)
    got = gpu_segment.segment_sum(v, torch.zeros(0, dtype=torch.int32, device=cuda_device), 8)
    torch.cuda.synchronize()
    assert got.shape == (8, 4) and not got.any()
    none = gpu_segment.segment_sum(torch.ones((5, 3), device=cuda_device),
                                   torch.zeros(5, dtype=torch.int32, device=cuda_device), 0)
    assert none.shape == (0, 3)
    with pytest.raises(ValueError, match="segment_sum"):  # mixed devices
        gpu_segment.segment_sum(torch.ones((5, 3), device=cuda_device),
                                torch.zeros(5, dtype=torch.int32), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_segment_reduce_on_card_equals_the_cpu(cuda_device, op):
    from triton_client_tpu_torch.parallel.ragged_kernels import segment_reduce

    v, ids = kernel_cases.segsum_inputs("out_of_range", 5000, 4, 8, seed=12)
    v, ids = torch.from_numpy(v), torch.from_numpy(ids)
    got = segment_reduce(v.to(cuda_device), ids.to(cuda_device), 8, op)
    assert torch.equal(got.cpu(), segment_reduce(v, ids, 8, op))
