"""The suppression bitmask and one-warp scan of the decode+NMS (kernel 1),
greedy NMS (kernel 2) and 3D suppress+pack (kernel 4) kernels, rendered in
plain PyTorch, against
the greedy-loop plain versions that the CPU path runs and that
tests/test_torch_kernels.py holds to the JAX package's Pallas kernels.

The mask-scan renderings (``*_mask_scan_reference``) visit the live
candidates in (score descending, index ascending) order and keep each that
no earlier kept one suppresses; the greedy loop takes the argmax over live
scores step by step. The two must agree BITWISE, rows and keep, on every
``kernel_cases`` kind (``nan`` included), at the main paths' shapes, at K
values that are not multiples of 32, with ``max_det`` reached before the
live set runs out and the reverse, at IoUs exactly at the threshold, on
sorted and unsorted inputs, and over small random sets drawn by
hypothesis. Small sizes only: the file runs in seconds.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from triton_client_tpu_torch.ops import gpu_decode, gpu_nms, gpu_suppress3d, kernel_cases, mask_scan


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)  # -0.0 differs from +0.0


def _hold_2d(arrays, **kw) -> torch.Tensor:
    """Both renderings of kernel 1 on the same inputs, equal bit for bit;
    returns the keep mask."""
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    want_rows, want_keep = gpu_decode.decode_nms_2d_reference(*args, **kw)
    rows, keep = gpu_decode.decode_nms_2d_mask_scan_reference(*args, **kw)
    assert torch.equal(keep, want_keep)
    assert torch.equal(_bits(rows), _bits(want_rows))
    return keep


def _hold_3d(iou, rows, thresh=0.01, max_det=128) -> torch.Tensor:
    iou, rows = (torch.from_numpy(np.ascontiguousarray(a)) for a in (iou, rows))
    if iou.ndim == 2:
        iou, rows = iou[None], rows[None]
    want_rows, want_keep = gpu_suppress3d.suppress_pack_3d_reference(iou, rows, thresh, max_det)
    got_rows, got_keep = gpu_suppress3d.suppress_pack_3d_mask_scan_reference(
        iou, rows, thresh, max_det
    )
    assert torch.equal(got_keep, want_keep)
    assert torch.equal(_bits(got_rows), _bits(want_rows))
    return got_keep


# -- kernel 1 --------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 31, 33, 100, 1025])
@pytest.mark.parametrize("kind", kernel_cases.KINDS)
def test_decode_mask_scan_equals_greedy_loop(kind, k):
    fmt, agnostic = ("xywh", False) if k % 2 else ("xyxy", True)
    arrays = kernel_cases.batch(kind, 2, k, seed=3, box_format=fmt)
    keep = _hold_2d(arrays, iou_thresh=0.45, max_det=300, box_format=fmt,
                    class_agnostic=agnostic)
    if kind in ("nan", "all_invalid"):
        assert not keep.any()


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
def test_decode_mask_scan_at_the_main_path_shape(sort):
    """B = 2 of the main path's 8 images, K = 1024, max_det 300, every slot
    valid (conf 0.05 fills them all), so max_det is reached first."""
    boxes, scores, classes, valid = kernel_cases.batch("random", 2, 1024, seed=7)
    valid[:] = True
    arrays = (boxes, np.where(valid, scores, 0.0).astype(np.float32), classes, valid)
    if sort:
        arrays = kernel_cases.score_sorted(*arrays)
        live = np.where(arrays[3], arrays[1], -np.inf)
        assert mask_scan.in_visiting_order(torch.from_numpy(live)).all()
    keep = _hold_2d(arrays, iou_thresh=0.45, max_det=300, box_format="xywh")
    assert keep.all()  # 300 kept before the live set ran out


@pytest.mark.parametrize("kind", ["random", "ties", "chain", "nan"])
def test_decode_mask_scan_on_sorted_inputs(kind):
    arrays = kernel_cases.score_sorted(*kernel_cases.batch(kind, 2, 100, seed=5))
    _hold_2d(arrays, iou_thresh=0.45, max_det=64, box_format="xywh")


def test_decode_mask_scan_max_det_either_side():
    arrays = kernel_cases.batch("random", 2, 100, seed=9)
    assert _hold_2d(arrays, max_det=5).all()  # max_det first
    keep = _hold_2d(arrays, max_det=300)  # the live set first
    assert 0 < int(keep.sum(1).max()) < 100


def test_decode_mask_scan_iou_at_the_threshold():
    """Unit-height boxes 10 wide whose neighbours overlap by exactly half
    their union (IoU 0.5 in float32): at threshold 0.5 none suppresses,
    one ulp below it every neighbour does."""
    k = 40
    x = 5.0 * np.arange(k, dtype=np.float32)
    boxes = np.stack([x, np.zeros(k), x + 15.0, np.ones(k)], 1).astype(np.float32)[None]
    scores = np.linspace(0.9, 0.1, k, dtype=np.float32)[None]
    arrays = (boxes, scores, np.zeros((1, k), np.int32), np.ones((1, k), bool))
    at = _hold_2d(arrays, iou_thresh=0.5, max_det=k, box_format="xyxy")
    below = _hold_2d(arrays, iou_thresh=float(np.nextafter(np.float32(0.5), np.float32(0))),
                     max_det=k, box_format="xyxy")
    assert int(at.sum()) > int(below.sum()) > 0


_SCORES = st.sampled_from([0.9, 0.5, 0.5, 0.25, 0.0, -0.0, 1.0, float("inf"), float("nan")])
_COORD = st.integers(0, 12).map(float)


@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(
    data=st.lists(st.tuples(_COORD, _COORD, _COORD, _COORD, _SCORES, st.integers(0, 2),
                            st.booleans()), min_size=1, max_size=40),
    thresh=st.sampled_from([0.0, 0.25, 0.45, 0.5, 1.0]),
    max_det=st.integers(1, 12),
    fmt=st.sampled_from(["xywh", "xyxy"]),
    agnostic=st.booleans(),
)
def test_decode_mask_scan_property(data, thresh, max_det, fmt, agnostic):
    """Coordinates on a small integer grid (touching and identical boxes,
    IoUs exactly at 0.25 and 0.5), equal, signed-zero, infinite and NaN
    scores."""
    c0, c1, c2, c3, s, c, v = (np.array(col) for col in zip(*data))
    boxes = np.stack([c0, c1, c2, c3], 1).astype(np.float32)[None]
    valid = v.astype(bool)[None]
    scores = np.where(valid, s, 0.0).astype(np.float32)
    _hold_2d((boxes, scores, c.astype(np.int32)[None], valid), iou_thresh=thresh,
             max_det=max_det, box_format=fmt, class_agnostic=agnostic)


# -- kernel 2 --------------------------------------------------------------

def _hold_nms(boxes, scores, max_det, thresh=0.45):
    """Both renderings of kernel 2 on the same inputs: equal index
    sequences (invalid slots included) and valid masks; returns valid."""
    boxes, scores = (torch.from_numpy(np.ascontiguousarray(a)) for a in (boxes, scores))
    want_idx, want_valid = gpu_nms.nms_greedy_reference(boxes, scores, thresh, max_det)
    idx, valid = gpu_nms.nms_greedy_mask_scan_reference(boxes, scores, thresh, max_det)
    assert idx.dtype == want_idx.dtype == torch.int32
    assert torch.equal(valid, want_valid)
    assert torch.equal(idx, want_idx)
    return valid


def _nms_batch(kind, k, order, seed):
    """Two images of ``nms_inputs``: in score order (as the unfused 2D
    route hands them over after its top-k), or shuffled."""
    boxes, scores = kernel_cases.nms_batch(kind, 2, k, seed, sort=order == "sorted")
    if order == "shuffled":
        perm = np.stack([np.random.default_rng(seed + 10 + i).permutation(k) for i in range(2)])
        boxes = np.take_along_axis(boxes, perm[..., None], 1)
        scores = np.take_along_axis(scores, perm, 1)
    return boxes, scores


@pytest.mark.parametrize("side", ["below", "above"])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("k", [1, 31, 32, 33, 1024, 1025])
@pytest.mark.parametrize("kind", kernel_cases.KINDS)
def test_nms_mask_scan_equals_greedy_loop(kind, k, order, side):
    """Every kind, K on both sides of a mask word and of one scan group,
    with ``max_det`` below the kept count (``max_det`` ends the walk) and
    above it (the live set does; the empty slots hold index 0)."""
    boxes, scores = _nms_batch(kind, k, order, seed=k)
    valid = _hold_nms(boxes, scores, max_det=k + 1)
    kept = int(valid.sum(1).min())
    if side == "below":
        valid = _hold_nms(boxes, scores, max_det=max(1, kept - 1))
        if kept > 1:
            assert valid.all()
    if kind in ("nan", "all_invalid"):
        assert not valid.any()
    elif k > 1:  # one candidate may be invalid (a fifth are)
        assert kept > 0
    if kind == "nan":  # every slot at the first NaN's index
        idx, _ = gpu_nms.nms_greedy_mask_scan_reference(
            torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, 4)
        first = np.isnan(scores).argmax(1)
        assert (idx.numpy() == first[:, None]).all()


def test_nms_mask_scan_iou_at_the_threshold():
    """Kernel 1's boxes at IoU exactly 0.5, in and out of score order: at
    threshold 0.5 none suppresses, one ulp below it every neighbour does."""
    k = 40
    x = 5.0 * np.arange(k, dtype=np.float32)
    boxes = np.stack([x, np.zeros(k), x + 15.0, np.ones(k)], 1).astype(np.float32)[None]
    scores = np.linspace(0.9, 0.1, k, dtype=np.float32)[None]
    perm = np.random.default_rng(4).permutation(k)
    for b, sc in ((boxes, scores), (boxes[:, perm], scores[:, perm])):
        at = _hold_nms(b, sc, max_det=k, thresh=0.5)
        below = _hold_nms(b, sc, max_det=k, thresh=float(np.nextafter(np.float32(0.5),
                                                                       np.float32(0))))
        assert int(at.sum()) > int(below.sum()) > 0


_NMS_THRESH = [0.0, 0.25, float(np.nextafter(np.float32(0.25), np.float32(0))), 0.5,
               float(np.nextafter(np.float32(0.5), np.float32(0))), 1.0]


@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(
    data=st.lists(st.tuples(_COORD, _COORD, _COORD, _COORD,
                            st.sampled_from([0.9, 0.5, 0.5, 0.25, 0.0, -0.0, 1.0, float("inf"),
                                             float("-inf"), float("nan")])),
                  min_size=1, max_size=40),
    thresh=st.sampled_from(_NMS_THRESH),
    max_det=st.integers(1, 12),
)
def test_nms_mask_scan_property(data, thresh, max_det):
    """xyxy coordinates on a small integer grid (touching, identical and
    inverted boxes; IoUs exactly at 0.25 and 0.5, and thresholds one ulp
    below them), equal, signed-zero, infinite, padded and NaN scores."""
    x1, y1, x2, y2, s = (np.array(col) for col in zip(*data))
    boxes = np.stack([x1, y1, x2, y2], 1).astype(np.float32)[None]
    _hold_nms(boxes, s.astype(np.float32)[None], max_det, thresh)


# -- kernel 4 --------------------------------------------------------------

def _sorted_3d(kind, k, seed):
    boxes, scores, labels = (torch.from_numpy(a)[None]
                             for a in kernel_cases.suppress3d_inputs(kind, k, seed=seed))
    iou, rows = gpu_suppress3d.sorted_candidates(boxes, scores, labels)
    return iou[0].numpy(), rows[0].numpy()


def _shuffled(iou, rows, seed):
    perm = np.random.default_rng(seed).permutation(rows.shape[0])
    return iou[perm][:, perm], rows[perm]


@pytest.mark.parametrize("k", [1, 31, 33, 100, 256])
@pytest.mark.parametrize("kind", kernel_cases.SUPPRESS3D_KINDS)
def test_suppress3d_mask_scan_equals_greedy_loop(kind, k):
    iou, rows = _sorted_3d(kind, k, seed=k)
    keep = _hold_3d(iou, rows)
    _hold_3d(*_shuffled(iou, rows, seed=k))
    if kind in ("nan", "all_gated"):
        assert not keep.any()


def test_suppress3d_mask_scan_max_det_either_side():
    iou, rows = _sorted_3d("disjoint", 256, seed=1)  # IoU 0: every live one is kept
    assert _hold_3d(iou, rows, max_det=128).all()
    keep = _hold_3d(iou, rows, max_det=256)
    assert 128 < int(keep.sum()) < 256


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
def test_suppress3d_mask_scan_iou_at_the_threshold(sort):
    iou, rows = kernel_cases.planted_iou(100, seed=2)
    if not sort:
        iou, rows = _shuffled(iou, rows, seed=3)
    keep = _hold_3d(iou, rows, max_det=64)
    assert 1 < int(keep.sum()) < 64


_IOU = st.sampled_from([0.0, 0.01, float(np.nextafter(np.float32(0.01), np.float32(1))),
                        float(np.nextafter(np.float32(0.01), np.float32(0))), 0.5, 1.0,
                        float("nan")])


@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(
    k=st.integers(1, 40),
    seed=st.integers(0, 2**16),
    scores=st.lists(st.sampled_from([0.9, 0.5, 0.5, -0.0, 0.0, float("-inf"), float("inf"),
                                     float("nan")]), min_size=40, max_size=40),
    iou_values=st.lists(_IOU, min_size=1, max_size=7, unique=True),
    max_det=st.integers(1, 12),
)
def test_suppress3d_mask_scan_property(k, seed, scores, iou_values, max_det):
    """An IoU matrix drawn from values at and beside the threshold, NaN and
    1, not symmetric (the kernel reads the chosen candidate's row); equal,
    signed-zero, infinite and NaN scores."""
    rng = np.random.default_rng(seed)
    iou = np.array(iou_values, np.float32)[rng.integers(0, len(iou_values), (k, k))]
    rows = rng.normal(0, 3, (k, 9)).astype(np.float32)
    rows[:, 7] = scores[:k]
    _hold_3d(iou, rows, thresh=0.01, max_det=max_det)


# -- the pieces ------------------------------------------------------------

def test_pack_bits_and_workspace_layout():
    bits = torch.zeros((1, 2, 33), dtype=torch.bool)
    bits[0, 0, [0, 31, 32]] = True
    bits[0, 1, 31] = True
    words = mask_scan.pack_bits(bits)
    assert words.shape == (1, 2, 2) and words.dtype == torch.int32
    assert words[0, 0].tolist() == [1 - 2**31, 1] and words[0, 1].tolist() == [-(2**31), 0]
    assert [mask_scan.sort_slots(k) for k in (0, 1, 2, 3, 1024, 1025)] == [1, 1, 2, 4, 1024, 2048]
    assert [mask_scan.row_stride(k) for k in (1, 32, 33, 256, 1024, 5785)] == [4, 4, 4, 8, 32, 184]
    assert gpu_decode.workspace_bytes(8, 1024) == 4 * (8 * 1024 * 32 + 8192 + 16 + 32768 + 8192)
    assert gpu_suppress3d.workspace_bytes(1, 256) == 4 * (256 * 8 + 256 + 4)
    assert gpu_suppress3d.workspace_bytes(1, 33) == 4 * (33 * 4 + 36 + 4)
    ws, ptrs = mask_scan.workspace("cpu", (5, 3, 8))
    assert ws.numel() == mask_scan.workspace_bytes((5, 3, 8)) == 80
    assert [a - ws.data_ptr() for a in ptrs] == [0, 32, 48]


def test_took_own_order_reads_the_flags_after_the_live_counts():
    # the order pass writes image b's live count at word b of the third
    # array and its own-order flag at word B + b
    sizes = (40, 12, 2 * 3)
    ws, _ = mask_scan.workspace("cpu", sizes)
    ws.zero_()
    offset = 4 * (40 + 12)
    ws[offset : offset + 24].view(torch.int32).copy_(torch.tensor([7, 0, 5, 1, 0, 1]))
    assert mask_scan.took_own_order(ws, sizes).tolist() == [True, False, True]


def test_visiting_order_ranks_nan_first_and_counts_no_live_one():
    live = torch.tensor([[0.5, float("nan"), 0.9, float("-inf")],
                         [0.5, 0.9, 0.9, float("-inf")]])
    order, n = mask_scan.visiting_order(live)
    assert n.tolist() == [0, 3] and order[1].tolist() == [1, 2, 0, 3]
    assert mask_scan.in_visiting_order(live).tolist() == [False, False]
    assert mask_scan.in_visiting_order(live.gather(1, order)).tolist() == [True, True]
