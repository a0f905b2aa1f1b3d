"""Seeded inputs for holding the port's kernels against their plain
versions and the JAX package's TPU kernels.

numpy only, so the CPU tests and ``chip_smoke.py`` build the same
inputs from the same seeds. For the 2D greedy kernels each kind aims at
one hazard of the loop: ``random`` (ordinary), ``ties`` (equal scores:
argmax must take the lowest index), ``all_invalid`` (no live candidate:
rows stay zero, indices 0), ``chain`` (each box suppresses only its
neighbour, so the result depends on the order of suppression),
``large`` (coordinates near 1e5, where the class-offset stride and the
IoU round coarsely) and ``nan`` (three live NaN scores among ordinary
ones: the loop's argmax ranks a NaN first and takes it as an invalid
pick, so nothing is kept and greedy NMS's indices are the first NaN's).
The random kinds are not in score order; the main paths hand the kernels
sorted candidates. The 3D kinds are described at ``decode3d_inputs``
and ``suppress3d_inputs``, the segment kinds at ``segment_inputs`` and
``segsum_inputs``.
"""

from __future__ import annotations

import numpy as np

KINDS = ("random", "ties", "all_invalid", "chain", "large", "nan")


def candidates(kind: str, k: int, nc: int = 2, seed: int = 0, box_format: str = "xywh"):
    """One image's candidate set for the fused tail: boxes (k, 4) in
    ``box_format``, scores (k,) 0 where invalid, classes (k,) int32,
    valid (k,) bool."""
    rng = np.random.default_rng(seed)
    if kind == "chain":
        # unit-height boxes 10 wide, each shifted 3 right: IoU of
        # neighbours 7/13 > 0.45, of every second box 4/16 < 0.45
        cx = 20.0 + 3.0 * np.arange(k)
        xywh = np.stack([cx, np.full(k, 50.0), np.full(k, 10.0), np.full(k, 1.0)], 1)
        scores = np.linspace(0.9, 0.5, k)
        classes = np.zeros(k, np.int64)
    else:
        scale = 1e5 if kind == "large" else 512.0
        centers = rng.uniform(0.05, 0.95, (k, 2)) * scale
        wh = rng.uniform(0.02, 0.3, (k, 2)) * scale
        xywh = np.concatenate([centers, wh], 1)
        scores = rng.uniform(0.3, 1.0, k)
        if kind == "ties":
            scores = np.round(scores * 4) / 4  # four distinct values
        classes = rng.integers(0, nc, k)
    valid = rng.uniform(size=k) < 0.8
    if kind == "chain":
        valid[:] = True
    if kind == "all_invalid":
        valid[:] = False
    if kind == "nan":
        bad = rng.choice(k, size=min(3, k), replace=False)
        scores[bad] = np.nan
        valid[bad] = True
    boxes = xywh.astype(np.float32)
    if box_format == "xyxy":
        c, h = boxes[:, :2], boxes[:, 2:] * np.float32(0.5)
        boxes = np.concatenate([c - h, c + h], 1)
    scores = np.where(valid, scores, 0.0).astype(np.float32)
    return boxes, scores, classes.astype(np.int32), valid


def batch(kind: str, b: int, k: int, nc: int = 2, seed: int = 0, box_format: str = "xywh"):
    """``candidates`` for ``b`` images (seeds ``seed``..``seed+b-1``),
    stacked on a leading batch axis."""
    parts = [candidates(kind, k, nc, seed + i, box_format) for i in range(b)]
    return tuple(np.stack(p) for p in zip(*parts))


def score_sorted(boxes, scores, classes, valid):
    """A ``batch`` re-ordered as ``topk_candidates`` hands candidates to
    the fused tail: live scores descending, ties by index, invalid slots
    last (NaN scores sort last here; the kernel ranks them first, and any
    order of a set with a live NaN keeps nothing)."""
    order = np.argsort(-np.where(valid, scores, -np.inf), axis=1, kind="stable")
    return tuple(np.take_along_axis(a, order[..., None] if a.ndim == 3 else order, 1)
                 for a in (boxes, scores, classes, valid))


def sparse_iou(k: int, density: float, thresh: float = 0.01, seed: int = 0):
    """Kernel 4's inputs at large K without a rotated IoU matrix: a (k, k)
    float32 matrix, not symmetric, with one entry in ``1 / density`` one
    ulp above the threshold and the rest at the threshold or 0, and
    score-sorted rows of width 9 (a fifth gated to -inf at the end).
    Returns (iou, rows)."""
    rng = np.random.default_rng(seed)
    t = np.float32(thresh)
    iou = np.where(rng.uniform(size=(k, k)) < 0.5, t, np.float32(0)).astype(np.float32)
    iou[rng.uniform(size=(k, k)) < density] = np.nextafter(t, np.float32(1))
    rows = rng.normal(0, 5, (k, 9)).astype(np.float32)
    rows[:, 7] = np.sort(rng.uniform(0.1, 1.0, k))[::-1]
    rows[k - k // 5:, 7] = -np.inf
    rows[:, 8] = rng.integers(1, 4, k)
    return iou, rows


def nms_inputs(kind: str, n: int, seed: int = 0):
    """One image's input for plain greedy NMS: xyxy boxes (n, 4) and
    scores (n,) with -inf where invalid."""
    boxes, scores, _, valid = candidates(kind, n, seed=seed, box_format="xyxy")
    return boxes, np.where(valid, scores, -np.inf).astype(np.float32)


def nms_batch(kind: str, b: int, n: int, seed: int = 0, sort: bool = False):
    """``nms_inputs`` for ``b`` images (seeds ``seed``..``seed+b-1``),
    stacked; with ``sort``, in descending score order, ties by index, as
    the unfused 2D route's top-k hands them to greedy NMS (NaN scores sort
    last here; the kernel ranks them first)."""
    parts = [nms_inputs(kind, n, seed + i) for i in range(b)]
    boxes, scores = np.stack([p[0] for p in parts]), np.stack([p[1] for p in parts])
    if sort:
        order = np.argsort(-scores, axis=1, kind="stable")
        boxes = np.take_along_axis(boxes, order[..., None], 1)
        scores = np.take_along_axis(scores, order, 1)
    return boxes, scores


# -- 3D: the residual decode (kernel 3) and rotated suppress+pack (kernel 4) --

DECODE3D_KINDS = ("random", "clip", "period", "negzero")


def decode3d_inputs(kind: str, k: int, seed: int = 0):
    """Kernel 3's inputs for ``k`` candidates: deltas (k, 7) and anchors
    (k, 7) float32, dir_bin (k,) int64 with both bins present. ``clip``
    puts the size deltas at and beyond the +-10 clamp; ``period`` puts the
    headings on both sides of a period boundary (PointPillars' two bins:
    dir_offset 0.78539, period pi); ``negzero`` carries -0.0 in every
    column."""
    rng = np.random.default_rng(seed)
    deltas = rng.normal(0.0, 1.0, (k, 7))
    anchors = np.column_stack(
        [
            rng.uniform(0, 70, k), rng.uniform(-40, 40, k), rng.uniform(-2, 0, k),
            rng.choice([3.9, 0.8, 1.76], k), rng.choice([1.6, 0.6], k),
            rng.choice([1.56, 1.73], k), rng.choice([0.0, np.pi / 2], k),
        ]
    )
    if kind == "clip":
        edge = np.array([-12.0, -10.0, -9.999, 9.999, 10.0, 12.0, 87.0, -87.0])
        deltas[:, 3:6] = rng.choice(edge, (k, 3))
    elif kind == "period":
        m = rng.integers(-2, 3, k)
        boundary = (np.float32(0.78539) + m * np.float32(np.pi)).astype(np.float32)
        side = rng.choice([-np.inf, 0.0, np.inf], k)  # below, on, above
        rot = np.where(side == 0, boundary, np.nextafter(boundary, side.astype(np.float32)))
        anchors[:, 6] = 0.0
        deltas[:, 6] = rot
    elif kind == "negzero":
        deltas[rng.uniform(size=(k, 7)) < 0.5] = -0.0
        anchors[rng.uniform(size=(k, 7)) < 0.2] = -0.0
    return (
        deltas.astype(np.float32),
        anchors.astype(np.float32),
        rng.integers(0, 2, k).astype(np.int64),
    )


DIR_KINDS = ("random", "ties", "nan")


def gather_decode3d_inputs(kind: str, b: int, n: int, k: int, dir_kind: str = "random",
                           nb: int = 2, seed: int = 0):
    """The gathered form's inputs: a (b, n, 7) box head and (n, 7) anchors
    drawn as ``decode3d_inputs`` draws them for ``kind``, (b, n, nb)
    float32 direction logits and (b, k) int64 top-k indices (distinct
    within an image, in no order). ``dir_kind``: ``random`` logits,
    ``ties`` (every logit one of 0.0, -0.0 and 0.5: equal maxima, the
    first taken), ``nan`` (a NaN on about a tenth of the logits: it ranks
    above every number)."""
    rng = np.random.default_rng(seed)
    parts = [decode3d_inputs(kind, n, seed=seed + 1 + i) for i in range(b)]
    box_head = np.stack([p[0] for p in parts])
    anchors = parts[0][1]
    if dir_kind == "ties":
        logits = rng.choice(np.array([0.0, -0.0, 0.5], np.float32), (b, n, nb))
    else:
        logits = rng.normal(0.0, 1.0, (b, n, nb)).astype(np.float32)
        if dir_kind == "nan":
            logits[rng.uniform(size=(b, n, nb)) < 0.1] = np.nan
    top_idx = np.stack([rng.permutation(n)[:k] for _ in range(b)]).astype(np.int64)
    return box_head, anchors, logits.astype(np.float32), top_idx


SUPPRESS3D_KINDS = ("random", "all_gated", "ties", "identical", "disjoint", "few", "nan")


def suppress3d_inputs(kind: str, k: int, seed: int = 0):
    """Kernel 4's candidates: boxes (k, 7) [x, y, z, dx, dy, dz, heading]
    float32, scores (k,) float32 with -inf where gated, labels (k,) int64
    1-indexed. ``random`` clusters rotated boxes so that many overlap;
    ``all_gated`` has no live candidate; ``ties`` has four score values;
    ``identical`` repeats each box four times (IoU 1); ``disjoint`` puts
    every box on its own grid cell (IoU 0: more are kept than max_det);
    ``few`` leaves 10 live candidates (fewer than max_det); ``nan`` puts a
    NaN score on three candidates (nothing is kept)."""
    rng = np.random.default_rng(seed)
    if kind == "disjoint":
        side = int(np.ceil(np.sqrt(k)))
        cell = np.arange(k)
        xy = np.column_stack([cell % side, cell // side]) * 10.0
    else:
        centers = rng.uniform([0, -30], [60, 30], (max(1, k // 8), 2))
        xy = centers[rng.integers(0, len(centers), k)] + rng.normal(0, 1.5, (k, 2))
    boxes = np.column_stack(
        [
            xy, rng.uniform(-2, 0, k), rng.uniform(1, 5, k), rng.uniform(0.5, 2.5, k),
            rng.uniform(1, 2, k), rng.uniform(-np.pi, np.pi, k),
        ]
    )
    scores = rng.uniform(0.1, 1.0, k)
    if kind == "identical":
        boxes = np.repeat(boxes[: (k + 3) // 4], 4, axis=0)[:k]
    if kind == "ties":
        scores = np.round(scores * 4) / 4
    scores[rng.uniform(size=k) < 0.2] = -np.inf
    if kind == "all_gated":
        scores[:] = -np.inf
    elif kind == "few":
        scores[10:] = -np.inf
    elif kind == "nan":
        scores[rng.choice(k, size=min(3, k), replace=False)] = np.nan
    return (
        boxes.astype(np.float32),
        scores.astype(np.float32),
        rng.integers(1, 4, k).astype(np.int64),
    )


def planted_iou(k: int, thresh: float = 0.01, seed: int = 0):
    """A symmetric (k, k) float32 IoU matrix (ones on the diagonal) whose
    entries are the float32 threshold itself or its neighbours above and
    below, with score-sorted rows of width 9: the ``iou > thresh`` edge.
    Returns (iou, rows)."""
    rng = np.random.default_rng(seed)
    t = np.float32(thresh)
    values = np.array([t, np.nextafter(t, np.float32(1)), np.nextafter(t, np.float32(0)), 0.0],
                      np.float32)
    iou = values[rng.integers(0, 4, (k, k))]
    iou = np.triu(iou, 1)
    iou = iou + iou.T + np.eye(k, dtype=np.float32)
    rows = rng.normal(0, 5, (k, 9)).astype(np.float32)
    rows[:, 7] = np.sort(rng.uniform(0.1, 1.0, k))[::-1]
    rows[:, 8] = rng.integers(1, 4, k)
    return iou.astype(np.float32), rows


# -- 3D: cell assignment of coordinates the int32 cast must convert by rule --

# NaN, +-inf, +-1e10, +-2^31 and the float32 neighbours of the int32 limits,
# and in-range values either side of 0
SPECIAL_COORDS = np.array(
    [np.nan, -np.nan, np.inf, -np.inf, 1e10, -1e10, 2.0**31, -(2.0**31),
     np.nextafter(np.float32(2.0**31), np.float32(0)), -(2.0**31) - 256, 2147483520.0,
     -2147483520.0, 3.7, -3.7, 0.5, -0.5, -0.0, 0.0],
    np.float32,
)


def special_cloud(n: int, pc_range, seed: int = 0) -> np.ndarray:
    """(n, 4) float32 points drawn uniformly over ``pc_range`` (n >= 55),
    with rows 0-17 carrying one ``SPECIAL_COORDS`` value each in x, rows
    18-35 in y, rows 36-53 in z, and row 54 NaN in x, y and z."""
    rng = np.random.default_rng(seed)
    r = pc_range
    pts = np.column_stack([rng.uniform(r[0], r[3], n), rng.uniform(r[1], r[4], n),
                           rng.uniform(r[2], r[5], n), rng.uniform(0, 1, n)]).astype(np.float32)
    k = len(SPECIAL_COORDS)
    for axis in range(3):
        pts[axis * k:(axis + 1) * k, axis] = SPECIAL_COORDS
    pts[3 * k, :3] = np.nan
    return pts


# -- 3D: the sorted-segment mean of SECOND's voxel stage (kernel 5) --

SEGMENT_KINDS = (
    "random", "singletons", "one_slot", "weights", "gaps", "dump_tail", "all_dump", "overflow",
    "late_start", "gap_before_dump", "single_row", "long_slot",
)


def segment_inputs(kind: str, n: int, num_slots: int, seed: int = 0):
    """Kernel 5's inputs: valsT (8, n) float32 and slots (n,) int32,
    non-decreasing, ``num_slots`` the dump id. Slots are dense ranks of
    sorted random cell ids, as ``fused_mean_volume`` makes them, so within
    any 1024 rows the live ids advance by far less than 1024 (the TPU
    kernel's slot window needs that). Feature rows 0-6 lie in [3, 5], so a
    sum never cancels and a relative tolerance means what it says; row 7
    is the weight, 1 on live rows. Dump rows carry values too: the kernel
    must not read them.

    ``random`` about 1.6 rows a slot; ``singletons`` every row its own
    slot; ``one_slot`` every row in slot ``num_slots // 2`` (keep ``n`` to
    a few thousand: the plain version loops over the longest slot);
    ``weights`` non-unit weights in row 7, a tenth of them 0; ``gaps``
    every third slot used, 8 rows each on average; ``dump_tail`` the last
    quarter of the rows at the dump id, as padding; ``all_dump`` every row
    there; ``overflow`` more distinct cells than ``num_slots`` (the cap of
    ``max_voxels``): the rows past it go to the dump id.

    Four more aim at where a slot begins and ends: ``late_start`` the first
    live slot is ``num_slots // 4``, not 0; ``gap_before_dump`` the last
    ``num_slots // 16`` slots are empty and the dump rows follow the last
    live slot at once; ``single_row`` one live row (row 0, slot
    ``num_slots // 3``), the rest at the dump id; ``long_slot`` the ``n //
    8`` rows (at most 512) from row ``n // 3`` share one slot among short
    ones."""
    rng = np.random.default_rng(seed)
    cells = {"gaps": max(1, n // 8), "overflow": 4 * n}.get(kind, n)
    ids = np.sort(rng.integers(0, cells, n))
    rank = np.concatenate([[0], np.cumsum(ids[1:] != ids[:-1])])
    if kind == "singletons":
        rank = np.arange(n)
    elif kind == "one_slot":
        rank = np.full(n, num_slots // 2)
    elif kind == "gaps":
        rank = 3 * rank
    elif kind == "late_start":
        rank = rank + num_slots // 4
    elif kind == "gap_before_dump":
        rank = np.where(rank < num_slots - max(1, num_slots // 16), rank, num_slots)
    elif kind == "single_row":
        rank = np.full(n, num_slots)
        rank[0] = num_slots // 3
    elif kind == "long_slot":
        a = n // 3
        rank[a:a + min(n // 8, 512)] = rank[a]
    slots = np.minimum(rank, num_slots)
    if kind == "dump_tail":
        slots[n - n // 4:] = num_slots
    elif kind == "all_dump":
        slots[:] = num_slots
    vals = rng.uniform(3.0, 5.0, (8, n))
    vals[7] = 1.0
    if kind == "weights":
        vals[7] = rng.uniform(0.5, 2.0, n)
        vals[7, rng.uniform(size=n) < 0.1] = 0.0
    vals[7, slots == num_slots] = rng.uniform(0.5, 2.0, int((slots == num_slots).sum()))
    return vals.astype(np.float32), slots.astype(np.int32)


# -- the segment sum of packed ragged batches (kernel 6) --

SEGSUM_KINDS = ("layout", "unsorted", "out_of_range", "empty_segments", "one_segment", "decades")
# the main path's packed rows: 8 clouds of ~70k points
SEGSUM_MAIN_ROWS = 560_000


def segsum_inputs(kind: str, r: int, f: int, num_segments: int, seed: int = 0):
    """Kernel 6's inputs: values (r, f) float32 in [-2, 2] (finite: the
    TPU kernel's one-hot product spreads a non-finite value to every
    segment, a per-segment sum does not) and segment ids (r,) int32.

    ``layout`` the ragged layout's ids: sorted, the segments' sizes drawn
    at random, the last tenth of the rows at the pad id ``num_segments``
    with values that replicate the last real row; ``unsorted`` ids drawn
    uniformly in [0, num_segments); ``out_of_range`` a third of the ids
    negative or >= num_segments (-1, the pad id, the TPU's 8-aligned
    segment count and beyond); ``empty_segments`` only even segments
    used; ``one_segment`` every row in segment ``num_segments // 2``;
    ``decades`` values spread over six decades (|v| from 1e-3 to 100) and a
    fifth of the ids out of range (-1, the pad id, beyond), so that
    another summation order changes the bits."""
    rng = np.random.default_rng(seed)
    s = num_segments
    vals = rng.uniform(-2.0, 2.0, (r, f))
    if kind == "layout":
        live = r - r // 10
        cuts = np.sort(rng.integers(0, live + 1, max(0, s - 1)))
        sizes = np.diff(np.concatenate([[0], cuts, [live]]))
        ids = np.full(r, s)
        ids[:live] = np.repeat(np.arange(s), sizes)
        if 0 < live < r:
            vals[live:] = vals[live - 1]
    elif kind == "unsorted":
        ids = rng.integers(0, s, r)
    elif kind == "out_of_range":
        ids = rng.integers(0, s, r)
        bad = rng.uniform(size=r) < 1 / 3
        s_pad = -(-s // 8) * 8
        ids[bad] = rng.choice([-1, -7, s, s_pad, s_pad + 1, 2**31 - 1], int(bad.sum()))
    elif kind == "empty_segments":
        ids = 2 * rng.integers(0, (s + 1) // 2, r)
    elif kind == "one_segment":
        ids = np.full(r, s // 2)
    elif kind == "decades":
        vals = vals / 2.0 * 10.0 ** rng.integers(-3, 3, (r, f))
        ids = rng.integers(0, s, r)
        bad = rng.uniform(size=r) < 0.2
        ids[bad] = rng.choice([-1, s, s + 7], int(bad.sum()))
    else:
        raise ValueError(f"unknown segment-sum kind {kind!r}")
    return vals.astype(np.float32), ids.astype(np.int32)


# (R, F, S) at and around every boundary of kernel 6's summation order: one
# row, a sub-chunk of 128, a chunk of 1024, several chunks, and C = 8, 9
# and 17 chunks, where the fold's groups grow from one chunk to two and
# three; F = 40 spans two feature tiles of 32 and 8; F = 12 and 20 fill
# a tile of 16 and of 32 only in part
SEGSUM_BOUNDARY_SHAPES = (
    (1, 4, 8), (127, 4, 8), (128, 4, 8), (129, 4, 8), (1023, 4, 8), (1025, 4, 8),
    (3 * 1024 + 17, 4, 8), (8 * 1024, 4, 8), (8 * 1024 + 1, 4, 8), (16 * 1024 + 1, 3, 5),
    (1025, 40, 3), (1025, 12, 8), (1025, 20, 3),
)

# (kind, R, F, S): every kind at the main path's shape, then F in
# {1, 4, 12, 20, 64, 130}, S in {1, 3, 8, 64} and R in {1, 7, 131,072,
# ~560k}; F = 12 and 20 leave part of a tile's columns past F
SEGSUM_CASES = (
    *((kind, SEGSUM_MAIN_ROWS, 4, 8) for kind in SEGSUM_KINDS),
    ("unsorted", 131072, 1, 8), ("layout", 131072, 64, 64), ("out_of_range", 131072, 130, 64),
    ("empty_segments", 131072, 130, 1), ("layout", 1, 4, 8), ("unsorted", 7, 130, 64),
    ("out_of_range", 7, 1, 1), ("one_segment", 131072, 64, 8), ("layout", SEGSUM_MAIN_ROWS, 4, 64),
    ("layout", 131072, 12, 8), ("unsorted", 131072, 20, 3),
)
