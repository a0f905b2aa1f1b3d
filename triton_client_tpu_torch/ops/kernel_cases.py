"""Seeded candidate sets for holding the greedy-suppression kernels
against their plain versions and the JAX package's TPU kernels.

numpy only, so the CPU tests and ``chip_smoke.py`` build the same
inputs from the same seeds. Each kind aims at one hazard of the greedy
loop: ``random`` (ordinary), ``ties`` (equal scores: argmax must take
the lowest index), ``all_invalid`` (no live candidate: rows stay zero,
indices 0), ``chain`` (each box suppresses only its neighbour, so the
result depends on the order of suppression) and ``large`` (coordinates
near 1e5, where the class-offset stride and the IoU round coarsely).
"""

from __future__ import annotations

import numpy as np

KINDS = ("random", "ties", "all_invalid", "chain", "large")


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


def nms_inputs(kind: str, n: int, seed: int = 0):
    """One image's input for plain greedy NMS: xyxy boxes (n, 4) and
    scores (n,) with -inf where invalid."""
    boxes, scores, _, valid = candidates(kind, n, seed=seed, box_format="xyxy")
    return boxes, np.where(valid, scores, -np.inf).astype(np.float32)
