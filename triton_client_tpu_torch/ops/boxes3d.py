"""Rotated BEV box geometry: corners, IoU, NMS (port of ``ops/boxes3d.py``).

The intersection of two rotated rectangles is computed with fixed
shapes, as in the JAX package: candidate vertices are the corners of A
inside B, the corners of B inside A and the 16 edge-pair intersections;
the valid ones are sorted by angle around their centroid and summed with
the shoelace formula, invalid slots collapsed onto the first vertex.

The JAX package leaves this computation to XLA, outside any Pallas
kernel; here it is plain PyTorch on the device the boxes lie on. Its
numbers are not bitwise the JAX package's: ``cos``/``sin``/``atan2``
round differently between XLA and PyTorch, and ``jax.lax.sort`` is not
stable, which changes the vertex order only for vertices at equal angle
(their contribution to the area is then ordered differently). The tests
hold ``rotated_iou_bev`` to 1e-5 absolute against the JAX function.

Boxes are [x, y, z, dx, dy, dz, heading]; BEV uses [x, y, dx, dy, heading].
"""

from __future__ import annotations

import torch

from triton_client_tpu_torch.ops.nms import fixpoint_keep_sorted


def _corners_soa(boxes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, 5) rects -> CCW corner coordinates as (4, P) x and (4, P) y."""
    cx, cy, dx, dy, h = boxes.unbind(-1)
    cos, sin = torch.cos(h), torch.sin(h)
    lx = torch.stack([dx, -dx, -dx, dx], 0) * 0.5
    ly = torch.stack([dy, dy, -dy, -dy], 0) * 0.5
    return cx + lx * cos - ly * sin, cy + lx * sin + ly * cos


def _in_rect_soa(px, py, rect: torch.Tensor, eps: float) -> torch.Tensor:
    """(k, P) points inside (P, 5) rects -> (k, P) bool."""
    cos, sin = torch.cos(rect[:, 4]), torch.sin(rect[:, 4])
    relx, rely = px - rect[:, 0], py - rect[:, 1]
    lx = relx * cos + rely * sin
    ly = -relx * sin + rely * cos
    return (lx.abs() <= rect[:, 2] * 0.5 + eps) & (ly.abs() <= rect[:, 3] * 0.5 + eps)


def intersection_areas(
    boxes_a: torch.Tensor, boxes_b: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Elementwise intersection area of (P, 5) vs (P, 5) BEV rects -> (P,)."""
    ax, ay = _corners_soa(boxes_a)
    bx, by = _corners_soa(boxes_b)
    p = boxes_a.shape[0]

    # edge vectors; (4, 1, P) x (1, 4, P) -> (4, 4, P)
    rx = (torch.roll(ax, -1, 0) - ax)[:, None]
    ry = (torch.roll(ay, -1, 0) - ay)[:, None]
    sx = (torch.roll(bx, -1, 0) - bx)[None]
    sy = (torch.roll(by, -1, 0) - by)[None]
    px, py = ax[:, None], ay[:, None]
    qx, qy = bx[None], by[None]
    rxs = rx * sy - ry * sx
    qpx, qpy = qx - px, qy - py
    parallel = rxs.abs() < eps
    denom = torch.where(parallel, 1.0, rxs)
    t = (qpx * sy - qpy * sx) / denom
    u = (qpx * ry - qpy * rx) / denom
    val_e = ~parallel & (t >= -eps) & (t <= 1 + eps) & (u >= -eps) & (u <= 1 + eps)
    ix, iy = px + t * rx, py + t * ry

    val_a = _in_rect_soa(ax, ay, boxes_b, eps)
    val_b = _in_rect_soa(bx, by, boxes_a, eps)
    xs = torch.cat([ax, bx, ix.reshape(16, p)], 0)  # (24, P)
    ys = torch.cat([ay, by, iy.reshape(16, p)], 0)
    valid = torch.cat([val_a, val_b, val_e.reshape(16, p)], 0)

    n_valid = valid.sum(0)
    vf = valid.to(xs.dtype)
    denom_c = torch.clamp(n_valid, min=1).to(xs.dtype)
    cx = (xs * vf).sum(0) / denom_c
    cy = (ys * vf).sum(0) / denom_c
    ang = torch.where(valid, torch.atan2(ys - cy, xs - cx), float("inf"))
    order = torch.argsort(ang, dim=0, stable=True)
    xs_s, ys_s = xs.gather(0, order), ys.gather(0, order)
    valid_s = valid.gather(0, order)
    # collapse the invalid tail onto the first (valid) vertex: duplicate
    # vertices add zero to the shoelace sum
    xs_s = torch.where(valid_s, xs_s, xs_s[0])
    ys_s = torch.where(valid_s, ys_s, ys_s[0])
    cross = xs_s * torch.roll(ys_s, -1, 0) - torch.roll(xs_s, -1, 0) * ys_s
    area = 0.5 * cross.sum(0).abs()
    return torch.where(n_valid >= 3, area, 0.0)  # fewer than 3 vertices: no area


def rotated_iou_bev(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated IoU of (..., N, 5) and (..., M, 5) BEV boxes ->
    (..., N, M); leading batch dims are flattened into the pair axis."""
    *lead, n, _ = boxes1.shape
    m = boxes2.shape[-2]
    a = boxes1[..., :, None, :].expand(*lead, n, m, 5).reshape(-1, 5)
    b = boxes2[..., None, :, :].expand(*lead, n, m, 5).reshape(-1, 5)
    inter = intersection_areas(a, b).reshape(*lead, n, m)
    area1 = boxes1[..., 2] * boxes1[..., 3]
    area2 = boxes2[..., 2] * boxes2[..., 3]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def boxes7_to_bev(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) [x, y, z, dx, dy, dz, heading] -> (..., 5) BEV."""
    return torch.cat([boxes[..., 0:2], boxes[..., 3:5], boxes[..., 6:7]], -1)


def nms_bev(
    boxes: torch.Tensor, scores: torch.Tensor, iou_thresh=0.01, max_det: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy rotated-BEV NMS over (B, N, 7) boxes and (B, N) scores (-inf
    = padding) -> ((B, max_det) int32 indices, (B, max_det) valid). The
    IoU matrix of the score-sorted candidates is computed once; the
    suppression resolves as the greedy fixpoint (``ops/nms``)."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    bev = boxes7_to_bev(torch.take_along_dim(boxes, order[..., None], dim=-2))
    valid0 = scores.gather(-1, order) > float("-inf")
    iou = rotated_iou_bev(bev, bev)
    return fixpoint_keep_sorted(iou, valid0, order, iou_thresh, max_det)
