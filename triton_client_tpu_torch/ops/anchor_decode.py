"""Anchor tables and box decoding of the detectron family (port of
``ops/anchor_decode.py``): RetinaNet's per-level anchor grids (3 scales x
3 ratios a cell, strides 8 to 128 for FPN P3-P7) with Faster R-CNN's delta
decode, and FCOS's cell centres with its ltrb distance decode.

The tables are numpy, built on the host once per input size, as in the JAX
package; the models hold them on the device as buffers, so a captured body
only reads them.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

# detectron2's RetinaNet defaults: sizes 32..512 on P3..P7, 3 octave
# scales, aspect ratios 1:2 / 1:1 / 2:1
RETINA_STRIDES = (8, 16, 32, 64, 128)
RETINA_SIZES = (32, 64, 128, 256, 512)
RETINA_RATIOS = (0.5, 1.0, 2.0)
RETINA_OCTAVES = (1.0, 2 ** (1 / 3), 2 ** (2 / 3))

# the delta clamp from above, log of the largest scale factor
# (detectron2's SCALE_CLAMP)
SCALE_CLAMP = math.log(1000.0 / 16)


def cell_anchors(
    size: float,
    ratios: Sequence[float] = RETINA_RATIOS,
    octaves: Sequence[float] = RETINA_OCTAVES,
) -> np.ndarray:
    """(A, 4) xyxy anchors centred at the origin for one level."""
    out = []
    for octave in octaves:
        area = (size * octave) ** 2
        for ratio in ratios:
            w = math.sqrt(area / ratio)
            h = w * ratio
            out.append([-w / 2, -h / 2, w / 2, h / 2])
    return np.asarray(out, np.float32)


def level_anchors(feat_hw: tuple[int, int], stride: int, base: np.ndarray) -> np.ndarray:
    """(H*W*A, 4) anchors of one pyramid level, in (h, w, anchor) order."""
    h, w = feat_hw
    shift_x = (np.arange(w, dtype=np.float32) + 0.5) * stride
    shift_y = (np.arange(h, dtype=np.float32) + 0.5) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def pyramid_anchors(
    input_hw: tuple[int, int],
    strides: Sequence[int] = RETINA_STRIDES,
    sizes: Sequence[float] = RETINA_SIZES,
    ratios: Sequence[float] = RETINA_RATIOS,
    octaves: Sequence[float] = RETINA_OCTAVES,
) -> np.ndarray:
    """(N, 4) anchors of every level for an input size; each level's grid
    is the input over its stride, rounded up, as the convolutions' padding
    gives it."""
    out = []
    for stride, size in zip(strides, sizes):
        feat_hw = (-(-input_hw[0] // stride), -(-input_hw[1] // stride))
        out.append(level_anchors(feat_hw, stride, cell_anchors(size, ratios, octaves)))
    return np.concatenate(out, axis=0)


def decode_deltas(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Faster R-CNN's parameterisation: anchors (N, 4) xyxy and deltas
    (..., N, 4) [dx, dy, dw, dh] -> (..., N, 4) xyxy boxes. dw and dh are
    clamped from above only, at ``SCALE_CLAMP``."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = anchors[:, 0] + 0.5 * aw
    ay = anchors[:, 1] + 0.5 * ah

    dx, dy, dw, dh = deltas.unbind(-1)
    dw = torch.clamp(dw, max=SCALE_CLAMP)
    dh = torch.clamp(dh, max=SCALE_CLAMP)

    cx = dx * aw + ax
    cy = dy * ah + ay
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def fcos_locations(
    input_hw: tuple[int, int], strides: Sequence[int] = RETINA_STRIDES
) -> np.ndarray:
    """(N, 2) FCOS cell centres across the pyramid."""
    out = []
    for stride in strides:
        h = -(-input_hw[0] // stride)
        w = -(-input_hw[1] // stride)
        xs = (np.arange(w, dtype=np.float32) + 0.5) * stride
        ys = (np.arange(h, dtype=np.float32) + 0.5) * stride
        gx, gy = np.meshgrid(xs, ys)
        out.append(np.stack([gx, gy], axis=-1).reshape(-1, 2))
    return np.concatenate(out, axis=0)


def fcos_decode(locations: torch.Tensor, ltrb: torch.Tensor) -> torch.Tensor:
    """Locations (N, 2) and ltrb distances (..., N, 4) -> xyxy boxes."""
    x, y = locations[:, 0], locations[:, 1]
    return torch.stack(
        [x - ltrb[..., 0], y - ltrb[..., 1], x + ltrb[..., 2], y + ltrb[..., 3]], dim=-1
    )
