"""Axis-aligned 2D box utilities on tensors (port of ``ops/boxes.py``)."""

from __future__ import annotations

import torch

from triton_client_tpu_torch.device import values_on


def xywh2xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[cx, cy, w, h] -> [x1, y1, x2, y2]; boxes is (..., 4)."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) xyxy boxes -> (...)."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def scale_boxes(
    boxes: torch.Tensor, model_hw: tuple[int, int], orig_hw: tuple[int, int]
) -> torch.Tensor:
    """Rescale xyxy boxes from model input resolution to the original
    image, per axis, after a plain (non-letterbox) resize."""
    mh, mw = model_hw
    oh, ow = orig_hw
    sx = ow / mw
    sy = oh / mh
    return boxes * values_on((sx, sy, sx, sy), boxes.dtype, boxes.device)
