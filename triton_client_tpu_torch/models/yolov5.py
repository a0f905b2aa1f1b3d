"""YOLOv5 as an ``nn.Module`` (port of ``models/yolov5.py``).

v6.0-style CSP backbone + SPPF + PANet neck + anchor Detect head at
strides 8/16/32, scaled by (depth_multiple, width_multiple). Input is
NHWC float in [0, 1]; the heads come back in the JAX package's layout,
(B, h, w, anchors, 5+nc), so decoded predictions flatten in
(b, h, w, anchor) order. Inside, the convolutions run NCHW.

Two layout options of the JAX model are served (``examples/yolov5_crop``):

- ``s2d``: space-to-depth of the NHWC input to (H/2, W/2, 12), channel
  ``(a*2 + b)*3 + c`` for the pixel at row offset ``a``, column offset
  ``b`` of its 2x2 block, then the stem as a 3x3 stride-1 conv; the
  blocking happens on NHWC before the NCHW permute, so the channel order
  is the JAX model's and ``runtime/importers`` reshapes an upstream 6x6
  stem onto it exactly;
- ``ch_floor``: every stage width raised to at least this many channels.

``dtype`` is the body's compute dtype: with ``torch.bfloat16`` every
convolution and BatchNorm of the body holds its tensors in bfloat16, and
the three detect convs run in float32 on float32 features, whatever the
dtype their weights are stored in.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from triton_client_tpu_torch.models.layers import (
    C3,
    SPPF,
    ConvBnAct,
    make_divisible,
    scale_depth,
    upsample2x,
)
from triton_client_tpu_torch.ops.yolo_decode import decode_yolo_grid

# (depth_multiple, width_multiple), upstream YOLOv5 scaling table.
YOLOV5_VARIANTS: dict[str, tuple[float, float]] = {
    "n": (0.33, 0.25),
    "s": (0.33, 0.50),
    "m": (0.67, 0.75),
    "l": (1.0, 1.0),
    "x": (1.33, 1.25),
}

# COCO-default anchor grid per stride (P3/8, P4/16, P5/32), pixels.
DEFAULT_ANCHORS: tuple[tuple[tuple[int, int], ...], ...] = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)
STRIDES = (8, 16, 32)


class YoloV5(nn.Module):
    """YOLOv5 detector. ``forward`` returns the raw per-scale heads;
    ``decode`` maps them to (B, N, 5+nc) predictions in input pixels.
    ``s2d``, ``ch_floor`` and ``dtype``: the module docstring."""

    def __init__(
        self,
        num_classes: int = 80,
        variant: str = "n",
        anchors: Sequence[Sequence[tuple[int, int]]] = DEFAULT_ANCHORS,
        s2d: bool = False,
        ch_floor: int = 0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        if variant not in YOLOV5_VARIANTS:
            raise ValueError(f"unknown YOLOv5 variant {variant!r} (of {sorted(YOLOV5_VARIANTS)})")
        self.num_classes = num_classes
        self.variant = variant
        self.anchors = tuple(tuple(tuple(a) for a in scale) for scale in anchors)
        self.s2d, self.ch_floor, self.dtype = s2d, ch_floor, dtype
        depth_mult, width_mult = YOLOV5_VARIANTS[variant]

        def c(ch: int) -> int:
            return max(make_divisible(ch * width_mult), ch_floor)

        def d(n: int) -> int:
            return scale_depth(n, depth_mult)

        na = len(self.anchors[0])
        self.na, self.no = na, 5 + num_classes
        # Backbone
        if s2d:
            self.stem = ConvBnAct(12, c(64), 3, 1)
        else:
            self.stem = ConvBnAct(3, c(64), 6, 2, padding=2)
        self.down2 = ConvBnAct(c(64), c(128), 3, 2)
        self.c3_2 = C3(c(128), c(128), d(3))
        self.down3 = ConvBnAct(c(128), c(256), 3, 2)
        self.c3_3 = C3(c(256), c(256), d(6))
        self.down4 = ConvBnAct(c(256), c(512), 3, 2)
        self.c3_4 = C3(c(512), c(512), d(9))
        self.down5 = ConvBnAct(c(512), c(1024), 3, 2)
        self.c3_5 = C3(c(1024), c(1024), d(3))
        self.sppf = SPPF(c(1024), c(1024), 5)
        # PANet neck: top-down then bottom-up.
        self.lat5 = ConvBnAct(c(1024), c(512), 1)
        self.c3_up4 = C3(c(512) * 2, c(512), d(3), shortcut=False)
        self.lat4 = ConvBnAct(c(512), c(256), 1)
        self.c3_up3 = C3(c(256) * 2, c(256), d(3), shortcut=False)
        self.pan3 = ConvBnAct(c(256), c(256), 3, 2)
        self.c3_pan4 = C3(c(256) * 2, c(512), d(3), shortcut=False)
        self.pan4 = ConvBnAct(c(512), c(512), 3, 2)
        self.c3_pan5 = C3(c(512) * 2, c(1024), d(3), shortcut=False)
        # Detect head: 1x1 conv per scale, float32 whatever the body's
        # dtype (box regression is precision-sensitive at the output).
        self.detect0 = nn.Conv2d(c(256), na * self.no, 1)
        self.detect1 = nn.Conv2d(c(512), na * self.no, 1)
        self.detect2 = nn.Conv2d(c(1024), na * self.no, 1)
        for name, child in self.named_children():
            if not name.startswith("detect"):
                child.to(dtype)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: (B, H, W, 3) float in [0, 1] -> raw float32 heads
        [(B, H/8, W/8, a, 5+nc), (B, H/16, ...), (B, H/32, ...)]."""
        x = x.to(self.dtype)
        if self.s2d:
            b, h, w, ch = x.shape
            x = x.reshape(b, h // 2, 2, w // 2, 2, ch).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(b, h // 2, w // 2, 4 * ch)
        x = x.permute(0, 3, 1, 2)
        x = self.c3_2(self.down2(self.stem(x)))
        p3 = self.c3_3(self.down3(x))
        p4 = self.c3_4(self.down4(p3))
        p5 = self.sppf(self.c3_5(self.down5(p4)))

        t5 = self.lat5(p5)
        n4 = self.c3_up4(torch.cat([upsample2x(t5), p4], dim=1))
        t4 = self.lat4(n4)
        out3 = self.c3_up3(torch.cat([upsample2x(t4), p3], dim=1))
        out4 = self.c3_pan4(torch.cat([self.pan3(out3), t4], dim=1))
        out5 = self.c3_pan5(torch.cat([self.pan4(out4), t5], dim=1))

        heads = []
        for conv, feat in zip((self.detect0, self.detect1, self.detect2), (out3, out4, out5)):
            # float32 on float32 features, whatever the body's dtype and the
            # weights' storage (the JAX model's detect head)
            h = F.conv2d(feat.float(), conv.weight.float(), conv.bias.float())
            h = h.permute(0, 2, 3, 1)
            b, hh, ww, _ = h.shape
            heads.append(h.reshape(b, hh, ww, self.na, self.no))
        return heads

    def decode(self, heads: list[torch.Tensor]) -> torch.Tensor:
        """Raw heads -> (B, sum(h*w*a), 5+nc) decoded predictions in
        input-pixel units ((1, 16128, 7) for 512x512, nc=2)."""
        return torch.cat(
            [decode_yolo_grid(h, self.anchors[i], STRIDES[i], "v5") for i, h in enumerate(heads)],
            dim=1,
        )


def num_predictions(input_hw: tuple[int, int], num_anchors: int = 3) -> int:
    """Total prediction slots for an input size (e.g. 512 -> 16128)."""
    h, w = input_hw
    return sum((h // s) * (w // s) * num_anchors for s in STRIDES)
