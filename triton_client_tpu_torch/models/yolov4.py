"""YOLOv4 as an ``nn.Module`` (port of ``models/yolov4.py``).

CSPDarknet53 (mish) + SPP + PANet (leaky) + anchor heads at strides
8/16/32. Input is NHWC float in [0, 1]; the heads come back in the JAX
model's layout, (B, h, w, anchors, 5+nc), and the convolutions run NCHW
inside. ``decode_flat`` gives the (B, N, 5+nc) pixel predictions the 2D
pipeline takes, as YOLOv5's ``decode`` does; ``decode_wire`` the
reference's served contract (normalised corner ``boxes (B, N, 1, 4)`` and
``confs = obj * cls``).

Every BatchNorm keeps PyTorch's eps 1e-5, as pytorch-YOLOv4 does, so
imported running statistics give the upstream function. The SPP
concatenation is the flax model's ``[x, p5, p9, p13]``; upstream's
reversed order is the importer's business (``runtime/importers``).
``dtype`` is the body's compute dtype; the three detect convs run in
float32 on float32 features under every policy. Submodules carry the flax
names (``stem``, ``stage1.res0_cv1``, ``spp.merge``, ``td4_cv0``,
``detect0``...), so ``models/convert`` maps a flax tree by path.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from triton_client_tpu_torch.models.layers import (
    ConvBnAct,
    conv_f32,
    make_divisible,
    upsample2x,
)
from triton_client_tpu_torch.ops.yolo_decode import decode_yolo_grid

# upstream YOLOv4's anchors (pixels at 512 input), three a stride 8/16/32
YOLOV4_ANCHORS: tuple[tuple[tuple[int, int], ...], ...] = (
    ((12, 16), (19, 36), (40, 28)),
    ((36, 75), (76, 55), (72, 146)),
    ((142, 110), (192, 243), (459, 401)),
)
STRIDES = (8, 16, 32)


def _cba(cin: int, cout: int, kernel: int = 1, stride: int = 1, act: str = "mish") -> ConvBnAct:
    return ConvBnAct(cin, cout, kernel, stride, act=act, eps=1e-5)


class CSPStage(nn.Module):
    """Darknet's CSP downsampling stage: a stride-2 conv, then a
    split-residual stack merged by 1x1 convs. ``first`` keeps the hidden
    width at the full width (darknet53's first stage)."""

    def __init__(self, cin: int, features: int, depth: int, first: bool = False) -> None:
        super().__init__()
        hidden = features if first else features // 2
        self.depth = depth
        self.down = _cba(cin, features, 3, 2)
        self.split_main = _cba(features, hidden)
        self.split_short = _cba(features, hidden)
        for i in range(depth):
            setattr(self, f"res{i}_cv1", _cba(hidden, features // 2))
            setattr(self, f"res{i}_cv2", _cba(features // 2, hidden, 3))
        self.post = _cba(hidden, hidden)
        self.merge = _cba(2 * hidden, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.down(x)
        main, short = self.split_main(x), self.split_short(x)
        for i in range(self.depth):
            main = main + getattr(self, f"res{i}_cv2")(getattr(self, f"res{i}_cv1")(main))
        return self.merge(torch.cat([self.post(main), short], dim=1))


class SPP(nn.Module):
    """YOLOv4's spatial pyramid pooling: parallel 5/9/13 max-pools (their
    padding is -inf, as flax's)."""

    def __init__(self, cin: int, features: int) -> None:
        super().__init__()
        self.merge = _cba(4 * cin, features, act="leaky")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pools = [x] + [F.max_pool2d(x, k, stride=1, padding=k // 2) for k in (5, 9, 13)]
        return self.merge(torch.cat(pools, dim=1))


class YoloV4(nn.Module):
    """YOLOv4. ``forward`` returns the raw heads; ``decode_flat`` and
    ``decode_wire`` map them to served outputs. ``width`` scales the
    channels through ``make_divisible`` (1.0: the full CSPDarknet53)."""

    def __init__(
        self,
        num_classes: int = 80,
        anchors: Sequence[Sequence[tuple[int, int]]] = YOLOV4_ANCHORS,
        width: float = 1.0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.num_classes, self.width, self.dtype = num_classes, width, dtype
        self.anchors = tuple(tuple(tuple(a) for a in scale) for scale in anchors)

        def c(ch: int) -> int:
            return make_divisible(ch * width)

        na = len(self.anchors[0])
        self.na, self.no = na, 5 + num_classes
        # CSPDarknet53, depths 1, 2, 8, 8, 4
        self.stem = _cba(3, c(32), 3)
        self.stage1 = CSPStage(c(32), c(64), 1, first=True)
        self.stage2 = CSPStage(c(64), c(128), 2)
        self.stage3 = CSPStage(c(128), c(256), 8)
        self.stage4 = CSPStage(c(256), c(512), 8)
        self.stage5 = CSPStage(c(512), c(1024), 4)
        # SPP between two 1-3-1 groups
        self.pre_spp0 = _cba(c(1024), c(512), 1, act="leaky")
        self.pre_spp1 = _cba(c(512), c(1024), 3, act="leaky")
        self.pre_spp2 = _cba(c(1024), c(512), 1, act="leaky")
        self.spp = SPP(c(512), c(512))
        self.post_spp0 = _cba(c(512), c(1024), 3, act="leaky")
        self.post_spp1 = _cba(c(1024), c(512), 1, act="leaky")
        # PANet: top-down with lateral 1x1s, then bottom-up
        self.td4_lat = _cba(c(512), c(256), act="leaky")
        self.td4_up = _cba(c(512), c(256), act="leaky")
        self._conv5("td4", 2 * c(256), c(256))
        self.td3_lat = _cba(c(256), c(128), act="leaky")
        self.td3_up = _cba(c(256), c(128), act="leaky")
        self._conv5("td3", 2 * c(128), c(128))
        self.bu4_down = _cba(c(128), c(256), 3, 2, act="leaky")
        self._conv5("bu4", 2 * c(256), c(256))
        self.bu5_down = _cba(c(256), c(512), 3, 2, act="leaky")
        self._conv5("bu5", 2 * c(512), c(512))
        # heads: a 3x3 leaky conv, then a linear 1x1 in float32
        for i, (cin, ch) in enumerate(((c(128), c(256)), (c(256), c(512)), (c(512), c(1024)))):
            setattr(self, f"head{i}_cv", _cba(cin, ch, 3, act="leaky"))
            setattr(self, f"detect{i}", nn.Conv2d(ch, na * self.no, 1))
        for name, child in self.named_children():
            if not name.startswith("detect"):
                child.to(dtype)

    def _conv5(self, name: str, cin: int, features: int) -> None:
        """The neck's 1-3-1-3-1 conv block (leaky), as ``{name}_cv0..4``."""
        for i, (k, f) in enumerate(((1, features), (3, 2 * features), (1, features),
                                    (3, 2 * features), (1, features))):
            setattr(self, f"{name}_cv{i}", _cba(cin, f, k, act="leaky"))
            cin = f

    def _run5(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(5):
            x = getattr(self, f"{name}_cv{i}")(x)
        return x

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: (B, H, W, 3) float in [0, 1] -> raw float32 heads
        [(B, H/8, W/8, a, 5+nc), (B, H/16, ...), (B, H/32, ...)]."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = self.stage2(self.stage1(self.stem(x)))
        p3 = self.stage3(x)
        p4 = self.stage4(p3)
        p5 = self.stage5(p4)

        x = self.spp(self.pre_spp2(self.pre_spp1(self.pre_spp0(p5))))
        n5 = self.post_spp1(self.post_spp0(x))

        n4 = self._run5("td4", torch.cat([self.td4_lat(p4), upsample2x(self.td4_up(n5))], 1))
        n3 = self._run5("td3", torch.cat([self.td3_lat(p3), upsample2x(self.td3_up(n4))], 1))
        n4 = self._run5("bu4", torch.cat([self.bu4_down(n3), n4], 1))
        n5 = self._run5("bu5", torch.cat([self.bu5_down(n4), n5], 1))

        heads = []
        for i, feat in enumerate((n3, n4, n5)):
            h = getattr(self, f"head{i}_cv")(feat)
            h = conv_f32(getattr(self, f"detect{i}"), h).permute(0, 2, 3, 1)
            b, hh, ww, _ = h.shape
            heads.append(h.reshape(b, hh, ww, self.na, self.no))
        return heads

    def decode_flat(self, heads: list[torch.Tensor],
                    normalize_hw: tuple[int, int] | None = None) -> torch.Tensor:
        """Raw heads -> (B, sum(h*w*a), 5+nc) [cx, cy, w, h, obj, cls...]
        in input pixels (or [0, 1] with ``normalize_hw``)."""
        return torch.cat(
            [decode_yolo_grid(h, self.anchors[i], STRIDES[i], "v4", normalize_hw=normalize_hw)
             for i, h in enumerate(heads)],
            dim=1,
        )

    def decode_wire(self, heads: list[torch.Tensor],
                    input_hw: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
        """Raw heads -> the reference's served contract: ``boxes (B, N, 1,
        4)`` normalised [x1, y1, x2, y2] and ``confs (B, N, nc)`` = obj *
        cls."""
        flat = self.decode_flat(heads, normalize_hw=input_hw)
        xy, wh = flat[..., :2], flat[..., 2:4]
        x1y1 = xy - wh * 0.5
        boxes = torch.cat([x1y1, x1y1 + wh], dim=-1)[:, :, None, :]
        return boxes, flat[..., 5:] * flat[..., 4:5]


def num_predictions(input_hw: tuple[int, int], num_anchors: int = 3) -> int:
    """Prediction slots for an input size (512 -> 16,128, the reference's
    served N)."""
    h, w = input_hw
    return sum((h // s) * (w // s) * num_anchors for s in STRIDES)
