"""RetinaNet and FCOS, the detectron family, as ``nn.Module``s (port of
``models/retinanet.py``).

A ResNet backbone (basic blocks or bottlenecks), an FPN over C3-C5 with
RetinaNet's P6 (from C5) and P7 (from ``relu(P6)``), and one of two heads
over the five levels:

- ``RetinaNetHead``: anchor-based, A = 9 anchors a cell, a class subnet
  and a box subnet, the class output's bias at the focal-loss prior;
- ``FCOSHead``: anchor-free, ltrb distances (``relu(reg * scale) *
  stride``, a learned ``scale`` a level) and centerness.

Input is NHWC float, as in the JAX package; inside, the convolutions run
NCHW. A head's NCHW output is permuted to NHWC before it is flattened, so
the predictions come out in the JAX models' (level, h, w, anchor, class)
order and line up with ``ops/anchor_decode``'s tables. The models hold
those tables as buffers, built once on the host for ``input_hw``.

``dtype`` is the body's compute dtype; the final head convolutions run in
float32 on float32 features under every policy (``models/layers.conv_f32``),
as the JAX heads do. Submodules carry the flax names (``backbone.stem``,
``s{stage}b{block}.c1``, ``lat3``, ``out3``, ``p6``, ``head.cls0``,
``cls_out``, ``scale0``...), so ``models/convert`` maps a flax tree by path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from triton_client_tpu_torch.models.layers import conv_f32
from triton_client_tpu_torch.ops.anchor_decode import (
    RETINA_OCTAVES,
    RETINA_RATIOS,
    RETINA_STRIDES,
    decode_deltas,
    fcos_decode,
    fcos_locations,
    pyramid_anchors,
)


class _ConvBnRelu(nn.Module):
    """Conv (no bias) + BatchNorm (flax's default eps 1e-5) + optional ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 act: bool = True) -> None:
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1) -> None:
        super().__init__()
        self.c1 = _ConvBnRelu(cin, features, 3, stride)
        self.c2 = _ConvBnRelu(features, features, 3, 1, act=False)
        if stride != 1 or cin != features:
            self.down = _ConvBnRelu(cin, features, 1, stride, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.c2(self.c1(x))
        identity = self.down(x) if hasattr(self, "down") else x
        return F.relu(identity + y)


class Bottleneck(nn.Module):
    """``features`` is the output width, 4x the inner width; the stride
    sits on the 3x3 conv (torchvision's layout)."""

    def __init__(self, cin: int, features: int, stride: int = 1) -> None:
        super().__init__()
        inner = features // 4
        self.c1 = _ConvBnRelu(cin, inner, 1, 1)
        self.c2 = _ConvBnRelu(inner, inner, 3, stride)
        self.c3 = _ConvBnRelu(inner, features, 1, 1, act=False)
        if stride != 1 or cin != features:
            self.down = _ConvBnRelu(cin, features, 1, stride, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.c3(self.c2(self.c1(x)))
        identity = self.down(x) if hasattr(self, "down") else x
        return F.relu(identity + y)


# depth preset -> (block, blocks a stage, stage widths)
_RESNETS = {
    # "tiny" keeps the tests fast: one block a stage, narrow
    "tiny": (BasicBlock, (1, 1, 1, 1), (16, 32, 64, 128)),
    "resnet18": (BasicBlock, (2, 2, 2, 2), (64, 128, 256, 512)),
    "resnet34": (BasicBlock, (3, 4, 6, 3), (64, 128, 256, 512)),
    "resnet50": (Bottleneck, (3, 4, 6, 3), (256, 512, 1024, 2048)),
}
RESNET_DEPTHS = tuple(_RESNETS)


def _upsample2(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Nearest upsample to ``like``'s spatial shape with half-pixel centres,
    as ``jax.image.resize(..., "nearest")`` does; plain ``"nearest"`` picks
    other rows where the sizes are not exactly 2x (an odd input size)."""
    return F.interpolate(x, size=like.shape[-2:], mode="nearest-exact")


class ResNetFPN(nn.Module):
    """ResNet C2-C5 -> FPN P3-P7 (NCHW in, five NCHW levels out)."""

    def __init__(self, depth: str = "resnet50", fpn_width: int = 256) -> None:
        super().__init__()
        if depth not in _RESNETS:
            raise ValueError(f"unknown backbone depth {depth!r} (of {sorted(_RESNETS)})")
        block, stages, widths = _RESNETS[depth]
        stem = widths[0] // 4 if block is Bottleneck else widths[0]
        self.stem = _ConvBnRelu(3, stem, 7, 2)
        cin = stem
        self.blocks = []
        for si, (n, w) in enumerate(zip(stages, widths)):
            for bi in range(n):
                name = f"s{si}b{bi}"
                setattr(self, name, block(cin, w, 2 if (bi == 0 and si > 0) else 1))
                self.blocks.append((si, name))
                cin = w
        fw = fpn_width
        for level, w in zip((3, 4, 5), widths[1:]):
            setattr(self, f"lat{level}", nn.Conv2d(w, fw, 1))
            setattr(self, f"out{level}", nn.Conv2d(fw, fw, 3, padding=1))
        self.p6 = nn.Conv2d(widths[3], fw, 3, stride=2, padding=1)
        self.p7 = nn.Conv2d(fw, fw, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = F.max_pool2d(self.stem(x), 3, stride=2, padding=1)  # pads with -inf
        feats = [None] * 4
        for si, name in self.blocks:
            x = getattr(self, name)(x)
            feats[si] = x
        _, c3, c4, c5 = feats
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + _upsample2(p5, c4)
        p3 = self.lat3(c3) + _upsample2(p4, c3)
        p6 = self.p6(c5)
        return [self.out3(p3), self.out4(p4), self.out5(p5), p6, self.p7(F.relu(p6))]


def _prior_bias(prior: float = 0.01) -> float:
    """The focal-loss prior bias of the class outputs."""
    return -math.log((1 - prior) / prior)


def _subnet(owner: nn.Module, prefix: str, cin: int, width: int, depth: int) -> None:
    for i in range(depth):
        setattr(owner, f"{prefix}{i}", nn.Conv2d(cin if i == 0 else width, width, 3, padding=1))


def _run_subnet(owner: nn.Module, prefix: str, depth: int, x: torch.Tensor) -> torch.Tensor:
    for i in range(depth):
        x = F.relu(getattr(owner, f"{prefix}{i}")(x))
    return x


def _flatten(t: torch.Tensor, per_cell: int, cols: int) -> torch.Tensor:
    """(B, per_cell * cols, h, w) NCHW -> (B, h * w * per_cell, cols), in
    the NHWC order of the JAX heads."""
    b, _, h, w = t.shape
    return t.permute(0, 2, 3, 1).reshape(b, h * w * per_cell, cols)


class RetinaNetHead(nn.Module):
    """Class and box subnets shared by every level."""

    def __init__(self, num_classes: int, in_ch: int = 256, width: int = 256, depth: int = 4,
                 num_anchors: int = len(RETINA_RATIOS) * len(RETINA_OCTAVES)) -> None:
        super().__init__()
        self.num_classes, self.num_anchors, self.depth = num_classes, num_anchors, depth
        _subnet(self, "cls", in_ch, width, depth)
        _subnet(self, "box", in_ch, width, depth)
        self.cls_out = nn.Conv2d(width, num_anchors * num_classes, 3, padding=1)
        self.box_out = nn.Conv2d(width, num_anchors * 4, 3, padding=1)

    def out_convs(self) -> tuple[nn.Conv2d, ...]:
        return (self.cls_out, self.box_out)

    @torch.no_grad()
    def init_prior_(self) -> None:
        self.cls_out.bias.fill_(_prior_bias())

    def forward(self, pyramid) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (B, N, num_classes) logits and (B, N, 4) deltas, float32, N
        over the levels in pyramid order (``pyramid_anchors``' order)."""
        logits, deltas = [], []
        for feat in pyramid:
            c = conv_f32(self.cls_out, _run_subnet(self, "cls", self.depth, feat))
            logits.append(_flatten(c, self.num_anchors, self.num_classes))
            d = conv_f32(self.box_out, _run_subnet(self, "box", self.depth, feat))
            deltas.append(_flatten(d, self.num_anchors, 4))
        return torch.cat(logits, dim=1), torch.cat(deltas, dim=1)


class _Scale(nn.Module):
    """FCOS's learned scalar of one level's distances."""

    def __init__(self) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(1))


class FCOSHead(nn.Module):
    """Anchor-free head: class logits, ltrb distances, centerness."""

    def __init__(self, num_classes: int, in_ch: int = 256, width: int = 256,
                 depth: int = 4) -> None:
        super().__init__()
        self.num_classes, self.depth = num_classes, depth
        _subnet(self, "cls", in_ch, width, depth)
        _subnet(self, "reg", in_ch, width, depth)
        self.cls_out = nn.Conv2d(width, num_classes, 3, padding=1)
        self.reg_out = nn.Conv2d(width, 4, 3, padding=1)
        self.ctr_out = nn.Conv2d(width, 1, 3, padding=1)
        for level in range(len(RETINA_STRIDES)):
            setattr(self, f"scale{level}", _Scale())

    def out_convs(self) -> tuple[nn.Conv2d, ...]:
        return (self.cls_out, self.reg_out, self.ctr_out)

    @torch.no_grad()
    def init_prior_(self) -> None:
        self.cls_out.bias.fill_(_prior_bias())

    def forward(self, pyramid) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (B, N, nc) logits, (B, N, 4) ltrb >= 0, (B, N) centerness,
        float32."""
        logits, ltrb, ctr = [], [], []
        for level, feat in enumerate(pyramid):
            c = _run_subnet(self, "cls", self.depth, feat)
            r = _run_subnet(self, "reg", self.depth, feat)
            logits.append(_flatten(conv_f32(self.cls_out, c), 1, self.num_classes))
            scale = getattr(self, f"scale{level}").weight.float()
            dist = F.relu(conv_f32(self.reg_out, r) * scale) * RETINA_STRIDES[level]
            ltrb.append(_flatten(dist, 1, 4))
            ctr.append(_flatten(conv_f32(self.ctr_out, r), 1, 1)[..., 0])
        return torch.cat(logits, dim=1), torch.cat(ltrb, dim=1), torch.cat(ctr, dim=1)


class _Detectron(nn.Module):
    """Backbone + FPN + a head; the body in ``dtype``, the head's output
    convolutions float32."""

    def __init__(self, head: nn.Module, depth: str, input_hw, dtype: torch.dtype,
                 fpn_width: int) -> None:
        super().__init__()
        self.depth, self.input_hw, self.dtype = depth, tuple(input_hw), dtype
        self.backbone = ResNetFPN(depth, fpn_width)
        self.head = head
        self.to(dtype)
        for conv in head.out_convs():
            conv.float()

    def forward(self, x: torch.Tensor):
        """x: (B, H, W, 3) float at ``input_hw`` -> the head's outputs."""
        return self.head(self.backbone(x.to(self.dtype).permute(0, 3, 1, 2)))


class RetinaNet(_Detectron):
    """Backbone + FPN + RetinaNet head; ``decode`` reads the anchors held
    on the model's device."""

    def __init__(self, num_classes: int = 80, depth: str = "resnet50",
                 input_hw: tuple[int, int] = (480, 640), dtype: torch.dtype = torch.float32,
                 fpn_width: int = 256) -> None:
        super().__init__(RetinaNetHead(num_classes, fpn_width, fpn_width), depth, input_hw,
                         dtype, fpn_width)
        self.num_classes = num_classes
        self.register_buffer("anchors", torch.from_numpy(pyramid_anchors(self.input_hw)),
                             persistent=False)

    def decode(self, outputs) -> tuple[torch.Tensor, torch.Tensor]:
        """(logits, deltas) -> ((B, N, 4) xyxy boxes, (B, N, nc) scores)."""
        logits, deltas = outputs
        return decode_deltas(self.anchors, deltas), torch.sigmoid(logits)


class FCOS(_Detectron):
    """Backbone + FPN + FCOS head; ``decode`` reads the cell centres held
    on the model's device."""

    def __init__(self, num_classes: int = 80, depth: str = "resnet50",
                 input_hw: tuple[int, int] = (480, 640), dtype: torch.dtype = torch.float32,
                 fpn_width: int = 256) -> None:
        super().__init__(FCOSHead(num_classes, fpn_width, fpn_width), depth, input_hw, dtype,
                         fpn_width)
        self.num_classes = num_classes
        self.register_buffer("locations", torch.from_numpy(fcos_locations(self.input_hw)),
                             persistent=False)

    def decode(self, outputs) -> tuple[torch.Tensor, torch.Tensor]:
        """-> ((B, N, 4) boxes, (B, N, nc) scores): FCOS's test-time score
        ``sqrt(sigmoid(cls) * sigmoid(centerness))``."""
        logits, ltrb, ctr = outputs
        boxes = fcos_decode(self.locations, ltrb)
        return boxes, torch.sqrt(torch.sigmoid(logits) * torch.sigmoid(ctr)[..., None])


def num_locations(input_hw: tuple[int, int], per_cell: int = 1) -> int:
    return sum((-(-input_hw[0] // s)) * (-(-input_hw[1] // s)) * per_cell
               for s in RETINA_STRIDES)
