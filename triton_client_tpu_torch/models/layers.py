"""Shared conv building blocks as ``nn.Module``s (port of
``models/layers.py``).

Modules run NCHW inside (the layout cuDNN wants); the models' public
functions keep the JAX package's NHWC. Submodule names follow the flax
names (``conv``/``bn``, ``cv1``..``cv3``, ``m``) so ``models/convert``
maps a flax tree onto a ``state_dict`` by path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def autopad(kernel: int, padding: int | None = None) -> int:
    """'same' padding for odd kernels (the YOLO convention)."""
    return kernel // 2 if padding is None else padding


class ConvBnAct(nn.Module):
    """Conv2D (no bias) + BatchNorm (eps 1e-3, as ultralytics YOLOv5) +
    SiLU, or no activation with ``act=False``."""

    def __init__(
        self,
        cin: int,
        cout: int,
        kernel: int = 1,
        stride: int = 1,
        padding: int | None = None,
        act: bool = True,
        eps: float = 1e-3,
    ) -> None:
        super().__init__()
        self.conv = nn.Conv2d(
            cin, cout, kernel, stride=stride, padding=autopad(kernel, padding), bias=False
        )
        self.bn = nn.BatchNorm2d(cout, eps=eps, momentum=0.03)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    """Two convs with an optional residual add."""

    def __init__(self, cin: int, cout: int, shortcut: bool = True, expansion: float = 0.5) -> None:
        super().__init__()
        hidden = int(cout * expansion)
        self.cv1 = ConvBnAct(cin, hidden, 1)
        self.cv2 = ConvBnAct(hidden, cout, 3)
        self.add = shortcut and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs: split, stack bottlenecks, merge."""

    def __init__(
        self, cin: int, cout: int, depth: int = 1, shortcut: bool = True, expansion: float = 0.5
    ) -> None:
        super().__init__()
        hidden = int(cout * expansion)
        self.cv1 = ConvBnAct(cin, hidden, 1)
        self.cv2 = ConvBnAct(cin, hidden, 1)
        self.m = nn.Sequential(
            *(Bottleneck(hidden, hidden, shortcut, expansion=1.0) for _ in range(depth))
        )
        self.cv3 = ConvBnAct(2 * hidden, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained stride-1 max-pools. The
    pools pad with -inf, as flax's ``max_pool`` does."""

    def __init__(self, cin: int, cout: int, pool: int = 5) -> None:
        super().__init__()
        hidden = cin // 2
        self.cv1 = ConvBnAct(cin, hidden, 1)
        self.cv2 = ConvBnAct(hidden * 4, cout, 1)
        self.pool = pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pools = [self.cv1(x)]
        for _ in range(3):
            # max_pool2d's implicit padding is -inf
            pools.append(F.max_pool2d(pools[-1], self.pool, stride=1, padding=self.pool // 2))
        return self.cv2(torch.cat(pools, dim=1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (NCHW)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def make_divisible(v: float, divisor: int = 8) -> int:
    """Round channel counts to a hardware-friendly multiple."""
    return max(divisor, int(round(v / divisor) * divisor))


def scale_depth(n: int, depth_multiple: float) -> int:
    return max(1, round(n * depth_multiple))


@torch.no_grad()
def init_random_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights, drawn as flax initialises the JAX models:
    conv and dense kernels from N(0, 1/fan_in), biases 0, BatchNorm
    scale 1, bias 0, running mean 0, running var 1. The numbers differ
    from the JAX package's (another generator); the statistics match.
    A transposed conv's fan-in is cin * kh * kw, as flax counts it."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.Linear, nn.ConvTranspose2d)):
            w = mod.weight
            fan_in = w[0].numel()
            if isinstance(mod, nn.ConvTranspose2d):  # weight (cin, cout, kh, kw)
                fan_in = w.shape[0] * w[0, 0].numel()
            w.copy_(torch.randn(w.shape, generator=gen) / fan_in**0.5)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.reset_parameters()
    return model
