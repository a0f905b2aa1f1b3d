"""YOLO anchor-grid decode, v5 and v4 conventions (port of
``ops/yolo_decode.py``).

  v5: xy = (2*sig(t_xy) - 0.5 + grid) * stride,  wh = (2*sig(t_wh))**2 * anchor
  v4: xy = (sig(t_xy) + grid) * stride,          wh = exp(t_wh) * anchor
"""

from __future__ import annotations

import torch

from triton_client_tpu_torch.device import values_on


def _grid(h: int, w: int, device) -> torch.Tensor:
    """(h, w, 2) grid of (x, y) cell offsets."""
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def decode_yolo_grid(
    raw: torch.Tensor,
    anchors,
    stride: int,
    variant: str = "v5",
    normalize_hw: tuple[int, int] | None = None,
) -> torch.Tensor:
    """One scale's raw head (b, h, w, a, 5+nc) -> (b, h*w*a, 5+nc)
    decoded [cx, cy, w, h, obj, cls...] in input pixels (or [0, 1] with
    ``normalize_hw``), flattened in (h, w, anchor) order. Decodes in
    float32 whatever the head's dtype."""
    b, h, w, a, no = raw.shape
    raw = raw.to(torch.float32)
    grid = _grid(h, w, raw.device)[None, :, :, None, :]
    anchors = values_on((v for pair in anchors for v in pair), torch.float32, raw.device)
    anchors = anchors.reshape(1, 1, 1, a, 2)

    txy, twh, trest = raw[..., :2], raw[..., 2:4], raw[..., 4:]
    if variant == "v5":
        xy = (torch.sigmoid(txy) * 2.0 - 0.5 + grid) * stride
        wh = (torch.sigmoid(twh) * 2.0) ** 2 * anchors
    elif variant == "v4":
        xy = (torch.sigmoid(txy) + grid) * stride
        wh = torch.exp(twh) * anchors
    else:
        raise ValueError(f"unknown decode variant: {variant}")
    rest = torch.sigmoid(trest)

    out = torch.cat([xy, wh, rest], dim=-1)
    if normalize_hw is not None:
        nh, nw = normalize_hw
        scale = values_on([nw, nh, nw, nh] + [1.0] * (no - 4), torch.float32, raw.device)
        out = out / scale
    return out.reshape(b, h * w * a, no)
