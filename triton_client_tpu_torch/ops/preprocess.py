"""Image preprocessing on tensors (port of ``ops/preprocess.py`` and of
the resize in ``pipelines/detect2d.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from triton_client_tpu_torch.device import values_on


def normalize_image(img: torch.Tensor, scaling: str = "yolo") -> torch.Tensor:
    """Pixel scaling modes; input (..., 3) RGB uint8/float, output float32."""
    x = img.to(torch.float32)
    if scaling in ("yolo", "coco", "raw255"):
        return x / 255.0
    if scaling == "inception":
        return x / 127.5 - 1.0
    if scaling == "vgg":
        return x - values_on((123.0, 117.0, 104.0), torch.float32, x.device)
    if scaling == "none":
        return x
    raise ValueError(f"unknown scaling mode: {scaling}")


def resize_bilinear(frames: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) float -> (B, out_h, out_w, C), bilinear.

    ``jax.image.resize(..., "bilinear")`` uses half-pixel centres and
    widens its triangle kernel when it downscales (antialiasing);
    ``antialias=True, align_corners=False`` is the same filter. The two
    differ in float rounding and, where the kernel leaves the image, in
    how the edge weights are renormalised. A bfloat16 input is resized in
    float32 and rounded back (PyTorch's CPU filter takes no bfloat16).
    """
    x = frames.permute(0, 3, 1, 2)
    x = F.interpolate(x.float() if x.dtype == torch.bfloat16 else x, size=tuple(out_hw),
                      mode="bilinear", align_corners=False, antialias=True)
    return x.to(frames.dtype).permute(0, 2, 3, 1)
