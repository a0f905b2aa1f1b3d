"""The explicit-device rule of the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: with no
device given they take ``cuda``, and where there is no CUDA device they
raise instead of falling back. The CPU path (the kernels' plain
versions) runs only for ``device="cpu"``, which is what the tests pass.
"""

from __future__ import annotations

import logging

import torch

log = logging.getLogger(__name__)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> cuda. Raises RuntimeError for cuda without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain CPU versions of the kernels"
        )
    return dev


def strict_fp32() -> None:
    """Turn TF32 off for convolutions and matrix products.

    cuDNN runs fp32 convolutions in TF32 by default, which keeps about
    three decimal digits; a model served at fp32 means fp32. This is a
    process-wide PyTorch setting.
    """
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        log.info("fp32 path: turning TF32 off for cuDNN and matmul")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def values_on(values, dtype: torch.dtype, device) -> torch.Tensor:
    """Config constants as a (len(values),) tensor on ``device``, each
    rounded to ``dtype`` as ``torch.tensor`` rounds it.

    On the card each value is one fill: ``torch.tensor(values,
    device="cuda")`` copies from pageable host memory, which makes the
    host wait for the card and cannot be captured into a CUDA graph
    (``runtime/graphs``)."""
    values = tuple(values)
    device = torch.device(device)
    if device.type != "cuda":
        return torch.tensor(values, dtype=dtype, device=device)
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


def scalar_on(value, dtype: torch.dtype, device) -> torch.Tensor:
    """A () tensor of ``value`` rounded to ``dtype``, made on ``device``
    without a host copy (see :func:`values_on`)."""
    return torch.full((), value, dtype=dtype, device=device)
