"""Fused-kernel routing (port of ``ops/fused.py``): the one place that
decides whether a pipeline stage runs its fused kernel or the unfused
op chain.

  * ``TPU_FUSED_KERNELS`` env, with the JAX package's values: ``0``/
    ``off`` disables every fusion; ``1``/``on``/``auto`` enables
    routing; a comma list enables only the named stages.
  * per-pipeline mode (``Detect2DConfig.fused``): ``auto`` fuses when
    the pipeline's device is CUDA (the hand-written kernel); ``on``
    fuses everywhere, which on the CPU means the kernel's plain version;
    ``off`` is the unfused tail.

The resolved list is published as ``spec.extra["fused_stages"]``.
"""

from __future__ import annotations

import os

import torch

FUSED_STAGES = ("voxelize_scatter", "decode_nms")

_OFF = ("0", "off", "false", "none", "")
_ON = ("1", "on", "true", "all", "auto")


def _env_stages() -> tuple[str, ...] | None:
    """Stage allowlist from ``TPU_FUSED_KERNELS``; ``None`` = all off.
    Unknown names in a comma list are ignored, as in the JAX package."""
    raw = os.environ.get("TPU_FUSED_KERNELS", "auto").strip().lower()
    if raw in _OFF:
        return None
    if raw in _ON:
        return FUSED_STAGES
    names = tuple(s.strip() for s in raw.split(",") if s.strip())
    return tuple(s for s in names if s in FUSED_STAGES) or None


def fused_stage_enabled(stage: str, mode: str, device: torch.device) -> bool:
    """Resolve one stage against the env knob, the pipeline ``mode``
    and the pipeline's device."""
    if stage not in FUSED_STAGES:
        raise ValueError(f"unknown fused stage {stage!r} (of {FUSED_STAGES})")
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"fused mode must be auto|on|off, got {mode!r}")
    if mode == "off":
        return False
    allowed = _env_stages()
    if allowed is None or stage not in allowed:
        return False
    return mode == "on" or torch.device(device).type == "cuda"


def resolve_fused_stages(
    mode: str, candidates: tuple[str, ...], device: torch.device
) -> tuple[str, ...]:
    """Which of a pipeline's candidate stages route fused."""
    return tuple(s for s in candidates if fused_stage_enabled(s, mode, device))
