"""Frame sources (the port's copy of the synthetic part of
``io/sources.py``; directory, video and bag sources come later)."""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class Frame:
    """One RGB image (H, W, 3) uint8 plus identity and timing."""

    data: np.ndarray
    frame_id: int
    timestamp: float


class SyntheticImageSource:
    """Deterministic random frames, the benchmark input (no-IO mode):
    the same frames as the JAX package's source for the same seed."""

    def __init__(self, n: int, hw: tuple[int, int] = (480, 640), seed: int = 0):
        self.n, self.hw, self.seed = n, hw, seed

    def __len__(self) -> int:
        return self.n

    def __iter__(self) -> Iterator[Frame]:
        rng = np.random.default_rng(self.seed)
        for i in range(self.n):
            img = rng.integers(0, 255, (*self.hw, 3), dtype=np.uint8)
            yield Frame(img, i, time.time())


def open_source(spec: str, limit: int = 0) -> SyntheticImageSource:
    """CLI string -> source: ``synthetic[:N[:HxW]]`` only, for now."""
    if not spec.startswith("synthetic"):
        raise ValueError(f"only synthetic[:N[:HxW]] sources are ported yet, got {spec!r}")
    parts = spec.split(":")
    n = int(parts[1]) if len(parts) > 1 else (limit or 100)
    hw = (480, 640)
    if len(parts) > 2:
        h, w = parts[2].split("x")
        hw = (int(h), int(w))
    return SyntheticImageSource(min(n, limit) if limit else n, hw)
