"""Frame sources (the port's copy of the synthetic and ``.npy`` parts of
``io/sources.py``; image-directory, video and bag sources come later)."""

from __future__ import annotations

import dataclasses
import glob
import os
import time
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class Frame:
    """One unit of input: an RGB image (H, W, 3) uint8 or a point cloud
    (N, >=4) float32, plus identity and timing."""

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


class NpyPointCloudSource:
    """Sorted directory of ``.npy`` point clouds (the format the
    reference's tools/pc_extractor.py writes)."""

    def __init__(self, path: str, limit: int = 0) -> None:
        self.paths = sorted(glob.glob(os.path.join(path, "*.npy")))
        if limit:
            self.paths = self.paths[:limit]
        if not self.paths:
            raise FileNotFoundError(f"no .npy point clouds under {path}")

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[Frame]:
        for i, p in enumerate(self.paths):
            yield Frame(np.load(p).astype(np.float32), i, time.time())


class SyntheticPointCloudSource:
    """Random KITTI-like point clouds for benchmarks and tests: the same
    clouds as the JAX package's source for the same seed."""

    def __init__(self, n: int, points: int = 20000, seed: int = 0) -> None:
        self.n, self.points, self.seed = n, points, seed

    def __len__(self) -> int:
        return self.n

    def __iter__(self) -> Iterator[Frame]:
        rng = np.random.default_rng(self.seed)
        for i in range(self.n):
            pc = np.stack(
                [
                    rng.uniform(0, 70, self.points),  # x forward
                    rng.uniform(-40, 40, self.points),  # y left
                    rng.uniform(-3, 1, self.points),  # z up
                    rng.uniform(0, 1, self.points),  # intensity
                ],
                axis=1,
            ).astype(np.float32)
            yield Frame(pc, i, time.time())


def open_source(spec: str, limit: int = 0, kind: str = "image"):
    """CLI string -> source: ``synthetic[:N[:HxW]]`` images, or with
    ``kind="pointcloud"`` ``synthetic[:N]`` clouds or a directory of
    ``.npy`` clouds."""
    if not spec.startswith("synthetic"):
        if kind == "pointcloud":
            return NpyPointCloudSource(spec, limit)
        raise ValueError(f"only synthetic[:N[:HxW]] image sources are ported yet, got {spec!r}")
    parts = spec.split(":")
    n = int(parts[1]) if len(parts) > 1 else (limit or 100)
    n = min(n, limit) if limit else n
    if kind == "pointcloud":
        return SyntheticPointCloudSource(n)
    hw = (480, 640)
    if len(parts) > 2:
        h, w = parts[2].split("x")
        hw = (int(h), int(w))
    return SyntheticImageSource(n, hw)
