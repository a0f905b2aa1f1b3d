"""Frame sources: the pull-driven input seam of the drivers (the port's
copy of ``io/sources.py``).

One iterator protocol, so the same driver runs a directory of images, a
video file, a bag (``io/bag_io.py``), recorded .npy point clouds or a
synthetic generator without knowing which. Images decode with cv2 where
it is installed (the reference's decoder) and PIL otherwise; both are
imported inside the functions that read.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time
from typing import Iterator, Protocol

import numpy as np

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


@dataclasses.dataclass
class Frame:
    """One unit of input: an RGB image (H, W, 3) uint8 or a point cloud
    (N, >=4) float32, plus identity and timing for eval and the sinks."""

    data: np.ndarray
    frame_id: int
    timestamp: float
    path: str = ""
    # source-specific context: a bag source's raw BagMessage, so the bag
    # sink can copy the input message through unchanged
    meta: object = None


class FrameSource(Protocol):
    def __iter__(self) -> Iterator[Frame]: ...

    def __len__(self) -> int: ...


class ImageDirSource:
    """Sorted directory of images -> RGB frames."""

    def __init__(self, path: str, limit: int = 0) -> None:
        self.paths = sorted(
            p
            for p in glob.glob(os.path.join(path, "*"))
            if os.path.splitext(p)[1].lower() in IMAGE_EXTENSIONS
        )
        if limit:
            self.paths = self.paths[:limit]
        if not self.paths:
            raise FileNotFoundError(f"no images under {path}")

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def hw(self) -> tuple[int, int]:
        """The first image's (H, W)."""
        return _read_image_rgb(self.paths[0]).shape[:2]

    def __iter__(self) -> Iterator[Frame]:
        for i, p in enumerate(self.paths):
            yield Frame(_read_image_rgb(p), i, time.time(), p)


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


class VideoSource:
    """Video file -> RGB frames (cv2 only)."""

    def __init__(self, path: str, limit: int = 0) -> None:
        cv2 = _cv2()
        if cv2 is None:
            raise ImportError("VideoSource requires cv2")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self.limit = limit
        cap = cv2.VideoCapture(path)
        self._length = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) or 0
        self.hw = (int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)), int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)))
        cap.release()
        if limit:
            self._length = min(self._length, limit)

    def __len__(self) -> int:
        return self._length

    def __iter__(self) -> Iterator[Frame]:
        cap = _cv2().VideoCapture(self.path)
        i = 0
        try:
            while True:
                if self.limit and i >= self.limit:
                    break
                ok, bgr = cap.read()
                if not ok:
                    break
                yield Frame(bgr[..., ::-1].copy(), i, time.time(), self.path)
                i += 1
        finally:
            cap.release()


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


def _stamp(i: int, period: float | None) -> float:
    """Frame ``i``'s timestamp: ``i * period`` s on a replay clock, or
    with no period the wall clock when the frame is read (the JAX
    package's stamp, which makes multi-sweep Δt differ run to run)."""
    return i * period if period else time.time()


class NpyPointCloudSource:
    """Sorted directory of ``.npy`` point clouds (the format the
    reference's tools/pc_extractor.py writes). ``period``: stamp frame i
    at ``i * period`` s (``detect3d --scan-period``), so the Δt of
    multi-sweep aggregation is the same in every run."""

    def __init__(self, path: str, limit: int = 0, period: float | None = None) -> None:
        self.period = period
        self.paths = sorted(glob.glob(os.path.join(path, "*.npy")))
        if limit:
            self.paths = self.paths[:limit]
        if not self.paths:
            raise FileNotFoundError(f"no .npy point clouds under {path}")

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[Frame]:
        for i, p in enumerate(self.paths):
            yield Frame(np.load(p).astype(np.float32), i, _stamp(i, self.period), p)


class SyntheticPointCloudSource:
    """Random KITTI-like point clouds for benchmarks and tests: the same
    clouds as the JAX package's source for the same seed."""

    def __init__(self, n: int, points: int = 20000, seed: int = 0,
                 period: float | None = None) -> None:
        self.n, self.points, self.seed, self.period = n, points, seed, period

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
            yield Frame(pc, i, _stamp(i, self.period))


def open_source(spec: str, limit: int = 0, kind: str = "image",
                period: float | None = None) -> FrameSource:
    """CLI string -> source: ``synthetic[:N[:HxW]]``, a ``.bag``, an image
    directory or a video file (2D); ``synthetic[:N]``, a ``.bag`` or a
    directory of ``.npy`` clouds (3D, ``kind="pointcloud"``). ``period``
    stamps synthetic and ``.npy`` clouds every ``period`` s; a bag's
    frames carry their header stamps."""
    if spec.startswith("synthetic"):
        parts = spec.split(":")
        n = int(parts[1]) if len(parts) > 1 else (limit or 100)
        n = min(n, limit) if limit else n
        if kind == "pointcloud":
            return SyntheticPointCloudSource(n, period=period)
        hw = (480, 640)
        if len(parts) > 2:
            h, w = parts[2].split("x")
            hw = (int(h), int(w))
        return SyntheticImageSource(n, hw)
    if spec.endswith(".bag"):
        from triton_client_tpu_torch.io.bag_io import BagImageSource, BagPointCloudSource

        if kind == "pointcloud":
            return BagPointCloudSource(spec, limit=limit)
        return BagImageSource(spec, limit=limit)
    if kind == "pointcloud":
        return NpyPointCloudSource(spec, limit, period)
    if os.path.isdir(spec):
        return ImageDirSource(spec, limit)
    return VideoSource(spec, limit)


def _read_image_rgb(path: str) -> np.ndarray:
    cv2 = _cv2()
    if cv2 is not None:
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is None:
            raise IOError(f"cannot decode {path}")
        return bgr[..., ::-1].copy()
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))
