"""Output sinks for the drivers (the port's copy of ``io/sinks.py``).

Sinks implement one ``write(frame, result)`` protocol. ``NullSink``
discards (benchmark mode); ``DetectionLogSink`` writes detections as
JSON lines, the machine-readable record; ``ImageFileSink`` draws boxes
with ``io/draw.py`` and writes numbered PNGs (cv2 where installed, else
PIL). The bag sink is ``io/bag_io.OutputBagSink``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping, Protocol

import numpy as np

from triton_client_tpu_torch.io.draw import draw_boxes
from triton_client_tpu_torch.io.sources import Frame


class Sink(Protocol):
    def write(self, frame: Frame, result: Mapping[str, Any]) -> None: ...

    def close(self) -> None: ...


class NullSink:
    """Discard results (benchmark mode)."""

    def write(self, frame: Frame, result: Mapping[str, Any]) -> None:
        pass

    def close(self) -> None:
        pass


class ImageFileSink:
    """Numbered annotated PNGs, ``{frame_id:04d}.png`` in ``out_dir``."""

    def __init__(self, out_dir: str = "./output_data", class_names: tuple[str, ...] = ()) -> None:
        self.out_dir = out_dir
        self.class_names = class_names
        os.makedirs(out_dir, exist_ok=True)

    def write(self, frame: Frame, result: Mapping[str, Any]) -> None:
        img = draw_boxes(frame.data, result["detections"], result.get("valid"), self.class_names)
        path = os.path.join(self.out_dir, f"{frame.frame_id:04d}.png")
        try:
            import cv2
        except ImportError:
            from PIL import Image

            Image.fromarray(img).save(path)
            return
        cv2.imwrite(path, img[..., ::-1])

    def close(self) -> None:
        pass


class DetectionLogSink:
    """Detections as JSON lines, one object a frame."""

    def __init__(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "w")

    def write(self, frame: Frame, result: Mapping[str, Any]) -> None:
        row: dict[str, Any] = {"frame_id": frame.frame_id, "ts": frame.timestamp}
        for key, val in result.items():
            if isinstance(val, np.ndarray):
                row[key] = val.tolist()
            elif isinstance(val, (int, float, str, list, bool)):
                row[key] = val
        self._f.write(json.dumps(row) + "\n")

    def close(self) -> None:
        self._f.close()
