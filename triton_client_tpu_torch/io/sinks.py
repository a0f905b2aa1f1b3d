"""Output sinks for the drivers (the port's copy of ``io/sinks.py``).

Sinks implement one ``write(frame, result)`` protocol. ``NullSink``
discards (benchmark mode); ``DetectionLogSink`` writes detections as
JSON lines, the machine-readable record. ``ImageFileSink`` draws boxes
with ``io/draw.py``, which is not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping, Protocol

import numpy as np

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
    """Numbered annotated PNGs: needs ``io/draw.py``."""

    def __init__(self, out_dir: str = "./output_data", class_names: tuple[str, ...] = ()) -> None:
        raise NotImplementedError(
            "ImageFileSink draws with io/draw.py, which is not ported yet "
            "(ROADMAP.md Queue 1, 'Evaluation and replay'); use --sink jsonl"
        )


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
