"""Host-side box drawing (the port's copy of ``io/draw.py``).

The reference draws with cv2.rectangle/putText, with a per-class color
hash. Same behavior here, as a pure function over the packed
(max_det, 6) detection rows; without cv2 (imported when drawing) it
strokes the rectangles with numpy and writes no labels.
"""

from __future__ import annotations

import numpy as np

def class_color(cls_id: int) -> tuple[int, int, int]:
    """Deterministic per-class RGB (the reference hashes class id into
    HSV offsets, yolov5_postprocess.py:131-141)."""
    rng = np.random.default_rng(cls_id + 12345)
    r, g, b = rng.integers(64, 256, 3)
    return int(r), int(g), int(b)


def draw_boxes(
    image: np.ndarray,
    detections: np.ndarray,
    valid: np.ndarray | None = None,
    class_names: tuple[str, ...] = (),
    thickness: int = 2,
) -> np.ndarray:
    """Return a copy of ``image`` (H, W, 3 uint8 RGB) with detection
    rows [x1, y1, x2, y2, conf, cls] drawn."""
    out = np.ascontiguousarray(image).copy()
    detections = np.asarray(detections).reshape(-1, 6)
    if valid is not None:
        detections = detections[np.asarray(valid, dtype=bool).reshape(-1)]
    try:
        import cv2
    except ImportError:
        cv2 = None
    h, w = out.shape[:2]
    for x1, y1, x2, y2, conf, cls in detections:
        c = int(cls)
        color = class_color(c)
        x1, y1 = max(0, int(x1)), max(0, int(y1))
        x2, y2 = min(w - 1, int(x2)), min(h - 1, int(y2))
        if x2 <= x1 or y2 <= y1:
            continue
        label = class_names[c] if c < len(class_names) else str(c)
        text = f"{label} {conf:.2f}"
        if cv2 is not None:
            cv2.rectangle(out, (x1, y1), (x2, y2), color, thickness)
            cv2.putText(
                out,
                text,
                (x1, max(0, y1 - 4)),
                cv2.FONT_HERSHEY_SIMPLEX,
                0.5,
                color,
                1,
                cv2.LINE_AA,
            )
        else:
            t = thickness
            out[y1 : y1 + t, x1:x2] = color
            out[max(0, y2 - t) : y2, x1:x2] = color
            out[y1:y2, x1 : x1 + t] = color
            out[y1:y2, max(0, x2 - t) : x2] = color
    return out
