"""Interactive 3D scene viewer (Open3D), the port's copy of
``io/viz3d.py``.

The reference renders point clouds and oriented boxes in an Open3D
window. This module is that capability over the in-tree box geometry
(``io/draw3d.corners_3d``); open3d is a visualization extra, imported
only when a window opens. Headless rendering (BEV / pinhole PNGs) lives
in ``io/draw3d.py``.
"""

from __future__ import annotations

import numpy as np

from triton_client_tpu_torch.io.draw3d import corners_3d

# 12 box edges + the front-face cross the reference draws so heading
# is visible (visualize_open3d.py translate_boxes_to_open3d_instance)
_BOX_LINES = np.array(
    [
        [0, 1], [1, 2], [2, 3], [3, 0],  # bottom
        [4, 5], [5, 6], [6, 7], [7, 4],  # top
        [0, 4], [1, 5], [2, 6], [3, 7],  # verticals
        [0, 5], [1, 4],                  # front-face cross (heading)
    ],
    np.int64,
)

PRED_COLOR = (0.0, 1.0, 0.0)   # green, the reference's pred color
GT_COLOR = (0.0, 0.0, 1.0)     # blue, the reference's gt color


def _require_open3d():
    try:
        import open3d  # type: ignore

        return open3d
    except ImportError as e:
        raise ImportError(
            "interactive 3D display needs open3d (`pip install open3d`); "
            "headless rendering (io/draw3d.py BEV/pinhole PNGs) works "
            "without it"
        ) from e


def box_linesets(o3d, boxes7: np.ndarray, color) -> list:
    """(n, 7) boxes -> Open3D LineSets (12 edges + heading cross)."""
    out = []
    if len(boxes7) == 0:
        return out
    corners = corners_3d(np.asarray(boxes7, np.float64))  # (n, 8, 3)
    for c in corners:
        ls = o3d.geometry.LineSet()
        ls.points = o3d.utility.Vector3dVector(c)
        ls.lines = o3d.utility.Vector2iVector(_BOX_LINES)
        ls.colors = o3d.utility.Vector3dVector(
            np.tile(np.asarray(color, np.float64), (len(_BOX_LINES), 1))
        )
        out.append(ls)
    return out


def scene_geometries(
    points: np.ndarray,
    pred_boxes: np.ndarray | None = None,
    gt_boxes: np.ndarray | None = None,
):
    """Build the Open3D geometry list for one scene: gray cloud +
    origin frame + green predictions + blue ground truth."""
    o3d = _require_open3d()
    geoms = [
        o3d.geometry.TriangleMesh.create_coordinate_frame(size=1.0)
    ]
    pc = o3d.geometry.PointCloud()
    pc.points = o3d.utility.Vector3dVector(
        np.asarray(points, np.float64)[:, :3]
    )
    pc.paint_uniform_color((0.6, 0.6, 0.6))
    geoms.append(pc)
    if pred_boxes is not None:
        geoms.extend(box_linesets(o3d, pred_boxes, PRED_COLOR))
    if gt_boxes is not None:
        geoms.extend(box_linesets(o3d, gt_boxes, GT_COLOR))
    return geoms


def draw_detections_3d(
    points: np.ndarray,
    pred_boxes: np.ndarray | None = None,
    gt_boxes: np.ndarray | None = None,
    window_name: str = "tpu detections",
) -> None:
    """Blocking interactive render of one scene (the reference's
    draw_scenes call shape)."""
    o3d = _require_open3d()
    o3d.visualization.draw_geometries(
        scene_geometries(points, pred_boxes, gt_boxes),
        window_name=window_name,
    )


class ShowSink3D:
    """Driver sink that opens an interactive window per frame (close
    the window to advance the stream — the reference's per-scene
    blocking draw_scenes loop)."""

    def __init__(self, gt_lookup=None) -> None:
        _require_open3d()  # fail at construction, not mid-stream
        self._gt_lookup = gt_lookup

    def write(self, frame, result) -> None:
        gts = self._gt_lookup(frame) if self._gt_lookup is not None else None
        draw_detections_3d(
            np.asarray(frame.data),
            pred_boxes=np.asarray(result.get("pred_boxes", np.zeros((0, 7)))),
            gt_boxes=None if gts is None else np.asarray(gts)[:, :7],
            window_name=f"frame {frame.frame_id}",
        )

    def close(self) -> None:
        pass
