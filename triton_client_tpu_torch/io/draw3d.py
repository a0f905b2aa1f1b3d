"""3D scene visualization: point clouds and oriented boxes, numpy only
(the port's copy of ``io/draw3d.py``).

Capability parity with the reference's Open3D / Mayavi scene renderers:
convert (N, 7) [x, y, z, dx, dy, dz, heading] boxes to 8 corners, and
render the scene to plain numpy RGB images (a rotated-rectangle BEV
raster and a pinhole-projected 3D wireframe view) instead of an
interactive GL window, so visualization works on a host with no GL
stack. Corner ordering matches the reference template, so downstream
consumers interchange.

All functions are host-side numpy: they run on results already read back
from the device, never inside a captured graph.
"""

from __future__ import annotations

import numpy as np

# Same palette role as the reference's box_colormap (visualize_mayavi.py:5-10),
# indexed by label id; RGB 0-255.
BOX_COLORMAP = np.array(
    [
        [255, 255, 255],
        [0, 255, 0],
        [0, 255, 255],
        [255, 255, 0],
        [255, 128, 0],
        [255, 0, 255],
        [64, 128, 255],
        [255, 64, 64],
        [128, 255, 128],
        [200, 200, 100],
    ],
    dtype=np.uint8,
)

# Unit-cube corner template, OpenPCDet ordering (visualize_mayavi.py:49-63):
# corners 0-3 are the bottom face (z = -dz/2), 4-7 the top, with corner k+4
# vertically above corner k.
_CORNER_TEMPLATE = (
    np.array(
        [
            [1, 1, -1],
            [1, -1, -1],
            [-1, -1, -1],
            [-1, 1, -1],
            [1, 1, 1],
            [1, -1, 1],
            [-1, -1, 1],
            [-1, 1, 1],
        ],
        dtype=np.float32,
    )
    / 2.0
)

# Wireframe edges over that ordering: bottom ring, top ring, verticals,
# plus the two heading-face diagonals the reference draws to mark +x
# (visualize_open3d.py:90-96 adds lines [0,5] and [4,1]).
_EDGES = np.array(
    [
        [0, 1], [1, 2], [2, 3], [3, 0],
        [4, 5], [5, 6], [6, 7], [7, 4],
        [0, 4], [1, 5], [2, 6], [3, 7],
        [0, 5], [4, 1],
    ],
    dtype=np.int32,
)


def corners_3d(boxes7: np.ndarray) -> np.ndarray:
    """(N, 7) [x, y, z, dx, dy, dz, yaw] -> (N, 8, 3) world-frame corners.

    Yaw rotates about +z, x toward y (visualize_mayavi.py:19-41).
    """
    boxes7 = np.asarray(boxes7, dtype=np.float32).reshape(-1, 7)
    n = boxes7.shape[0]
    corners = boxes7[:, None, 3:6] * _CORNER_TEMPLATE[None, :, :]  # (N,8,3)
    c, s = np.cos(boxes7[:, 6]), np.sin(boxes7[:, 6])
    zeros, ones = np.zeros(n, np.float32), np.ones(n, np.float32)
    rot = np.stack(
        [c, s, zeros, -s, c, zeros, zeros, zeros, ones], axis=1
    ).reshape(n, 3, 3)
    corners = corners @ rot
    return corners + boxes7[:, None, 0:3]


def _draw_line(img: np.ndarray, p0, p1, color) -> None:
    """Integer Bresenham-ish line via dense interpolation (host viz only)."""
    h, w = img.shape[:2]
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    t = np.linspace(0.0, 1.0, n)
    xs = np.round(x0 + (x1 - x0) * t).astype(np.int64)
    ys = np.round(y0 + (y1 - y0) * t).astype(np.int64)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


class BEVCanvas:
    """Rasterizes a metric top-down view into an RGB image.

    World x is forward (image up), world y is left (image left) — the
    usual LiDAR BEV convention for KITTI-range scenes
    (data/kitti_dataset.yaml POINT_CLOUD_RANGE semantics).
    """

    def __init__(
        self,
        xlim: tuple[float, float] = (0.0, 70.4),
        ylim: tuple[float, float] = (-40.0, 40.0),
        px_per_m: float = 10.0,
        background: int = 0,
    ) -> None:
        self.xlim, self.ylim, self.px_per_m = xlim, ylim, px_per_m
        self.width = int(round((ylim[1] - ylim[0]) * px_per_m))
        self.height = int(round((xlim[1] - xlim[0]) * px_per_m))
        self.img = np.full((self.height, self.width, 3), background, np.uint8)

    def world_to_px(self, xy: np.ndarray) -> np.ndarray:
        """(..., 2) world x,y -> (..., 2) pixel col,row."""
        xy = np.asarray(xy, dtype=np.float32)
        col = (self.ylim[1] - xy[..., 1]) * self.px_per_m
        row = (self.xlim[1] - xy[..., 0]) * self.px_per_m
        return np.stack([col, row], axis=-1)

    def add_points(self, points: np.ndarray, intensity: np.ndarray | None = None):
        """Splat (N, >=2) world points; brightness from intensity if given
        (parity with show_intensity, visualize_mayavi.py:79-83)."""
        points = np.asarray(points)
        px = self.world_to_px(points[:, :2])
        cols = np.round(px[:, 0]).astype(np.int64)
        rows = np.round(px[:, 1]).astype(np.int64)
        keep = (cols >= 0) & (cols < self.width) & (rows >= 0) & (rows < self.height)
        cols, rows = cols[keep], rows[keep]
        if intensity is None:
            shade = np.full(cols.shape, 180, np.uint8)
        else:
            inten = np.clip(np.asarray(intensity, np.float32)[keep], 0.0, 1.0)
            shade = (80 + 175 * inten).astype(np.uint8)
        self.img[rows, cols] = shade[:, None]
        return self

    def add_boxes(
        self,
        boxes7: np.ndarray,
        labels: np.ndarray | None = None,
        scores: np.ndarray | None = None,
        color: tuple[int, int, int] | None = None,
    ):
        """Draw rotated rectangles with a heading tick from center to the
        front-face midpoint (so yaw is visually checkable, like the
        reference's oriented LineSets, visualize_open3d.py:76-103)."""
        boxes7 = np.asarray(boxes7, dtype=np.float32).reshape(-1, 7)
        corners = corners_3d(boxes7)[:, :4, :2]  # bottom ring in world xy
        for i, quad in enumerate(corners):
            if color is not None:
                col = color
            elif labels is not None:
                col = BOX_COLORMAP[int(labels[i]) % len(BOX_COLORMAP)]
            else:
                col = (0, 255, 0)
            px = self.world_to_px(quad)
            for a, b in ((0, 1), (1, 2), (2, 3), (3, 0)):
                _draw_line(self.img, px[a], px[b], col)
            # heading tick: center -> midpoint of the +x face (corners 0,1)
            center = self.world_to_px(boxes7[i, :2])
            front = self.world_to_px(quad[:2].mean(axis=0))
            _draw_line(self.img, center, front, col)
            if scores is not None:
                # brightness-coded score dot at the box center
                r, c = int(round(center[1])), int(round(center[0]))
                if 0 <= r < self.height and 0 <= c < self.width:
                    shade = int(55 + 200 * float(np.clip(scores[i], 0, 1)))
                    self.img[r, c] = (shade, shade, shade)
        return self


def draw_scene_bev(
    points: np.ndarray | None,
    boxes7: np.ndarray | None = None,
    labels: np.ndarray | None = None,
    scores: np.ndarray | None = None,
    gt_boxes7: np.ndarray | None = None,
    xlim: tuple[float, float] = (0.0, 70.4),
    ylim: tuple[float, float] = (-40.0, 40.0),
    px_per_m: float = 10.0,
) -> np.ndarray:
    """One-call scene render, the draw_scenes equivalent
    (visualize_mayavi.py:142-171: points + ref boxes(green) + gt(blue)).

    Returns an (H, W, 3) uint8 RGB image.
    """
    canvas = BEVCanvas(xlim=xlim, ylim=ylim, px_per_m=px_per_m)
    if points is not None and len(points):
        inten = points[:, 3] if points.shape[1] > 3 else None
        canvas.add_points(points, inten)
    if gt_boxes7 is not None and len(gt_boxes7):
        canvas.add_boxes(gt_boxes7, color=(64, 128, 255))
    if boxes7 is not None and len(boxes7):
        canvas.add_boxes(boxes7, labels=labels, scores=scores)
    return canvas.img


def project_pinhole(
    pts_world: np.ndarray,
    eye: np.ndarray,
    look_at: np.ndarray,
    up: np.ndarray = np.array([0.0, 0.0, 1.0]),
    focal_px: float = 500.0,
    size: tuple[int, int] = (600, 600),
) -> tuple[np.ndarray, np.ndarray]:
    """Project world points through a simple pinhole camera.

    Returns (pixels (N, 2) col,row, depth (N,)); points behind the camera
    get depth <= 0 and should be masked by the caller.
    """
    eye = np.asarray(eye, np.float32)
    fwd = np.asarray(look_at, np.float32) - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-9)
    right = np.cross(fwd, np.asarray(up, np.float32))
    right = right / (np.linalg.norm(right) + 1e-9)
    cam_up = np.cross(right, fwd)
    rel = np.asarray(pts_world, np.float32) - eye
    x = rel @ right
    y = rel @ cam_up
    z = rel @ fwd
    w, h = size
    zc = np.where(np.abs(z) < 1e-6, 1e-6, z)
    cols = w / 2.0 + focal_px * x / zc
    rows = h / 2.0 - focal_px * y / zc
    return np.stack([cols, rows], axis=-1), z


def draw_scene_3d(
    points: np.ndarray | None,
    boxes7: np.ndarray | None = None,
    labels: np.ndarray | None = None,
    eye: tuple[float, float, float] = (-25.0, -25.0, 20.0),
    look_at: tuple[float, float, float] = (20.0, 0.0, 0.0),
    size: tuple[int, int] = (600, 600),
) -> np.ndarray:
    """Perspective wireframe render — the headless stand-in for the
    reference's interactive GL viewers (same default 600x600 viewport as
    visualize_mayavi.py:77)."""
    w, h = size
    img = np.zeros((h, w, 3), np.uint8)
    if points is not None and len(points):
        px, depth = project_pinhole(points[:, :3], eye, look_at, size=size)
        order = np.argsort(-depth)  # painter's order: far first
        px, depth = px[order], depth[order]
        keep = depth > 0.1
        cols = np.round(px[keep, 0]).astype(np.int64)
        rows = np.round(px[keep, 1]).astype(np.int64)
        ok = (cols >= 0) & (cols < w) & (rows >= 0) & (rows < h)
        shade = np.clip(255.0 * 20.0 / depth[keep][ok], 40, 220).astype(np.uint8)
        img[rows[ok], cols[ok]] = shade[:, None]
    if boxes7 is not None and len(boxes7):
        corners = corners_3d(boxes7)
        for i, corn in enumerate(corners):
            color = (
                BOX_COLORMAP[int(labels[i]) % len(BOX_COLORMAP)]
                if labels is not None
                else (0, 255, 0)
            )
            px, depth = project_pinhole(corn, eye, look_at, size=size)
            if np.any(depth <= 0.1):
                continue
            for a, b in _EDGES:
                _draw_line(img, px[a], px[b], color)
    return img
