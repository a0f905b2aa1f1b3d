"""Synthetic labeled datasets: the accuracy oracle (the port's copy of
``io/synthdata.py``).

No trained checkpoint is in the repo, so accuracy is proven in a closed
loop: generate labeled scenes with known ground truth, run the whole
detect pipeline (decode and NMS included) and score it through
``eval/detection_map.py``. The same generators give the replay stream
its frames (a bag written from a seed).

Two generators, matching the reference's two domains:

* 2D (`write_detection_dataset`): crop-field-like images (textured
  ground, shape-classed objects: ellipse / rotated box / triangle for
  the crop/weed-style classes of data/crop.names, line and speckle
  distractors) with tight [x1, y1, x2, y2, cls] ground truth in the
  gt-JSONL schema `cli/common.load_gt_lookup` reads. Drawing needs cv2,
  imported inside the functions that draw.
* 3D (`write_scene_dataset`): KITTI-like lidar scenes (ground clutter
  and surface-sampled, yaw-rotated objects with 1/r^2 return density)
  as .npy clouds plus [cx, cy, cz, dx, dy, dz, yaw, cls] ground truth;
  numpy only.

Determinism: everything derives from the seed, and the same seed gives
the JAX package's generators' frames bit for bit.
"""

from __future__ import annotations

import json
import os

import numpy as np

# KITTI anchor geometry (data/pointpillar.yaml anchor_sizes), reused by
# the 3D scene generator so synthetic objects match the anchor priors.
KITTI_CLASS_GEOMETRY = {
    # name: ((dx, dy, dz), bottom_z)
    "Car": ((3.9, 1.6, 1.56), -1.78),
    "Pedestrian": ((0.8, 0.6, 1.73), -0.6),
    "Cyclist": ((1.76, 0.6, 1.73), -0.6),
}


# --------------------------------------------------------------------------
# 2D: shape-classed field scenes
# --------------------------------------------------------------------------

def _background(rng: np.random.Generator, hw: tuple[int, int]) -> np.ndarray:
    """Low-frequency field texture + speckle, uint8 RGB."""
    h, w = hw
    # coarse noise upsampled -> smooth patches (soil/foliage blobs)
    coarse = rng.uniform(0.0, 1.0, (max(h // 32, 2), max(w // 32, 2), 3))
    idx_y = np.linspace(0, coarse.shape[0] - 1, h)
    idx_x = np.linspace(0, coarse.shape[1] - 1, w)
    smooth = coarse[idx_y.astype(int)][:, idx_x.astype(int)]
    base = np.array([90.0, 70.0, 50.0]) + smooth * np.array([60.0, 50.0, 30.0])
    img = base + rng.normal(0, 12.0, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


_SHAPE_COLORS = (
    (60, 180, 60),   # vivid green
    (200, 60, 60),   # red
    (60, 80, 210),   # blue
    (220, 200, 40),  # yellow
    (180, 60, 200),  # magenta
)


def _draw_object(img, rng, cls: int, box: tuple[int, int, int, int]) -> None:
    """Draw one class-`cls` shape tightly inside `box` (x1, y1, x2, y2)."""
    import cv2

    x1, y1, x2, y2 = box
    color = tuple(
        int(np.clip(c + rng.normal(0, 20), 0, 255))
        for c in _SHAPE_COLORS[rng.integers(0, len(_SHAPE_COLORS))]
    )
    cx, cy = (x1 + x2) // 2, (y1 + y2) // 2
    if cls == 0:  # ellipse
        cv2.ellipse(
            img, (cx, cy), ((x2 - x1) // 2, (y2 - y1) // 2), 0, 0, 360,
            color, -1, cv2.LINE_AA,
        )
    elif cls == 1:  # filled box with an inner notch (distinct from ellipse)
        cv2.rectangle(img, (x1, y1), (x2, y2), color, -1)
        nw, nh = max((x2 - x1) // 4, 1), max((y2 - y1) // 4, 1)
        dark = tuple(int(c * 0.35) for c in color)
        cv2.rectangle(img, (cx - nw // 2, cy - nh // 2),
                      (cx + nw // 2, cy + nh // 2), dark, -1)
    else:  # triangle touching the box edges
        pts = np.array(
            [[cx, y1], [x1, y2], [x2, y2]], np.int32
        )
        cv2.fillPoly(img, [pts], color, cv2.LINE_AA)


def _iou_xyxy(a: np.ndarray, b: np.ndarray) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def synth_detection_frame(
    rng: np.random.Generator,
    hw: tuple[int, int] = (512, 512),
    num_classes: int = 2,
    max_objects: int = 6,
    distractors: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """One labeled frame: (img uint8 (H, W, 3), boxes (n, 5)
    [x1, y1, x2, y2, cls] float32). Objects are shape-classed, sized
    8-30% of the short side, rejection-sampled to pairwise IoU < 0.2."""
    import cv2

    h, w = hw
    img = _background(rng, hw)
    if distractors:
        for _ in range(int(rng.integers(4, 10))):
            p1 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            p2 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            shade = int(rng.integers(30, 90))
            cv2.line(img, p1, p2, (shade, shade, shade), 1, cv2.LINE_AA)
        for _ in range(int(rng.integers(8, 20))):
            c = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            shade = tuple(int(v) for v in rng.integers(40, 140, 3))
            cv2.circle(img, c, int(rng.integers(1, 3)), shade, -1)

    short = min(h, w)
    boxes: list[np.ndarray] = []
    n_obj = int(rng.integers(1, max_objects + 1))
    for _ in range(n_obj):
        for _attempt in range(20):
            bw = int(rng.uniform(0.08, 0.30) * short)
            bh = int(bw * rng.uniform(0.7, 1.4))
            x1 = int(rng.uniform(2, w - bw - 2))
            y1 = int(rng.uniform(2, h - bh - 2))
            cand = np.array([x1, y1, x1 + bw, y1 + bh], np.float32)
            if all(_iou_xyxy(cand, b[:4]) < 0.2 for b in boxes):
                cls = int(rng.integers(0, num_classes))
                _draw_object(img, rng, cls, (x1, y1, x1 + bw, y1 + bh))
                boxes.append(np.append(cand, np.float32(cls)))
                break
    return img, np.stack(boxes).astype(np.float32)


def write_detection_dataset(
    out_dir: str,
    n_images: int,
    hw: tuple[int, int] = (512, 512),
    num_classes: int = 2,
    seed: int = 0,
    max_objects: int = 6,
) -> tuple[str, str]:
    """Write `<out_dir>/images/%06d.png` + `<out_dir>/gt.jsonl`
    (frame_id = sorted-filename index, the ImageDirSource contract).
    Returns (images_dir, gt_path)."""
    import cv2

    rng = np.random.default_rng(seed)
    images_dir = os.path.join(out_dir, "images")
    os.makedirs(images_dir, exist_ok=True)
    gt_path = os.path.join(out_dir, "gt.jsonl")
    with open(gt_path, "w") as f:
        for i in range(n_images):
            img, boxes = synth_detection_frame(
                rng, hw, num_classes, max_objects
            )
            cv2.imwrite(
                os.path.join(images_dir, f"{i:06d}.png"), img[..., ::-1]
            )
            f.write(
                json.dumps(
                    {"frame_id": i, "boxes": [list(map(float, b)) for b in boxes]}
                )
                + "\n"
            )
    return images_dir, gt_path


# --------------------------------------------------------------------------
# 3D: KITTI-like lidar scenes with yaw-rotated ground truth
# --------------------------------------------------------------------------

def synth_scene_frame(
    rng: np.random.Generator,
    pc_range: tuple = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0),
    n_objects: int = 8,
    n_clutter: int = 16_000,
    class_names: tuple[str, ...] = ("Car", "Pedestrian", "Cyclist"),
    yaw: bool = True,
    yaw_mode: str = "uniform",
    min_points: int = 20,
    n_sweeps: int = 0,
    sweep_dt: float = 0.05,
    velocity_max: float = 0.0,
    front_bias: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """One labeled scan: (points (N, 4) [x, y, z, intensity] float32,
    boxes (n, 8) [cx, cy, cz, dx, dy, dz, yaw, cls] float32).

    Ground plane clutter + surface-sampled objects whose return density
    falls ~1/r^2 with range (perf/profile_second_grid.py's scene model,
    plus per-object yaw so the rotated-IoU eval path is exercised);
    objects closer than `min_points` returns are rejected so every GT
    box is actually observable.

    ``yaw_mode``: 'uniform' draws headings uniformly (the hard,
    rotation-agnostic case); 'road' draws 80% near an axis (N(axis,
    0.15), axis in {0, pi/2, pi, -pi/2}) + 20% uniform — KITTI-like
    traffic, the distribution the reference's axis-aligned anchor
    config (data/pointpillar.yaml:118-142 rotations [0, 1.57]) is
    designed for.

    ``n_sweeps > 0`` switches to the nuScenes multi-sweep contract the
    served CenterPoint consumes (reference clients/preprocess/
    voxelize.py:13-24 feeds 10-sweep clouds): points gain a Δt channel
    (-> (N, 5)), each object gets a ground-plane velocity drawn from
    [-velocity_max, velocity_max]² whose MOTION IS IN THE DATA — sweep
    k's returns sample the object displaced to c - v·k·dt — and boxes
    gain [vx, vy] (-> (n, 10)). Velocity is thereby observable from a
    single stacked cloud (the motion streak), which is exactly what the
    CenterPoint velocity head trains on.

    ``front_bias > 0`` skews each object's surface returns toward its
    +x (heading) half: a fraction ``front_bias`` of returns land on the
    front half, the rest on the rear. A perfect cuboid with symmetric
    sampling is EXACTLY π-rotation-invariant, which makes full-circle
    yaw unlearnable on principle — component-wise L1 over the
    {(sinθ, cosθ), (−sinθ, −cosθ)} mixture medians to (0, 0), the
    failure CenterPoint's det3d (sin, cos) regression hits on such
    data (anchor heads dodge it via the mod-π sin-difference loss).
    Real lidar returns are front/back asymmetric (bumpers, windshield
    rake, mirrors), which is the asymmetry this models."""
    x0, y0, _z0, x1, y1, _z1 = pc_range
    sweeps = max(1, n_sweeps)
    cols = 5 if n_sweeps > 0 else 4
    ground = np.stack(
        [
            rng.uniform(x0, x1, n_clutter),
            rng.uniform(y0, y1, n_clutter),
            rng.normal(-1.9, 0.05, n_clutter),
            rng.uniform(0, 1, n_clutter),
        ],
        axis=1,
    ).astype(np.float32)
    if cols == 5:
        # static clutter appears in every sweep at the same place;
        # spread its Δt uniformly over the sweep window
        ts = rng.integers(0, sweeps, n_clutter) * sweep_dt
        ground = np.concatenate(
            [ground, ts[:, None].astype(np.float32)], axis=1
        )
    parts = [ground]
    boxes: list[list[float]] = []
    for _ in range(n_objects):
        for _attempt in range(20):
            cls = int(rng.integers(0, len(class_names)))
            (dx, dy, dz), bz = KITTI_CLASS_GEOMETRY[class_names[cls]]
            cx = float(rng.uniform(x0 + 5, min(x1 - 3, 60)))
            cy = float(rng.uniform(y0 + 5, y1 - 5))
            cz = bz + dz / 2
            if not yaw:
                ry = 0.0
            elif yaw_mode == "road" and rng.uniform() < 0.8:
                axis = rng.choice([0.0, np.pi / 2, np.pi, -np.pi / 2])
                ry = float(axis + rng.normal(0.0, 0.15))
            else:
                ry = float(rng.uniform(-np.pi, np.pi))
            vx = vy = 0.0
            if velocity_max > 0:
                vx = float(rng.uniform(-velocity_max, velocity_max))
                vy = float(rng.uniform(-velocity_max, velocity_max))
            r = float(np.hypot(cx, cy))
            n_pts = int(60_000 / max(r, 5) ** 2)
            if n_pts < min_points:
                continue
            # keep objects separated (no overlapping GT): centre
            # distance vs the larger footprint diagonal
            too_close = any(
                np.hypot(cx - b[0], cy - b[1])
                < 0.7 * (np.hypot(dx, dy) + np.hypot(b[3], b[4]))
                for b in boxes
            )
            if too_close:
                continue
            obj_parts = []
            for k in range(sweeps):
                nk = max(n_pts // sweeps, 4)
                face = rng.integers(0, 3, nk)
                u = rng.uniform(-0.5, 0.5, (nk, 3))
                if front_bias > 0:
                    to_front = rng.uniform(size=nk) < front_bias
                    u[:, 0] = np.where(
                        to_front, np.abs(u[:, 0]), -np.abs(u[:, 0])
                    )
                u[face == 0, 0] = np.sign(u[face == 0, 0]) * 0.5
                u[face == 1, 1] = np.sign(u[face == 1, 1]) * 0.5
                u[face == 2, 2] = 0.5  # top surface
                lx, ly, lz = u[:, 0] * dx, u[:, 1] * dy, u[:, 2] * dz
                c, s = np.cos(ry), np.sin(ry)
                # sweep k observed the object k·dt in the past: its
                # center was displaced by -v·k·dt (the motion streak
                # the velocity head reads)
                t = k * sweep_dt
                sweep_cols = [
                    cx - vx * t + lx * c - ly * s,
                    cy - vy * t + lx * s + ly * c,
                    cz + lz,
                    rng.uniform(0, 1, nk),
                ]
                if cols == 5:
                    sweep_cols.append(np.full(nk, t))
                obj_parts.append(
                    np.stack(sweep_cols, axis=1).astype(np.float32)
                )
            parts.extend(obj_parts)
            row = [cx, cy, cz, dx, dy, dz, ry, float(cls)]
            if cols == 5:
                row += [vx, vy]
            boxes.append(row)
            break
    points = np.concatenate(parts)
    return points, np.asarray(boxes, np.float32).reshape(-1, 10 if cols == 5 else 8)


def write_scene_dataset(
    out_dir: str,
    n_scenes: int,
    seed: int = 0,
    **scene_kwargs,
) -> tuple[str, str]:
    """Write `<out_dir>/clouds/%06d.npy` + `<out_dir>/gt3d.jsonl`
    ({"frame_id", "boxes": [[cx, cy, cz, dx, dy, dz, yaw, cls]]}).
    Returns (clouds_dir, gt_path)."""
    rng = np.random.default_rng(seed)
    clouds_dir = os.path.join(out_dir, "clouds")
    os.makedirs(clouds_dir, exist_ok=True)
    gt_path = os.path.join(out_dir, "gt3d.jsonl")
    with open(gt_path, "w") as f:
        for i in range(n_scenes):
            points, boxes = synth_scene_frame(rng, **scene_kwargs)
            np.save(os.path.join(clouds_dir, f"{i:06d}.npy"), points)
            f.write(
                json.dumps(
                    {"frame_id": i, "boxes": [list(map(float, b)) for b in boxes]}
                )
                + "\n"
            )
    return clouds_dir, gt_path


def load_gt3d_lookup(path: str):
    """gt3d JSONL -> frame lookup of (n, 8|10) [cx, cy, cz, dx, dy, dz,
    yaw, cls(, vx, vy)] arrays (the 3D sibling of
    cli/common.load_gt_lookup); 10-column rows carry the multi-sweep
    velocity labels."""
    table: dict[int, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            arr = np.asarray(row["boxes"], np.float64)
            arr = arr.reshape(len(row["boxes"]), -1) if len(row["boxes"]) else arr.reshape(0, 8)
            if arr.shape[1] not in (8, 10):
                raise ValueError(
                    f"gt3d rows must have 8 or 10 columns, got {arr.shape[1]}"
                )
            table[int(row["frame_id"])] = arr

    def lookup(frame):
        return table.get(frame.frame_id)

    return lookup


# --------------------------------------------------------------------------
# Replay bags (the port's addition): the same frames in a ROS1 bag
# --------------------------------------------------------------------------

# 1/8 s: a dyadic scan period whose stamps (i + 1) / 8 the bag's
# (secs, nsecs) header stamps hold exactly, so ``.npy`` replay of the same
# clouds with ``--scan-period 0.125`` sees the same sweep time lags
REPLAY_PERIOD = 0.125
IMAGE_TOPIC, CLOUD_TOPIC = "/camera/image_raw", "/points"
# the replay platform: 8 m/s on an arc turning 0.05 rad/s
EGO_SPEED, EGO_YAW_RATE = 8.0, 0.05


def write_detection_bag(
    path: str,
    n_frames: int,
    hw: tuple[int, int] = (512, 512),
    num_classes: int = 2,
    seed: int = 0,
    max_objects: int = 6,
) -> str:
    """``write_detection_dataset``'s frames (same seed, same frames) as raw
    rgb8 ``sensor_msgs/Image`` messages on ``IMAGE_TOPIC``, frame i stamped
    ``(i + 1) * REPLAY_PERIOD`` s with seq i, and the GT JSONL beside it
    (``<path>.gt.jsonl``, keyed by seq). Returns the GT path."""
    from triton_client_tpu_torch.io import rosbag as rb

    rng = np.random.default_rng(seed)
    gt_path = path + ".gt.jsonl"
    with rb.BagWriter(path) as w, open(gt_path, "w") as f:
        for i in range(n_frames):
            img, boxes = synth_detection_frame(rng, hw, num_classes, max_objects)
            t = (i + 1) * REPLAY_PERIOD
            w.write(IMAGE_TOPIC, rb.numpy_to_image(img, stamp=t, seq=i), t=t)
            f.write(json.dumps({"frame_id": i, "boxes": [list(map(float, b)) for b in boxes]})
                    + "\n")
    return gt_path


def ego_pose(i: int) -> list[float]:
    """Frame i's world pose [x, y, z, qx, qy, qz, qw] on the replay
    platform's arc (yaw about z)."""
    t = i * REPLAY_PERIOD
    yaw = EGO_YAW_RATE * t
    return [EGO_SPEED * t * float(np.cos(yaw / 2)), EGO_SPEED * t * float(np.sin(yaw / 2)), 0.0,
            0.0, 0.0, float(np.sin(yaw / 2)), float(np.cos(yaw / 2))]


def write_scene_bag(
    path: str,
    n_scenes: int,
    seed: int = 0,
    odom_topic: str | None = None,
    compression: str = "none",
    **scene_kwargs,
) -> tuple[str, str | None]:
    """``write_scene_dataset``'s scenes (same seed, same clouds) as
    ``sensor_msgs/PointCloud2`` x/y/z/intensity messages on ``CLOUD_TOPIC``,
    scan i stamped ``(i + 1) * REPLAY_PERIOD`` s with seq i, the GT JSONL
    beside it (``<path>.gt3d.jsonl``). With ``odom_topic``, a
    ``nav_msgs/Odometry`` message a scan at the same stamp carries
    :func:`ego_pose`, and ``<path>.poses.jsonl`` holds the same poses by
    frame id (the pose file of ``.npy`` replay). Returns (GT path, poses
    path or None)."""
    from triton_client_tpu_torch.io import rosbag as rb

    rng = np.random.default_rng(seed)
    gt_path = path + ".gt3d.jsonl"
    poses_path = path + ".poses.jsonl" if odom_topic else None
    poses = open(poses_path, "w") if poses_path else None
    try:
        with rb.BagWriter(path, compression=compression) as w, open(gt_path, "w") as f:
            for i in range(n_scenes):
                points, boxes = synth_scene_frame(rng, **scene_kwargs)
                t = (i + 1) * REPLAY_PERIOD
                w.write(CLOUD_TOPIC, rb.xyzi_to_pointcloud2(points[:, :4], stamp=t, seq=i), t=t)
                f.write(json.dumps({"frame_id": i,
                                    "boxes": [list(map(float, b)) for b in boxes]}) + "\n")
                if poses is None:
                    continue
                pose = ego_pose(i)
                msg = rb.make("nav_msgs/Odometry")
                msg.header.seq = i
                msg.header.stamp = rb._split_time(t)
                msg.header.frame_id = "odom"
                p = msg.pose.pose
                p.position.x, p.position.y, p.position.z = pose[:3]
                (p.orientation.x, p.orientation.y, p.orientation.z,
                 p.orientation.w) = pose[3:]
                w.write(odom_topic, msg, t=t)
                poses.write(json.dumps({"frame_id": i, "pose": pose}) + "\n")
    finally:
        if poses is not None:
            poses.close()
    return gt_path, poses_path
