"""Multi-sweep point-cloud aggregation, nuScenes' 10-sweep semantics (the
port's copy of ``ops/sweeps.py``, numpy only).

The reference's CenterPoint path is the 10-sweep config
(``data/nusc_centerpoint_pp_02voxel_two_pfn_10sweep.py``; its client
zero-pads a time column onto single sweeps, the 1-sweep case of this
module). det3d stacks the keyframe with up to 9 earlier sweeps, each
moved into the keyframe's sensor frame, and appends a per-point time lag
Δt = t_key - t_sweep, from which the network reads motion (the velocity
head's input).

Aggregation is host-side stream prep: its (N, 5) cloud is padded by
``pipelines/detect3d.prepare_points`` and feeds the pipeline, whose VFE
takes ``VoxelConfig.point_features = 5`` columns.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import numpy as np


def aggregate_sweeps(
    sweeps: Sequence[np.ndarray],
    times: Sequence[float] | None = None,
    transforms: Sequence[np.ndarray] | None = None,
) -> np.ndarray:
    """Stack sweeps (keyframe FIRST) into one (N, 5) cloud
    [x, y, z, intensity, Δt].

    Args:
      sweeps: per-sweep (M_i, >=3) arrays, newest (keyframe) first; a
        missing intensity column is zero-filled.
      times: per-sweep timestamps (seconds). Δt_i = times[0] - times[i]
        (keyframe lag 0; older sweeps positive). None -> all zeros (the
        reference's single-sweep zero-pad).
      transforms: optional per-sweep (4, 4) homogeneous transforms
        mapping sweep i's sensor frame into the KEYFRAME's frame (ego
        motion compensation; identity for the keyframe). None -> static
        platform assumed.
    """
    if not sweeps:
        raise ValueError("aggregate_sweeps needs at least one sweep")
    if times is not None and len(times) != len(sweeps):
        raise ValueError(f"{len(times)} times for {len(sweeps)} sweeps")
    if transforms is not None and len(transforms) != len(sweeps):
        raise ValueError(f"{len(transforms)} transforms for {len(sweeps)} sweeps")

    parts = []
    t0 = times[0] if times is not None else 0.0
    for i, sweep in enumerate(sweeps):
        pts = np.asarray(sweep, np.float32)
        if pts.ndim != 2 or pts.shape[1] < 3:
            raise ValueError(f"sweep {i}: expected (M, >=3), got {pts.shape}")
        xyz = pts[:, :3]
        if transforms is not None:
            tf = np.asarray(transforms[i], np.float32)
            xyz = xyz @ tf[:3, :3].T + tf[:3, 3]
        inten = (
            pts[:, 3:4]
            if pts.shape[1] >= 4
            else np.zeros((len(pts), 1), np.float32)
        )
        dt = np.full(
            (len(pts), 1),
            (t0 - times[i]) if times is not None else 0.0,
            np.float32,
        )
        parts.append(np.concatenate([xyz, inten, dt], axis=1))
    return np.concatenate(parts, axis=0)


def pose_to_matrix(
    translation: Sequence[float], quaternion: Sequence[float]
) -> np.ndarray:
    """(x, y, z) + (qx, qy, qz, qw) -> (4, 4) homogeneous world_T_sensor
    (the ROS nav_msgs/Odometry pose convention)."""
    x, y, z, w = (float(v) for v in quaternion)
    n = np.sqrt(x * x + y * y + z * z + w * w)
    if n < 1e-12:
        raise ValueError("zero-norm quaternion")
    x, y, z, w = x / n, y / n, z / n, w / n
    tf = np.eye(4, dtype=np.float64)
    tf[:3, :3] = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    tf[:3, 3] = translation
    return tf


def _rigid_inverse(tf: np.ndarray) -> np.ndarray:
    out = np.eye(4, dtype=np.float64)
    r = tf[:3, :3].T
    out[:3, :3] = r
    out[:3, 3] = -r @ tf[:3, 3]
    return out


def relative_transforms(poses: Sequence[np.ndarray]) -> list[np.ndarray]:
    """Per-sweep world_T_sensor poses (keyframe FIRST) -> transforms
    mapping each sweep's sensor frame into the KEYFRAME's frame:
    T_i = inv(pose_key) @ pose_i (identity for the keyframe) — the
    det3d ego-motion compensation the reference applies from dataset
    sweep records (clients/preprocess/voxelize.py:13-24)."""
    inv_key = _rigid_inverse(np.asarray(poses[0], np.float64))
    return [inv_key @ np.asarray(p, np.float64) for p in poses]


class SweepBuffer:
    """Rolling window of the last ``nsweeps`` scans for a live/replay
    stream: push the newest scan (+ timestamp and, on a moving
    platform, its world_T_sensor pose), get the aggregated (N, 5)
    cloud with the newest scan as keyframe.

    With poses, older sweeps are transformed into the keyframe's
    sensor frame before stacking (ego-motion compensation — without it
    a moving vehicle smears static structure across sweeps and
    corrupts the velocity head's input). Without poses the platform is
    assumed static — exact for a stationary sensor and an explicit,
    documented approximation otherwise. Mixing posed and poseless
    pushes in one window is refused loudly."""

    def __init__(self, nsweeps: int = 10):
        if nsweeps < 1:
            raise ValueError(f"nsweeps must be >= 1, got {nsweeps}")
        self.nsweeps = nsweeps
        self._window: collections.deque = collections.deque(maxlen=nsweeps)

    def push(
        self,
        points: np.ndarray,
        timestamp: float,
        pose: np.ndarray | None = None,
    ) -> np.ndarray:
        """Add the newest scan; returns the aggregated cloud (newest
        first, Δt relative to it)."""
        # validate BEFORE appending: a rejected push must not poison
        # the window for the following (correct) pushes
        window_posed = [q is not None for _, _, q in self._window]
        if window_posed and (pose is not None) != window_posed[0]:
            raise ValueError(
                "SweepBuffer window mixes posed and poseless scans; "
                "supply a pose for every push or none"
            )
        self._window.appendleft(
            (
                np.asarray(points, np.float32),
                float(timestamp),
                None if pose is None else np.asarray(pose, np.float64),
            )
        )
        sweeps = [p for p, _, _ in self._window]
        times = [t for _, t, _ in self._window]
        poses = [q for _, _, q in self._window]
        have = [q is not None for q in poses]
        transforms = relative_transforms(poses) if all(have) and poses else None
        return aggregate_sweeps(sweeps, times, transforms)

    def __len__(self) -> int:
        return len(self._window)


def sweep_source(source, nsweeps: int, pose_lookup=None):
    """Wrap a pull-driven FrameSource so each yielded frame's data is
    the aggregation of the last ``nsweeps`` scans (Δt from the frames'
    own timestamps). ``pose_lookup(frame) -> (4, 4) world_T_sensor or
    None`` supplies ego poses (``io/bag_io.pose_lookup_from_jsonl`` for a
    pose file, or any callback). Identity when nsweeps == 1 —
    single sweeps still gain their zero Δt column from the pipeline's
    column pad."""
    if nsweeps <= 1:
        yield from source
        return
    buf = SweepBuffer(nsweeps)
    for frame in source:
        pose = None
        if pose_lookup is not None:
            pose = pose_lookup(frame)
            if pose is None:
                # a total key mismatch would otherwise degrade to the
                # very uncompensated stacking --poses exists to fix
                raise ValueError(
                    f"pose source has no pose for frame_id "
                    f"{frame.frame_id} (t={frame.timestamp}); check the "
                    "pose file's frame_id keying / odometry coverage"
                )
        agg = buf.push(np.asarray(frame.data), frame.timestamp, pose)
        yield dataclasses.replace(frame, data=agg)
