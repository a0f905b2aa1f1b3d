"""Pose sources for multi-sweep replay (the port's copy of the pose-file
part of ``io/bag_io.py``). The bag reader and a bag's odometry topic
(``--poses odom``) wait for ROADMAP.md Queue 1 item 6."""

from __future__ import annotations

import json

import numpy as np

from triton_client_tpu_torch.ops.sweeps import pose_to_matrix


def pose_lookup_from_jsonl(path: str):
    """Pose JSONL ({"frame_id": int, "pose": [x, y, z, qx, qy, qz,
    qw]}) -> pose_lookup callback keyed by frame_id — the file-based
    pose source for .npy replay streams."""
    table: dict[int, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            v = row["pose"]
            if len(v) != 7:
                raise ValueError(
                    f"{path}: pose must be [x, y, z, qx, qy, qz, qw], "
                    f"got {len(v)} values"
                )
            table[int(row["frame_id"])] = pose_to_matrix(v[:3], v[3:])

    def lookup(frame):
        return table.get(frame.frame_id)

    return lookup
