"""Bag-backed frame sources, the output-bag detection sink and the pose
sources for multi-sweep replay (the port's copy of ``io/bag_io.py``).

These give the drivers the reference's bag replay mode without ROS:
``BagImageSource`` / ``BagPointCloudSource`` are its pull loops over a
bag, and ``OutputBagSink`` writes each input cloud through plus a jsk
BoundingBoxArray of the detections on the publish topic, into
``<bag>_output.bag``. ``bag_pose_lookup`` reads a bag's odometry topic
(``detect3d --poses odom``); ``pose_lookup_from_jsonl`` a pose file.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Iterator, Mapping

import numpy as np

from triton_client_tpu_torch.io import rosbag as rb
from triton_client_tpu_torch.io.sources import Frame
from triton_client_tpu_torch.ops.sweeps import pose_to_matrix

_IMAGE_TYPES = ("sensor_msgs/CompressedImage", "sensor_msgs/Image")


def _msg_time(msg, record_t: float) -> float:
    """header.stamp (capture time) when set, else the bag record time —
    sweeps and pose interpolation align on capture time so per-topic
    transport latency doesn't skew the compensation."""
    try:
        secs, nsecs = msg.header.stamp
    except (AttributeError, TypeError, ValueError):
        return record_t
    stamp = float(secs) + float(nsecs) * 1e-9
    return stamp if stamp > 0 else record_t


def _pick_topic(path: str, wanted_types: tuple[str, ...]) -> str:
    with rb.BagReader(path) as r:
        topics = r.topics()
    matches = [t for t, dt in topics.items() if dt in wanted_types]
    if not matches:
        raise ValueError(
            f"{path}: no topic of type {wanted_types} (found {topics})"
        )
    return sorted(matches)[0]


class _BagSourceBase:
    def __init__(self, path: str, topic: str | None, limit: int) -> None:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self.topic = topic
        self.limit = limit
        self._length: int | None = None

    def _count(self, topic: str) -> int:
        n = 0
        with rb.BagReader(self.path) as r:
            for _ in r.read_messages(topics=[topic], raw=True):
                n += 1
        return n

    def __len__(self) -> int:
        if self._length is None:
            n = self._count(self.topic)
            self._length = min(n, self.limit) if self.limit else n
        return self._length


class BagImageSource(_BagSourceBase):
    """Image/CompressedImage topic -> RGB frames.

    ``topic=None`` auto-selects the first image-typed connection (the
    reference hardwires the topic in the YAML param file instead,
    data/client_parameter.yaml)."""

    def __init__(self, path: str, topic: str | None = None, limit: int = 0):
        super().__init__(path, topic, limit)
        if self.topic is None:
            self.topic = _pick_topic(path, _IMAGE_TYPES)

    @property
    def hw(self) -> tuple[int, int]:
        """The first frame's (H, W)."""
        for frame in self:
            return frame.data.shape[:2]
        raise ValueError(f"{self.path}: no messages on {self.topic}")

    def __iter__(self) -> Iterator[Frame]:
        with rb.BagReader(self.path) as r:
            for i, (_, bm, t) in enumerate(
                r.read_messages(topics=[self.topic], raw=True)
            ):
                if self.limit and i >= self.limit:
                    return
                msg = bm.msg
                if bm.connection.datatype == "sensor_msgs/CompressedImage":
                    img = rb.compressed_image_to_numpy(msg)
                else:
                    img = rb.image_to_numpy(msg)
                seq = int(msg.header.seq) if msg.header.seq else i
                yield Frame(img, seq, t, self.path, meta=bm)


class BagPointCloudSource(_BagSourceBase):
    """PointCloud2 topic -> (N, 4) float32 x/y/z/intensity frames.

    Raw sensor values — the reference's intensity normalization and
    z offset (ros_inference3d.py:126-128) belong to the pipeline's
    preprocess, not the source."""

    def __init__(self, path: str, topic: str | None = None, limit: int = 0):
        super().__init__(path, topic, limit)
        if self.topic is None:
            self.topic = _pick_topic(path, ("sensor_msgs/PointCloud2",))

    def __iter__(self) -> Iterator[Frame]:
        with rb.BagReader(self.path) as r:
            for i, (_, bm, t) in enumerate(
                r.read_messages(topics=[self.topic], raw=True)
            ):
                if self.limit and i >= self.limit:
                    return
                msg = bm.msg
                pts = rb.pointcloud2_to_xyzi(msg)
                seq = int(msg.header.seq) if msg.header.seq else i
                # prefer the sensor's own header.stamp over the bag
                # record time: sweep Δt and ego-pose interpolation must
                # use capture time, not transport/record latency
                yield Frame(pts, seq, _msg_time(msg, t), self.path, meta=bm)


def default_output_bag(in_bag: str) -> str:
    """'<basename>_output.bag' in the cwd (bag_inference3d.py:63)."""
    return f"{os.path.basename(in_bag)}_output.bag"


class OutputBagSink:
    """3D detections -> output bag: input cloud passthrough + jsk
    BoundingBoxArray per frame (bag_inference3d.py:156-183)."""

    def __init__(
        self,
        path: str,
        pub_topic: str = "/tpu_detections/boxes3d",
        input_topic: str | None = None,
        frame_id: str = "lidar",
        compression: str = "none",
    ) -> None:
        self.pub_topic = pub_topic
        self.input_topic = input_topic
        self.frame_id = frame_id
        self._w = rb.BagWriter(path, compression=compression)

    def write(self, frame: Frame, result: Mapping[str, Any]) -> None:
        t = frame.timestamp or time.time()
        stamp, frame_id = t, self.frame_id
        if isinstance(frame.meta, rb.BagMessage):
            bm = frame.meta
            topic = self.input_topic or bm.connection.topic
            self._w.write(topic, bm, t=t)
            stamp = t
            frame_id = bm.msg.header.frame_id or self.frame_id
        elif frame.data is not None and frame.data.ndim == 2:
            topic = self.input_topic or "/points"
            self._w.write(
                topic,
                rb.xyzi_to_pointcloud2(
                    frame.data, frame_id=frame_id, stamp=t, seq=frame.frame_id
                ),
                t=t,
            )
        boxes, scores, labels = _unpack_boxes(result)
        arr = rb.boxes7_to_jsk_array(
            boxes, scores, labels, frame_id=frame_id, stamp=stamp,
            seq=frame.frame_id,
        )
        self._w.write(self.pub_topic, arr, t=t)

    def close(self) -> None:
        self._w.close()


def _unpack_boxes(result: Mapping[str, Any]):
    """Accept either the 3D client dict contract (pred_boxes/pred_scores/
    pred_labels, clients/detector_3d_client.py:29-34) or the packed
    (dets (M, 9), valid) form the fused pipeline emits."""
    if "pred_boxes" in result:
        return (
            np.asarray(result["pred_boxes"], np.float32).reshape(-1, 7),
            np.asarray(result["pred_scores"], np.float32).reshape(-1),
            np.asarray(result["pred_labels"]).reshape(-1).astype(np.int64),
        )
    dets = np.asarray(result["detections"], np.float32)
    if dets.ndim == 3:  # batch of 1
        dets = dets[0]
    if dets.shape[-1] < 9:
        raise ValueError(
            "OutputBagSink needs 3D detections (M, 9) [x,y,z,dx,dy,dz,yaw,"
            f"score,label]; got shape {dets.shape} — 2D pipelines should "
            "use the images/jsonl sinks"
        )
    if "valid" in result:
        valid = np.asarray(result["valid"]).reshape(-1).astype(bool)
        dets = dets[: valid.size][valid[: dets.shape[0]]]
    return dets[:, :7], dets[:, 7], dets[:, 8].astype(np.int64)


# ---------------------------------------------------------------------------
# Ego-pose sources for multi-sweep aggregation (ops/sweeps.py)
# ---------------------------------------------------------------------------

def bag_pose_lookup(path: str, topic: str | None = None):
    """Odometry topic of a bag -> pose_lookup callback for
    ``sweep_source``: frame -> (4, 4) world_T_sensor interpolated at
    the frame's timestamp (linear translation + normalized-lerp
    rotation between the bracketing odometry samples; clamped at the
    ends). The reference compensates ego motion from dataset pose
    records (clients/preprocess/voxelize.py:13-24); a live/replay
    stream's equivalent pose source is its odometry topic."""
    if topic is None:
        topic = _pick_topic(path, ("nav_msgs/Odometry",))
    stamps: list[float] = []
    trans: list[list[float]] = []
    quats: list[list[float]] = []
    with rb.BagReader(path) as r:
        for _, bm, t in r.read_messages(topics=[topic], raw=True):
            p = bm.msg.pose.pose
            stamps.append(_msg_time(bm.msg, t))
            trans.append([p.position.x, p.position.y, p.position.z])
            quats.append(
                [p.orientation.x, p.orientation.y, p.orientation.z,
                 p.orientation.w]
            )
    if not stamps:
        raise ValueError(f"{path}: no messages on odometry topic {topic!r}")
    order = np.argsort(stamps)
    t_arr = np.asarray(stamps, np.float64)[order]
    tr_arr = np.asarray(trans, np.float64)[order]
    q_arr = np.asarray(quats, np.float64)[order]

    def lookup(frame) -> np.ndarray:
        t = float(frame.timestamp)
        i = int(np.searchsorted(t_arr, t))
        if i <= 0:
            return pose_to_matrix(tr_arr[0], q_arr[0])
        if i >= len(t_arr):
            return pose_to_matrix(tr_arr[-1], q_arr[-1])
        w = (t - t_arr[i - 1]) / max(t_arr[i] - t_arr[i - 1], 1e-12)
        tr = (1 - w) * tr_arr[i - 1] + w * tr_arr[i]
        qa, qb = q_arr[i - 1], q_arr[i]
        if np.dot(qa, qb) < 0:  # shorter arc
            qb = -qb
        q = (1 - w) * qa + w * qb
        return pose_to_matrix(tr, q)

    return lookup


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
