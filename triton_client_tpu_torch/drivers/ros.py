"""Live ROS adapter (the port's copy of ``drivers/ros.py``); rospy,
cv_bridge and the message packages are imported when a node is built.

Parity with the reference's live drivers: subscribe a camera topic
(CompressedImage/Image) or a PointCloud2 topic with queue_size 50, run
the in-process pipeline (or a remote one through ``-u grpc:``) and
publish annotated images / 3D box arrays back.

The callback only enqueues; ``spin`` drains the queue, so a slow model
degrades to a lower frame rate instead of unbounded lag. The camera node
drops the oldest queued frame when its queue is full; the point-cloud
node drops the newest, as the JAX package's nodes do.
"""

from __future__ import annotations

import queue
from typing import Any, Callable, Mapping

import numpy as np


def _ros():
    """(rospy, sensor_msgs.msg), or None where ROS is not installed."""
    try:
        import rospy
        from sensor_msgs import msg
    except ImportError:
        return None
    return rospy, msg


def available() -> bool:
    return _ros() is not None


def _require_ros():
    ros = _ros()
    if ros is None:
        raise ImportError(
            "rospy is not installed — live ROS mode needs a ROS noetic "
            "environment (see the reference docker/amd64 image); use the "
            "file/video/synthetic sources otherwise"
        )
    return ros


class RosDetect2D:
    """Camera topic -> pipeline -> annotated Image topic."""

    def __init__(
        self,
        infer: Callable[[np.ndarray], Mapping[str, Any]],
        sub_topic: str,
        pub_topic: str,
        class_names: tuple[str, ...] = (),
        compressed: bool = True,
        queue_size: int = 4,
    ) -> None:
        rospy, msgs = _require_ros()
        import cv2
        from cv_bridge import CvBridge

        self._rospy = rospy
        self._cv2 = cv2
        self._bridge = CvBridge()
        self.infer = infer
        self.class_names = class_names
        self._q: queue.Queue = queue.Queue(maxsize=queue_size)
        msg_type = msgs.CompressedImage if compressed else msgs.Image
        self._sub = rospy.Subscriber(sub_topic, msg_type, self._callback, queue_size=1)
        self._pub = rospy.Publisher(pub_topic, msgs.Image, queue_size=1)
        self._compressed = compressed

    def _callback(self, msg) -> None:
        # enqueue-only callback; drop the oldest frame when full
        try:
            self._q.put_nowait(msg)
        except queue.Full:
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._q.put_nowait(msg)

    def spin(self) -> None:
        from triton_client_tpu_torch.io.draw import draw_boxes

        while not self._rospy.is_shutdown():
            try:
                msg = self._q.get(timeout=0.5)
            except queue.Empty:
                continue
            if self._compressed:
                arr = np.frombuffer(msg.data, np.uint8)
                bgr = self._cv2.imdecode(arr, self._cv2.IMREAD_COLOR)
                rgb = bgr[..., ::-1]
            else:
                rgb = self._bridge.imgmsg_to_cv2(msg, "rgb8")
            result = self.infer(np.ascontiguousarray(rgb))
            annotated = draw_boxes(
                rgb, result["detections"], result.get("valid"), self.class_names
            )
            out = self._bridge.cv2_to_imgmsg(annotated[..., ::-1], "bgr8")
            out.header = msg.header
            self._pub.publish(out)


class RosDetect3D:
    """PointCloud2 topic -> 3D pipeline -> Detection3DArray topic."""

    def __init__(
        self,
        infer: Callable[[np.ndarray], Mapping[str, Any]],
        sub_topic: str,
        pub_topic: str,
        queue_size: int = 50,
        score_thresh: float = 0.5,
    ) -> None:
        rospy, msgs = _require_ros()
        from sensor_msgs import point_cloud2  # noqa: F401

        self._rospy = rospy
        self.infer = infer
        self.score_thresh = score_thresh
        self._q: queue.Queue = queue.Queue(maxsize=4)
        self._sub = rospy.Subscriber(
            sub_topic, msgs.PointCloud2, self._callback, queue_size=queue_size
        )
        try:
            from vision_msgs.msg import Detection3DArray

            self._pub = rospy.Publisher(pub_topic, Detection3DArray, queue_size=1)
        except ImportError:
            self._pub = None
            rospy.logwarn("vision_msgs absent; 3D detections will not be published")

    def _callback(self, msg) -> None:
        try:
            self._q.put_nowait(msg)
        except queue.Full:
            pass  # drop newest under backpressure, keep latency bounded

    def spin(self) -> None:
        from sensor_msgs import point_cloud2

        while not self._rospy.is_shutdown():
            try:
                msg = self._q.get(timeout=0.5)
            except queue.Empty:
                continue
            pts = np.asarray(
                list(
                    point_cloud2.read_points(
                        msg, field_names=("x", "y", "z", "intensity")
                    )
                ),
                np.float32,
            )
            result = self.infer(pts)
            if self._pub is not None:
                self._pub.publish(
                    _to_detection3d_array(result, msg.header, self.score_thresh)
                )


def _to_detection3d_array(result, header, score_thresh):
    """pred arrays -> vision_msgs Detection3DArray with yaw->quaternion
    (parity: communicator/ros_inference3d.py:117-118,158-205)."""
    from geometry_msgs.msg import Point, Quaternion
    from vision_msgs.msg import Detection3D, Detection3DArray, ObjectHypothesisWithPose

    arr = Detection3DArray()
    arr.header = header
    boxes = np.asarray(result["pred_boxes"])
    scores = np.asarray(result["pred_scores"])
    labels = np.asarray(result["pred_labels"])
    for box, score, label in zip(boxes, scores, labels):
        if score < score_thresh:
            continue
        det = Detection3D()
        det.header = header
        x, y, z, dx, dy, dz, yaw = box[:7]
        det.bbox.center.position = Point(x=float(x), y=float(y), z=float(z))
        det.bbox.center.orientation = Quaternion(
            x=0.0, y=0.0, z=float(np.sin(yaw / 2)), w=float(np.cos(yaw / 2))
        )
        det.bbox.size.x, det.bbox.size.y, det.bbox.size.z = (
            float(dx),
            float(dy),
            float(dz),
        )
        hyp = ObjectHypothesisWithPose()
        hyp.id = int(label)
        hyp.score = float(score)
        det.results.append(hyp)
        arr.detections.append(det)
    return arr
