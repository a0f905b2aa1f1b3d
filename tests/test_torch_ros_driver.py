"""The port's live ROS nodes (``drivers/ros.py``) against the JAX
package's, both driven through the fake rospy, cv_bridge and message
packages of ``tests/test_ros_driver.py``: the same messages in give the
same published messages out, the queues drop as JAX's drop, and without
ROS both refuse with the same message (the detect CLIs exit with it)."""

import sys

import numpy as np
import pytest
from test_ros_driver import _ns, ros_env  # noqa: F401 (the fake ROS fixture)

from triton_client_tpu_torch.drivers import ros as tros


def _infer2d(rgb):
    h, w = rgb.shape[:2]
    v = float(rgb.mean())
    dets = np.array([[2, 3, w - 4, h - 2, 0.9, 1], [1, 1, 5 + v % 7, 6, 0.4, 0]], np.float32)
    return {"detections": dets, "valid": np.array([True, v > 50])}


def _spin(rospy, node, n):
    rospy.published.clear()
    rospy.shutdown_after = n
    node.spin()
    return list(rospy.published)


def test_detect2d_node_publishes_what_jax_publishes(ros_env):  # noqa: F811
    rospy, jros = ros_env
    rng = np.random.default_rng(0)
    msgs = [_ns(array=rng.integers(0, 255, (24, 32, 3), dtype=np.uint8), header=f"h{i}")
            for i in range(3)]
    out = []
    for ros in (tros, jros):
        rospy.subscribers.clear()
        node = ros.RosDetect2D(_infer2d, "/cam", "/out", class_names=("crop", "weed"),
                               compressed=False, queue_size=4)
        (topic, msg_type, callback) = rospy.subscribers[0]
        assert topic == "/cam" and msg_type.__name__ == "Image"
        for m in msgs:
            callback(m)
        out.append(_spin(rospy, node, 3))
    assert [t for t, _ in out[0]] == [t for t, _ in out[1]] == ["/out"] * 3
    for (_, a), (_, b) in zip(*out):
        assert a.header == b.header
        np.testing.assert_array_equal(a.array, b.array)


def test_compressed_frames_decode_as_jax(ros_env):  # noqa: F811
    cv2 = pytest.importorskip("cv2")
    rospy, jros = ros_env
    img = np.random.default_rng(1).integers(0, 255, (16, 16, 3), dtype=np.uint8)
    ok, enc = cv2.imencode(".png", img)
    seen = []
    for ros in (tros, jros):
        rospy.subscribers.clear()
        node = ros.RosDetect2D(lambda rgb: seen.append(rgb.copy()) or _infer2d(rgb), "/c", "/o")
        rospy.subscribers[0][2](_ns(data=enc.tobytes(), header="h"))
        _spin(rospy, node, 1)
    np.testing.assert_array_equal(seen[0], seen[1])
    np.testing.assert_array_equal(seen[0], img[..., ::-1])


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_full_queues_drop_as_jax_drops(ros_env, kind):  # noqa: F811
    """The camera node drops the oldest queued frame, the point-cloud node
    the newest, as JAX's nodes do."""
    rospy, jros = ros_env
    kept = []
    for ros in (tros, jros):
        rospy.subscribers.clear()
        if kind == "2d":
            node = ros.RosDetect2D(_infer2d, "/cam", "/out", compressed=False, queue_size=2)
        else:
            node = ros.RosDetect3D(lambda pts: {}, "/pc", "/boxes")
        callback = rospy.subscribers[0][2]
        for v in range(7):
            callback(_ns(array=np.full((2, 2, 3), v, np.uint8), points=[], header=v))
        vals = []
        while not node._q.empty():
            vals.append(node._q.get_nowait().header)
        kept.append(vals)
    assert kept[0] == kept[1] == ([5, 6] if kind == "2d" else [0, 1, 2, 3])


def _infer3d(pts):
    n = len(pts)
    boxes = np.stack([pts[:, 0], pts[:, 1], pts[:, 2], np.full(n, 4.0), np.full(n, 1.7),
                      np.full(n, 1.5), np.linspace(-3, 3, n)], 1).astype(np.float32)
    return {"pred_boxes": boxes, "pred_scores": np.linspace(0.1, 0.95, n).astype(np.float32),
            "pred_labels": (np.arange(n) % 3).astype(np.int32)}


def _detections(arr):
    return [(d.header, d.bbox.center.position.x, d.bbox.center.position.y,
             d.bbox.center.position.z, d.bbox.center.orientation.z, d.bbox.center.orientation.w,
             d.bbox.size.x, d.bbox.size.y, d.bbox.size.z,
             [(h.id, h.score) for h in d.results]) for d in arr.detections]


def test_detect3d_node_publishes_what_jax_publishes(ros_env):  # noqa: F811
    rospy, jros = ros_env
    rng = np.random.default_rng(2)
    clouds = [[tuple(map(float, p)) for p in rng.normal(0, 5, (n, 4))] for n in (6, 9)]
    out = []
    for ros in (tros, jros):
        rospy.subscribers.clear()
        node = ros.RosDetect3D(_infer3d, "/pc", "/boxes", score_thresh=0.5)
        for i, pts in enumerate(clouds):
            rospy.subscribers[0][2](_ns(points=pts, header=f"h{i}"))
        out.append(_spin(rospy, node, 2))
    for (ta, a), (tb, b) in zip(*out):
        assert ta == tb == "/boxes" and a.header == b.header
        assert _detections(a) == _detections(b) and len(_detections(a)) > 0
    got = tros._to_detection3d_array(_infer3d(np.ones((4, 4), np.float32)), "h", 0.0)
    want = jros._to_detection3d_array(_infer3d(np.ones((4, 4), np.float32)), "h", 0.0)
    assert _detections(got) == _detections(want)


def test_without_ros_both_refuse_with_jaxs_message(monkeypatch):
    from triton_client_tpu.drivers import ros as jros

    from triton_client_tpu_torch.cli import detect2d, detect3d

    monkeypatch.setitem(sys.modules, "rospy", None)
    assert not tros.available()
    errors = []
    for make in (lambda: tros.RosDetect2D(_infer2d, "/c", "/o"),
                 lambda: tros.RosDetect3D(_infer3d, "/p", "/b"), jros._require_ros):
        with pytest.raises(ImportError) as e:
            make()
        errors.append(str(e.value))
    assert errors[0] == errors[1] == errors[2] and "rospy is not installed" in errors[0]
    for cli in (detect2d, detect3d):
        with pytest.raises(SystemExit) as e:
            cli.main(["-i", "ros:/topic", "--device", "cpu"])
        assert str(e.value) == errors[0]
