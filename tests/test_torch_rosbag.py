"""The port's ROS1 bag codec (``io/rosbag.py``) against the JAX package's.

The same messages, made from a seed with numpy, written by either
package's ``BagWriter`` give the same bytes (uncompressed and bz2, one
chunk and several); each package reads the other's bags to the same
messages; every registered type has the same md5 and full definition; the
PointCloud2 / Image / CompressedImage / Odometry / jsk conversions give
equal arrays and bytes; and an lz4 chunk is refused the same way.
"""

import numpy as np
import pytest

from triton_client_tpu.io import rosbag as jrb

from triton_client_tpu_torch.io import rosbag as trb


def _messages(rb, seed: int = 0):
    """[(topic, message, t)] of every type the replay path writes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(4):
        t = 1.0 + 0.125 * i
        pts = rng.normal(0, 10, (37 + 11 * i, 4)).astype(np.float32)
        out.append(("/points", rb.xyzi_to_pointcloud2(pts, frame_id="lidar", stamp=t, seq=i), t))
        img = rng.integers(0, 255, (6, 10, 3), dtype=np.uint8)
        out.append(("/camera", rb.numpy_to_image(img, stamp=t, seq=i), t))
        odom = rb.make("nav_msgs/Odometry")
        odom.header.seq, odom.header.stamp, odom.header.frame_id = i, (1, 125_000_000 * i), "odom"
        odom.pose.pose.position.x, odom.pose.pose.position.y = float(i) * 1.5, -0.25 * i
        odom.pose.pose.orientation.z = float(np.sin(0.1 * i))
        odom.pose.pose.orientation.w = float(np.cos(0.1 * i))
        out.append(("/odom", odom, t))
        boxes = rng.normal(0, 5, (3, 7))
        arr = rb.boxes7_to_jsk_array(boxes, rng.random(3), rng.integers(0, 3, 3), frame_id="lidar",
                                     stamp=t, seq=i)
        out.append(("/tpu_detections/boxes3d", arr, t))
    return out


def _write(rb, path, compression="none", chunk_threshold=768 * 1024, seed=0):
    with rb.BagWriter(str(path), compression=compression, chunk_threshold=chunk_threshold) as w:
        for topic, msg, t in _messages(rb, seed):
            w.write(topic, msg, t=t)
    return path.read_bytes()


@pytest.mark.parametrize("compression", ["none", "bz2"])
@pytest.mark.parametrize("chunk_threshold", [768 * 1024, 256])
def test_bag_bytes_equal_the_jax_writer(tmp_path, compression, chunk_threshold):
    ours = _write(trb, tmp_path / "t.bag", compression, chunk_threshold)
    theirs = _write(jrb, tmp_path / "j.bag", compression, chunk_threshold)
    assert ours == theirs


def _read_all(rb, path):
    with rb.BagReader(str(path)) as r:
        return [(topic, bm.connection.datatype, bytes(bm.raw), t)
                for topic, bm, t in r.read_messages(raw=True)]


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_each_package_reads_the_others_bags(tmp_path, compression):
    _write(trb, tmp_path / "t.bag", compression, 512)
    _write(jrb, tmp_path / "j.bag", compression, 512)
    from_ours = _read_all(jrb, tmp_path / "t.bag")
    from_theirs = _read_all(trb, tmp_path / "j.bag")
    assert from_ours == from_theirs == _read_all(trb, tmp_path / "t.bag")
    assert len(from_ours) == 16
    with trb.BagReader(str(tmp_path / "j.bag")) as r, jrb.BagReader(str(tmp_path / "t.bag")) as j:
        assert r.topics() == j.topics()
        got = [(topic, trb.pointcloud2_to_xyzi(msg)) for topic, msg, _ in
               r.read_messages(topics=["/points"])]
        want = [(topic, jrb.pointcloud2_to_xyzi(msg)) for topic, msg, _ in
                j.read_messages(topics=["/points"])]
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_md5s_and_definitions_equal_the_jax_registry():
    assert sorted(trb.REGISTRY) == sorted(jrb.REGISTRY)
    for name in jrb.REGISTRY:
        assert trb.compute_md5(name) == jrb.compute_md5(name), name
        assert trb.full_definition(name) == jrb.full_definition(name), name


def _cloud(rb, n, step, offsets, bigendian=False, intensity=True, seed=3):
    """A PointCloud2 of n points with ``step``-byte points and float32
    fields at ``offsets`` (x, y, z[, intensity])."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(0, 20, (n, 4)).astype(">f4" if bigendian else "<f4")
    buf = rng.integers(0, 255, (n, step), dtype=np.uint8)  # padding is noise
    names = ("x", "y", "z", "intensity") if intensity else ("x", "y", "z")
    for k, (name, off) in enumerate(zip(names, offsets)):
        buf[:, off:off + 4] = vals[:, k:k + 1].view(np.uint8).reshape(n, 4)
    fields = [rb.make("sensor_msgs/PointField", name=nm, offset=off, datatype=7, count=1)
              for nm, off in zip(names, offsets)]
    return rb.make("sensor_msgs/PointCloud2", header=rb.make("std_msgs/Header"), height=1,
                   width=n, fields=fields, is_bigendian=int(bigendian), point_step=step,
                   row_step=step * n, data=buf.reshape(-1), is_dense=1)


@pytest.mark.parametrize("step,offsets,bigendian,intensity", [
    (16, (0, 4, 8, 12), False, True),
    (32, (0, 4, 8, 16), False, True),  # PCL's padded layout
    (22, (0, 4, 8, 12), False, True),  # odd step (a uint16 ring after the floats)
    (20, (4, 8, 12), False, False),  # no intensity
    (16, (0, 4, 8, 12), True, True),  # big-endian
])
def test_pointcloud2_layouts_convert_as_jax(step, offsets, bigendian, intensity):
    for n in (1, 7):
        got = trb.pointcloud2_to_xyzi(_cloud(trb, n, step, offsets, bigendian, intensity))
        want = jrb.pointcloud2_to_xyzi(_cloud(jrb, n, step, offsets, bigendian, intensity))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_xyzi_round_trip_is_lossless_and_bytes_equal():
    pts = np.random.default_rng(5).normal(0, 1e3, (1000, 4)).astype(np.float32)
    pts[3] = [np.inf, -np.inf, 1e-42, -0.0]
    msg_t = trb.xyzi_to_pointcloud2(pts, stamp=2.5, seq=9)
    msg_j = jrb.xyzi_to_pointcloud2(pts, stamp=2.5, seq=9)
    raw = trb.serialize("sensor_msgs/PointCloud2", msg_t)
    assert raw == jrb.serialize("sensor_msgs/PointCloud2", msg_j)
    back = trb.pointcloud2_to_xyzi(trb.deserialize("sensor_msgs/PointCloud2", raw))
    assert back.tobytes() == pts.tobytes()


@pytest.mark.parametrize("encoding,channels", [
    ("rgb8", 3), ("bgr8", 3), ("mono8", 1), ("rgba8", 4), ("bgra8", 4)])
@pytest.mark.parametrize("pad", [0, 5])
def test_image_encodings_and_wide_steps_convert_as_jax(encoding, channels, pad):
    """Image.step wider than width x channels (row padding) and each
    encoding decode to the same RGB array in both packages."""
    rng = np.random.default_rng(channels + pad)
    h, w = 5, 7
    rows = rng.integers(0, 255, (h, w * channels + pad), dtype=np.uint8)

    def msg(rb):
        return rb.make("sensor_msgs/Image", header=rb.make("std_msgs/Header"), height=h,
                       width=w, encoding=encoding, is_bigendian=0, step=w * channels + pad,
                       data=rows.reshape(-1).copy())

    got, want = trb.image_to_numpy(msg(trb)), jrb.image_to_numpy(msg(jrb))
    assert got.dtype == want.dtype and got.shape == want.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)


def test_image_writers_equal_jax():
    img = np.random.default_rng(1).integers(0, 255, (9, 4, 3), dtype=np.uint8)
    for frame_id in ("camera", "cam_left"):
        a = trb.serialize("sensor_msgs/Image", trb.numpy_to_image(img, frame_id, 3.0, 2))
        b = jrb.serialize("sensor_msgs/Image", jrb.numpy_to_image(img, frame_id, 3.0, 2))
        assert a == b


def test_compressed_images_equal_jax():
    pytest.importorskip("cv2")
    img = np.random.default_rng(2).integers(0, 255, (16, 24, 3), dtype=np.uint8)
    for stamp in (1.0, 2.375):
        mt = trb.numpy_to_compressed_image(img, stamp=stamp, seq=1)
        mj = jrb.numpy_to_compressed_image(img, stamp=stamp, seq=1)
        assert (trb.serialize("sensor_msgs/CompressedImage", mt)
                == jrb.serialize("sensor_msgs/CompressedImage", mj))
        np.testing.assert_array_equal(trb.compressed_image_to_numpy(mt),
                                      jrb.compressed_image_to_numpy(mj))


def test_odometry_and_jsk_conversions_equal_jax():
    for yaw in (0.0, 0.3, -2.9, np.pi):
        q_t, q_j = trb.yaw_to_quaternion(yaw), jrb.yaw_to_quaternion(yaw)
        assert (q_t.x, q_t.y, q_t.z, q_t.w) == (q_j.x, q_j.y, q_j.z, q_j.w)
    for (_, mt, _), (_, mj, _) in zip(_messages(trb, 4), _messages(jrb, 4)):
        assert mt._type == mj._type
        assert trb.serialize(mt._type, mt) == jrb.serialize(mj._type, mj)
        back_t = trb.deserialize(mt._type, trb.serialize(mt._type, mt))
        back_j = jrb.deserialize(mj._type, jrb.serialize(mj._type, mj))
        assert trb.serialize(mt._type, back_t) == jrb.serialize(mj._type, back_j)


def test_lz4_chunks_are_refused_as_jax_refuses_them(tmp_path):
    """A bag whose chunks say lz4 (here: a bz2 bag relabelled) raises the
    same error in both readers where the lz4 module is absent."""
    try:
        import lz4.frame  # noqa: F401
        pytest.skip("lz4 is installed: the refusal path is not reachable here")
    except ImportError:
        pass
    raw = _write(trb, tmp_path / "b.bag", "bz2")
    assert raw.count(b"compression=bz2") > 0
    path = tmp_path / "lz4.bag"
    path.write_bytes(raw.replace(b"compression=bz2", b"compression=lz4"))
    errors = []
    for rb in (trb, jrb):
        with pytest.raises(NotImplementedError) as e:
            with rb.BagReader(str(path)) as r:
                list(r.read_messages(raw=True))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "lz4" in errors[0]
