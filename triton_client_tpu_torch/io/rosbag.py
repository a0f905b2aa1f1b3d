"""Dependency-free rosbag v2.0 reader/writer and ROS1 message codec (the
port's copy of ``io/rosbag.py``).

The reference replays recorded sensor data with the ``rosbag`` package
and writes detections into an output bag, all of which needs a full ROS
installation. A serving host has none, so this module implements the
open rosbag V2.0 container format and the ROS1 message serialization
rules directly:

- ``BagReader``: sequential chunk walk (none/bz2 compression; lz4 is
  imported only when a bag uses it), yielding ``(topic, message, t)``
  like ``rosbag.Bag.read_messages``.
- ``BagWriter``: writes indexed V2.0 bags (chunks + index data +
  connection + chunk-info records) that standard ROS tooling can read,
  byte for byte what the JAX package's writer writes for the same
  messages.
- A message-spec codec with the standard md5 computation, covering the
  message types the reference touches: sensor_msgs Image /
  CompressedImage / PointCloud2, nav_msgs Odometry, vision_msgs
  Detection2DArray and jsk_recognition_msgs BoundingBoxArray.

Host-side I/O only: numpy and the standard library. cv2 and PIL, for
compressed images, are imported inside the functions that use them.
"""

from __future__ import annotations

import bz2
import dataclasses
import hashlib
import struct
from types import SimpleNamespace
from typing import Any, Iterator

import numpy as np

# ---------------------------------------------------------------------------
# Message specs
# ---------------------------------------------------------------------------

_BUILTIN_FMT = {
    "bool": "B",
    "int8": "b",
    "uint8": "B",
    "byte": "b",
    "char": "B",
    "int16": "h",
    "uint16": "H",
    "int32": "i",
    "uint32": "I",
    "int64": "q",
    "uint64": "Q",
    "float32": "f",
    "float64": "d",
}
_BUILTIN_NP = {
    "bool": np.uint8,
    "int8": np.int8,
    "uint8": np.uint8,
    "byte": np.int8,
    "char": np.uint8,
    "int16": np.int16,
    "uint16": np.uint16,
    "int32": np.int32,
    "uint32": np.uint32,
    "int64": np.int64,
    "uint64": np.uint64,
    "float32": np.float32,
    "float64": np.float64,
}
_BUILTINS = set(_BUILTIN_FMT) | {"string", "time", "duration"}


@dataclasses.dataclass(frozen=True)
class Field:
    type: str  # resolved full type name (or builtin)
    name: str
    is_array: bool = False
    array_len: int | None = None  # None = variable length


@dataclasses.dataclass(frozen=True)
class Constant:
    type: str
    name: str
    value: str


class MsgSpec:
    def __init__(self, full_name: str, text: str) -> None:
        self.full_name = full_name
        self.package = full_name.split("/")[0]
        self.text = text.strip()
        self.fields: list[Field] = []
        self.constants: list[Constant] = []
        for raw in self.text.splitlines():
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            type_tok, rest = line.split(None, 1)
            if "=" in rest:
                cname, value = rest.split("=", 1)
                self.constants.append(
                    Constant(type_tok, cname.strip(), value.strip())
                )
                continue
            is_array, array_len = False, None
            if "[" in type_tok:
                base, dims = type_tok.split("[", 1)
                dims = dims.rstrip("]")
                is_array = True
                array_len = int(dims) if dims else None
                type_tok = base
            self.fields.append(
                Field(self._resolve(type_tok), rest.strip(), is_array, array_len)
            )

    def _resolve(self, t: str) -> str:
        if t in _BUILTINS:
            return t
        if t == "Header":  # special-cased by the ROS msg language
            return "std_msgs/Header"
        if "/" in t:
            return t
        return f"{self.package}/{t}"


REGISTRY: dict[str, MsgSpec] = {}


def register(full_name: str, text: str) -> MsgSpec:
    spec = MsgSpec(full_name, text)
    REGISTRY[full_name] = spec
    return spec


def compute_md5(type_name: str) -> str:
    """Standard ROS md5: constants first, builtin field lines verbatim,
    complex fields replaced by '<nested md5> <name>' (array spec dropped)."""
    spec = REGISTRY[type_name]
    lines = [f"{c.type} {c.name}={c.value}" for c in spec.constants]
    for f in spec.fields:
        if f.type in _BUILTINS:
            if f.is_array:
                dims = "" if f.array_len is None else str(f.array_len)
                lines.append(f"{f.type}[{dims}] {f.name}")
            else:
                lines.append(f"{f.type} {f.name}")
        else:
            lines.append(f"{compute_md5(f.type)} {f.name}")
    return hashlib.md5("\n".join(lines).encode()).hexdigest()


def full_definition(type_name: str) -> str:
    """gendeps --cat style concatenated definition for connection headers."""
    seen: list[str] = []

    def deps(name: str) -> None:
        for f in REGISTRY[name].fields:
            if f.type not in _BUILTINS:
                if f.type not in seen:
                    seen.append(f.type)
                deps(f.type)

    deps(type_name)
    parts = [REGISTRY[type_name].text]
    sep = "=" * 80
    for dep in seen:
        parts.append(f"{sep}\nMSG: {dep}\n{REGISTRY[dep].text}")
    return "\n".join(parts) + "\n"


# --- the message vocabulary the reference's pipelines touch ---------------

register("std_msgs/Header", "uint32 seq\ntime stamp\nstring frame_id")
register("geometry_msgs/Point", "float64 x\nfloat64 y\nfloat64 z")
register("geometry_msgs/Quaternion", "float64 x\nfloat64 y\nfloat64 z\nfloat64 w")
register("geometry_msgs/Vector3", "float64 x\nfloat64 y\nfloat64 z")
register(
    "geometry_msgs/Pose",
    "geometry_msgs/Point position\ngeometry_msgs/Quaternion orientation",
)
register("geometry_msgs/Pose2D", "float64 x\nfloat64 y\nfloat64 theta")
register(
    "geometry_msgs/PoseWithCovariance",
    "geometry_msgs/Pose pose\nfloat64[36] covariance",
)
register(
    "geometry_msgs/Twist",
    "geometry_msgs/Vector3 linear\ngeometry_msgs/Vector3 angular",
)
register(
    "geometry_msgs/TwistWithCovariance",
    "geometry_msgs/Twist twist\nfloat64[36] covariance",
)
register(
    "nav_msgs/Odometry",
    "Header header\nstring child_frame_id\n"
    "geometry_msgs/PoseWithCovariance pose\n"
    "geometry_msgs/TwistWithCovariance twist",
)
register(
    "sensor_msgs/PointField",
    "uint8 INT8=1\nuint8 UINT8=2\nuint8 INT16=3\nuint8 UINT16=4\n"
    "uint8 INT32=5\nuint8 UINT32=6\nuint8 FLOAT32=7\nuint8 FLOAT64=8\n"
    "string name\nuint32 offset\nuint8 datatype\nuint32 count",
)
register(
    "sensor_msgs/PointCloud2",
    "Header header\nuint32 height\nuint32 width\n"
    "sensor_msgs/PointField[] fields\nbool is_bigendian\nuint32 point_step\n"
    "uint32 row_step\nuint8[] data\nbool is_dense",
)
register(
    "sensor_msgs/Image",
    "Header header\nuint32 height\nuint32 width\nstring encoding\n"
    "uint8 is_bigendian\nuint32 step\nuint8[] data",
)
register(
    "sensor_msgs/CompressedImage",
    "Header header\nstring format\nuint8[] data",
)
register(
    "jsk_recognition_msgs/BoundingBox",
    "Header header\ngeometry_msgs/Pose pose\ngeometry_msgs/Vector3 dimensions\n"
    "float32 value\nuint32 label",
)
register(
    "jsk_recognition_msgs/BoundingBoxArray",
    "Header header\njsk_recognition_msgs/BoundingBox[] boxes",
)
register(
    "vision_msgs/ObjectHypothesisWithPose",
    "int64 id\nfloat64 score\ngeometry_msgs/PoseWithCovariance pose",
)
register(
    "vision_msgs/BoundingBox2D",
    "geometry_msgs/Pose2D center\nfloat64 size_x\nfloat64 size_y",
)
register(
    "vision_msgs/Detection2D",
    "Header header\nvision_msgs/ObjectHypothesisWithPose[] results\n"
    "vision_msgs/BoundingBox2D bbox\nsensor_msgs/Image source_img",
)
register(
    "vision_msgs/Detection2DArray",
    "Header header\nvision_msgs/Detection2D[] detections",
)


# ---------------------------------------------------------------------------
# Serialization (little-endian ROS1 wire rules)
# ---------------------------------------------------------------------------


def make(type_name: str, **kwargs: Any) -> SimpleNamespace:
    """Default-initialized message instance (recursively), then kwargs."""
    spec = REGISTRY[type_name]
    msg = SimpleNamespace(_type=type_name)
    for f in spec.fields:
        if f.is_array:
            if f.type in _BUILTIN_NP:
                val: Any = np.zeros(f.array_len or 0, _BUILTIN_NP[f.type])
            else:
                val = []
        elif f.type in _BUILTIN_FMT:
            val = 0
        elif f.type == "string":
            val = ""
        elif f.type in ("time", "duration"):
            val = (0, 0)
        else:
            val = make(f.type)
        setattr(msg, f.name, val)
    for k, v in kwargs.items():
        setattr(msg, k, v)
    return msg


def _ser_value(out: bytearray, ftype: str, value: Any) -> None:
    if ftype in _BUILTIN_FMT:
        out += struct.pack("<" + _BUILTIN_FMT[ftype], value)
    elif ftype == "string":
        data = value.encode() if isinstance(value, str) else bytes(value)
        out += struct.pack("<I", len(data)) + data
    elif ftype in ("time", "duration"):
        secs, nsecs = _as_time(value)
        out += struct.pack("<II", secs, nsecs)
    else:
        _serialize_into(out, ftype, value)


def _serialize_into(out: bytearray, type_name: str, msg: Any) -> None:
    for f in REGISTRY[type_name].fields:
        value = getattr(msg, f.name)
        if not f.is_array:
            _ser_value(out, f.type, value)
            continue
        if f.type in _BUILTIN_NP:
            arr = np.ascontiguousarray(value, dtype=_BUILTIN_NP[f.type])
            if f.array_len is None:
                out += struct.pack("<I", arr.size)
            elif arr.size != f.array_len:
                raise ValueError(
                    f"{type_name}.{f.name}: fixed array wants {f.array_len}, "
                    f"got {arr.size}"
                )
            out += arr.tobytes()
        else:
            seq = list(value)
            if f.array_len is None:
                out += struct.pack("<I", len(seq))
            for item in seq:
                _ser_value(out, f.type, item)


def serialize(type_name: str, msg: Any) -> bytes:
    out = bytearray()
    _serialize_into(out, type_name, msg)
    return bytes(out)


def _as_time(value: Any) -> tuple[int, int]:
    if isinstance(value, (tuple, list)):
        return int(value[0]), int(value[1])
    if isinstance(value, (int, float)):
        secs = int(value)
        return secs, int(round((float(value) - secs) * 1e9))
    return int(value.secs), int(value.nsecs)  # rospy.Time-like


def _des_value(buf: memoryview, pos: int, ftype: str) -> tuple[Any, int]:
    if ftype in _BUILTIN_FMT:
        fmt = "<" + _BUILTIN_FMT[ftype]
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if ftype == "string":
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        return bytes(buf[pos : pos + n]).decode(errors="replace"), pos + n
    if ftype in ("time", "duration"):
        secs, nsecs = struct.unpack_from("<II", buf, pos)
        return (secs, nsecs), pos + 8
    return _deserialize_from(buf, pos, ftype)


def _deserialize_from(
    buf: memoryview, pos: int, type_name: str
) -> tuple[SimpleNamespace, int]:
    msg = SimpleNamespace(_type=type_name)
    for f in REGISTRY[type_name].fields:
        if not f.is_array:
            value, pos = _des_value(buf, pos, f.type)
        elif f.type in _BUILTIN_NP:
            if f.array_len is None:
                (count,) = struct.unpack_from("<I", buf, pos)
                pos += 4
            else:
                count = f.array_len
            dt = np.dtype(_BUILTIN_NP[f.type])
            nbytes = count * dt.itemsize
            value = np.frombuffer(buf, dt, count, pos).copy()
            pos += nbytes
        else:
            if f.array_len is None:
                (count,) = struct.unpack_from("<I", buf, pos)
                pos += 4
            else:
                count = f.array_len
            items = []
            for _ in range(count):
                item, pos = _des_value(buf, pos, f.type)
                items.append(item)
            value = items
        setattr(msg, f.name, value)
    return msg, pos


def deserialize(type_name: str, data: bytes | memoryview) -> SimpleNamespace:
    msg, pos = _deserialize_from(memoryview(data), 0, type_name)
    if pos != len(data):
        raise ValueError(
            f"{type_name}: {len(data) - pos} trailing bytes after deserialize"
        )
    return msg


# ---------------------------------------------------------------------------
# Bag container format (V2.0)
# ---------------------------------------------------------------------------

MAGIC = b"#ROSBAG V2.0\n"
_OP_MSG = 0x02
_OP_BAG_HEADER = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNK_INFO = 0x06
_OP_CONNECTION = 0x07
_BAG_HEADER_LEN = 4096  # standard padded bag-header record size


def _pack_header(fields: dict[str, bytes]) -> bytes:
    out = bytearray()
    for name, value in fields.items():
        entry = name.encode() + b"=" + value
        out += struct.pack("<I", len(entry)) + entry
    return bytes(out)


def _parse_header(data: bytes | memoryview) -> dict[str, bytes]:
    fields: dict[str, bytes] = {}
    pos, n = 0, len(data)
    while pos < n:
        (flen,) = struct.unpack_from("<I", data, pos)
        pos += 4
        entry = bytes(data[pos : pos + flen])
        pos += flen
        name, _, value = entry.partition(b"=")
        fields[name.decode()] = value
    return fields


def _u32(v: int) -> bytes:
    return struct.pack("<I", v)


def _u64(v: int) -> bytes:
    return struct.pack("<Q", v)


def _time_bytes(t: float) -> bytes:
    secs = int(t)
    return struct.pack("<II", secs, int(round((t - secs) * 1e9)))


def _time_from(b: bytes) -> float:
    secs, nsecs = struct.unpack("<II", b)
    return secs + nsecs * 1e-9


@dataclasses.dataclass
class Connection:
    conn_id: int
    topic: str
    datatype: str
    md5sum: str
    definition: str


@dataclasses.dataclass
class BagMessage:
    """Lazily-decoded message: ``.msg`` deserializes on first access."""

    connection: Connection
    raw: bytes
    time: float

    _decoded: Any = dataclasses.field(default=None, repr=False)

    @property
    def msg(self) -> Any:
        if self._decoded is None:
            if self.connection.datatype not in REGISTRY:
                raise KeyError(
                    f"no spec registered for {self.connection.datatype}; "
                    "use .raw or register() the type"
                )
            self._decoded = deserialize(self.connection.datatype, self.raw)
        return self._decoded


def _decompress(compression: str, data: bytes) -> bytes:
    if compression in ("none", ""):
        return data
    if compression == "bz2":
        return bz2.decompress(data)
    if compression == "lz4":
        try:
            import lz4.frame  # noqa: F401 - optional
        except ImportError as e:
            raise NotImplementedError(
                "lz4-compressed bag and no lz4 module; re-record with "
                "bz2/none compression"
            ) from e
        return lz4.frame.decompress(data)
    raise NotImplementedError(f"unknown chunk compression {compression!r}")


class BagReader:
    """Sequential rosbag V2.0 reader.

    Walks the file record by record (no index needed — robust to
    unindexed/truncated bags), expanding chunks inline. Messages come
    out in file order, which for rosbag-recorded files is time order
    per chunk.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self.connections: dict[int, Connection] = {}
        self._f = open(path, "rb")
        magic = self._f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(
                f"{path}: not a rosbag V2.0 file (magic {magic!r}); "
                "V1.2 bags must be migrated with `rosbag fix`"
            )

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "BagReader":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def _read_record_from_file(self) -> tuple[dict[str, bytes], bytes] | None:
        hdr_len_b = self._f.read(4)
        if len(hdr_len_b) < 4:
            return None
        (hdr_len,) = struct.unpack("<I", hdr_len_b)
        header = self._f.read(hdr_len)
        (data_len,) = struct.unpack("<I", self._f.read(4))
        data = self._f.read(data_len)
        if len(header) < hdr_len or len(data) < data_len:
            return None  # truncated tail
        return _parse_header(header), data

    def _register_connection(self, fields: dict[str, bytes], data: bytes) -> None:
        (conn_id,) = struct.unpack("<I", fields["conn"])
        if conn_id in self.connections:
            return
        info = _parse_header(data)
        self.connections[conn_id] = Connection(
            conn_id=conn_id,
            topic=fields.get("topic", info.get("topic", b"")).decode(),
            datatype=info.get("type", b"").decode(),
            md5sum=info.get("md5sum", b"").decode(),
            definition=info.get("message_definition", b"").decode(
                errors="replace"
            ),
        )

    def _iter_chunk(self, data: bytes) -> Iterator[BagMessage]:
        buf = memoryview(data)
        pos, n = 0, len(buf)
        while pos < n:
            (hdr_len,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            fields = _parse_header(buf[pos : pos + hdr_len])
            pos += hdr_len
            (data_len,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            payload = bytes(buf[pos : pos + data_len])
            pos += data_len
            op = fields["op"][0]
            if op == _OP_CONNECTION:
                self._register_connection(fields, payload)
            elif op == _OP_MSG:
                (conn_id,) = struct.unpack("<I", fields["conn"])
                yield BagMessage(
                    connection=self.connections[conn_id],
                    raw=payload,
                    time=_time_from(fields["time"]),
                )

    def read_messages(
        self, topics: list[str] | None = None, raw: bool = False
    ) -> Iterator[tuple[str, Any, float]]:
        """Yield ``(topic, msg, t)`` — rosbag.Bag.read_messages parity
        (bag_inference2d.py:92): a falsy ``topics`` ([] or None) means
        every topic, matching rosbag's truthiness check. ``raw=True``
        yields the BagMessage (undecoded) instead of the deserialized
        message."""
        yield from self._scan(set(topics) if topics else None, raw)

    def _scan(
        self, want: set[str] | None, raw: bool = False
    ) -> Iterator[tuple[str, Any, float]]:
        """Record walk; ``want`` is the exact topic filter (empty set =
        yield nothing, i.e. a connection-metadata-only scan)."""
        self._f.seek(len(MAGIC))
        while True:
            rec = self._read_record_from_file()
            if rec is None:
                return
            fields, data = rec
            op = fields["op"][0]
            if op == _OP_CONNECTION:
                self._register_connection(fields, data)
            elif op == _OP_CHUNK:
                compression = fields.get("compression", b"none").decode()
                for bm in self._iter_chunk(_decompress(compression, data)):
                    if want is None or bm.connection.topic in want:
                        yield (
                            bm.connection.topic,
                            bm if raw else bm.msg,
                            bm.time,
                        )
            elif op == _OP_MSG:  # unchunked bag (not produced by rosbag,
                # but legal) — treat like an in-chunk record
                (conn_id,) = struct.unpack("<I", fields["conn"])
                bm = BagMessage(
                    connection=self.connections[conn_id],
                    raw=data,
                    time=_time_from(fields["time"]),
                )
                if want is None or bm.connection.topic in want:
                    yield bm.connection.topic, bm if raw else bm.msg, bm.time
            # _OP_INDEX / _OP_CHUNK_INFO / _OP_BAG_HEADER: skip

    def topics(self) -> dict[str, str]:
        """topic -> datatype map (raw scan — never decodes payloads, so
        unregistered message types in the bag are fine)."""
        for _ in self._scan(set()):
            pass
        return {c.topic: c.datatype for c in self.connections.values()}


class BagWriter:
    """Indexed rosbag V2.0 writer (chunked; none or bz2 compression)."""

    def __init__(
        self,
        path: str,
        compression: str = "none",
        chunk_threshold: int = 768 * 1024,
    ) -> None:
        if compression not in ("none", "bz2"):
            raise ValueError("compression must be 'none' or 'bz2'")
        self.path = path
        self.compression = compression
        self.chunk_threshold = chunk_threshold
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._write_bag_header(0, 0, 0)  # placeholder, rewritten on close
        self._conns: dict[str, Connection] = {}  # topic -> Connection
        self._chunk = bytearray()
        self._chunk_index: dict[int, list[tuple[float, int]]] = {}
        self._chunk_conns_written: set[int] = set()
        self._chunk_infos: list[tuple[int, float, float, dict[int, int]]] = []
        self._closed = False

    # -- record plumbing --

    def _write_record(self, fields: dict[str, bytes], data: bytes) -> None:
        header = _pack_header(fields)
        self._f.write(_u32(len(header)) + header + _u32(len(data)) + data)

    def _write_bag_header(self, index_pos: int, conns: int, chunks: int) -> None:
        header = _pack_header(
            {
                "op": bytes([_OP_BAG_HEADER]),
                "index_pos": _u64(index_pos),
                "conn_count": _u32(conns),
                "chunk_count": _u32(chunks),
            }
        )
        pad = _BAG_HEADER_LEN - 8 - len(header)
        self._f.write(_u32(len(header)) + header + _u32(pad) + b" " * pad)

    def _connection_data(self, c: Connection) -> bytes:
        return _pack_header(
            {
                "topic": c.topic.encode(),
                "type": c.datatype.encode(),
                "md5sum": c.md5sum.encode(),
                "message_definition": c.definition.encode(),
            }
        )

    def _conn_record(self, c: Connection) -> bytes:
        fields = {
            "op": bytes([_OP_CONNECTION]),
            "conn": _u32(c.conn_id),
            "topic": c.topic.encode(),
        }
        header = _pack_header(fields)
        data = self._connection_data(c)
        return _u32(len(header)) + header + _u32(len(data)) + data

    # -- public API --

    def register(
        self,
        topic: str,
        datatype: str,
        md5sum: str | None = None,
        definition: str | None = None,
    ) -> Connection:
        if topic in self._conns:
            return self._conns[topic]
        if datatype in REGISTRY:
            if md5sum is None:
                md5sum = compute_md5(datatype)
            if definition is None:
                definition = full_definition(datatype)
        else:
            # Raw passthrough of a type we have no spec for: '*' is the
            # ROS wildcard md5 (subscribers that don't type-check accept it).
            md5sum = md5sum or "*"
            definition = definition or ""
        conn = Connection(len(self._conns), topic, datatype, md5sum, definition)
        self._conns[topic] = conn
        return conn

    def write(
        self,
        topic: str,
        msg: Any,
        t: float | None = None,
        datatype: str | None = None,
    ) -> None:
        """Write a message. ``msg`` is a SimpleNamespace from make()/
        deserialize() (datatype from ``._type`` unless given), a
        BagMessage (re-written raw), or raw bytes (datatype required)."""
        if isinstance(msg, BagMessage):
            raw = msg.raw
            datatype = datatype or msg.connection.datatype
            if t is None:
                t = msg.time
            conn = (
                self._conns[topic]
                if topic in self._conns
                else self.register(
                    topic,
                    datatype,
                    msg.connection.md5sum,
                    msg.connection.definition,
                )
            )
        elif isinstance(msg, (bytes, bytearray, memoryview)):
            if datatype is None:
                raise ValueError("raw bytes need an explicit datatype")
            raw = bytes(msg)
            conn = self.register(topic, datatype)
        else:
            datatype = datatype or getattr(msg, "_type")
            raw = serialize(datatype, msg)
            conn = self.register(topic, datatype)
        if t is None:
            stamp = getattr(msg, "header", None)
            t = 0.0
            if stamp is not None:
                secs, nsecs = _as_time(stamp.stamp)
                t = secs + nsecs * 1e-9

        if conn.conn_id not in self._chunk_conns_written:
            self._chunk += self._conn_record(conn)
            self._chunk_conns_written.add(conn.conn_id)
        offset = len(self._chunk)
        header = _pack_header(
            {
                "op": bytes([_OP_MSG]),
                "conn": _u32(conn.conn_id),
                "time": _time_bytes(t),
            }
        )
        self._chunk += _u32(len(header)) + header + _u32(len(raw)) + raw
        self._chunk_index.setdefault(conn.conn_id, []).append((t, offset))
        if len(self._chunk) >= self.chunk_threshold:
            self._flush_chunk()

    def _flush_chunk(self) -> None:
        if not self._chunk:
            return
        chunk_pos = self._f.tell()
        payload = bytes(self._chunk)
        data = bz2.compress(payload) if self.compression == "bz2" else payload
        all_times = [t for idx in self._chunk_index.values() for t, _ in idx]
        self._write_record(
            {
                "op": bytes([_OP_CHUNK]),
                "compression": self.compression.encode(),
                "size": _u32(len(payload)),
            },
            data,
        )
        for conn_id, entries in sorted(self._chunk_index.items()):
            data = b"".join(
                _time_bytes(t) + _u32(off) for t, off in entries
            )
            self._write_record(
                {
                    "op": bytes([_OP_INDEX]),
                    "ver": _u32(1),
                    "conn": _u32(conn_id),
                    "count": _u32(len(entries)),
                },
                data,
            )
        self._chunk_infos.append(
            (
                chunk_pos,
                min(all_times) if all_times else 0.0,
                max(all_times) if all_times else 0.0,
                {cid: len(e) for cid, e in self._chunk_index.items()},
            )
        )
        self._chunk = bytearray()
        self._chunk_index = {}
        self._chunk_conns_written = set()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._flush_chunk()
        index_pos = self._f.tell()
        for conn in self._conns.values():
            self._write_record(
                {
                    "op": bytes([_OP_CONNECTION]),
                    "conn": _u32(conn.conn_id),
                    "topic": conn.topic.encode(),
                },
                self._connection_data(conn),
            )
        for chunk_pos, t0, t1, counts in self._chunk_infos:
            data = b"".join(
                _u32(cid) + _u32(cnt) for cid, cnt in sorted(counts.items())
            )
            self._write_record(
                {
                    "op": bytes([_OP_CHUNK_INFO]),
                    "ver": _u32(1),
                    "chunk_pos": _u64(chunk_pos),
                    "start_time": _time_bytes(t0),
                    "end_time": _time_bytes(t1),
                    "count": _u32(len(counts)),
                },
                data,
            )
        self._f.seek(len(MAGIC))
        self._write_bag_header(index_pos, len(self._conns), len(self._chunk_infos))
        self._f.close()

    def __enter__(self) -> "BagWriter":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Sensor message <-> numpy helpers
# ---------------------------------------------------------------------------

_PF_DTYPE = {
    1: np.int8,
    2: np.uint8,
    3: np.int16,
    4: np.uint16,
    5: np.int32,
    6: np.uint32,
    7: np.float32,
    8: np.float64,
}


def pointcloud2_to_xyzi(msg: Any) -> np.ndarray:
    """(N, 4) float32 x/y/z/intensity — parity with the driver's
    ``point_cloud2.read_points(msg, ('x','y','z','intensity'))``
    (communicator/ros_inference3d.py:125). Missing intensity -> zeros."""
    n = int(msg.width) * int(msg.height)
    step = int(msg.point_step)
    buf = np.ascontiguousarray(msg.data, np.uint8)
    # Structured dtype with explicit offsets + itemsize handles arbitrary
    # point layouts (padding, extra fields, steps not divisible by 4 —
    # e.g. velodyne's 22-byte x/y/z/intensity/ring points).
    present = {
        f.name: (f.offset, np.dtype(_PF_DTYPE[int(f.datatype)]))
        for f in msg.fields
        if f.name in ("x", "y", "z", "intensity")
    }
    rec = np.frombuffer(
        buf,  # zero-copy view; the .astype below does the only copy
        dtype=np.dtype(
            {
                "names": list(present),
                "formats": [dt for _, dt in present.values()],
                "offsets": [off for off, _ in present.values()],
                "itemsize": step,
            }
        ),
        count=n,
    )
    cols = [
        rec[name].astype(np.float32)
        if name in present
        else np.zeros(n, np.float32)
        for name in ("x", "y", "z", "intensity")
    ]
    return np.stack(cols, axis=1)


def xyzi_to_pointcloud2(
    points: np.ndarray,
    frame_id: str = "lidar",
    stamp: float = 0.0,
    seq: int = 0,
) -> SimpleNamespace:
    """(N, 4) float32 -> dense PointCloud2 with x/y/z/intensity fields."""
    pts = np.ascontiguousarray(points, np.float32)
    n = pts.shape[0]
    fields = [
        make(
            "sensor_msgs/PointField",
            name=name,
            offset=4 * i,
            datatype=7,  # FLOAT32
            count=1,
        )
        for i, name in enumerate(("x", "y", "z", "intensity"))
    ]
    header = make(
        "std_msgs/Header", seq=seq, stamp=_split_time(stamp), frame_id=frame_id
    )
    return make(
        "sensor_msgs/PointCloud2",
        header=header,
        height=1,
        width=n,
        fields=fields,
        is_bigendian=0,
        point_step=16,
        row_step=16 * n,
        data=pts.reshape(-1).view(np.uint8),
        is_dense=1,
    )


def _split_time(t: float) -> tuple[int, int]:
    secs = int(t)
    return secs, int(round((t - secs) * 1e9))


def image_to_numpy(msg: Any) -> np.ndarray:
    """sensor_msgs/Image -> RGB uint8 (rgb8/bgr8/mono8/bgra8/rgba8)."""
    h, w = int(msg.height), int(msg.width)
    enc = msg.encoding.lower()
    data = np.asarray(msg.data, np.uint8)
    ch = {"mono8": 1, "rgb8": 3, "bgr8": 3, "rgba8": 4, "bgra8": 4}.get(enc)
    if ch is None:
        raise NotImplementedError(f"image encoding {msg.encoding!r}")
    step = int(msg.step) or w * ch
    img = data.reshape(h, step)[:, : w * ch].reshape(h, w, ch)
    if enc == "mono8":
        return np.repeat(img, 3, axis=2)
    if enc.startswith("bgr"):
        img = img[..., [2, 1, 0]]
    return np.ascontiguousarray(img[..., :3])


def compressed_image_to_numpy(msg: Any) -> np.ndarray:
    """sensor_msgs/CompressedImage -> RGB uint8 via cv2 (reference's
    cv2.imdecode path, ros_inference.py:119-131) or PIL fallback."""
    raw = np.asarray(msg.data, np.uint8)
    try:
        import cv2

        bgr = cv2.imdecode(raw, cv2.IMREAD_COLOR)
        if bgr is None:
            raise IOError("cv2.imdecode failed")
        return bgr[..., ::-1].copy()
    except ImportError:
        import io as _io

        from PIL import Image

        return np.asarray(Image.open(_io.BytesIO(raw.tobytes())).convert("RGB"))


def numpy_to_image(
    img: np.ndarray, frame_id: str = "camera", stamp: float = 0.0, seq: int = 0
) -> SimpleNamespace:
    """RGB uint8 (H, W, 3) -> sensor_msgs/Image rgb8."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    header = make(
        "std_msgs/Header", seq=seq, stamp=_split_time(stamp), frame_id=frame_id
    )
    return make(
        "sensor_msgs/Image",
        header=header,
        height=h,
        width=w,
        encoding="rgb8",
        is_bigendian=0,
        step=w * 3,
        data=img.reshape(-1),
    )


def numpy_to_compressed_image(
    img: np.ndarray, frame_id: str = "camera", stamp: float = 0.0, seq: int = 0
) -> SimpleNamespace:
    """RGB uint8 -> jpeg CompressedImage (cv2 required)."""
    import cv2

    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]))
    if not ok:
        raise IOError("cv2.imencode failed")
    header = make(
        "std_msgs/Header", seq=seq, stamp=_split_time(stamp), frame_id=frame_id
    )
    return make(
        "sensor_msgs/CompressedImage",
        header=header,
        format="jpeg",
        data=np.asarray(enc, np.uint8).reshape(-1),
    )


def yaw_to_quaternion(yaw: float) -> SimpleNamespace:
    """Rotation about +z — the driver's yaw2quaternion
    (communicator/ros_inference3d.py:117-118)."""
    return make(
        "geometry_msgs/Quaternion",
        x=0.0,
        y=0.0,
        z=float(np.sin(yaw / 2.0)),
        w=float(np.cos(yaw / 2.0)),
    )


def boxes7_to_jsk_array(
    boxes7: np.ndarray,
    scores: np.ndarray,
    labels: np.ndarray,
    frame_id: str = "lidar",
    stamp: float = 0.0,
    seq: int = 0,
) -> SimpleNamespace:
    """(N, 7) [x,y,z,dx,dy,dz,yaw] -> jsk BoundingBoxArray, with the
    reference's dimension mapping (dimensions.x <- dy, dimensions.y <- dx
    swap per bag_inference3d.py:170-172 / ros_inference3d.py:177-186)."""
    header = make(
        "std_msgs/Header", seq=seq, stamp=_split_time(stamp), frame_id=frame_id
    )
    arr = make("jsk_recognition_msgs/BoundingBoxArray", header=header)
    for i in range(len(boxes7)):
        b = boxes7[i]
        box = make(
            "jsk_recognition_msgs/BoundingBox",
            header=header,
            pose=make(
                "geometry_msgs/Pose",
                position=make(
                    "geometry_msgs/Point",
                    x=float(b[0]),
                    y=float(b[1]),
                    z=float(b[2]),
                ),
                orientation=yaw_to_quaternion(float(b[6])),
            ),
            dimensions=make(
                "geometry_msgs/Vector3",
                x=float(b[4]),
                y=float(b[3]),
                z=float(b[5]),
            ),
            value=float(scores[i]),
            label=int(labels[i]),
        )
        arr.boxes.append(box)
    return arr
