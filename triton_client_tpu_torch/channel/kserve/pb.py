"""The KServe v2 messages of ``kserve_v2.proto``, encoded without protobuf.

The port's stand-in for the generated ``kserve_v2_pb2`` of the JAX
package: one class per message of the ``.proto`` beside this file, with
the generated module's field names, the ``TYPE_*`` constants of
``DataType``, ``SerializeToString()`` and ``FromString(bytes)``. The port
needs no protobuf on its serving host, so the proto3 wire format is
written here:

- varints (a negative ``int32``/``int64``/enum as ten bytes), fixed 32
  and 64-bit floats, length-delimited strings, bytes and messages;
- repeated scalars packed on output, and read packed or unpacked;
- ``map<string, ...>`` fields as repeated key/value entries, both fields
  of an entry always written;
- the ``parameter_choice`` oneof of ``InferParameter``: setting one
  member clears the others, and a set member is written even when it
  holds its default.

Output is byte-identical to protobuf's ``SerializeToString(
deterministic=True)``: fields in number order, map entries in the order
its encoder sorts them (:func:`_map_order`), proto3 defaults omitted. Input skips unknown fields of every wire type
(groups included); they are not kept for re-serialization.
``raw_input_contents`` and ``raw_output_contents`` decode as
``memoryview`` slices of the message buffer, not copies, so the codec's
``np.frombuffer`` views stay zero-copy.

Reading an unset singular message field returns an empty message that
becomes present once one of its fields is assigned, as in protobuf;
bracket access on a map inserts the key's default entry, as in protobuf.
"""

from __future__ import annotations

import math
import struct

class DecodeError(ValueError):
    """The bytes are not a valid encoding of the message."""


# -- field kinds ---------------------------------------------------------------

# kind -> (wire type, default)
_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5
_KINDS = {
    "bool": (_VARINT, False),
    "int32": (_VARINT, 0),
    "int64": (_VARINT, 0),
    "uint32": (_VARINT, 0),
    "uint64": (_VARINT, 0),
    "enum": (_VARINT, 0),
    "float": (_I32, 0.0),
    "double": (_I64, 0.0),
    "string": (_LEN, ""),
    "bytes": (_LEN, b""),
    "message": (_LEN, None),
}
_RANGES = {
    "int32": (-(1 << 31), 1 << 31),
    "enum": (-(1 << 31), 1 << 31),
    "int64": (-(1 << 63), 1 << 63),
    "uint32": (0, 1 << 32),
    "uint64": (0, 1 << 64),
}
_SMALL = [bytes((i,)) for i in range(128)]
_MASK64 = (1 << 64) - 1


def _varint(v: int) -> bytes:
    if 0 <= v < 128:
        return _SMALL[v]
    v &= _MASK64
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _read_varint(buf, pos: int, end: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= end:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than ten bytes")


class _Field:
    __slots__ = ("number", "name", "kind", "label", "msg", "oneof", "view", "wire", "tag",
                 "packed_tag")

    def __init__(self, number, name, kind, label="single", msg=None, oneof=None, view=False):
        self.number = number
        self.name = name
        self.kind = kind  # for a map: the value's kind
        self.label = label  # "single" | "repeated" | "map"
        self.msg = msg  # message class (for kind "message"; the map's value class)
        self.oneof = oneof
        self.view = view  # bytes decoded as memoryview slices
        self.wire = _LEN if label == "map" else _KINDS[kind][0]
        self.tag = _varint((number << 3) | self.wire)
        self.packed_tag = _varint((number << 3) | _LEN)

    @property
    def packable(self) -> bool:
        return self.label == "repeated" and self.kind not in ("string", "bytes", "message")


def _check_scalar(f: _Field, kind: str, v):
    """Coerce a scalar assigned to ``f`` (numpy scalars included) or raise
    as protobuf does."""
    if kind == "string":
        if isinstance(v, bytes):
            return v.decode("utf-8")  # protobuf takes UTF-8 bytes too
        if not isinstance(v, str):
            raise TypeError(f"{f.name}: expected str, got {type(v).__name__}")
        return v
    if kind == "bytes":
        if not isinstance(v, (bytes, bytearray, memoryview)):
            raise TypeError(f"{f.name}: expected bytes, got {type(v).__name__}")
        return v
    if kind in ("float", "double"):
        if isinstance(v, (str, bytes)):
            raise TypeError(f"{f.name}: expected a number, got {type(v).__name__}")
        return float(v)
    if kind == "bool":
        if isinstance(v, (str, bytes, float)):
            raise TypeError(f"{f.name}: expected bool, got {type(v).__name__}")
        return bool(v)
    try:
        v = v.__index__()
    except AttributeError:
        raise TypeError(f"{f.name}: expected an integer, got {type(v).__name__}") from None
    lo, hi = _RANGES[kind]
    if not lo <= v < hi:
        raise ValueError(f"{f.name}: value {v} out of range for {kind}")
    return v


# -- containers ------------------------------------------------------------------


class RepeatedMessages(list):
    """A repeated message field: ``add(**fields)`` appends a new element."""

    __slots__ = ("_cls",)

    def __init__(self, cls) -> None:
        super().__init__()
        self._cls = cls

    def add(self, **fields):
        m = self._cls(**fields)
        self.append(m)
        return m


class MessageMap(dict):
    """``map<string, Message>``: bracket access inserts an empty message."""

    __slots__ = ("_cls",)

    def __init__(self, cls) -> None:
        super().__init__()
        self._cls = cls

    def __missing__(self, key):
        if not isinstance(key, str):
            raise TypeError(f"map keys are str, got {type(key).__name__}")
        v = self[key] = self._cls()
        return v


class ScalarMap(dict):
    """``map<string, string>``: bracket access inserts ``""``."""

    __slots__ = ()

    def __missing__(self, key):
        if not isinstance(key, str):
            raise TypeError(f"map keys are str, got {type(key).__name__}")
        self[key] = ""
        return ""

    def __setitem__(self, key, value) -> None:
        if not isinstance(key, str) or not isinstance(value, str):
            raise TypeError("map<string, string> takes str keys and values")
        super().__setitem__(key, value)


# -- messages ----------------------------------------------------------------------


class Message:
    """Base of every message class. Field values live in ``_v``. A
    singular message read while unset is created once, kept in ``_lazy``
    with a back-reference (``_parent``), and becomes present when a field
    of it is assigned, or when it holds anything at all at encoding time
    (a repeated field or a map of it filled in place)."""

    __slots__ = ("_v", "_oneof", "_parent", "_lazy")
    _FIELDS: tuple[_Field, ...] = ()
    _BY_NAME: dict[str, _Field] = {}
    _BY_NUMBER: dict[int, _Field] = {}

    def __init__(self, **fields) -> None:
        object.__setattr__(self, "_v", {})
        object.__setattr__(self, "_oneof", {})
        object.__setattr__(self, "_parent", None)
        object.__setattr__(self, "_lazy", {})
        for name, value in fields.items():
            f = self._BY_NAME.get(name)
            if f is None:
                raise ValueError(f"{type(self).__name__} has no field {name!r}")
            if value is None:
                continue
            if f.label == "repeated":
                getattr(self, name).extend(
                    value if f.kind == "message" else (_check_scalar(f, f.kind, x) for x in value)
                )
            elif f.label == "map":
                m = getattr(self, name)
                for k, x in dict(value).items():
                    if f.kind == "message":
                        m[k]._merge_from(x)
                    else:
                        m[k] = x
            else:
                setattr(self, name, value)

    # -- attribute access ------------------------------------------------------

    def __getattr__(self, name: str):
        f = self._BY_NAME.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        v = self._v.get(name)
        if v is not None:
            return v
        if f.label == "repeated":
            v = self._v[name] = RepeatedMessages(f.msg) if f.kind == "message" else []
            return v
        if f.label == "map":
            v = self._v[name] = MessageMap(f.msg) if f.kind == "message" else ScalarMap()
            return v
        if f.kind == "message":
            lazy = self._lazy
            v = lazy.get(name)
            if v is None:
                v = lazy[name] = f.msg()
                object.__setattr__(v, "_parent", (self, name))
            return v
        return _KINDS[f.kind][1]

    def __setattr__(self, name: str, value) -> None:
        f = self._BY_NAME.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        if f.label != "single":
            raise AttributeError(f"assignment to repeated field {name!r} is not allowed")
        if f.kind == "message":
            if not isinstance(value, f.msg):
                raise TypeError(f"{name}: expected {f.msg.__name__}, got {type(value).__name__}")
            object.__setattr__(value, "_parent", None)
            self._lazy.pop(name, None)
        else:
            value = _check_scalar(f, f.kind, value)
        self._v[name] = value
        if f.oneof is not None:
            prev = self._oneof.get(f.oneof)
            if prev is not None and prev != name:
                self._v.pop(prev, None)
            self._oneof[f.oneof] = name
        self._mark_present()

    def _mark_present(self) -> None:
        link = self._parent
        if link is not None:
            parent, name = link
            object.__setattr__(self, "_parent", None)
            parent._lazy.pop(name, None)
            parent._v[name] = self
            parent._mark_present()

    def WhichOneof(self, group: str):
        return self._oneof.get(group)

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self.SerializeToString() == other.SerializeToString()

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v!r}" for k, v in self._v.items() if v or v == 0)
        return f"{type(self).__name__}({body})"

    # -- encoding ------------------------------------------------------------------

    def SerializeToString(self, deterministic: bool = True) -> bytes:
        """The proto3 encoding (always the deterministic one)."""
        out: list = []
        self._encode(out)
        return b"".join(out)

    def _encode(self, out: list) -> int:
        """Append the encoding's pieces to ``out``; returns its length."""
        size = 0
        v = self._v
        lazy = self._lazy
        for f in self._FIELDS:
            x = v.get(f.name)
            if x is None:
                if not lazy or f.name not in lazy:
                    continue
                x = lazy[f.name]
                sub: list = []
                n = x._encode(sub)
                if n == 0:
                    continue  # read, never filled: not present
                ln = _varint(n)
                out.append(f.tag)
                out.append(ln)
                out.extend(sub)
                size += len(f.tag) + len(ln) + n
                continue
            if f.label == "single":
                if f.kind == "message":
                    sub = []
                    n = x._encode(sub)
                    ln = _varint(n)
                    out.append(f.tag)
                    out.append(ln)
                    out.extend(sub)
                    size += len(f.tag) + len(ln) + n
                    continue
                # a set oneof member is written even at its default
                if f.oneof is None and not _nondefault(f.kind, x):
                    continue
                size += _encode_scalar(out, f, f.kind, x)
            elif f.label == "repeated":
                if not x:
                    continue
                if f.kind == "message":
                    for m in x:
                        sub = []
                        n = m._encode(sub)
                        ln = _varint(n)
                        out.append(f.tag)
                        out.append(ln)
                        out.extend(sub)
                        size += len(f.tag) + len(ln) + n
                elif f.packable:
                    body = _packed(f, x)
                    ln = _varint(len(body))
                    out.append(f.packed_tag)
                    out.append(ln)
                    out.append(body)
                    size += len(f.packed_tag) + len(ln) + len(body)
                else:
                    for item in x:
                        size += _encode_scalar(out, f, f.kind, item)
            else:  # map: key and value always written, entries in _map_order
                for key in sorted(x, key=_map_order):
                    val = x[key]
                    entry: list = []
                    kb = key.encode("utf-8")
                    n = 1 + len(_varint(len(kb))) + len(kb)
                    entry.append(b"\x0a")
                    entry.append(_varint(len(kb)))
                    entry.append(kb)
                    if f.kind == "message":
                        sub = []
                        m = val._encode(sub)
                        lm = _varint(m)
                        entry.append(b"\x12")
                        entry.append(lm)
                        entry.extend(sub)
                        n += 1 + len(lm) + m
                    else:
                        vb = val.encode("utf-8")
                        lv = _varint(len(vb))
                        entry.append(b"\x12")
                        entry.append(lv)
                        entry.append(vb)
                        n += 1 + len(lv) + len(vb)
                    ln = _varint(n)
                    out.append(f.tag)
                    out.append(ln)
                    out.extend(entry)
                    size += len(f.tag) + len(ln) + n
        return size

    # -- decoding ------------------------------------------------------------------

    @classmethod
    def FromString(cls, data):
        """Parse ``data`` (bytes, bytearray or memoryview)."""
        msg = cls()
        msg.MergeFromString(data)
        return msg

    def MergeFromString(self, data) -> int:
        view = data if isinstance(data, memoryview) else memoryview(data)
        if view.format != "B" or view.ndim != 1:
            view = view.cast("B")
        self._decode(view, 0, len(view))
        return len(view)

    def _decode(self, view: memoryview, pos: int, end: int) -> None:
        by_number = self._BY_NUMBER
        v = self._v
        while pos < end:
            key, pos = _read_varint(view, pos, end)
            number, wire = key >> 3, key & 7
            if number == 0:
                raise DecodeError("field number 0")
            f = by_number.get(number)
            if f is None or not (wire == f.wire or (wire == _LEN and f.packable)):
                pos = _skip(view, pos, end, wire, number)
                continue
            if wire == _LEN:
                ln, pos = _read_varint(view, pos, end)
                stop = pos + ln
                if stop > end:
                    raise DecodeError(f"field {f.name}: truncated")
                if f.label == "map":
                    _decode_entry(self, f, view, pos, stop)
                elif f.kind == "message":
                    if f.label == "repeated":
                        m = f.msg()
                        m._decode(view, pos, stop)
                        getattr(self, f.name).append(m)
                    else:
                        m = v.get(f.name)
                        if m is None:
                            m = v[f.name] = self._lazy.pop(f.name, None) or f.msg()
                            object.__setattr__(m, "_parent", None)
                        m._decode(view, pos, stop)
                elif f.kind in ("string", "bytes"):
                    chunk = view[pos:stop]
                    if f.kind == "string":
                        try:
                            val = str(chunk, "utf-8")
                        except UnicodeDecodeError as e:
                            raise DecodeError(f"field {f.name}: invalid UTF-8") from e
                    else:
                        val = chunk if f.view else bytes(chunk)
                    self._store(f, val)
                else:  # packed scalars
                    items = getattr(self, f.name)
                    p = pos
                    while p < stop:
                        val, p = _read_scalar(f.kind, view, p, stop)
                        items.append(val)
                    if p != stop:
                        raise DecodeError(f"field {f.name}: packed run overruns its length")
                pos = stop
            else:
                val, pos = _read_scalar(f.kind, view, pos, end)
                self._store(f, val)

    def _store(self, f: _Field, val) -> None:
        if f.label == "repeated":
            getattr(self, f.name).append(val)
            return
        self._v[f.name] = val
        if f.oneof is not None:
            prev = self._oneof.get(f.oneof)
            if prev is not None and prev != f.name:
                self._v.pop(prev, None)
            self._oneof[f.oneof] = f.name

    def _merge_from(self, other: "Message") -> None:
        """Copy ``other``'s set fields onto this message (map values)."""
        if type(other) is not type(self):
            raise TypeError(f"expected {type(self).__name__}, got {type(other).__name__}")
        self.MergeFromString(other.SerializeToString())


def _map_order(key: str) -> bytes:
    """Deterministic map-entry order as protobuf's (upb) encoder writes it:
    bytewise on the UTF-8 keys, a key before every prefix of itself (so
    the empty key comes last). 0xFF never occurs in UTF-8, so it sorts
    after any continuation."""
    return key.encode("utf-8") + b"\xff"


def _nondefault(kind: str, x) -> bool:
    if kind in ("float", "double"):
        # -0.0 is not the default: protobuf compares the bits
        return x != 0.0 or math.copysign(1.0, x) < 0
    if kind == "bytes":
        return len(x) > 0
    return bool(x)


def _encode_scalar(out: list, f: _Field, kind: str, x) -> int:
    out.append(f.tag)
    if kind == "string":
        b = x.encode("utf-8")
        ln = _varint(len(b))
        out.append(ln)
        out.append(b)
        return len(f.tag) + len(ln) + len(b)
    if kind == "bytes":
        ln = _varint(len(x))
        out.append(ln)
        out.append(x)
        return len(f.tag) + len(ln) + len(x)
    body = _scalar_bytes(kind, x)
    out.append(body)
    return len(f.tag) + len(body)


def _scalar_bytes(kind: str, x) -> bytes:
    if kind == "double":
        return struct.pack("<d", x)
    if kind == "float":
        return struct.pack("<f", x)
    if kind == "bool":
        return b"\x01" if x else b"\x00"
    return _varint(int(x))


def _packed(f: _Field, items) -> bytes:
    if f.kind == "double":
        return struct.pack(f"<{len(items)}d", *map(float, items))
    if f.kind == "float":
        return struct.pack(f"<{len(items)}f", *map(float, items))
    if f.kind == "bool":
        return bytes(1 if x else 0 for x in items)
    return b"".join(_varint(_check_scalar(f, f.kind, x)) for x in items)


def _read_scalar(kind: str, view, pos: int, end: int):
    if kind == "double":
        if pos + 8 > end:
            raise DecodeError("truncated double")
        return struct.unpack_from("<d", view, pos)[0], pos + 8
    if kind == "float":
        if pos + 4 > end:
            raise DecodeError("truncated float")
        return struct.unpack_from("<f", view, pos)[0], pos + 4
    raw, pos = _read_varint(view, pos, end)
    if kind == "bool":
        return raw != 0, pos
    if kind == "int64":
        return (raw - (1 << 64) if raw >= 1 << 63 else raw), pos
    if kind in ("int32", "enum"):
        raw &= 0xFFFFFFFF
        return (raw - (1 << 32) if raw >= 1 << 31 else raw), pos
    if kind == "uint32":
        return raw & 0xFFFFFFFF, pos
    return raw & _MASK64, pos


def _skip(view, pos: int, end: int, wire: int, number: int) -> int:
    """Skip one unknown field's payload (a group up to its matching end)."""
    if wire == _VARINT:
        return _read_varint(view, pos, end)[1]
    if wire == _I64:
        pos += 8
    elif wire == _I32:
        pos += 4
    elif wire == _LEN:
        ln, pos = _read_varint(view, pos, end)
        pos += ln
    elif wire == _SGROUP:
        while True:
            if pos >= end:
                raise DecodeError(f"group {number} has no end")
            key, pos = _read_varint(view, pos, end)
            if key & 7 == _EGROUP:
                if key >> 3 != number:
                    raise DecodeError(f"group {number} closed by {key >> 3}")
                return pos
            pos = _skip(view, pos, end, key & 7, key >> 3)
    else:
        raise DecodeError(f"invalid wire type {wire}")
    if pos > end:
        raise DecodeError("truncated field")
    return pos


def _decode_entry(msg: Message, f: _Field, view, pos: int, stop: int) -> None:
    """One map entry (key = 1, value = 2; either may be absent, and the
    last of a repeated key wins)."""
    key = ""
    val = None
    while pos < stop:
        tag, pos = _read_varint(view, pos, stop)
        number, wire = tag >> 3, tag & 7
        if number == 1 and wire == _LEN:
            ln, pos = _read_varint(view, pos, stop)
            try:
                key = str(view[pos:pos + ln], "utf-8")
            except UnicodeDecodeError as e:
                raise DecodeError(f"map {f.name}: invalid UTF-8 key") from e
            pos += ln
        elif number == 2 and wire == _LEN:
            ln, pos = _read_varint(view, pos, stop)
            if f.kind == "message":
                val = f.msg()
                val._decode(view, pos, pos + ln)
            else:
                try:
                    val = str(view[pos:pos + ln], "utf-8")
                except UnicodeDecodeError as e:
                    raise DecodeError(f"map {f.name}: invalid UTF-8 value") from e
            pos += ln
        else:
            pos = _skip(view, pos, stop, wire, number)
    if pos != stop:
        raise DecodeError(f"map {f.name}: entry overruns its length")
    target = getattr(msg, f.name)
    if val is None:
        val = f.msg() if f.kind == "message" else ""
    dict.__setitem__(target, key, val)


def _message(name: str, fields: list[_Field], namespace: dict | None = None) -> type:
    fields = sorted(fields, key=lambda f: f.number)
    attrs = {
        "__slots__": (),
        "_FIELDS": tuple(fields),
        "_BY_NAME": {f.name: f for f in fields},
        "_BY_NUMBER": {f.number: f for f in fields},
    }
    attrs.update(namespace or {})
    return type(name, (Message,), attrs)


def _params(number: int) -> _Field:
    return _Field(number, "parameters", "message", "map", msg=InferParameter)


F = _Field

# -- DataType --------------------------------------------------------------------

TYPE_INVALID = 0
TYPE_BOOL = 1
TYPE_UINT8 = 2
TYPE_UINT16 = 3
TYPE_UINT32 = 4
TYPE_UINT64 = 5
TYPE_INT8 = 6
TYPE_INT16 = 7
TYPE_INT32 = 8
TYPE_INT64 = 9
TYPE_FP16 = 10
TYPE_FP32 = 11
TYPE_FP64 = 12
TYPE_STRING = 13
TYPE_BF16 = 14

# -- the messages of kserve_v2.proto, in its order ----------------------------------

ServerLiveRequest = _message("ServerLiveRequest", [])
ServerLiveResponse = _message("ServerLiveResponse", [F(1, "live", "bool")])
ServerReadyRequest = _message("ServerReadyRequest", [])
ServerReadyResponse = _message("ServerReadyResponse", [F(1, "ready", "bool")])
ModelReadyRequest = _message("ModelReadyRequest", [F(1, "name", "string"),
                                                   F(2, "version", "string")])
ModelReadyResponse = _message("ModelReadyResponse", [F(1, "ready", "bool")])
ServerMetadataRequest = _message("ServerMetadataRequest", [])
ServerMetadataResponse = _message("ServerMetadataResponse", [
    F(1, "name", "string"), F(2, "version", "string"),
    F(3, "extensions", "string", "repeated"),
])
ModelMetadataRequest = _message("ModelMetadataRequest", [F(1, "name", "string"),
                                                         F(2, "version", "string")])
_TensorMetadata = _message("TensorMetadata", [
    F(1, "name", "string"), F(2, "datatype", "string"), F(3, "shape", "int64", "repeated"),
])
ModelMetadataResponse = _message("ModelMetadataResponse", [
    F(1, "name", "string"), F(2, "versions", "string", "repeated"),
    F(3, "platform", "string"),
    F(4, "inputs", "message", "repeated", msg=_TensorMetadata),
    F(5, "outputs", "message", "repeated", msg=_TensorMetadata),
], {"TensorMetadata": _TensorMetadata})
InferParameter = _message("InferParameter", [
    F(1, "bool_param", "bool", oneof="parameter_choice"),
    F(2, "int64_param", "int64", oneof="parameter_choice"),
    F(3, "string_param", "string", oneof="parameter_choice"),
    F(4, "double_param", "double", oneof="parameter_choice"),
    F(5, "uint64_param", "uint64", oneof="parameter_choice"),
])
InferTensorContents = _message("InferTensorContents", [
    F(1, "bool_contents", "bool", "repeated"),
    F(2, "int_contents", "int32", "repeated"),
    F(3, "int64_contents", "int64", "repeated"),
    F(4, "uint_contents", "uint32", "repeated"),
    F(5, "uint64_contents", "uint64", "repeated"),
    F(6, "fp32_contents", "float", "repeated"),
    F(7, "fp64_contents", "double", "repeated"),
    F(8, "bytes_contents", "bytes", "repeated"),
])
_InferInputTensor = _message("InferInputTensor", [
    F(1, "name", "string"), F(2, "datatype", "string"), F(3, "shape", "int64", "repeated"),
    _params(4), F(5, "contents", "message", msg=InferTensorContents),
])
_InferRequestedOutputTensor = _message("InferRequestedOutputTensor", [
    F(1, "name", "string"), _params(2),
])
ModelInferRequest = _message("ModelInferRequest", [
    F(1, "model_name", "string"), F(2, "model_version", "string"), F(3, "id", "string"),
    _params(4),
    F(5, "inputs", "message", "repeated", msg=_InferInputTensor),
    F(6, "outputs", "message", "repeated", msg=_InferRequestedOutputTensor),
    F(7, "raw_input_contents", "bytes", "repeated", view=True),
], {"InferInputTensor": _InferInputTensor,
    "InferRequestedOutputTensor": _InferRequestedOutputTensor})
_InferOutputTensor = _message("InferOutputTensor", [
    F(1, "name", "string"), F(2, "datatype", "string"), F(3, "shape", "int64", "repeated"),
    _params(4), F(5, "contents", "message", msg=InferTensorContents),
])
ModelInferResponse = _message("ModelInferResponse", [
    F(1, "model_name", "string"), F(2, "model_version", "string"), F(3, "id", "string"),
    _params(4),
    F(5, "outputs", "message", "repeated", msg=_InferOutputTensor),
    F(6, "raw_output_contents", "bytes", "repeated", view=True),
], {"InferOutputTensor": _InferOutputTensor})
ModelStreamInferResponse = _message("ModelStreamInferResponse", [
    F(1, "error_message", "string"),
    F(2, "infer_response", "message", msg=ModelInferResponse),
])
ModelConfigRequest = _message("ModelConfigRequest", [F(1, "name", "string"),
                                                     F(2, "version", "string")])
ModelInput = _message("ModelInput", [
    F(1, "name", "string"), F(2, "data_type", "enum"), F(4, "dims", "int64", "repeated"),
])
ModelOutput = _message("ModelOutput", [
    F(1, "name", "string"), F(2, "data_type", "enum"), F(3, "dims", "int64", "repeated"),
])
ModelConfig = _message("ModelConfig", [
    F(1, "name", "string"), F(2, "platform", "string"), F(4, "max_batch_size", "int32"),
    F(5, "input", "message", "repeated", msg=ModelInput),
    F(6, "output", "message", "repeated", msg=ModelOutput),
    F(7, "parameters", "string", "map"),
])
ModelConfigResponse = _message("ModelConfigResponse", [
    F(1, "config", "message", msg=ModelConfig),
])
RepositoryIndexRequest = _message("RepositoryIndexRequest", [
    F(1, "repository_name", "string"), F(2, "ready", "bool"),
])
_ModelIndex = _message("ModelIndex", [
    F(1, "name", "string"), F(2, "version", "string"), F(3, "state", "string"),
    F(4, "reason", "string"),
])
RepositoryIndexResponse = _message("RepositoryIndexResponse", [
    F(1, "models", "message", "repeated", msg=_ModelIndex),
], {"ModelIndex": _ModelIndex})
SystemSharedMemoryStatusRequest = _message("SystemSharedMemoryStatusRequest",
                                           [F(1, "name", "string")])
_RegionStatus = _message("RegionStatus", [
    F(1, "name", "string"), F(2, "key", "string"), F(3, "offset", "uint64"),
    F(4, "byte_size", "uint64"),
])
SystemSharedMemoryStatusResponse = _message("SystemSharedMemoryStatusResponse", [
    F(1, "regions", "message", "map", msg=_RegionStatus),
], {"RegionStatus": _RegionStatus})
SystemSharedMemoryRegisterRequest = _message("SystemSharedMemoryRegisterRequest", [
    F(1, "name", "string"), F(2, "key", "string"), F(3, "offset", "uint64"),
    F(4, "byte_size", "uint64"),
])
SystemSharedMemoryRegisterResponse = _message("SystemSharedMemoryRegisterResponse", [])
SystemSharedMemoryUnregisterRequest = _message("SystemSharedMemoryUnregisterRequest",
                                               [F(1, "name", "string")])
SystemSharedMemoryUnregisterResponse = _message("SystemSharedMemoryUnregisterResponse", [])

del F
