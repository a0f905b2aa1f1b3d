"""Minimal ONNX weight reader, no ``onnx`` package (the port's copy of
``runtime/onnx_reader.py``; bfloat16 tensors come back as ``config.BF16``
words, since the port does not import ``ml_dtypes``).

The reference serves .onnx artifacts straight from the Triton model
repository (examples/YOLOv5/config.pbtxt:2 'platform:
"onnxruntime_onnx"'; deploy.sh converts .pth -> .onnx before pushing).
To import those same artifacts without the onnx pip package, this
module hand-parses the protobuf wire format —
ONNX ModelProto is plain proto3, and for weights we only need:

  ModelProto.graph (field 7) -> GraphProto.initializer (field 5, repeated
  TensorProto) -> {name (8), dims (1), data_type (2), raw_data (9) or
  the typed *_data arrays (4/5/7/10/11)}.

Wire format: each record is a varint key (field_no << 3 | wire_type);
wire types used by ONNX are 0 (varint), 1 (64-bit), 2 (length-
delimited), 5 (32-bit).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from triton_client_tpu_torch.config import BF16
from triton_client_tpu_torch.runtime.precision import to_bf16_words

# TensorProto.DataType enum -> numpy dtype (bfloat16: BF16 words).
_ONNX_DTYPES: dict[int, object] = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}
_BFLOAT16 = 16


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: memoryview) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over one message's bytes.
    Length-delimited values come back as memoryviews (zero-copy)."""
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value = bytes(buf[pos:pos + 8])
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            value = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, value


def _packed_varints(value: object, wire: int) -> list[int]:
    """A repeated int field arrives either packed (one length-delimited
    blob) or as individual varint records."""
    if wire == 0:
        return [int(value)]  # type: ignore[arg-type]
    out = []
    pos = 0
    buf = value
    while pos < len(buf):  # type: ignore[arg-type]
        v, pos = _read_varint(buf, pos)  # type: ignore[arg-type]
        out.append(v)
    return out


def _unzigzag64(v: int) -> int:
    """ONNX dims are int64 varints (not zigzag); map 2^63.. to negative."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_tensor(buf: memoryview) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    data_type = 1
    name = ""
    raw: memoryview | None = None
    typed: dict[int, list[object]] = {}
    for field, wire, value in _iter_fields(buf):
        if field == 1:
            dims.extend(_unzigzag64(v) for v in _packed_varints(value, wire))
        elif field == 2:
            data_type = int(value)  # type: ignore[arg-type]
        elif field == 8:
            name = bytes(value).decode()  # type: ignore[arg-type]
        elif field == 9:
            raw = value  # type: ignore[assignment]
        elif field in (4, 10):  # float_data / double_data (packed f32/f64)
            typed.setdefault(field, []).append((value, wire))
        elif field in (5, 7, 11):  # int32/int64/uint64 (packed varints)
            typed.setdefault(field, []).append((value, wire))

    if data_type == _BFLOAT16:
        np_dtype = BF16
    elif data_type in _ONNX_DTYPES:
        np_dtype = np.dtype(_ONNX_DTYPES[data_type])
    else:
        raise ValueError(f"tensor '{name}': unsupported ONNX data_type {data_type}")

    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype.newbyteorder("<"))
    elif typed:
        field, chunks = next(iter(typed.items()))
        if field in (4, 10):
            width = np.float32 if field == 4 else np.float64
            parts = [
                np.frombuffer(v, dtype=np.dtype(width).newbyteorder("<"))
                if w == 2
                else np.frombuffer(bytes(v), dtype=width)
                for v, w in chunks
            ]
            arr = np.concatenate(parts)
            arr = to_bf16_words(arr) if np_dtype == BF16 else arr.astype(np_dtype)
        else:
            ints: list[int] = []
            for v, w in chunks:
                ints.extend(_packed_varints(v, w))
            # Varints arrive as raw unsigned 64-bit patterns: negatives
            # are sign-extended (10-byte) encodings, and fp16/bf16 in
            # int32_data are IEEE bit patterns per the ONNX spec — both
            # need reinterpretation, not numeric conversion.
            u64 = np.asarray(ints, dtype=np.uint64)
            if np_dtype.kind == "f" or data_type == _BFLOAT16:
                arr = u64.astype(np.uint16).view(np_dtype)
            elif np_dtype.kind == "i":
                arr = u64.view(np.int64).astype(np_dtype)
            else:  # unsigned / bool
                arr = u64.astype(np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def read_onnx_initializers(path_or_bytes) -> dict[str, np.ndarray]:
    """Parse an .onnx file's graph initializers into {name: ndarray}.

    Raises on external-data tensors (field 13/14) implicitly: those
    tensors carry no raw_data and come back empty — callers converting
    real weights will fail shape checks loudly rather than silently.
    """
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        blob = memoryview(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            blob = memoryview(f.read())

    out: dict[str, np.ndarray] = {}
    for field, _, value in _iter_fields(blob):
        if field == 7:  # ModelProto.graph
            for gfield, _, gvalue in _iter_fields(value):  # type: ignore[arg-type]
                if gfield == 5:  # GraphProto.initializer
                    name, arr = _parse_tensor(gvalue)  # type: ignore[arg-type]
                    out[name] = arr
    return out


def onnx_to_state_dict(initializers: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Normalize ONNX initializer names to torch state_dict style so the
    checkpoint name maps apply unchanged: exporters (torch.onnx, the
    reference's deploy.sh path) name initializers after the module
    parameters ('model.0.conv.weight'); strip any leading '/' graph
    scoping some exporters add."""
    return {k.lstrip("/").replace("::", "."): v for k, v in initializers.items()}
