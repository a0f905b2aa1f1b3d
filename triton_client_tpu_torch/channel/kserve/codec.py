"""numpy <-> KServe v2 raw tensor codec, zero-copy where possible (the
port's copy of ``channel/kserve/codec.py``, over the port's own ``pb``).

Both directions are single buffer views: ``np.frombuffer`` over the
message's ``memoryview`` slices on receive (no copy; the message bytes
own the memory) and ``ndarray.tobytes()`` on send. Datatype strings
follow the KServe v2 table of ``config._DTYPES``. BF16 travels as uint16
words, little-endian; numpy has no bfloat16 (the JAX package takes it from
``ml_dtypes``), so on this side a BF16 tensor is an array of
``config.BF16`` words (``runtime/precision.py``).
"""

from __future__ import annotations

import numpy as np

from triton_client_tpu_torch.channel.kserve import pb
from triton_client_tpu_torch.config import BF16, config_dtypes
from triton_client_tpu_torch.runtime import faults

# KServe v2 datatype string <-> numpy dtype (little-endian wire order);
# BF16 is the one special case, the words dtype
_TO_NP: dict[str, np.dtype] = {
    k: (BF16 if v is None else np.dtype(v)) for k, v in config_dtypes().items()
}
_FROM_NP = {v: k for k, v in _TO_NP.items()}

_CONFIG_DTYPE = {
    "BOOL": pb.TYPE_BOOL,
    "UINT8": pb.TYPE_UINT8,
    "UINT16": pb.TYPE_UINT16,
    "UINT32": pb.TYPE_UINT32,
    "UINT64": pb.TYPE_UINT64,
    "INT8": pb.TYPE_INT8,
    "INT16": pb.TYPE_INT16,
    "INT32": pb.TYPE_INT32,
    "INT64": pb.TYPE_INT64,
    "FP16": pb.TYPE_FP16,
    "FP32": pb.TYPE_FP32,
    "FP64": pb.TYPE_FP64,
    "BF16": pb.TYPE_BF16,
}


def datatype_of(arr: np.ndarray) -> str:
    if arr.dtype == BF16:
        return "BF16"
    dtype = arr.dtype.newbyteorder("=")
    if dtype not in _FROM_NP:
        raise ValueError(f"unsupported wire dtype {arr.dtype}")
    return _FROM_NP[dtype]


def config_datatype(datatype: str) -> int:
    return _CONFIG_DTYPE.get(datatype, pb.TYPE_INVALID)


def serialize_tensor(arr: np.ndarray) -> bytes:
    """Array -> little-endian raw bytes (C order)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    return arr.tobytes()


def deserialize_tensor(raw, datatype: str, shape) -> np.ndarray:
    """Raw bytes -> array view over the buffer (zero copy)."""
    if datatype not in _TO_NP:
        raise ValueError(f"unsupported wire datatype '{datatype}'")
    arr = np.frombuffer(raw, dtype=_TO_NP[datatype])
    return arr.reshape(tuple(int(d) for d in shape))


def set_request_params(msg, params: dict | None) -> None:
    """Write request/response-level ``parameters`` (str -> str/int/bool)
    onto a ModelInfer message: the trace context (``traceparent``),
    priorities and span summaries travel here."""
    if not params:
        return
    for key, value in params.items():
        if isinstance(value, bool):
            msg.parameters[key].bool_param = value
        elif isinstance(value, int):
            msg.parameters[key].int64_param = value
        else:
            msg.parameters[key].string_param = str(value)


def get_string_param(msg, key: str) -> str | None:
    """Presence-checked read of a string parameter (bracket access on a
    map inserts a default entry: never subscript blind)."""
    p = msg.parameters
    if key not in p:
        return None
    return p[key].string_param or None


def get_int_param(msg, key: str, default: int = 0) -> int:
    p = msg.parameters
    if key not in p:
        return default
    return int(p[key].int64_param)


def get_bool_param(msg, key: str, default: bool = False) -> bool:
    p = msg.parameters
    if key not in p:
        return default
    return bool(p[key].bool_param)


# streaming-session sequence parameters (Triton's sequence-batcher names)
SEQUENCE_ID_PARAM = "sequence_id"
SEQUENCE_START_PARAM = "sequence_start"
SEQUENCE_END_PARAM = "sequence_end"

# multi-frame streaming: one ModelStreamInfer message carries a packed
# group of G equal-shape frames along the leading axis; the server fans
# them into single requests and streams one response per frame
STREAM_GROUP_PARAM = "stream_group"
STREAM_GROUP_IDS_PARAM = "stream_group_ids"


def _add_inputs(req, inputs, input_parameters, shm_inputs=None) -> None:
    # sorted: the wire pairs inputs and raw_input_contents by position
    for name in sorted(inputs):
        arr = np.asarray(inputs[name])
        t = req.inputs.add(name=name, datatype=datatype_of(arr), shape=arr.shape)
        if input_parameters and name in input_parameters:
            set_request_params(t, input_parameters[name])
        target = (shm_inputs or {}).get(name)
        if target is None:
            req.raw_input_contents.append(serialize_tensor(arr))
        else:
            set_shm_params(t, *target)


def build_infer_request(
    model_name: str,
    inputs: dict[str, np.ndarray],
    model_version: str = "",
    request_id: str = "",
    parameters: dict | None = None,
    input_parameters: dict[str, dict] | None = None,
) -> pb.ModelInferRequest:
    """``input_parameters`` maps input name -> per-tensor parameters."""
    req = pb.ModelInferRequest(model_name=model_name, model_version=model_version, id=request_id)
    set_request_params(req, parameters)
    _add_inputs(req, inputs, input_parameters)
    return req


def build_infer_request_shm(
    model_name: str,
    inputs: dict[str, np.ndarray],
    shm_inputs: dict[str, tuple[str, int, int]],
    model_version: str = "",
    request_id: str = "",
    parameters: dict | None = None,
    input_parameters: dict[str, dict] | None = None,
) -> pb.ModelInferRequest:
    """Like :func:`build_infer_request`, but inputs named in ``shm_inputs``
    (name -> (region, offset, byte_size)) travel as shared-memory
    parameters with no raw content."""
    req = pb.ModelInferRequest(model_name=model_name, model_version=model_version, id=request_id)
    set_request_params(req, parameters)
    _add_inputs(req, inputs, input_parameters, shm_inputs)
    return req


def shm_params(tensor) -> tuple[str, int, int] | None:
    """(region, offset, byte_size) when a tensor's parameters ask for
    shared-memory transport (Triton system-shared-memory extension); None
    for wire tensors."""
    p = tensor.parameters
    if "shared_memory_region" not in p:
        return None
    region = p["shared_memory_region"].string_param
    byte_size = (
        int(p["shared_memory_byte_size"].int64_param) if "shared_memory_byte_size" in p else 0
    )
    offset = int(p["shared_memory_offset"].int64_param) if "shared_memory_offset" in p else 0
    if not region or byte_size <= 0 or offset < 0:
        raise ValueError(
            "shared-memory tensor parameters need a region name, a positive byte_size, and "
            f"a non-negative offset (got {region!r}, {byte_size}, {offset})"
        )
    return region, offset, byte_size


def set_shm_params(tensor, region: str, offset: int, byte_size: int) -> None:
    tensor.parameters["shared_memory_region"].string_param = region
    tensor.parameters["shared_memory_byte_size"].int64_param = byte_size
    if offset:
        tensor.parameters["shared_memory_offset"].int64_param = offset


def parse_infer_request(req: pb.ModelInferRequest, shm=None) -> dict[str, np.ndarray]:
    """Wire -> arrays. Inputs with shared-memory parameters are read from
    ``shm`` (a registry with ``read(name, offset, byte_size)``) and take no
    raw_input_contents slot; the port's server passes none."""
    faults.probe("codec_decode", req.model_name)
    wire_inputs = [t for t in req.inputs if shm_params(t) is None]
    if len(req.raw_input_contents) != len(wire_inputs):
        raise ValueError(
            f"{len(wire_inputs)} wire input tensors but "
            f"{len(req.raw_input_contents)} raw buffers"
        )
    raws = iter(req.raw_input_contents)
    out = {}
    for t in req.inputs:
        region = shm_params(t)
        if region is None:
            out[t.name] = deserialize_tensor(next(raws), t.datatype, t.shape)
            continue
        if shm is None:
            raise ValueError(
                f"input {t.name!r} requests shared-memory transport but this server has no "
                "shared-memory registry"
            )
        name, offset, byte_size = region
        out[t.name] = deserialize_tensor(shm.read(name, offset, byte_size), t.datatype, t.shape)
    return out


def build_infer_response(
    model_name: str,
    outputs: dict[str, np.ndarray],
    model_version: str = "",
    request_id: str = "",
    parameters: dict | None = None,
) -> pb.ModelInferResponse:
    """Arrays -> a response with every output as raw content. (The JAX
    codec's shared-memory output placement waits for the shared-memory
    registry, ROADMAP.md Queue 1 item 8.)"""
    resp = pb.ModelInferResponse(model_name=model_name, model_version=model_version, id=request_id)
    set_request_params(resp, parameters)
    for name in sorted(outputs):
        arr = np.asarray(outputs[name])
        resp.outputs.add(name=name, datatype=datatype_of(arr), shape=arr.shape)
        resp.raw_output_contents.append(serialize_tensor(arr))
    return resp


def parse_infer_response(resp: pb.ModelInferResponse, regions=None) -> dict[str, np.ndarray]:
    """Wire -> arrays. Outputs with shared-memory coordinates are read from
    ``regions`` (output or region name -> a region with ``read(offset,
    byte_size)``)."""
    wire_outputs = [t for t in resp.outputs if shm_params(t) is None]
    if len(resp.raw_output_contents) != len(wire_outputs):
        raise ValueError(
            f"{len(wire_outputs)} wire output tensors but "
            f"{len(resp.raw_output_contents)} raw buffers"
        )
    raws = iter(resp.raw_output_contents)
    out = {}
    for t in resp.outputs:
        target = shm_params(t)
        if target is None:
            out[t.name] = deserialize_tensor(next(raws), t.datatype, t.shape)
            continue
        name, offset, byte_size = target
        region = (regions or {}).get(name) or (regions or {}).get(t.name)
        if region is None:
            raise ValueError(
                f"response output {t.name!r} lives in shared-memory region {name!r} but no "
                "matching client region was provided"
            )
        out[t.name] = deserialize_tensor(region.read(offset, byte_size), t.datatype, t.shape)
    return out
