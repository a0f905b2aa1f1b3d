"""The port's KServe v2 messages (``channel/kserve/pb.py``, written without
protobuf) and codec against the JAX package's generated ``kserve_v2_pb2``
and codec: on every message of ``kserve_v2.proto``, with seeded field
values (negative int64s and enums, empty strings and bytes, -0.0, maps,
oneofs at their defaults, nested messages), the port's bytes equal
``SerializeToString(deterministic=True)`` and each side parses the other's.
Unknown fields of every wire type are skipped; repeated scalars are read
packed and unpacked.
"""

import math

import numpy as np
import pytest
from google.protobuf.descriptor import FieldDescriptor as FD

from triton_client_tpu.channel.kserve import codec as jcodec
from triton_client_tpu.channel.kserve import pb as J

from triton_client_tpu_torch.channel.kserve import codec, pb as P
from triton_client_tpu_torch.config import config_dtypes
from torch_threads import one_torch_thread  # noqa: F401


def _message_paths():
    """(dotted path, JAX class, port class) for every message of the proto."""
    out = []

    def walk(desc, jcls, pcls, path):
        out.append((path, jcls, pcls))
        for nested in desc.nested_types:
            if nested.GetOptions().map_entry:
                continue
            walk(nested, getattr(jcls, nested.name), getattr(pcls, nested.name),
                 f"{path}.{nested.name}")

    for name, desc in J.DESCRIPTOR.message_types_by_name.items():
        walk(desc, getattr(J, name), getattr(P, name), name)
    return out


MESSAGES = _message_paths()


def _scalar(rng, ftype):
    pick = rng.integers(0, 4)
    if ftype == FD.TYPE_BOOL:
        return bool(rng.integers(0, 2))
    if ftype in (FD.TYPE_INT64, FD.TYPE_SINT64, FD.TYPE_SFIXED64):
        return [0, -1, -(1 << 63), int(rng.integers(-(1 << 62), 1 << 62))][pick]
    if ftype in (FD.TYPE_UINT64, FD.TYPE_FIXED64):
        return [0, (1 << 64) - 1, 300, int(rng.integers(0, 1 << 62))][pick]
    if ftype == FD.TYPE_INT32:
        return [0, -1, (1 << 31) - 1, int(rng.integers(-(1 << 31), 1 << 31))][pick]
    if ftype == FD.TYPE_UINT32:
        return [0, (1 << 32) - 1, 127, int(rng.integers(0, 1 << 32))][pick]
    if ftype == FD.TYPE_ENUM:
        return [0, -3, 14, 11][pick]
    if ftype == FD.TYPE_DOUBLE:
        return [0.0, -0.0, math.inf, float(rng.normal() * 1e6)][pick]
    if ftype == FD.TYPE_FLOAT:
        return [0.0, -0.0, 1.5, float(np.float32(rng.normal() * 1e3))][pick]
    if ftype == FD.TYPE_STRING:
        return ["", "a", "grüße ✓", "x" * int(rng.integers(1, 200))][pick]
    if ftype == FD.TYPE_BYTES:
        return [b"", b"\x00", bytes(rng.integers(0, 256, 300, dtype=np.uint8)), b"abc"][pick]
    raise AssertionError(ftype)


def _fill(jmsg, pmsg, rng, depth=0):
    """Set the same seeded values on a JAX message and a port message."""
    oneofs = set()
    for f in jmsg.DESCRIPTOR.fields:
        if f.containing_oneof is not None:
            if f.containing_oneof.name in oneofs or rng.random() < 0.4:
                continue
            oneofs.add(f.containing_oneof.name)
        if rng.random() < 0.2:
            continue  # left unset
        jf, pf = getattr(jmsg, f.name), getattr(pmsg, f.name)
        is_map = f.message_type is not None and f.message_type.GetOptions().map_entry
        if is_map:
            value_f = f.message_type.fields_by_name["value"]
            for k in ["", "b", "a", f"k{rng.integers(0, 9)}"][: int(rng.integers(1, 5))]:
                if value_f.message_type is not None:
                    _fill(jf[k], pf[k], rng, depth + 1)
                else:
                    v = _scalar(rng, value_f.type)
                    jf[k] = v
                    pf[k] = v
        elif f.is_repeated:
            for _ in range(int(rng.integers(0, 4))):
                if f.message_type is not None:
                    _fill(jf.add(), pf.add(), rng, depth + 1)
                else:
                    v = _scalar(rng, f.type)
                    jf.append(v)
                    pf.append(v)
        elif f.message_type is not None:
            if depth < 3:
                _fill(jf, pf, rng, depth + 1)
        else:
            v = _scalar(rng, f.type)
            setattr(jmsg, f.name, v)
            setattr(pmsg, f.name, v)


def _pair(jcls, pcls, seed):
    rng = np.random.default_rng(seed)
    jmsg, pmsg = jcls(), pcls()
    _fill(jmsg, pmsg, rng)
    return jmsg, pmsg


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("path,jcls,pcls", MESSAGES, ids=[m[0] for m in MESSAGES])
def test_bytes_equal_protobuf_and_each_side_parses_the_other(path, jcls, pcls, seed):
    jmsg, pmsg = _pair(jcls, pcls, seed)
    want = jmsg.SerializeToString(deterministic=True)
    got = pmsg.SerializeToString()
    assert got == want
    assert pcls.FromString(want).SerializeToString() == want
    assert jcls.FromString(got).SerializeToString(deterministic=True) == got


# one unknown field of each wire type (field 99; 98 a group with a nested
# varint), appended to a message: varint, fixed64, length-delimited, group,
# fixed32
UNKNOWN = (bytes.fromhex("98069601") + bytes.fromhex("99060102030405060708")
           + bytes.fromhex("9a0603616263") + bytes.fromhex("930608079406")
           + bytes.fromhex("9d0601020304"))


@pytest.mark.parametrize("path,jcls,pcls", MESSAGES, ids=[m[0] for m in MESSAGES])
def test_unknown_fields_of_every_wire_type_are_skipped(path, jcls, pcls):
    jmsg, _ = _pair(jcls, pcls, 7)
    known = jmsg.SerializeToString(deterministic=True)
    data = UNKNOWN + known + UNKNOWN
    theirs = jcls.FromString(data)
    theirs.DiscardUnknownFields()
    assert theirs.SerializeToString(deterministic=True) == known
    assert pcls.FromString(data).SerializeToString() == known


def test_unpacked_repeated_scalars_are_read():
    """``shape`` as unpacked varints (what a proto2 writer sends), negative
    dims included, and a packed run split in two."""
    unpacked = bytes.fromhex("0a0178" "1801" "18ffffffffffffffffff01" "1803")
    split = bytes.fromhex("0a0178" "1a020102" "1a0103")
    for data, want in ((unpacked, [1, -1, 3]), (split, [1, 2, 3])):
        t = P.ModelInferRequest.InferInputTensor.FromString(data)
        assert list(t.shape) == want == list(J.ModelInferRequest.InferInputTensor.FromString(
            data).shape)


def test_oneof_member_at_its_default_is_written():
    for kw in ({"bool_param": False}, {"int64_param": 0}, {"string_param": ""},
               {"double_param": 0.0}, {"uint64_param": 0}):
        assert P.InferParameter(**kw).SerializeToString() == \
            J.InferParameter(**kw).SerializeToString(deterministic=True) != b""
    p = P.InferParameter(int64_param=3)
    p.string_param = "x"  # setting one member clears the other
    assert p.WhichOneof("parameter_choice") == "string_param"
    assert p.int64_param == 0
    assert p.SerializeToString() == J.InferParameter(string_param="x").SerializeToString()


def test_raw_contents_decode_as_views_of_the_message():
    req = J.ModelInferRequest(model_name="m", raw_input_contents=[b"", b"\x01\x02\x03\x04"])
    data = req.SerializeToString(deterministic=True)
    got = P.ModelInferRequest.FromString(data)
    assert [type(r) for r in got.raw_input_contents] == [memoryview, memoryview]
    assert [bytes(r) for r in got.raw_input_contents] == [b"", b"\x01\x02\x03\x04"]
    arr = np.frombuffer(got.raw_input_contents[1], np.uint8)
    assert np.shares_memory(arr, np.frombuffer(data, np.uint8))


def test_submessage_presence_follows_protobuf():
    for m in (P, J):
        read = m.ModelStreamInferResponse()
        read.infer_response  # noqa: B018 (a read does not make it present)
        assert read.SerializeToString() == b""
        set_default = m.ModelStreamInferResponse()
        set_default.infer_response.id = ""  # an assignment does, even of a default
        assert set_default.SerializeToString() == b"\x12\x00"
        filled = m.ModelMetadataResponse()
        filled.inputs.add().shape.extend([1, -2])
        assert m.ModelConfigResponse(config=m.ModelConfig()).SerializeToString() == b"\x0a\x00"
    j = J.ModelInferRequest()
    p = P.ModelInferRequest()
    for msg in (j, p):
        msg.inputs.add(name="x").contents.fp32_contents.extend([1.5, -0.0])
    assert p.SerializeToString() == j.SerializeToString(deterministic=True)


@pytest.mark.parametrize("data", [b"\x0a\x05ab", b"\x0a", b"\x08", b"\x0f\x00", b"\x0b\x08\x01",
                                  b"\x80" * 11 + b"\x01"])
def test_malformed_bytes_raise_decode_errors(data):
    from google.protobuf.message import DecodeError as PbDecodeError

    with pytest.raises(PbDecodeError):
        J.ModelInferRequest.FromString(data)
    with pytest.raises(P.DecodeError):
        P.ModelInferRequest.FromString(data)


def test_out_of_range_and_wrong_types_raise_as_protobuf():
    for m in (P, J):
        with pytest.raises(ValueError):
            m.ModelConfig(max_batch_size=1 << 31)
        with pytest.raises(TypeError):
            m.ModelReadyRequest(name=1)
        assert m.ModelReadyRequest(name=b"x").name == "x"
        with pytest.raises((TypeError, ValueError)):
            m.ModelMetadataResponse(noexist=1)


def test_type_constants_equal_the_enum():
    names = [n for n in dir(J) if n.startswith("TYPE_")]
    assert len(names) == 15
    for n in names:
        assert getattr(P, n) == getattr(J, n), n


# -- codec ---------------------------------------------------------------------


def _array(rng, dtype):
    if dtype == np.bool_:
        return rng.random((3, 5)) > 0.5
    if np.issubdtype(dtype, np.floating):
        return rng.normal(0, 10, (3, 5)).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -100), min(info.max, 100) + 1, (3, 5)).astype(dtype)


SERVED_DTYPES = [k for k, v in config_dtypes().items() if v is not None]


@pytest.mark.parametrize("datatype", SERVED_DTYPES)
def test_codec_roundtrip_every_config_dtype(rng, datatype):
    """As tests/test_grpc.py's matrix: bitwise round trip, a zero-copy
    view over the wire buffer, and the JAX codec's bytes."""
    arr = _array(rng, np.dtype(config_dtypes()[datatype]))
    assert codec.datatype_of(arr) == jcodec.datatype_of(arr) == datatype
    raw = codec.serialize_tensor(arr)
    assert raw == jcodec.serialize_tensor(arr)
    back = codec.deserialize_tensor(raw, datatype, arr.shape)
    np.testing.assert_array_equal(back.view(np.uint8), arr.view(np.uint8))
    assert not back.flags.writeable and np.shares_memory(back, np.frombuffer(raw, np.uint8))


def test_bf16_round_trips_as_words_with_the_jax_codecs_bytes(rng):
    """BF16 travels as little-endian 16-bit words: the port's words serialize to
    the JAX codec's bytes for the same ml_dtypes array, each side reads the
    other's, and the words come back as a zero-copy view."""
    import ml_dtypes

    from triton_client_tpu_torch.config import BF16
    from triton_client_tpu_torch.runtime.precision import bf16_words_to_f32, to_bf16_words

    x = rng.normal(0, 10, (3, 5)).astype(np.float32)
    words = to_bf16_words(x)
    jarr = x.astype(ml_dtypes.bfloat16)
    assert codec.datatype_of(words) == jcodec.datatype_of(jarr) == "BF16"
    raw = codec.serialize_tensor(words)
    assert raw == jcodec.serialize_tensor(jarr)
    back = codec.deserialize_tensor(raw, "BF16", words.shape)
    assert back.dtype == BF16 and np.shares_memory(back, np.frombuffer(raw, np.uint8))
    np.testing.assert_array_equal(back.view(np.uint16), words.view(np.uint16))
    jback = jcodec.deserialize_tensor(raw, "BF16", words.shape)
    np.testing.assert_array_equal(jback.astype(np.float32), bf16_words_to_f32(back))
    assert codec.config_datatype("BF16") == P.TYPE_BF16 == J.TYPE_BF16
    assert "BF16" not in SERVED_DTYPES  # the table keeps None, as the JAX one


def test_requests_and_responses_cross_the_packages(rng):
    inputs = {"images": rng.random((2, 8, 8, 3)).astype(np.float32),
              "count": np.array([7], np.int32), "empty": np.zeros((0, 4), np.float32)}
    params = {"traceparent": "00-a-b-01", "priority": -2, "sequence_end": True}
    got = codec.build_infer_request("m", inputs, "3", "42", parameters=params)
    want = jcodec.build_infer_request("m", inputs, "3", "42", parameters=params)
    assert got.SerializeToString() == want.SerializeToString(deterministic=True)
    for parsed in (codec.parse_infer_request(P.ModelInferRequest.FromString(
            want.SerializeToString())), jcodec.parse_infer_request(J.ModelInferRequest.FromString(
                got.SerializeToString()))):
        assert set(parsed) == set(inputs)
        for k in inputs:
            np.testing.assert_array_equal(parsed[k], inputs[k])
    outputs = {"detections": rng.random((1, 3, 6)).astype(np.float32),
               "valid": np.array([[True, False, True]])}
    got = codec.build_infer_response("m", outputs, "1", "7", parameters={"trace_summary": "{}"})
    want = jcodec.build_infer_response("m", outputs, "1", "7", parameters={"trace_summary": "{}"})
    assert got.SerializeToString() == want.SerializeToString(deterministic=True)
    back = codec.parse_infer_response(P.ModelInferResponse.FromString(got.SerializeToString()))
    for k in outputs:
        np.testing.assert_array_equal(back[k], outputs[k])


def test_param_getters_check_presence_and_shm_params_agree():
    for m, c in ((P, codec), (J, jcodec)):
        req = m.ModelInferRequest()
        assert c.get_string_param(req, "x") is None and c.get_int_param(req, "x", 5) == 5
        assert not c.get_bool_param(req, "x") and "x" not in req.parameters
        t = req.inputs.add(name="a")
        c.set_shm_params(t, "region", 16, 64)
        assert c.shm_params(t) == ("region", 16, 64)
        c.set_shm_params(req.inputs.add(name="b"), "r", 0, 8)
    assert codec.build_infer_request_shm(
        "m", {"a": np.zeros(2, np.float32), "b": np.ones(2, np.float32)}, {"a": ("r", 0, 8)}
    ).SerializeToString() == jcodec.build_infer_request_shm(
        "m", {"a": np.zeros(2, np.float32), "b": np.ones(2, np.float32)}, {"a": ("r", 0, 8)}
    ).SerializeToString(deterministic=True)


def test_mismatched_raw_buffers_rejected():
    req = P.ModelInferRequest(model_name="m")
    req.inputs.add(name="x", datatype="FP32", shape=[1])
    with pytest.raises(ValueError, match="raw buffers"):
        codec.parse_infer_request(req)
