"""The port's KServe v2 server on ``device="cpu"`` against the JAX
package's, both on loopback, serving a tiny YOLOv5n (64x64, 2 classes)
and a tiny PointPillars (tests/test_torch_pointpillars.py's 64 x 64 pillar
grid) with the same flax variables (carried into the port by
``models/convert.py``), reached through the JAX package's ``GRPCChannel``.

Bars: the in-process paths' (tests/test_torch_detect2d.py: equal valid,
rows within 1e-3 relative / 1e-2 pixels; tests/test_torch_detect3d.py:
equal labels, boxes and scores within 1e-5). Health, metadata,
``ModelConfig`` (its JSON parameters included), ``RepositoryIndex``,
streaming and the status code of every error case agree, and so does
``message_limit``. By design the port's ``ServerMetadata`` names itself
and lists no ``system_shared_memory`` (its shared-memory RPCs answer
UNIMPLEMENTED), specs say ``platform: torch``, and every response
carries a ``trace_summary`` parameter.

The variables are a seeded fill of the flax tree's shapes
(``jax.eval_shape`` of the init), not ``PRNGKey(0)``'s: the init costs
more than the rest of the file.
"""

import json
import pathlib
import subprocess
import sys
import threading

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from triton_client_tpu.channel.base import InferRequest as JInferRequest
from triton_client_tpu.channel.grpc_channel import GRPCChannel as JGRPCChannel
from triton_client_tpu.channel.kserve import pb as jpb
from triton_client_tpu.channel.kserve import service as jservice
from triton_client_tpu.channel.tpu_channel import TPUChannel
from triton_client_tpu.config import ModelSpec as JModelSpec
from triton_client_tpu.config import TensorSpec as JTensorSpec
from triton_client_tpu.models import pointpillars as jpp
from triton_client_tpu.models.yolov5 import YoloV5 as JYoloV5
from triton_client_tpu.pipelines import detect2d as jdet2d
from triton_client_tpu.pipelines import detect3d as jdet3d
from triton_client_tpu.runtime import admission as jadm
from triton_client_tpu.runtime import faults as jfaults
from triton_client_tpu.runtime import server as jserver
from triton_client_tpu.runtime.repository import ModelRepository as JRepository

from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.channel.kserve import pb
from triton_client_tpu_torch.config import ModelSpec, TensorSpec
from triton_client_tpu_torch.obs.trace import SUMMARY_PARAM_KEY, decode_span_summary
from triton_client_tpu_torch.ops.cuda_build import KernelError
from triton_client_tpu_torch.pipelines import detect2d as tdet2d
from triton_client_tpu_torch.pipelines import detect3d as tdet3d
from triton_client_tpu_torch.runtime import admission as tadm
from triton_client_tpu_torch.runtime import faults as tfaults
from triton_client_tpu_torch.runtime import server as tserver
from triton_client_tpu_torch.runtime.repository import ModelRepository
from tests.test_torch_pointpillars import cloud, tiny_configs

ROOT = pathlib.Path(__file__).resolve().parent.parent
HW = (64, 64)
CFG_2D = dict(model_name="yolov5n", num_classes=2, input_hw=HW, conf_thresh=0.05, max_det=50,
              fused="on")
CFG_3D = dict(point_buckets=(1024,), max_det=16, pre_max=64, score_thresh=0.0)


def seeded_variables(init, seed=0):
    """A flax variable tree of ``init``'s structure (traced with
    ``jax.eval_shape``, nothing run) filled from a seeded numpy generator:
    unit BatchNorm scales and variances, small biases and means, fan-in
    scaled kernels."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "var" in name or "scale" in name:
            return (1.0 + 0.1 * rng.random(s.shape)).astype(s.dtype)
        if "mean" in name or "bias" in name:
            return (0.05 * rng.normal(size=s.shape)).astype(s.dtype)
        fan_in = max(1, int(np.prod(s.shape[:-1])))
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def yolo_variables():
    model = JYoloV5(num_classes=2, variant="n")
    return seeded_variables(lambda k: model.init(k, jnp.zeros((1, *HW, 3)), train=False))


def pointpillars_variables(jcfg):
    return seeded_variables(lambda k: jpp.init_pointpillars(k, jcfg)[1])


@pytest.fixture(scope="module")
def pair():
    """(JAX server, port server), each serving yolov5n and pointpillars."""
    jcfg3, tcfg3 = tiny_configs()
    yv, pv = yolo_variables(), pointpillars_variables(jcfg3)
    jrepo, trepo = JRepository(), ModelRepository()
    jpipe, jspec, _ = jdet2d.build_yolov5_pipeline(
        jax.random.PRNGKey(0), variant="n", num_classes=2, input_hw=HW, variables=yv,
        config=jdet2d.Detect2DConfig(**CFG_2D))
    jrepo.register(jspec, jpipe.infer_fn())
    tpipe, tspec, _ = tdet2d.build_yolov5_pipeline(
        variant="n", num_classes=2, input_hw=HW, variables=yv,
        config=tdet2d.Detect2DConfig(**CFG_2D), device="cpu")
    trepo.register(tspec, tpipe.infer_fn())
    jpipe, jspec, _ = jdet3d.build_pointpillars_pipeline(
        jax.random.PRNGKey(0), model_cfg=jcfg3, config=jdet3d.Detect3DConfig(**CFG_3D),
        variables=pv)
    jrepo.register(jspec, jpipe.infer_fn())
    tpipe, tspec, _ = tdet3d.build_pointpillars_pipeline(
        model_cfg=tcfg3, config=tdet3d.Detect3DConfig(**CFG_3D), variables=pv, device="cpu")
    trepo.register(tspec, tpipe.infer_fn())
    js = jserver.InferenceServer(jrepo, TPUChannel(jrepo), address="127.0.0.1:0", max_workers=4)
    ts = tserver.InferenceServer(trepo, CUDAChannel(trepo, device="cpu"),
                                 address="127.0.0.1:0", max_workers=4)
    js.start()
    ts.start()
    yield js, ts
    js.stop()
    ts.stop()


def _clients(pair):
    js, ts = pair
    return (JGRPCChannel(f"127.0.0.1:{js.port}", timeout_s=60, use_shared_memory=False),
            JGRPCChannel(f"127.0.0.1:{ts.port}", timeout_s=60, use_shared_memory=False))


def _stubs(pair):
    return [jservice.GRPCInferenceServiceStub(grpc.insecure_channel(f"127.0.0.1:{s.port}"))
            for s in pair]


def frames(seed, n):
    return np.random.default_rng(seed).integers(0, 255, (n, 48, 80, 3)).astype(np.uint8)


def scan(seed, n=500):
    padded, m = tdet3d.prepare_points(cloud(seed, n), 4, CFG_3D["point_buckets"])
    return {"points": padded, "num_points": np.asarray(m, np.int32)}


def assert_2d_close(got, want):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["detections"], want["detections"], rtol=1e-3, atol=1e-2)


def assert_3d_close(got, want):
    got = tdet3d.unpack_rows(got["detections"], got["valid"])
    want = tdet3d.unpack_rows(want["detections"], want["valid"])
    np.testing.assert_array_equal(got["pred_labels"], want["pred_labels"])
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["pred_scores"], want["pred_scores"], rtol=0, atol=1e-5)


# -- health, metadata, config, index -------------------------------------------------


def test_health_agrees(pair):
    jc, tc = _clients(pair)
    for c in (jc, tc):
        assert c.server_live() and c.server_ready()
        assert c.model_ready("yolov5n") and c.model_ready("pointpillars", "1")
        assert not c.model_ready("nope") and not c.model_ready("yolov5n", "9")
    assert jc.repository_index() == tc.repository_index() == [
        ("pointpillars", "1", "READY"), ("yolov5n", "1", "READY")]


def test_server_metadata_agrees_but_for_the_name_and_shared_memory(pair):
    want, got = (s.ServerMetadata(jpb.ServerMetadataRequest(), timeout=10) for s in _stubs(pair))
    assert got.version == want.version
    assert (want.name, got.name) == ("triton_client_tpu", "triton_client_tpu_torch")
    assert list(got.extensions) == [e for e in want.extensions if e != "system_shared_memory"]


@pytest.mark.parametrize("model", ["yolov5n", "pointpillars"])
def test_model_metadata_and_config_agree(pair, model):
    jstub, tstub = _stubs(pair)
    for rpc, req in (("ModelMetadata", jpb.ModelMetadataRequest(name=model)),
                     ("ModelConfig", jpb.ModelConfigRequest(name=model))):
        want, got = (getattr(s, rpc)(req, timeout=10) for s in (jstub, tstub))
        target_w, target_g = (want, got) if rpc == "ModelMetadata" else (want.config, got.config)
        assert (target_w.platform, target_g.platform) == ("jax", "torch")
        target_w.platform = "torch"
        if rpc == "ModelConfig":
            # the JSON parameters: every one the port serves is JAX's
            params_w, params_g = dict(want.config.parameters), dict(got.config.parameters)
            assert set(params_g) == set(params_w)
            for key, value in params_g.items():
                assert json.loads(value) == json.loads(params_w[key]), key
        assert got.SerializeToString(deterministic=True) == \
            want.SerializeToString(deterministic=True), rpc


def test_specs_through_grpc_channel_agree(pair):
    jc, tc = _clients(pair)
    for model in ("yolov5n", "pointpillars"):
        want, got = jc.get_metadata(model), tc.get_metadata(model)
        assert got.extra == want.extra and got.inputs == want.inputs
        assert got.outputs == want.outputs and got.max_batch_size == want.max_batch_size


def test_message_limit_agrees():
    specs = [
        (dict(name="fixed", inputs=(("x", (8, 512, 512, 3), "FP32"),),
              outputs=(("y", (8, 1000), "FP16"),), max_batch_size=8)),
        (dict(name="dyn", inputs=(("x", (-1, 4), "FP32"),), outputs=(("y", (-1,), "BOOL"),))),
        (dict(name="huge", inputs=(("x", (4096, 4096, 3), "FP64"),), outputs=(),
              max_batch_size=4)),
    ]
    jrepo, trepo = JRepository(), ModelRepository()
    for i, s in enumerate(specs):
        j = JModelSpec(s["name"], inputs=tuple(JTensorSpec(*t) for t in s["inputs"]),
                       outputs=tuple(JTensorSpec(*t) for t in s["outputs"]),
                       max_batch_size=s.get("max_batch_size", 1))
        t = ModelSpec(s["name"], inputs=tuple(TensorSpec(*t) for t in s["inputs"]),
                      outputs=tuple(TensorSpec(*t) for t in s["outputs"]),
                      max_batch_size=s.get("max_batch_size", 1))
        assert t.wire_bytes() == j.wire_bytes()
        jrepo.register(j, lambda x: x)
        trepo.register(t, lambda x: x)
        assert tserver.message_limit(trepo) == jserver.message_limit(jrepo), i
    assert tserver.message_limit(trepo) > 64 << 20


# -- inference -------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 2])
def test_infer_2d_agrees(pair, batch):
    jc, tc = _clients(pair)
    x = frames(batch, batch)
    want = jc.do_inference(JInferRequest("yolov5n", {"images": x}, request_id="r1"))
    got = tc.do_inference(JInferRequest("yolov5n", {"images": x}, request_id="r1"))
    assert got.request_id == want.request_id == "r1"
    assert got.outputs["detections"].shape == (batch, 50, 6)
    assert_2d_close(got.outputs, want.outputs)
    assert got.outputs["valid"].sum() > 10


@pytest.mark.parametrize("seed", [0, 1])
def test_infer_3d_agrees(pair, seed):
    jc, tc = _clients(pair)
    want = jc.do_inference(JInferRequest("pointpillars", scan(seed)))
    got = tc.do_inference(JInferRequest("pointpillars", scan(seed)))
    assert_3d_close(got.outputs, want.outputs)
    assert got.outputs["valid"].sum() > 0


@pytest.mark.parametrize("group_size", [1, 2])
def test_streaming_agrees(pair, group_size):
    """Four requests a stream, in order, each equal to its own unary answer
    from the same server; the JAX server's stream at the 2D bar."""
    jc, tc = _clients(pair)
    xs = [frames(10 + i, 1) for i in range(4)]
    streams = {}
    for name, c in (("jax", jc), ("port", tc)):
        reqs = [JInferRequest("yolov5n", {"images": x}, request_id=f"s{i}")
                for i, x in enumerate(xs)]
        out = list(c.infer_stream(reqs, group_size=group_size))
        assert [r.request_id for r in out] == [f"s{i}" for i in range(4)]
        for r, x in zip(out, xs):
            solo = c.do_inference(JInferRequest("yolov5n", {"images": x})).outputs
            np.testing.assert_array_equal(r.outputs["detections"], solo["detections"])
        streams[name] = out
    for got, want in zip(streams["port"], streams["jax"]):
        assert_2d_close(got.outputs, want.outputs)


def test_port_client_and_jax_client_get_the_same_bytes(pair):
    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel

    _, ts = pair
    jc = JGRPCChannel(f"127.0.0.1:{ts.port}", timeout_s=60, use_shared_memory=False)
    tc = GRPCChannel(f"127.0.0.1:{ts.port}", timeout_s=60)
    x = frames(7, 1)
    a = jc.do_inference(JInferRequest("yolov5n", {"images": x})).outputs
    b = tc.do_inference(InferRequest("yolov5n", {"images": x})).outputs
    for k in a:
        assert a[k].tobytes() == b[k].tobytes()
    tc.close()


def test_every_response_carries_the_span_summary(pair):
    _, ts = pair
    jc = JGRPCChannel(f"127.0.0.1:{ts.port}", timeout_s=60, use_shared_memory=False)
    resp = jc.do_inference(JInferRequest("pointpillars", scan(3)))
    doc = decode_span_summary(resp.parameters[SUMMARY_PARAM_KEY])
    names = [s[0] for s in doc["s"]]
    assert doc["st"] == "ok" and {"parse", "channel", "stage", "readback", "encode"} <= set(names)
    assert ts.tracer.stats()["finished"] >= 1


def test_shared_memory_answers_unimplemented_and_clients_fall_back(pair):
    _, ts = pair
    stub = _stubs(pair)[1]
    with pytest.raises(grpc.RpcError) as e:
        stub.SystemSharedMemoryRegister(jpb.SystemSharedMemoryRegisterRequest(name="r"), timeout=10)
    assert e.value.code() == grpc.StatusCode.UNIMPLEMENTED and "item 8" in e.value.details()
    # the JAX client negotiates shared memory on loopback, then rides the wire
    jc = JGRPCChannel(f"127.0.0.1:{ts.port}", timeout_s=60)
    x = frames(9, 1)
    auto = jc.do_inference(JInferRequest("yolov5n", {"images": x})).outputs
    wire = _clients(pair)[1].do_inference(JInferRequest("yolov5n", {"images": x})).outputs
    assert jc.stats()["transport"] == "grpc"
    np.testing.assert_array_equal(auto["detections"], wire["detections"])
    jc.close()


# -- status codes ------------------------------------------------------------------------


ERRORS = {
    "unknown_model": (dict(model="nope"), "NOT_FOUND"),
    "unknown_version": (dict(model_version="9"), "NOT_FOUND"),
    "missing_input": (dict(inputs={"other": np.zeros((1, 4), np.float32)}), "INVALID_ARGUMENT"),
    "wrong_rank": (dict(inputs={"images": np.zeros((48, 80, 3), np.uint8)}),
                   "INVALID_ARGUMENT"),
    "wrong_shape": (dict(inputs={"images": np.zeros((1, 48, 80, 4), np.uint8)}),
                    "INVALID_ARGUMENT"),
    "unknown_datatype": (dict(datatype="FP99"), "INVALID_ARGUMENT"),
    "raw_buffer_count": (dict(extra_raw=True), "INVALID_ARGUMENT"),
}


def _error_request(case):
    kw, _ = ERRORS[case]
    inputs = kw.get("inputs", {"images": np.zeros((1, 48, 80, 3), np.uint8)})
    from triton_client_tpu.channel.kserve import codec as jcodec

    req = jcodec.build_infer_request(kw.get("model", "yolov5n"), inputs,
                                     model_version=kw.get("model_version", ""))
    if "datatype" in kw:
        req.inputs[0].datatype = kw["datatype"]
    if kw.get("extra_raw"):
        req.raw_input_contents.append(b"")
    return req


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_error_status_codes_and_messages_agree(pair, case):
    codes = []
    for stub in _stubs(pair):
        with pytest.raises(grpc.RpcError) as e:
            stub.ModelInfer(_error_request(case), timeout=30)
        codes.append((e.value.code().name, e.value.details()))
    assert codes[0] == codes[1]
    assert codes[0][0] == ERRORS[case][1]


def _gate_pair(**server_kw):
    """A JAX and a port server over one blocking FP32 model each: a request
    waits in the model until ``gate`` is set."""
    gate = threading.Event()

    def fn(inputs):
        gate.wait(10)
        return {"y": inputs["x"] + 1}

    out = []
    for repo_t, spec_t, tspec_t, chan, srv in (
        (JRepository, JModelSpec, JTensorSpec, TPUChannel, jserver.InferenceServer),
        (ModelRepository, ModelSpec, TensorSpec, lambda r: CUDAChannel(r, device="cpu"),
         tserver.InferenceServer),
    ):
        repo = repo_t()
        repo.register(spec_t("g", inputs=(tspec_t("x", (-1, 4)),),
                             outputs=(tspec_t("y", (-1, 4)),)), fn)
        s = srv(repo, chan(repo), address="127.0.0.1:0", max_workers=4, **server_kw)
        s.start()
        out.append(s)
    return gate, out


def _infer_code(server, model="g"):
    stub = jservice.GRPCInferenceServiceStub(grpc.insecure_channel(f"127.0.0.1:{server.port}"))
    from triton_client_tpu.channel.kserve import codec as jcodec

    req = jcodec.build_infer_request(model, {"x": np.zeros((1, 4), np.float32)})
    try:
        stub.ModelInfer(req, timeout=30)
        return "OK", ""
    except grpc.RpcError as e:
        return e.code().name, e.details()


def test_admission_shed_is_resource_exhausted_in_both():
    gate, servers = _gate_pair(admission_max_queue=1)
    try:
        held = [threading.Thread(target=_infer_code, args=(s,)) for s in servers]
        for t in held:
            t.start()
        for s in servers:
            while s._servicer.active_requests() < 1:
                threading.Event().wait(0.01)
        codes = [_infer_code(s) for s in servers]
        assert codes[0] == codes[1]
        assert codes[0][0] == "RESOURCE_EXHAUSTED" and "queue depth 1 >= limit 1" in codes[0][1]
    finally:
        gate.set()
        for t in held:
            t.join()
        for s in servers:
            s.stop()


@pytest.mark.parametrize("priority", [0, -1, 3])
def test_admission_controller_sheds_as_jax_without_a_deadline(priority):
    """The served requests carry no deadline (the SLO plane that stamps one
    is not ported), so the queue-depth knee and its priority limit decide
    alone, in both packages, through admits and finishes."""
    outcomes = []
    for mod in (jadm, tadm):
        ctl = mod.AdmissionController(max_queue=4)
        seq = []
        for step in ("a", "a", "a", "f", "a", "a", "a", "f", "f", "a"):
            if step == "f":
                ctl.finished("m")
                continue
            try:
                ctl.admit("m", priority=priority)
                seq.append("ok")
            except mod.AdmissionRejectedError as e:
                seq.append(str(e))
        stats = ctl.stats()
        outcomes.append((seq, stats["admitted"], stats["inflight"], stats["rejects"]))
    assert outcomes[0] == outcomes[1]


def test_draining_is_unavailable_and_not_ready_in_both():
    gate, servers = _gate_pair()
    gate.set()
    try:
        for s in servers:
            s._draining.set()
        codes = [_infer_code(s) for s in servers]
        assert codes[0] == codes[1] and codes[0][0] == "UNAVAILABLE"
        for s in servers:
            stub = jservice.GRPCInferenceServiceStub(grpc.insecure_channel(f"127.0.0.1:{s.port}"))
            assert not stub.ServerReady(jpb.ServerReadyRequest(), timeout=10).ready
            assert not stub.ModelReady(jpb.ModelReadyRequest(name="g"), timeout=10).ready
    finally:
        for s in servers:
            s.stop()


def test_replica_down_is_unavailable_in_both():
    gate, servers = _gate_pair(replica_of="cell0")
    gate.set()
    rule = {"point": "replica_down", "model": "cell0", "count": 1}
    prev = (jfaults.install_fault_plan(jfaults.FaultPlan([rule], seed=3)),
            tfaults.install_fault_plan(tfaults.FaultPlan([rule], seed=3)))
    try:
        codes = [_infer_code(s) for s in servers]
        assert codes[0] == codes[1] == ("UNAVAILABLE", "replica is down (injected)")
        assert [_infer_code(s) for s in servers] == [("OK", "")] * 2  # the rule fired once
    finally:
        jfaults.install_fault_plan(prev[0])
        tfaults.install_fault_plan(prev[1])
        for s in servers:
            s.stop()


def test_failures_are_internal_and_an_open_breaker_unavailable_in_both():
    """A model that fails (a KernelError on the port) answers INTERNAL; with
    the breaker at threshold 1 the next request is refused UNAVAILABLE."""
    servers = []
    for repo_t, spec_t, tspec_t, chan, srv, err in (
        (JRepository, JModelSpec, JTensorSpec,
         lambda r: TPUChannel(r, breaker_threshold=1, breaker_reset_s=60),
         jserver.InferenceServer, RuntimeError),
        (ModelRepository, ModelSpec, TensorSpec,
         lambda r: CUDAChannel(r, device="cpu", breaker_threshold=1, breaker_reset_s=60),
         tserver.InferenceServer, KernelError),
    ):
        def fn(inputs, err=err):
            raise err("kernel launch failed")

        repo = repo_t()
        repo.register(spec_t("g", inputs=(tspec_t("x", (-1, 4)),),
                             outputs=(tspec_t("y", (-1, 4)),)), fn)
        s = srv(repo, chan(repo), address="127.0.0.1:0", max_workers=2)
        s.start()
        servers.append(s)
    try:
        first = [_infer_code(s) for s in servers]
        second = [_infer_code(s) for s in servers]
        assert first[0] == first[1] == ("INTERNAL", "kernel launch failed")
        assert second[0][0] == second[1][0] == "UNAVAILABLE"
        assert second[0] == second[1]
    finally:
        for s in servers:
            s.stop()


EXCEPTIONS = ["AdmissionRejectedError", "QueueFullError", "DeadlineExpiredError",
              "CircuitOpenError", "ServerDrainingError", "ReplicaDownError"]


@pytest.mark.parametrize("name", EXCEPTIONS + ["KeyError", "ValueError", "RuntimeError",
                                               "KernelError"])
def test_grpc_code_mapping_agrees(name):
    if name in EXCEPTIONS:
        want, got = getattr(jadm, name)("x"), getattr(tadm, name)("x")
    elif name == "KernelError":  # a failed kernel on the port, any fault on JAX
        want, got = RuntimeError("x"), KernelError("x")
    else:
        want = got = {"KeyError": KeyError, "ValueError": ValueError,
                      "RuntimeError": RuntimeError}[name]("x")
    assert tserver._grpc_code(got) == jserver._grpc_code(want)


def test_unported_options_raise_naming_their_item():
    repo = ModelRepository()
    for kw in ({"metrics_port": 8002}, {"uds_address": "auto"}, {"slo_ms": 5.0},
               {"tenants": object()}, {"lifecycle": object()}, {"quality": object()},
               {"temporal": object()}, {"history_path": "h.json"},
               {"op_sample_interval_s": 1.0}):
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md Queue 1 item 8"):
            tserver.InferenceServer(repo, None, address="127.0.0.1:0", **kw)


def test_content_encoding_is_unimplemented(pair):
    from triton_client_tpu.channel.kserve import codec as jcodec

    req = jcodec.build_infer_request("yolov5n", {"images": np.zeros((1, 48, 80, 3), np.uint8)},
                                     input_parameters={"images": {"content_encoding": "jpeg"}})
    with pytest.raises(grpc.RpcError) as e:
        _stubs(pair)[1].ModelInfer(req, timeout=30)
    assert e.value.code() == grpc.StatusCode.UNIMPLEMENTED and "wire_encoding" in e.value.details()


# -- the servicer in-process, where grpc is not installed ---------------------------------

_IN_PROCESS = r"""
import sys

BLOCKED = ("grpc", "google", "jax", "yaml", "triton_client_tpu")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked {name}")
        return None

sys.meta_path.insert(0, Blocker())
import numpy as np
from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.channel.kserve import codec, pb, service
from triton_client_tpu_torch.pipelines.detect2d import Detect2DConfig, build_yolov5_pipeline
from triton_client_tpu_torch.runtime.repository import ModelRepository
from triton_client_tpu_torch.obs.trace import Tracer
from triton_client_tpu_torch.runtime.server import _Servicer

repo = ModelRepository()
cfg = Detect2DConfig(model_name="y", num_classes=2, input_hw=(64, 64), conf_thresh=0.05)
pipe, spec, _ = build_yolov5_pipeline(num_classes=2, input_hw=(64, 64), config=cfg, device="cpu")
repo.register(spec, pipe.infer_fn())
channel = CUDAChannel(repo, device="cpu")
servicer = _Servicer(repo, channel, tracer=Tracer())
x = np.random.default_rng(0).integers(0, 255, (2, 48, 80, 3)).astype(np.uint8)
req = codec.build_infer_request("y", {"images": x}, request_id="q").SerializeToString()
out = codec.parse_infer_response(pb.ModelInferResponse.FromString(
    service.invoke(servicer, "ModelInfer", req)))
direct = channel.do_inference(InferRequest("y", {"images": x})).outputs
assert all(out[k].tobytes() == direct[k].tobytes() for k in direct), "differs"
stream = service.invoke(servicer, "ModelStreamInfer", [req, req, req])
assert [pb.ModelStreamInferResponse.FromString(b).infer_response.id for b in stream] == ["q"] * 3
ctx = service.InProcessContext()
try:
    service.invoke(servicer, "ModelInfer", codec.build_infer_request(
        "nope", {"images": x}).SerializeToString(), ctx)
except service.RpcAborted:
    pass
assert ctx.aborted[0] == "NOT_FOUND", ctx.aborted
for m in ("ServerLive", "ServerReady", "ServerMetadata", "RepositoryIndex"):
    service.invoke(servicer, m, b"")
print("ok")
"""


def test_servicer_runs_in_process_without_grpc_or_protobuf():
    out = subprocess.run([sys.executable, "-c", _IN_PROCESS], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_batched_requests_with_a_0d_input_run_solo_as_in_jax():
    """A 3D request's ``num_points`` has no batch axis: both batchers run
    such members alone (JAX's after a failed merge), with equal outputs,
    and the port counts no merge fallback for it."""
    from triton_client_tpu.channel.base import InferRequest as JR
    from triton_client_tpu.runtime.continuous import ContinuousBatchingChannel as JC

    from triton_client_tpu_torch.channel.base import InferRequest as TR
    from triton_client_tpu_torch.runtime.continuous import ContinuousBatchingChannel as TC

    outs = []
    for repo_t, spec_t, tensor_t, chan, batcher, req_t in (
        (JRepository, JModelSpec, JTensorSpec, TPUChannel, JC, JR),
        (ModelRepository, ModelSpec, TensorSpec, lambda r: CUDAChannel(r, device="cpu"), TC, TR),
    ):
        repo = repo_t()
        repo.register(spec_t("m", inputs=(tensor_t("points", (-1, 4)),
                                          tensor_t("num_points", (), "INT32")),
                             outputs=(tensor_t("n", (), "INT32"),), max_batch_size=2),
                      lambda i: {"n": i["num_points"] * 2})
        c = batcher(chan(repo))
        futs = [c.do_inference_async(req_t("m", {"num_points": np.asarray(k, np.int32),
                                                 "points": np.zeros((8, 4), np.float32)}))
                for k in range(6)]
        outs.append([int(f.result().outputs["n"]) for f in futs])
        if batcher is TC:
            assert c.stats()["merge_fallbacks"] == 0
        c.close()
    assert outs[0] == outs[1] == [0, 2, 4, 6, 8, 10]


@pytest.mark.parametrize("batcher", ["window", "continuous"])
def test_a_0d_input_group_frees_its_slot_once_every_member_launched(batcher):
    """A group whose members run alone keeps the pipeline overlap: every
    member launches, then the slot frees, and only then does any readback
    wait. The check covers every member, not the first alone: a group
    whose second member has the 0-d input runs solo too."""
    import concurrent.futures

    from triton_client_tpu_torch.channel.base import InferRequest as TR
    from triton_client_tpu_torch.channel.base import InferResponse
    from triton_client_tpu_torch.runtime.batching import BatchingChannel
    from triton_client_tpu_torch.runtime.continuous import ContinuousBatchingChannel

    gate = threading.Event()
    launched = []

    class _GatedInner:
        """Launches resolve only once the gate opens."""

        batch_multiple = 1

        def get_metadata(self, name, version=""):
            raise KeyError(name)  # no spec: no ragged route

        def do_inference_async(self, request):
            launched.append(request.request_id)
            fut = concurrent.futures.Future()

            def readback():
                assert gate.wait(timeout=30.0)
                fut.set_result(InferResponse(
                    model_name=request.model_name, request_id=request.request_id,
                    outputs={"n": np.asarray(request.inputs["num_points"]) * 2}))

            threading.Thread(target=readback, daemon=True).start()
            return fut

    cls = BatchingChannel if batcher == "window" else ContinuousBatchingChannel
    chan = cls(_GatedInner(), max_batch=2, pipeline_depth=2)
    freed = threading.Event()
    members = [(None, TR("m", {"num_points": np.asarray([k], np.int32) if k == 0
                               else np.asarray(k, np.int32)}, request_id=f"r{k}"),
                concurrent.futures.Future()) for k in range(3)]
    runner = threading.Thread(target=chan._run_group, args=(members, freed.set), daemon=True)
    try:
        runner.start()
        assert freed.wait(timeout=30.0), "the slot must free once every member launched"
        assert launched == ["r0", "r1", "r2"]
        assert not any(f.done() for _t, _r, f in members)
        gate.set()
        runner.join(timeout=30.0)
        assert not runner.is_alive()
        assert [int(np.ravel(f.result(timeout=0).outputs["n"])[0])
                for _t, _r, f in members] == [0, 2, 4]
        assert chan.stats()["merge_fallbacks"] == 0
    finally:
        gate.set()
        chan.close()


def test_span_summaries_encode_decode_and_graft_as_jax():
    """A server's summary grafts onto a caller's clock as the JAX
    function places it: wire_send / wire_recv around the prefixed spans."""
    from triton_client_tpu.obs import trace as jtrace

    from triton_client_tpu_torch.obs import trace as ttrace

    ctx = "00-" + "a" * 32 + "-" + "b" * 16 + "-01"
    summaries = []
    for mod in (jtrace, ttrace):
        tr = mod.RequestTrace(1, model="m", request_id="r", context=mod.TraceContext.decode(ctx))
        tr.add("parse", tr.t_start + 0.001, tr.t_start + 0.002)
        tr.add("encode", tr.t_start + 0.004, tr.t_start + 0.0045)
        tr.t_end = tr.t_start + 0.005
        summaries.append(json.loads(mod.encode_span_summary(tr)))
    assert summaries[0] == summaries[1]
    assert ttrace.decode_span_summary("not json") is None
    assert ttrace.decode_span_summary(json.dumps({"s": []})) is None
    grafted = []
    for mod in (jtrace, ttrace):
        local = mod.RequestTrace(2)
        mod.graft_span_summary(local, summaries[0], t_sent=10.0, t_recv=10.009)
        grafted.append([(s.name, round(s.t0, 9), round(s.t1, 9)) for s in local.spans])
    assert grafted[0] == grafted[1]
    assert [g[0] for g in grafted[1]] == ["wire_send", "wire_recv", "srv.parse", "srv.encode"]
    assert ttrace.TraceContext.decode("garbage") is None
    assert ttrace.TraceContext.decode(ctx).encode() == ctx


@pytest.mark.parametrize("held", [False, True])
def test_drain_reports_stragglers_as_jax(held):
    """drain() turns the server not-ready, waits out in-flight requests up
    to its timeout and stops: True when it emptied in time, in both."""
    gate, servers = _gate_pair()
    threads = []
    try:
        if held:
            threads = [threading.Thread(target=_infer_code, args=(s,)) for s in servers]
            for t in threads:
                t.start()
            for s in servers:
                while s._servicer.active_requests() < 1:
                    threading.Event().wait(0.01)
        else:
            gate.set()
        drained = [s.drain(timeout_s=0.3) for s in servers]
        assert drained == [not held, not held]
        assert all(s.draining for s in servers)
    finally:
        gate.set()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
