"""The port's ``GRPCChannel`` against both servers (the JAX package's and
the port's, on loopback, on the CPU): metadata with the re-dial to a
larger message cap, unary, async and streamed inference (stream groups
included), the health RPCs, ``repository_index``, the retry ladder and
its counters, deadlines that fail before the wire, and ``close``. Each
answer is held to what the JAX package's ``GRPCChannel`` gets from the
same server, bit for bit.
"""

import threading
import time

import grpc
import numpy as np
import pytest

from triton_client_tpu.channel.base import InferRequest as JInferRequest
from triton_client_tpu.channel.grpc_channel import GRPCChannel as JGRPCChannel
from triton_client_tpu.channel.tpu_channel import TPUChannel
from triton_client_tpu.config import ModelSpec as JModelSpec
from triton_client_tpu.config import TensorSpec as JTensorSpec
from triton_client_tpu.runtime import server as jserver
from triton_client_tpu.runtime.repository import ModelRepository as JRepository

from triton_client_tpu_torch.channel import grpc_channel as tgc
from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel
from triton_client_tpu_torch.config import ModelSpec, TensorSpec
from triton_client_tpu_torch.runtime import server as tserver
from triton_client_tpu_torch.runtime.repository import ModelRepository

# a 2048^2 x 3 FP32 frame at batch 8: 805 MB of payload, past the 64 MiB floor
BIG = ((8, 2048, 2048, 3), "FP32")


def _specs(spec_t, tensor_t):
    return (
        spec_t("addone", inputs=(tensor_t("x", (-1, 4)),), outputs=(tensor_t("y", (-1, 4)),),
               max_batch_size=8, extra={"a": [1, 2], "b": "c"}),
        spec_t("big", inputs=(tensor_t("x", BIG[0], BIG[1]),), outputs=(), max_batch_size=1),
    )


def _fns(gate):
    def addone(inputs):
        return {"y": inputs["x"] + 1}

    def overload(inputs):
        gate.wait(10)
        return {"y": inputs["x"] + 1}

    return addone, overload


def _make_server(kind, admission=0):
    gate = threading.Event()
    if kind == "jax":
        repo, spec_t, tensor_t = JRepository(), JModelSpec, JTensorSpec
    else:
        repo, spec_t, tensor_t = ModelRepository(), ModelSpec, TensorSpec
    addone, overload = _fns(gate)
    for spec in _specs(spec_t, tensor_t):
        repo.register(spec, addone)
    repo.register(spec_t("slow", inputs=(tensor_t("x", (-1, 4)),),
                         outputs=(tensor_t("y", (-1, 4)),)), overload)
    if kind == "jax":
        srv = jserver.InferenceServer(repo, TPUChannel(repo), address="127.0.0.1:0",
                                      max_workers=8, admission_max_queue=admission)
    else:
        srv = tserver.InferenceServer(repo, CUDAChannel(repo, device="cpu"),
                                      address="127.0.0.1:0", max_workers=8,
                                      admission_max_queue=admission)
    srv.start()
    srv.gate = gate
    srv.kind = kind
    return srv


@pytest.fixture(scope="module", params=["jax", "port"])
def server(request):
    srv = _make_server(request.param)
    yield srv
    srv.gate.set()
    srv.stop()


@pytest.fixture
def clients(server):
    endpoint = f"127.0.0.1:{server.port}"
    port = GRPCChannel(endpoint, timeout_s=30, backoff_s=0.01)
    jax_ = JGRPCChannel(endpoint, timeout_s=30, use_shared_memory=False)
    yield port, jax_
    port.close()
    jax_.close()


def _x(seed, n=2):
    return np.random.default_rng(seed).random((n, 4)).astype(np.float32)


def test_health_and_index(clients):
    port, jax_ = clients
    assert port.server_live() and port.server_ready() and port.model_ready("addone")
    assert not port.model_ready("nope")
    assert port.repository_index() == jax_.repository_index()
    assert port.transport == "grpc" and port.stats() == {
        "infer_rejections": 0, "retries": 0, "transport": "grpc"}


@pytest.mark.parametrize("endpoint", ["127.0.0.1:8001", "localhost:8001", "[::1]:8001",
                                      "example.com:8001", "unix:/tmp/kserve.sock",
                                      "unix:///tmp/kserve.sock", "unix-abstract:kserve"])
def test_transport_label_equals_the_jax_clients_without_shared_memory(endpoint):
    """Channels dial lazily: no server is needed to read the label."""
    port = GRPCChannel(endpoint)
    jax_ = JGRPCChannel(endpoint, use_shared_memory=False)
    try:
        assert port.transport == jax_.transport
    finally:
        port.close()
        jax_.close()


def test_metadata_equals_the_jax_clients_and_redials_to_a_larger_cap(clients):
    port, jax_ = clients
    spec = port.get_metadata("addone")
    want = jax_.get_metadata("addone")
    assert (spec.name, spec.version, spec.platform, spec.max_batch_size, spec.extra) == (
        want.name, want.version, want.platform, want.max_batch_size, want.extra)
    assert [(t.name, t.shape, t.dtype) for t in spec.inputs + spec.outputs] == [
        (t.name, t.shape, t.dtype) for t in want.inputs + want.outputs]
    old = port.fetch_channel()
    assert port._max_message_bytes == 64 << 20
    big = port.get_metadata("big")
    assert port._max_message_bytes == 2 * big.wire_bytes() + (1 << 20) > 64 << 20
    assert port.fetch_channel() is not old and old in port._retired
    with pytest.raises(grpc.RpcError) as e:
        port.get_metadata("nope")
    assert e.value.code() == grpc.StatusCode.NOT_FOUND


@pytest.mark.parametrize("mode", ["unary", "async"])
def test_inference_equals_the_jax_clients(clients, mode):
    port, jax_ = clients
    x = _x(1)
    want = jax_.do_inference(JInferRequest("addone", {"x": x}, request_id="7"))
    if mode == "unary":
        got = port.do_inference(InferRequest("addone", {"x": x}, request_id="7"))
    else:
        futures = [port.do_inference_async(InferRequest("addone", {"x": x}, request_id="7"))
                   for _ in range(3)]
        got = [f.result() for f in futures][-1]
    assert got.request_id == "7" and got.model_name == "addone"
    assert got.outputs["y"].tobytes() == want.outputs["y"].tobytes()
    np.testing.assert_allclose(got.outputs["y"], x + 1)
    assert got.latency_s > 0


@pytest.mark.parametrize("group_size", [1, 3])
def test_streams_in_order_with_groups(clients, group_size):
    port, jax_ = clients
    xs = [_x(10 + i) for i in range(7)]
    reqs = [InferRequest("addone", {"x": x}, request_id=f"r{i}") for i, x in enumerate(xs)]
    got = list(port.infer_stream(reqs, group_size=group_size))
    want = list(jax_.infer_stream([JInferRequest("addone", {"x": x}, request_id=f"r{i}")
                                   for i, x in enumerate(xs)], group_size=group_size))
    assert [r.request_id for r in got] == [r.request_id for r in want] == [
        f"r{i}" for i in range(7)]
    for g, w, x in zip(got, want, xs):
        assert g.outputs["y"].tobytes() == w.outputs["y"].tobytes()
        np.testing.assert_allclose(g.outputs["y"], x + 1)


def test_a_stream_error_raises(clients):
    port, _ = clients
    with pytest.raises(RuntimeError, match="not registered"):
        list(port.infer_stream([InferRequest("nope", {"x": _x(0)})]))


def test_errors_keep_their_codes_and_sheds_are_not_retried(server, clients):
    port, _ = clients
    with pytest.raises(grpc.RpcError) as e:
        port.do_inference(InferRequest("addone", {"x": np.zeros((2, 3), np.float32)}))
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    gated = _make_server(server.kind, admission=1)
    client = GRPCChannel(f"127.0.0.1:{gated.port}", timeout_s=30, backoff_s=0.01)
    held = threading.Thread(target=lambda: client.do_inference(InferRequest("slow", {"x": _x(0)})))
    held.start()
    try:
        while gated._servicer.active_requests() < 1:
            time.sleep(0.01)
        with pytest.raises(grpc.RpcError) as e:
            client.do_inference(InferRequest("slow", {"x": _x(0)}))
        assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        fut = client.do_inference_async(InferRequest("slow", {"x": _x(0)}))
        with pytest.raises(grpc.RpcError):
            fut.result()
    finally:
        gated.gate.set()
        held.join()
        client.close()
        gated.stop()
    assert client.stats()["infer_rejections"] == 2 and client.stats()["retries"] == 0


def test_deadlines_fail_before_the_wire():
    err = tgc.DeadlineExceededRpcError
    assert issubclass(err, grpc.RpcError)
    port = GRPCChannel("127.0.0.1:1", timeout_s=1, retries=0)
    expired = InferRequest("addone", {"x": _x(0)}, deadline_s=time.perf_counter() - 1)
    with pytest.raises(err) as e:
        port.do_inference(expired)
    assert e.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
    with pytest.raises(err):
        port.do_inference_async(expired).result()
    port.close()


def test_unavailable_retries_with_backoff_then_raises():
    with socket_port() as free:
        port = GRPCChannel(f"127.0.0.1:{free}", timeout_s=0.5, retries=2, backoff_s=0.01)
        assert not port.server_live(timeout_s=0.5)
        with pytest.raises(grpc.RpcError) as e:
            port.repository_index()
        assert e.value.code() == grpc.StatusCode.UNAVAILABLE
        # the idempotent queries and ModelInfer both re-issue on UNAVAILABLE
        with pytest.raises(grpc.RpcError):
            port.do_inference(InferRequest("addone", {"x": _x(0)}))
        assert port.stats()["retries"] == 2 * 2 + 2 * 1  # live (2), index (2), infer (2)
        port.close()


def test_a_deadline_caps_the_backoff():
    with socket_port() as free:
        port = GRPCChannel(f"127.0.0.1:{free}", timeout_s=0.5, retries=5, backoff_s=0.2)
        req = InferRequest("addone", {"x": _x(0)}, deadline_s=time.perf_counter() + 0.15)
        with pytest.raises(tgc.DeadlineExceededRpcError):
            port.do_inference(req)
        port.close()


def test_shared_memory_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 8"):
        GRPCChannel("127.0.0.1:1", use_shared_memory=True)


class socket_port:
    """A loopback port with nothing listening on it."""

    def __enter__(self):
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        self.port = s.getsockname()[1]
        s.close()
        return self.port

    def __exit__(self, *exc):
        return False
