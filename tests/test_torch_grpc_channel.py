"""The port's ``GRPCChannel`` against both servers (the JAX package's and
the port's, on loopback, on the CPU): metadata with the re-dial to a
larger message cap, unary, async and streamed inference (stream groups
included), the health RPCs, ``repository_index``, the retry ladder and
its counters, deadlines that fail before the wire, and ``close``. Each
answer is held to what the JAX package's ``GRPCChannel`` gets from the
same server, bit for bit. ``InferFuture.cancel`` and ``add_done_callback``
behave as JAX's on lazy, completed, failed, hooked and wire futures, and a
cancelled shared-memory attempt retires its output region, so the late
outputs of the cancelled request never land in the slot's next owner's.
"""

import threading
import time

import grpc
import numpy as np
import pytest

from triton_client_tpu.channel import base as jbase
from triton_client_tpu.channel.base import InferRequest as JInferRequest
from triton_client_tpu.channel.grpc_channel import GRPCChannel as JGRPCChannel
from triton_client_tpu.channel.tpu_channel import TPUChannel
from triton_client_tpu.config import ModelSpec as JModelSpec
from triton_client_tpu.config import TensorSpec as JTensorSpec
from triton_client_tpu.runtime import server as jserver
from triton_client_tpu.runtime.repository import ModelRepository as JRepository

from triton_client_tpu_torch.channel import base as tbase
from triton_client_tpu_torch.channel import grpc_channel as tgc
from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel
from triton_client_tpu_torch.config import ModelSpec, TensorSpec
from triton_client_tpu_torch.runtime import server as tserver
from triton_client_tpu_torch.runtime.repository import ModelRepository
from torch_threads import one_torch_thread  # noqa: F401

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
    # both on the wire: the shared-memory transport has its own tests
    # (tests/test_torch_transport.py)
    port = GRPCChannel(endpoint, timeout_s=30, backoff_s=0.01, use_shared_memory=False)
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
    port = GRPCChannel(endpoint, use_shared_memory=False)
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
        port = GRPCChannel(f"127.0.0.1:{free}", timeout_s=0.5, retries=2, backoff_s=0.01,
                           use_shared_memory=False)
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
        port = GRPCChannel(f"127.0.0.1:{free}", timeout_s=0.5, retries=5, backoff_s=0.2,
                           use_shared_memory=False)
        req = InferRequest("addone", {"x": _x(0)}, deadline_s=time.perf_counter() + 0.15)
        with pytest.raises(tgc.DeadlineExceededRpcError):
            port.do_inference(req)
        port.close()


def test_shared_memory_is_not_ported():
    """Forcing shared memory on a loopback endpoint with no server: the
    channel says ``shm`` and a request fails UNAVAILABLE (the registration
    RPC), with no fallback to the wire."""
    with socket_port() as free:
        port = GRPCChannel(f"127.0.0.1:{free}", use_shared_memory=True, timeout_s=2,
                           retries=0)
        assert port.transport == "shm"
        with pytest.raises(grpc.RpcError) as e:
            port.do_inference(InferRequest("addone", {"x": _x(0)}))
        assert e.value.code() == grpc.StatusCode.UNAVAILABLE
        assert port.transport == "shm"
        port.close()


def _future_semantics(base):
    """What a caller sees of each kind of future: cancel's answer, when a
    done-callback fires, the result, and a callback that raises."""
    out, fired = [], []

    def note(tag):
        return lambda: fired.append(tag)

    def boom():
        raise RuntimeError("a callback that raises is swallowed")

    lazy = base.InferFuture(lambda: 5)
    out.append(lazy.cancel())
    lazy.add_done_callback(note("lazy"))
    lazy.add_done_callback(boom)
    out += [list(fired), lazy.result(), lazy.cancel(), lazy.map(lambda v: v + 1).result()]
    for fut in (base.InferFuture.completed(7), base.InferFuture.failed(ValueError("x"))):
        out.append(fut.cancel())
        fut.add_done_callback(note("done"))
        try:
            out.append(fut.result())
        except ValueError as e:
            out.append(repr(e))
    held = []
    hooked = base.InferFuture(lambda: 3, cancel=lambda: True, subscribe=held.append)
    hooked.add_done_callback(note("hooked"))
    out += [list(fired), len(held), hooked.cancel()]
    held[0]()  # the transport completes
    out += [list(fired), hooked.result(), hooked.cancel()]
    hooked.add_done_callback(note("after"))  # retired: at once
    refusing = base.InferFuture(lambda: 4, cancel=boom, subscribe=lambda fn: boom())
    refusing.add_done_callback(note("refused-subscribe"))  # falls back to at once
    out += [list(fired), refusing.cancel(), refusing.map(lambda v: v * 2).result()]
    return out


def test_future_cancel_and_done_callback_equal_jax():
    got, want = _future_semantics(tbase), _future_semantics(jbase)
    assert got == want
    assert got[:5] == [False, ["lazy"], 5, False, 6]


def _wire_future_run(chan):
    """A request held on the server, cancelled: cancel's answer, the
    callback, the error; then a request that completes."""
    fired = threading.Event()
    fut = chan.do_inference_async(InferRequest("slow", {"x": _x(0)}))
    fut.add_done_callback(fired.set)
    out = [fired.is_set(), fut.cancel(), fired.wait(10)]
    with pytest.raises(grpc.FutureCancelledError) as e:
        fut.result()
    out += [type(e.value).__name__, fut.cancel()]
    done = threading.Event()
    fut = chan.do_inference_async(InferRequest("addone", {"x": _x(1)}))
    fut.add_done_callback(done.set)
    out += [done.wait(10), fut.cancel(), fut.result().outputs["y"].tobytes()]
    late = []
    fut.add_done_callback(lambda: late.append(1))
    return out + [late]


@pytest.mark.parametrize("kind", ["jax", "port"])
def test_wire_futures_cancel_and_subscribe_equal_jax(kind):
    srv = _make_server(kind)
    endpoint = f"127.0.0.1:{srv.port}"
    port = GRPCChannel(endpoint, timeout_s=30, retries=0, use_shared_memory=False)
    jax_ = JGRPCChannel(endpoint, timeout_s=30, retries=0, use_shared_memory=False)
    try:
        got, want = _wire_future_run(port), _wire_future_run(jax_)
        assert got == want
        assert got[:5] == [False, True, True, "FutureCancelledError", False]
        assert got[5:7] == [True, False] and got[-1] == [1]
    finally:
        srv.gate.set()
        port.close()
        jax_.close()
        srv.stop()


def _wait_for(cond, timeout_s=10.0):
    t_end = time.perf_counter() + timeout_s
    while not cond():
        assert time.perf_counter() < t_end, "timed out"
        time.sleep(0.01)


def test_a_cancelled_shm_attempt_cannot_write_into_the_next_owners_region():
    """A request held on the server is cancelled over shared memory; the
    slot goes to the next request; then the cancelled request finishes and
    writes its outputs, late. The cancel retired the output region, so that
    write misses and the next owner's region holds only its own outputs.
    The held model answers a constant: it reads its inputs from the slot's
    input region, which the next owner has overwritten by then."""
    gate = threading.Event()
    repo = ModelRepository()
    repo.register(ModelSpec("addone", inputs=(TensorSpec("x", (-1, 4)),),
                            outputs=(TensorSpec("y", (-1, 4)),)), _fns(gate)[0])

    def hold(inputs):
        gate.wait(10)
        return {"y": inputs["x"] * 0 - 7}

    repo.register(ModelSpec("hold", inputs=(TensorSpec("x", (-1, 4)),),
                            outputs=(TensorSpec("y", (-1, 4)),)), hold)
    srv = tserver.InferenceServer(repo, CUDAChannel(repo, device="cpu"),
                                  address="127.0.0.1:0", max_workers=8)
    srv.start()
    gate.set()
    chan = GRPCChannel(f"127.0.0.1:{srv.port}", timeout_s=30, retries=0,
                       use_shared_memory=True)
    try:
        ghost_x, own_x = _x(1), _x(2)
        for model in ("hold", "addone"):  # the first answers teach the output sizes
            chan.do_inference(InferRequest(model, {"x": ghost_x}))
        gate.clear()
        fut = chan.do_inference_async(InferRequest("hold", {"x": ghost_x}))
        (slot,) = [s for s in chan._pool._slots if s.busy]
        ghost_name = slot.regions["o"].key.lstrip("/")
        assert ghost_name in srv.shm_registry.status()
        _wait_for(lambda: srv._servicer.active_requests() == 1)  # the server holds it
        assert fut.cancel() is True
        assert "o" not in slot.regions and not slot.busy
        assert ghost_name not in srv.shm_registry.status()
        nxt = chan.do_inference_async(InferRequest("addone", {"x": own_x}))
        assert slot.busy and slot.regions["o"].key.lstrip("/") != ghost_name  # LIFO: same slot
        with pytest.raises(grpc.FutureCancelledError):
            fut.result()
        assert slot.busy  # the cancelled future's result() left the next owner's slot alone
        own = nxt.result().outputs["y"]
        gate.set()  # the cancelled request runs on, and answers late
        _wait_for(lambda: srv._servicer.active_requests() == 0)
        np.testing.assert_array_equal(own, own_x + 1)
        arena = np.frombuffer(slot.regions["o"].read(0, own_x.nbytes), np.float32)
        np.testing.assert_array_equal(arena.reshape(own_x.shape), own_x + 1)
        assert chan._pool.stats()["aliased"] == 0 and not slot.busy
    finally:
        gate.set()
        chan.close()
        srv.stop()
    assert srv.shm_registry.status() == {}


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
