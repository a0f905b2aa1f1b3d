"""The port's host transport against the JAX package's, on the CPU:
``channel/transport.py`` (endpoint classes, unix-socket paths, labels),
``runtime/shared_memory.py`` (regions, the server's registry, the
client's slot pool), the servicer's shared-memory extension and its peer
gate, the ``--uds`` listener, and ``runtime/wire_encoding.py``.

Shared memory works across the packages both ways: the port's
``GRPCChannel(use_shared_memory=True)`` against JAX's ``InferenceServer``,
and JAX's client, negotiating on its own, against the port's server; each
answer is bitwise equal to the same request over the wire. A client
recovers when the server loses its registrations (a restart, the
``shm_detach`` fault point).
"""

import os
import pathlib

import grpc
import numpy as np
import pytest

from triton_client_tpu.channel import transport as jtransport
from triton_client_tpu.channel.base import InferRequest as JInferRequest
from triton_client_tpu.channel.grpc_channel import GRPCChannel as JGRPCChannel
from triton_client_tpu.channel.kserve import codec as jcodec
from triton_client_tpu.channel.kserve import pb as jpb
from triton_client_tpu.channel.tpu_channel import TPUChannel
from triton_client_tpu.config import ModelSpec as JModelSpec
from triton_client_tpu.config import TensorSpec as JTensorSpec
from triton_client_tpu.runtime import server as jserver
from triton_client_tpu.runtime import shared_memory as jshm
from triton_client_tpu.runtime import wire_encoding as jwe
from triton_client_tpu.runtime.repository import ModelRepository as JRepository

from triton_client_tpu_torch.channel import transport as ttransport
from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel
from triton_client_tpu_torch.channel.kserve import codec as tcodec
from triton_client_tpu_torch.channel.kserve import pb as tpb
from triton_client_tpu_torch.channel.kserve import service as tservice
from triton_client_tpu_torch.config import BF16, ModelSpec, TensorSpec
from triton_client_tpu_torch.runtime import faults as tfaults
from triton_client_tpu_torch.runtime import server as tserver
from triton_client_tpu_torch.runtime import shared_memory as tshm
from triton_client_tpu_torch.runtime import wire_encoding as twe
from triton_client_tpu_torch.runtime.repository import ModelRepository
from torch_threads import one_torch_thread  # noqa: F401

# the endpoints of tests/test_transport.py's negotiation tests, and more
ENDPOINTS = ["unix:/tmp/s.sock", "unix:///tmp/s.sock", "unix-abstract:kserve",
             "127.0.0.1:8001", "127.8.3.1:8001", "localhost:8001", "[::1]:8001",
             "ipv4:127.0.0.1:8001", "dns:///svc.cluster:443", "10.0.0.5:8001",
             "tpu-host-3:8001", "example.com:8001"]
MODULES = {"jax": jshm, "port": tshm}


def _key(tag):
    return f"/tct_ttest_{os.getpid()}_{tag}"


# -- channel/transport.py -------------------------------------------------------------


@pytest.mark.parametrize("endpoint", ENDPOINTS)
def test_classify_and_eligibility_equal_jax(endpoint):
    assert ttransport.classify(endpoint) == jtransport.classify(endpoint)
    assert ttransport.is_uds(endpoint) == jtransport.is_uds(endpoint)
    assert ttransport.shm_eligible(endpoint) == jtransport.shm_eligible(endpoint)
    for use in (True, False):
        assert ttransport.negotiated(endpoint, use) == jtransport.negotiated(endpoint, use)


@pytest.mark.parametrize("endpoint", ["unix:/a/b.sock", "unix:///a/b.sock", "unix://host/a/b",
                                      "unix:rel.sock", "127.0.0.1:80"])
def test_uds_path_equals_jax(endpoint):
    try:
        want = jtransport.uds_path(endpoint)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            ttransport.uds_path(endpoint)
        return
    assert ttransport.uds_path(endpoint) == want


def test_channel_labels_equal_jax_with_shared_memory():
    """Channels dial lazily: the label needs no server."""
    for endpoint in ENDPOINTS:
        for use in (None, True, False):
            port = GRPCChannel(endpoint, use_shared_memory=use)
            jax_ = JGRPCChannel(endpoint, use_shared_memory=use)
            try:
                assert port.transport == jax_.transport, (endpoint, use)
            finally:
                port.close()
                jax_.close()


# -- runtime/shared_memory.py ----------------------------------------------------------


@pytest.mark.parametrize("pkg", sorted(MODULES))
def test_region_create_write_read_unlink(pkg):
    mod = MODULES[pkg]
    key = _key(f"rw_{pkg}")
    arr = np.arange(24, dtype=np.float32).reshape(4, 6)
    with mod.SharedMemoryRegion.create(key, arr.nbytes) as region:
        assert region.write(arr) == arr.nbytes
        back = np.frombuffer(region.read(0, arr.nbytes), np.float32).reshape(4, 6)
        np.testing.assert_array_equal(back, arr)
        assert os.path.exists(mod._shm_path(key))
        reader = mod.SharedMemoryRegion.attach(key)
        reader.close()  # a non-owner's close leaves the segment
        assert os.path.exists(mod._shm_path(key))
    assert not os.path.exists(mod._shm_path(key))


@pytest.mark.parametrize("bad", ["", "/", "a/b", "/../etc", ".hidden", "/x/y"])
def test_key_validation_equals_jax(bad):
    with pytest.raises(ValueError) as want:
        jshm._shm_path(bad)
    with pytest.raises(ValueError) as got:
        tshm._shm_path(bad)
    assert str(got.value) == str(want.value)
    assert tshm._shm_path("/abc") == jshm._shm_path("/abc") == "/dev/shm/abc"


def test_bounds_errors_equal_jax():
    msgs = {}
    for pkg, mod in MODULES.items():
        with mod.SharedMemoryRegion.create(_key(f"bounds_{pkg}"), 16) as region:
            out = []
            for call in (lambda: region.write(np.zeros(5, np.float32)),
                         lambda: region.read(8, 16), lambda: region.read(-1, 4)):
                with pytest.raises(ValueError) as e:
                    call()
                out.append(str(e.value).replace(f"bounds_{pkg}", "bounds"))
            msgs[pkg] = out
    assert msgs["port"] == msgs["jax"]


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_registry_reads_the_other_packages_regions(writer, reader):
    """Same key format, offsets and windows: a region one package creates
    is registered, read, bounds-checked and unregistered by the other's."""
    key = _key(f"reg_{writer}_{reader}")
    with MODULES[writer].SharedMemoryRegion.create(key, 128) as region:
        region.write(np.arange(32, dtype=np.float32))
        reg = MODULES[reader].SystemSharedMemoryRegistry()
        reg.register("r0", key, 0, 128)
        reg.register("w", key, offset=32, byte_size=32)
        with pytest.raises(ValueError, match="already registered"):
            reg.register("r0", key, 0, 128)
        assert reg.status()["r0"].byte_size == 128 and reg.status("w")["w"].offset == 32
        np.testing.assert_array_equal(np.frombuffer(reg.read("r0", 0, 128), np.float32),
                                      np.arange(32, dtype=np.float32))
        np.testing.assert_array_equal(np.frombuffer(reg.read("w", 0, 32), np.float32),
                                      np.arange(8, 16, dtype=np.float32))
        with pytest.raises(ValueError, match="exceeds registered window"):
            reg.read("w", 16, 32)
        reg.write("w", 0, np.full(8, 7.0, np.float32))
        np.testing.assert_array_equal(np.frombuffer(region.read(32, 32), np.float32),
                                      np.full(8, 7.0, np.float32))
        reg.unregister("r0")
        with pytest.raises(ValueError, match="not registered"):
            reg.read("r0", 0, 4)
        with pytest.raises(KeyError):
            reg.status("r0")
        reg.unregister_all()
        assert reg.status() == {}


@pytest.mark.parametrize("pkg", sorted(MODULES))
def test_attach_missing_and_stale_segments(pkg):
    mod = MODULES[pkg]
    with pytest.raises(OSError):
        mod.SystemSharedMemoryRegistry().register("nope", _key(f"missing_{pkg}"), 0, 8)
    key = _key(f"stale_{pkg}")
    with open(mod._shm_path(key), "wb") as f:
        f.write(b"\xff" * 32)  # a crashed run's segment
    with mod.SharedMemoryRegion.create(key, 16) as region:
        np.testing.assert_array_equal(np.frombuffer(region.read(0, 16), np.uint8),
                                      np.zeros(16, np.uint8))
    assert not os.path.exists(mod._shm_path(key))


def _drive_pool(mod, tag):
    """One sequence of acquires, growth, retirement, recovery and release
    on a pool of ``mod``; returns the RPC calls made and the stats seen."""
    calls = []
    pool = mod.ShmRegionPool(tag, 2, lambda *a: calls.append(("reg",) + a),
                             lambda name: calls.append(("unreg", name)))
    a = pool.acquire(timeout_s=0)
    b = pool.acquire(timeout_s=0)
    with pytest.raises(TimeoutError):
        pool.acquire(timeout_s=0)
    a.region_for("i_x", 64).write(np.ones(16, np.float32))
    a.region_for("i_x", 32)  # fits: no new generation
    a.region_for("i_x", 256)  # grows: generation 1 replaces 0
    b.region_for("o", 128)
    b.retire("o")
    seen = [pool.stats()]
    pool.release(a)
    pool.release(a)  # idempotent
    pool.release(b)
    assert pool.acquire(timeout_s=0) is b  # LIFO: the warm slot comes back first
    pool.release(b)
    pool.reregister_all()
    seen.append(pool.stats())
    pool.close()
    with pytest.raises(RuntimeError, match="closed"):
        pool.acquire(timeout_s=0)
    keys = [c[2] for c in calls if c[0] == "reg"]
    assert all(not os.path.exists(f"/dev/shm{k}") for k in keys)
    return calls, seen


def test_pool_behaves_as_jax():
    """The same tag drives the same register/unregister calls (names, keys,
    sizes, order) and the same counters in both packages' pools."""
    tag = f"tct_ttest_{os.getpid()}_pool"
    want, want_stats = _drive_pool(jshm, tag)
    got, got_stats = _drive_pool(tshm, tag)
    assert got == want and got_stats == want_stats
    assert [c[0] for c in got].count("reg") == 4  # g0, g1, the arena, one re-registration


def test_bf16_words_through_a_region_equal_jax():
    """A bf16 tensor through a region: JAX writes ``ml_dtypes.bfloat16``, the
    port reads ``config.BF16`` words; the words are the same, both ways."""
    import ml_dtypes

    arr = (np.arange(16, dtype=np.float32) * 0.37).astype(ml_dtypes.bfloat16).reshape(4, 4)
    key = _key("bf16")
    with jshm.SharedMemoryRegion.create(key, arr.nbytes) as region:
        region.write(arr)
        reg = tshm.SystemSharedMemoryRegistry()
        reg.register("bf16_r", key, 0, arr.nbytes)
        req = jcodec.build_infer_request_shm("m", {"x": arr},
                                             shm_inputs={"x": ("bf16_r", 0, arr.nbytes)})
        wire = tpb.ModelInferRequest.FromString(req.SerializeToString())
        parsed = tcodec.parse_infer_request(wire, shm=reg)
        assert parsed["x"].dtype == BF16
        assert parsed["x"].view(np.uint16).tobytes() == arr.view(np.uint16).tobytes()
        # and back: the port's words written into the region read as JAX's bf16
        words = np.ascontiguousarray(parsed["x"][::-1])
        tshm.SharedMemoryRegion.attach(key).write(words)
        jreg = jshm.SystemSharedMemoryRegistry()
        jreg.register("bf16_r", key, 0, arr.nbytes)
        back = jcodec.parse_infer_request(jpb.ModelInferRequest.FromString(
            req.SerializeToString()), shm=jreg)["x"]
        assert back.view(np.uint16).tobytes() == words.view(np.uint16).tobytes()
        reg.unregister_all()
        jreg.unregister_all()


# -- the servers: shared memory across the packages, the peer gate, recovery ----------------


def _register_models(repo, spec_t, tensor_t):
    def addone(inputs):
        return {"y": np.asarray(inputs["x"]) + 1}

    def two(inputs):
        x = np.asarray(inputs["x"])
        return {"s": (x * 2).astype(np.float32), "n": np.full((x.shape[0],), 3, np.int32)}

    repo.register(spec_t("addone", inputs=(tensor_t("x", (-1, 4)),),
                         outputs=(tensor_t("y", (-1, 4)),), max_batch_size=8), addone)
    repo.register(spec_t("two", inputs=(tensor_t("x", (-1, 4)),),
                         outputs=(tensor_t("s", (-1, 4)), tensor_t("n", (-1,), "INT32")),
                         max_batch_size=8), two)


def _port_server(address="127.0.0.1:0"):
    repo = ModelRepository()
    _register_models(repo, ModelSpec, TensorSpec)
    srv = tserver.InferenceServer(repo, CUDAChannel(repo, device="cpu"), address=address,
                                  uds_address="auto", max_workers=8)
    srv.start()
    return srv


@pytest.fixture(scope="module")
def servers():
    jrepo = JRepository()
    _register_models(jrepo, JModelSpec, JTensorSpec)
    js = jserver.InferenceServer(jrepo, TPUChannel(jrepo), address="127.0.0.1:0",
                                 uds_address="auto", max_workers=8)
    js.start()
    ts = _port_server()
    yield {"jax": js, "port": ts}
    js.stop()
    ts.stop()


def _x(seed, n=2):
    return np.random.default_rng(seed).random((n, 4)).astype(np.float32)


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _exercise(client, wire, req_t):
    """Unary (twice a model: the second answers through the output arena),
    async and a grouped stream through ``client``, each equal to ``wire``'s
    answer to the same request."""
    for model in ("addone", "two", "addone", "two"):
        for seed in (1, 2):
            req = req_t(model, {"x": _x(seed)})
            _same(client.do_inference(req).outputs, wire.do_inference(req).outputs)
    req = req_t("two", {"x": _x(3, 1)})
    _same(client.do_inference_async(req).result().outputs, wire.do_inference(req).outputs)
    reqs = [req_t("addone", {"x": _x(10 + i, 1)}, request_id=f"s{i}") for i in range(5)]
    got = list(client.infer_stream(reqs, group_size=2))
    assert [r.request_id for r in got] == [f"s{i}" for i in range(5)]
    for r, q in zip(got, reqs):
        _same(r.outputs, wire.do_inference(q).outputs)


@pytest.mark.parametrize("via", ["tcp", "uds"])
def test_port_client_rides_shm_against_the_jax_server(servers, via):
    js = servers["jax"]
    endpoint = f"127.0.0.1:{js.port}" if via == "tcp" else js.uds_address
    client = GRPCChannel(endpoint, use_shared_memory=True, timeout_s=30)
    wire = JGRPCChannel(f"127.0.0.1:{js.port}", use_shared_memory=False, timeout_s=30)
    _exercise(client, wire, InferRequest)
    stats = client.stats()
    assert stats["transport"] == ("shm" if via == "tcp" else "uds+shm")
    assert stats["shm_pool"]["aliased"] == 0 and stats["shm_pool"]["regions"] >= 2
    client.close()
    wire.close()
    assert js.shm_registry.status() == {}


@pytest.mark.parametrize("via", ["tcp", "uds"])
def test_jax_client_negotiates_shm_with_the_port_server(servers, via):
    ts = servers["port"]
    endpoint = f"127.0.0.1:{ts.port}" if via == "tcp" else ts.uds_address
    client = JGRPCChannel(endpoint, timeout_s=30)  # auto
    wire = GRPCChannel(f"127.0.0.1:{ts.port}", use_shared_memory=False, timeout_s=30)
    _exercise(client, wire, JInferRequest)
    assert client.stats()["transport"] == ("shm" if via == "tcp" else "uds+shm")
    client.close()
    wire.close()
    assert ts.shm_registry.status() == {}


@pytest.mark.parametrize("shm", [False, True], ids=["wire", "shm"])
@pytest.mark.parametrize("server", ["jax", "port"])
def test_a_traced_request_grafts_the_server_summary_as_the_jax_router(servers, server, shm):
    """A traced ``do_inference``: the client's ``encode`` and ``decode``
    spans around the server's span summary, grafted on the RPC's interval
    exactly as JAX's ``graft_span_summary`` places it. The JAX server built
    without telemetry traces nothing and sends no summary: nothing is
    grafted."""
    from triton_client_tpu.obs.trace import RequestTrace as JRequestTrace
    from triton_client_tpu.obs.trace import graft_span_summary as jgraft

    from triton_client_tpu_torch.obs.trace import (
        SUMMARY_PARAM_KEY,
        Tracer,
        decode_span_summary,
    )

    srv = servers[server]
    client = GRPCChannel(f"127.0.0.1:{srv.port}", use_shared_memory=shm, timeout_s=30)
    client.do_inference(InferRequest("two", {"x": _x(1)}))  # teaches the output arena
    untraced = client.do_inference(InferRequest("two", {"x": _x(2)}))
    trace = Tracer().start(model="two")
    resp = client.do_inference(InferRequest("two", {"x": _x(2)}, trace=trace))
    client.close()
    _same(resp.outputs, untraced.outputs)
    spans = {sp.name: sp for sp in trace.spans}
    assert trace.spans[0].name == "encode" and trace.spans[-1].name == "decode"
    if server == "jax":
        assert resp.parameters is None and list(spans) == ["encode", "decode"]
        assert spans["encode"].t1 <= spans["decode"].t0
        return
    assert spans["encode"].t1 == spans["wire_send"].t0
    assert spans["wire_recv"].t1 == spans["decode"].t0
    assert any(name.startswith("srv.") for name in spans)
    summary = decode_span_summary(resp.parameters[SUMMARY_PARAM_KEY])
    want = JRequestTrace(0)
    jgraft(want, summary, spans["wire_send"].t0, spans["wire_recv"].t1)
    assert [(sp.name, sp.t0, sp.t1) for sp in trace.spans[1:-1]] == [
        (sp.name, sp.t0, sp.t1) for sp in want.spans]


def test_uds_parity_on_both_servers(servers):
    """Over each server's unix socket on the wire: the port's and JAX's
    clients say ``uds`` and get the TCP wire's bytes."""
    for srv in servers.values():
        tcp = GRPCChannel(f"127.0.0.1:{srv.port}", use_shared_memory=False)
        assert srv.uds_address.startswith("unix:") and os.path.exists(srv.uds_address[5:])
        for client in (GRPCChannel(srv.uds_address, use_shared_memory=False),
                       JGRPCChannel(srv.uds_address, use_shared_memory=False)):
            assert client.transport == "uds"
            req = InferRequest("two", {"x": _x(4)})
            _same(client.do_inference(req).outputs, tcp.do_inference(req).outputs)
            client.close()
        tcp.close()


def test_status_rpc_and_metadata_agree(servers):
    """SystemSharedMemoryStatus lists a registered region alike, and both
    servers' metadata list the extension."""
    key = _key("status")
    with tshm.SharedMemoryRegion.create(key, 64):
        out = []
        for srv in (servers["jax"], servers["port"]):
            stub = tservice.GRPCInferenceServiceStub(
                grpc.insecure_channel(f"127.0.0.1:{srv.port}"))
            stub.SystemSharedMemoryRegister(tpb.SystemSharedMemoryRegisterRequest(
                name="st", key=key, offset=16, byte_size=32), timeout=10)
            status = stub.SystemSharedMemoryStatus(
                tpb.SystemSharedMemoryStatusRequest(name="st"), timeout=10)
            out.append(status.SerializeToString())
            with pytest.raises(grpc.RpcError) as e:
                stub.SystemSharedMemoryStatus(tpb.SystemSharedMemoryStatusRequest(name="nope"),
                                              timeout=10)
            out.append((e.value.code(), e.value.details()))
            stub.SystemSharedMemoryUnregister(tpb.SystemSharedMemoryUnregisterRequest(),
                                              timeout=10)
            meta = stub.ServerMetadata(tpb.ServerMetadataRequest(), timeout=10)
            assert "system_shared_memory" in meta.extensions
        assert out[:2] == out[2:]


class _RemoteContext:
    """A servicer context whose peer is on another host."""

    def __init__(self, peer="ipv4:10.0.0.5:40000"):
        self._peer = peer
        self.aborted = None

    def peer(self):
        return self._peer

    def abort(self, code, details):
        self.aborted = (getattr(code, "name", code), details)
        raise RuntimeError("aborted")


def _shm_rpcs(pb):
    req = jcodec.build_infer_request_shm("addone", {"x": np.zeros((1, 4), np.float32)},
                                         shm_inputs={"x": ("r", 0, 16)})
    return [
        ("SystemSharedMemoryRegister",
         pb.SystemSharedMemoryRegisterRequest(name="r", key="/etc_passwd", byte_size=16)),
        ("SystemSharedMemoryStatus", pb.SystemSharedMemoryStatusRequest()),
        ("SystemSharedMemoryUnregister", pb.SystemSharedMemoryUnregisterRequest()),
        ("ModelInfer", pb.ModelInferRequest.FromString(req.SerializeToString())),
        ("ModelStreamInfer", iter([pb.ModelInferRequest.FromString(req.SerializeToString())])),
    ]


@pytest.mark.parametrize("peer", ["ipv4:10.0.0.5:40000", "ipv6:[2001:db8::1]:5",
                                  "ipv4:128.0.0.1:1", "in-process"])
def test_a_remote_peer_cannot_reach_the_registry(servers, peer):
    """Every shm RPC and shm-carrying request from a non-local peer is
    PERMISSION_DENIED, with JAX's message, before any region is mapped."""
    jsv = servers["jax"]._servicer
    tsv = servers["port"]._servicer
    for (name, jreq), (_, treq) in zip(_shm_rpcs(jpb), _shm_rpcs(tpb)):
        answers = []
        for sv, req in ((jsv, jreq), (tsv, treq)):
            ctx = _RemoteContext(peer)
            with pytest.raises(RuntimeError, match="aborted"):
                out = getattr(sv, name)(req, ctx)
                if name == "ModelStreamInfer":
                    list(out)
            answers.append(ctx.aborted)
        assert answers[0] == answers[1], name
        assert answers[1][0] == "PERMISSION_DENIED" and peer in answers[1][1]
    assert servers["port"].shm_registry.status() == {}


@pytest.mark.parametrize("peer", ["ipv4:127.0.0.1:5", "ipv4:127.9.9.9:5", "ipv6:[::1]:5",
                                  "ipv6:[::ffff:127.0.0.1]:5", "unix:/tmp/x.sock", "unix:",
                                  "ipv4:10.0.0.1:5", "ipv6:[::2]:5", "in-process"])
def test_local_peer_rule_equals_jax(peer):
    ctx = _RemoteContext(peer)
    assert tserver._Servicer._is_local_peer(ctx) == jserver._Servicer._is_local_peer(ctx)


def test_client_recovers_after_a_server_restart():
    """The restarted server's registry is empty: the next request answers
    'not registered', the client registers its regions again and re-issues,
    and the answers stay equal to the wire's."""
    srv = _port_server()
    port = srv.port
    client = GRPCChannel(f"127.0.0.1:{port}", use_shared_memory=True, timeout_s=30)
    req = InferRequest("two", {"x": _x(5)})
    first = client.do_inference(req).outputs
    client.do_inference(req)  # the output arena is registered too now
    srv.stop()
    srv = _port_server(f"127.0.0.1:{port}")
    try:
        assert srv.shm_registry.status() == {}
        _same(client.do_inference(req).outputs, first)
        assert len(srv.shm_registry.status()) == client.stats()["shm_pool"]["regions"] == 2
        _same(client.do_inference_async(req).result().outputs, first)
    finally:
        client.close()
        srv.stop()


def test_client_recovers_after_shm_detach(servers):
    """The ``shm_detach`` fault point drops every registration before a
    parse, unary and streamed; the port's client and JAX's recover."""
    ts = servers["port"]
    wire = GRPCChannel(f"127.0.0.1:{ts.port}", use_shared_memory=False)
    for client, req_t in ((GRPCChannel(f"127.0.0.1:{ts.port}", use_shared_memory=True),
                           InferRequest),
                          (JGRPCChannel(f"127.0.0.1:{ts.port}", use_shared_memory=True),
                           JInferRequest)):
        req = req_t("addone", {"x": _x(6)})
        want = wire.do_inference(req).outputs
        _same(client.do_inference(req).outputs, want)
        rule = {"point": "shm_detach", "model": "addone", "count": 1}
        prev = tfaults.install_fault_plan(tfaults.FaultPlan([rule], seed=1))
        try:
            _same(client.do_inference(req).outputs, want)
            assert tfaults.active_plan().rules[0].fired == 1
            tfaults.install_fault_plan(tfaults.FaultPlan([rule], seed=1))
            reqs = [req_t("addone", {"x": _x(6)}, request_id=f"d{i}") for i in range(3)]
            got = list(client.infer_stream(reqs))
            assert [r.request_id for r in got] == ["d0", "d1", "d2"]
            for r in got:
                _same(r.outputs, want)
            assert tfaults.active_plan().rules[0].fired == 1
        finally:
            tfaults.install_fault_plan(prev)
        client.close()
    wire.close()


def test_auto_falls_back_to_the_wire_on_a_server_without_the_extension():
    """A same-host endpoint whose server refuses the extension: auto rides
    the wire from then on, forced shm raises."""
    class NoShm(tserver._Servicer):
        def SystemSharedMemoryRegister(self, request, context):
            self._abort(context, "UNIMPLEMENTED", "no shared memory here")

    repo = ModelRepository()
    _register_models(repo, ModelSpec, TensorSpec)
    srv = tserver.InferenceServer(repo, CUDAChannel(repo, device="cpu"), address="127.0.0.1:0")
    srv._server.stop(0)
    import concurrent.futures

    srv._server = grpc.server(concurrent.futures.ThreadPoolExecutor(max_workers=4))
    tservice.add_GRPCInferenceServiceServicer_to_server(
        NoShm(repo, srv.channel, status=tservice.grpc_status_table()), srv._server)
    port = srv._server.add_insecure_port("127.0.0.1:0")
    srv._server.start()
    try:
        auto = GRPCChannel(f"127.0.0.1:{port}")
        assert auto.transport == "shm"
        out = auto.do_inference(InferRequest("addone", {"x": _x(7)})).outputs
        assert auto.transport == "grpc"
        np.testing.assert_array_equal(out["y"], _x(7) + 1)
        forced = GRPCChannel(f"127.0.0.1:{port}", use_shared_memory=True)
        with pytest.raises(grpc.RpcError) as e:
            forced.do_inference(InferRequest("addone", {"x": _x(7)}))
        assert e.value.code() == grpc.StatusCode.UNIMPLEMENTED
        auto.close()
        forced.close()
    finally:
        srv._server.stop(0)


def test_uds_address_forms_and_cleanup(tmp_path):
    repo = ModelRepository()
    _register_models(repo, ModelSpec, TensorSpec)
    for form in (str(tmp_path / "a.sock"), f"unix:{tmp_path / 'b.sock'}",
                 f"unix://{tmp_path / 'c.sock'}"):
        srv = tserver.InferenceServer(repo, CUDAChannel(repo, device="cpu"),
                                      address="127.0.0.1:0", uds_address=form)
        srv.start()
        path = srv.uds_address[len("unix:"):]
        assert pathlib.Path(path).parent == tmp_path and os.path.exists(path)
        c = GRPCChannel(srv.uds_address, use_shared_memory=False)
        assert c.server_live()
        c.close()
        srv.stop()
        assert not os.path.exists(path)


# -- runtime/wire_encoding.py -------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dequantize_equals_jax_bitwise(bits, seed):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(3, 1000, 4)) * rng.uniform(0.01, 300)).astype(np.float32)
    q, params = jwe.quantize(a, bits)
    tq, tparams = twe.quantize(a, bits)
    assert tq.tobytes() == q.tobytes() and tparams == params
    req = jcodec.build_infer_request("m", {"x": q}, input_parameters={"x": params})
    wire = tpb.ModelInferRequest.FromString(req.SerializeToString())
    enc = twe.encodings_of(wire)
    assert enc == jwe.encodings_of(req)
    got = twe.decode_inputs(tcodec.parse_infer_request(wire), enc)["x"]
    want = np.asarray(jwe.decode_inputs(jcodec.parse_infer_request(req),
                                        jwe.encodings_of(req))["x"])
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("shm", [False, True])
def test_port_client_sends_encoded_inputs_as_jax_does(servers, shm):
    """``InferRequest.input_params`` ride the port's client (wire or shm) as
    JAX's client sends them: a q8 input answers as the decoded float input
    does on the JAX server."""
    x = _x(12, 3)
    q, params = twe.quantize(x, 8)
    got = GRPCChannel(f"127.0.0.1:{servers['port'].port}", use_shared_memory=shm)
    jax_ = JGRPCChannel(f"127.0.0.1:{servers['jax'].port}", use_shared_memory=False)
    for _ in range(2):  # on shm the second answer comes through the output arena
        out = got.do_inference(InferRequest("addone", {"x": q}, input_params={"x": params}))
        want = jax_.do_inference(JInferRequest("addone", {"x": q}, input_params={"x": params}))
        _same(out.outputs, want.outputs)
    assert got.transport == ("shm" if shm else "grpc")
    got.close()
    jax_.close()


def test_encoding_errors_equal_jax():
    for params in ({"content_encoding": "q8"}, {"content_encoding": "q8", "q_scale": "x",
                                                "q_min": "0"}):
        req = jcodec.build_infer_request("m", {"x": np.zeros(4, np.uint8)},
                                         input_parameters={"x": params})
        with pytest.raises(ValueError) as want:
            jwe.encodings_of(req)
        with pytest.raises(ValueError) as got:
            twe.encodings_of(tpb.ModelInferRequest.FromString(req.SerializeToString()))
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown content_encoding 'zstd'"):
        twe.decode_one(np.zeros(4, np.uint8), {"encoding": "zstd"})
    with pytest.raises(ValueError, match="8 or 16 bits"):
        twe.quantize(np.zeros(4, np.float32), 4)


def test_jpeg_equals_jax():
    pytest.importorskip("PIL")
    frame = np.random.default_rng(3).integers(0, 255, (48, 80, 3), dtype=np.uint8)
    payload, params = twe.encode_jpeg(frame, quality=85)
    jpayload, jparams = jwe.encode_jpeg(frame, quality=85)
    assert payload.tobytes() == jpayload.tobytes() and params == jparams
    got, want = twe.decode_jpeg(payload), jwe.decode_jpeg(jpayload)
    assert got.dtype == want.dtype == np.uint8 and got.tobytes() == want.tobytes()
    req = jcodec.build_infer_request("m", {"images": payload, "other": np.ones(2, np.float32)},
                                     input_parameters={"images": params})
    wire = tpb.ModelInferRequest.FromString(req.SerializeToString())
    out = twe.decode_inputs(tcodec.parse_infer_request(wire), twe.encodings_of(wire))
    assert out["images"].tobytes() == want.tobytes() and out["other"].tolist() == [1.0, 1.0]
