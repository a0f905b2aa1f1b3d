"""The port's streaming sessions (``runtime/sessions.py``), the staged
channel's sessions hook and the servicer's sequence thread, on the CPU:
every case of the JAX package's ``tests/test_sessions.py`` pool, group and
server classes, run against the port (the router's rendezvous cases are
held to JAX's in tests/test_torch_router.py), plus the two-stream isolation
case, a failed ``advance`` inside a launch, the replay drive of
``utils/loadgen.run_streams`` (48 frames, 4 ``stream:`` tenants on the
device-time ledger) and the same replay over two replicas behind the
front-door router, each stream pinned to its rendezvous owner.

The serving model of every end-to-end test is an ECHO detector (its body
returns the request's ``detections``/``valid`` unchanged), so the
tracker's inputs are exactly what the test scripted. This file imports
nothing of JAX: its residency case (marked ``cuda``) runs on the card,
where ``advance``/``release`` run under
``torch.cuda.set_sync_debug_mode("error")``.
"""

from __future__ import annotations

import urllib.request

import numpy as np
import pytest
import torch

from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.config import ModelSpec, TensorSpec
from triton_client_tpu_torch.ops import tracking
from triton_client_tpu_torch.ops.tracking import TrackerConfig
from triton_client_tpu_torch.runtime.repository import ModelRepository
from triton_client_tpu_torch.runtime.sessions import (
    SessionLimitError,
    SessionManager,
    id_base_for,
)
from torch_threads import one_torch_thread  # noqa: F401

DET_DIM = 11
N_SLOTS = 6
TRACKER = TrackerConfig(max_tracks=8)


def _detections(rows, device="cpu"):
    det = np.zeros((N_SLOTS, DET_DIM), np.float32)
    valid = np.zeros((N_SLOTS,), bool)
    for i, (x, y) in enumerate(rows):
        det[i, 0], det[i, 1] = x, y
        det[i, 3:6] = (4.0, 2.0, 1.5)
        det[i, -2] = 0.9
        valid[i] = True
    return {"detections": torch.from_numpy(det).to(device),
            "valid": torch.from_numpy(valid).to(device)}


def _req(sid, start=False, end=False, model="echo"):
    return InferRequest(model_name=model, inputs={}, sequence_id=sid, sequence_start=start,
                        sequence_end=end)


def _manager(**kw):
    kw.setdefault("tracker", TRACKER)
    return SessionManager(**kw)


def _echo_repo(name="echo"):
    spec = ModelSpec(
        name=name, version="1",
        inputs=(TensorSpec("detections", (-1, DET_DIM), "FP32"), TensorSpec("valid", (-1,), "BOOL")),
        outputs=(TensorSpec("detections", (-1, DET_DIM), "FP32"),
                 TensorSpec("valid", (-1,), "BOOL")),
    )
    repo = ModelRepository()
    repo.register(spec, lambda inputs: {"detections": inputs["detections"],
                                        "valid": inputs["valid"]})
    return repo


def _channel(**manager_kw):
    repo = _echo_repo()
    chan = CUDAChannel(repo, device="cpu")
    manager = _manager(**manager_kw)
    chan.attach_sessions(manager)
    return chan, manager


def _server(max_sessions=8, ttl_s=60.0, id_namespace=0):
    """In-process server over an echo detector with sessions attached;
    returns (server, manager); the caller stops the server."""
    from triton_client_tpu_torch.runtime.server import InferenceServer

    repo = _echo_repo()
    chan = CUDAChannel(repo, device="cpu")
    manager = _manager(max_sessions=max_sessions, ttl_s=ttl_s, id_namespace=id_namespace)
    chan.attach_sessions(manager)
    server = InferenceServer(repo, chan, address="127.0.0.1:0", metrics_port="auto")
    server.start()
    return server, manager


def _wire(frame):
    return {k: v.numpy() for k, v in frame.items()}


# -- SessionManager ---------------------------------------------------------------


class TestSessionPool:
    def test_advance_creates_and_tracks(self):
        m = _manager()
        out = m.advance(_req("a", start=True), _detections([(0, 0), (5, 5)]))
        m.release("a")
        tids = out["det_track_ids"]
        assert tids[0] > 0 and tids[1] > 0 and tids[0] != tids[1]
        assert m.stats()["active_sessions"] == 1
        assert m.stats()["frames_total"] == 1

    def test_refcount_brackets_inflight(self):
        m = _manager()
        m.advance(_req("a", start=True), _detections([(0, 0)]))
        assert m.stats()["inflight_frames"] == 1
        m.release("a")
        assert m.stats()["inflight_frames"] == 0

    def test_end_frees_slot_after_last_release(self):
        m = _manager()
        m.advance(_req("a", start=True), _detections([(0, 0)]))
        m.advance(_req("a", end=True), _detections([(0.1, 0)]))
        # two frames in flight; the ended slot survives until both drop
        m.release("a")
        assert m.stats()["active_sessions"] == 1
        m.release("a")
        s = m.stats()
        assert s["active_sessions"] == 0
        assert s["ended_total"] == 1
        assert s["track_births_total"] == 1

    def test_restart_gets_fresh_epoch_disjoint_ids(self):
        m = _manager()
        out1 = m.advance(_req("a", start=True), _detections([(0, 0)]))
        m.release("a")
        out2 = m.advance(_req("a", start=True), _detections([(0, 0)]))
        m.release("a")
        assert int(out1["det_track_ids"][0]) != int(out2["det_track_ids"][0])
        s = m.stats()
        assert s["restarted_total"] == 1
        assert s["track_births_total"] == 1  # the first life's, folded at the restart

    def test_ttl_reclaims_idle_session(self):
        now = [0.0]
        m = _manager(max_sessions=1, ttl_s=10.0, time_fn=lambda: now[0])
        m.advance(_req("a", start=True), _detections([(0, 0)]))
        m.release("a")
        now[0] = 11.0
        m.advance(_req("b", start=True), _detections([(1, 1)]))
        m.release("b")
        s = m.stats()
        assert s["active_sessions"] == 1
        assert s["expired_total"] == 1

    def test_lru_reclaims_oldest_idle(self):
        now = [0.0]
        m = _manager(max_sessions=2, ttl_s=100.0, time_fn=lambda: now[0])
        for i, sid in enumerate(("a", "b")):
            now[0] = float(i)
            m.advance(_req(sid, start=True), _detections([(i, i)]))
            m.release(sid)
        now[0] = 5.0
        m.advance(_req("c", start=True), _detections([(9, 9)]))
        m.release("c")
        assert m.stats()["reclaimed_total"] == 1
        # "a" (least recently used) was the victim: "b" continues unrestarted
        m.advance(_req("b"), _detections([(1, 1)]))
        m.release("b")
        assert m.stats()["restarted_total"] == 0

    def test_full_pool_of_inflight_sessions_sheds(self):
        m = _manager(max_sessions=1, ttl_s=0.0)
        m.advance(_req("a", start=True), _detections([(0, 0)]))
        # "a" still holds its in-flight ref: unreclaimable
        with pytest.raises(SessionLimitError):
            m.advance(_req("b", start=True), _detections([(1, 1)]))
        assert m.stats()["rejected_total"] == 1

    def test_ended_slot_reclaimed_before_ttl(self):
        m = _manager(max_sessions=1, ttl_s=1e9)
        m.advance(_req("a", start=True, end=True), _detections([(0, 0)]))
        m.release("a")
        m.advance(_req("b", start=True), _detections([(1, 1)]))
        m.release("b")
        assert m.stats()["active_sessions"] == 1

    def test_failed_step_drops_ref(self):
        m = _manager()
        bad = {"detections": torch.zeros((5,)), "valid": torch.ones((5,), dtype=torch.bool)}
        with pytest.raises(Exception):
            m.advance(_req("a", start=True), bad)  # 1-D: no detection axis
        assert m.stats()["inflight_frames"] == 0

    def test_2d_rows_narrow_velocity_window(self):
        """The default config carries CenterPoint's velocity_cols=(7, 9); a
        2D detector's 6-column rows narrow it to None, and a coast keeps
        the narrowed config."""
        m = SessionManager(max_sessions=4)
        det = torch.zeros((4, 6))
        det[0] = torch.tensor([10.0, 12.0, 20.0, 22.0, 0.9, 1.0])
        valid = torch.tensor([True, False, False, False])
        out = m.advance(_req("v2d", start=True), {"detections": det, "valid": valid})
        m.release("v2d")
        assert int(out["det_track_ids"][0]) > 0
        coasted = m.coast(_req("v2d"))
        m.release("v2d")
        assert coasted is not None and coasted["tracks"].shape[-1] == 6
        assert m.stats()["coast_frames_total"] == 1

    def test_model_without_detections_passes_through(self):
        m = _manager()
        out = m.advance(_req("a", start=True), {"y": torch.zeros(3)})
        m.release("a")
        assert set(out) == {"y"}

    def test_namespace_epoch_id_layout(self):
        base = id_base_for(3, 7)
        assert base == (3 << 27) | (7 << 16)
        assert id_base_for(15, 2047) > 0  # stays in int32 positive range
        assert id_base_for(16, 0) == id_base_for(0, 0)  # namespace masks
        assert id_base_for(1, 2048) == id_base_for(1, 0)  # epoch wraps


class TestSessionGroups:
    def test_group_step_outputs_per_camera(self):
        m = _manager()
        single = _detections([(0, 0), (8, 8)])
        group = {k: torch.stack([v] * 2) for k, v in single.items()}
        out = m.advance(_req("g", start=True), group)
        m.release("g")
        tids = out["det_track_ids"]
        assert tids.shape[0] == 2
        cam0 = set(tids[0][tids[0] > 0].tolist())
        cam1 = set(tids[1][tids[1] > 0].tolist())
        assert cam0 and cam1 and not (cam0 & cam1)

    def test_group_size_change_rejected(self):
        m = _manager()
        single = _detections([(0, 0)])
        g2 = {k: torch.stack([v] * 2) for k, v in single.items()}
        g3 = {k: torch.stack([v] * 3) for k, v in single.items()}
        m.advance(_req("g", start=True), g2)
        m.release("g")
        with pytest.raises(ValueError, match="group size"):
            m.advance(_req("g"), g3)
        assert m.stats()["inflight_frames"] == 0

    def test_batch_of_one_is_a_group(self):
        m = _manager()
        g1 = {k: v[None] for k, v in _detections([(0, 0)]).items()}
        out = m.advance(_req("g", start=True), g1)
        m.release("g")
        assert out["det_track_ids"].shape[0] == 1

    def test_group_counters_fold_over_cameras(self):
        """A group's births and deaths fold summed over its cameras (JAX
        reads them as one int, which a group of more than one refuses:
        ROADMAP.md Queue 3)."""
        m = _manager()
        group = {k: torch.stack([v] * 3) for k, v in _detections([(0, 0), (9, 9)]).items()}
        m.advance(_req("g", start=True, end=True), group)
        m.release("g")
        assert m.stats()["track_births_total"] == 6

    def test_group_coast_advances_every_camera(self):
        m = _manager()
        group = {k: torch.stack([v] * 2) for k, v in _detections([(0, 0)]).items()}
        assert m.coast(_req("g")) is None  # nothing to coast before a keyframe
        m.advance(_req("g", start=True), group)
        m.release("g")
        out = m.coast(_req("g"))
        m.release("g")
        assert set(out) == set(tracking.COAST_OUTPUT_KEYS) and out["tracks"].shape[0] == 2
        assert m.stats()["inflight_frames"] == 0


# -- the staged channel's hook ------------------------------------------------------


def test_two_streams_on_one_channel_never_share_state():
    """Two sessions interleave frames on one channel: each stream's outputs
    equal that stream alone through the plain tracker (its own epoch's id
    base), so no frame saw the other stream's state."""
    chan, manager = _channel(max_sessions=4)
    rng = np.random.default_rng(0)
    tracks = {"a": rng.uniform(-10, 10, (3, 2)), "b": rng.uniform(-10, 10, (2, 2))}
    refs = {sid: tracking.init_state(TRACKER, DET_DIM, id_base_for(0, epoch))
            for epoch, sid in ((1, "a"), (2, "b"))}
    for k in range(8):
        for sid in ("a", "b"):
            frame = _detections([tuple(p + 0.3 * k) for p in tracks[sid]])
            resp = chan.do_inference(InferRequest(
                "echo", _wire(frame), sequence_id=sid, sequence_start=(k == 0)))
            refs[sid], want = tracking.reference_step(TRACKER, refs[sid], frame["detections"],
                                                      frame["valid"])
            for key in ("det_track_ids", "track_assign", "track_ids", "tracks_valid"):
                np.testing.assert_array_equal(resp.outputs[key], want[key].numpy(),
                                              err_msg=f"{sid} frame {k} {key}")
            assert resp.outputs["det_track_ids"].dtype == np.int32
            assert resp.outputs["tracks_valid"].dtype == np.bool_
    assert manager.stats()["frames_total"] == 16 and manager.stats()["inflight_frames"] == 0


def test_a_failed_advance_sheds_and_frees_the_slot():
    """SessionLimitError inside a launch fails that request only, counts a
    'session' shed, and leaves no staging slot or reference behind."""
    chan, manager = _channel(max_sessions=1, ttl_s=1e9)
    manager.advance(_req("a", start=True), _detections([(0, 0)]))
    fut = chan.do_inference_async(InferRequest("echo", _wire(_detections([(1, 1)])),
                                               sequence_id="b", sequence_start=True))
    with pytest.raises(SessionLimitError):
        fut.result()
    stats = chan.stats()
    assert stats["shed"] == {"echo|0|session": 1}
    assert stats["slots_active"] == 0 and stats["inflight"] == 0
    assert stats["launch_failures"] == 0  # not the model's failure
    manager.release("a")
    resp = chan.do_inference(InferRequest("echo", _wire(_detections([(1, 1)])),
                                          sequence_id="b", sequence_start=True))
    assert "det_track_ids" in resp.outputs and manager.stats()["inflight_frames"] == 0


def test_session_frames_bill_their_stream_on_the_ledger():
    from triton_client_tpu_torch.obs.device_time import DeviceTimeLedger

    chan, _ = _channel()
    ledger = DeviceTimeLedger()
    chan.attach_device_time(ledger)
    chan.do_inference(InferRequest("echo", _wire(_detections([(0, 0)]))))
    chan.do_inference(InferRequest("echo", _wire(_detections([(0, 0)])), sequence_id="cam"))
    assert set(ledger.device_seconds()) == {"echo|default", "echo|stream:cam"}


# -- the server -------------------------------------------------------------------


class TestServerSessions:
    def test_sequence_round_trip_tracks_across_frames(self):
        from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel

        server, manager = _server()
        try:
            client = GRPCChannel(f"127.0.0.1:{server.port}")
            try:
                tids = []
                for k in range(4):
                    resp = client.do_inference(InferRequest(
                        "echo", _wire(_detections([(0.2 * k, 0.0)])), sequence_id="cam-0",
                        sequence_start=(k == 0), sequence_end=(k == 3)))
                    assert set(tracking.OUTPUT_KEYS) <= set(resp.outputs)
                    tids.append(int(resp.outputs["det_track_ids"][0]))
                # one object, one stable id across the whole stream
                assert len(set(tids)) == 1 and tids[0] > 0
                s = manager.stats()
                assert s["frames_total"] == 4
                assert s["ended_total"] == 1
                assert s["inflight_frames"] == 0
            finally:
                client.close()
        finally:
            server.stop()

    def test_stateless_requests_untouched(self):
        from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel

        server, manager = _server()
        try:
            client = GRPCChannel(f"127.0.0.1:{server.port}")
            try:
                resp = client.do_inference(InferRequest("echo", _wire(_detections([(0, 0)]))))
                assert set(resp.outputs) == {"detections", "valid"}
                assert manager.stats()["active_sessions"] == 0
            finally:
                client.close()
        finally:
            server.stop()

    def test_session_pool_full_is_resource_exhausted(self):
        """Pin stream "a"'s reference on the manager (what a launch in flight
        holds), then knock as "b": the SessionLimitError raised inside the
        launch reaches the client as RESOURCE_EXHAUSTED."""
        import grpc

        from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel

        server, manager = _server(max_sessions=1, ttl_s=1e9)
        try:
            manager.advance(_req("a", start=True), _detections([(0, 0)]))
            client = GRPCChannel(f"127.0.0.1:{server.port}", retries=0)
            knock = InferRequest("echo", _wire(_detections([(1, 1)])), sequence_id="b",
                                 sequence_start=True)
            try:
                with pytest.raises(grpc.RpcError) as exc:
                    client.do_inference(knock)
                assert exc.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
                manager.release("a")
                # the reference dropped: the same knock now succeeds (LRU reclaim)
                assert "det_track_ids" in client.do_inference(knock).outputs
            finally:
                client.close()
        finally:
            server.stop()

    def test_collector_exports_session_plane(self):
        from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel

        server, _ = _server()
        try:
            client = GRPCChannel(f"127.0.0.1:{server.port}")
            try:
                client.do_inference(InferRequest("echo", _wire(_detections([(0, 0)])),
                                                 sequence_id="a", sequence_start=True))
            finally:
                client.close()
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{server.metrics_port}/metrics", timeout=5).read().decode()
            assert "tpu_serving_sessions_active 1.0" in body
            assert "tpu_serving_session_frames_total 1.0" in body
            assert 'tpu_serving_sessions_total{event="created"} 1.0' in body
        finally:
            server.stop()


def test_replay_streams_sustained_and_consistent():
    """Four streams of 12 frames replayed against one server: every frame
    answered, no track-id churn on clean synthetic motion, and each stream's
    device seconds under its own tenant on the ledger."""
    from triton_client_tpu_torch.utils.loadgen import run_streams, synthetic_stream

    server, manager = _server(max_sessions=16)
    try:
        res = run_streams(
            f"127.0.0.1:{server.port}", "echo", n_streams=4,
            source=lambda i: synthetic_stream(n_frames=12, fps=40.0, n_objects=3, seed=i),
            deadline_s=30.0)
        assert res.frames_ok == res.frames_sent == 4 * 12
        assert res.goodput == 1.0 and res.aliases == 0 and res.id_switches == 0
        for s in res.streams:
            assert s.sustained_fps > 0
        m = manager.stats()
        assert m["frames_total"] == 48 and m["ended_total"] == 4
        stream_tenants = {k.split("|", 1)[1] for k in server.device_time.device_seconds()
                          if "|stream:" in k}
        assert stream_tenants == {f"stream:stream-{i}" for i in range(4)}
    finally:
        server.stop()


def test_run_streams_refuses_a_replica_list(monkeypatch):
    """A replica list no longer raises: ``run_streams`` routes every stream
    by affinity through one ``FrontDoorRouter``. Each stream's frames all
    land on its rendezvous owner, whose id namespace its track ids carry;
    no frame is hedged or handed off."""
    from triton_client_tpu_torch.runtime import router
    from triton_client_tpu_torch.runtime.router import _rendezvous_score
    from triton_client_tpu_torch.utils.loadgen import run_streams, synthetic_stream

    built = []

    class Counted(router.FrontDoorRouter):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            built.append(self)

    monkeypatch.setattr(router, "FrontDoorRouter", Counted)
    servers = [_server(max_sessions=16, id_namespace=ns) for ns in (1, 2)]
    endpoints = [f"127.0.0.1:{s.port}" for s, _ in servers]
    try:
        res = run_streams(
            endpoints, "echo", n_streams=4,
            source=lambda i: synthetic_stream(n_frames=6, fps=40.0, n_objects=3, seed=i),
            deadline_s=30.0, realtime=False)
        assert res.frames_ok == res.frames_sent == 4 * 6
        assert res.id_switches == 0 and res.aliases == 0
        (fleet,) = built
        s = fleet.stats()
        assert s["affinity_routed"] == 24 and s["affinity_handoffs"] == 0
        assert s["hedges_launched"] == 0 and s["failovers"] == 0
        owner = {st.stream_id: max(endpoints, key=lambda e: (_rendezvous_score(st.stream_id, e), e))
                 for st in res.streams}
        for ns, ep, (_, manager) in zip((1, 2), endpoints, servers):
            mine = [sid for sid, o in owner.items() if o == ep]
            assert manager.stats()["frames_total"] == 6 * len(mine)
            for st in res.streams:
                if st.stream_id in mine:
                    assert st.track_map and {tid >> 27 for tid in st.track_map} == {ns}
    finally:
        for server, _ in servers:
            server.stop()


# -- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: pytest -m cuda, chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_advance_steady_state_no_host_reads(cuda_device):
    """After a warm frame, advance/release never wait for the card: run under
    set_sync_debug_mode("error"), any synchronizing call raises."""
    m = _manager()
    frame = _detections([(0, 0)], device=cuda_device)
    m.advance(_req("a", start=True), frame)
    m.release("a")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            out = m.advance(_req("a"), frame)
            m.release("a")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out["det_track_ids"].device.type == "cuda"
    assert m.stats()["frames_total"] == 6  # stats after the guard
