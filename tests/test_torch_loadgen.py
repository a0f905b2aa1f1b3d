"""The port's load generator (``utils/loadgen.py``) against the JAX
package's, on the CPU.

- ``poisson_schedule`` equals JAX's for several seeds, rates and weights;
  ``co_percentile`` and every ``OpenLoopResult`` property equal JAX's on
  the same latency lists, unanswered requests (+Inf) included.
- ``run_open_loop`` and ``slo_capacity_search`` through channel-shaped
  stubs (one that answers at once, one that raises) give JAX's schedules,
  counts and probe logs; failures score +Inf.
- ``run_pool`` in each mode (unary, stream, async) and ``run_open_loop``
  against the port's ``serve`` on a loopback port with a 64x64 YOLOv5n:
  counts and errors are asserted, rates are not (they are the host's).
  Every client thread has exited and every shared-memory region is
  unregistered when a run returns.
- A list of addresses raises naming ROADMAP item 8 (the router).
- The streaming replay's pieces: ``synthetic_stream`` equals JAX's bit for
  bit for the same arguments (every ``dynamics``); ``_score_tracking``,
  ``_score_coast`` and ``StreamsResult.summary()`` equal JAX's on the same
  recorded stats; ``run_streams`` through a channel-shaped echo stub gives
  JAX's per-stream counts and scores.
"""

import math
import pathlib
import threading

import numpy as np
import pytest

from triton_client_tpu.utils import loadgen as jlg

from triton_client_tpu_torch.channel.base import InferFuture, InferResponse
from triton_client_tpu_torch.cli import serve
from triton_client_tpu_torch.utils import loadgen as tlg
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = """family: yolov5
model:
  variant: n
  input_hw: [64, 64]
pipeline:
  class_names_file: data/crop.names
  conf_thresh: 0.05
max_batch_size: 4
"""
FRAME = np.random.default_rng(0).integers(0, 256, (1, 48, 80, 3), dtype=np.uint8)


@pytest.mark.parametrize("rate,duration,seed,weights", [
    (10.0, 2.0, 0, None), (250.0, 1.5, 7, None), (40.0, 3.0, 3, [1.0, 3.0]),
    (5.0, 0.5, 11, [0.2, 0.3, 0.5]), (0.0, 1.0, 0, None), (30.0, 0.0, 1, [1, 1]),
])
def test_poisson_schedule_equals_jax(rate, duration, seed, weights):
    got = tlg.poisson_schedule(rate, duration, seed=seed, weights=weights)
    want = jlg.poisson_schedule(rate, duration, seed=seed, weights=weights)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (got[0] < duration).all() if len(got[0]) else True


LATENCY_LISTS = [([], 0), ([], 5), ([3.0], 1), ([5.0, 1.0, 2.0, 4.0], 4),
                 ([5.0, 1.0, 2.0, 4.0], 10), (list(np.linspace(1, 40, 37)), 40)]


@pytest.mark.parametrize("lats,scheduled", LATENCY_LISTS)
def test_co_percentile_and_open_loop_result_equal_jax(lats, scheduled):
    errors = ["RpcError RESOURCE_EXHAUSTED", "boom"][: max(0, scheduled - len(lats))]
    args = dict(offered_qps=20.0, scheduled=scheduled, completed=len(lats), wall_s=2.0,
                latencies_ms=list(lats), errors=errors)
    got, want = tlg.OpenLoopResult(**args), jlg.OpenLoopResult(**args)
    for q in (0, 1, 50, 90, 99, 99.9, 100):
        assert tlg.co_percentile(lats, scheduled, q) == jlg.co_percentile(lats, scheduled, q)
        assert got.percentile(q) == want.percentile(q)
    for slo in (0.5, 2.0, 30.0):
        assert got.attainment(slo) == want.attainment(slo)
        assert got.goodput_qps(slo) == want.goodput_qps(slo)
    assert (got.achieved_qps, got.shed_count, got.shed_rate) == \
        (want.achieved_qps, want.shed_count, want.shed_rate)
    if scheduled > len(lats):  # the unanswered tail is +Inf
        assert got.percentile(100) == math.inf


class _Stub:
    """A channel-shaped target (driven, never closed): answers the warm
    request, then answers every scheduled one at once, or fails it."""

    def __init__(self, fail=False):
        self.fail, self.calls, self.closed = fail, 0, False

    def do_inference(self, request):
        return InferResponse(model_name=request.model_name, model_version="1", outputs={})

    def do_inference_async(self, request):
        self.calls += 1
        if self.fail:
            return InferFuture.failed(RuntimeError("stub failure"))
        return InferFuture.completed(self.do_inference(request))

    def close(self):
        self.closed = True


def _no_loadgen_threads():
    return [t.name for t in threading.enumerate()
            if "client_loop" in t.name or t.name.startswith("openloop-res")] == []


@pytest.mark.parametrize("fail", [False, True], ids=["answers", "fails"])
def test_open_loop_through_a_stub_equals_jax(fail):
    scen = [("a", {"x": np.zeros(2, np.float32)}), ("b", {"x": np.ones(2, np.float32)}, 3.0)]
    runs = []
    for lg in (tlg, jlg):
        stub = _Stub(fail)
        res = lg.run_open_loop(stub, scen, rate_qps=200.0, duration_s=0.25, seed=5, warm=False,
                               resolvers=4)
        runs.append((res, stub))
        assert not stub.closed  # a channel target is driven, not closed
    (got, tstub), (want, jstub) = runs
    assert got.scheduled == want.scheduled == tstub.calls == jstub.calls > 20
    assert got.completed == want.completed == (0 if fail else got.scheduled)
    assert len(got.errors) == len(want.errors) == (got.scheduled if fail else 0)
    if fail:  # every request unanswered: +Inf at every percentile
        assert got.percentile(50) == got.percentile(99) == math.inf
        assert "stub failure" in got.errors[0]
    else:
        assert len(got.latencies_ms) == got.scheduled and got.percentile(99) < math.inf
    assert _no_loadgen_threads()


@pytest.mark.parametrize("fail", [False, True], ids=["answers", "fails"])
def test_slo_capacity_search_through_a_stub_equals_jax(fail):
    scen = [("a", {"x": np.zeros(2, np.float32)})]
    kw = dict(slo_ms=500.0, duration_s=0.1, seed=2, qps_lo=16.0, qps_hi=256.0, iters=4)
    got = tlg.slo_capacity_search(_Stub(fail), scen, **kw)
    want = jlg.slo_capacity_search(_Stub(fail), scen, **kw)
    keys = ("offered_qps", "scheduled", "completed", "errors")
    assert [{k: p[k] for k in keys} for p in got["probes"]] == \
        [{k: p[k] for k in keys} for p in want["probes"]]
    assert got["slo_capacity_qps"] == want["slo_capacity_qps"] == (0.0 if fail else 256.0)
    assert set(got) == set(want)
    if fail:
        assert got["p99_ms"] == math.inf and len(got["probes"]) == 1


def test_a_list_of_addresses_raises_naming_the_router_item():
    for call in (lambda: tlg._dial(["127.0.0.1:1", "127.0.0.1:2"], 1.0),
                 lambda: tlg.run_open_loop(["127.0.0.1:1"], [("m", {})], 1.0, 0.1),
                 lambda: tlg.slo_capacity_search(("127.0.0.1:1",), [("m", {})], 10.0),
                 lambda: tlg.run_streams(["127.0.0.1:1"], "m", 1, lambda i: [])):
        with pytest.raises(NotImplementedError, match="item 8, step 5"):
            call()
    with pytest.raises(TypeError, match="loadgen target"):
        tlg._dial(3, 1.0)
    with pytest.raises(ValueError, match="at least one scenario"):
        tlg.run_open_loop(_Stub(), [], 1.0, 0.1)
    with pytest.raises(ValueError, match="unknown pool mode"):
        tlg.run_pool("127.0.0.1:1", "m", {}, 1, 0.1, mode="bogus")


# -- streaming replay ----------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n_frames=6), dict(n_frames=12, fps=40.0, n_objects=3, seed=2),
    dict(n_frames=9, det_dim=13, clutter=0, speed=2.5, seed=5),
    dict(n_frames=14, dynamics="static", seed=1), dict(n_frames=14, dynamics="pan", seed=3),
    dict(n_frames=30, dynamics="burst", phase_frames=5, seed=4),
    dict(n_frames=40, dynamics="mixed", phase_frames=4, seed=9),
])
def test_synthetic_stream_equals_jax_bitwise(kw):
    got, want = list(tlg.synthetic_stream(**kw)), list(jlg.synthetic_stream(**kw))
    assert len(got) == len(want) == kw["n_frames"]
    for (g_off, g_in, g_gt), (w_off, w_in, w_gt) in zip(got, want):
        assert g_off == w_off
        for name in ("detections", "valid"):
            assert g_in[name].dtype == w_in[name].dtype
            np.testing.assert_array_equal(g_in[name], w_in[name])
        np.testing.assert_array_equal(g_gt, w_gt)
    for bad in (dict(n_frames=1, det_dim=9), dict(n_frames=1, dynamics="spin")):
        with pytest.raises(ValueError):
            list(tlg.synthetic_stream(**bad))


def _scored(mod, seed):
    """One StreamStats per module, fed the same seeded per-frame track ids
    (switches, clutter, -1 rows, an alias) and coast frames."""
    rng = np.random.default_rng(seed)
    stats = mod.StreamStats(f"stream-{seed}")
    gt_to_tid, tids_per_gt = {}, {}
    gt = np.array([0, 1, 2, -1])
    for k in range(12):
        tids = np.array([10, 11, 12, 99], np.int32)
        tids[rng.random(4) < 0.2] = -1
        if k == 6:
            tids[:2] = tids[1::-1]  # two objects swap ids: switches and aliases
        mod._score_tracking(stats, tids, gt, gt_to_tid, tids_per_gt)
        live = np.array([10, 11, 12, 13]) if k % 4 else np.array([10, 0, 12, 13])
        mod._score_coast(stats, {"track_ids": live, "tracks_valid": live > 0}, gt_to_tid)
        stats.frames_sent += 1
        stats.frames_ok += int(k != 3)
        stats.latencies_ms.append(float(rng.uniform(1, 20)))
        stats.inter_frame_ms.append(float(rng.uniform(20, 40)))
    stats.wall_s = 1.25 + seed
    stats.fragmentation = sum(len(s) - 1 for s in tids_per_gt.values())
    return stats


def test_stream_scores_and_summary_equal_jax():
    got = tlg.StreamsResult(streams=[_scored(tlg, s) for s in range(3)], wall_s=4.5)
    want = jlg.StreamsResult(streams=[_scored(jlg, s) for s in range(3)], wall_s=4.5)
    assert got.summary() == want.summary()
    assert got.summary()["id_switches"] > 0 and got.summary()["coast_track_drops"] > 0
    for g, w in zip(got.streams, want.streams):
        assert (g.track_map, g.aliases, g.inter_frame_p99(), g.sustained_fps) == \
            (w.track_map, w.aliases, w.inter_frame_p99(), w.sustained_fps)
    assert tlg.StreamsResult().summary() == jlg.StreamsResult().summary()


class _EchoTracker:
    """A channel-shaped stub that answers each frame with per-detection
    track ids ``100 + gt`` (a perfect tracker), clutter -1."""

    def __init__(self, response_cls, swap_at=None):
        self._cls = response_cls
        self._swap_at = swap_at
        self._frames = {}  # sequence_id -> frames seen (one stream's thread each)

    def do_inference_async(self, request):  # marks the stub channel-shaped
        raise NotImplementedError

    def do_inference(self, request):
        k = self._frames[request.sequence_id] = self._frames.get(request.sequence_id, 0) + 1
        det = np.asarray(request.inputs["detections"])
        ids = np.where(det[:, -2] > 0.5, 100 + np.arange(det.shape[0]), -1).astype(np.int32)
        if self._swap_at is not None and k % self._swap_at == 0:
            ids[:2] = ids[1::-1]
        return self._cls(model_name=request.model_name, model_version="1",
                         outputs={"det_track_ids": ids})


@pytest.mark.parametrize("swap_at", [None, 5])
def test_run_streams_through_a_stub_equals_jax(swap_at):
    from triton_client_tpu.channel.base import InferResponse as JResponse

    def source(i):
        return tlg.synthetic_stream(n_frames=10, n_objects=3, seed=i)

    got = tlg.run_streams(_EchoTracker(InferResponse, swap_at), "m", 3, source, realtime=False)
    want = jlg.run_streams(_EchoTracker(JResponse, swap_at), "m", 3, source, realtime=False)
    for key in ("streams", "frames_sent", "frames_ok", "goodput", "frames_detected",
                "id_switches", "fragmentation", "track_id_aliases"):
        assert got.summary()[key] == want.summary()[key], key
    for g, w in zip(got.streams, want.streams):
        assert (g.stream_id, g.track_map, g.id_switches) == (w.stream_id, w.track_map,
                                                             w.id_switches)
    assert (got.id_switches > 0) == (swap_at is not None)


# -- against the port's serve on a loopback port ----------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("repo")
    (root / "tiny").mkdir()
    (root / "tiny" / "config.yaml").write_text(TINY)
    mp = pytest.MonkeyPatch()
    mp.chdir(ROOT)  # data/crop.names
    try:
        server = serve.build_server(serve.parser().parse_args(
            ["-r", str(root), "-a", "127.0.0.1:0", "--device", "cpu", "--max-workers", "8",
             "--warmup"]))
    finally:
        mp.undo()
    server.start()
    yield server, f"127.0.0.1:{server.port}"
    server.stop()


@pytest.mark.parametrize("mode,inflight,group", [("unary", 1, 1), ("stream", 2, 4),
                                                 ("async", 2, 1)])
def test_run_pool_against_serve(served, monkeypatch, mode, inflight, group):
    """Two clients for a second: every client warms, the window opens once
    after the barrier, requests complete without error, and nothing of the
    pool outlives the call (threads joined, shm regions unregistered).
    ``stream_group`` is clamped to ``inflight``. How many complete inside
    the window is the host's rate, so only completions at all are held."""
    from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel

    server, address = served
    groups = []
    stream = GRPCChannel.infer_stream

    def recording(self, requests, stream_timeout_s=3600.0, group_size=1):
        groups.append(group_size)
        return stream(self, requests, stream_timeout_s=stream_timeout_s, group_size=group_size)

    monkeypatch.setattr(GRPCChannel, "infer_stream", recording)
    windows = []
    res = tlg.run_pool(address, "tiny", {"images": FRAME}, clients=2, duration_s=1.0,
                       deadline_s=60.0, stagger_s=0.05, mode=mode, inflight=inflight,
                       stream_group=group, on_window_start=lambda: windows.append(1))
    assert res.errors == [] and windows == [1]
    assert len(res.latencies_ms) >= 2 and len(res.latencies_ms) >= res.served_frames
    assert 1.0 <= res.wall_s < 10.0
    assert all(v > 0 for v in res.latencies_ms)
    assert groups == ([min(group, inflight)] * 2 if mode == "stream" else [])
    assert _no_loadgen_threads()
    assert server.shm_registry.status() == {}


def test_run_open_loop_against_serve(served):
    _, address = served
    scen = [("tiny", {"images": FRAME})]
    res = tlg.run_open_loop(address, scen, rate_qps=20.0, duration_s=1.0, seed=4, resolvers=4)
    offsets, _ = tlg.poisson_schedule(20.0, 1.0, seed=4, weights=[1.0])
    assert res.scheduled == len(offsets) > 5
    assert res.errors == [] and res.completed == res.scheduled == len(res.latencies_ms)
    assert res.percentile(99) < math.inf and res.wall_s == 1.0
    assert _no_loadgen_threads()
    assert served[0].shm_registry.status() == {}
