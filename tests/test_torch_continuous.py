"""The port's continuous batcher against the JAX package's.

The planes of ``tests/test_continuous_batching.py``, run on the port's
stack ``ContinuousBatchingChannel(CUDAChannel(repo, device="cpu"))``:
EDF order under a held slot, no window knobs, dense bitwise parity
against the window batcher and a direct call, a packed group against
solo, a threaded burst that packs, the counted fallbacks and the kernel
failures that never fall back, and the locked ragged-names cache. Then
``LiveBuckets``, the tenant fair-share order and the fault plan against
JAX's on the same inputs, and the whole slice: one white-box packed
group through JAX's ``ContinuousBatchingChannel(TPUChannel)`` with the
jnp pool body and through the port's stack with the torch pool body,
per-member outputs within 1e-6 x sum|terms| and equal ``ragged_*`` stats.

Every batcher is closed in ``finally`` and every join or wait has a
timeout, so no test can hang the suite.
"""

import concurrent.futures
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_client_tpu_torch.channel.base import InferRequest, InferResponse
from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.config import ModelSpec, TensorSpec
from triton_client_tpu_torch.models.pool import POOL_W, PoolModel, pool_spec, register_pool
from triton_client_tpu_torch.obs.trace import RequestTrace
from triton_client_tpu_torch.ops import gpu_segment
from triton_client_tpu_torch.ops.cuda_build import KernelError
from triton_client_tpu_torch.runtime import faults
from triton_client_tpu_torch.runtime.admission import DeadlineExpiredError, QueueFullError
from triton_client_tpu_torch.runtime.batching import BatchingChannel
from triton_client_tpu_torch.runtime.continuous import ContinuousBatchingChannel, LiveBuckets
from triton_client_tpu_torch.parallel.ragged_kernels import ragged_row_bucket
from triton_client_tpu_torch.runtime.padding import bucket
from triton_client_tpu_torch.runtime.repository import ModelRepository

_W = torch.from_numpy(POOL_W)


def _dense_spec(name="dense"):
    return ModelSpec(
        name=name, version="1", inputs=(TensorSpec("x", (-1, 4), "FP32"),),
        outputs=(TensorSpec("y", (-1, 4), "FP32"),),
    )


def _dense_infer_fn(inputs):
    x = inputs["x"]
    return {"y": torch.tanh(x @ _W) + 0.5 * x}


def _cloud(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 4)).astype(np.float32),
            rng.standard_normal((1, 4)).astype(np.float32))


def _expected_pool(points, bias):
    return np.tanh(points.astype(np.float64) @ POOL_W).sum(axis=0) + bias[0]


@pytest.fixture(scope="module")
def pool_repo():
    repo = ModelRepository()
    register_pool(repo, "cpu")
    return repo


def _join_all(threads, timeout=60.0):
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive()


# -- EDF admission --


class _RecordingInner:
    """Duck-typed inner channel: records launch order; the FIRST call
    blocks on a gate so the single execution slot stays held."""

    batch_multiple = 1

    def __init__(self):
        self.order = []
        self.first_started = threading.Event()
        self.gate = threading.Event()

    def get_metadata(self, name, version=""):
        raise KeyError(name)  # no spec: requests take the dense path

    def do_inference_async(self, request):
        self.order.append(request.request_id)
        if len(self.order) == 1:
            self.first_started.set()
            assert self.gate.wait(timeout=30.0)
        fut = concurrent.futures.Future()
        fut.set_result(InferResponse(model_name=request.model_name, outputs={},
                                     request_id=request.request_id))
        return fut


def _wait_ready(chan, k):
    deadline = time.time() + 10.0
    while time.time() < deadline:
        with chan._ready_cv:
            if len(chan._ready) >= k:
                return
        time.sleep(0.005)
    pytest.fail(f"the ready set never held {k} requests")


def test_edf_ordering_under_held_slot():
    inner = _RecordingInner()
    chan = ContinuousBatchingChannel(inner, max_batch=1, pipeline_depth=1, max_merge=1,
                                     pad_to_buckets=False, live_buckets=False)
    threads = []

    def submit(rid, deadline, priority=0):
        req = InferRequest("m", {"x": np.zeros((1, 4), np.float32)}, request_id=rid,
                           deadline_s=deadline, priority=priority)
        t = threading.Thread(target=chan.do_inference, args=(req,), daemon=True)
        t.start()
        threads.append(t)

    try:
        submit("blocker", None)
        assert inner.first_started.wait(timeout=30.0)
        plan = [("late", None, 0), ("d5-lo", 5.0, 0), ("d1", 1.0, 0), ("d5-hi", 5.0, 7),
                ("d05", 0.5, 0)]
        for k, (rid, dl, pr) in enumerate(plan, start=1):
            submit(rid, dl, pr)
            _wait_ready(chan, k)  # arrival order breaks the final tie
        inner.gate.set()
        _join_all(threads, 30.0)
    finally:
        inner.gate.set()
        chan.close()
    assert inner.order == ["blocker", "d05", "d1", "d5-hi", "d5-lo", "late"]


def test_window_knobs_are_not_parameters():
    inner = _RecordingInner()
    inner.gate.set()
    for kw in ({"timeout_us": 5000}, {"merge_hold_us": 9999}, {"use_native": False}):
        with pytest.raises(TypeError):
            ContinuousBatchingChannel(inner, **kw)
    chan = ContinuousBatchingChannel(inner)
    try:
        assert chan._merge_hold_s == 0  # the EDF head is never held
        assert chan._py is None  # no window thread
        s = chan.stats()
        assert s["scheduler"] == "continuous"
        assert s["pad_fraction"] == 0.0
    finally:
        chan.close()


def test_native_batcher_and_arena_are_refused():
    inner = _RecordingInner()
    for kw in ({"use_native": True}, {"arena_slots": 4}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            BatchingChannel(inner, **kw)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        ContinuousBatchingChannel(inner, arena_slots=4)


def test_queue_full_fails_fast_once_the_ready_set_is_at_capacity():
    inner = _RecordingInner()
    chan = ContinuousBatchingChannel(inner, max_batch=1, pipeline_depth=1, capacity=1,
                                     pad_to_buckets=False, live_buckets=False)
    threads = []
    try:
        for rid in ("blocker", "queued"):
            t = threading.Thread(
                target=chan.do_inference,
                args=(InferRequest("m", {"x": np.zeros((1, 4), np.float32)}, request_id=rid),),
                daemon=True,
            )
            t.start()
            threads.append(t)
            if rid == "blocker":
                assert inner.first_started.wait(timeout=30.0)
        _wait_ready(chan, 1)
        with pytest.raises(QueueFullError):
            chan.do_inference(InferRequest("m", {"x": np.zeros((1, 4), np.float32)}))
        assert chan.stats()["shed"] == {"m|0|queue": 1}
        inner.gate.set()
        _join_all(threads, 30.0)
    finally:
        inner.gate.set()
        chan.close()
    assert inner.order == ["blocker", "queued"]


def test_expired_members_are_shed_before_the_device():
    inner = _RecordingInner()
    inner.gate.set()
    chan = ContinuousBatchingChannel(inner, shed_expired=True)
    try:
        with pytest.raises(DeadlineExpiredError):
            chan.do_inference(InferRequest("m", {"x": np.zeros((1, 4), np.float32)},
                                           deadline_s=time.perf_counter() - 1.0))
        assert chan.stats()["shed"] == {"m|0|merge": 1}
    finally:
        chan.close()
    assert inner.order == []


def test_batcher_stall_probe_sleeps_under_a_fault_plan():
    """The dense group path probes ``batcher_stall`` once a group."""
    plan = faults.FaultPlan([{"point": "batcher_stall", "model": "dense", "count": 1,
                              "latency_s": 0.05}], seed=3)
    repo = ModelRepository()
    repo.register(_dense_spec(), _dense_infer_fn)
    prev = faults.install_fault_plan(plan)
    chan = ContinuousBatchingChannel(CUDAChannel(repo, "cpu"))
    try:
        x = np.ones((2, 4), np.float32)
        t0 = time.perf_counter()
        chan.do_inference(InferRequest("dense", {"x": x}))
        assert time.perf_counter() - t0 >= 0.05
        chan.do_inference(InferRequest("dense", {"x": x}))
        assert plan.stats()["fired"] == 1 and plan.stats()["rules"][0]["seen"] == 2
    finally:
        faults.install_fault_plan(prev)
        chan.close()


# -- dense bitwise parity --


def test_dense_path_bitwise_matches_window_batcher_and_direct():
    frames = {i: np.random.default_rng(i).standard_normal((2, 4)).astype(np.float32)
              for i in range(16)}

    def serve(make_batcher):
        repo = ModelRepository()
        repo.register(_dense_spec(), _dense_infer_fn)
        chan = make_batcher(CUDAChannel(repo, "cpu"))
        out = {}
        try:
            def call(i):
                out[i] = chan.do_inference(InferRequest("dense", {"x": frames[i]})).outputs["y"]

            threads = [threading.Thread(target=call, args=(i,), daemon=True) for i in frames]
            for t in threads:
                t.start()
            _join_all(threads)
            stats = chan.stats()
        finally:
            chan.close()
        return out, stats

    window, _ = serve(lambda inner: BatchingChannel(inner, max_batch=8, timeout_us=2000,
                                                    pad_to_buckets=True))
    continuous, stats = serve(lambda inner: ContinuousBatchingChannel(inner, max_batch=8,
                                                                      pad_to_buckets=True))
    for i, x in frames.items():
        direct = _dense_infer_fn({"x": torch.from_numpy(x)})["y"].numpy()
        np.testing.assert_array_equal(continuous[i], window[i])
        np.testing.assert_array_equal(continuous[i], direct)
    occ = stats["merge_occupancy"]
    assert sum(occ.values()) == stats["merges"]
    assert sum(k * v for k, v in occ.items()) == stats["merged_frames"] == 32


def test_traced_request_carries_the_batcher_spans():
    trace = RequestTrace(1, model="dense")
    repo = ModelRepository()
    repo.register(_dense_spec(), _dense_infer_fn)
    dense = ContinuousBatchingChannel(CUDAChannel(repo, "cpu"), pad_to_buckets=True)
    try:
        x = np.ones((3, 4), np.float32)
        dense.do_inference(InferRequest("dense", {"x": x}, trace=trace))
        names = {s.name for s in trace.spans}
        assert {"batch_queue", "merge_wait", "batch_merge", "batch_respond"} <= names
        assert dense.stats()["padded_frames"] == 1  # 3 rows pad to the bucket 4
    finally:
        dense.close()


# -- packed ragged parity --


def _ragged_group(sizes, seed0=100):
    clouds = {i: _cloud(seed0 + i, n) for i, n in enumerate(sizes)}
    futs = {i: concurrent.futures.Future() for i in clouds}
    group = [(None, InferRequest("pool", {"points": p, "bias": b}, request_id=str(i)), futs[i])
             for i, (p, b) in clouds.items()]
    return clouds, futs, group


def test_ragged_group_matches_solo(pool_repo):
    """White box: one multi-member group through ``_run_ragged_group``,
    every member against its solo (true-size) result."""
    sizes = (3, 11, 8, 40, 5)
    clouds, futs, group = _ragged_group(sizes)
    inner = CUDAChannel(pool_repo, "cpu")
    cont = ContinuousBatchingChannel(inner)
    try:
        cont._run_ragged_group(group)
        for i, (pts, bias) in clouds.items():
            got = futs[i].result(timeout=60.0).outputs["pooled"]
            assert got.shape == (4,)
            np.testing.assert_allclose(got, _expected_pool(pts, bias), rtol=1e-5, atol=1e-5)
            solo = inner.do_inference(InferRequest("pool", {"points": pts, "bias": bias}))
            np.testing.assert_allclose(got, solo.outputs["pooled"], rtol=1e-5, atol=1e-5)
        s = cont.stats()
        assert (s["ragged_batches"], s["ragged_segments"], s["ragged_rows"]) == (1, 5, 67)
        assert s["ragged_pad_rows"] == 80 - 67
    finally:
        cont.close()


class _RecordingBackend:
    """Warms up and "captures" by calling the body; a replay calls it again
    into the captured outputs, as a graph rewrites its static outputs."""

    def __init__(self):
        self.captures, self.owned = [], []

    def warmup(self, fn, inputs, times):
        for _ in range(times):
            fn(*inputs)

    def capture(self, fn, inputs, owner):
        self.captures.append((owner.name, tuple(tuple(a.shape) for a in inputs)))
        self.owned.append(gpu_segment._owned.tickets)
        outputs = fn(*inputs)

        def replay():
            for k, v in fn(*inputs).items():
                outputs[k].copy_(v)

        return replay, outputs, 0


def test_the_packed_route_captures_once_a_segment_and_row_bucket(pool_repo):
    """The channel's packed route goes through a captured launcher per
    segment bucket, one graph a packed-row bucket: a recording backend
    sees one capture per (segment bucket, row bucket), inside the owned
    ticket scope, and replays after that; members equal their solo
    results, as on the eager route."""
    groups = [(3, 11, 8), (3, 11, 9), (40, 5), (3, 11, 8), (3, 11, 8, 40, 5), (40, 5)]
    inner = CUDAChannel(pool_repo, "cpu")
    inner.graph_backend = backend = _RecordingBackend()
    eager = CUDAChannel(pool_repo, "cpu", capture_ragged=False)
    cont = ContinuousBatchingChannel(inner)
    try:
        keys = []
        for sizes in groups:
            clouds, futs, group = _ragged_group(sizes)
            layout_key = (bucket(len(sizes)), ragged_row_bucket(sum(sizes)))
            keys.append(layout_key)
            cont._run_ragged_group(group)
            for i, (pts, bias) in clouds.items():
                got = futs[i].result(timeout=60.0).outputs["pooled"]
                solo = eager.do_inference(InferRequest("pool", {"points": pts, "bias": bias}))
                np.testing.assert_allclose(got, solo.outputs["pooled"], rtol=1e-5, atol=1e-5)
        want = sorted(set(keys))
        got = sorted((int(name.rsplit(":", 1)[1]), shapes[0][0])
                     for name, shapes in backend.captures)
        assert got == want and len(want) < len(groups)
        assert all(isinstance(o, gpu_segment.OwnedTickets) for o in backend.owned)
        stats = inner.ragged_graph_stats()
        assert sum(s["captures"] for s in stats.values()) == len(want)
        assert sum(s["replays"] for s in stats.values()) == len(groups)
        assert sorted(stats) == sorted({k[0] for k in want})
    finally:
        cont.close()


def test_packed_request_skips_the_spec_check_and_slices_dead_segments(pool_repo):
    from triton_client_tpu_torch.channel.cuda_channel import SEGMENT_IDS_KEY
    from triton_client_tpu_torch.parallel.ragged_kernels import RaggedLayout, pack_rows

    chan = CUDAChannel(pool_repo, "cpu")
    assert chan.batch_multiple == 1
    clouds = [_cloud(7 + i, n) for i, n in enumerate((5, 9, 2))]
    layout = RaggedLayout((5, 9, 2))  # 3 segments in a bucket of 4
    bias = np.concatenate([np.stack([b for _, b in clouds]), clouds[-1][1][None]])
    req = InferRequest("pool", {"points": pack_rows([p for p, _ in clouds], layout),
                                "bias": bias}, ragged=layout)
    out = chan.do_inference(req).outputs["pooled"]
    assert out.shape == (3, 4)
    for i, (p, b) in enumerate(clouds):
        np.testing.assert_allclose(out[i], _expected_pool(p, b), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="rank"):  # dense requests keep the check
        chan.do_inference(InferRequest("pool", {"points": req.inputs["points"], "bias": bias}))
    with pytest.raises(ValueError, match="reserved"):
        chan.do_inference(InferRequest("pool", {**req.inputs, SEGMENT_IDS_KEY: bias},
                                       ragged=layout))


def test_ragged_requests_pack_end_to_end():
    """Threaded: concurrent variable-size requests through the whole
    scheduler at depth 1. A first request runs solo and holds the single
    slot inside infer_fn until the burst has queued, so the burst packs."""
    sizes = [3, 11, 8, 40, 5, 16, 7, 9, 24, 1]
    clouds = {i: _cloud(i, n) for i, n in enumerate(sizes)}
    model = PoolModel("cpu")
    entered, gate = threading.Event(), threading.Event()

    def infer_fn(inputs):
        entered.set()
        assert gate.wait(timeout=30.0)
        return model.infer_fn(inputs)

    repo = ModelRepository()
    repo.register(pool_spec(), infer_fn, ragged_fn=model.ragged_fn)
    chan = ContinuousBatchingChannel(CUDAChannel(repo, "cpu"), max_batch=8, pipeline_depth=1)
    out = {}

    def call(i):
        pts, bias = clouds[i]
        out[i] = chan.do_inference(InferRequest("pool", {"points": pts, "bias": bias}))

    try:
        threads = [threading.Thread(target=call, args=(0,), daemon=True)]
        threads[0].start()
        assert entered.wait(timeout=30.0)
        threads += [threading.Thread(target=call, args=(i,), daemon=True) for i in clouds if i]
        for t in threads[1:]:
            t.start()
        _wait_ready(chan, len(clouds) - 1)
        gate.set()
        _join_all(threads, 120.0)
        stats = chan.stats()
    finally:
        gate.set()
        chan.close()
    for i, (pts, bias) in clouds.items():
        np.testing.assert_allclose(out[i].outputs["pooled"], _expected_pool(pts, bias),
                                   rtol=1e-5, atol=1e-5)
    # the solo first request, a pack of 8 of the burst, its last arrival solo
    assert stats["merge_occupancy"] == {1: 2, 8: 1}
    assert (stats["ragged_batches"], stats["ragged_segments"]) == (1, 8)
    assert stats["ragged_rows"] in {sum(sizes[1:]) - n for n in sizes[1:]}


def test_a_failed_packed_batch_falls_back_to_solo():
    """The serving contract: a packed failure runs each member alone
    through infer_fn, so the stats show no packed batch."""
    calls = []

    def broken_ragged(inputs, ids, num_segments):
        raise RuntimeError("ragged body failed")

    def infer_fn(inputs):
        calls.append(1)
        return {"pooled": torch.tanh(inputs["points"] @ _W).sum(0) + inputs["bias"][0]}

    repo = ModelRepository()
    repo.register(pool_spec(), infer_fn, ragged_fn=broken_ragged)
    sizes = (4, 6, 3)
    clouds, futs, group = _ragged_group(sizes)
    cont = ContinuousBatchingChannel(CUDAChannel(repo, "cpu"))
    try:
        cont._run_ragged_group(group)
        for i, (pts, bias) in clouds.items():
            np.testing.assert_allclose(futs[i].result(timeout=30.0).outputs["pooled"],
                                       _expected_pool(pts, bias), rtol=1e-5, atol=1e-5)
        s = cont.stats()
        assert s["ragged_batches"] == 0 and len(calls) == len(sizes)
        assert s["ragged_fallbacks"] == 1 and s["kernel_failures"] == 0
    finally:
        cont.close()


def _dense_group(n, rows=2):
    frames = [np.random.default_rng(40 + i).standard_normal((rows, 4)).astype(np.float32)
              for i in range(n)]
    futs = [concurrent.futures.Future() for _ in frames]
    group = [(None, InferRequest("dense", {"x": x}, request_id=str(i)), f)
             for i, (x, f) in enumerate(zip(frames, futs))]
    return frames, futs, group


def test_a_failed_merged_batch_falls_back_to_solo():
    """The dense path's contract: a merged failure reruns each member
    alone, counted in ``merge_fallbacks``."""
    calls = []

    def infer_fn(inputs):
        calls.append(int(inputs["x"].shape[0]))
        if inputs["x"].shape[0] > 2:
            raise RuntimeError("merged call failed")
        return _dense_infer_fn(inputs)

    repo = ModelRepository()
    repo.register(_dense_spec(), infer_fn)
    frames, futs, group = _dense_group(3)
    cont = ContinuousBatchingChannel(CUDAChannel(repo, "cpu"))
    try:
        cont._run_group(group)
        for x, f in zip(frames, futs):
            want = _dense_infer_fn({"x": torch.from_numpy(x)})["y"].numpy()
            np.testing.assert_array_equal(f.result(timeout=30.0).outputs["y"], want)
        s = cont.stats()
        assert calls == [8, 2, 2, 2]  # 6 rows padded to the bucket 8, then each alone
        assert s["merge_fallbacks"] == 1 and s["kernel_failures"] == 0
        assert s["padded_frames"] == 0  # the padded call never ran
    finally:
        cont.close()


@pytest.mark.parametrize("path", ["packed", "merged"])
def test_a_kernel_failure_fails_the_group_without_fallback(path):
    """A kernel that fails to build, load or launch fails every member:
    no member reruns through a path that skips the kernel."""
    calls = []
    err = KernelError("segment_sum: CUDA launch failed with error 9")

    def broken(*args):
        calls.append(path)
        raise err

    repo = ModelRepository()
    if path == "packed":
        repo.register(pool_spec(), lambda inputs: calls.append("solo"), ragged_fn=broken)
        _clouds, futs, group = _ragged_group((4, 6, 3))
        futs = list(futs.values())
    else:
        repo.register(_dense_spec(), broken)
        _frames, futs, group = _dense_group(3)
    cont = ContinuousBatchingChannel(CUDAChannel(repo, "cpu"))
    try:
        if path == "packed":
            cont._run_ragged_group(group)
        else:
            cont._run_group(group)
        for f in futs:
            with pytest.raises(KernelError, match="launch failed"):
                f.result(timeout=30.0)
        s = cont.stats()
        assert calls == [path]  # one group call, no solo rerun
        assert s["kernel_failures"] == 1
        assert s["merge_fallbacks"] == s["ragged_fallbacks"] == s["ragged_batches"] == 0
    finally:
        cont.close()


def test_ragged_names_cache_fill_is_locked_and_converges():
    """Every filler inserts under ``_ragged_cache_lock`` and all converge
    on one value, with the metadata call outside the lock."""
    calls = []
    gate = threading.Event()

    class _Spec:
        extra = {"ragged_inputs": ("points",)}

    class _Inner:
        batch_multiple = 1

        def get_metadata(self, name, version=""):
            calls.append(threading.current_thread().name)
            assert gate.wait(timeout=30.0)
            return _Spec()

        def do_inference_async(self, request):
            raise AssertionError("no inference in this test")

    chan = ContinuousBatchingChannel(_Inner(), max_batch=1, pipeline_depth=1, live_buckets=False)
    workers = []
    try:
        lock = chan._ragged_cache_lock

        class _LockChecked(dict):
            def __setitem__(self, key, value):
                assert lock.locked(), "cache mutated without the lock"
                dict.__setitem__(self, key, value)

            def setdefault(self, key, default=None):
                assert lock.locked(), "cache mutated without the lock"
                return dict.setdefault(self, key, default)

        chan._ragged_inputs_cache = _LockChecked()
        results = []
        workers = [threading.Thread(target=lambda: results.append(chan._ragged_names("m", "1")),
                                    daemon=True) for _ in range(8)]
        for t in workers:
            t.start()
        for _ in range(200):
            if len(calls) == len(workers):
                break
            time.sleep(0.01)
        assert len(calls) == len(workers)
        assert not lock.locked(), "the metadata call must run outside the lock"
        gate.set()
        _join_all(workers, 30.0)
        assert results == [frozenset({"points"})] * len(workers)
        assert chan._ragged_names("m", "1") == frozenset({"points"})
        assert len(calls) == len(workers)  # the cache is warm
    finally:
        gate.set()
        chan.close()


# -- LiveBuckets against JAX's --


@pytest.mark.parametrize("multiple", [1, 2, 4])
def test_live_buckets_equal_jax(multiple):
    from triton_client_tpu.runtime.continuous import LiveBuckets as JLiveBuckets

    rng = np.random.default_rng(multiple)
    obs = np.concatenate([np.full(40, 6), rng.integers(1, 17, 200), np.full(60, 3)])
    t, j = LiveBuckets(multiple=multiple), JLiveBuckets(multiple=multiple)
    for k, total in enumerate(obs):
        t.observe(int(total))
        j.observe(int(total))
        if k % 7 == 0:
            assert t.table == j.table
            assert [t.target(n) for n in range(1, 20)] == [j.target(n) for n in range(1, 20)]
    assert t.table == j.table and len(t.table) > 0


# -- tenant fair share and the fault plan against JAX's --


def test_tenant_fair_share_orders_as_jax():
    """The deficit-round-robin hook on both stacks: the same tenant
    table, the same charges and the same arrivals under a held slot give
    the same keys, the same dispatch order and the same tenant stats."""
    from triton_client_tpu.channel import InferRequest as JRequest
    from triton_client_tpu.runtime.continuous import ContinuousBatchingChannel as JContinuous
    from triton_client_tpu.runtime.lifecycle import TenantPolicy, TenantTable

    table = TenantTable([TenantPolicy(name="gold", share=8, models=("g",)),
                         TenantPolicy(name="bronze", share=1, models=("z",))])
    x = np.zeros((1, 4), np.float32)
    plan = [("z1", "z", 1.0), ("g1", "g", 1.0), ("zn", "z", None), ("g05", "g", 0.5),
            ("gn", "g", None)]

    def drive(make_chan, make_request):
        inner = _RecordingInner()
        chan = make_chan(inner, max_batch=1, pipeline_depth=1, max_merge=1,
                         pad_to_buckets=False, live_buckets=False)
        chan.attach_tenants(table)
        threads = []

        def submit(rid, model, deadline):
            req = make_request(model, {"x": x}, request_id=rid, deadline_s=deadline)
            t = threading.Thread(target=chan.do_inference, args=(req,), daemon=True)
            t.start()
            threads.append(t)

        try:
            submit("blocker", "g", None)
            assert inner.first_started.wait(timeout=30.0)
            with chan._ready_cv:
                # bronze has had 16 frames at share 1, gold 16 at share 8
                chan._charge_tenants_locked([(("k",), 16, make_request("z", {"x": x}), None, 0.0),
                                             (("k",), 16, make_request("g", {"x": x}), None, 0.0)])
            keys = [chan._edf_key((("k",), 1, make_request(m, {"x": x}, deadline_s=d), None, 0.0))
                    for _rid, m, d in plan]
            for k, (rid, model, deadline) in enumerate(plan, start=1):
                submit(rid, model, deadline)
                _wait_ready(chan, k)
            inner.gate.set()
            _join_all(threads, 30.0)
            s = chan.stats()
        finally:
            inner.gate.set()
            chan.close()
        return keys, inner.order, s["tenant_served_frames"], s["tenant_vtime"]

    port = drive(ContinuousBatchingChannel, InferRequest)
    ref = drive(JContinuous, JRequest)
    assert port == ref
    # the over-served bronze tenant sorts after gold at equal deadlines
    assert port[1] == ["blocker", "g05", "g1", "z1", "gn", "zn"]
    assert port[2] == {"gold": 20, "bronze": 18}


def test_fault_plan_replays_as_jax():
    """A seeded plan with count windows and probabilistic rules fires on
    the same probes in the port's copy of the fault module as in JAX's."""
    from triton_client_tpu.runtime import faults as jfaults

    rules = [{"point": "batcher_stall", "model": "m", "after": 3, "count": 40, "prob": 0.5},
             {"point": "launch", "count": 25, "prob": 0.7, "message": "boom"},
             {"point": "batcher_stall", "after": 10, "count": 5, "latency_s": 0.25}]

    def replay(module):
        plan = module.FaultPlan.from_json(json.dumps({"seed": 11, "rules": rules}))
        fired = []
        for i in range(120):
            model = None if i % 3 == 0 else ("m" if i % 2 else "n")
            point = "launch" if model is None else "batcher_stall"
            try:
                fired.append(plan.check(point, model))
            except module.InjectedFault as e:
                fired.append(str(e))
        return fired, plan.stats()

    port, ref = replay(faults), replay(jfaults)
    assert port == ref
    assert port[1]["fired"] > 0 and any(isinstance(f, str) for f in port[0])
    assert 0.25 in port[0]


# -- the whole slice: JAX's stack and the port's on one packed group --


def _jax_pool_repo():
    from triton_client_tpu.config import ModelSpec as JSpec
    from triton_client_tpu.config import TensorSpec as JTensor
    from triton_client_tpu.parallel.ragged_kernels import segment_reduce
    from triton_client_tpu.runtime import ModelRepository as JRepo

    def ragged_fn(inputs, segment_ids, num_segments):
        feat = jnp.tanh(inputs["points"] @ jnp.asarray(POOL_W))
        pooled = segment_reduce(feat, segment_ids, num_segments, "sum")
        return {"pooled": pooled + jnp.squeeze(inputs["bias"], axis=1)}

    def infer_fn(inputs):
        pooled = jnp.sum(jnp.tanh(jnp.asarray(inputs["points"]) @ jnp.asarray(POOL_W)), axis=0)
        return {"pooled": np.asarray(pooled + jnp.asarray(inputs["bias"])[0])}

    spec = JSpec(name="pool", version="1",
                 inputs=(JTensor("points", (-1, 4), "FP32"), JTensor("bias", (1, 4), "FP32")),
                 outputs=(JTensor("pooled", (4,), "FP32"),),
                 extra={"ragged_inputs": ["points"]})
    repo = JRepo()
    repo.register(spec, infer_fn, ragged_fn=ragged_fn)
    return repo


@pytest.mark.parametrize("sizes", [(3, 11, 8, 40, 5), (1500, 37, 2900, 640, 2, 1024, 88, 777)])
def test_slice_matches_the_jax_stack(pool_repo, sizes):
    from triton_client_tpu.channel import InferRequest as JRequest
    from triton_client_tpu.channel import TPUChannel
    from triton_client_tpu.parallel.mesh import MeshConfig
    from triton_client_tpu.runtime.continuous import ContinuousBatchingChannel as JContinuous

    clouds, futs, group = _ragged_group(sizes, seed0=300)
    jfuts = {i: concurrent.futures.Future() for i in clouds}
    jgroup = [(None, JRequest("pool", {"points": p, "bias": b}, request_id=str(i)), jfuts[i])
              for i, (p, b) in clouds.items()]
    port = ContinuousBatchingChannel(CUDAChannel(pool_repo, "cpu"))
    ref = JContinuous(TPUChannel(_jax_pool_repo(), MeshConfig(data=-1, model=1)))
    gpu_segment.launches.reset()
    try:
        port._run_ragged_group(group)
        ref._run_ragged_group(jgroup)
        for i, (pts, bias) in clouds.items():
            got = futs[i].result(timeout=60.0).outputs["pooled"]
            want = np.asarray(jfuts[i].result(timeout=60.0).outputs["pooled"])
            terms = float(np.abs(np.tanh(pts.astype(np.float64) @ POOL_W)).sum())
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * terms + 1e-6)
        keys = ("ragged_batches", "ragged_segments", "ragged_rows", "ragged_pad_rows")
        ps, rs = port.stats(), ref.stats()
        assert {k: ps[k] for k in keys} == {k: rs[k] for k in keys}
        assert ps["pad_fraction"] == rs["pad_fraction"]
    finally:
        port.close()
        ref.close()
    assert gpu_segment.launches.count == 0  # CPU tensors run the plain version
