"""The port's staged channel (``channel/staged.py`` through
``CUDAChannel(device="cpu")``) against the JAX ``TPUChannel``.

The toy model of ``tests/test_overlap_dispatch.py`` (with a torch body)
and a tiny YOLOv5 whose flax weights are carried across run through both
channels: the same request sequences give the same ``stats()``, the same
breaker states and the same failures, and outputs agree at the pipeline
tests' bars. The JAX staged-engine tests fail on this tree (jit against
eager differs by ~1e-7 on the CPU), so the port's staged path is held
bitwise to its own eager path, and to JAX at the stated tolerance.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_client_tpu.channel import InferRequest as JRequest
from triton_client_tpu.channel import TPUChannel
from triton_client_tpu.config import ModelSpec as JSpec
from triton_client_tpu.config import TensorSpec as JTensor
from triton_client_tpu.parallel.mesh import MeshConfig
from triton_client_tpu.runtime import ModelRepository as JRepository
from triton_client_tpu.runtime import faults as jfaults
from triton_client_tpu.runtime.admission import CircuitBreaker as JBreaker

from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.config import ModelSpec, TensorSpec
from triton_client_tpu_torch.runtime import faults
from triton_client_tpu_torch.runtime.admission import (
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExpiredError,
)
from triton_client_tpu_torch.runtime.repository import ModelRepository
from torch_threads import one_torch_thread  # noqa: F401

_W = np.linspace(-1.0, 1.0, 16, dtype=np.float32).reshape(4, 4)
STAT_KEYS = ("staged", "launched", "donated_launches", "stage_slot_waits", "slot_occupancy",
             "inflight", "launch_failures", "deadline_expired_launches", "shed")


def _compute_torch(inputs):
    x = inputs["x"]
    y = torch.tanh(x @ torch.from_numpy(_W)) + 0.5 * x
    return {"y": y, "cls": torch.argmax(y, dim=-1).to(torch.int32)}


def _compute_jax(inputs):
    x = inputs["x"]
    y = jnp.tanh(x @ jnp.asarray(_W)) + 0.5 * x
    return {"y": y, "cls": jnp.argmax(y, axis=-1).astype(jnp.int32)}


def _tensors(mod):
    return (
        (mod("x", (-1, 4), "FP32", donatable=True),),
        (mod("y", (-1, 4), "FP32"), mod("cls", (-1,), "INT64")),
    )


def _spec(name):
    inputs, outputs = _tensors(TensorSpec)
    return ModelSpec(name=name, version="1", inputs=inputs, outputs=outputs)


def _jspec(name):
    inputs, outputs = _tensors(JTensor)
    return JSpec(name=name, version="1", inputs=inputs, outputs=outputs)


def _eager_torch(inputs):
    return _compute_torch({k: torch.as_tensor(v) for k, v in inputs.items()})


def _eager_jax(inputs):
    out = jax.jit(_compute_jax)(inputs)
    return {"y": np.asarray(out["y"]), "cls": np.asarray(out["cls"], dtype=np.int64)}


def _port(depth=2, **kw):
    repo = ModelRepository()
    repo.register(_spec("staged"), _eager_torch, device_fn=_compute_torch)
    repo.register(_spec("eager"), _eager_torch)
    return repo, CUDAChannel(repo, device="cpu", pipeline_depth=depth, **kw)


def _jax(depth=2, **kw):
    repo = JRepository()
    repo.register(_jspec("staged"), _eager_jax, device_fn=_compute_jax)
    repo.register(_jspec("eager"), _eager_jax)
    return repo, TPUChannel(repo, MeshConfig(data=-1, model=1), pipeline_depth=depth, **kw)


def _frame(seed, batch=8):
    return np.random.default_rng(seed).standard_normal((batch, 4)).astype(np.float32)


def _stats(chan):
    s = chan.stats()
    return {k: s[k] for k in STAT_KEYS}


@pytest.fixture(autouse=True)
def _no_fault_plans():
    prev, jprev = faults.install_fault_plan(None), jfaults.install_fault_plan(None)
    yield
    faults.install_fault_plan(prev)
    jfaults.install_fault_plan(jprev)


def test_staged_equals_eager_bitwise_and_jax_within_1e6():
    _, chan = _port()
    _, jchan = _jax()
    for seed in range(4):
        x = _frame(seed)
        staged = chan.do_inference(InferRequest("staged", {"x": x})).outputs
        eager = chan.do_inference(InferRequest("eager", {"x": x})).outputs
        want = jchan.do_inference(JRequest("staged", {"x": x})).outputs
        jchan.do_inference(JRequest("eager", {"x": x}))
        for k in ("y", "cls"):
            assert staged[k].tobytes() == eager[k].tobytes()
            assert staged[k].dtype == want[k].dtype
        np.testing.assert_allclose(staged["y"], want["y"], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(staged["cls"], want["cls"])
    assert staged["cls"].dtype == np.int64  # the wire contract
    assert _stats(chan) == _stats(jchan)
    assert chan.stats()["donated_launches"] == 4


def _sequence_async(chan, make, n):
    futs = [chan.do_inference_async(make(s)) for s in range(n)]
    return [f.result() for f in futs]


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("shape", ["async6", "sync3_async3", "interleaved"])
def test_the_same_sequence_gives_the_same_stats(depth, shape):
    _, chan = _port(depth)
    _, jchan = _jax(depth)
    for c, req in ((chan, InferRequest), (jchan, JRequest)):
        make = lambda s, req=req: req("staged", {"x": _frame(s)})  # noqa: E731
        if shape == "async6":
            _sequence_async(c, make, 6)
        elif shape == "sync3_async3":
            for s in range(3):
                c.do_inference(make(s))
            _sequence_async(c, make, 3)
        else:
            f1 = c.do_inference_async(make(0))
            c.do_inference(make(1))
            f2 = c.do_inference_async(make(2))
            f1.result()
            f3 = c.do_inference_async(make(3))
            f3.result()
            f2.result()
    assert _stats(chan) == _stats(jchan)
    if depth == 1:
        assert set(chan.stats()["slot_occupancy"]) == {1}


def test_two_in_flight_each_get_their_own_outputs():
    _, chan = _port(2)
    xa, xb = _frame(1), _frame(2)
    fa = chan.do_inference_async(InferRequest("staged", {"x": xa}))
    fb = chan.do_inference_async(InferRequest("staged", {"x": xb}))
    out_b, out_a = fb.result().outputs, fa.result().outputs
    np.testing.assert_array_equal(out_a["y"], _eager_torch({"x": xa})["y"].numpy())
    np.testing.assert_array_equal(out_b["y"], _eager_torch({"x": xb})["y"].numpy())
    np.testing.assert_array_equal(xa, _frame(1))  # host arrays untouched


def test_future_resolves_exactly_once():
    _, chan = _port()
    fut = chan.do_inference_async(InferRequest("staged", {"x": _frame(7)}))
    r1 = fut.result()
    assert chan.stats()["inflight"] == 0
    assert fut.result() is r1
    stats = chan.stats()
    assert stats["launched"] == 1 and sum(stats["slot_occupancy"].values()) == 1


def test_dispatch_errors_are_deferred_to_result():
    _, chan = _port()
    _, jchan = _jax()
    for c, req in ((chan, InferRequest), (jchan, JRequest)):
        fut = c.do_inference_async(req("staged", {}))
        with pytest.raises(ValueError, match="requires input"):
            fut.result()
        with pytest.raises(KeyError):
            c.do_inference_async(req("missing", {"x": _frame(0)})).result()
        assert c.stats()["inflight"] == 0 and c.stats()["slots_active"] == 0
        assert c.do_inference(req("staged", {"x": _frame(3)})).outputs["y"].shape == (8, 4)
    assert _stats(chan) == _stats(jchan)


def test_breaker_walks_the_same_states_as_jax():
    steps = [("fail", 0.0), ("allow", 0.5), ("fail", 0.6), ("allow", 0.7), ("fail", 0.8),
             ("allow", 1.0), ("allow", 1.9), ("allow", 2.0), ("allow", 2.1), ("fail", 2.2),
             ("allow", 2.5), ("allow", 3.3), ("ok", 3.4), ("allow", 3.5), ("fail", 3.6)]
    port, ref = CircuitBreaker(threshold=3, reset_s=1.0), JBreaker(threshold=3, reset_s=1.0)
    for op, now in steps:
        if op == "allow":
            assert port.allow("m", now) == ref.allow("m", now), (op, now)
        elif op == "fail":
            assert port.record_failure("m", now) == ref.record_failure("m", now), (op, now)
        else:
            port.record_success("m")
            ref.record_success("m")
        assert port.states() == ref.states() and port.state("m") == ref.state("m")
    assert port.states()["m"]["opens"] == 2


def test_channel_breaker_opens_half_opens_and_closes_as_jax():
    _, chan = _port(breaker_threshold=2, breaker_reset_s=0.0)
    _, jchan = _jax(breaker_threshold=2, breaker_reset_s=0.0)
    plan = {"point": "launch", "model": "staged", "after": 0, "count": 2}
    walks = []
    for c, req, mod in ((chan, InferRequest, faults), (jchan, JRequest, jfaults)):
        mod.install_fault_plan(mod.FaultPlan([plan], seed=7))
        walk = []
        for s in range(2):
            with pytest.raises(mod.InjectedFault):
                c.do_inference(req("staged", {"x": _frame(s)}))
            walk.append(c.stats()["breaker"])
        probe = c.do_inference_async(req("staged", {"x": _frame(2)}))  # the half-open probe
        walk.append(c.stats()["breaker"])
        probe.result()
        walk.append(c.stats()["breaker"])
        walks.append(walk)
        mod.install_fault_plan(None)
    assert walks[0] == walks[1]
    assert [w["staged"]["state"] for w in walks[0]] == [0, 2, 1, 0]
    assert _stats(chan) == _stats(jchan)


def test_an_open_breaker_fails_fast_and_drops_the_launcher():
    _, chan = _port(breaker_threshold=1, breaker_reset_s=60.0)
    chan.do_inference(InferRequest("staged", {"x": _frame(0)}))
    assert ("staged", "1") in chan._launch_cache
    faults.install_fault_plan(faults.FaultPlan([{"point": "launch", "model": "staged"}]))
    with pytest.raises(faults.InjectedFault):
        chan.do_inference(InferRequest("staged", {"x": _frame(1)}))
    assert ("staged", "1") not in chan._launch_cache
    with pytest.raises(CircuitOpenError):
        chan.do_inference(InferRequest("staged", {"x": _frame(2)}))
    assert chan.stats()["shed"] == {"staged|0|breaker": 1}
    # other models stay served
    assert chan.do_inference(InferRequest("eager", {"x": _frame(3)})).outputs["y"].shape == (8, 4)


def test_shed_expired_fails_late_requests_as_jax():
    _, chan = _port(shed_expired=True)
    _, jchan = _jax(shed_expired=True)
    for c, req in ((chan, InferRequest), (jchan, JRequest)):
        late = req("staged", {"x": _frame(0)}, priority=2)
        late.deadline_s = time.perf_counter() - 1.0
        fut = c.do_inference_async(late)
        with pytest.raises(Exception) as err:
            fut.result()
        assert type(err.value).__name__ == "DeadlineExpiredError"
        on_time = req("staged", {"x": _frame(1)})
        on_time.deadline_s = time.perf_counter() + 60.0
        c.do_inference(on_time)
    assert isinstance(err.value, Exception)
    assert _stats(chan) == _stats(jchan)
    assert chan.stats()["shed"] == {"staged|2|launch": 1}
    with pytest.raises(DeadlineExpiredError):
        late = InferRequest("staged", {"x": _frame(0)})
        late.deadline_s = time.perf_counter() - 1.0
        chan.do_inference(late)


def test_unregister_drops_the_cached_launcher():
    repo, chan = _port()
    jrepo, jchan = _jax()
    for r, c, req in ((repo, chan, InferRequest), (jrepo, jchan, JRequest)):
        c.do_inference(req("staged", {"x": _frame(0)}))
        assert ("staged", "1") in c._launch_cache
        r.unregister("staged", "1")
        assert ("staged", "1") not in c._launch_cache
        with pytest.raises(KeyError):
            c.do_inference(req("staged", {"x": _frame(0)}))
    repo.register(_spec("staged"), _eager_torch, device_fn=_compute_torch)
    assert chan.do_inference(InferRequest("staged", {"x": _frame(0)})).outputs["y"].shape == (8, 4)


@pytest.mark.parametrize("point", ["launch", "readback"])
def test_a_fault_fails_only_its_own_future(point):
    _, chan = _port()
    _, jchan = _jax()
    plan = {"point": point, "model": "staged", "after": 1, "count": 1}
    for c, req, mod in ((chan, InferRequest, faults), (jchan, JRequest, jfaults)):
        mod.install_fault_plan(mod.FaultPlan([plan], seed=3))
        futs = [c.do_inference_async(req("staged", {"x": _frame(s)})) for s in range(3)]
        for s, fut in enumerate(futs):  # readbacks probe in resolve order
            if s == 1:
                with pytest.raises(mod.InjectedFault):
                    fut.result()
            else:
                np.testing.assert_allclose(fut.result().outputs["y"],
                                           _eager_torch({"x": _frame(s)})["y"].numpy(),
                                           rtol=1e-6, atol=1e-6)
        mod.install_fault_plan(None)
    assert _stats(chan) == _stats(jchan)
    assert chan.stats()["launch_failures"] == 1
    assert chan.stats()["breaker"] == {"staged": {"state": 0, "opens": 0, "consecutive": 0}}


@pytest.mark.parametrize("hook", ["attach_lifecycle", "attach_device_time", "attach_sessions"])
def test_slot_buffers_and_hooks_not_ported(hook):
    """Every hook is ported. The sessions hook attaches a manager, and a
    session frame then carries the track tensors (the toy model has no
    detections head, so a 6-column echo model rides beside it;
    tests/test_torch_sessions.py holds the rest); the device-time hook takes
    a ledger, which then accounts one launch a request
    (tests/test_torch_device_time.py holds the rest); the lifecycle hook: a
    request promotes its model (tests/test_torch_lifecycle.py holds the
    rest)."""
    from triton_client_tpu_torch.obs.device_time import DeviceTimeLedger
    from triton_client_tpu_torch.ops.tracking import OUTPUT_KEYS
    from triton_client_tpu_torch.runtime.lifecycle import ModelLifecycleManager
    from triton_client_tpu_torch.runtime.sessions import SessionManager

    _, chan = _port()
    attach = getattr(chan, hook)
    if hook == "attach_sessions":
        manager = SessionManager(max_sessions=2)
        attach(manager)
        assert chan.sessions is manager
        spec = ModelSpec(name="echo6", version="1",
                         inputs=(TensorSpec("detections", (-1, 6), "FP32"),),
                         outputs=(TensorSpec("detections", (-1, 6), "FP32"),
                                  TensorSpec("valid", (-1,), "BOOL")))
        chan._repository.register(spec, lambda inputs: {
            "detections": inputs["detections"], "valid": inputs["detections"][:, 4] > 0})
        det = np.zeros((3, 6), np.float32)
        det[0] = (1.0, 2.0, 5.0, 6.0, 0.9, 0.0)
        plain = chan.do_inference(InferRequest("staged", {"x": _frame(0)}, sequence_id="s"))
        assert set(plain.outputs) == {"y", "cls"}  # no detections head: passes through
        resp = chan.do_inference(InferRequest("echo6", {"detections": det}, sequence_id="s"))
        assert set(OUTPUT_KEYS) <= set(resp.outputs)
        assert resp.outputs["det_track_ids"][0] > 0 and resp.outputs["tracks"].shape == (64, 6)
        assert manager.stats()["frames_total"] == 1 and manager.stats()["inflight_frames"] == 0
        return
    if hook == "attach_lifecycle":
        manager = ModelLifecycleManager(chan._repository)
        attach(manager)
        assert chan.lifecycle is manager
        chan.do_inference(InferRequest("staged", {"x": _frame(0)}))
        stats = manager.stats()
        assert stats["promotions"] == 1 and stats["states"]["warm"] == 1
        return
    ledger = DeviceTimeLedger()
    attach(ledger)
    assert chan.device_time is ledger
    chan.do_inference(InferRequest("staged", {"x": _frame(0)}))
    assert ledger.snapshot()["launches"] == {"staged": 1}


@pytest.fixture(scope="module")
def yolo_pair():
    from triton_client_tpu.pipelines import detect2d as jdet

    from triton_client_tpu_torch.pipelines import detect2d as tdet

    kw = dict(num_classes=2, input_hw=(128, 128), conf_thresh=0.05, max_det=100)
    jpipe, jspec, variables = jdet.build_yolov5_pipeline(
        jax.random.PRNGKey(0), variant="n", num_classes=2, input_hw=(128, 128),
        config=jdet.Detect2DConfig(**kw),
    )
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    tpipe, tspec, _ = tdet.build_yolov5_pipeline(
        variant="n", num_classes=2, input_hw=(128, 128), variables=variables,
        config=tdet.Detect2DConfig(**kw), device="cpu",
    )
    return jpipe, jspec, tpipe, tspec


def test_tiny_yolov5_through_both_staged_channels(yolo_pair):
    import dataclasses

    jpipe, jspec, tpipe, tspec = yolo_pair
    repo = ModelRepository()
    repo.register(tspec, tpipe.infer_fn(), device_fn=tpipe.device_fn())
    repo.register(dataclasses.replace(tspec, name="eager"), tpipe.infer_fn())
    chan = CUDAChannel(repo, device="cpu")
    jrepo = JRepository()
    jrepo.register(jspec, jpipe.infer_fn(), device_fn=jpipe.device_fn())
    jchan = TPUChannel(jrepo, MeshConfig(data=-1, model=1))
    frames = np.random.default_rng(4).integers(0, 255, (2, 96, 128, 3), dtype=np.uint8)
    fut = chan.do_inference_async(InferRequest(tspec.name, {"images": frames}))
    eager = chan.do_inference(InferRequest("eager", {"images": frames})).outputs
    staged = fut.result().outputs
    want = jchan.do_inference(JRequest(jspec.name, {"images": frames})).outputs
    for k in ("detections", "valid"):
        assert staged[k].tobytes() == eager[k].tobytes()
    np.testing.assert_array_equal(staged["valid"], want["valid"])
    np.testing.assert_allclose(staged["detections"], want["detections"], rtol=1e-3, atol=1e-2)
    assert staged["valid"].sum() > 20
    launcher = chan._launch_cache[(tspec.name, "1")][1]
    assert launcher.graphs.stats()["calls"] == 1  # the device_fn path, through runtime/graphs


def test_a_traced_request_gets_the_engine_spans():
    from triton_client_tpu_torch.obs.trace import RequestTrace

    _, chan = _port()
    req = InferRequest("staged", {"x": _frame(0)})
    req.trace = RequestTrace(1, "staged")
    fut = chan.do_inference_async(req)
    fut.result()
    names = [s.name for s in req.trace.spans]
    assert names == ["slot_wait", "stage", "launch", "device_execute", "readback"]
    spans = {s.name: s for s in req.trace.spans}
    assert spans["stage"].t0 <= spans["slot_wait"].t0 <= spans["stage"].t1 <= spans["launch"].t0
    assert spans["launch"].t1 <= spans["device_execute"].t0 + 1e-9
    assert spans["device_execute"].t1 <= spans["readback"].t0 + 1e-9


def test_threads_sharing_the_channel_keep_its_slots_consistent():
    import sys
    import threading

    _, chan = _port(2)
    errors, done = [], []

    def worker(w):
        try:
            for i in range(5):
                x = _frame(100 * w + i)
                fut = chan.do_inference_async(InferRequest("staged", {"x": x}))
                np.testing.assert_array_equal(fut.result().outputs["y"],
                                              _eager_torch({"x": x})["y"].numpy())
            done.append(w)
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and sorted(done) == list(range(8))
    stats = chan.stats()
    assert stats["launched"] == stats["staged"] == 40
    assert stats["inflight"] == 0 and stats["slots_active"] == 0
    assert max(stats["slot_occupancy"]) <= 2
