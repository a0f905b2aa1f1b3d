"""The port's runtime collector (``obs/collector.py``) and estimated-wait
admission (``runtime/admission.py``) against the JAX package's.

Bars: ``METRIC_TYPES`` equal, name for name and in order; on the same
channel and batcher ``stats()`` (duck-typed stand-ins), the same
histograms, SLO, admission and ledger states, every exported sample line
of both collectors is the same text, but for the compile counters (the
port counts CUDA-graph captures, JAX XLA compilations: pinned by their own
test) and the device-memory gauges (none on a CPU channel, in either);
snapshots' deltas equal; admission outcomes and messages equal under one
injected clock.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from triton_client_tpu.obs import collector as jcol
from triton_client_tpu.obs import histogram as jhist
from triton_client_tpu.obs import slo as jslo
from triton_client_tpu.runtime import admission as jadm

from triton_client_tpu_torch.obs import collector as tcol
from triton_client_tpu_torch.obs import histogram as thist
from triton_client_tpu_torch.obs import slo as tslo
from triton_client_tpu_torch.runtime import admission as tadm
from triton_client_tpu_torch.runtime import graphs
from torch_threads import one_torch_thread  # noqa: F401


def test_metric_types_equal_jax():
    assert list(tcol.METRIC_TYPES.items()) == list(jcol.METRIC_TYPES.items())
    assert tcol._HBM_KINDS == jcol._HBM_KINDS


class _Staged:
    """A staged channel's ``stats()`` shape (both packages')."""

    pipeline_depth = 2

    def __init__(self, device="cpu") -> None:
        self.device = torch.device(device)

    def fetch_channel(self):
        return self.device

    def stats(self) -> dict:
        return {
            "staged": 41, "launched": 40, "donated_launches": 0, "stage_slot_waits": 3,
            "deadline_expired_launches": 2, "inflight": 1, "slots_active": 2,
            "pipeline_depth": 2, "slot_occupancy": {1: 30, 2: 10},
            "shed": {"cam|0|launch": 2, "cam|-1|breaker": 1},
            "breaker": {"cam": {"state": 0, "opens": 1, "consecutive": 0},
                        "lidar": {"state": 2, "opens": 3, "consecutive": 4}},
            "data_axis_size": 1, "mesh_devices": 1,
        }


class _Batcher:
    def __init__(self, inner) -> None:
        self.inner = inner

    def stats(self) -> dict:
        return {
            "ready_depth": 2, "queue_depth": 3, "active_slots": 1, "merges": 12,
            "max_merge": 4, "merged_frames": 30, "padded_by_model": {"cam": 5},
            "launch_frees": 7, "merge_occupancy": {1: 3, 3: 4, 4: 5}, "pad_fraction": 0.125,
            "ragged_batches": 2, "ragged_rows": 90, "ragged_pad_rows": 6,
            "shed": {"cam|0|queue": 4}, "dispatcher_stalled": 0,
            "dispatcher_last_progress_age_s": 0.5,
        }


class _Ledger:
    def snapshot(self) -> dict:
        return {"device_seconds": {"cam|default": 1.5, "lidar|default": 0.25},
                "launches": {"cam": 30, "lidar": 10},
                "window": {"utilization": 0.4, "mfu": {"cam": 0.01}}}


class _Tracer:
    def stats(self) -> dict:
        return {"finished": 40, "buffered": 16, "capacity": 16}


def _collector(col, hist, slo, adm, registry):
    rng = np.random.default_rng(2)
    fam = hist.HistogramFamily()
    for _ in range(200):
        fam.observe(("cam", "lidar")[rng.integers(2)],
                    ("e2e", "device_execute", "queue_delay")[rng.integers(3)],
                    float(10.0 ** rng.uniform(-4, 0)))
    tracker = slo.SLOTracker(slo_ms=10.0, histograms=fam)
    for i in range(30):
        tracker.observe_request("cam", wall_s=0.001 * i, priority=i % 2, now=0.0)
    gate = adm.AdmissionController(max_queue=2)
    gate.admit("cam")
    c = col.RuntimeCollector(channel=_Batcher(_Staged()), tracer=_Tracer(), registry=registry,
                             histograms=fam, slo=tracker, admission=gate,
                             device_time=_Ledger())
    c.request_started()
    c.record_error("cam", "INTERNAL")
    c.record_shed("cam", 0, "admission")
    c.record_transport("uds+shm", 100, 4096)
    c.record_transport("grpc", 786432, 0)
    for g in (1, 3, 4, 8, 8, 70):
        c.record_stream_group(g)
    c.record_op_sample([{"model": "cam", "op": "k", "kind": "conv", "time_us": 12.5},
                        {"model": None, "op": "memcpy", "kind": "copy", "time_us": 2.0}], 0.02)
    c.set_draining(True)
    return c


_SKIP = ("tpu_serving_jit_compile",)


def _samples(registry) -> list[str]:
    import prometheus_client

    text = prometheus_client.generate_latest(registry).decode()
    return [line for line in text.splitlines()
            if not line.startswith("# HELP") and not line.startswith(_SKIP)
            and not line.startswith("# TYPE tpu_serving_jit_compile")]


def test_collect_exports_the_jax_samples():
    import prometheus_client

    lines = []
    for mods in ((jcol, jhist, jslo, jadm), (tcol, thist, tslo, tadm)):
        registry = prometheus_client.CollectorRegistry()
        c = _collector(*mods, registry)
        lines.append(_samples(registry))
        c.close()
    assert lines[1] == lines[0]
    types = {line.split()[2]: line.split()[3] for line in lines[1] if line.startswith("# TYPE")}
    assert types == {k: v for k, v in tcol.METRIC_TYPES.items() if not k.startswith(_SKIP)}


_SESSION_FAMILIES = ("tpu_serving_sessions", "tpu_serving_session_", "tpu_serving_track_")


def test_sessions_families_export_the_manager_as_jax_does():
    """With a session manager on the staged channel (its stats() from a real
    port manager that tracked, ended and rejected), both collectors export
    the same sessions samples, and they count."""
    import prometheus_client

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.ops.tracking import TrackerConfig
    from triton_client_tpu_torch.runtime.sessions import SessionLimitError, SessionManager

    manager = SessionManager(max_sessions=1, tracker=TrackerConfig(max_tracks=4))
    det = torch.zeros((3, 11))
    det[:2, 0] = torch.tensor([0.0, 9.0])
    det[:2, -2] = 0.9
    frame = {"detections": det, "valid": det[:, -2] > 0}
    manager.advance(InferRequest("m", {}, sequence_id="a", sequence_start=True), frame)
    with pytest.raises(SessionLimitError):
        manager.advance(InferRequest("m", {}, sequence_id="b"), frame)
    manager.release("a")
    manager.advance(InferRequest("m", {}, sequence_id="a", sequence_end=True), frame)
    manager.release("a")
    stats = manager.stats()

    class _Sessions:
        def stats(self) -> dict:
            return dict(stats)

    lines = []
    for col in (jcol, tcol):
        registry = prometheus_client.CollectorRegistry()
        staged = _Staged()
        staged.sessions = _Sessions()
        c = col.RuntimeCollector(channel=staged, registry=registry)
        lines.append([line for line in _samples(registry) if line.startswith(_SESSION_FAMILIES)])
        c.close()
    assert lines[1] == lines[0]
    for want in ("tpu_serving_session_frames_total 2.0", "tpu_serving_track_births_total 2.0",
                 "tpu_serving_sessions_rejected_total 1.0",
                 'tpu_serving_sessions_total{event="ended"} 1.0'):
        assert want in lines[1], want


def test_every_family_exports_without_components():
    """No channel, tracer or plane: every family still has its TYPE line,
    at the type METRIC_TYPES names (the lifecycle, sessions, quality and
    temporal families at zero)."""
    import prometheus_client

    registry = prometheus_client.CollectorRegistry()
    c = tcol.RuntimeCollector(registry=registry)
    text = prometheus_client.generate_latest(registry).decode()
    for name, kind in tcol.METRIC_TYPES.items():
        assert f"# TYPE {name} {kind}" in text, name
    for zero in ("tpu_serving_hbm_budget_bytes 0.0", "tpu_serving_sessions_active 0.0",
                 'tpu_serving_frames_total{mode="coast"} 0.0',
                 "tpu_quality_promotions_total 0.0"):
        assert zero in text
    c.close()
    assert "tpu_serving_inflight_requests" not in prometheus_client.generate_latest(
        registry).decode()


def test_snapshot_and_delta_match_jax():
    snaps = []
    for mods in ((jcol, jhist, jslo, jadm), (tcol, thist, tslo, tadm)):
        c = _collector(*mods, None)
        old = c.snapshot()
        c.record_error("cam", "INTERNAL")
        c.record_transport("grpc", 10, 0)
        new = c.snapshot()
        for s in (old, new):
            s.pop("compile")
        snaps.append((old, c.delta(new, old)))
    assert snaps[1] == snaps[0]


def test_memory_reads_nothing_on_a_cpu_channel():
    assert tcol.RuntimeCollector(channel=_Staged("cpu"))._memory() == {}
    assert tcol.RuntimeCollector()._memory() == {}


@pytest.mark.cuda
def test_memory_reads_torch_cuda_on_the_card():
    """The device-memory gauges read ``torch.cuda.memory_stats`` and
    ``mem_get_info`` for the channel's card (JAX: ``memory_stats()``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones(1 << 20, device="cuda")
    mem = tcol.RuntimeCollector(channel=_Staged("cuda"))._memory()
    (stats,) = mem.values()
    assert stats["bytes_limit"] == torch.cuda.mem_get_info()[1]
    assert stats["bytes_in_use"] >= x.numel() * 4


def test_compile_family_counts_cuda_graph_captures():
    """``tpu_serving_jit_compiles_total`` counts CaptureFunction captures (a
    stand-in backend: the CPU path captures nothing), once a new key."""

    class Backend:
        def warmup(self, fn, inputs, times):
            fn(*inputs)

        def capture(self, fn, inputs, owner):
            outputs = fn(*inputs)
            return (lambda: None), outputs, 0

    events = tcol.CompileEvents.install()
    before = events.snapshot()
    f = graphs.CapturedFunction(lambda x: x * 2, "double", backend=Backend())
    for n in (3, 3, 4):
        f(torch.ones(n))
    after = events.snapshot()
    assert after["compiles"] - before["compiles"] == 2
    assert after["compile_seconds"] >= before["compile_seconds"]
    assert tcol.CompileEvents.install() is events


def test_split_channel_walks_the_port_stacks():
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.runtime.continuous import ContinuousBatchingChannel
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    channel = CUDAChannel(ModelRepository(), device="cpu")
    assert tcol._split_channel(channel) == (None, channel)
    batcher = ContinuousBatchingChannel(channel, max_batch=2)
    try:
        assert tcol._split_channel(batcher) == (batcher, channel)
    finally:
        batcher.close()


def _admission_script(mod, concurrency):
    """Admits with deadlines against a service-time EWMA fed by finishes,
    at injected times: the outcome (or the rejection message) of each."""
    gate = mod.AdmissionController(max_queue=6, concurrency=concurrency)
    out = []
    t = 100.0
    rng = np.random.default_rng(concurrency)
    for step in range(60):
        t += 0.001
        if rng.random() < 0.35:
            gate.finished("cam", service_s=float(rng.uniform(0.001, 0.03))
                          if rng.random() < 0.8 else None)
            out.append(("finished", gate.estimated_wait_s("cam")))
            continue
        deadline = None if rng.random() < 0.2 else t + float(rng.uniform(0.0, 0.02))
        try:
            gate.admit("cam", deadline_s=deadline, priority=int(rng.integers(-1, 1)), now=t)
            out.append("ok")
        except mod.AdmissionRejectedError as e:
            out.append(str(e))
    return out, gate.stats()


@pytest.mark.parametrize("concurrency", [1, 4])
def test_estimated_wait_rejections_match_jax(concurrency):
    j, t = _admission_script(jadm, concurrency), _admission_script(tadm, concurrency)
    assert t == j
    assert any("estimated queue wait" in o for o in t[0] if isinstance(o, str))
