"""The port's latency histograms (``obs/histogram.py``), SLO tracker
(``obs/slo.py``) and the ``Tracer``'s ``profiler=``/``histograms=`` feeds
against the JAX package's, on the same seeded sequences under one injected
clock; and the span names the port's channel and batcher emit against
JAX's, so the per-(model, stage) histograms fill the series a dashboard
reads.

Bars: snapshots, quantiles and stats equal (``==`` on floats: bitwise);
the retained exemplars are the same requests, in the same order.
"""

from __future__ import annotations

import numpy as np
import pytest

from triton_client_tpu.obs import histogram as jhist
from triton_client_tpu.obs import profiling as jprof
from triton_client_tpu.obs import slo as jslo
from triton_client_tpu.obs import trace as jtrace

from triton_client_tpu_torch.obs import histogram as thist
from triton_client_tpu_torch.obs import profiling as tprof
from triton_client_tpu_torch.obs import slo as tslo
from triton_client_tpu_torch.obs import trace as ttrace
from torch_threads import one_torch_thread  # noqa: F401

BUCKETS = {"default": None, "coarse": (0.01, 0.1, 1.0), "unsorted": (0.5, 0.001, 0.02)}


def _samples(seed: int, n: int = 400) -> np.ndarray:
    """Log-uniform latencies from 10 us to 100 s, with a negative, a NaN, a
    zero and exact bucket bounds mixed in (clamped / boundary cases)."""
    rng = np.random.default_rng(seed)
    x = 10.0 ** rng.uniform(-5, 2, n)
    x[:6] = [-1.0, float("nan"), 0.0, 0.005, 60.0, 0.00025]
    return rng.permutation(x)


@pytest.mark.parametrize("buckets", sorted(BUCKETS))
@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_snapshot_and_quantiles_are_jax_bitwise(buckets, seed):
    hists = []
    for mod in (jhist, thist):
        b = BUCKETS[buckets]
        h = mod.LatencyHistogram() if b is None else mod.LatencyHistogram(b)
        for v in _samples(seed):
            h.observe(float(v))
        hists.append(h)
    j, t = hists
    assert t.snapshot() == j.snapshot() and t.bounds == j.bounds
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 0.999, 1.0, 1.5, -0.2):
        assert t.quantile(q) == j.quantile(q)


def test_quantile_from_snapshot_of_a_delta_and_of_nothing():
    """A window's delta reads through the same estimator; an empty
    histogram reads 0 and a snapshot past the last bound its largest."""
    from triton_client_tpu.obs.collector import RuntimeCollector as JC
    from triton_client_tpu_torch.obs.collector import RuntimeCollector as TC

    x = _samples(3)
    out = []
    for hmod, col in ((jhist, JC), (thist, TC)):
        h = hmod.LatencyHistogram()
        for v in x[:150]:
            h.observe(float(v))
        old = h.snapshot()
        for v in x[150:]:
            h.observe(float(v))
        window = col.delta(h.snapshot(), old)
        out.append([hmod.quantile_from_snapshot(window, q) for q in (0.5, 0.95, 0.99)]
                   + [hmod.quantile_from_snapshot({}, 0.5),
                      hmod.quantile_from_snapshot({"buckets": {"inf": 3}}, 0.5)])
    assert out[0] == out[1]


def test_histogram_family_matches_jax():
    rng = np.random.default_rng(5)
    fams = [jhist.HistogramFamily(), thist.HistogramFamily()]
    for _ in range(300):
        model = f"m{rng.integers(3)}"
        stage = ("queue_delay", "device_execute", "e2e")[rng.integers(3)]
        v = float(10.0 ** rng.uniform(-4, 0))
        for f in fams:
            f.observe(model, stage, v)
    j, t = fams
    assert t.snapshot() == j.snapshot()
    assert [k for k, _ in t.items()] == [k for k, _ in j.items()]
    for model in ("m0", "m1", "m2", "none"):
        for stage in ("e2e", "device_execute", "none"):
            assert t.count(model, stage) == j.count(model, stage)
            assert t.quantile(model, stage, 0.99) == j.quantile(model, stage, 0.99)
    assert thist.SLO_STAGES == jhist.SLO_STAGES and thist.DEFAULT_BUCKETS == jhist.DEFAULT_BUCKETS


def _slo_script(seed: int, n: int = 260):
    """(model, wall_s, deadline offset or None, priority, status) per
    request, each finishing at its own injected ``now``."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        model = ("cam", "lidar", "free")[rng.integers(3)]
        wall = float(10.0 ** rng.uniform(-3.5, -0.5))
        deadline = None if rng.random() < 0.4 else float(rng.uniform(0.0, 0.1))
        rows.append((model, wall, deadline, int(rng.integers(-1, 2)),
                     "ok" if rng.random() < 0.9 else "INTERNAL"))
    return rows


@pytest.mark.parametrize("with_histograms", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_slo_tracker_stats_and_tail_ring_match_jax(seed, with_histograms):
    """Budgets (a default, one per-model override, one model without),
    deadlines that decide over the budget, failures counted missed, and the
    tail ring's p99 criterion (fed by the family, past 100 samples)."""
    results = []
    for hmod, smod, tmod in ((jhist, jslo, jtrace), (thist, tslo, ttrace)):
        fam = hmod.HistogramFamily() if with_histograms else None
        tracker = smod.SLOTracker(slo_ms=20.0, per_model={"lidar": 80.0, "free": 0.0},
                                  tail_capacity=16, histograms=fam)
        deadlines = []
        t0 = 1000.0
        for i, (model, wall, dl, prio, status) in enumerate(_slo_script(seed)):
            start = t0 + i
            deadlines.append(tracker.deadline_for(model, start))
            tr = tmod.RequestTrace(i + 1, model=model, request_id=f"r{i}")
            if fam is not None:
                fam.observe(model, "e2e", wall)
            tracker.observe_request(
                model, wall_s=wall, deadline_s=None if dl is None else start + dl,
                priority=prio, status=status, trace=tr, now=start + wall)
        tracker.set_budget(5.0, model="cam")
        deadlines.append(tracker.deadline_for("cam", 5.0))
        results.append((tracker.stats(), tracker.attainment(), tracker.enabled, deadlines,
                         [tr.trace_id for tr in tracker.violations()],
                         [tr.trace_id for tr in tracker.violations(3)]))
    assert results[1] == results[0]


def test_unscored_tracker_and_attainment_before_any_request():
    for mod in (jslo, tslo):
        tracker = mod.SLOTracker()
        assert not tracker.enabled and tracker.attainment() == 1.0
        tracker.observe_request("m", 1.0)
        assert tracker.stats()["met"] == tracker.stats()["missed"] == 0


def test_tracer_feeds_profiler_and_histograms_as_jax(monkeypatch):
    """The same spans into each package's Tracer (one injected clock):
    the stage profiler's ``span_<name>`` samples and the family's SLO
    stages and e2e equal JAX's."""
    spans = [("batch_queue", 0.0, 0.002), ("merge_wait", 0.001, 0.002),
             ("stage", 0.002, 0.0025), ("device_execute", 0.0025, 0.009),
             ("readback", 0.009, 0.0093), ("encode", 0.0093, 0.0094)]
    out = []
    for hmod, pmod, tmod in ((jhist, jprof, jtrace), (thist, tprof, ttrace)):
        now = iter([50.0 + 0.0125 * i for i in range(20)])
        monkeypatch.setattr(tmod.time, "perf_counter", lambda: next(now))
        fam, prof = hmod.HistogramFamily(), pmod.StageProfiler()
        seen = []
        prof.add_listener(lambda stage, s: seen.append((stage, s)))
        tracer = tmod.Tracer(capacity=4, profiler=prof, histograms=fam)
        for model in ("cam", "lidar", "cam"):
            tr = tracer.start(model=model, request_id="x")
            for name, a, b in spans:
                tr.add(name, tr.t_start + a, tr.t_start + b)
            tracer.finish(tr)
        monkeypatch.undo()
        out.append((fam.snapshot(), seen, tracer.stats()))
    assert out[1] == out[0]


def test_stage_profiler_listener_stage_and_wrap():
    """``stage`` and ``wrap`` record one sample a call into the listeners,
    a failing listener never fails the call, as in JAX."""
    for mod in (jprof, tprof):
        prof, seen = mod.StageProfiler(), []
        prof.add_listener(lambda stage, s: 1 / 0)
        prof.add_listener(lambda stage, s: seen.append(stage))
        with prof.stage("a"):
            pass
        assert prof.wrap("b", lambda x: x + 1)(1) == 2
        assert seen == ["a", "b"] and set(prof.summary()) == {"a", "b"}


def test_prometheus_stage_exporter_shares_a_family_per_registry():
    import prometheus_client

    registry = prometheus_client.CollectorRegistry()
    for _ in range(2):
        exporter = tprof.PrometheusStageExporter(0, registry=registry)
        exporter.attach(prof := tprof.StageProfiler())
        prof.record("infer_m", 0.004)
        prof.record("span_a.b", 0.02)
    text = prometheus_client.generate_latest(registry).decode()
    assert 'tpu_serving_stage_latency_seconds_count{stage="infer_m"} 2.0' in text
    assert 'tpu_serving_stage_latency_seconds_count{stage="span_a_b"} 2.0' in text


def _span_names(channel, request_cls, trace_mod, inputs):
    tracer = trace_mod.Tracer(capacity=4)
    tr = tracer.start(model="m")
    channel.do_inference(request_cls(model_name="m", inputs=inputs, trace=tr))
    return sorted({s.name for s in tr.spans})


@pytest.mark.parametrize("batcher", ["none", "window", "continuous"])
def test_channel_span_names_are_jax_names(batcher):
    """A traced request through the port's CUDAChannel (CPU), alone and
    behind each batcher, carries exactly the span names the JAX package's
    TPUChannel stack writes; among them every SLO stage the stack feeds."""
    import jax.numpy as jnp

    from triton_client_tpu.channel.base import InferRequest as JRequest
    from triton_client_tpu.channel.tpu_channel import TPUChannel
    from triton_client_tpu.config import ModelSpec as JSpec, TensorSpec as JTensor
    from triton_client_tpu.runtime import batching as jbatching, continuous as jcontinuous
    from triton_client_tpu.runtime.repository import ModelRepository as JRepo

    from triton_client_tpu_torch.channel.base import InferRequest as TRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.config import ModelSpec as TSpec, TensorSpec as TTensor
    from triton_client_tpu_torch.runtime import batching as tbatching, continuous as tcontinuous
    from triton_client_tpu_torch.runtime.repository import ModelRepository as TRepo

    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    names = []
    for spec_cls, tensor_cls, repo_cls, chan, bat, cont, req, tmod, fn in (
        (JSpec, JTensor, JRepo, TPUChannel, jbatching, jcontinuous, JRequest, jtrace,
         lambda inputs: {"y": jnp.asarray(inputs["x"]) * 2.0}),
        (TSpec, TTensor, TRepo, lambda r: CUDAChannel(r, device="cpu"), tbatching, tcontinuous,
         TRequest, ttrace, lambda inputs: {"y": inputs["x"] * 2.0}),
    ):
        repo = repo_cls()
        repo.register(spec_cls(name="m", inputs=[tensor_cls("x", [-1, 4], "FP32")],
                               outputs=[tensor_cls("y", [-1, 4], "FP32")], max_batch_size=8),
                      fn)
        channel = chan(repo)
        if batcher == "window":
            channel = bat.BatchingChannel(channel, max_batch=4, timeout_us=100)
        elif batcher == "continuous":
            channel = cont.ContinuousBatchingChannel(channel, max_batch=4)
        try:
            names.append(_span_names(channel, req, tmod, {"x": x}))
        finally:
            close = getattr(channel, "close", None)
            if close is not None:
                close()
    assert names[1] == names[0]
    fed = {s for s in thist.SLO_STAGES if s in names[1]}
    assert {"device_execute", "readback"} <= fed
    if batcher != "none":
        assert "batch_queue" in fed
