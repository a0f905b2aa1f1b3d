"""The port's metric history (``obs/history.py``), continuous op sampler
(``obs/sampler.py``) and the launch log that carries other threads'
launch windows into a profiler window (``obs/profiling.py``) against the
JAX package's, on the CPU with injected clocks: no test waits on the wall.

Bars: history entries equal JAX's from the same ledger snapshots and tick
times (all but the unix stamp ``t``); the persisted document round-trips;
the sampler's clamps and counters equal JAX's; a launch logged on a
serving thread attributes a correlated kernel to its model as a launch on
the profiling thread would.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest

from triton_client_tpu.obs import history as jhistory
from triton_client_tpu.obs import sampler as jsampler

from triton_client_tpu_torch.obs import history as thistory
from triton_client_tpu_torch.obs import opstats
from triton_client_tpu_torch.obs import profiling
from triton_client_tpu_torch.obs import sampler as tsampler
from torch_threads import one_torch_thread  # noqa: F401


class _Ledger:
    """Ledger snapshots of a seeded serving run, one a tick."""

    def __init__(self, seed: int) -> None:
        rng = np.random.default_rng(seed)
        self._snaps, dev, launches = [], {}, {}
        for _ in range(8):
            for model in ("cam", "lidar"):
                if rng.random() < 0.8:
                    n = int(rng.integers(1, 50))
                    launches[model] = launches.get(model, 0) + n
                    key = f"{model}|default"
                    dev[key] = dev.get(key, 0.0) + n * float(rng.uniform(1e-3, 8e-3))
            self._snaps.append({
                "device_seconds": dict(dev), "launches": dict(launches),
                "window": {"utilization": float(rng.random()),
                           "mfu": {"cam": float(rng.random() * 0.01)}},
            })
        self._i = 0

    def snapshot(self) -> dict:
        snap = self._snaps[min(self._i, len(self._snaps) - 1)]
        self._i += 1
        return snap


def _ticks(mod, seed, capacity=5):
    history = mod.MetricHistory(ledger=_Ledger(seed), interval_s=1.0, capacity=capacity)
    entries = [history.tick(now=1000.0 + 1.5 * i + 0.25 * (i % 3)) for i in range(8)]
    for e in entries:
        e.pop("t")
    return history, entries


@pytest.mark.parametrize("seed", [0, 3])
def test_history_entries_equal_jax(seed):
    (jh, j), (th, t) = _ticks(jhistory, seed), _ticks(thistory, seed)
    assert t == j
    assert th.stats() == jh.stats()
    strip = lambda es: [{k: v for k, v in e.items() if k != "t"} for e in es]  # noqa: E731
    assert strip(th.snapshots(3)) == strip(jh.snapshots(3))


def test_history_persist_load_restore_round_trip(tmp_path):
    history, _ = _ticks(thistory, 1)
    path = tmp_path / "h.json"
    assert history.persist(str(path)) == 5
    doc = thistory.MetricHistory.load(str(path))
    assert doc == jhistory.MetricHistory.load(str(path))
    fresh = thistory.MetricHistory(ledger=None, capacity=3)
    assert fresh.restore(doc) == 3 and fresh.snapshots() == history.snapshots()[-3:]
    assert fresh.tick() is None


def test_history_thread_starts_and_close_joins():
    history = thistory.MetricHistory(ledger=_Ledger(0), interval_s=60.0)
    history.start()
    thread = history._thread
    assert thread.is_alive()
    history.close()
    assert history._thread is None and not thread.is_alive()


@pytest.mark.parametrize("interval,window", [(30.0, 0.2), (2.0, 0.2), (0.1, 5.0), (5.0, 0.001)])
def test_sampler_clamps_equal_jax(interval, window):
    j = jsampler.ContinuousSampler(interval_s=interval, window_s=window)
    t = tsampler.ContinuousSampler(interval_s=interval, window_s=window)
    assert (t.interval_s, t.window_s, t.duty_cycle) == (j.interval_s, j.window_s, j.duty_cycle)
    assert tsampler.MAX_DUTY_CYCLE == jsampler.MAX_DUTY_CYCLE
    assert set(t.stats()) == set(j.stats())


class _Sink:
    def __init__(self) -> None:
        self.samples = []

    def record_op_sample(self, rows, window_s):
        self.samples.append((rows, window_s))


def test_sampler_window_reaches_the_sink_and_counts():
    """One window (a stand-in sleep: no wall wait) is a torch.profiler
    session parsed by opstats; a held guard skips, a failed parse counts."""
    sink, waited = _Sink(), []
    lock = threading.Lock()
    sampler = tsampler.ContinuousSampler(sink=sink, interval_s=2.0, window_s=0.02, lock=lock,
                                         hlo_modules=lambda: {"launch:m:1": "m"},
                                         sleep=waited.append)
    summary = sampler.sample_once()
    assert waited == [0.02] and summary["op_count"] == 0  # no card: no device op
    assert sink.samples == [([], 0.02)]
    with lock:
        assert sampler.sample_once() is None
    sampler._hlo_modules = lambda: 1 / 0  # a failing map still samples
    assert sampler.sample_once() is not None
    stats = sampler.stats()
    assert (stats["captures"], stats["skipped_busy"], stats["failures"]) == (2, 1, 0)


def test_sampler_failure_is_counted(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no trace")

    monkeypatch.setattr(opstats, "summarize_profile_dir", broken)
    sampler = tsampler.ContinuousSampler(interval_s=2.0, sleep=lambda s: None)
    assert sampler.sample_once() is None
    assert sampler.stats()["failures"] == 1 and not sampler._lock.locked()


def test_sampler_thread_close_joins():
    sampler = tsampler.ContinuousSampler(interval_s=3600.0, sleep=lambda s: None)
    sampler.start()
    thread = sampler._thread
    sampler.close()
    assert sampler._thread is None and not thread.is_alive()


def test_launch_on_another_thread_lands_in_the_trace(tmp_path):
    """A launch_scope on a serving thread while a device_trace is open on
    this one is logged beside the trace and merged onto the serving
    thread, inside the window; with no trace open nothing is logged."""
    done = threading.Event()

    def serve():
        with profiling.launch_scope("launch:m:1"):
            pass
        done.set()

    with profiling.device_trace(str(tmp_path)):
        worker = threading.Thread(target=serve)
        worker.start()
        assert done.wait(30)
        tid = worker.native_id
        worker.join(30)
    log = json.loads((tmp_path / opstats.LAUNCH_LOG).read_text())
    assert [w[0] for w in log["windows"]] == [tid]
    doc = opstats.load_trace(str(tmp_path / "trace.json"))
    assert opstats.merge_launch_log(doc, log) == 1
    (event,) = [e for e in doc["traceEvents"] if e.get("name") == "launch:m:1"]
    (sync,) = [e for e in doc["traceEvents"] if e.get("name") == opstats.CLOCK_SYNC]
    assert event["tid"] == tid and event["ts"] >= sync["ts"] and event["dur"] >= 0
    assert opstats.summarize_profile_dir(str(tmp_path))["launch_log_windows"] == 1
    assert profiling._launch_log is None
    with profiling.launch_scope("launch:m:1"):
        pass
    assert profiling._launch_log is None


def test_launch_gate_holds_launches_while_a_session_switches():
    """A closed gate waits out the launch in progress and holds the next
    until it opens; a launch nested in a launch passes."""
    gate = profiling._LaunchGate()
    order, entered, release = [], threading.Event(), threading.Event()

    def launch(name, hold=None):
        with gate.launching():
            with gate.launching():  # a member launched inside its ensemble
                order.append(name)
                entered.set()
                if hold is not None:
                    assert hold.wait(30)

    first = threading.Thread(target=launch, args=("first", release))
    first.start()
    assert entered.wait(30)
    closer_done = threading.Event()

    def close():
        with gate.closed():
            order.append("closed")
            second = threading.Thread(target=launch, args=("second",))
            second.start()
            second.join(0.05)  # bounded: it must still be waiting
            order.append("alive" if second.is_alive() else "ran")
        second.join(30)
        closer_done.set()

    closer = threading.Thread(target=close)
    closer.start()
    release.set()
    assert closer_done.wait(30)
    first.join(30)
    closer.join(30)
    assert order == ["first", "closed", "alive", "second"]


@pytest.mark.parametrize("named_by", ["native", "ident", "ident_low32", "ident_low32_negated"])
def test_logged_windows_attribute_correlated_kernels(named_by):
    """A trace whose launch annotation came from the launch log attributes
    the kernel the logged launch's runtime call launched to the model, and
    one launched outside stays unattributed. As on the card: the runtime
    calls' clock sits 830 us before the host ops' (the log is aligned on
    the tracing thread's run of ``cudaStreamQuery`` calls inside the sync
    annotation, named by its ``pthread_t`` or native id, not on a lone query
    of the profiler's start or another thread's), and a thread's runtime
    calls name it by its native id, its ``pthread_t`` or that cut to 32
    bits; a cut id with its top bit set, read as a signed int, comes
    negated."""
    native = 42
    ident = 140492272563904 if named_by == "ident_low32_negated" else 139973856589504
    low = ident & 0xFFFFFFFF
    tid = {"native": native, "ident": ident, "ident_low32": low,
           "ident_low32_negated": (1 << 32) - low}[named_by]
    skew = -830.0
    doc = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": opstats.CLOCK_SYNC, "pid": 7,
         "tid": 1, "ts": 5000.0, "dur": 70.0},
        # the profiler's start on the tracing thread, then the sync run in the
        # annotation; a serving thread's own query earlier still
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamQuery", "pid": 7,
         "tid": 900, "ts": 4950.0 + skew, "dur": 2.0, "args": {"correlation": 6}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamIsCapturing", "pid": 7,
         "tid": 1, "ts": 4960.0 + skew, "dur": 2.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamQuery", "pid": 7,
         "tid": 1, "ts": 4990.0 + skew, "dur": 2.0, "args": {"correlation": 8}},
    ] + [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamQuery", "pid": 7,
         "tid": 900, "ts": 5000.0 + skew - 3 * i, "dur": 2.0, "args": {"correlation": 20 + i}}
        for i in range(opstats.CLOCK_SYNC_CALLS)
    ] + [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamQuery", "pid": 7,
         "tid": tid, "ts": 4000.0, "dur": 2.0, "args": {"correlation": 9}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "pid": 7,
         "tid": tid, "ts": 5105.0 + skew, "dur": 4.0, "args": {"correlation": 11}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "pid": 7,
         "tid": tid, "ts": 5300.0 + skew, "dur": 4.0, "args": {"correlation": 12}},
        {"ph": "X", "cat": "kernel", "name": "decode_nms_2d_order", "pid": 0, "tid": 7,
         "ts": 5200.0, "dur": 3.5, "args": {"correlation": 11}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "pid": 0, "tid": 7,
         "ts": 5310.0, "dur": 2.0, "args": {"correlation": 12}},
    ]}
    # the window: perf_counter 10.0001 .. 10.0002, the run's last call at 10.0
    log = {"t_sync": 10.0, "sync_thread": [1, 900],
           "windows": [[native, ident, 10.0001, 10.0002, "launch:yolov5_crop:1"]]}
    assert opstats.merge_launch_log(doc, log) == 1
    summary = opstats.summarize(doc)
    assert summary["models"] == {"yolov5_crop": 3.5} and summary["unattributed_us"] == 2.0
    (kernel,) = [r for r in summary["ops"] if r["op"] == "decode_nms_2d_order"]
    assert kernel["stage"] == "decode_nms" and kernel["model"] == "yolov5_crop"


def test_bracketed_windows_attribute_without_a_clock():
    """On a card each logged launch is bracketed by a stream query on its
    thread: two windows of one thread take their pairs in order, whatever
    the clocks say (here t_sync is a second off), so each kernel lands
    under the model its window names."""
    tid = 139973856589504 & 0xFFFFFFFF
    doc = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": opstats.CLOCK_SYNC, "pid": 7,
         "tid": 1, "ts": 5000.0, "dur": 70.0},
    ]}
    corr = 100
    for base, kernel in ((6000.0, "decode_nms_2d_order"), (7000.0, "suppress_pack_3d_order")):
        for name, at in (("cudaStreamQuery", base), ("cudaGraphLaunch", base + 50.0),
                         ("cudaStreamQuery", base + 400.0)):
            corr += 1
            doc["traceEvents"].append({"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 7,
                                       "tid": tid, "ts": at, "dur": 3.0,
                                       "args": {"correlation": corr}})
        doc["traceEvents"].append({"ph": "X", "cat": "kernel", "name": kernel, "pid": 0,
                                   "tid": 7, "ts": base + 900.0, "dur": 2.0,
                                   "args": {"correlation": corr - 1}})
    log = {"t_sync": 99.0, "sync_thread": [1, 900], "windows": [
        [42, 139973856589504, 10.0, 10.0004, "launch:yolov5_crop:1"],
        [42, 139973856589504, 10.001, 10.0014, "launch:pointpillar_kitti:1"]]}
    assert opstats.merge_launch_log(doc, log) == 2
    summary = opstats.summarize(doc)
    assert summary["models"] == {"yolov5_crop": 2.0, "pointpillar_kitti": 2.0}
    assert summary["unattributed_us"] == 0.0
