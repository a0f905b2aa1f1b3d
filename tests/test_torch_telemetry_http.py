"""The port's telemetry endpoint (``obs/http.py``) served by a CPU
``InferenceServer(metrics_port="auto")`` on the tiny YOLOv5n (64x64, 2
classes; tests/test_torch_server.py's seeded variables), the live forms of
``trace-dump``, ``trace-join --probe`` and ``roofline`` against it, and the
endpoint's answers against the JAX package's ``TelemetryServer`` over the
same traces and history.

Bars: a scrape lists every ``METRIC_TYPES`` family; each stage histogram's
count equals the requests sent; SLO met + missed equals them; the JAX and
port endpoints answer ``/traces``, ``/traces?slo_violations=1`` and
``/history`` with the same JSON and every error path with the same code.
Every server binds port 0 and stops in a ``finally``; every wait is
bounded.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from triton_client_tpu.obs import http as jhttp
from triton_client_tpu.obs import trace as jtrace

from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel
from triton_client_tpu_torch.cli import tools as ttools
from triton_client_tpu_torch.obs import http as thttp
from triton_client_tpu_torch.obs import trace as ttrace
from triton_client_tpu_torch.obs.collector import METRIC_TYPES
from triton_client_tpu_torch.pipelines import detect2d as tdet2d
from triton_client_tpu_torch.runtime.repository import ModelRepository
from triton_client_tpu_torch.runtime.server import InferenceServer
from tests.test_torch_server import CFG_2D, HW, yolo_variables
from torch_threads import one_torch_thread  # noqa: F401

REQUESTS = 6


def _get(url: str, timeout: float = 30.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def served():
    """A started telemetry server with REQUESTS answered, its base URL."""
    repo = ModelRepository()
    pipe, spec, _ = tdet2d.build_yolov5_pipeline(
        variant="n", num_classes=2, input_hw=HW, variables=yolo_variables(),
        config=tdet2d.Detect2DConfig(**CFG_2D), device="cpu")
    repo.register(spec, pipe.infer_fn(), device_fn=pipe.device_fn())
    server = InferenceServer(repo, CUDAChannel(repo, device="cpu"), address="127.0.0.1:0",
                             max_workers=4, metrics_port="auto", slo_ms=1000.0,
                             history_interval_s=60.0)
    server.start()
    try:
        chan = GRPCChannel(f"127.0.0.1:{server.port}", timeout_s=60)
        frame = np.random.default_rng(0).integers(0, 255, (1, *HW, 3)).astype(np.float32)
        try:
            for _ in range(REQUESTS):
                chan.do_inference(InferRequest(spec.name, {"images": frame}))
        finally:
            chan.close()
        server.history.tick()
        yield server, f"http://127.0.0.1:{server.metrics_port}", spec.name
    finally:
        server.stop()


def test_scrape_lists_every_family_and_counts_the_requests(served):
    server, url, model = served
    code, body = _get(url + "/metrics")
    text = body.decode()
    assert code == 200
    for name, kind in METRIC_TYPES.items():
        assert f"# TYPE {name} {kind}" in text, name
    for stage in ("e2e", "device_execute", "readback"):
        assert (f'tpu_serving_latency_seconds_count{{model="{model}",stage="{stage}"}} '
                f"{float(REQUESTS)}") in text
    assert f'tpu_serving_stage_latency_seconds_count{{stage="infer_{model}"}} {REQUESTS}.0' in text
    # a loopback client negotiates shared memory for its frames
    assert f'tpu_serving_transport_requests_total{{transport="shm"}} {REQUESTS}.0' in text
    stats = server.slo.stats()
    assert stats["met"] + stats["missed"] == REQUESTS
    assert f"tpu_serving_traces_finished_total {float(REQUESTS)}" in text


def test_snapshot_history_and_traces(served):
    server, url, model = served
    snap = json.loads(_get(url + "/snapshot")[1])
    assert snap["device_time"]["launches"] == {model: REQUESTS}
    assert 0 < snap["device_time"]["busy_fraction"] <= 1
    assert snap["histograms"][f"{model}|e2e"]["count"] == REQUESTS
    assert snap["models"][0]["roofline"]["flops"] > 0
    history = json.loads(_get(url + "/history?n=1")[1])
    assert len(history["snapshots"]) == 1 and f"{model}|default" in history["snapshots"][0]["models"]
    traces = json.loads(_get(url + "/traces?n=2")[1])["traceEvents"]
    assert sum(1 for e in traces if e.get("name") == "request") == 2
    assert "traceEvents" in json.loads(_get(url + "/traces?slo_violations=1")[1])


def test_profile_window_and_its_guard(served):
    server, url, _ = served
    code, body = _get(url + "/profile?seconds=0.05&top_k=5")
    doc = json.loads(body)
    assert code == 200 and doc["seconds"] == 0.05 and "op_summary" in doc
    assert _get(url + "/profile?seconds=x")[0] == 400
    with server._telemetry.profile_lock:
        code, body = _get(url + "/profile?seconds=0.05")
    assert code == 409 and b"already in progress" in body


def test_live_trace_dump_and_roofline(served, tmp_path, capsys):
    _, url, model = served
    out = tmp_path / "traces.json"
    ttools.trace_dump(["--url", url, "-n", "3", "-o", str(out)])
    doc = json.loads(out.read_text())
    assert sum(1 for e in doc["traceEvents"] if e.get("name") == "request") == 3
    assert "wrote 3 request traces" in capsys.readouterr().err
    ttools.trace_dump(["--url", url, "--ops", "--seconds", "0.05", "-o", str(tmp_path / "o.json")])
    assert "distinct ops" in capsys.readouterr().out
    assert json.loads((tmp_path / "o.json").read_text())["op_count"] == 0  # no card
    ttools.roofline([url, "--json"])
    (row,) = json.loads(capsys.readouterr().out)["rows"]
    assert row["model"] == f"{model}:1" and row["flops"] > 0


def test_live_trace_join_probe(served, tmp_path, capsys):
    _, url, _ = served
    dump = tmp_path / "server.json"
    ttools.trace_dump(["--url", url, "-o", str(dump)])
    joined = tmp_path / "joined.json"
    ttools.trace_join([f"server={dump}", "--probe", f"server={url}/", "-o", str(joined)])
    err = capsys.readouterr().err
    assert "probe server: rtt" in err
    assert json.loads(joined.read_text())["traceEvents"]


def test_stop_leaves_no_telemetry_thread():
    """Every thread a telemetry server starts (the endpoint, the history,
    the sampler, the gRPC handlers) is gone once stop() returns."""
    before = set(threading.enumerate())
    repo = ModelRepository()
    server = InferenceServer(repo, CUDAChannel(repo, device="cpu"), address="127.0.0.1:0",
                             metrics_port="auto", history_interval_s=60.0,
                             op_sample_interval_s=3600.0)
    server.start()
    try:
        started = {t.name for t in set(threading.enumerate()) - before}
        assert {"telemetry-http", "metric-history", "op-sampler"} <= started
    finally:
        server.stop()
    assert not [t.name for t in set(threading.enumerate()) - before if t.is_alive()]


class _History:
    def stats(self):
        return {"interval_s": 1.0, "capacity": 4, "buffered": 2, "ticks": 2}

    def snapshots(self, n=0):
        rows = [{"t": 1.0, "models": {}}, {"t": 2.0, "models": {"m|default": {"mfu": 0.5}}}]
        return rows[-n:] if n else rows


class _SLO:
    def __init__(self, traces):
        self._traces = traces

    def violations(self, n=0):
        return self._traces[-n:] if n else self._traces


def _tracer(mod):
    """A tracer holding three finished traces on fixed clocks."""
    tracer = mod.Tracer(capacity=8)
    for i in range(3):
        tr = tracer.start(model="m", request_id=f"r{i}")
        tr.t_start = 10.0 + i
        tr.add("device_execute", tr.t_start + 0.001, tr.t_start + 0.004)
        tracer.finish(tr)
        tr.t_end = tr.t_start + 0.005
    return tracer


@pytest.fixture(scope="module")
def endpoints():
    """A JAX and a port endpoint over the same traces and history (no
    registry, no collector)."""
    servers = []
    try:
        for hmod, tmod in ((jhttp, jtrace), (thttp, ttrace)):
            tracer = _tracer(tmod)
            servers.append(hmod.TelemetryServer(port=0, host="127.0.0.1", tracer=tracer,
                                                slo=_SLO(tracer.recent()), history=_History()))
        yield [f"http://127.0.0.1:{s.port}" for s in servers]
    finally:
        for s in servers:
            s.close()


@pytest.mark.parametrize("path", ["/traces", "/traces?n=2", "/traces?slo_violations=1&n=1",
                                  "/history", "/history?n=1", "/", "/nope", "/metrics",
                                  "/snapshot", "/profile?seconds=x"])
def test_endpoint_answers_as_jax(endpoints, path):
    """The same code and the same body from both endpoints."""
    answers = [_get(base + path) for base in endpoints]
    assert answers[1] == answers[0]
