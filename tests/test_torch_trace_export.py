"""The port's Chrome-trace export and the rest of ``obs/trace.py``
(``TraceContext.new``/``child``, ``RequestTrace.span_coverage``/``summary``,
``MultiTrace.span``), and the ``trace-join`` tool, against the JAX
package's on the same spans and files.

Bars: the exported JSON is identical (``json.dumps`` equal); ``trace-join``
writes byte-identical merged JSON for the same files and ``--offset``s.
"""

from __future__ import annotations

import json

import pytest

from triton_client_tpu.cli import tools as jtools
from triton_client_tpu.obs import trace as jtrace

from triton_client_tpu_torch.cli import tools as ttools
from triton_client_tpu_torch.obs import trace as ttrace
from torch_threads import one_torch_thread  # noqa: F401

#: (name, t0, t1, attrs) of one request's spans, seconds after its start
SPANS = (
    ("stage", 0.0001, 0.0009, None),
    ("slot_wait", 0.0002, 0.0003, None),
    ("launch", 0.0009, 0.0012, {"attempt": 1, "endpoint": "a"}),
    ("device_execute", 0.0012, 0.0031, None),
    ("readback", 0.0031, 0.0034, None),
    ("readback", 0.0040, 0.0041, None),
)


def _traces(mod, t_base: float = 100.0, n: int = 3):
    """``n`` finished traces with the same ids, clocks and spans; the second
    carries a distributed context and the last is left open."""
    out = []
    for i in range(n):
        ctx = mod.TraceContext("ab" * 16, "cd" * 8) if i == 1 else None
        tr = mod.RequestTrace(i + 1, model=f"m{i % 2}", request_id=f"r{i}", context=ctx)
        tr.t_start = t_base + 0.01 * i
        for name, t0, t1, attrs in SPANS[: 3 + i]:
            tr.add(name, tr.t_start + t0, tr.t_start + t1, attrs)
        if i < n - 1:
            tr.t_end = tr.t_start + 0.0045
            tr.status = "ok" if i == 0 else "UNAVAILABLE"
        out.append(tr)
    return out


def test_chrome_trace_is_jax_identical():
    jdoc = jtrace.chrome_trace(_traces(jtrace)[:2])
    tdoc = ttrace.chrome_trace(_traces(ttrace)[:2])
    assert json.dumps(tdoc) == json.dumps(jdoc)
    assert [e["name"] for e in tdoc["traceEvents"] if e["ph"] == "X"].count("request") == 2
    assert ttrace.chrome_trace([]) == jtrace.chrome_trace([])


def test_tracer_chrome_trace_and_dump_match_jax(tmp_path):
    docs = []
    for mod in (jtrace, ttrace):
        tracer = mod.Tracer(capacity=4)
        for tr in _traces(mod)[:2]:
            tracer._ring.append(tr)
        docs.append(tracer.chrome_trace(1))
        mod.dump_chrome_trace(tracer.recent(), str(tmp_path / f"{mod.__name__}.json"))
    assert json.dumps(docs[0]) == json.dumps(docs[1])
    files = [(tmp_path / f"{m.__name__}.json").read_text() for m in (jtrace, ttrace)]
    assert files[0] == files[1]


def test_span_coverage_and_summary_match_jax():
    for jtr, ttr in zip(_traces(jtrace), _traces(ttrace)):
        if ttr.t_end is None:  # open traces read the clock: close both alike
            jtr.t_end = ttr.t_end = ttr.t_start + 0.005
        assert ttr.span_coverage() == jtr.span_coverage()
        assert ttr.summary() == jtr.summary()
    empty = ttrace.RequestTrace(1)
    empty.t_end = empty.t_start
    assert empty.span_coverage() == 1.0


def test_trace_context_new_and_child():
    ctx = ttrace.TraceContext.new()
    assert len(ctx.trace_id) == 32 and len(ctx.parent_span_id) == 16 and ctx.sampled
    child = ctx.child()
    assert child.trace_id == ctx.trace_id and child.parent_span_id != ctx.parent_span_id
    assert not ttrace.TraceContext.new(sampled=False).child().sampled
    # either package decodes the other's wire form
    assert jtrace.TraceContext.decode(child.encode()).encode() == child.encode()


def test_multitrace_span_fans_out():
    members = [ttrace.RequestTrace(i) for i in range(3)]
    multi = ttrace.MultiTrace(members + [None])
    with multi.span("device_execute"):
        pass
    spans = [m.spans[0] for m in members]
    assert all(s.name == "device_execute" for s in spans)
    assert len({(s.t0, s.t1) for s in spans}) == 1


def _write_dumps(tmp_path):
    """Two per-process dumps (the JAX export of the same spans at two clock
    bases) and their paths."""
    paths = []
    for name, base in (("client", 10.0), ("replica", 50.0)):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(jtrace.chrome_trace(_traces(jtrace, base)[:2])))
        paths.append(path)
    return paths


@pytest.mark.parametrize("offsets", [[], ["replica=-1500.25"], ["client=3", "replica=40000"]])
def test_trace_join_output_is_jax_identical(tmp_path, capsys, offsets):
    client, replica = _write_dumps(tmp_path)
    argv = [f"client={client}", str(replica)]
    for o in offsets:
        argv += ["--offset", o]
    out = {}
    for name, mod in (("jax", jtools), ("port", ttools)):
        mod.trace_join(argv + ["-o", str(tmp_path / f"{name}.joined.json")])
        out[name] = (tmp_path / f"{name}.joined.json").read_text()
        capsys.readouterr()
    assert out["port"] == out["jax"]
    doc = json.loads(out["port"])
    assert {e["pid"] for e in doc["traceEvents"]} == {1, 2}


def test_trace_join_probe_shifts_by_half_the_probe_round_trip(tmp_path, capsys):
    """``--probe NAME=URL`` against a port telemetry endpoint (port 0, no
    server behind it): NAME's events move by half the best round trip, as
    JAX's tool moves them, on top of its ``--offset``; the other source's
    stay where the offset-only join puts them."""
    from triton_client_tpu_torch.obs.http import TelemetryServer

    client, replica = _write_dumps(tmp_path)
    argv = [f"client={client}", f"replica={replica}", "--offset", "replica=40000"]
    plain, probed = tmp_path / "plain.json", tmp_path / "probed.json"
    telemetry = TelemetryServer(port=0, host="127.0.0.1")
    try:
        url = f"http://127.0.0.1:{telemetry.port}/"
        ttools.trace_join(argv + ["-o", str(plain)])
        ttools.trace_join(argv + ["--probe", f"replica={url}", "--timeout", "10",
                                  "-o", str(probed)])
    finally:
        telemetry.close()
    err = capsys.readouterr().err
    rtt_ms = float(err.split("probe replica: rtt ")[1].split(" ms")[0])
    shift_us = rtt_ms / 2.0 * 1e3
    a = json.loads(plain.read_text())["traceEvents"]
    b = json.loads(probed.read_text())["traceEvents"]
    assert len(a) == len(b)
    key = lambda e: (e["pid"], e.get("name"), e.get("tid"), e.get("ph"))  # noqa: E731
    shifts = {1: set(), 2: set()}
    for ea, eb in zip(sorted(a, key=key), sorted(b, key=key)):
        if "ts" in ea:
            shifts[ea["pid"]].add(round(eb["ts"] - ea["ts"], 2))
    assert shifts[1] == {0.0}
    # one shift for every replica event (each ts is rounded to 1e-3 us), the
    # printed half round trip (printed to 1e-3 ms)
    assert max(shifts[2]) - min(shifts[2]) <= 0.01 and min(shifts[2]) > 0
    assert abs(min(shifts[2]) - shift_us) <= 1.0


def test_trace_join_probe_failure_exits_as_jax(tmp_path):
    """A probe that cannot connect exits with JAX's message."""
    client, _ = _write_dumps(tmp_path)
    msgs = []
    for mod in (jtools, ttools):
        with pytest.raises(SystemExit) as e:
            mod.trace_join([str(client), "--probe", "client=http://127.0.0.1:1",
                            "--timeout", "5"])
        msgs.append(str(e.value).split(":")[0])
    assert msgs[0] == msgs[1] == "probe against http"
