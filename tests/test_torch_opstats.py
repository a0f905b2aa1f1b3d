"""The port's op attribution (``obs/opstats.py``) against the JAX
package's, and ``trace-dump --ops``.

One synthetic capture is written in JAX's form (device ops stamped with
``hlo_op`` and, where XLA knows it, the launcher's ``hlo_module``) and in
``torch.profiler``'s (the same names, ``ts``, ``dur`` and ``launch:``
windows, as CUPTI kernels and memcpys with the ``correlation`` ids of the
runtime calls that launched them). Bars: the same rows (the ``module``
key renamed from the HLO module to the launch annotation), totals, model
and stage splits and ``top_k``, and the same ``trace-dump --ops`` table.
"""

from __future__ import annotations

import gzip
import json
import pathlib
import re

import numpy as np
import pytest

from triton_client_tpu.cli import tools as jtools
from triton_client_tpu.obs import opstats as jops
from triton_client_tpu.ops.fused import FUSED_STAGES

from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.cli import tools as ttools
from triton_client_tpu_torch.obs import opstats as tops
from tests.test_torch_staged import _frame, _port
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: launch windows on host thread 1: (annotation, ts, dur)
WINDOWS = (("launch:det2d:1", 90.0, 250.0), ("launch:pillars:1", 990.0, 200.0),
           ("launch:det2d:1", 2000.0, 100.0))
HLO_MODULE = {"launch:det2d:1": "jit_mdl_det2d_1", "launch:pillars:1": "jit_mdl_pillars_1"}
#: device ops: (name, ts, dur, launch the op belongs to, (runtime call ts,
#: thread, correlation) or None, stage scope JAX's metadata carries)
OPS = (
    ("fusion.1", 100.0, 50.0, "launch:det2d:1", (95.0, 1, 1), None),
    ("convolution.2", 160.0, 40.0, "launch:det2d:1", (96.0, 1, 2), None),
    ("copy.3", 210.0, 10.0, None, None, None),  # no correlation: its midpoint decides
    ("fusion.1", 300.0, 50.0, "launch:det2d:1", (290.0, 1, 4), None),
    # runs after its window has closed: correlation alone places it
    ("decode_nms_2d_scan(float const*, float const*, int)", 400.0, 20.0, "launch:det2d:1",
     (335.0, 1, 5), "decode_nms"),
    # the staging upload, issued outside every launch window
    ("Memcpy HtoD (Pinned -> Device)", 60.0, 5.0, None, (50.0, 1, 6), None),
    # one graph replay: three kernels, one cudaGraphLaunch
    ("segment_mean_zero(float4*, int)", 1000.0, 30.0, "launch:pillars:1", (995.0, 1, 7),
     "voxelize_scatter"),
    ("segment_mean_walk(float const*, int const*, float*, int)", 1040.0, 60.0,
     "launch:pillars:1", (995.0, 1, 7), "voxelize_scatter"),
    ("custom-call.7", 1100.0, 20.0, "launch:pillars:1", (995.0, 1, 7), None),
    ("dot.9", 5000.0, 30.0, None, None, None),
    # launched by another thread at a time inside thread 1's det2d window
    ("sort.4", 3000.0, 15.0, None, (200.0, 2, 11), None),
    ("fusion.1", 2010.0, 50.0, "launch:det2d:1", (2005.0, 1, 12), None),
)
HOST_NOISE = {"ph": "X", "pid": 2, "tid": 1, "name": "some_host_thing", "ts": 0.0,
              "dur": 5000.0, "args": {}}


def jax_form() -> dict:
    events = [{"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "/device:TPU:0"}},
              dict(HOST_NOISE)]
    for name, ts, dur in WINDOWS:
        events.append({"ph": "X", "pid": 2, "tid": 1, "name": name, "ts": ts, "dur": dur,
                       "args": {}})
    for name, ts, dur, launch, call, stage in OPS:
        args = {"hlo_op": name}
        if launch is not None and call is not None:
            args["hlo_module"] = HLO_MODULE[launch]
        if stage is not None:
            args["long_name"] = f"{args.get('hlo_module', 'jit_x')}/fused:{stage}/body"
        events.append({"ph": "X", "pid": 1, "tid": 1, "name": name, "ts": ts, "dur": dur,
                       "args": args})
    return {"traceEvents": events}


def torch_form(drop_correlation: tuple = ()) -> dict:
    events = [{"ph": "M", "pid": 0, "name": "process_name", "args": {"name": "GPU 0"}},
              dict(HOST_NOISE, cat="python_function")]
    for i, (name, ts, dur) in enumerate(WINDOWS):
        events.append({"ph": "X", "cat": "user_annotation", "pid": 2, "tid": 1, "name": name,
                       "ts": ts, "dur": dur, "args": {"External id": 100 + i}})
        # the profiler mirrors each annotation onto the device's row: not a window
        events.append({"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
                       "name": name, "ts": ts + 700.0, "dur": dur, "args": {}})
    calls = {}
    for _name, _ts, _dur, _launch, call, _stage in OPS:
        if call is not None:
            calls[call[2]] = call
    for corr, (ts, tid, _) in sorted(calls.items()):
        api = "cudaGraphLaunch" if corr == 7 else "cudaLaunchKernel"
        events.append({"ph": "X", "cat": "cuda_runtime", "pid": 2, "tid": tid, "name": api,
                       "ts": ts, "dur": 3.0, "args": {"correlation": corr, "cbid": 211}})
        events.append({"ph": "s", "id": corr, "pid": 2, "tid": tid, "ts": ts, "cat": "ac2g",
                       "name": "ac2g"})
    for name, ts, dur, _launch, call, _stage in OPS:
        cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
        args = {"device": 0, "stream": 7}
        if call is not None and name not in drop_correlation:
            args["correlation"] = call[2]
        events.append({"ph": "X", "cat": cat, "pid": 0, "tid": 7, "name": name, "ts": ts,
                       "dur": dur, "args": args})
    return {"traceEvents": events, "deviceProperties": [{"name": "NVIDIA H100 80GB HBM3"}]}


def _renamed(rows):
    """JAX's rows with the HLO module renamed to the launch annotation."""
    back = {v: k for k, v in HLO_MODULE.items()}
    return [{**r, "module": back.get(r["module"], r["module"])} for r in rows]


@pytest.mark.parametrize("top_k", [0, 3])
def test_summary_matches_jax(top_k):
    want = jops.summarize(jax_form(), hlo_modules={v: k.split(":")[1] for k, v in
                                                   HLO_MODULE.items()}, top_k=top_k)
    got = tops.summarize(torch_form(), top_k=top_k)
    assert got["ops"] == _renamed(want["ops"])
    for key in ("total_op_time_us", "op_count", "models", "unattributed_us", "stages",
                "annotation_windows"):
        assert got[key] == want[key], key
    assert got["models"] == {"det2d": 220.0, "pillars": 110.0}
    assert got["unattributed_us"] == 50.0
    assert got["annotation_windows"] == {"det2d": 2, "pillars": 1}
    assert got["stages"] == {"decode_nms": 20.0, "voxelize_scatter": 90.0}
    assert len(got["ops"]) == (3 if top_k else 10)


def _row(summary, fn):
    return next(r for r in summary["ops"] if tops.kernel_function(r["op"]) == fn)


def test_a_kernel_outside_every_window_is_attributed_by_correlation_alone():
    kernel = "decode_nms_2d_scan(float const*, float const*, int)"
    row = _row(tops.summarize(torch_form()), "decode_nms_2d_scan")
    assert (row["model"], row["module"], row["stage"]) == ("det2d", "launch:det2d:1",
                                                           "decode_nms")
    # without its correlation id the midpoint rule finds no window for it
    bare = _row(tops.summarize(torch_form(drop_correlation=(kernel,))), "decode_nms_2d_scan")
    assert bare["model"] is None and bare["module"] == "?"
    # a correlated op whose call lies in no window gets no midpoint fallback,
    # even where its midpoint lies inside one (a readback issued at resolve)
    doc = torch_form()
    doc["traceEvents"] += [
        {"ph": "X", "cat": "cuda_runtime", "pid": 2, "tid": 1, "name": "cudaMemcpyAsync",
         "ts": 3500.0, "dur": 2.0, "args": {"correlation": 99}},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7, "name": "Memcpy DtoH",
         "ts": 250.0, "dur": 4.0, "args": {"correlation": 99}},
    ]
    summary = tops.summarize(doc)
    readback = next(r for r in summary["ops"] if r["op"] == "Memcpy DtoH")
    assert readback["model"] is None and summary["unattributed_us"] == 54.0


def test_launchers_mapping_overrides_the_annotation_name():
    got = tops.summarize(torch_form(), launchers={"launch:pillars:1": "second"})
    assert got["models"] == {"det2d": 220.0, "second": 110.0}


def test_every_hand_kernel_maps_to_a_jax_fused_stage():
    names = set()
    for path in sorted((ROOT / "triton_client_tpu_torch" / "csrc").glob("*.cu")):
        names |= set(re.findall(r"__global__ void[^\n]*\n(\w+)\(", path.read_text()))
    assert set(tops.KERNEL_STAGES) <= names
    # kernels 2 (greedy_nms) and 6 (segment_sum) belong to no fused stage
    assert names - set(tops.KERNEL_STAGES) == {"greedy_nms_order", "greedy_nms_mask",
                                                "greedy_nms_scan", "segment_sum_chunks_fold"}
    assert set(tops.KERNEL_STAGES.values()) == set(FUSED_STAGES)
    for fn, stage in tops.KERNEL_STAGES.items():
        assert tops.fused_stage(f"{fn}(float const*, int)") == stage
        assert tops.fused_stage(f"_Z{len(fn)}{fn}PKfi") == stage
    assert tops.kernel_function("void at::native::vectorized_elementwise_kernel<4, "
                                "at::native::FillFunctor<float> >(int)") == \
        "vectorized_elementwise_kernel"
    assert tops.op_kind("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32") == "dot"
    for name in ("Memcpy DtoH (Device -> Pinned)", "fusion.1", "copy.3", "reduce_window.2"):
        assert tops.op_kind(name) == jops.op_kind(name)


def test_find_trace_file_and_gz_round_trip(tmp_path):
    prof = tmp_path / "prof"
    prof.mkdir()
    assert tops.find_trace_file(str(prof)) is None
    with pytest.raises(FileNotFoundError):
        tops.summarize_profile_dir(str(prof))
    (prof / "trace.json").write_text(json.dumps(torch_form()))
    assert tops.find_trace_file(str(prof)) == str(prof / "trace.json")
    nested = prof / "run" / "host.1.pt.trace.json.gz"
    nested.parent.mkdir()
    with gzip.open(nested, "wt") as fh:
        json.dump(torch_form(), fh)
    assert tops.find_trace_file(str(prof)) == str(nested)
    s = tops.summarize_profile_dir(str(prof), top_k=2)
    assert s["trace_file"] == str(nested) and len(s["ops"]) == 2
    assert s["total_op_time_us"] == 380.0


def test_trace_dump_ops_prints_jax_table(tmp_path, capsys):
    jdir = tmp_path / "jax" / "plugins" / "profile" / "run"
    jdir.mkdir(parents=True)
    (jdir / "h.trace.json").write_text(json.dumps(jax_form()))
    tdir = tmp_path / "port"
    tdir.mkdir()
    (tdir / "trace.json").write_text(json.dumps(torch_form()))
    jtools.trace_dump(["--ops", str(tmp_path / "jax"), "--top-k", "6"])
    jout = capsys.readouterr().out
    ttools.trace_dump(["--ops", str(tdir), "--top-k", "6", "-o", str(tmp_path / "ops.json")])
    tout = capsys.readouterr().out
    assert tout == jout
    assert "det2d: 0.220 ms" in tout and "(unattributed: 0.050 ms)" in tout
    assert json.loads((tmp_path / "ops.json").read_text())["models"]["pillars"] == 110.0


@pytest.mark.parametrize("argv", [[], ["--ops", "--seconds", "0.05"], ["-n", "2", "--top-k", "5"]])
def test_trace_dump_live_forms_match_jax(argv, capsys):
    """The live forms against a port telemetry endpoint (port 0) holding
    three finished traces: the JAX tool and the port's print the same (the
    trace ring's Chrome JSON; bare ``--ops``: a /profile capture's table,
    empty off the card)."""
    from triton_client_tpu_torch.obs.http import TelemetryServer
    from triton_client_tpu_torch.obs.trace import Tracer

    tracer = Tracer(capacity=8)
    for i in range(3):
        tr = tracer.start(model="m", request_id=f"r{i}")
        tr.add("device_execute", tr.t_start, tr.t_start + 0.001)
        tracer.finish(tr)
    server = TelemetryServer(port=0, host="127.0.0.1", tracer=tracer)
    try:
        url = ["--url", f"http://127.0.0.1:{server.port}"]
        jtools.trace_dump(url + argv)
        jout = capsys.readouterr().out
        ttools.trace_dump(url + argv)
        tout = capsys.readouterr().out
    finally:
        server.close()
    assert tout == jout
    if "--ops" not in argv:
        events = json.loads(tout)["traceEvents"]
        assert sum(e.get("name") == "request" for e in events) == (2 if "-n" in argv else 3)


def test_launches_carry_their_annotation_in_a_real_profiler_trace(tmp_path):
    """The CPU channel's launches in ``obs/profiling.device_trace``'s
    export: one ``launch:`` window a request (no device ops off the card)."""
    from triton_client_tpu_torch.obs.profiling import device_trace

    _, chan = _port()
    with device_trace(str(tmp_path)):
        for i in range(3):
            chan.do_inference(InferRequest("staged", {"x": _frame(i)}))
        chan.do_inference(InferRequest("eager", {"x": _frame(0)}))
    s = tops.summarize_profile_dir(str(tmp_path))
    assert s["annotation_windows"] == {"staged": 3, "eager": 1}
    assert s["op_count"] == 0 and s["models"] == {}
    assert np.isclose(s["total_op_time_us"], 0.0)
