"""The port's device-time ledger (``obs/device_time.py``) against the JAX
package's, and ``StagedChannel.attach_device_time`` on a CPU channel.

Bars: the same ``record`` sequence under the same frozen clock gives equal
device-seconds, launches, utilization and snapshot (keys and values), and
``mfu x peak`` equal to 1e-12 relative (the peaks differ by design: the
port divides by the H100's, ``obs/roofline.py``). Through a CPU
``CUDAChannel`` a ledger counts one launch a request with a positive
window (the launcher's own wall time there), as JAX's ``TPUChannel``
counts one.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from triton_client_tpu.channel import InferRequest as JRequest
from triton_client_tpu.obs import device_time as jdt
from triton_client_tpu.obs import roofline as jroof

from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.obs import device_time as tdt
from triton_client_tpu_torch.obs import roofline as troof
from tests.test_torch_staged import _frame, _jax, _port

#: (model, seconds, spec.extra, tenant, clock advance before the record)
RECORDS = (
    ("det2d", 0.004, {"flops_per_call": 8.2e9, "precision": "bf16"}, None, 0.5),
    ("det2d", 0.0041, {"flops_per_call": 1.0, "precision": "f32"}, None, 0.25),  # first wins
    ("pillars", 0.012, {"flops_per_call": 6.3e10}, None, 1.0),
    ("second", 0.009, {"precision": "int8w"}, "tenant_b", 2.0),
    ("pillars", -1.0, {"flops_per_call": 6.3e10}, None, 7.0),  # clamps to 0
    ("nometa", 0.002, None, "stream:s1", 0.0),
    ("det2d", 0.0039, None, None, 30.0),
    ("second", 0.0088, {"precision": "int8w"}, None, 45.0),  # old buckets age out
    ("int8", 0.001, {"flops_per_call": 2e9, "precision": "int8"}, None, 1.5),
)


class _Tenants:
    def tenant_of(self, model):
        if model == "boom":
            raise RuntimeError("lookup failed")
        return {"pillars": "lidar"}.get(model)


def _run(mod, monkeypatch, clock):
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    ledger = mod.DeviceTimeLedger(tenants=_Tenants(), devices=2, window_s=60.0, buckets=6)
    reads = []
    for model, seconds, extra, tenant, advance in RECORDS:
        clock[0] += advance
        ledger.record(model, seconds, extra, tenant=tenant)
        reads.append((ledger.device_seconds(), ledger.utilization(), ledger.mfu(),
                      ledger.snapshot()))
    ledger.record("boom", 0.5)
    reads.append((ledger.device_seconds(), ledger.utilization(), ledger.mfu(),
                  ledger.snapshot()))
    return reads


def _peak(mod, extra):
    return mod.POLICY_PEAK_FLOPS.get(str((extra or {}).get("precision") or "f32"))


def test_ledger_matches_jax_under_one_clock(monkeypatch):
    jreads = _run(jdt, monkeypatch, [1000.0])
    treads = _run(tdt, monkeypatch, [1000.0])
    first_extra = {}
    for model, _s, extra, _t, _a in RECORDS:
        first_extra.setdefault(model, extra)
    for (jsec, jutil, jmfu, jsnap), (tsec, tutil, tmfu, tsnap) in zip(jreads, treads):
        assert tsec == jsec
        assert tutil == jutil
        assert set(tmfu) == set(jmfu)
        for model, value in tmfu.items():
            extra = first_extra[model]
            assert value * _peak(troof, extra) == pytest.approx(
                jmfu[model] * _peak(jroof, extra), rel=1e-12)
        assert set(tsnap) == set(jsnap) and set(tsnap["window"]) == set(jsnap["window"])
        tw, jw = dict(tsnap["window"]), dict(jsnap["window"])
        tmfu_w, jmfu_w = tw.pop("mfu"), jw.pop("mfu")
        assert tw == jw and set(tmfu_w) == set(jmfu_w)
        assert {k: v for k, v in tsnap.items() if k != "window"} == \
               {k: v for k, v in jsnap.items() if k != "window"}
    snap = treads[-1][3]
    assert snap["launches"] == {"det2d": 3, "pillars": 2, "second": 2, "nometa": 1,
                                "int8": 1, "boom": 1}
    assert snap["device_seconds"]["pillars|lidar"] == pytest.approx(0.012)
    assert snap["device_seconds"]["boom|default"] == 0.5


def test_ledger_divides_by_the_h100_peaks(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    ledger = tdt.DeviceTimeLedger(window_s=10.0)
    clock[0] = 2.0
    for precision in ("f32", "bf16", "int8w", "int8", "fp64?"):
        ledger.record(precision, 0.001, {"flops_per_call": 1e12, "precision": precision})
    mfu = ledger.mfu()
    assert mfu["f32"] == pytest.approx(1e12 / 2.0 / 67e12, rel=1e-12)
    assert mfu["bf16"] == pytest.approx(1e12 / 2.0 / 989e12, rel=1e-12)
    assert mfu["int8w"] == mfu["int8"] == mfu["fp64?"] == mfu["f32"]


def _toy_requests(chan, req, n, seed0=0):
    return [chan.do_inference(req("staged", {"x": _frame(seed0 + i)})) for i in range(n)]


def test_cpu_channel_records_one_launch_a_request_as_jax():
    _, chan = _port()
    _, jchan = _jax()
    ledgers = (tdt.DeviceTimeLedger(), jdt.DeviceTimeLedger())
    chan.attach_device_time(ledgers[0])
    jchan.attach_device_time(ledgers[1])
    assert chan.device_time is ledgers[0]
    _toy_requests(chan, InferRequest, 4)
    _toy_requests(jchan, JRequest, 4)
    for c, req in ((chan, InferRequest), (jchan, JRequest)):
        futs = [c.do_inference_async(req("eager", {"x": _frame(9)})) for _ in range(2)]
        for f in futs:
            f.result()
    tsnap, jsnap = ledgers[0].snapshot(), ledgers[1].snapshot()
    assert tsnap["launches"] == jsnap["launches"] == {"staged": 4, "eager": 2}
    assert set(tsnap["device_seconds"]) == set(jsnap["device_seconds"])
    assert all(v > 0 for v in tsnap["device_seconds"].values())
    # the first launch measured the body's cost (obs/roofline), as JAX's does
    extra = chan._repository.get("staged").spec.extra
    assert extra["launch_annotation"] == "launch:staged:1"
    assert extra["flops_per_call"] == extra["measured_flops_per_call"] == 2 * 8 * 4 * 4
    assert extra["measured_batch"] == 8
    assert "measured_flops_per_call" not in chan._repository.get("eager").spec.extra


def test_windows_are_the_launchers_own_wall_time(monkeypatch):
    """One ledger record a request, each window within the request's wall."""
    _, chan = _port()
    seen = []

    class Recording(tdt.DeviceTimeLedger):
        def record(self, model, duration_s, spec_extra=None, tenant=None):
            seen.append(duration_s)
            super().record(model, duration_s, spec_extra, tenant)

    chan.attach_device_time(Recording())
    walls = []
    for i in range(5):
        t0 = time.perf_counter()
        chan.do_inference(InferRequest("staged", {"x": _frame(i)}))
        walls.append(time.perf_counter() - t0)
    assert len(seen) == 5
    assert all(0 < s <= w for s, w in zip(seen, walls))


def test_no_ledger_no_window_and_no_cost(monkeypatch):
    """Without a ledger the launch opens no window (on the card: creates no
    timing event) and measures nothing; detaching restores that."""
    _, chan = _port()

    def boom(self):
        raise AssertionError("a device window opened with no ledger attached")

    monkeypatch.setattr(CUDAChannel, "_begin_window", boom)
    out = _toy_requests(chan, InferRequest, 2)
    assert out[0].outputs["y"].shape == (8, 4)
    assert "measured_flops_per_call" not in chan._repository.get("staged").spec.extra
    chan.attach_device_time(tdt.DeviceTimeLedger())
    chan.attach_device_time(None)
    assert chan.device_time is None
    _toy_requests(chan, InferRequest, 1)


def test_a_failing_cost_measurement_never_fails_the_launch():
    _, chan = _port()
    model = chan._repository.get("staged")
    calls = []

    def body(inputs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("measurement run failed")
        return {"y": torch.tanh(inputs["x"]), "cls": torch.zeros(inputs["x"].shape[0],
                                                                  dtype=torch.int32)}

    chan._repository.register(model.spec, model.infer_fn, device_fn=body)
    chan.attach_device_time(tdt.DeviceTimeLedger())
    out = chan.do_inference(InferRequest("staged", {"x": _frame(0)})).outputs
    np.testing.assert_allclose(out["y"], np.tanh(_frame(0)), rtol=1e-6)
    chan.do_inference(InferRequest("staged", {"x": _frame(1)}))
    assert len(calls) == 3  # the measuring run once, then one call a launch
    assert chan.device_time.snapshot()["launches"] == {"staged": 2}


def test_batch_rows_of_a_launch():
    """Frames as JAX counts them; a 3D request (padded cloud + a 0-d count)
    is one scan, where JAX counts its padded points."""
    from triton_client_tpu.channel.staged import _batch_rows as jrows

    from triton_client_tpu_torch.channel.staged import _batch_rows

    frames = {"images": np.zeros((8, 4, 4, 3), np.uint8), "scale": np.zeros((1,), np.float32)}
    assert _batch_rows({k: torch.from_numpy(v) for k, v in frames.items()}) == jrows(frames) == 8
    scan = {"points": np.zeros((4096, 4), np.float32), "num_points": np.asarray(5, np.int32)}
    assert jrows(scan) == 4096
    assert _batch_rows({k: torch.from_numpy(v) for k, v in scan.items()}) == 1
