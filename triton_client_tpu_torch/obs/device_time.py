"""Device-time ledger: per-model x tenant device-seconds and live MFU (the
port's copy of ``obs/device_time.py``).

Every launch's device window accrues into

  * cumulative per-``model|tenant`` device-seconds,
  * a rolling-window device-utilization ratio: busy device-seconds over
    elapsed wall x device count,
  * live per-model MFU: achieved flops over the window against the peak of
    the precision the arithmetic ran at (``spec.extra["flops_per_call"]``
    and ``extra["compute_precision"]``, measured at the first launch by
    ``obs/roofline.record_launch_cost``; else the policy's
    ``extra["precision"]``), from the H100 table of ``obs/roofline.py``.

The window is the card's own: ``CUDAChannel`` records a timing CUDA event
on the launch stream just before the launcher and one behind it, and
``resolve`` records ``start.elapsed_time(end)`` once the launch has
executed. So time a launch spends queued behind an earlier one is not in
its window (JAX's window is ``t_launched -> block_until_ready`` on the
host clock, which includes it). On a CPU channel the window is the
launcher call's own wall time: the launch has finished when it returns.

``record`` runs on the resolve path (once per launch): float and dict work
under one short lock, no host sync.
"""

from __future__ import annotations

import collections
import threading
import time

from triton_client_tpu_torch.obs.roofline import (  # noqa: F401 (re-exported)
    H100_PEAK_FP32_FLOPS,
    POLICY_PEAK_FLOPS,
)


class DeviceTimeLedger:
    """Accumulates per-launch device-execute durations.

    ``tenants``: anything answering ``tenant_of(model) -> str``; models
    outside any tenant land under ``"default"``. ``devices``: cards the
    busy ratio is normalized over. ``window_s``: rolling window for the
    LIVE utilization/MFU gauges (cumulative counters never reset).

    Flops metadata is learned lazily per model from the ``spec_extra``
    mapping the channel passes on each record (first one wins):
    ``flops_per_call`` (flops of one launch at its serving batch) and
    ``compute_precision`` (``obs/roofline.measure_launch_cost``), else
    ``precision`` (the policy name), keying :data:`POLICY_PEAK_FLOPS`.
    Models without flops metadata still account device-seconds; their MFU
    is not reported.
    """

    def __init__(
        self,
        tenants=None,
        devices: int = 1,
        window_s: float = 60.0,
        buckets: int = 12,
    ) -> None:
        self._tenants = tenants
        self._devices = max(1, int(devices))
        self._window_s = float(window_s)
        self._n_buckets = max(2, int(buckets))
        self._bucket_w = self._window_s / self._n_buckets
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        # cumulative account
        self._device_s: collections.Counter = collections.Counter()
        self._launches: collections.Counter = collections.Counter()
        self._total_device_s = 0.0
        # per-model flops metadata learned from spec.extra
        self._flops_per_call: dict[str, float] = {}
        self._peak_flops: dict[str, float] = {}
        # rolling window: ring of (bucket_index, {model: [dev_s, flops]})
        self._ring: collections.deque = collections.deque(maxlen=self._n_buckets)
        self._tenant_cache: dict[str, str] = {}

    # -- recording --------------------------------------------------------------

    def tenant_of(self, model: str) -> str:
        tenant = self._tenant_cache.get(model)
        if tenant is None:
            tenant = "default"
            if self._tenants is not None:
                try:
                    tenant = self._tenants.tenant_of(model) or "default"
                except Exception:
                    tenant = "default"
            self._tenant_cache[model] = tenant
        return tenant

    def record(self, model: str, duration_s: float, spec_extra=None, tenant=None) -> None:
        """Account one launch's device window (the channel's resolve calls
        this once the launch has executed). ``tenant`` overrides the table
        lookup."""
        if duration_s < 0:
            duration_s = 0.0
        if tenant is None:
            tenant = self.tenant_of(model)
        flops = self._flops_per_call.get(model)
        if flops is None and spec_extra:
            try:
                flops = float(spec_extra.get("flops_per_call") or 0.0)
            except (TypeError, ValueError):
                flops = 0.0
            self._flops_per_call[model] = flops
            precision = str(spec_extra.get("compute_precision")
                            or spec_extra.get("precision") or "f32")
            self._peak_flops[model] = POLICY_PEAK_FLOPS.get(precision, H100_PEAK_FP32_FLOPS)
        now = time.perf_counter()
        idx = int(now / self._bucket_w)
        with self._lock:
            self._device_s[f"{model}|{tenant}"] += duration_s
            self._launches[model] += 1
            self._total_device_s += duration_s
            if not self._ring or self._ring[-1][0] != idx:
                self._ring.append((idx, {}))
            per_model = self._ring[-1][1]
            cell = per_model.get(model)
            if cell is None:
                cell = per_model[model] = [0.0, 0.0]
            cell[0] += duration_s
            cell[1] += flops or 0.0

    # -- reading ----------------------------------------------------------------

    def _window_totals(self, now: float):
        """(elapsed_s, busy_s, {model: [dev_s, flops]}) over the live window;
        the caller holds the lock."""
        idx_now = int(now / self._bucket_w)
        floor = idx_now - self._n_buckets + 1
        busy = 0.0
        per_model: dict[str, list[float]] = {}
        for idx, models in self._ring:
            if idx < floor:
                continue
            for model, (dev_s, flops) in models.items():
                cell = per_model.get(model)
                if cell is None:
                    cell = per_model[model] = [0.0, 0.0]
                cell[0] += dev_s
                cell[1] += flops
                busy += dev_s
        elapsed = min(now - self._t0, self._window_s)
        return max(elapsed, 1e-9), busy, per_model

    def utilization(self) -> float:
        """Rolling-window busy fraction: device-seconds executed over
        elapsed wall x devices."""
        now = time.perf_counter()
        with self._lock:
            elapsed, busy, _ = self._window_totals(now)
        return min(1.0, busy / (elapsed * self._devices))

    def mfu(self) -> dict[str, float]:
        """Live per-model MFU over the rolling window (only models with
        flops metadata)."""
        now = time.perf_counter()
        with self._lock:
            elapsed, _, per_model = self._window_totals(now)
            peaks = dict(self._peak_flops)
        out = {}
        for model, (_dev_s, flops) in per_model.items():
            peak = peaks.get(model) or 0.0
            if flops > 0 and peak > 0:
                out[model] = flops / elapsed / (peak * self._devices)
        return out

    def device_seconds(self) -> dict[str, float]:
        """Cumulative ``{"model|tenant": seconds}``."""
        with self._lock:
            return dict(self._device_s)

    def snapshot(self) -> dict:
        now = time.perf_counter()
        with self._lock:
            elapsed, busy, per_model = self._window_totals(now)
            device_s = dict(self._device_s)
            launches = dict(self._launches)
            total = self._total_device_s
            peaks = dict(self._peak_flops)
            uptime = now - self._t0
        mfu = {
            model: flops / elapsed / ((peaks.get(model) or 0.0) * self._devices)
            for model, (_d, flops) in per_model.items()
            if flops > 0 and peaks.get(model)
        }
        return {
            "devices": self._devices,
            "uptime_s": uptime,
            "device_seconds": device_s,
            "launches": launches,
            "total_device_seconds": total,
            "busy_fraction": min(1.0, total / (max(uptime, 1e-9) * self._devices)),
            "window": {
                "seconds": elapsed,
                "device_seconds": busy,
                "utilization": min(1.0, busy / (elapsed * self._devices)),
                "mfu": mfu,
            },
        }
