"""Roofline attribution: measured flops/bytes -> bound class + ceiling (the
port's copy of ``obs/roofline.py``, on the H100's peaks).

Two numbers place a model against the card's roofline:

  arithmetic intensity  I = flops / bytes            (flop per HBM byte)
  machine knee          K = peak_flops / peak_bw     (flop per byte)

I >= K means the arithmetic ceiling binds (compute-bound: the attainable
rate is ``peak_flops / flops`` calls/s); I < K means the HBM ceiling binds
(bandwidth-bound: ``peak_bw / bytes`` calls/s). The attainable-fps ceiling
beside the measured rate names the gap.

flops/bytes are MEASURED once per model, by one eager run of its body
before any capture (:func:`measure_launch_cost`): flops from
``torch.utils.flop_counter.FlopCounterMode`` (2 x the multiply-adds of the
convolutions and matrix products), bytes from a dispatch mode that sums
every aten op's operand and result bytes (the per-op, pre-fusion count
that XLA's "bytes accessed" is too; views move nothing and count nothing).
They are recorded into ``model.spec.extra`` under the JAX module's keys:

  measured_flops_per_call / measured_bytes_per_call   the counts above
  measured_batch                                      rows they were
                                                      measured at
  flops_per_call                                      overwritten with
                                                      the measured value
                                                      (the ledger's MFU
                                                      reads it)
  analytic_flops_per_call                             the previous seed,
                                                      kept as a labeled
                                                      comparison only
  compute_precision                                   (the port's own)
                                                      ``bf16`` where most
                                                      flops ran in
                                                      bfloat16, else
                                                      ``f32``: the peak
                                                      the ledger and
                                                      model_row divide by
                                                      ahead of
                                                      ``precision``
  launch_annotation                                   JAX's ``hlo_module``:
                                                      the name opstats
                                                      maps device ops
                                                      back to this model
                                                      by, the launch's
                                                      ``record_function``

This module is the single home of the card's peaks: the device-time
ledger's MFU, the ``roofline`` tool and a benchmark divide by the same
table.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

#: One NVIDIA H100 SXM5 80GB's dense peaks at its 700 W power limit, from
#: NVIDIA's H100 Tensor Core GPU data sheet (the SKU ``nvidia-smi`` names
#: "NVIDIA H100 80GB HBM3"): 67 TFLOP/s fp32 on the CUDA cores, 989
#: TFLOP/s bf16 on the tensor cores without sparsity, 3.35 TB/s of HBM3.
#: The ``f32`` body runs with TF32 off (``device.strict_fp32``), and under
#: ``int8w`` and ``int8`` the port dequantizes and computes in float32
#: (``runtime/precision.py``): those three divide by the fp32 peak.
H100_PEAK_FP32_FLOPS = 67e12
H100_PEAK_BF16_FLOPS = 989e12
#: HBM3 bandwidth (bytes/s): the roofline's memory slope.
H100_PEAK_HBM_BPS = 3.35e12

POLICY_PEAK_FLOPS = {
    "f32": H100_PEAK_FP32_FLOPS,
    "bf16": H100_PEAK_BF16_FLOPS,
    "int8w": H100_PEAK_FP32_FLOPS,
    "int8": H100_PEAK_FP32_FLOPS,
}
#: HBM bandwidth is precision-independent (narrower dtypes already shrink
#: the measured byte count).
POLICY_PEAK_BYTES = {
    "f32": H100_PEAK_HBM_BPS,
    "bf16": H100_PEAK_HBM_BPS,
    "int8w": H100_PEAK_HBM_BPS,
    "int8": H100_PEAK_HBM_BPS,
}

#: the name StagedChannel.launch gives each launch: ``launch:<model>:<version>``
LAUNCH_PREFIX = "launch:"


def peak_flops(precision: str | None) -> float:
    return POLICY_PEAK_FLOPS.get(str(precision or "f32"), H100_PEAK_FP32_FLOPS)


def peak_bytes_per_s(precision: str | None) -> float:
    return POLICY_PEAK_BYTES.get(str(precision or "f32"), H100_PEAK_HBM_BPS)


@dataclass
class RooflineRow:
    """One model's (or op's) position against the machine roofline."""

    flops: float
    bytes: float
    precision: str = "f32"
    batch: int = 1
    #: derived
    intensity: float = 0.0
    knee: float = 0.0
    bound: str = "unknown"
    attainable_calls_per_s: float = 0.0
    attainable_fps: float = 0.0

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "precision": self.precision,
            "batch": self.batch,
            "intensity": self.intensity,
            "knee": self.knee,
            "bound": self.bound,
            "attainable_calls_per_s": self.attainable_calls_per_s,
            "attainable_fps": self.attainable_fps,
        }


def classify(
    flops: float,
    bytes_accessed: float,
    precision: str = "f32",
    batch: int = 1,
) -> RooflineRow:
    """Roofline position of one launch: arithmetic intensity against the
    machine knee, the binding ceiling, and the attainable call/fps rate if
    ONLY that ceiling bound (the ideal-overlap upper bound a serving rate is
    compared to)."""
    flops = max(0.0, float(flops or 0.0))
    bytes_accessed = max(0.0, float(bytes_accessed or 0.0))
    batch = max(1, int(batch or 1))
    pf, pb = peak_flops(precision), peak_bytes_per_s(precision)
    row = RooflineRow(
        flops=flops, bytes=bytes_accessed, precision=str(precision or "f32"),
        batch=batch, knee=pf / pb,
    )
    if flops <= 0 and bytes_accessed <= 0:
        return row
    row.intensity = flops / bytes_accessed if bytes_accessed > 0 else float("inf")
    compute_rate = pf / flops if flops > 0 else float("inf")
    memory_rate = pb / bytes_accessed if bytes_accessed > 0 else float("inf")
    row.bound = "compute" if compute_rate <= memory_rate else "bandwidth"
    row.attainable_calls_per_s = min(compute_rate, memory_rate)
    row.attainable_fps = row.attainable_calls_per_s * batch
    return row


# -- measured cost capture (first launch) --------------------------------------


def launcher_name(model) -> str:
    """The name of a model's launches, ``launch:<model>:<version>``:
    ``StagedChannel.launch`` wraps each launcher call in a
    ``torch.profiler.record_function`` of it, and opstats maps the card's
    ops back to the model through it (JAX names its jitted launcher
    ``mdl_<model>_<version>`` and maps by the HLO module)."""
    return f"{LAUNCH_PREFIX}{model.spec.name}:{model.spec.version}"


def hlo_module_for(model) -> str:
    """JAX's HLO module name of the launcher; in the port the key opstats
    maps by is the launch annotation, :func:`launcher_name`."""
    return launcher_name(model)


def name_launcher(fn, model):
    """Stamp a launcher callable with the model's launcher name (JAX does
    so before ``jax.jit`` takes the module name from it)."""
    name = launcher_name(model)
    try:
        fn.__name__ = name
        fn.__qualname__ = name
    except (AttributeError, TypeError):
        pass
    return fn


def _is_view(func) -> bool:
    """An aten op whose result aliases an input without writing it."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _tensor_bytes(tree) -> int:
    from torch.utils import _pytree as pytree

    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _cost_counter():
    """A dispatch mode that sums each aten op's operand and result bytes in
    ``.bytes``, and the flops of the ops ``torch.utils.flop_counter`` counts
    by their first operand's dtype in ``.flops_by_dtype`` (built here:
    ``torch.utils._python_dispatch`` is imported only when a cost is
    measured)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class CostCounter(TorchDispatchMode):
        def __init__(self) -> None:
            super().__init__()
            self.bytes = 0
            self.flops_by_dtype: dict[torch.dtype, int] = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not _is_view(func):
                self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                dtype = next(a.dtype for a in args if isinstance(a, torch.Tensor))
                self.flops_by_dtype[dtype] = (self.flops_by_dtype.get(dtype, 0)
                                              + formula(*args, **kwargs, out_val=out))
            return out

    return CostCounter()


def measure_launch_cost(body, *args, batch_rows: int = 1) -> dict:
    """Measured flops/bytes of one call of ``body`` (a model's eager body,
    never its captured graph: a replay runs no aten op) at the given args,
    by running it once under the counting modes.

    Returns ``{"flops", "bytes", "batch", "compute_precision"}``: the last
    is ``bf16`` where most of the flops ran in bfloat16 (a ``dtype: bf16``
    body keeps the ``f32`` wire policy, so ``spec.extra["precision"]``
    does not say which peak its arithmetic runs at), else ``f32``."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = _cost_counter()
    with torch.no_grad(), FlopCounterMode(display=False) as flops, counter:
        body(*args)
    by_dtype = counter.flops_by_dtype
    bf16 = by_dtype.get(torch.bfloat16, 0) * 2 > sum(by_dtype.values())
    return {
        "flops": float(flops.get_total_flops()),
        "bytes": float(counter.bytes),
        "batch": max(1, int(batch_rows or 1)),
        "compute_precision": "bf16" if bf16 else "f32",
    }


def record_launch_cost(model, body, *args, batch_rows: int = 1) -> dict:
    """Measure one call and record the result into ``model.spec.extra``
    (the module docstring lists the keys). A previous ``flops_per_call``
    seed is kept as ``analytic_flops_per_call`` and then OVERWRITTEN with
    the measured value, so every flops consumer (the DeviceTimeLedger's
    MFU, the roofline rows) divides by what ran."""
    measured = measure_launch_cost(body, *args, batch_rows=batch_rows)
    extra = model.spec.extra
    seed = extra.get("flops_per_call")
    if seed is not None and "analytic_flops_per_call" not in extra:
        extra["analytic_flops_per_call"] = seed
    if measured["flops"] > 0:
        extra["flops_per_call"] = measured["flops"]
    extra["measured_flops_per_call"] = measured["flops"]
    extra["measured_bytes_per_call"] = measured["bytes"]
    extra["measured_batch"] = measured["batch"]
    extra["compute_precision"] = measured["compute_precision"]
    extra.setdefault("launch_annotation", launcher_name(model))
    return measured


def model_row(extra: dict, measured_fps: float | None = None) -> dict:
    """Roofline report row from a model's ``spec.extra`` (the rows of a
    model snapshot and of the ``roofline`` tool). ``measured_fps``, where
    known, is reported beside the attainable ceiling as
    ``attained_fraction``."""
    flops = float(extra.get("measured_flops_per_call") or 0.0)
    bytes_ = float(extra.get("measured_bytes_per_call") or 0.0)
    batch = int(extra.get("measured_batch") or 1)
    precision = str(extra.get("compute_precision") or extra.get("precision") or "f32")
    row = classify(flops, bytes_, precision, batch).as_dict()
    analytic = extra.get("analytic_flops_per_call")
    if analytic is not None:
        row["analytic_flops_per_call"] = float(analytic)
    if measured_fps is not None and row["attainable_fps"] > 0:
        row["measured_fps"] = float(measured_fps)
        row["attained_fraction"] = float(measured_fps) / row["attainable_fps"]
    return row
