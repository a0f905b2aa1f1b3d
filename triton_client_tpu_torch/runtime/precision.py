"""Per-model serving precision policies (port of ``runtime/precision.py``):
``f32``, ``bf16``, ``int8w`` and ``int8``.

  * ``f32``   — the plain path, unchanged.
  * ``bf16``  — parameters stored as bfloat16 (:meth:`PrecisionPolicy.
    cast_params`), the pipeline body computing in bfloat16
    (:meth:`~PrecisionPolicy.cast_in`), float wire inputs narrowed to
    bfloat16 words on the host before staging (:meth:`~PrecisionPolicy.
    wire_cast`: half the host-to-device bytes, never a widening).
  * ``int8w`` — weight-only quantization: every kernel (a float tensor of
    two or more dimensions) stored as int8 with one symmetric float32
    scale per output channel, ``max|w| / 127``
    (:func:`quantize_channelwise`); biases and BatchNorm stay float32, and
    so do the wire and the compute. On a module the weight is a
    ``torch.nn.utils.parametrize`` parametrization (:class:`Dequantize`)
    that stores ``q`` and ``scale`` and dequantizes on every forward, so
    a captured graph reads the int8 bytes and no float32 copy is kept.
  * ``int8``  — ``int8w`` plus the int8 wire: float inputs that a
    calibration pass covered (:meth:`~PrecisionPolicy.calibrated`,
    ``max|x| / 127`` a tensor) are quantized on the host and dequantized
    inside the captured body (:meth:`~PrecisionPolicy.ingest`), a quarter
    of the float32 bytes. Without scales it stages float32, as ``int8w``.

The keep-lists (``KEEP_F32_2D``/``KEEP_F32_3D``) name the boundary ops
that stay float32 under any policy: a pipeline applies
:meth:`~PrecisionPolicy.boundary` to the raw heads before them, so box
decode, NMS scores and pixel rescale never resolve in bfloat16 and the
hand-written kernels receive float32 as they do at ``f32``.

**Host bfloat16.** numpy has no bfloat16 (the JAX package takes it from
``ml_dtypes``, which the port does not import). On the host a bfloat16
array is carried as its 16-bit words in the structured dtype
:data:`BF16`: one little-endian ``uint16`` field named ``bfloat16``. The
tag is the dtype itself, so it survives every numpy operation the serving
path applies (``np.concatenate``, ``np.stack``, padding, ``np.frombuffer``
of wire bytes), where a ``uint16`` array with a metadata tag decays into
plain integers on a concatenate; arithmetic on the words raises instead of
computing on them. :func:`host_tensor` views the words as a
``torch.bfloat16`` tensor, which is how they reach the card.
Float32 -> bfloat16 rounds to nearest even (PyTorch's conversion), as
``ml_dtypes`` does; a NaN stays a NaN, its payload aside.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Mapping

import numpy as np
import torch

from triton_client_tpu_torch.config import BF16

# The four policy names, in increasing compression order.
POLICIES = ("f32", "bf16", "int8w", "int8")

# Precision-sensitive boundary ops that stay float32 regardless of
# policy, recorded in each pipeline spec's extra["precision_keep_f32"].
KEEP_F32_2D = ("box_decode", "nms_scores", "box_rescale")
KEEP_F32_3D = ("voxelize_coords", "box_decode", "nms_scores")

# Declared accuracy budgets: the largest synthetic-set mAP drop allowed
# against the f32 reference.
MAP_BUDGETS = {"f32": 0.0, "bf16": 0.05, "int8w": 0.10, "int8": 0.15}

# the symmetric int8 range: +-127 keeps the scale invertible without the
# asymmetric -128 corner
_QMAX = 127.0


# -- host bfloat16 words -------------------------------------------------------------


def is_bf16_words(arr) -> bool:
    return isinstance(arr, np.ndarray) and arr.dtype == BF16


def to_bf16_words(arr) -> np.ndarray:
    """A float array -> its bfloat16 words (:data:`BF16`), rounded to
    nearest even. Words pass through."""
    if is_bf16_words(arr):
        return arr
    with warnings.catch_warnings():
        # a read-only wire view (np.frombuffer) is only read here
        warnings.simplefilter("ignore", UserWarning)
        src = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return src.to(torch.bfloat16).view(torch.int16).numpy().view(BF16)


def bf16_words_to_f32(words: np.ndarray) -> np.ndarray:
    """:data:`BF16` words -> float32, exactly (bfloat16 is float32's top
    half)."""
    w = np.ascontiguousarray(words).view(np.uint16)
    return (w.astype(np.uint32) << 16).view(np.float32)


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host array as a CPU tensor over the same memory; :data:`BF16`
    words become a ``torch.bfloat16`` tensor."""
    if is_bf16_words(arr):
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor back on the host as numpy; ``torch.bfloat16`` becomes
    :data:`BF16` words."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(BF16)
    return t.numpy()


# -- int8 quantization -------------------------------------------------------------------


class QuantizedParam:
    """One int8-quantized parameter: ``q`` (int8) and the per-output-channel
    float32 ``scale`` that dequantizes it, both numpy arrays or both
    tensors, as the leaf they came from."""

    __slots__ = ("q", "scale")

    def __init__(self, q, scale) -> None:
        self.q = q
        self.scale = scale

    def dequant(self):
        if isinstance(self.q, torch.Tensor):
            return self.q.float() * self.scale
        return self.q.astype(np.float32) * self.scale

    @property
    def nbytes(self) -> int:
        return _nbytes(self.q) + _nbytes(self.scale)

    @property
    def shape(self) -> tuple:
        return tuple(self.q.shape)

    def __repr__(self) -> str:
        return f"QuantizedParam(shape={self.shape})"


def _nbytes(x) -> int:
    if isinstance(x, QuantizedParam):
        return x.nbytes
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def quantize_channelwise(arr, axis: int = -1) -> QuantizedParam:
    """Symmetric per-channel int8 quantization: ``scale = max|x| / 127``
    over every axis but ``axis`` (the output channel: the last of a flax
    kernel, 0 of a PyTorch ``Conv``/``Linear`` weight, 1 of a
    ``ConvTranspose``'s), 1.0 for an all-zero channel, and ``q =
    clip(rint(x / scale), -127, 127)``, computed in numpy float32 as the
    JAX package computes it, so both give the same bytes. A tensor in gives
    tensors out (on its device), anything else numpy."""
    is_tensor = isinstance(arr, torch.Tensor)
    x = arr.detach().float().cpu().numpy() if is_tensor else _to_f32(arr)
    reduce_axes = tuple(i for i in range(x.ndim) if i != (axis % x.ndim))
    amax = np.max(np.abs(x), axis=reduce_axes, keepdims=True)
    scale = np.where(amax > 0, amax / _QMAX, 1.0).astype(np.float32)
    q = np.clip(np.rint(x / scale), -_QMAX, _QMAX).astype(np.int8)
    if is_tensor:
        return QuantizedParam(torch.from_numpy(q).to(arr.device),
                              torch.from_numpy(scale).to(arr.device))
    return QuantizedParam(q, scale)


def realize(tree):
    """Every :class:`QuantizedParam` of ``tree`` dequantized to float32."""
    return tree_map(lambda x: x.dequant() if isinstance(x, QuantizedParam) else x, tree)


# -- trees -----------------------------------------------------------------------------


def _is_float(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return is_bf16_words(x) or (
        isinstance(x, (np.ndarray, np.generic)) and np.issubdtype(x.dtype, np.floating)
    )


def tree_map(fn, tree):
    """``fn`` over the leaves of nested mappings, lists and tuples."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_bytes(tree) -> int:
    """Bytes of every tensor, array or :class:`QuantizedParam` leaf of
    ``tree`` (a quantized one counts its int8 words and its scales): what
    ``param_bytes`` reports."""
    total = 0

    def add(x):
        nonlocal total
        if isinstance(x, (torch.Tensor, np.ndarray, np.generic, QuantizedParam)):
            total += _nbytes(x)
        return x

    tree_map(add, tree)
    return total


def _to_bf16(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.bfloat16)
    return to_bf16_words(x)


def _to_f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    if is_bf16_words(x):
        return bf16_words_to_f32(x)
    return np.asarray(x, np.float32)


# -- the policy -------------------------------------------------------------------------


def resolve_policy(precision, dtype=torch.float32):
    """The builders' policy resolution: parse the policy and pick the
    model's compute dtype. The ``bf16`` policy switches a float32 model to
    bfloat16; an explicit ``dtype`` wins (``model: {dtype: bf16}``, the
    examples' spelling, keeps its policy's wire). Returns ``(policy,
    model_dtype)``."""
    policy = PrecisionPolicy.parse(precision)
    if policy.name == "bf16" and dtype == torch.float32:
        dtype = torch.bfloat16
    return policy, dtype


def parse_compute_dtype(name) -> torch.dtype:
    """A model's compute-dtype string (``fp32``/``float32``/``bf16``/
    ``bfloat16``) -> torch dtype (``config.yaml``'s ``model: {dtype: ...}``)."""
    table = {"fp32": torch.float32, "float32": torch.float32,
             "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}
    if isinstance(name, torch.dtype) and name in table.values():
        return name
    if name not in table:
        raise ValueError(f"unknown model dtype {name!r} (fp32|bf16)")
    return table[name]


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One model's serving precision (see the module docstring).

    ``act_scales`` (``int8`` only): per-input symmetric scales from
    :meth:`calibrated`, a sorted tuple of (name, scale) so the policy stays
    hashable. ``keep_f32_inputs``: wire inputs never narrowed (the 3D
    pipelines keep ``points`` float32: the voxelizer's cell coordinates are
    precision-sensitive)."""

    name: str = "f32"
    act_scales: tuple[tuple[str, float], ...] = ()
    keep_f32_inputs: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if self.name not in POLICIES:
            raise ValueError(
                f"unknown precision policy {self.name!r} (expected one of {'|'.join(POLICIES)})"
            )

    @classmethod
    def parse(cls, value) -> "PrecisionPolicy":
        """str | PrecisionPolicy | None -> PrecisionPolicy (None = f32): the
        ``--precision`` flag and ``config.yaml``'s ``model.precision``."""
        if value is None or value == "":
            return cls()
        if isinstance(value, cls):
            return value
        return cls(name=str(value))

    @property
    def compute_dtype(self) -> torch.dtype:
        """bfloat16 for ``bf16`` only: the int8 policies dequantize to
        float32 compute."""
        return torch.bfloat16 if self.name == "bf16" else torch.float32

    @property
    def quantize_weights(self) -> bool:
        return self.name in ("int8w", "int8")

    @property
    def quantize_acts(self) -> bool:
        return self.name == "int8"

    @property
    def wire_ingest_needed(self) -> bool:
        """True when the captured body must dequantize int8 wire inputs."""
        return self.name == "int8" and bool(self.act_scales)

    @property
    def map_budget(self) -> float:
        return MAP_BUDGETS[self.name]

    def scale_for(self, name: str) -> float | None:
        for k, s in self.act_scales:
            if k == name:
                return s
        return None

    def wire_dtype(self, name: str) -> torch.dtype:
        """The dtype a float32 wire input ``name`` is staged in on the card
        (:meth:`wire_cast`): bfloat16 under ``bf16``, int8 for a calibrated
        input under ``int8``, float32 otherwise and for keep-list inputs."""
        if name in self.keep_f32_inputs:
            return torch.float32
        if self.name == "bf16":
            return torch.bfloat16
        scale = self.scale_for(name)
        if self.name == "int8" and scale is not None and scale > 0:
            return torch.int8
        return torch.float32

    def cast_params(self, tree):
        """The parameter tree in the policy's storage, once at registration:
        ``bf16`` casts every float leaf (tensors to ``torch.bfloat16``,
        numpy arrays to :data:`BF16` words); ``int8w``/``int8`` quantize
        every float leaf of two or more dimensions into a
        :class:`QuantizedParam` over its last axis (a flax kernel's output
        channel), 1-D leaves (biases, BatchNorm) staying as they are; ``f32``
        is the identity. On a model, :func:`apply_cast_params`."""
        if self.name == "f32":
            return tree
        if self.name == "bf16":
            return tree_map(lambda x: _to_bf16(x) if _is_float(x) else x, tree)

        def quant(x):
            if _is_float(x) and len(getattr(x, "shape", ())) >= 2:
                return quantize_channelwise(x)
            return x

        return tree_map(quant, tree)

    def cast_in(self, x: torch.Tensor) -> torch.Tensor:
        """The pipeline's ingress cast of a staged wire input."""
        return x.to(self.compute_dtype)

    def boundary(self, tree):
        """The keep-list cast: model outputs re-enter float32 before the
        boundary ops (``KEEP_F32_2D``/``KEEP_F32_3D``)."""
        if self.name == "f32":
            return tree
        return tree_map(lambda x: _to_f32(x) if _is_float(x) else x, tree)

    def wire_cast(self, name: str, arr: np.ndarray) -> np.ndarray:
        """The host staging cast of one wire input. Never widens: ``bf16``
        narrows wider floats to :data:`BF16` words, ``int8`` quantizes a
        calibrated float input to int8 with its scale (the JAX package's
        expression, on the float32 array and the Python-float scale, so both
        packages give the same bytes); integer frames, words, keep-list
        inputs, uncalibrated inputs and every input under ``f32`` and
        ``int8w`` pass as they are."""
        if self.name in ("f32", "int8w") or name in self.keep_f32_inputs:
            return arr
        if is_bf16_words(arr) or not np.issubdtype(arr.dtype, np.floating):
            return arr
        if self.name == "bf16":
            if arr.dtype.itemsize > BF16.itemsize:
                return to_bf16_words(arr)
            return arr
        scale = self.scale_for(name)
        if scale is None or scale <= 0:
            return arr
        return np.clip(np.rint(arr / scale), -_QMAX, _QMAX).astype(np.int8)

    def ingest(self, inputs: dict) -> dict:
        """The device-side inverse of :meth:`wire_cast`, run inside the
        captured body: an int8 input with a scale becomes ``q * scale`` in
        float32 (the scale rounded to float32, as JAX's ``jnp.float32``);
        everything else, a float32 input of the same name included, passes
        through."""
        if not self.wire_ingest_needed:
            return inputs
        out = {}
        for k, v in inputs.items():
            scale = self.scale_for(k)
            if scale is not None and v.dtype == torch.int8:
                out[k] = v.float() * float(np.float32(scale))
            else:
                out[k] = v
        return out

    def calibrated(self, samples: dict) -> "PrecisionPolicy":
        """Per-input activation scales from sample inputs, at registration:
        ``max|x| / 127`` over the whole batch, 1.0 for an all-zero one.
        Only ``int8`` calibrates; keep-list and integer inputs are
        skipped."""
        if not self.quantize_acts:
            return self
        scales = dict(self.act_scales)
        for name, arr in samples.items():
            if name in self.keep_f32_inputs:
                continue
            a = np.asarray(arr)
            if not np.issubdtype(a.dtype, np.floating):
                continue  # integer frames already travel in a byte or less
            amax = float(np.max(np.abs(a))) if a.size else 0.0
            scales[name] = (amax / _QMAX) if amax > 0 else 1.0
        return dataclasses.replace(self, act_scales=tuple(sorted(scales.items())))

    def spec_extra(self, params, keep_ops=KEEP_F32_2D) -> dict:
        """The spec ``extra`` entries of a precision-aware builder: policy,
        keep-list and the bytes of ``params`` as stored."""
        return {
            "precision": self.name,
            "precision_keep_f32": list(keep_ops),
            "param_bytes": tree_bytes(params),
        }


# -- models -------------------------------------------------------------------------------


def stored_params(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """A model's parameters and running statistics as it stores them (its
    ``state_dict`` without BatchNorm's ``num_batches_tracked`` counters; a
    quantized weight is its ``q`` and ``scale``)."""
    return {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}


class Dequantize(torch.nn.Module):
    """The parametrization of an int8-stored weight: it keeps ``q`` (int8)
    and ``scale`` (float32, one per output channel along ``axis``) and
    returns ``q * scale`` in float32, rounded to ``dtype`` where the module
    computes in bfloat16 (flax casts the dequantized float32 kernel to the
    module's dtype the same way). It runs on every forward, inside any
    captured graph: no float32 copy of the weight is kept."""

    def __init__(self, axis: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.axis = axis
        self.dtype = dtype

    def forward(self, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        w = q.float() * scale
        return w if self.dtype == torch.float32 else w.to(self.dtype)

    def right_inverse(self, weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        qp = quantize_channelwise(weight, self.axis)
        return qp.q, qp.scale


def apply_cast_params(
    model: torch.nn.Module, policy: PrecisionPolicy, source=None
) -> torch.nn.Module:
    """Store ``model``'s tensors as ``policy`` gives them.

    ``bf16``: every float tensor in bfloat16 (the dtypes change in place of
    a copy into the old ones). ``int8w``/``int8``: every weight of two or
    more dimensions (the kernels of ``Linear``, ``Conv*`` and
    ``ConvTranspose*``: exactly the flax leaves the JAX policy quantizes;
    a buffer such as the anchors is no parameter; and SECOND's sparse
    ``(k^3, cin, cout)`` weights, whose module names the axis in
    ``weight_out_axis``) quantized over its output-channel axis behind a :class:`Dequantize` parametrization that
    yields the module's own compute dtype; every other float tensor stored
    in float32, as the JAX tree keeps its 1-D leaves. ``source``: the
    float32 state_dict the model was filled from, quantized in place of a
    bfloat16 body's rounded copy (the JAX package quantizes the float32
    tree)."""
    if policy.name == "bf16":
        model.load_state_dict(policy.cast_params(dict(model.state_dict())), assign=True)
    elif policy.quantize_weights:
        from torch.nn.utils import parametrize

        source = source or {}
        model.requires_grad_(False)
        for name, mod in list(model.named_modules()):
            w = mod._parameters.get("weight")
            if w is None or not w.is_floating_point() or w.ndim < 2:
                continue
            key = f"{name}.weight" if name else "weight"
            full = source.get(key, w).detach().to(device=w.device, dtype=torch.float32)
            mod.weight = torch.nn.Parameter(full, requires_grad=False)
            # the output channel: axis 1 of a transposed convolution's
            # (cin, cout, ...) weight, the last of a weight in the JAX layout
            # (SECOND's sparse (k^3, cin, cout)), 0 of the others'
            axis = getattr(mod, "weight_out_axis", None)
            if axis is None:
                axis = 1 if isinstance(mod, torch.nn.modules.conv._ConvTransposeNd) else 0
            # a bfloat16 module's parametrization yields bfloat16 from the
            # float32 it was registered over: "unsafe" is that dtype change
            parametrize.register_parametrization(
                mod, "weight", Dequantize(axis, w.dtype), unsafe=w.dtype != torch.float32)
        rest = {k: source.get(k, v).detach().to(device=v.device, dtype=torch.float32)
                for k, v in model.state_dict().items()
                if v.is_floating_point() and ".parametrizations." not in f".{k}"}
        model.load_state_dict(rest, strict=False, assign=True)
    return model
