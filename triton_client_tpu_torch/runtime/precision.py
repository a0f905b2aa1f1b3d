"""Per-model serving precision policies (port of ``runtime/precision.py``):
``f32`` and ``bf16``; ``int8w`` and ``int8`` parse and raise.

  * ``f32``  — the plain path, unchanged.
  * ``bf16`` — parameters stored as bfloat16 (:meth:`PrecisionPolicy.
    cast_params`), the pipeline body computing in bfloat16
    (:meth:`~PrecisionPolicy.cast_in`), float wire inputs narrowed to
    bfloat16 words on the host before staging (:meth:`~PrecisionPolicy.
    wire_cast`: half the host-to-device bytes, never a widening).

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

INT8_ITEM = "10 (the int8w and int8 precision policies)"


def not_ported_policy(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"precision policy {name!r} is not ported yet (ROADMAP.md Queue 1 item {INT8_ITEM})"
    )


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
    """Bytes of every tensor or array leaf of ``tree``: what ``param_bytes``
    reports."""
    total = 0

    def add(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (np.ndarray, np.generic)):
            total += int(x.nbytes)
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
    examples' spelling, keeps the f32 policy and its float32 wire).
    Returns ``(policy, model_dtype)``."""
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
    """One model's serving precision (see the module docstring)."""

    name: str = "f32"

    def __post_init__(self) -> None:
        if self.name not in POLICIES:
            raise ValueError(
                f"unknown precision policy {self.name!r} (expected one of {'|'.join(POLICIES)})"
            )
        if self.name in ("int8w", "int8"):
            raise not_ported_policy(self.name)

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
        return torch.bfloat16 if self.name == "bf16" else torch.float32

    @property
    def wire_dtype(self) -> torch.dtype:
        """The dtype a float32 wire input is staged in on the card."""
        return torch.bfloat16 if self.name == "bf16" else torch.float32

    @property
    def map_budget(self) -> float:
        return MAP_BUDGETS[self.name]

    def cast_params(self, tree):
        """The parameter tree in the policy's storage, once at registration:
        ``bf16`` casts every float leaf (tensors to ``torch.bfloat16``,
        numpy arrays to :data:`BF16` words); ``f32`` is the identity."""
        if self.name == "f32":
            return tree
        return tree_map(lambda x: _to_bf16(x) if _is_float(x) else x, tree)

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
        narrows wider floats to :data:`BF16` words; integer frames, words
        and every input under ``f32`` pass as they are. (The JAX policy's
        ``keep_f32_inputs`` exempts the 3D ``points``; the port serves no 3D
        entry in bf16, ROADMAP.md Queue 1 item 11.)"""
        if self.name == "f32":
            return arr
        if is_bf16_words(arr) or not np.issubdtype(arr.dtype, np.floating):
            return arr
        if arr.dtype.itemsize > BF16.itemsize:
            return to_bf16_words(arr)
        return arr

    def spec_extra(self, params, keep_ops=KEEP_F32_2D) -> dict:
        """The spec ``extra`` entries of a precision-aware builder: policy,
        keep-list and the bytes of ``params`` as stored."""
        return {
            "precision": self.name,
            "precision_keep_f32": list(keep_ops),
            "param_bytes": tree_bytes(params),
        }


def stored_params(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """A model's parameters and running statistics as it stores them (its
    ``state_dict`` without BatchNorm's ``num_batches_tracked`` counters)."""
    return {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}


def apply_cast_params(model: torch.nn.Module, policy: PrecisionPolicy) -> torch.nn.Module:
    """Store ``model``'s tensors as ``policy.cast_params`` gives them (the
    dtypes change in place of a copy into the old ones)."""
    if policy.name != "f32":
        model.load_state_dict(policy.cast_params(dict(model.state_dict())), assign=True)
    return model
