"""Carry the JAX package's flax weights across to the port.

A flax variable tree (``params`` + ``batch_stats``, leaves as numpy
arrays or anything ``np.asarray`` takes) maps onto a model's
``state_dict`` by path; the kind of the receiving module decides how a
``kernel`` is laid out:

  * ``Dense`` kernel (in, out) -> ``Linear.weight`` (out, in)
  * ``Conv`` kernel (kh, kw, cin, cout) -> ``weight`` (cout, cin, kh, kw)
  * 3D ``Conv`` kernel (kd, kh, kw, cin, cout) -> ``Conv3d.weight``
    (cout, cin, kd, kh, kw)
  * ``ConvTranspose`` kernel (kh, kw, cin, cout) -> flipped in both
    spatial axes, then ``weight`` (cin, cout, kh, kw): flax's transposed
    convolution does not flip its kernel, PyTorch's does
  * a module with ``weight_out_axis = -1`` (SECOND's sparse stages, whose
    weight keeps the JAX layout (k^3, cin, cout)) takes its kernel as it is
  * BatchNorm ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
    ``running_mean``/``running_var``; conv and dense ``bias`` -> ``bias``

Conversion is strict: every leaf is used exactly once and every tensor
of the model is filled, with matching shapes, or it raises. Leaves are
read as float32 (bfloat16 ones widen exactly); the model's own dtypes
decide what they are stored as (``load_state_dict`` rounds to a bfloat16
body), and a precision policy runs after the fill
(``runtime/precision.apply_cast_params``: bfloat16, or int8 quantized
from the float32 leaves ``fill_model`` returns).
"""

from __future__ import annotations

import re
from typing import Callable, Mapping

import numpy as np
import torch
from torch import nn

from triton_client_tpu_torch.runtime.precision import bf16_words_to_f32, is_bf16_words

# (collection, leaf name) -> state_dict suffix
_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        path = (*prefix, str(key))
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _leaf_f32(leaf) -> np.ndarray:
    # bfloat16 leaves read from a flax msgpack arrive as BF16 words, which
    # np.asarray would cast as integers
    if is_bf16_words(leaf):
        return bf16_words_to_f32(leaf)
    return np.asarray(leaf, dtype=np.float32)


def _kernel_to_torch(module: nn.Module, arr: np.ndarray) -> np.ndarray:
    if getattr(module, "weight_out_axis", None) == -1:
        return arr
    if isinstance(module, nn.Linear):
        return arr.T
    if isinstance(module, nn.ConvTranspose2d):
        return arr[::-1, ::-1].transpose(2, 3, 0, 1).copy()
    if isinstance(module, nn.Conv3d):
        return arr.transpose(4, 3, 0, 1, 2)
    return arr.transpose(3, 2, 0, 1)


def state_dict_from_flax(
    variables: Mapping,
    model: nn.Module,
    module_path: Callable[[tuple[str, ...]], str] = ".".join,
) -> dict[str, torch.Tensor]:
    """flax ``{"params": ..., "batch_stats": ...}`` -> a ``state_dict``
    for ``model``; ``module_path`` maps a flax module path to the
    port's dotted submodule name."""
    want = model.state_dict()
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"unexpected flax collections {sorted(extra)}")
    out: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            suffix = _LEAF.get((collection, path[-1]))
            if suffix is None:
                raise KeyError(f"unexpected flax leaf {collection}/{'/'.join(path)}")
            mod_path = module_path(path[:-1])
            key = f"{mod_path}.{suffix}"
            if key not in want:
                raise KeyError(f"flax leaf {collection}/{'/'.join(path)} -> {key}: no such tensor")
            if key in out:
                raise KeyError(f"two flax leaves map onto {key}")
            arr = _leaf_f32(leaf)
            if path[-1] == "kernel":
                arr = _kernel_to_torch(model.get_submodule(mod_path), arr)
            if tuple(arr.shape) != tuple(want[key].shape):
                raise ValueError(
                    f"{key}: flax shape {arr.shape} != model shape {tuple(want[key].shape)}"
                )
            out[key] = torch.tensor(arr)  # a copy: the leaf may be read-only
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            out.setdefault(key, torch.zeros_like(value))
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"flax variables leave {len(missing)} tensors unfilled: {missing[:5]}")
    return out


def fill_model(
    model: nn.Module,
    variables: Mapping | None = None,
    state_dict=None,
    seed: int = 0,
    from_flax: Callable[[Mapping, nn.Module], dict] = state_dict_from_flax,
) -> dict[str, torch.Tensor] | None:
    """Fill a built model's tensors, in the builders' order of sources:
    a flax tree through ``from_flax``; else ``state_dict``, a state_dict in
    the model's own names and layout or a function of the model that
    returns one (the disk repository's importers, which read the model's
    shapes as their template); else seeded random weights.

    Returns the state_dict loaded, as read (float32 for a flax tree; None
    for seeded weights): what a precision policy quantizes in place of a
    bfloat16 body's rounded copy (``runtime/precision.apply_cast_params``),
    since the policy runs after the fill."""
    from triton_client_tpu_torch.models.layers import init_random_

    if variables is not None:
        loaded = from_flax(variables, model)
    elif state_dict is not None:
        if callable(state_dict):
            state_dict = state_dict(model)
        loaded = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    else:
        init_random_(model, seed)
        return None
    model.load_state_dict(loaded)
    return loaded


def _yolov5_module_path(names: tuple[str, ...]) -> str:
    # flax names a C3's bottlenecks m0, m1, ...; the port keeps them in
    # an nn.Sequential called m
    return ".".join(re.sub(r"^m(\d+)$", r"m.\1", n) for n in names)


def yolov5_state_dict_from_flax(variables: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """The JAX ``YoloV5`` tree -> a ``state_dict`` for the port's
    ``YoloV5`` of the same variant and classes."""
    return state_dict_from_flax(variables, model, _yolov5_module_path)


def pointpillars_state_dict_from_flax(
    variables: Mapping, model: nn.Module
) -> dict[str, torch.Tensor]:
    """The JAX ``PointPillars`` tree (``init_pointpillars``: ``vfe/linear``,
    ``vfe/bn``, ``backbone/block{i}_down[_bn]``, ``block{i}_conv{j}``/
    ``block{i}_bn{j}``, ``up{i}[_bn]``, ``cls_head``, ``box_head``,
    ``dir_head``) -> a ``state_dict`` for the port's ``PointPillars`` of
    the same config; the submodules carry the flax names."""
    return state_dict_from_flax(variables, model)


def second_state_dict_from_flax(variables: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """The JAX ``SECONDIoU`` tree (``init_second``: ``middle/conv{i}`` 3D
    kernels, ``middle/bn{i}``, ``backbone/...`` as PointPillars',
    ``cls_head``, ``box_head``, ``dir_head``, ``iou_head``; the mean VFE has
    no parameters) -> a ``state_dict`` for the port's ``SECONDIoU`` of the
    same config; the submodules carry the flax names. The sparse middle's
    stages hold a bare ``params/middle/conv{i}`` leaf (k^3, cin, cout),
    which lands on ``middle.conv{i}.weight`` as it is; its dense-tail
    stages' ``conv{i}/kernel`` are 3D kernels as the dense middle's."""
    params = dict(variables.get("params", {}))
    middle = dict(params.get("middle", {}))
    for name in [k for k in middle if re.fullmatch(r"conv\d+", str(k))]:
        if not isinstance(middle[name], Mapping):
            middle[name] = {"kernel": middle[name]}  # a leaf -> the module holding it
    if middle:
        params["middle"] = middle
    return state_dict_from_flax({**variables, "params": params}, model)


def centerpoint_state_dict_from_flax(
    variables: Mapping, model: nn.Module
) -> dict[str, torch.Tensor]:
    """The JAX ``CenterPoint`` tree (``init_centerpoint``: ``vfe/linear``,
    ``vfe/bn``, ``backbone/...`` as PointPillars', ``head/shared``,
    ``head/shared_bn`` and the 1x1 branches ``head/heatmap``, ``offset``,
    ``height``, ``size``, ``rot``, ``vel``) -> a ``state_dict`` for the
    port's ``CenterPoint`` of the same config; the submodules carry the
    flax names."""
    return state_dict_from_flax(variables, model)


def retinanet_state_dict_from_flax(variables: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """The JAX ``RetinaNet`` tree (``backbone/stem``, ``backbone/s{i}b{j}/
    c1..c3|down``, ``backbone/lat3..5``, ``out3..5``, ``p6``, ``p7``,
    ``head/cls{i}``, ``box{i}``, ``cls_out``, ``box_out``) -> a
    ``state_dict`` for the port's ``RetinaNet`` of the same depth and
    classes; the submodules carry the flax names."""
    return state_dict_from_flax(variables, model)


def fcos_state_dict_from_flax(variables: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """The JAX ``FCOS`` tree -> a ``state_dict`` for the port's ``FCOS``.
    The tree is RetinaNet's with ``head/reg{i}``, ``reg_out``, ``ctr_out``
    and one bare ``(1,)`` leaf a level, ``params/head/scale{l}``, which
    lands on the port's ``head.scale{l}.weight``."""
    params = dict(variables.get("params", {}))
    head = dict(params.get("head", {}))
    for name in [k for k in head if re.fullmatch(r"scale\d+", str(k))]:
        head[name] = {"scale": head[name]}  # a leaf -> the module holding it
    params["head"] = head
    return state_dict_from_flax({**variables, "params": params}, model)


def yolov4_state_dict_from_flax(variables: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """The JAX ``YoloV4`` tree (``stem``, ``stage{k}/down|split_main|
    split_short|res{i}_cv{1,2}|post|merge``, ``spp/merge``, ``pre_spp*``,
    ``post_spp*``, ``td4_*``, ``td3_*``, ``bu4_*``, ``bu5_*``,
    ``head{i}_cv``, ``detect{i}``) -> a ``state_dict`` for the port's
    ``YoloV4`` of the same width and classes; the submodules carry the flax
    names."""
    return state_dict_from_flax(variables, model)
