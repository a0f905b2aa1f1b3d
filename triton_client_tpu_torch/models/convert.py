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
  * BatchNorm ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
    ``running_mean``/``running_var``; conv and dense ``bias`` -> ``bias``

Conversion is strict: every leaf is used exactly once and every tensor
of the model is filled, with matching shapes, or it raises.
"""

from __future__ import annotations

import re
from typing import Callable, Mapping

import numpy as np
import torch
from torch import nn

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


def _kernel_to_torch(module: nn.Module, arr: np.ndarray) -> np.ndarray:
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
            arr = np.asarray(leaf, dtype=np.float32)
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
    """The JAX ``SECONDIoU`` tree with the dense middle (``init_second``:
    ``middle/conv{i}`` 3D kernels, ``middle/bn{i}``, ``backbone/...`` as
    PointPillars', ``cls_head``, ``box_head``, ``dir_head``, ``iou_head``;
    the mean VFE has no parameters) -> a ``state_dict`` for the port's
    ``SECONDIoU`` of the same config; the submodules carry the flax names."""
    return state_dict_from_flax(variables, model)
