"""Carry the JAX package's YOLOv5 weights across to the port.

``yolov5_state_dict_from_flax`` maps a flax variable tree (``params`` +
``batch_stats``, leaves as numpy arrays or anything ``np.asarray``
takes) onto ``YoloV5``'s ``state_dict``:

  * conv ``kernel`` (kh, kw, cin, cout) -> ``weight`` (cout, cin, kh, kw)
  * BatchNorm ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
    ``running_mean``/``running_var``
  * detect conv ``bias`` -> ``bias``

It is strict: every leaf is used exactly once and every tensor of the
model is filled, with matching shapes, or it raises.
"""

from __future__ import annotations

import re
from typing import Mapping

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


def _module_path(names: tuple[str, ...]) -> str:
    # flax names a C3's bottlenecks m0, m1, ...; the port keeps them in
    # an nn.Sequential called m
    return ".".join(re.sub(r"^m(\d+)$", r"m.\1", n) for n in names)


def yolov5_state_dict_from_flax(variables: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """flax ``{"params": ..., "batch_stats": ...}`` -> a ``state_dict``
    for ``model`` (a ``YoloV5`` of the same variant and classes)."""
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
            key = f"{_module_path(path[:-1])}.{suffix}"
            arr = np.asarray(leaf, dtype=np.float32)
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
            if key not in want:
                raise KeyError(f"flax leaf {collection}/{'/'.join(path)} -> {key}: no such tensor")
            if key in out:
                raise KeyError(f"two flax leaves map onto {key}")
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
