"""Upstream checkpoints onto the port's models (the parts of
``runtime/checkpoint.py`` the importers use; the JAX package's orbax
checkpoint manager is not ported).

The port's models already hold PyTorch's layouts (OIHW convolutions,
(out, in) linear layers, (in, out, kh, kw) transposed convolutions,
OIDHW 3D convolutions), so an upstream ``state_dict`` carries across by
name: :func:`convert_state_dict` walks the model's own ``state_dict`` (the
template), looks each tensor up in the upstream one through a name map and
checks its shape. It is strict: every tensor of the template is filled
once, from a source key no other tensor takes, or it raises.
"""

from __future__ import annotations

import logging
import pathlib
from typing import Any, Callable, Mapping

import numpy as np
import torch

from triton_client_tpu_torch.runtime.precision import host_tensor

log = logging.getLogger(__name__)


def as_tensor(value) -> torch.Tensor:
    """A checkpoint value as a CPU tensor (numpy arrays, ``config.BF16``
    words and tensors alike)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return host_tensor(np.array(value))  # a writable copy, 0-d kept


def load_torch_checkpoint(path: str | pathlib.Path) -> dict[str, torch.Tensor]:
    """A ``.pt``/``.pth`` file's state_dict, unwrapped from the
    ``{"state_dict": ...}``, ``{"model_state": ...}`` and ``{"model": ...}``
    wrappers OpenPCDet and ultralytics use. Loaded with
    ``weights_only=True``: tensors and plain containers only, no pickled
    code (a file that pickles a whole ``nn.Module`` is refused; save its
    ``state_dict()``)."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model_state", "model"):
        if isinstance(raw, dict) and key in raw and isinstance(raw[key], dict):
            raw = raw[key]
            break
    return {k: as_tensor(v) for k, v in raw.items() if hasattr(v, "shape")}


def convert_state_dict(
    state_dict: Mapping[str, Any],
    template: Mapping[str, torch.Tensor],
    name_map: Callable[[str], str],
    leaf_transform: Callable[[str, torch.Tensor, tuple], torch.Tensor] | None = None,
) -> dict[str, torch.Tensor]:
    """An upstream ``state_dict`` -> a ``state_dict`` with ``template``'s
    names and shapes (``template``: the receiving model's own).

    ``name_map`` maps a template key to its upstream key. Without
    ``leaf_transform`` a shape mismatch raises; with it,
    ``leaf_transform(key, value, target_shape)`` adapts the value or
    raises. BatchNorm's ``num_batches_tracked`` counters are not weights:
    they come back as the template's. A missing upstream key raises
    ``KeyError``."""
    out: dict[str, torch.Tensor] = {}
    missing: list[str] = []
    taken: dict[str, str] = {}
    for key, like in template.items():
        if key.endswith("num_batches_tracked"):
            out[key] = like.detach().clone()
            continue
        src = name_map(key)
        if src not in state_dict:
            missing.append(src)
            continue
        if src in taken:
            raise KeyError(f"{src} would fill both {taken[src]} and {key}")
        taken[src] = key
        value = as_tensor(state_dict[src])
        target = tuple(like.shape)
        if tuple(value.shape) != target:
            if leaf_transform is None:
                raise ValueError(
                    f"cannot map torch tensor '{src}' {tuple(value.shape)} onto '{key}' {target}"
                )
            value = leaf_transform(key, value, target)
            if tuple(value.shape) != target:
                raise ValueError(f"{key}: adapted to {tuple(value.shape)}, want {target}")
        out[key] = value
    if missing:
        raise KeyError(f"{len(missing)} torch keys missing (e.g. {missing[:5]})")
    unused = set(state_dict) - set(taken)
    if unused:
        log.info("%d torch keys unused (e.g. %s)", len(unused), sorted(unused)[:5])
    return out
