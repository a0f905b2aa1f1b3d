"""Upstream checkpoints onto the port's models (port of
``runtime/importers.py``: YOLOv5, PointPillars, SECOND-IoU, CenterPoint).

Each importer maps the published checkpoint naming (ultralytics YOLOv5
``model.N.*``; OpenPCDet PointPillars and SECOND ``vfe.pfn_layers``/
``backbone_3d``/``backbone_2d.blocks``/``dense_head.*``; det3d CenterPoint
``reader.pfn_layers``/``neck.blocks``/``bbox_head.*``; an ONNX export's
initializers, read by ``runtime/onnx_reader``) onto the port's
``state_dict`` names, through ``runtime/checkpoint.convert_state_dict``.
Both sides are PyTorch layouts, so the JAX importer's transposes vanish
(the ``ConvTranspose2d`` deblocks and SECOND's ``Conv3d`` stages copy as
they are). What remains is det3d's shared-conv bias, folded exactly into
the BatchNorm mean (:func:`load_centerpoint`), and YOLOv5's layout of
``examples/yolov5_crop``, imported exactly from the plain upstream
weights:

- the ``s2d`` stem: the 6x6 stride-2 kernel (out, 3, 6, 6) reshaped to
  the 3x3 stride-1 kernel (out, 12, 3, 3) over the space-to-depth input
  (:func:`stem_s2d_kernel`);
- ``ch_floor``: the stem's widened output rows and ``down2``'s widened
  input columns filled with zero kernels and neutral BatchNorm rows
  (scale and variance 1, bias and mean 0), so the padded channels are
  exactly zero through SiLU (:func:`embed_padded`).

Any other shape mismatch (wrong classes or variant, a ``ch_floor`` that
pads a stage feeding a concat) raises, as in the JAX package.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import torch

from triton_client_tpu_torch.runtime.checkpoint import convert_state_dict, load_torch_checkpoint

# The port's YOLOv5 module -> the ultralytics layer index ("model.N"); the
# layout of models/yolov5n.yaml, fixed across variants n/s/m/l/x: backbone
# 0-9, head 10-23, Detect 24 (11/15 Upsample, 12/16/19/22 Concat).
_YOLOV5_LAYER_IDX = {
    "stem": 0, "down2": 1, "c3_2": 2, "down3": 3, "c3_3": 4, "down4": 5, "c3_4": 6,
    "down5": 7, "c3_5": 8, "sppf": 9, "lat5": 10, "c3_up4": 13, "lat4": 14, "c3_up3": 17,
    "pan3": 18, "c3_pan4": 20, "pan4": 21, "c3_pan5": 23,
}


def yolov5_torch_key(key: str) -> str:
    """Port key -> ultralytics key: ``c3_3.m.0.cv1.conv.weight`` ->
    ``model.4.m.0.cv1.conv.weight``; ``detect1.weight`` ->
    ``model.24.m.1.weight``."""
    head, rest = key.split(".", 1)
    if head.startswith("detect"):
        return f"model.24.m.{head[len('detect'):]}.{rest}"
    return f"model.{_YOLOV5_LAYER_IDX[head]}.{rest}"


def stem_s2d_kernel(natural: torch.Tensor) -> torch.Tensor:
    """The plain (out, cin, 6, 6) stride-2 stem kernel -> the equivalent
    (out, 4*cin, 3, 3) kernel of the space-to-depth stem. Kernel row
    ky = 2*bi + a reads block row bi at within-block row a (columns alike),
    and the blocked channel is (a*2 + b)*cin + c: the order of the forward's
    NHWC reshape (``models/yolov5.py``)."""
    out, cin, kh, kw = natural.shape
    if (kh, kw) != (6, 6):
        raise ValueError(f"s2d stem expects a 6x6 source kernel, got {tuple(natural.shape)}")
    w = natural.reshape(out, cin, 3, 2, 3, 2)  # (o, c, bi, a, bj, b)
    w = w.permute(0, 3, 5, 1, 2, 4)  # (o, a, b, c, bi, bj)
    return w.reshape(out, 4 * cin, 3, 3).contiguous()


def _neutral_fill(key: str) -> float:
    # BatchNorm scale and variance pad with 1, everything else with 0
    return 1.0 if key.endswith(("bn.weight", "running_var")) else 0.0


def embed_padded(natural: torch.Tensor, target_shape, key: str) -> torch.Tensor:
    """Zero/neutral-pad a plain tensor into a ``ch_floor``-widened shape:
    zero kernel rows and columns, BatchNorm rows that normalise to 0, so
    the padded channels stay exactly zero (SiLU(0) = 0) into the next
    layer's zero input columns."""
    target_shape = tuple(target_shape)
    if tuple(natural.shape) == target_shape:
        return natural
    if natural.ndim != len(target_shape) or any(
        n > t for n, t in zip(natural.shape, target_shape)
    ):
        raise ValueError(f"cannot embed {key} {tuple(natural.shape)} into {target_shape}")
    out = torch.full(target_shape, _neutral_fill(key), dtype=natural.dtype)
    out[tuple(slice(0, s) for s in natural.shape)] = natural
    return out


def load_yolov5(path_or_state: Any, model: torch.nn.Module) -> dict:
    """An ultralytics YOLOv5 checkpoint (a ``.pt`` path or a state_dict) ->
    a ``state_dict`` for the port's ``model`` (any layout: the s2d stem and
    a stem-only ``ch_floor``, e.g. 32 on variant n, import exactly; see the
    module docstring). Raises on any other mismatch."""
    state = _strip_prefix(_as_state_dict(path_or_state), "model.model.", "model.")

    def transform(key: str, nat: torch.Tensor, target: tuple) -> torch.Tensor:
        if key.startswith("stem."):
            if key == "stem.conv.weight" and nat.shape[2:] == (6, 6) and target[2:] == (3, 3):
                nat = stem_s2d_kernel(nat)
            # only the out-channel axis may grow (ch_floor): a spatial or
            # input mismatch (a grayscale fork's 1-channel stem) is another
            # model
            if tuple(nat.shape[1:]) == target[1:] and nat.shape[0] <= target[0]:
                return embed_padded(nat, target, key)
        if (
            key == "down2.conv.weight"
            and nat.shape[0] == target[0]
            and tuple(nat.shape[2:]) == target[2:]
            and nat.shape[1] < target[1]
        ):
            # the extra input columns read the stem's padded (zero) channels
            return embed_padded(nat, target, key)
        raise ValueError(
            f"yolov5 import: {key} {tuple(nat.shape)} does not fit the template {target}. "
            "Only stem-local adaptations (s2d; a ch_floor that pads the stem stage alone, "
            "e.g. 32 on variant n) preserve the function; this mismatch means wrong "
            "num_classes/variant, or a ch_floor that pads concatenated stages (segment "
            "layouts would silently shift)"
        )

    return convert_state_dict(state, model.state_dict(), yolov5_torch_key,
                              leaf_transform=transform)


# --- PointPillars and SECOND (OpenPCDet naming) ----------------------------------

_BLOCK_DOWN = re.compile(r"^block(\d+)_down(_bn)?$")
_BLOCK_CONV = re.compile(r"^block(\d+)_(conv|bn)(\d+)$")
_UP = re.compile(r"^up(\d+)(_bn)?$")
_HEADS = {
    "cls_head": "dense_head.conv_cls",
    "box_head": "dense_head.conv_box",
    "dir_head": "dense_head.conv_dir_cls",
    # SECOND-IoU's per-anchor IoU-quality conv, under OpenPCDet's conv-head
    # naming (the JAX package's dense design of the reference's IoU branch)
    "iou_head": "dense_head.conv_iou",
}


def _bev_backbone_key(name: str, leaf: str, prefix: str = "backbone_2d") -> str | None:
    """A BEV backbone module -> ``<prefix>.blocks/deblocks...`` (OpenPCDet's
    ``backbone_2d``, det3d's ``neck``): each block is Sequential(ZeroPad2d,
    Conv2d, BN, ReLU, [Conv2d, BN, ReLU] * L) (down conv at 1, its BN at
    2, layer li at 4+3*li / 5+3*li) and each deblock Sequential(
    ConvTranspose2d, BN, ReLU)."""
    m = _BLOCK_DOWN.match(name)
    if m:
        return f"{prefix}.blocks.{m.group(1)}.{2 if m.group(2) else 1}.{leaf}"
    m = _BLOCK_CONV.match(name)
    if m:
        li = int(m.group(3))
        idx = 4 + 3 * li if m.group(2) == "conv" else 5 + 3 * li
        return f"{prefix}.blocks.{m.group(1)}.{idx}.{leaf}"
    m = _UP.match(name)
    if m:
        return f"{prefix}.deblocks.{m.group(1)}.{1 if m.group(2) else 0}.{leaf}"
    return None


def _head_or_backbone_key(head: str, rest: str, key: str, family: str) -> str:
    if head in _HEADS:
        return f"{_HEADS[head]}.{rest}"
    if head == "backbone":
        name, leaf = rest.split(".", 1)
        mapped = _bev_backbone_key(name, leaf)
        if mapped:
            return mapped
    raise KeyError(f"unmapped {family} key: {key}")


def pointpillars_torch_key(key: str) -> str:
    """Port key -> OpenPCDet key (PillarVFE keeps one PFNLayer, its BN named
    ``norm``)."""
    head, rest = key.split(".", 1)
    if head == "vfe":
        sub, leaf = rest.split(".", 1)
        return f"vfe.pfn_layers.0.{'linear' if sub == 'linear' else 'norm'}.{leaf}"
    return _head_or_backbone_key(head, rest, key, "PointPillars")


def load_pointpillars(path_or_state: Any, model: torch.nn.Module) -> dict:
    """An OpenPCDet PointPillars checkpoint -> a ``state_dict`` for the
    port's ``model``."""
    return convert_state_dict(_as_state_dict(path_or_state), model.state_dict(),
                              pointpillars_torch_key)


_MIDDLE = re.compile(r"^(conv|bn)(\d+)$")


def second_torch_key(key: str) -> str:
    """Port key -> OpenPCDet key. The middle's stage i (Conv3d, BN) sits
    at ``backbone_3d.conv{i}.0`` / ``.1``, spconv's SparseSequential
    indexing; MeanVFE has no parameters."""
    head, rest = key.split(".", 1)
    if head == "middle":
        name, leaf = rest.split(".", 1)
        m = _MIDDLE.match(name)
        if m:
            return f"backbone_3d.conv{m.group(2)}.{0 if m.group(1) == 'conv' else 1}.{leaf}"
    return _head_or_backbone_key(head, rest, key, "SECOND")


def load_second(path_or_state: Any, model: torch.nn.Module) -> dict:
    """An OpenPCDet-named SECOND(-IoU) checkpoint -> a ``state_dict`` for the
    port's ``model`` (the dense middle: ``Conv3d`` kernels copy as they
    are)."""
    return convert_state_dict(_as_state_dict(path_or_state), model.state_dict(),
                              second_torch_key)


# --- CenterPoint (det3d naming, data/nusc_centerpoint_pp_02voxel_...py) ------------

# the port's head branch -> det3d's SepHead task branch
_CP_BRANCH = {"heatmap": "hm", "offset": "reg", "height": "height", "size": "dim",
              "rot": "rot", "vel": "vel"}
_CP_SHARED_BIAS = "bbox_head.shared_conv.0.bias"
_CP_SHARED_MEAN = "bbox_head.shared_conv.1.running_mean"


def centerpoint_torch_key(key: str) -> str:
    """Port key -> det3d key. det3d names the pillar CenterPoint's trunk
    ``reader`` (the PillarFeatureNet), ``neck`` (the RPN, laid out as
    OpenPCDet's BEV backbone) and ``bbox_head`` (``shared_conv``
    Sequential(Conv2d, BN, ReLU), then per-task branches); the port's head
    is one task, so its branches sit at ``bbox_head.tasks.0.<name>.0``."""
    head, rest = key.split(".", 1)
    name, leaf = rest.split(".", 1)
    if head == "vfe":
        return f"reader.pfn_layers.0.{'linear' if name == 'linear' else 'norm'}.{leaf}"
    if head == "backbone":
        mapped = _bev_backbone_key(name, leaf, "neck")
        if mapped:
            return mapped
    if head == "head":
        if name == "shared":
            return f"bbox_head.shared_conv.0.{leaf}"
        if name == "shared_bn":
            return f"bbox_head.shared_conv.1.{leaf}"
        if name in _CP_BRANCH:
            return f"bbox_head.tasks.0.{_CP_BRANCH[name]}.0.{leaf}"
    raise KeyError(f"unmapped CenterPoint key: {key}")


def load_centerpoint(path_or_state: Any, model: torch.nn.Module) -> dict:
    """A det3d-named CenterPoint checkpoint -> a ``state_dict`` for the
    port's ``model``. det3d's shared conv has a bias and the port's, as
    the JAX package's, has none (BatchNorm consumes it): the bias folds
    exactly into the BN running mean, BN((conv + b) - m) = BN(conv -
    (m - b)), so the forward is unchanged. A bias without a mean raises."""
    state = dict(_as_state_dict(path_or_state))
    if _CP_SHARED_BIAS in state:
        if _CP_SHARED_MEAN not in state:
            raise KeyError(f"{_CP_SHARED_BIAS} present but {_CP_SHARED_MEAN} missing: cannot "
                           "fold the shared-conv bias into BN")
        bias = state.pop(_CP_SHARED_BIAS)
        state[_CP_SHARED_MEAN] = torch.as_tensor(state[_CP_SHARED_MEAN]) - torch.as_tensor(bias)
    return convert_state_dict(state, model.state_dict(), centerpoint_torch_key)


def _as_state_dict(path_or_state: Any) -> Mapping[str, Any]:
    if isinstance(path_or_state, Mapping):
        return path_or_state
    return load_torch_checkpoint(path_or_state)


def _strip_prefix(state: Mapping[str, Any], *prefixes: str) -> dict:
    """Keys with the first matching prefix replaced by the canonical
    ``model.`` (ultralytics wraps the detection model once or twice,
    depending on the export path)."""
    out = dict(state)
    for prefix in prefixes:
        if any(k.startswith(prefix) for k in out):
            return {("model." + k[len(prefix):] if k.startswith(prefix) else k): v
                    for k, v in out.items()}
    return out


# family -> importer(state_dict or path, model) for .pt/.pth/.onnx artifacts
IMPORTERS = {
    "yolov5": load_yolov5,
    "pointpillars": load_pointpillars,
    "second_iou": load_second,
    "centerpoint": load_centerpoint,
}
