"""Upstream checkpoints onto the port's models (port of
``runtime/importers.py``: YOLOv5, PointPillars, SECOND-IoU, CenterPoint,
RetinaNet, FCOS, YOLOv4).

Each importer maps the published checkpoint naming (ultralytics YOLOv5
``model.N.*``; OpenPCDet PointPillars and SECOND ``vfe.pfn_layers``/
``backbone_3d``/``backbone_2d.blocks``/``dense_head.*``; det3d CenterPoint
``reader.pfn_layers``/``neck.blocks``/``bbox_head.*``; detectron2
RetinaNet/FCOS ``backbone.bottom_up.res{2-5}``/``fpn_lateral``/
``head.cls_subnet``; pytorch-YOLOv4 ``down1-5``/``neek``/``head``; an ONNX
export's initializers, read by ``runtime/onnx_reader``) onto the port's
``state_dict`` names, through ``runtime/checkpoint.convert_state_dict``.
Both sides are PyTorch layouts, so the JAX importer's transposes vanish
(the ``ConvTranspose2d`` deblocks and SECOND's ``Conv3d`` stages copy as
they are). What remains is det3d's shared-conv bias, folded exactly into
the BatchNorm mean (:func:`load_centerpoint`), FCOS's missing per-level
scales (:func:`load_fcos`), the block order of YOLOv4's SPP merge conv
(:func:`load_yolov4`), and YOLOv5's layout of ``examples/yolov5_crop``,
imported exactly from the plain upstream weights:

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

from triton_client_tpu_torch.runtime.checkpoint import (
    as_tensor,
    convert_state_dict,
    load_torch_checkpoint,
)

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
    """Port key -> OpenPCDet key. The middle's stage i (its conv, dense or
    sparse, and its BN) sits at ``backbone_3d.conv{i}.0`` / ``.1``,
    spconv's SparseSequential indexing; MeanVFE has no parameters."""
    head, rest = key.split(".", 1)
    if head == "middle":
        name, leaf = rest.split(".", 1)
        m = _MIDDLE.match(name)
        if m:
            return f"backbone_3d.conv{m.group(2)}.{0 if m.group(1) == 'conv' else 1}.{leaf}"
    return _head_or_backbone_key(head, rest, key, "SECOND")


def sparse_weight_from_conv3d(key: str, natural: torch.Tensor, target: tuple) -> torch.Tensor:
    """An OpenPCDet ``Conv3d`` kernel (out, in, kd, kh, kw) -> the sparse
    middle's (k^3, in, out) gather weight: (kd, kh, kw, in, out), reshaped
    row-major, the order of ``ops/sparse_conv.kernel_offsets``. A 2^3
    stride stage has no 3^3 source and raises, as any other mismatch."""
    if natural.ndim == 5 and len(target) == 3:
        w = natural.permute(2, 3, 4, 1, 0)
        k3 = w.shape[0] * w.shape[1] * w.shape[2]
        if (k3, *w.shape[3:]) == tuple(target):
            return w.reshape(target).contiguous()
        raise ValueError(
            f"sparse middle stage {key} expects {tuple(target)}; the checkpoint's "
            f"{tuple(natural.shape)} kernel does not reshape to it: stride_kernel=2 stages "
            "have no upstream 3^3 source; import into a dense-middle template or serve "
            "with sparse_stride_kernel=3")
    raise ValueError(f"cannot map torch tensor {tuple(natural.shape)} onto '{key}' "
                     f"{tuple(target)} (wrong grid, filters or classes?)")


def load_second(path_or_state: Any, model: torch.nn.Module) -> dict:
    """An OpenPCDet-named SECOND(-IoU) checkpoint -> a ``state_dict`` for the
    port's ``model``, with either middle encoder: the dense middle's (and a
    sparse middle's dense-tail) ``Conv3d`` kernels copy as they are, the
    sparse stages' (k^3, in, out) weights are the row-major reshape of the
    same 3^3 kernels (:func:`sparse_weight_from_conv3d`), so one checkpoint
    serves both encoders."""
    return convert_state_dict(_as_state_dict(path_or_state), model.state_dict(),
                              second_torch_key, leaf_transform=sparse_weight_from_conv3d)


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


# --- RetinaNet / FCOS (detectron2 naming, the reference's libtorch export
#     lineage: examples/RetinaNet_detectron/config.pbtxt) ---------------------

_D2_BLOCK = re.compile(r"^s(\d+)b(\d+)$")
_D2_CONV = {"c1": "conv1", "c2": "conv2", "c3": "conv3", "down": "shortcut"}
_D2_LAT = re.compile(r"^lat(\d)$")
_D2_OUT = re.compile(r"^out(\d)$")
_D2_SUBNET = re.compile(r"^(cls|box|reg)(\d+)$")
_D2_SCALE = re.compile(r"^scale(\d+)$")
_D2_OUTPUTS = {"cls_out": "cls_score", "box_out": "bbox_pred", "reg_out": "bbox_pred",
               "ctr_out": "ctrness"}


def _d2_norm(base: str, sub: str, leaf: str) -> str:
    # a _ConvBnRelu's conv is the detectron2 conv, its bn the conv's .norm
    return f"{base}.{leaf}" if sub == "conv" else f"{base}.norm.{leaf}"


def detectron_torch_key(key: str) -> str:
    """Port key -> detectron2 key: ``backbone.bottom_up.stem.conv1`` and
    ``res{2-5}.{i}.conv{1-3}``/``.shortcut`` (norms as ``.norm``
    children), ``backbone.fpn_lateral{l}``/``fpn_output{l}``/
    ``top_block.p6|p7``, ``head.cls_subnet.{2i}``/``bbox_subnet.{2i}`` (ReLU
    at the odd indices), ``head.cls_score``/``bbox_pred``/``ctrness``, and
    AdelaiDet's ``head.scales.{l}.scale``. The residual stride is on
    conv2 (torchvision's layout; caffe-style checkpoints put it on conv1,
    which no key reveals, and are out of contract, as in the JAX
    package)."""
    head, name, rest = (key.split(".", 2) + [""])[:3]
    if head == "backbone":
        if name == "stem":
            sub, leaf = rest.split(".", 1)
            return _d2_norm("backbone.bottom_up.stem.conv1", sub, leaf)
        m = _D2_BLOCK.match(name)
        if m:
            conv, sub, leaf = rest.split(".", 2)
            base = f"backbone.bottom_up.res{int(m.group(1)) + 2}.{m.group(2)}.{_D2_CONV[conv]}"
            return _d2_norm(base, sub, leaf)
        m = _D2_LAT.match(name) or _D2_OUT.match(name)
        if m:
            kind = "lateral" if name.startswith("lat") else "output"
            return f"backbone.fpn_{kind}{m.group(1)}.{rest}"
        if name in ("p6", "p7"):
            return f"backbone.top_block.{name}.{rest}"
    if head == "head":
        m = _D2_SCALE.match(name)
        if m:
            return f"head.scales.{m.group(1)}.scale"
        m = _D2_SUBNET.match(name)
        if m:
            sub = "cls_subnet" if m.group(1) == "cls" else "bbox_subnet"
            return f"head.{sub}.{2 * int(m.group(2))}.{rest}"
        if name in _D2_OUTPUTS:
            return f"head.{_D2_OUTPUTS[name]}.{rest}"
    raise KeyError(f"unmapped detectron key: {key}")


def _d2_state(path_or_state: Any) -> dict:
    return {k.removeprefix("model."): v for k, v in _as_state_dict(path_or_state).items()}


def load_retinanet(path_or_state: Any, model: torch.nn.Module) -> dict:
    """A detectron2-named RetinaNet checkpoint -> a ``state_dict`` for the
    port's ``model``."""
    return convert_state_dict(_d2_state(path_or_state), model.state_dict(), detectron_torch_key)


def load_fcos(path_or_state: Any, model: torch.nn.Module) -> dict:
    """A detectron2/AdelaiDet-named FCOS checkpoint -> a ``state_dict`` for
    the port's ``model``. Stock detectron2 FCOS has no per-level scales
    (it predicts unscaled distances); AdelaiDet's checkpoints carry
    ``head.scales.{l}.scale``. A missing scale is the neutral 1.0, which
    is stock detectron2's function; every other missing key raises."""
    state = _d2_state(path_or_state)
    template = model.state_dict()
    for key in template:
        m = _D2_SCALE.match(key.split(".")[1]) if key.startswith("head.") else None
        if m:
            state.setdefault(f"head.scales.{m.group(1)}.scale", torch.ones(1))
    return convert_state_dict(state, template, detectron_torch_key)


# --- YOLOv4 (pytorch-YOLOv4 naming, the torch source of the ONNX the
#     reference serves: examples/YOLOv4/config.pbtxt) -------------------------

# Tianxiaomo/pytorch-YOLOv4's layout: DownSample1..5 ("down{k}"), the neck
# ("neek" [sic]) and the head. Every Conv_Bn_Activation keeps its layers in
# a ModuleList "conv": the conv at .conv.0, the BN at .conv.1. DownSample1
# inlines the first CSP stage as conv1..conv8; DownSample2-5 hold conv1..5
# and a ResBlock ("resblock.module_list.{i}.{0,1}").
_V4_DOWN1 = {"stem": 1, "down": 2, "split_short": 3, "split_main": 4, "res0_cv1": 5,
             "res0_cv2": 6, "post": 7, "merge": 8}
_V4_STAGE = {"down": 1, "split_short": 2, "split_main": 3, "post": 4, "merge": 5}
_V4_RES = re.compile(r"^res(\d+)_cv([12])$")
_V4_TOP = {
    "pre_spp0": "neek.conv1", "pre_spp1": "neek.conv2", "pre_spp2": "neek.conv3",
    "post_spp0": "neek.conv5", "post_spp1": "neek.conv6", "td4_up": "neek.conv7",
    "td4_lat": "neek.conv8", "td3_up": "neek.conv14", "td3_lat": "neek.conv15",
    "head0_cv": "head.conv1", "detect0": "head.conv2", "bu4_down": "head.conv3",
    "head1_cv": "head.conv9", "detect1": "head.conv10", "bu5_down": "head.conv11",
    "head2_cv": "head.conv17", "detect2": "head.conv18",
}
# the neck's 1-3-1-3-1 blocks: {name}_cv{i} -> {module}.conv{base + i}
_V4_CONV5 = {"td4": ("neek", 9), "td3": ("neek", 16), "bu4": ("head", 4), "bu5": ("head", 12)}
_V4_CV = re.compile(r"^(td4|td3|bu4|bu5)_cv(\d)$")
# upstream's SPP merge conv: pytorch-YOLOv4 concatenates [p13, p9, p5, x]
_V4_SPP_MERGE = "neek.conv4.conv.0.weight"


def yolov4_torch_key(key: str) -> str:
    """Port key -> pytorch-YOLOv4 key."""
    parts = key.split(".")

    def cba(mod: str, sub: str, leaf: str) -> str:
        return f"{mod}.conv.{0 if sub == 'conv' else 1}.{leaf}"

    head = parts[0]
    if head == "stem":
        return cba("down1.conv1", parts[1], parts[2])
    if head == "stage1" and parts[1] in _V4_DOWN1:
        return cba(f"down1.conv{_V4_DOWN1[parts[1]]}", parts[2], parts[3])
    if head.startswith("stage") and head != "stage1":
        k, name = head[len("stage"):], parts[1]
        if name in _V4_STAGE:
            return cba(f"down{k}.conv{_V4_STAGE[name]}", parts[2], parts[3])
        m = _V4_RES.match(name)
        if m:
            return cba(f"down{k}.resblock.module_list.{m.group(1)}.{int(m.group(2)) - 1}",
                       parts[2], parts[3])
    if head == "spp":
        return cba("neek.conv4", parts[2], parts[3])
    if head in _V4_TOP:
        if head.startswith("detect"):  # a bare Conv2d with a bias
            return f"{_V4_TOP[head]}.conv.0.{parts[1]}"
        return cba(_V4_TOP[head], parts[1], parts[2])
    m = _V4_CV.match(head)
    if m:
        mod, base = _V4_CONV5[m.group(1)]
        return cba(f"{mod}.conv{base + int(m.group(2))}", parts[1], parts[2])
    raise KeyError(f"unmapped YOLOv4 key: {key}")


def spp_blocks_reversed(weight: torch.Tensor) -> torch.Tensor:
    """The SPP merge conv's (cout, cin, kh, kw) kernel with its four
    input-channel blocks in reverse order: upstream's [p13, p9, p5, x]
    columns onto the port's [x, p5, p9, p13] (the same function; only the
    concatenation's bookkeeping differs). Axis 1 in PyTorch's OIHW, where
    the JAX importer flips axis 2 of flax's HWIO."""
    cout, cin, kh, kw = weight.shape
    return weight.reshape(cout, 4, cin // 4, kh, kw).flip(1).reshape(cout, cin, kh, kw)


def load_yolov4(path_or_state: Any, model: torch.nn.Module) -> dict:
    """A pytorch-YOLOv4 checkpoint (``.pth``, or its ONNX export's
    initializers) -> a ``state_dict`` for the port's ``model``. ``neck.``
    (ONNX initializer names, some forks) is read as upstream's ``neek.``;
    the SPP merge conv's input blocks are reversed
    (:func:`spp_blocks_reversed`). A tensor that does not fit (another
    width multiple or class count) raises, naming the key."""
    state = {("neek." + k[len("neck."):] if k.startswith("neck.") else k): v
             for k, v in _as_state_dict(path_or_state).items()}
    if _V4_SPP_MERGE in state:
        w = as_tensor(state[_V4_SPP_MERGE])
        if w.ndim == 4 and w.shape[1] % 4 == 0:
            state[_V4_SPP_MERGE] = spp_blocks_reversed(w)

    def transform(key: str, nat: torch.Tensor, target: tuple) -> torch.Tensor:
        raise ValueError(f"yolov4 import: {key} {tuple(nat.shape)} does not fit the template "
                         f"{target} (wrong width multiple or num_classes?)")

    return convert_state_dict(state, model.state_dict(), yolov4_torch_key,
                              leaf_transform=transform)


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
    "retinanet": load_retinanet,
    "fcos": load_fcos,
    "yolov4": load_yolov4,
}
