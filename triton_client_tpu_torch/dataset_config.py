"""YAML dataset/model hyperparameter files -> typed configs (the port's
copy of ``dataset_config.py``).

The ``data/*.yaml`` files map 1:1 onto the frozen config dataclasses (the
voxel grid, anchors, model fields, the pipeline section); the in-code
defaults stay the source of truth for anything a file omits, and unknown
keys raise. Files are read with the port's own :mod:`yaml_subset` reader,
held to ``yaml.safe_load`` on every file under ``data/`` and
``examples/``. Also loads the client parameter file
(``data/client_parameter.yaml``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from triton_client_tpu_torch import yaml_subset
from triton_client_tpu_torch.ops.voxelize import VoxelConfig


def load_yaml(path: str) -> dict:
    doc = yaml_subset.load(path)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: expected a YAML mapping at top level")
    return doc


def _tup(v: Any) -> tuple:
    return tuple(v) if isinstance(v, (list, tuple)) else (v,)


def _check_keys(d: Mapping[str, Any], cls, what: str) -> None:
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise KeyError(f"unknown {what} keys {sorted(unknown)}; known: {sorted(known)}")


def voxel_from_dict(d: Mapping[str, Any], base: VoxelConfig | None = None) -> VoxelConfig:
    base = base or VoxelConfig()
    _check_keys(d, VoxelConfig, "voxel config")
    # coerce per the field's declared type, so a float field is not
    # truncated by int()
    types = {f.name: f.type for f in dataclasses.fields(VoxelConfig)}

    def _coerce(k: str, v: Any):
        if k in ("point_cloud_range", "voxel_size"):
            return _tup(v)
        t = str(types.get(k, "int"))
        return float(v) if "float" in t else int(v)

    return dataclasses.replace(base, **{k: _coerce(k, v) for k, v in d.items()})


def _anchor_classes(rows: list[Mapping[str, Any]]):
    from triton_client_tpu_torch.models.pointpillars import AnchorClassConfig

    out = []
    for r in rows:
        _check_keys(r, AnchorClassConfig, f"anchor class {r.get('name', '?')!r}")
        out.append(
            AnchorClassConfig(
                name=r["name"],
                size=_tup(r["size"]),
                bottom_z=float(r["bottom_z"]),
                matched_thresh=float(r.get("matched_thresh", 0.6)),
                unmatched_thresh=float(r.get("unmatched_thresh", 0.45)),
            )
        )
    return tuple(out)


def _apply_overrides(cfg, d: Mapping[str, Any], tuple_keys: set[str]):
    """Overlay YAML keys onto a frozen dataclass; unknown keys raise."""
    known = {f.name for f in dataclasses.fields(cfg)}
    updates = {}
    for k, v in d.items():
        if k not in known:
            raise KeyError(f"unknown {type(cfg).__name__} key {k!r} (valid: {sorted(known)})")
        updates[k] = _tup(v) if k in tuple_keys and isinstance(v, list) else v
    return dataclasses.replace(cfg, **updates)


_SEQ_KEYS = {
    "backbone_layers",
    "backbone_strides",
    "backbone_filters",
    "upsample_strides",
    "upsample_filters",
    "middle_filters",
    "class_names",
    "point_buckets",
}


def model_config_from_dict(model: str, d: Mapping[str, Any]):
    """'pointpillars' | 'second_iou' + mapping -> config dataclass.
    Sections: ``voxel`` (the grid), ``anchors`` (per-class rows), any
    other key a field override. CenterPoint is not ported (ROADMAP.md
    Queue 1 item 5)."""
    d = dict(d)
    voxel = d.pop("voxel", None)
    anchors = d.pop("anchors", None)
    if model == "pointpillars":
        from triton_client_tpu_torch.models.pointpillars import PointPillarsConfig

        cfg = PointPillarsConfig()
    elif model == "second_iou":
        from triton_client_tpu_torch.models.second import SECONDConfig

        cfg = SECONDConfig()
    elif model == "centerpoint":
        raise NotImplementedError(
            "CenterPoint is not ported yet (ROADMAP.md Queue 1 item 5: models/centerpoint.py)"
        )
    else:
        raise ValueError(f"unknown 3D model {model!r}")
    if voxel is not None:
        cfg = dataclasses.replace(cfg, voxel=voxel_from_dict(voxel, cfg.voxel))
    if anchors is not None:
        cfg = dataclasses.replace(cfg, anchor_classes=_anchor_classes(anchors))
    return _apply_overrides(cfg, d, _SEQ_KEYS)


def detect3d_from_yaml(path: str):
    """A 3D stack's config file -> (model name, model config,
    Detect3DConfig)::

        model: pointpillars
        voxel: {point_cloud_range: [...], voxel_size: [...], ...}
        anchors: [{name: Car, size: [...], bottom_z: ...}, ...]
        pipeline: {score_thresh: ..., z_offset: ..., ...}
        <field>: <model-config override>
    """
    from triton_client_tpu_torch.pipelines.detect3d import default_detect3d_config

    doc = load_yaml(path)
    model = doc.pop("model", "pointpillars")
    pipe_d = dict(doc.pop("pipeline", {}))
    model_cfg = model_config_from_dict(model, doc)
    pipe_cfg = _apply_overrides(default_detect3d_config(model), pipe_d, _SEQ_KEYS)
    # the label vocabulary follows the model's classes
    names = getattr(model_cfg, "class_names", None)
    if names is None and hasattr(model_cfg, "anchor_classes"):
        names = tuple(a.name for a in model_cfg.anchor_classes)
    if names and tuple(pipe_cfg.class_names) != tuple(names):
        pipe_cfg = dataclasses.replace(pipe_cfg, class_names=tuple(names))
    return model, model_cfg, pipe_cfg


_CLIENT_PARAM_DEFAULTS = {
    "channel": "tpu",
    "grpc_channel": "localhost:8001",
    "sub_topic": "/camera/color/image_raw",
    "pub_topic": "/tpu_detections/image",
    "gt_topic": "/camera/color/Detection2DArray",
    "pointcloud_topic": "/os_cloud_node/points",
    "mesh": {"data": -1, "model": 1},
}


def client_params(path: str | None = None) -> dict:
    """Endpoint and topic wiring with defaults (client_parameter.yaml)."""
    params = dict(_CLIENT_PARAM_DEFAULTS)
    if path:
        params.update(load_yaml(path))
    return params
