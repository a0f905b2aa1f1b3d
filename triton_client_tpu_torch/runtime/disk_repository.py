"""On-disk model repository: Triton's directory layout (the port's copy of
``runtime/disk_repository.py``)::

    <root>/<model_name>/
        config.yaml      # family + model/pipeline config (config.pbtxt)
        1/weights.*      # a version dir's weight artifact

:func:`scan_disk` builds every entry's pipeline with the port's builders
(``build_yolov5_pipeline``, ``build_pointpillars_pipeline``,
``build_second_pipeline``) and registers it (name, version) into a
``ModelRepository`` for ``CUDAChannel`` and the serving façade. Each entry
registers its pipeline's captured body (``infer_fn``) with a ``warmup``
that captures the graph real traffic uses: batch 1 of FP32 frames at the
model's input size (2D), or every point bucket (3D). ``config.yaml`` and
the dataset files it names are read with the port's ``yaml_subset``.

Weights: an entry with no version dir registers version 1 with random
weights from a seed (seed 0, where the JAX package draws from
``PRNGKey(0)``); tests hand JAX's variables across through
``registered(..., variables=...)``. Broken or unported entries raise, so
a serving process fails at startup instead of skipping models:

- the families not ported (yolov4, retinanet, fcos, preprocess and
  ensembles: ROADMAP.md Queue 1 item 7; centerpoint: item 5);
- the ``s2d`` / ``ch_floor`` / ``dtype: bf16`` layout and the precision
  policies (item 3);
- weight artifacts in version dirs, ``load_pipeline`` and ``export_model``
  (item 4).
"""

from __future__ import annotations

import dataclasses
import logging
import pathlib
from typing import Any, Mapping

import torch

from triton_client_tpu_torch.dataset_config import (
    _SEQ_KEYS,
    _apply_overrides,
    detect3d_from_yaml,
    load_yaml,
    model_config_from_dict,
)
from triton_client_tpu_torch.runtime.repository import ModelRepository, RegisteredModel

log = logging.getLogger(__name__)

_WEIGHT_NAMES = ("weights.msgpack", "weights.pt", "weights.pth", "weights.onnx", "model.pt",
                 "model.pth", "model.onnx")

# family -> the ROADMAP.md Queue 1 item that ports it
_UNPORTED_FAMILIES = {
    "yolov4": "7 (models/yolov4.py)",
    "retinanet": "7 (models/retinanet.py)",
    "fcos": "7 (models/retinanet.py, ops/anchor_decode.py)",
    "preprocess": "7 (pipelines/preprocess2d.py)",
    "ensemble": "7 (runtime/ensemble.py)",
    "centerpoint": "5 (models/centerpoint.py)",
}
_LAYOUT_ITEM = "3 (the examples/yolov5_crop layout and runtime/precision.py)"
_WEIGHTS_ITEM = "4 (weight importers that need no JAX)"


def _families_2d() -> tuple[str, ...]:
    from triton_client_tpu_torch.pipelines.detect2d import BUILDERS_2D

    return tuple(BUILDERS_2D)


def _families_3d() -> tuple[str, ...]:
    from triton_client_tpu_torch.pipelines.detect3d import BUILDERS_3D

    return tuple(BUILDERS_3D)


def load_weights(path: str | pathlib.Path, family: str):
    """A version dir's weight artifact: not ported (every format needs an
    importer the port does not have yet)."""
    raise NotImplementedError(
        f"{pathlib.Path(path)}: weight artifacts for {family!r} are not ported yet "
        f"(ROADMAP.md Queue 1 item {_WEIGHTS_ITEM})"
    )


def _resolve(path_str: str, model_dir: pathlib.Path) -> str:
    """A config-referenced file, relative to the model dir first, then the
    repository root, then the working directory."""
    p = pathlib.Path(path_str)
    if p.is_absolute():
        return str(p)
    bases = (model_dir, model_dir.parent, pathlib.Path.cwd())
    for base in bases:
        if (base / p).exists():
            return str(base / p)
    raise FileNotFoundError(
        f"{model_dir / 'config.yaml'} references {path_str!r}, not found relative to any of "
        f"{[str(b) for b in bases]}"
    )


def _refuse_layout(where: pathlib.Path, model_kwargs: Mapping[str, Any]) -> None:
    """The layout and precision options the port does not serve yet."""
    bad = [k for k in ("s2d", "ch_floor") if model_kwargs.get(k)]
    if str(model_kwargs.get("dtype", "fp32")) not in ("fp32", "float32"):
        bad.append(f"dtype: {model_kwargs['dtype']}")
    if model_kwargs.get("precision") not in (None, "", "f32"):
        bad.append(f"precision: {model_kwargs['precision']}")
    if bad:
        raise NotImplementedError(
            f"{where / 'config.yaml'}: {', '.join(bad)} is not ported yet "
            f"(ROADMAP.md Queue 1 item {_LAYOUT_ITEM})"
        )


def _build_2d(family: str, doc: Mapping[str, Any], model_dir: pathlib.Path, device):
    from triton_client_tpu_torch.pipelines import detect2d

    model_kwargs = dict(doc.get("model", {}))
    _refuse_layout(model_dir, model_kwargs)
    for k in ("s2d", "ch_floor", "dtype", "precision"):
        model_kwargs.pop(k, None)
    if "input_hw" in model_kwargs:
        model_kwargs["input_hw"] = tuple(model_kwargs["input_hw"])
    pipe_d = dict(doc.get("pipeline", {}))
    names_file = pipe_d.pop("class_names_file", None)
    names = detect2d.load_class_names(_resolve(names_file, model_dir)) if names_file else None
    if names:
        model_kwargs.setdefault("num_classes", len(names))
    known = {"variant", "num_classes", "input_hw"}
    if set(model_kwargs) - known:
        raise KeyError(f"{model_dir / 'config.yaml'}: unknown model keys "
                       f"{sorted(set(model_kwargs) - known)}; known: {sorted(known)}")
    # the family's default config, then the pipeline section over it
    cfg = detect2d.default_detect2d_config(
        model_kwargs.get("variant", "n"), model_kwargs.get("num_classes", 80),
        model_kwargs.get("input_hw", (512, 512)),
    )
    cfg = _apply_overrides(cfg, pipe_d, _SEQ_KEYS)
    if names:
        cfg = dataclasses.replace(cfg, class_names=names, num_classes=model_kwargs["num_classes"])

    def build(variables=None):
        return detect2d.BUILDERS_2D[family](
            variables=variables, config=cfg, device=device, **model_kwargs
        )

    def warmup(pipe):
        # batch 1 of FP32 frames at the model's input size, as the JAX
        # entry compiles it (other shapes capture on first use)
        pipe.warmup(tuple(cfg.input_hw), batch_sizes=(1,), dtype=torch.float32)

    return build, cfg, warmup


def _build_3d(family: str, doc: Mapping[str, Any], model_dir: pathlib.Path, device):
    from triton_client_tpu_torch.pipelines import detect3d

    model_doc = dict(doc.get("model", {}))
    _refuse_layout(model_dir, model_doc)
    model_doc.pop("dtype", None)
    model_doc.pop("precision", None)
    if "dataset" in doc:
        got_family, model_cfg, pipe_cfg = detect3d_from_yaml(_resolve(doc["dataset"], model_dir))
        if got_family != family:
            raise ValueError(f"config.yaml family {family!r} != dataset yaml model {got_family!r}")
    else:
        model_cfg = model_config_from_dict(family, model_doc)
        pipe_cfg = _apply_overrides(
            detect3d.default_detect3d_config(family), dict(doc.get("pipeline", {})), _SEQ_KEYS
        )

    def build(variables=None):
        return detect3d.BUILDERS_3D[family](
            model_cfg=model_cfg, config=pipe_cfg, variables=variables, device=device
        )

    return build, pipe_cfg, lambda pipe: pipe.warmup()


_TOP_KEYS = {"family", "model", "pipeline", "dataset", "max_batch_size", "warmup"}


class _Entry:
    """One model dir's parsed config and builder."""

    def __init__(
        self,
        model_dir: str | pathlib.Path,
        doc: Mapping[str, Any] | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        """``device``: cuda unless the caller passes cpu."""
        self.model_dir = pathlib.Path(model_dir)
        if doc is None:
            doc = load_yaml(str(self.model_dir / "config.yaml"))
        doc = dict(doc)
        self.family = doc.get("family")
        if self.family in _UNPORTED_FAMILIES:
            raise NotImplementedError(
                f"{self.model_dir}: family {self.family!r} is not ported yet "
                f"(ROADMAP.md Queue 1 item {_UNPORTED_FAMILIES[self.family]})"
            )
        unknown = set(doc) - _TOP_KEYS
        if unknown:
            raise KeyError(f"{self.model_dir / 'config.yaml'}: unknown keys {sorted(unknown)}; "
                           f"known: {sorted(_TOP_KEYS)}")
        self.doc = doc
        if self.family in _families_2d():
            self._build, self.cfg, self._warmup = _build_2d(self.family, doc, self.model_dir,
                                                            device)
        elif self.family in _families_3d():
            self._build, self.cfg, self._warmup = _build_3d(self.family, doc, self.model_dir,
                                                            device)
        else:
            raise ValueError(f"{self.model_dir}: unknown family {self.family!r} "
                             f"(known: {_families_2d() + _families_3d()})")

    def registered(
        self, version: str, weights: str | pathlib.Path | None = None, variables=None
    ) -> RegisteredModel:
        """The entry's pipeline as a RegisteredModel. ``weights``: a version
        dir's artifact (raises: not ported). ``variables``: a flax variable
        tree carried across by ``models/convert.py`` (tests); None draws
        seeded random weights."""
        if weights is not None:
            load_weights(weights, self.family)
        pipeline, spec, _ = self._build(variables=variables)
        spec = dataclasses.replace(
            spec,
            name=self.model_dir.name,
            version=version,
            max_batch_size=int(self.doc.get("max_batch_size", spec.max_batch_size)),
        )
        return RegisteredModel(
            spec=spec, infer_fn=pipeline.infer_fn(),
            warmup=lambda p=pipeline: self._warmup(p),
        )


def load_pipeline(model_dir, version: str = "", kind: str = "", device=None):
    """One model dir's pipeline with its trained weights (the detect CLIs'
    ``--repo``): every served artifact needs an importer the port does not
    have yet."""
    raise NotImplementedError(
        f"load_pipeline is not ported yet (ROADMAP.md Queue 1 item {_WEIGHTS_ITEM})"
    )


def version_dirs(model_dir: pathlib.Path) -> list[pathlib.Path]:
    return sorted(
        (d for d in model_dir.iterdir() if d.is_dir() and d.name.isdigit()),
        key=lambda d: int(d.name),
    )


def find_weights(version_dir: pathlib.Path) -> pathlib.Path:
    """A version dir must carry a recognized artifact (a typo'd file name
    must not serve random weights)."""
    for name in _WEIGHT_NAMES:
        if (version_dir / name).exists():
            return version_dir / name
    present = sorted(p.name for p in version_dir.iterdir())
    raise FileNotFoundError(f"{version_dir}: no weight artifact (found {present}; recognized "
                            f"names: {list(_WEIGHT_NAMES)})")


def scan_disk(
    root: str | pathlib.Path,
    repository: ModelRepository | None = None,
    device: str | torch.device | None = None,
) -> ModelRepository:
    """Load every ``<root>/<model>/config.yaml`` entry into a repository.

    Numeric version dirs each register separately; an entry without one
    registers version 1 with seeded random weights. A ``warmup: true``
    entry captures its graphs at scan time; every entry carries its warmup
    for ``serve --warmup``. Broken and unported entries raise (module
    docstring). ``device``: cuda unless the caller passes cpu."""
    root = pathlib.Path(root)
    repo = repository or ModelRepository()
    for model_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        if not (model_dir / "config.yaml").exists():
            log.info("skipping %s (no config.yaml)", model_dir)
            continue
        entry = _Entry(model_dir, device=device)
        versions = version_dirs(model_dir)
        pairs = [(v.name, find_weights(v)) for v in versions] if versions else [("1", None)]
        for version, weights in pairs:
            rm = entry.registered(version, weights)
            repo.register(rm.spec, rm.infer_fn, warmup=rm.warmup)
            if entry.doc.get("warmup"):
                rm.warmup()
    return repo


def export_model(root, name: str, config_doc: Mapping[str, Any], variables=None,
                 version: str = "1"):
    """Writing an entry (config and weight artifact) is not ported."""
    raise NotImplementedError(
        f"export_model is not ported yet (ROADMAP.md Queue 1 item {_WEIGHTS_ITEM})"
    )
