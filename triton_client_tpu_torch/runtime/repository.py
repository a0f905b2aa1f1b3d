"""Model repository: versioned registry of model functions (port of
``runtime/repository.py``, cut to what the in-process path reads).

A model is a ModelSpec plus a callable over tensors; "the latest
version" is the default serve target, as Triton's version_policy.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Mapping

from triton_client_tpu_torch.config import ModelSpec

# An infer function maps {input_name: tensor} -> {output_name: tensor}.
InferFn = Callable[[Mapping[str, object]], dict[str, object]]


def _version_key(v: str):
    """'Latest version' ordering: numeric-style ('10' > '9'), lexical tiebreak."""
    return (len(v), v)


@dataclasses.dataclass
class RegisteredModel:
    # CONTRACT: infer_fn may receive inputs NARROWER than the declared
    # wire dtype (uint8 frames against an FP32 spec): the channel uploads
    # them as they are, and the pipeline widens them on the device.
    spec: ModelSpec
    infer_fn: InferFn


class ModelRepository:
    """Thread-safe name -> version -> model registry."""

    def __init__(self) -> None:
        self._models: dict[str, dict[str, RegisteredModel]] = {}
        self._lock = threading.Lock()

    def register(self, spec: ModelSpec, infer_fn: InferFn) -> None:
        with self._lock:
            self._models.setdefault(spec.name, {})[spec.version] = RegisteredModel(spec, infer_fn)

    def get(self, name: str, version: str = "") -> RegisteredModel:
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise KeyError(f"model '{name}' is not registered")
            if version:
                if version not in versions:
                    raise KeyError(f"model '{name}' has no version '{version}'")
                return versions[version]
            return versions[max(versions, key=_version_key)]

    def metadata(self, name: str, version: str = "") -> ModelSpec:
        return self.get(name, version).spec
