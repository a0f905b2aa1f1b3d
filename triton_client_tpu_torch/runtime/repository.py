"""Model repository: versioned registry of model functions (port of
``runtime/repository.py``, cut to what the serving path reads).

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
    # Optional zero-argument callable that captures the model's graphs
    # ahead of traffic (the pipelines' ``warmup``: each point bucket,
    # each batch size an entry point uses). The caller runs it after
    # registering; the repository only keeps it.
    warmup: Callable[[], None] | None = None
    # Optional capturable form of the model: {name: device tensor} ->
    # {name: device tensor} with the wire spec's names, static shapes for
    # one input shape and no host sync. The serving channel captures it
    # as a CUDA graph per input shape (runtime/graphs.py) and may hand a
    # donatable input's staged buffer back after the launch; None keeps
    # the infer_fn call.
    device_fn: InferFn | None = None
    # Optional segment-aware form of the model for packed ragged batches
    # (runtime/continuous.py): ``ragged_fn(inputs, segment_ids,
    # num_segments) -> outputs``, where each input named in
    # ``spec.extra["ragged_inputs"]`` is a packed (R, ...) row
    # concatenation, the other inputs are stacked per segment,
    # ``segment_ids`` is the (R,) int32 row -> request table (pad rows
    # carry an out-of-range id), and every per-request output has leading
    # dim ``num_segments``. None: the model only runs dense.
    ragged_fn: Callable | None = None


class ModelRepository:
    """Thread-safe name -> version -> model registry."""

    def __init__(self) -> None:
        self._models: dict[str, dict[str, RegisteredModel]] = {}
        self._lock = threading.Lock()
        # unregister listeners: fn(name, version), called once per removed
        # version OUTSIDE the registry lock. Serving channels subscribe so
        # a dropped model also drops its cached launcher (and the graphs
        # it holds in device memory)
        self._unregister_listeners: list[Callable[[str, str], None]] = []

    def add_unregister_listener(self, fn: Callable[[str, str], None]) -> None:
        with self._lock:
            self._unregister_listeners.append(fn)

    def register(
        self,
        spec: ModelSpec,
        infer_fn: InferFn,
        ragged_fn: Callable | None = None,
        warmup: Callable[[], None] | None = None,
        device_fn: InferFn | None = None,
    ) -> None:
        with self._lock:
            self._models.setdefault(spec.name, {})[spec.version] = RegisteredModel(
                spec, infer_fn, warmup, device_fn, ragged_fn
            )

    def unregister(self, name: str, version: str = "") -> None:
        """Drop one version (or every version) of a model, then tell the
        listeners, outside the lock: they take locks of their own."""
        removed: list[tuple[str, str]] = []
        with self._lock:
            if version:
                if self._models.get(name, {}).pop(version, None) is not None:
                    removed.append((name, version))
                if not self._models.get(name):
                    self._models.pop(name, None)
            else:
                for v in self._models.pop(name, {}):
                    removed.append((name, v))
            listeners = list(self._unregister_listeners)
        for n, v in removed:
            for fn in listeners:
                fn(n, v)

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

    def list_models(self) -> list[tuple[str, str]]:
        with self._lock:
            return [(n, v) for n, vs in self._models.items() for v in vs]

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def versions(self, name: str) -> list[str]:
        with self._lock:
            return sorted(self._models.get(name, {}), key=_version_key)
