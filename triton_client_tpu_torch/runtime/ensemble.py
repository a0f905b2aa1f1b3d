"""Ensemble models: serve a DAG of registered models as one model (port of
``runtime/ensemble.py``).

Triton ensembles (``platform: "ensemble"`` with ``ensemble_scheduling``
steps and their input_map/output_map) are the reference's acknowledged gap:
"Ensemble mode for Triton server" is an unchecked TODO (its README.md:119),
so the JAX package is the reference here.

An ensemble is declared in the model repository like any other entry::

    <root>/<name>/config.yaml
        family: ensemble
        steps:
          - model: detector            # registered model name
            version: "2"               # optional (default: latest)
            input_map:  {images: raw}  # step input <- ensemble tensor
            output_map: {detections: boxes}  # step output -> ensemble tensor
            precision: bf16            # optional: the stage's input dtype
          - model: tracker
            input_map:  {boxes: boxes}
            output_map: {tracks: tracks}
        outputs: [tracks]              # ensemble-level outputs

Steps run in declaration order (Triton's semantics). The build checks that
every consumed tensor is an ensemble input or an earlier step's output,
that the named models and tensors exist, and that the declared outputs are
produced. The ensemble's input contract is derived, not declared.

Three data paths (``spec.extra["data_path"]``), chosen by ``fuse``:

- **fused** (``auto`` when every member has a ``device_fn``, or
  ``always``): the composition of the members' device forms (``_compose``)
  is the ensemble's ``device_fn``, so ``CUDAChannel`` captures the whole
  DAG as one CUDA graph per input signature, and a parent ensemble can
  compose it in turn. The ensemble's own ``infer_fn`` is a
  ``runtime/graphs.CapturedFunction`` over the same composition. No
  intermediate leaves the card.
- **device-resident** (``auto`` with some members host-only): one
  ``CapturedFunction`` per member with a ``device_fn``; tensors pass
  between consecutive device steps on the card and come back to the host
  only at a host-only member.
- **host** (``never``, or ``auto`` with no ``device_fn`` among the
  members): each step's outputs are read back as numpy and the next
  member uploads them again, as the JAX host path hands numpy between its
  members' ``infer_fn``s.

Device forms. A model registered with a ``device_fn`` serves through it
(the channel captures it). A disk entry serves through its pipeline's
captured ``infer_fn`` and offers its device form as ``member_device_fn``
only, so its route, launch counts and graphs do not change; ``fuse:
always`` takes a member's ``device_fn`` or else its ``member_device_fn``,
``auto`` its ``device_fn`` only. A member with neither is host-only.

Each fused or device-resident stage casts its floating pool inputs to its
compute dtype on the device: the step's ``precision``, else the member's
registered policy (``spec.extra["precision"]``), else float32. Each
declared output is cast to its spec dtype at the boundary (a scored head's
``device_fn`` emits int32 classes where its spec says INT64).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Mapping, Sequence

import numpy as np
import torch

from triton_client_tpu_torch.channel.staged import cast_wire_input
from triton_client_tpu_torch.config import ModelSpec, TensorSpec, config_dtypes
from triton_client_tpu_torch.device import resolve_device
from triton_client_tpu_torch.runtime.graphs import CapturedFunction
from triton_client_tpu_torch.runtime.precision import PrecisionPolicy, host_array, host_tensor
from triton_client_tpu_torch.runtime.repository import ModelRepository, RegisteredModel


@dataclasses.dataclass(frozen=True)
class EnsembleStep:
    """One scheduling step: run ``model`` with inputs pulled from the
    ensemble's tensor pool via ``input_map`` (step input name -> pool name)
    and publish its outputs back via ``output_map`` (step output name ->
    pool name). ``precision``: the stage's policy name; "" inherits the
    member's registered policy. An explicit value casts the stage's pool
    inputs to that policy's compute dtype on the device paths; the weights
    stay as the member registered them."""

    model: str
    input_map: Mapping[str, str]
    output_map: Mapping[str, str]
    version: str = ""
    precision: str = ""


# step-level precision values accepted by parse_steps ("" = inherit)
_STEP_PRECISIONS = ("", "f32", "bf16", "int8w", "int8")


def parse_steps(doc_steps: Sequence[Mapping]) -> list[EnsembleStep]:
    steps = []
    for i, d in enumerate(doc_steps):
        d = dict(d)
        unknown = set(d) - {"model", "version", "input_map", "output_map", "precision"}
        if unknown:
            raise KeyError(f"ensemble step {i}: unknown keys {sorted(unknown)}")
        for key in ("model", "input_map", "output_map"):
            if key not in d:
                raise KeyError(f"ensemble step {i}: missing '{key}'")
        precision = str(d.get("precision", ""))
        if precision not in _STEP_PRECISIONS:
            raise ValueError(
                f"ensemble step {i}: precision must be one of "
                f"{[p for p in _STEP_PRECISIONS if p]} (got {precision!r})"
            )
        steps.append(EnsembleStep(
            model=str(d["model"]),
            version=str(d.get("version", "")),
            input_map=dict(d["input_map"]),
            output_map=dict(d["output_map"]),
            precision=precision,
        ))
    if not steps:
        raise ValueError("ensemble needs at least one step")
    return steps


def _rename(spec: TensorSpec, name: str) -> TensorSpec:
    return dataclasses.replace(spec, name=name)


def _check_compatible(
    ensemble: str, step: str, pool_name: str, have: TensorSpec, want: TensorSpec
) -> None:
    """Producer/consumer check of one pool tensor: dtypes equal exactly,
    dims equal where both sides are static (-1 is a wildcard). Failing here
    keeps scan_disk's fail-at-startup policy."""
    if have.dtype != want.dtype:
        raise ValueError(
            f"ensemble '{ensemble}': tensor '{pool_name}' is {have.dtype} "
            f"but step '{step}' consumes it as {want.dtype}"
        )
    if len(have.shape) != len(want.shape) or any(
        a != b for a, b in zip(have.shape, want.shape) if a >= 0 and b >= 0
    ):
        raise ValueError(
            f"ensemble '{ensemble}': tensor '{pool_name}' has shape "
            f"{have.shape} but step '{step}' expects {want.shape}"
        )


def _torch_dtype(spec_dtype: str) -> torch.dtype | None:
    if spec_dtype == "BF16":
        return torch.bfloat16
    np_dtype = config_dtypes().get(spec_dtype)
    return None if np_dtype is None else torch.from_numpy(np.empty(0, np_dtype)).dtype


def _to_dtype(x, spec_dtype: str):
    """An output at its spec dtype: a tensor stays on its device."""
    if isinstance(x, torch.Tensor):
        dt = _torch_dtype(spec_dtype)
        return x if dt is None or x.dtype == dt else x.to(dt)
    dt = config_dtypes().get(spec_dtype)
    return np.asarray(x) if dt is None else np.asarray(x, dtype=dt)


def _stage_cast(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A floating pool tensor to a stage's compute dtype; integer and bool
    tensors (num_points, labels) pass as they are."""
    if x.is_floating_point() and x.dtype != dt:
        return x.to(dt)
    return x


class _Transfers:
    """Bytes the ensemble's own hops move between host and device (the
    channel's upload of the request and readback of the result are not
    counted here)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._bytes = {"h2d_bytes": 0, "d2h_bytes": 0}

    def add(self, key: str, n: int) -> None:
        with self._lock:
            self._bytes[key] += int(n)

    def stats(self) -> dict:
        with self._lock:
            return dict(self._bytes)


def build_ensemble(
    repository: ModelRepository,
    name: str,
    steps: Sequence[EnsembleStep],
    outputs: Sequence[str],
    version: str = "1",
    max_batch_size: int = 1,
    fuse: str = "auto",
    device: str | torch.device | None = None,
) -> RegisteredModel:
    """Compose registered models into one RegisteredModel.

    The input contract is derived: every pool tensor consumed before it is
    produced is an ensemble input, typed by the first member input bound to
    it. Members are resolved at build time (snapshot semantics): reloading a
    member means rebuilding the ensembles over it, as in Triton. ``device``:
    where the host path uploads a step's inputs, ``cuda`` unless the caller
    passes ``cpu``."""
    if not outputs:
        raise ValueError(f"ensemble '{name}': declare at least one output")
    members = [repository.get(s.model, s.version) for s in steps]

    produced: dict[str, TensorSpec] = {}
    needed: dict[str, TensorSpec] = {}
    for step, member in zip(steps, members):
        in_names = {t.name for t in member.spec.inputs}
        missing = set(step.input_map) - in_names
        if missing:
            raise KeyError(
                f"ensemble '{name}': step '{step.model}' has no inputs "
                f"{sorted(missing)} (has {sorted(in_names)})"
            )
        unbound = in_names - set(step.input_map)
        if unbound:
            raise KeyError(
                f"ensemble '{name}': step '{step.model}' inputs "
                f"{sorted(unbound)} are not bound in input_map"
            )
        for step_in, pool_name in step.input_map.items():
            spec = member.spec.input_by_name(step_in)
            have = produced.get(pool_name) or needed.get(pool_name)
            if have is None:
                needed[pool_name] = _rename(spec, pool_name)
            else:
                _check_compatible(name, step.model, pool_name, have, spec)
        out_specs = {t.name: t for t in member.spec.outputs}
        missing = set(step.output_map) - set(out_specs)
        if missing:
            raise KeyError(
                f"ensemble '{name}': step '{step.model}' has no outputs "
                f"{sorted(missing)} (has {sorted(out_specs)})"
            )
        for step_out, pool_name in step.output_map.items():
            produced[pool_name] = _rename(out_specs[step_out], pool_name)

    missing = [o for o in outputs if o not in produced]
    if missing:
        # an ensemble input does not qualify: echoing one back is almost
        # always a typo (Triton also requires every output from a step)
        raise ValueError(
            f"ensemble '{name}': outputs {missing} are never produced "
            f"by any step (produced: {sorted(produced)})"
        )

    step_list = list(zip(steps, members))
    output_names = tuple(outputs)
    out_dtype = {o: produced[o].dtype for o in output_names}
    # the effective policy of each stage: a step key overrides, "" inherits
    # the member's registered policy
    step_precision = [s.precision or str(m.spec.extra.get("precision", "f32"))
                      for s, m in step_list]

    if fuse not in ("auto", "always", "never"):
        raise ValueError(f"ensemble '{name}': fuse must be auto/always/never, got {fuse!r}")
    # the device form of each member under this fuse setting (module docstring)
    forms = [m.device_fn or (m.member_device_fn if fuse == "always" else None)
             for _, m in step_list]
    host_only = [s.model for (s, _), f in zip(step_list, forms) if f is None]
    if fuse == "always" and host_only:
        raise ValueError(
            f"ensemble '{name}': fuse: always, but members {host_only} "
            f"expose no device_fn (host-only)"
        )
    fused = fuse != "never" and not host_only
    mixed = fuse != "never" and not fused and any(f is not None for f in forms)

    spec = ModelSpec(
        name=name,
        version=version,
        platform="ensemble",
        inputs=tuple(needed.values()),
        outputs=tuple(produced[o] for o in output_names),
        max_batch_size=max_batch_size,
        extra={
            "steps": [s.model for s in steps],
            "fused": fused,
            "data_path": "fused" if fused else "device-resident" if mixed else "host",
            # the effective policy per stage; the ensemble's own wire stays
            # float32, cast back at the boundary like any pipeline's
            "step_precision": step_precision,
        },
    )
    dev = resolve_device(device)
    in_names = tuple(t.name for t in spec.inputs)
    step_dtype = [PrecisionPolicy.parse(p).compute_dtype for p in step_precision]
    transfers = _Transfers()

    def upload(member, step_in: str, value) -> torch.Tensor:
        """A pool value as the member's input on the device: a tensor as it
        is, a host array through the channel's staging cast and one copy."""
        if isinstance(value, torch.Tensor):
            return value
        arr = np.require(cast_wire_input(member, step_in, np.asarray(value)), requirements="C")
        t = host_tensor(arr if arr.flags.writeable else arr.copy())
        if dev.type == "cuda":
            transfers.add("h2d_bytes", arr.nbytes)
            t = t.to(dev)
        return t

    def readback(value) -> np.ndarray:
        if not isinstance(value, torch.Tensor):
            return np.asarray(value)
        if value.device.type == "cuda":
            transfers.add("d2h_bytes", value.numel() * value.element_size())
        return host_array(value)

    def host_step(step, member, pool) -> None:
        """One step through the host: its inputs upload, its outputs come
        back as numpy."""
        result = member.infer_fn({step_in: upload(member, step_in, pool[pool_name])
                                  for step_in, pool_name in step.input_map.items()})
        for step_out, pool_name in step.output_map.items():
            pool[pool_name] = readback(result[step_out])

    def host_infer_fn(inputs: Mapping) -> dict:
        pool = dict(inputs)
        for step, member in step_list:
            host_step(step, member, pool)
        return {o: _to_dtype(pool[o], out_dtype[o]) for o in output_names}

    def to_device(value) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.to(dev)
        arr = np.require(np.asarray(value), requirements="C")
        return host_tensor(arr if arr.flags.writeable else arr.copy()).to(dev)

    ensemble_device_fn = None
    if fused:
        def _compose(pool_in):
            # the whole DAG in one body: each step's outputs feed the next
            # as device tensors, and the only transfers are the ensemble's
            # inputs in and its outputs out. Kept uncaptured, so a parent
            # ensemble can compose this one inside its own capture.
            pool = dict(pool_in)
            for (step, _), form, dt in zip(step_list, forms, step_dtype):
                result = form({step_in: _stage_cast(pool[pool_name], dt)
                               for step_in, pool_name in step.input_map.items()})
                for step_out, pool_name in step.output_map.items():
                    pool[pool_name] = result[step_out]
            return {o: pool[o] for o in output_names}

        ensemble_device_fn = _compose

        def body(*tensors):
            out = _compose(dict(zip(in_names, tensors)))
            return {k: _to_dtype(v, out_dtype[k]) for k, v in out.items()}

        dag = CapturedFunction(body, f"{name}:{version}")

        def infer_fn(inputs: Mapping) -> dict:
            return dag(*(to_device(inputs[n]) for n in in_names))

        infer_fn.graph_stats = dag.stats
        infer_fn.release_graphs = dag.release
    elif mixed:
        # one captured function per device-capable member: consecutive
        # device steps hand tensors over on the card; a host-only step
        # reads its inputs back and its outputs come back as numpy
        captured = {}
        for i, ((step, member), form) in enumerate(zip(step_list, forms)):
            if form is not None:
                names = tuple(step.input_map)
                captured[i] = (names, CapturedFunction(
                    lambda *t, form=form, names=names: form(dict(zip(names, t))),
                    f"{name}:{version}:{step.model}"))

        def infer_fn(inputs: Mapping) -> dict:
            pool = dict(inputs)
            for i, (step, member) in enumerate(step_list):
                if i not in captured:
                    for pool_name in step.input_map.values():
                        pool[pool_name] = readback(pool[pool_name])
                    host_step(step, member, pool)
                    continue
                names, fn = captured[i]
                result = fn(*(_stage_cast(to_device(pool[step.input_map[n]]), step_dtype[i])
                              for n in names))
                for step_out, pool_name in step.output_map.items():
                    pool[pool_name] = result[step_out]
            return {o: _to_dtype(pool[o], out_dtype[o]) for o in output_names}

        infer_fn.graph_stats = lambda: {
            k: sum(fn.stats()[k] for _, fn in captured.values())
            for k in ("calls", "captures", "replays", "keys", "pool_bytes")
        }

        def release_graphs() -> None:
            for _, fn in captured.values():
                fn.release()

        infer_fn.release_graphs = release_graphs
    else:
        infer_fn = host_infer_fn
    infer_fn.transfer_stats = transfers.stats

    if fused or mixed:
        def warmup() -> None:
            # the members' warmups capture their standalone bodies, which
            # neither the fused nor the device-resident path runs: warm the
            # served DAG itself on a nominal spec-shaped batch (wildcard
            # dims 64, batch 1), as the JAX package does
            zeros = {}
            for t in spec.inputs:
                shape = [1] + [(64 if d < 0 else int(d)) for d in t.shape[1:]]
                zeros[t.name] = np.zeros(shape, config_dtypes().get(t.dtype) or np.float32)
            infer_fn(zeros)
    else:
        def warmup() -> None:
            for _, member in step_list:
                if member.warmup is not None:
                    member.warmup()

    return RegisteredModel(spec=spec, infer_fn=infer_fn, warmup=warmup,
                           device_fn=ensemble_device_fn)


def build_ensemble_doc(
    repository: ModelRepository, name: str, doc: Mapping, version: str = "1",
    device: str | torch.device | None = None,
) -> RegisteredModel:
    """config.yaml dict -> RegisteredModel (the disk repository's hook)."""
    unknown = set(doc) - {"family", "steps", "outputs", "max_batch_size", "warmup", "fuse"}
    if unknown:
        raise KeyError(f"ensemble '{name}': unknown config keys {sorted(unknown)}")
    if "steps" not in doc or "outputs" not in doc:
        raise KeyError(f"ensemble '{name}': config needs 'steps' and 'outputs'")
    fuse = doc.get("fuse", "auto")
    if isinstance(fuse, bool):  # yaml `fuse: true` reads as a bool
        fuse = "always" if fuse else "never"
    return build_ensemble(
        repository,
        name,
        parse_steps(doc["steps"]),
        outputs=list(doc["outputs"]),
        version=version,
        max_batch_size=int(doc.get("max_batch_size", 1)),
        fuse=str(fuse),
        device=device,
    )
