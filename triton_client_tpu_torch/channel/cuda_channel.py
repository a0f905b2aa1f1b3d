"""CUDAChannel: the in-process dispatch channel, the single-device
placement policy of ``StagedChannel`` (port of ``channel/tpu_channel.py``).

``do_inference`` is a function call: inputs go host -> device, the
registered model runs on the card, and outputs come back as numpy only
at the boundary, lazily (``channel/staged.py``).

- **Placement** (``_place_inputs``): the never-widen dtype policy and the
  model's precision policy (``cast_wire_input``: a ``bf16`` model's float32
  frames become bfloat16 words, a calibrated ``int8`` model's int8 codes),
  then a copy into pinned host buffers owned by a
  staging slot and reused across requests, then a host-to-device copy
  with ``non_blocking=True``. A slot's pinned buffers are written again
  only after an event shows its last copy done. On the CPU the request's
  arrays are used as they are.
- **Launcher** (``_make_launcher``): a model with a ``device_fn`` runs
  through a ``runtime/graphs.CapturedFunction`` over it, one CUDA graph
  per input signature; a model without one keeps its ``infer_fn`` (the
  pipelines' ``infer_fn`` goes through their own captured body).
- **Donation**: a ``donatable`` input (``TensorSpec.donatable``) of a
  ``device_fn`` model stages into a device buffer of the slot, which goes
  back to the slot as soon as the launch has consumed it (in stream
  order: the next copy into it waits on an event behind the launch).
  Such a launch counts under ``donated_launches``.
- **Packed ragged requests** (``request.ragged`` set by the continuous
  batcher): the packed inputs and the layout's (R,) int32 segment ids
  upload, the model's ``ragged_fn`` runs eagerly at the layout's
  ``launch_segments``, and the dead segment slots are sliced off the
  outputs whose leading dim is the segment bucket. Their inputs skip the
  per-tensor spec check.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from triton_client_tpu_torch.channel.staged import (  # noqa: F401 (re-exported)
    SEGMENT_IDS_KEY,
    StagedChannel,
    StagedRequest,
    _wire_dtypes,
    cast_wire_input,
)
from triton_client_tpu_torch.device import resolve_device
from triton_client_tpu_torch.runtime.precision import host_tensor
from triton_client_tpu_torch.runtime.graphs import CapturedFunction
from triton_client_tpu_torch.runtime.repository import ModelRepository


class _StagingSlot:
    """Pinned host buffers (and donated device buffers) reused across
    requests, with the events that say when each may be written again."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.host: dict[str, torch.Tensor] = {}
        self.dev: dict[str, torch.Tensor] = {}
        self.copied = torch.cuda.Event()  # behind the last host -> device copy
        self.consumed = torch.cuda.Event()  # behind the last launch that read .dev
        self.used = False

    def pinned(self, name: str, arr: np.ndarray) -> torch.Tensor:
        """``arr`` copied into this slot's pinned buffer for ``name``."""
        buf = self.host.get(name)
        if buf is None or buf.numel() < arr.nbytes:
            buf = self.host[name] = torch.empty(
                max(arr.nbytes, 1), dtype=torch.uint8, pin_memory=True
            )
        src = host_tensor(arr)  # bfloat16 words as torch.bfloat16
        view = buf[: arr.nbytes].view(src.dtype).view(src.shape)
        view.copy_(src)
        return view

    def donated(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """This slot's device buffer for ``name``, shaped as ``like``."""
        nbytes = like.numel() * like.element_size()
        buf = self.dev.get(name)
        if buf is None or buf.numel() < nbytes:
            buf = self.dev[name] = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                               device=self.device)
        return buf[:nbytes].view(like.dtype).view(like.shape)


class CUDAChannel(StagedChannel):
    """Single-device in-process serving channel (see module docstring)."""

    def __init__(
        self,
        repository: ModelRepository,
        device: str | torch.device | None = None,
        **kwargs,
    ) -> None:
        """``device``: ``cuda`` unless the caller passes ``cpu``. The other
        arguments are ``StagedChannel``'s (``pipeline_depth``,
        ``shed_expired``, ``breaker_threshold``, ``breaker_reset_s``)."""
        self._free_slots: list[_StagingSlot] = []
        self._slots_lock = threading.Lock()
        super().__init__(repository, resolve_device(device), **kwargs)

    # -- placement --------------------------------------------------------------

    def _take_slot(self) -> _StagingSlot:
        with self._slots_lock:
            if self._free_slots:
                return self._free_slots.pop()
        return _StagingSlot(self.device)

    def _give_slot(self, slot: _StagingSlot) -> None:
        with self._slots_lock:
            self._free_slots.append(slot)

    def _wire_arrays(self, model, request) -> dict[str, np.ndarray]:
        # np.require, not np.ascontiguousarray: that one turns a 0-d array
        # (num_points) into shape (1,)
        return {
            name: np.require(cast_wire_input(model, name, np.asarray(arr)),
                             requirements="C")
            for name, arr in request.inputs.items()
        }

    def _upload(self, arrays: dict[str, np.ndarray], donate_names=frozenset()):
        """``arrays`` on the device (see module docstring); returns (device
        inputs, the staging slot or None)."""
        if self.device.type != "cuda":
            # a read-only wire view (the KServe codec's np.frombuffer) is
            # copied: a tensor over it could not be written safely
            return {k: host_tensor(v if v.flags.writeable else v.copy())
                    for k, v in arrays.items()}, None
        slot = self._take_slot()
        try:
            if slot.used:
                slot.copied.synchronize()  # the pinned buffers are free again
            stream = torch.cuda.current_stream(self.device)
            staged = {}
            for name, arr in arrays.items():
                host = slot.pinned(name, arr)
                if name in donate_names:
                    if slot.used:
                        stream.wait_event(slot.consumed)
                    dev = slot.donated(name, host)
                    dev.copy_(host, non_blocking=True)
                else:
                    dev = host.to(self.device, non_blocking=True)
                staged[name] = dev
            slot.copied.record(stream)
            slot.used = True
        except BaseException:
            self._give_slot(slot)
            raise
        return staged, slot

    def _place_inputs(self, model, request):
        return self._upload(self._wire_arrays(model, request), self._donate_names(model))

    def _place_ragged(self, model, request):
        if SEGMENT_IDS_KEY in request.inputs:
            raise ValueError(f"input name {SEGMENT_IDS_KEY!r} is reserved")
        for t in model.spec.inputs:
            if t.name not in request.inputs:
                raise KeyError(f"model '{model.spec.name}' needs input '{t.name}'")
        arrays = self._wire_arrays(model, request)
        arrays[SEGMENT_IDS_KEY] = np.ascontiguousarray(request.ragged.segment_ids, dtype=np.int32)
        staged, slot = self._upload(arrays)
        if slot is not None:
            self._give_slot(slot)  # nothing donated: the copies' event guards reuse
        return staged, request.ragged

    def _consumed(self, staged: StagedRequest) -> None:
        slot = staged.meta
        if isinstance(slot, _StagingSlot):
            staged.meta = None
            slot.consumed.record(torch.cuda.current_stream(self.device))
            self._give_slot(slot)

    def _record_done(self):
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    # -- launcher ---------------------------------------------------------------

    def _donate_names(self, model) -> frozenset:
        if model.device_fn is None:
            return frozenset()
        return frozenset(model.spec.donatable_inputs())

    def _make_launcher(self, model):
        """A ``CapturedFunction`` over the model's ``device_fn``, called
        with the spec's inputs in the spec's order."""
        device_fn = model.device_fn
        names = tuple(t.name for t in model.spec.inputs)

        def body(*tensors):
            return device_fn(dict(zip(names, tensors)))

        captured = CapturedFunction(body, f"{model.spec.name}:{model.spec.version}")

        def launcher(device_inputs):
            return captured(*(device_inputs[n] for n in names))

        launcher.graphs = captured
        return launcher, self._donate_names(model), _wire_dtypes(model.spec)
