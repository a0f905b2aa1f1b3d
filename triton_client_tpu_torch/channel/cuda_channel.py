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
  upload, and the model's ``ragged_fn`` runs at the layout's
  ``launch_segments`` through a ``CapturedFunction`` of its own for each
  segment bucket (``_make_ragged_launcher``), one graph a packed-row
  bucket, whose kernel-6 launches use a ticket buffer the graph owns
  (``ops/gpu_segment.owned_tickets``). The dead segment slots are sliced
  off the outputs whose leading dim is the segment bucket. Their inputs
  skip the per-tensor spec check.
- **Page-out** (``attach_lifecycle``, ``channel/staged.py``): an evicted
  model's graphs are released, then ``runtime/graphs.empty_cache`` hands
  their freed pools back to CUDA (the caching allocator would keep
  the blocks reserved for this process, and cannot release a dead pool
  while another thread captures). A model's cost is ``param_bytes`` plus
  the live bytes of its graph pools, noted after each capture. The
  weights stay on the card: a page-out frees graphs, not parameters.
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
from triton_client_tpu_torch.ops.gpu_segment import owned_tickets
from triton_client_tpu_torch.runtime.precision import host_tensor
from triton_client_tpu_torch.runtime.graphs import CapturedFunction, empty_cache
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

    # what warms up and captures the launchers' graphs (runtime/graphs):
    # None is CUDA graphs on the card and plain calls on the CPU
    graph_backend = None

    def __init__(
        self,
        repository: ModelRepository,
        device: str | torch.device | None = None,
        capture_ragged: bool = True,
        **kwargs,
    ) -> None:
        """``device``: ``cuda`` unless the caller passes ``cpu``.
        ``capture_ragged=False`` runs the packed route's ``ragged_fn``
        eagerly, the comparison leg of the tests and of the card's smoke
        run. The other arguments are ``StagedChannel``'s
        (``pipeline_depth``, ``shed_expired``, ``breaker_threshold``,
        ``breaker_reset_s``)."""
        self.capture_ragged = capture_ragged
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

    def _begin_window(self):
        """A timing event on the launch stream, just before the launcher
        (only while a ledger is attached): the launch's window starts when
        the card reaches it, so queueing behind an earlier launch is not in
        it. Every route goes through here: graph replays, the ragged
        route's graphs, a fused ensemble's one graph."""
        if self.device.type != "cuda":
            return super()._begin_window()
        start = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(self.device))
        return start

    def _end_window(self, start):
        """A timing event behind the launch, which is also the event its
        resolve waits on; the window is ``start.elapsed_time(end)``, on the
        card's clock."""
        if self.device.type != "cuda":
            return super()._end_window(start)
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(self.device))
        return end, lambda: start.elapsed_time(end) / 1e3

    def _after_page_out(self) -> None:
        if self.device.type == "cuda":
            empty_cache()

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

        captured = CapturedFunction(body, f"{model.spec.name}:{model.spec.version}",
                                    backend=self.graph_backend)

        def launcher(device_inputs):
            return captured(*(device_inputs[n] for n in names))

        launcher.graphs = captured
        return launcher, self._donate_names(model), _wire_dtypes(model.spec)

    def _make_ragged_launcher(self, model, num_segments: int):
        """A ``CapturedFunction`` over the model's ``ragged_fn`` at
        ``num_segments``, called with the packed inputs in name order and
        the segment ids last; each graph owns its kernel-6 tickets."""
        ragged_fn = model.ragged_fn
        names = tuple(t.name for t in model.spec.inputs)

        def body(*tensors):
            return ragged_fn(dict(zip(names, tensors)), tensors[-1], num_segments)

        if not self.capture_ragged:
            def eager(device_inputs):
                return body(*(device_inputs[n] for n in names), device_inputs[SEGMENT_IDS_KEY])

            return eager
        captured = CapturedFunction(
            body, f"{model.spec.name}:{model.spec.version}:ragged:{num_segments}",
            backend=self.graph_backend, capture_scope=owned_tickets,
        )

        def launcher(device_inputs):
            return captured(*(device_inputs[n] for n in names), device_inputs[SEGMENT_IDS_KEY])

        launcher.graphs = captured
        return launcher

    def ragged_graph_stats(self) -> dict:
        """``{segment bucket: CapturedFunction.stats()}`` of the cached
        ragged launchers (captures, replays and keys, a key a packed-row
        bucket), summed over models."""
        out: dict[int, dict] = {}
        with self._slot_cv:
            cached = [(k[3], v[1]) for k, v in self._launch_cache.items()
                      if len(k) == 4 and k[2] == "ragged"]
        for segments, launcher in cached:
            graphs = getattr(launcher, "graphs", None)
            if graphs is None:
                continue
            acc = out.setdefault(segments, {})
            for name, value in graphs.stats().items():
                acc[name] = acc.get(name, 0) + value
        return out
