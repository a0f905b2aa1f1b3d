"""Streaming-session state: per-stream tracking slots kept on the device
(port of ``runtime/sessions.py``).

A :class:`SessionManager` owns a bounded pool of per-stream slots, each
holding the tracker state of ``ops/tracking.py`` on the channel's device
between frames, and the tracker's captured steps (``ops/tracking.
TrackerStep``, one CUDA graph a key): they belong to the manager, not to a
model, so a detector's page-out (``runtime/lifecycle.py``) leaves them
alone and no model's cost counts them. On the steady-state path nothing
crosses the host boundary (the card's check runs ``advance``/``release``
under ``torch.cuda.set_sync_debug_mode("error")``).

Wiring (the ``sequence_id`` thread): clients set the ``sequence_id`` /
``sequence_start`` / ``sequence_end`` request parameters
(``channel/kserve/codec.py``), the servicer decodes them onto the
``InferRequest``, the batchers dispatch session frames alone (state depends
on frame order), and ``StagedChannel.launch`` calls :meth:`SessionManager.
advance` on the launch's device outputs, on the launch stream and inside
its device window. ``advance`` takes a reference on the slot; ``release``
(from the launch's resolve, success or failure) drops it, so TTL or LRU
reclaim never frees a slot with a launch in flight.

Slot reclaim follows ``runtime/lifecycle.py``'s eviction ladder: ended
slots first, then TTL-expired, then LRU, always ``refs == 0`` only; a full
pool with every slot in flight rejects the new stream with
:class:`SessionLimitError` (``RESOURCE_EXHAUSTED`` on the wire).

Track ids are int32 ``namespace(4b) | epoch(11b) | local(16b)``:
``namespace`` tells replicas apart (``serve --session-id-namespace``) and
``epoch`` grows on every session (re)start, so a restarted stream mints
ids disjoint from its previous life's. 16 local bits bound one session
life at 65k track births; 11 epoch bits wrap at 2048 lives per process.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import torch

from triton_client_tpu_torch.ops import tracking
from triton_client_tpu_torch.runtime.admission import AdmissionRejectedError


class SessionLimitError(AdmissionRejectedError):
    """Session pool full and nothing reclaimable: ``RESOURCE_EXHAUSTED``
    (non-retryable overload), like every admission reject."""


#: output tensors ``advance`` consumes from the detector launch
DET_KEY = "detections"
VALID_KEY = "valid"

_NAMESPACE_BITS = 4
_EPOCH_BITS = 11
_LOCAL_BITS = 16


def id_base_for(namespace: int, epoch: int) -> int:
    """int32-positive id floor for one session life (module docstring)."""
    ns = int(namespace) & ((1 << _NAMESPACE_BITS) - 1)
    ep = int(epoch) & ((1 << _EPOCH_BITS) - 1)
    return (ns << (_EPOCH_BITS + _LOCAL_BITS)) | (ep << _LOCAL_BITS)


@dataclasses.dataclass
class _Slot:
    stream_id: str
    epoch: int
    id_base: int
    state: dict | None = None  # device tensors, built on the first frame
    group: int = 0  # 0 single-frame; >0 synchronized-camera group size
    refs: int = 0
    frames: int = 0
    ended: bool = False
    created: float = 0.0
    last_used: float = 0.0
    # serializes the per-frame step: frames of one stream advance in order
    # even if a client pipelines requests
    step_lock: threading.Lock = dataclasses.field(default_factory=threading.Lock, repr=False)


class SessionManager:
    """Bounded pool of device-resident streaming-session slots.

    ``tracker``: the ``ops/tracking.py`` config every session runs.
    ``id_namespace``: the replica's 4-bit id prefix. ``time_fn``: the clock
    (tests drive TTL with their own)."""

    def __init__(
        self,
        max_sessions: int = 64,
        ttl_s: float = 60.0,
        tracker: tracking.TrackerConfig | None = None,
        id_namespace: int = 0,
        time_fn=time.monotonic,
    ) -> None:
        self.tracker = tracker or tracking.TrackerConfig()
        self._max = max(1, int(max_sessions))
        self._ttl_s = float(ttl_s)
        self._namespace = int(id_namespace)
        self._time = time_fn
        self._lock = threading.Lock()
        self._slots: dict[str, _Slot] = {}
        # (config, group, coast) -> the TrackerStep owning those graphs
        self._steps: dict[tuple, tracking.TrackerStep] = {}
        # dead sessions' states awaiting a counter fold (device reads
        # deferred to stats(); see _drain_folds)
        self._dead_states: list = []
        self._epochs = 0
        # host counters; the device birth/death totals fold in when a
        # session ends or restarts (one read a session life, never on the
        # steady-state frame path)
        self._created = 0
        self._restarted = 0
        self._expired = 0
        self._reclaimed = 0
        self._rejected = 0
        self._ended = 0
        self._frames = 0
        self._coasted = 0
        self._births_total = 0
        self._deaths_total = 0

    # -- pool bookkeeping (locked) --------------------------------------------

    def _next_epoch_locked(self) -> int:
        self._epochs += 1
        return self._epochs

    def _make_room_locked(self, now: float) -> None:
        """Free one refs == 0 slot: ended > TTL-expired > LRU. Raises
        SessionLimitError when every slot has work in flight."""
        if len(self._slots) < self._max:
            return
        idle = [s for s in self._slots.values() if s.refs == 0]
        victim = next((s for s in idle if s.ended), None)
        if victim is None and self._ttl_s > 0:
            victim = next((s for s in idle if now - s.last_used > self._ttl_s), None)
            if victim is not None:
                self._expired += 1
        if victim is None and idle:
            victim = min(idle, key=lambda s: s.last_used)
            self._reclaimed += 1
        if victim is None:
            self._rejected += 1
            raise SessionLimitError(f"session pool full ({self._max} slots, all in flight)")
        del self._slots[victim.stream_id]
        self._fold_async_locked(victim)

    def _fold_async_locked(self, slot: _Slot) -> None:
        """Queue a dead slot's device counters for the next fold (the caller
        holds the pool lock); the device read happens later, off the lock
        and off the frame path."""
        if slot.state is not None:
            self._dead_states.append(slot.state)

    def _drain_folds(self) -> None:
        """Fold queued dead sessions' device birth/death counters into the
        host totals, summed over a group's cameras. Device reads: never
        called from ``advance``/``release``, only from ``stats()`` and
        ``end()``."""
        while True:
            with self._lock:
                if not self._dead_states:
                    return
                state = self._dead_states.pop()
            births = int(state["births"].sum())
            deaths = int(state["deaths"].sum())
            with self._lock:
                self._births_total += births
                self._deaths_total += deaths

    # -- the frame bracket ----------------------------------------------------

    def advance(self, request, outputs):
        """Run one tracking step on a detector launch's device outputs.

        Called from ``StagedChannel.launch`` with the launch's output dict;
        returns it extended with the track tensors. Takes a reference on
        the slot: the caller pairs it with :meth:`release` (the launch's
        resolve does, on success and failure alike). Device work only: one
        graph replay over tensors already on the card."""
        sid = request.sequence_id
        now = self._time()
        with self._lock:
            slot = self._slots.get(sid)
            if slot is None:
                self._make_room_locked(now)
                epoch = self._next_epoch_locked()
                slot = _Slot(stream_id=sid, epoch=epoch,
                             id_base=id_base_for(self._namespace, epoch),
                             created=now, last_used=now)
                self._slots[sid] = slot
                self._created += 1
            elif request.sequence_start or slot.ended:
                # clean in-place restart: a fresh epoch, disjoint ids
                self._fold_async_locked(slot)
                slot.epoch = self._next_epoch_locked()
                slot.id_base = id_base_for(self._namespace, slot.epoch)
                slot.state = None
                slot.group = 0
                slot.frames = 0
                slot.ended = False
                slot.created = now
                self._restarted += 1
            slot.refs += 1
            slot.last_used = now
        try:
            out = self._step(slot, outputs)
        except Exception:
            with self._lock:
                slot.refs -= 1
            raise
        if request.sequence_end:
            with self._lock:
                slot.ended = True
                self._ended += 1
        return out

    def _cfg_for(self, det_dim: int) -> tracking.TrackerConfig:
        """The tracker config for this model's row width. The default carries
        CenterPoint's ``velocity_cols=(7, 9)``; a 2D detector's 6-column
        rows hold no velocity, so the window narrows to None (a width-0
        ``z_vel`` would break the update). Rows of 9 or more columns keep
        it, as in the JAX package."""
        cfg = self.tracker
        if cfg.velocity_cols is not None and det_dim < cfg.velocity_cols[1]:
            cfg = dataclasses.replace(cfg, velocity_cols=None)
        return cfg

    def _step_fn(self, cfg, group: bool, coast: bool) -> tracking.TrackerStep:
        key = (cfg, group, coast)
        with self._lock:
            fn = self._steps.get(key)
            if fn is None:
                fn = self._steps[key] = tracking.TrackerStep(cfg, group=group, coast=coast)
            return fn

    def _step(self, slot: _Slot, outputs):
        det = outputs.get(DET_KEY)
        valid = outputs.get(VALID_KEY)
        if det is None or valid is None:
            return outputs  # the model has no tracking-compatible head
        det_dim = int(det.shape[-1])
        cfg = self._cfg_for(det_dim)
        with slot.step_lock:
            if det.ndim == 3:
                # leading dim = a synchronized camera group (B == 1 is a
                # group of one): the group step over stacked state
                group = int(det.shape[0])
                if slot.state is None:
                    base = tracking.init_state(cfg, det_dim, slot.id_base)
                    # disjoint per-camera id ranges: the session's 16-bit
                    # local id space split evenly across the group
                    span = (1 << _LOCAL_BITS) // group
                    stacked = {k: torch.stack([v] * group) for k, v in base.items()}
                    stacked["next_id"] = torch.tensor(
                        [slot.id_base + 1 + c * span for c in range(group)], dtype=torch.int32)
                    slot.state = {k: v.to(det.device) for k, v in stacked.items()}
                    slot.group = group
                elif slot.group != group:
                    raise ValueError(
                        f"stream '{slot.stream_id}': camera-group size changed mid-stream "
                        f"({slot.group} -> {group})")
                step = self._step_fn(cfg, True, False)
            else:
                if slot.state is None:
                    base = tracking.init_state(cfg, det_dim, slot.id_base)
                    slot.state = {k: v.to(det.device) for k, v in base.items()}
                    slot.group = 0
                step = self._step_fn(cfg, False, False)
            new_state, track_out = step(slot.state, det, valid)
            slot.state = new_state
            slot.frames += 1
        with self._lock:
            self._frames += 1
        out = dict(outputs)
        out.update(track_out)
        return out

    def coast(self, request):
        """Advance one frame by the Kalman predict alone (the detector is
        skipped: ``runtime/temporal.py`` decided the frame is redundant).
        Returns the coast outputs (the track table), or None when the stream
        has no state yet: a coast before the first keyframe means nothing,
        and the caller runs the detector. Same reference contract as
        :meth:`advance`: pair it with :meth:`release`."""
        sid = request.sequence_id
        now = self._time()
        with self._lock:
            slot = self._slots.get(sid)
            if slot is None or slot.state is None or slot.ended or request.sequence_start:
                return None
            slot.refs += 1
            slot.last_used = now
        try:
            with slot.step_lock:
                if slot.state is None:  # a reset raced us
                    with self._lock:
                        slot.refs -= 1
                    return None
                # the det-width-narrowed config of _step, so a stream's coast
                # shares its keyframe step's config
                cfg = self._cfg_for(int(slot.state["box"].shape[-1]))
                coast = self._step_fn(cfg, bool(slot.group), True)
                new_state, track_out = coast(slot.state)
                slot.state = new_state
                slot.frames += 1
        except Exception:
            with self._lock:
                slot.refs -= 1
            raise
        with self._lock:
            self._frames += 1
            self._coasted += 1
        if request.sequence_end:
            with self._lock:
                slot.ended = True
                self._ended += 1
        return dict(track_out)

    def release(self, stream_id: str) -> None:
        """Drop the reference :meth:`advance` took. An ended slot frees (and
        queues its counters for the next fold) once its last reference
        drops."""
        with self._lock:
            slot = self._slots.get(stream_id)
            if slot is None:
                return
            slot.refs = max(0, slot.refs - 1)
            if slot.ended and slot.refs == 0:
                del self._slots[stream_id]
                self._fold_async_locked(slot)

    def end(self, stream_id: str) -> None:
        """End a session explicitly (server drain, client abort)."""
        with self._lock:
            slot = self._slots.get(stream_id)
            if slot is None:
                return
            slot.ended = True
            if slot.refs == 0:
                del self._slots[stream_id]
                self._fold_async_locked(slot)
        self._drain_folds()

    def reset(self) -> None:
        """Drop every session (drain, shutdown). Launches in flight keep their
        state tensors alive; new frames restart."""
        with self._lock:
            slots = list(self._slots.values())
            self._slots.clear()
            for s in slots:
                self._fold_async_locked(s)

    # -- observability --------------------------------------------------------

    def stats(self) -> dict:
        """Pool counters for the collector. Folds the queued dead sessions'
        device counters first (device reads at scrape time only)."""
        self._drain_folds()
        with self._lock:
            active = len(self._slots)
            inflight = sum(s.refs for s in self._slots.values())
            return {
                "active_sessions": active,
                "max_sessions": self._max,
                "slot_occupancy": active / self._max,
                "inflight_frames": inflight,
                "created_total": self._created,
                "restarted_total": self._restarted,
                "ended_total": self._ended,
                "expired_total": self._expired,
                "reclaimed_total": self._reclaimed,
                "rejected_total": self._rejected,
                "frames_total": self._frames,
                "coast_frames_total": self._coasted,
                "track_births_total": self._births_total,
                "track_deaths_total": self._deaths_total,
            }
