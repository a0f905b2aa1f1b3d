"""Multi-object tracking on the device: Kalman + greedy association (port
of ``ops/tracking.py``).

The per-frame step (constant-velocity Kalman predict, two-stage
ByteTrack-style greedy association, update, births and deaths) is one
function over fixed-shape tensors (``max_tracks`` slots, the detector's
``max_det`` rows), so the session layer (``runtime/sessions.py``) chains it
after a detector launch and keeps the track state on the card between
frames.

- **One body over a group axis.** :func:`_step` and :func:`_coast` take
  every tensor with a leading group axis ``G >= 1`` (C synchronized
  cameras of one session, ``drivers/multicam.py`` in the JAX package); the
  single-stream step is the body at ``G = 1``. JAX's ``vmap`` has no
  cheaper counterpart than that explicit axis.
- **Two forms of the body**, as JAX's ``xp`` switch has two. The card's
  form (``plain=False``) is tensor code with no host read: no ``int()`` or
  ``.item()`` of a tensor and no Python ``if`` on one; :func:`greedy_assign`'s
  ``trips`` masked argmaxes are ``torch.where`` selections and scatters, as
  JAX's ``fori_loop`` body is. The plain form (``plain=True``, JAX's
  ``xp is np`` branch) reads the argmax back every trip and places births
  through ``nonzero``; it runs on CPU tensors only and is the oracle
  (:func:`reference_step`, :func:`reference_coast`).
- **Captured.** :func:`make_step` and its siblings (JAX's ``jax.jit``) wrap
  the card's form in a ``runtime/graphs.CapturedFunction``: one CUDA graph
  a key of (config, detection shape, group). Eager, one CenterPoint frame
  is 2 stages x 64 trips x 5 launches and ~150 more; replayed, it is one
  graph launch, and a slot's state is copied into the graph's inputs and
  the new state out of its outputs on the launch stream. On CPU tensors the
  wrapper runs the card's form eagerly.
- **Bitwise.** Both forms take the first maximum row-major on ties
  (``torch.max`` over the flattened matrix, as ``np.argmax`` and
  ``jnp.argmax``) and rank a NaN as the maximum, keep every id, rank and
  counter in int32, and round every constant to float32 before it meets a
  tensor, so ids and associations equal the JAX reference bitwise.

Detection rows follow ``ops/detect3d_postprocess.py``'s packed convention
``[x, y, ..., score, label]``: centres are columns 0:2, the score column
-2. Track ids are int32, positive, offset by the session layer's
``id_base`` so they never alias across session restarts.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from triton_client_tpu_torch.runtime.graphs import CapturedFunction

#: Gated / impossible affinity. Large-negative finite (not -inf) so an
#: argmax over an all-gated matrix still returns index 0 and the validity
#: check ``best > GATED / 2`` stays well-defined in float32.
GATED = float(np.float32(-1e18))
_HALF_GATED = float(np.float32(-1e18) / np.float32(2))


def _f32(x) -> float:
    """A config constant rounded to float32, as ``np.float32`` rounds it."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Static tracker shape and policy; hashable, so one capture set a config."""

    max_tracks: int = 64
    #: ByteTrack score split: >= high associates in stage 1 (and may found
    #: new tracks); [low, high) only rescues existing tracks
    score_high: float = 0.5
    score_low: float = 0.1
    #: stage-1 association gate, centre distance (world units)
    gate_dist: float = 5.0
    #: stage-2 (low-score rescue) gate, tighter
    gate_dist_low: float = 2.5
    #: Mahalanobis gate on the position innovation (chi-square, 2 dof,
    #: p=0.01 -> 9.21); <= 0 disables the statistical gate
    gate_maha2: float = 9.21
    #: consecutive missed frames before a track slot frees
    max_age: int = 3
    dt: float = 1.0
    #: process noise added per predict (position / velocity variance)
    q_pos: float = 0.1
    q_vel: float = 0.1
    #: measurement noise (position; velocity when measured)
    r_pos: float = 0.5
    r_vel: float = 1.0
    #: initial covariance of a newborn track
    p0_pos: float = 1.0
    p0_vel: float = 10.0
    #: detection columns holding measured (vx, vy): CenterPoint's velocity
    #: head rides columns 7:9 of the packed row; None = no measured velocity
    velocity_cols: tuple | None = (7, 9)

    def __post_init__(self):
        if self.velocity_cols is not None:
            a, b = self.velocity_cols
            if b - a != 2:
                raise ValueError("velocity_cols must span exactly 2 columns")


#: state-dict leaves, all fixed-shape: the session layer keeps exactly
#: these tensors on the device between frames
STATE_KEYS = (
    "mean", "cov", "box", "tid", "age", "hits",
    "next_id", "frame", "births", "deaths",
)

#: output tensor names the session hook adds to a response
OUTPUT_KEYS = (
    "tracks", "track_ids", "tracks_valid", "track_assign", "det_track_ids",
    "innovation",
)

#: outputs a coast (predict-only) frame produces: the track table only
COAST_OUTPUT_KEYS = ("tracks", "track_ids", "tracks_valid")


def init_state(cfg: TrackerConfig, det_dim: int, id_base: int = 0) -> dict[str, torch.Tensor]:
    """Fresh tracker state for one stream, as CPU tensors (the session layer
    moves it to the detections' device). ``id_base`` offsets every id this
    state will mint."""
    t = int(cfg.max_tracks)
    return {
        # [x, y, vx, vy] per slot
        "mean": torch.zeros((t, 4), dtype=torch.float32),
        # per-axis 2x2 covariance packed [p00, p01, p11] (x/y share it)
        "cov": torch.zeros((t, 3), dtype=torch.float32),
        # last matched detection row, centre/velocity refreshed from the mean
        "box": torch.zeros((t, int(det_dim)), dtype=torch.float32),
        "tid": torch.zeros((t,), dtype=torch.int32),  # 0 = free slot
        "age": torch.zeros((t,), dtype=torch.int32),
        "hits": torch.zeros((t,), dtype=torch.int32),
        "next_id": torch.tensor(int(id_base) + 1, dtype=torch.int32),
        "frame": torch.tensor(0, dtype=torch.int32),
        "births": torch.tensor(0, dtype=torch.int32),
        "deaths": torch.tensor(0, dtype=torch.int32),
    }


def _check_plain(*tensors: torch.Tensor) -> None:
    for x in tensors:
        if x.device.type != "cpu":
            raise ValueError(
                f"the plain tracker runs on CPU tensors only, got one on {x.device}")


# -- association ---------------------------------------------------------------


def greedy_assign(cost: torch.Tensor, trips: int, plain: bool = False):
    """Greedy one-to-one matching over a (T, N) or (G, T, N) affinity matrix.

    ``trips`` masked global argmaxes: take the best remaining (track, det)
    pair, bind it, blank its row and column. Returns ``(track_det,
    det_track)`` in int32: per-track matched detection index and
    per-detection matched track slot, -1 where unmatched.

    ``plain``: JAX's ``np`` branch, a host loop reading each argmax (CPU
    tensors only). Otherwise the card's form, five launches a trip (the
    max, the pair's row and column, the two blanking scatters) and no host
    read. It blanks the pair of every trip, bound or not, and keeps each
    trip's best value; a pair is bound where that value is above
    ``GATED / 2``. That is the loop's result: blanking only lowers
    entries, so after the first trip whose best is not above ``GATED / 2``
    no later trip's is, and the loop binds nothing more. A NaN ranks as the
    maximum, so the loop's first trip takes the first NaN, binds nothing,
    and every later trip takes it again: a group whose matrix holds a NaN
    binds nothing, and the card's form runs its trips with the NaNs
    GATED."""
    single = cost.ndim == 2
    if single:
        cost = cost[None]
    g, t, n = cost.shape
    if plain:
        _check_plain(cost)
        cost = cost.clone()
        track_det = torch.full((g, t), -1, dtype=torch.int32)
        det_track = torch.full((g, n), -1, dtype=torch.int32)
        for gi in range(g):
            c = cost[gi]
            for _ in range(trips):
                flat = int(torch.argmax(c))
                ti, di = flat // n, flat % n
                if c[ti, di] > _HALF_GATED:
                    track_det[gi, ti] = di
                    det_track[gi, di] = ti
                    c[ti, :] = GATED
                    c[:, di] = GATED
    else:
        nan = torch.isnan(cost)
        work = torch.where(nan, GATED, cost).contiguous()
        flat_work = work.view(g, t * n)
        bests, picks = [], []
        for _ in range(trips):
            best, flat = torch.max(flat_work, dim=1)
            ti = torch.div(flat, n, rounding_mode="floor")
            di = torch.remainder(flat, n)
            work.scatter_(1, ti.view(g, 1, 1).expand(g, 1, n), GATED)
            work.scatter_(2, di.view(g, 1, 1).expand(g, t, 1), GATED)
            bests.append(best)
            picks.append(flat)
        # (G, trips): an unbound trip writes into a junk column past the end
        track_det = torch.full((g, t + 1), -1, dtype=torch.int64, device=cost.device)
        det_track = torch.full((g, n + 1), -1, dtype=torch.int64, device=cost.device)
        if trips:
            flat = torch.stack(picks, 1)
            bound = (torch.stack(bests, 1) > _HALF_GATED) & ~nan.view(g, -1).any(1, keepdim=True)
            ti = torch.div(flat, n, rounding_mode="floor")
            di = torch.remainder(flat, n)
            track_det.scatter_(1, torch.where(bound, ti, t), di)
            det_track.scatter_(1, torch.where(bound, di, n), ti)
        track_det = track_det[:, :t].to(torch.int32)
        det_track = det_track[:, :n].to(torch.int32)
    if single:
        return track_det[0], det_track[0]
    return track_det, det_track


def _affinity(cfg, mean, cov, tid, centers, det_mask, gate_dist):
    """Negative squared centre distance, gated on distance and (when enabled)
    the Mahalanobis position innovation. (G, T, N): rows track slots,
    columns detections; inactive slots and masked detections are GATED."""
    dx = mean[:, :, 0:1] - centers[:, None, :, 0]
    dy = mean[:, :, 1:2] - centers[:, None, :, 1]
    d2 = dx * dx + dy * dy
    gated = d2 > _f32(float(gate_dist) ** 2)
    if cfg.gate_maha2 > 0:
        # per-axis innovation variance post-predict: S = p00 + r
        s = cov[:, :, 0:1] + _f32(cfg.r_pos)
        gated = gated | (d2 / s > _f32(cfg.gate_maha2))
    keep = (tid > 0)[:, :, None] & det_mask[:, None, :] & ~gated
    return torch.where(keep, -d2, GATED)


# -- Kalman (decoupled per-axis scalar blocks) ---------------------------------


def _predict(cfg, mean, cov):
    dt = _f32(cfg.dt)
    dt2 = float(np.float32(dt) * np.float32(dt))
    x, y, vx, vy = mean.unbind(-1)
    p00, p01, p11 = cov.unbind(-1)
    x = x + vx * dt
    y = y + vy * dt
    n00 = p00 + dt * (p01 + p01) + dt2 * p11 + _f32(cfg.q_pos)
    n01 = p01 + dt * p11
    n11 = p11 + _f32(cfg.q_vel)
    return torch.stack([x, y, vx, vy], -1), torch.stack([n00, n01, n11], -1)


def _update(cfg, mean, cov, z_pos, z_vel, matched):
    """Scalar-gain update per axis for matched slots; unmatched slots pass
    through untouched. ``z_vel`` is None without a velocity head."""
    x, y, vx, vy = mean.unbind(-1)
    p00, p01, p11 = cov.unbind(-1)
    s = p00 + _f32(cfg.r_pos)
    k0 = p00 / s
    k1 = p01 / s
    ix = z_pos[..., 0] - x
    iy = z_pos[..., 1] - y
    ux, uy = x + k0 * ix, y + k0 * iy
    uvx, uvy = vx + k1 * ix, vy + k1 * iy
    u00 = (1.0 - k0) * p00
    u01 = (1.0 - k0) * p01
    u11 = p11 - k1 * p01
    if z_vel is not None:
        sv = u11 + _f32(cfg.r_vel)
        kv = u11 / sv
        uvx = uvx + kv * (z_vel[..., 0] - uvx)
        uvy = uvy + kv * (z_vel[..., 1] - uvy)
        u11 = (1.0 - kv) * u11
    m = matched
    mean = torch.stack([torch.where(m, ux, x), torch.where(m, uy, y),
                        torch.where(m, uvx, vx), torch.where(m, uvy, vy)], -1)
    cov = torch.stack([torch.where(m, u00, p00), torch.where(m, u01, p01),
                       torch.where(m, u11, p11)], -1)
    return mean, cov


# -- birth bookkeeping ---------------------------------------------------------


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(G, N, C) rows gathered by (G, T) indices -> (G, T, C)."""
    return torch.take_along_dim(x, idx.long()[:, :, None], dim=1)


def _scatter_births(plain, t, n, takes, free_rank, placed, born_rank):
    """Order-preserving one-to-one map between taking slots and placed
    detections: the rank-i free slot receives the rank-i newborn. Returns
    ``(slot_det, det_slot)``, (G, T) and (G, N) int32: per-slot detection
    index (0 on non-taking slots) and per-detection slot index (0 where not
    placed). Every rank below the birth count has exactly one writer."""
    g = takes.shape[0]
    if plain:
        slot_det = torch.zeros((g, t), dtype=torch.int32)
        det_slot = torch.zeros((g, n), dtype=torch.int32)
        for gi in range(g):
            det_ids = torch.nonzero(placed[gi])[:, 0].to(torch.int32)
            slot_ids = torch.nonzero(takes[gi])[:, 0].to(torch.int32)
            slot_det[gi, slot_ids.long()] = det_ids
            det_slot[gi, det_ids.long()] = slot_ids
        return slot_det, det_slot
    # the rank tables carry one junk column (index t) where the writes of
    # non-placed / non-taking entries land; it is never read
    dev = takes.device
    rank_det = torch.zeros((g, t + 1), dtype=torch.int32, device=dev)
    rank_det.scatter_(1, torch.where(placed, born_rank, t).long(),
                      torch.where(placed, torch.arange(n, dtype=torch.int32, device=dev), 0))
    rank_slot = torch.zeros((g, t + 1), dtype=torch.int32, device=dev)
    rank_slot.scatter_(1, torch.where(takes, free_rank, t).long(),
                       torch.where(takes, torch.arange(t, dtype=torch.int32, device=dev), 0))
    slot_det = torch.where(takes, rank_det.gather(1, torch.where(takes, free_rank, 0).long()), 0)
    det_slot = torch.where(placed, rank_slot.gather(1, torch.where(placed, born_rank, 0).long()), 0)
    return slot_det, det_slot


# -- the per-frame step --------------------------------------------------------


def _refresh_box(cfg, box, mean):
    """The reported row's centre (and velocity columns, when present) from
    the fused mean."""
    box = torch.cat([mean[..., 0:2], box[..., 2:]], -1)
    if cfg.velocity_cols is not None and box.shape[-1] >= cfg.velocity_cols[1]:
        a = cfg.velocity_cols[0]
        box = torch.cat([box[..., :a], mean[..., 2:4], box[..., a + 2:]], -1)
    return box


def _step(plain: bool, cfg: TrackerConfig, state, detections, valid):
    """One tracking frame over a group axis. ``detections``: (G, N, D)
    packed rows, ``valid``: (G, N). Returns (new_state, outputs); outputs
    carry the full track table plus the per-detection association
    (``track_assign``) the parity tests compare bitwise."""
    t = int(cfg.max_tracks)
    detections = detections.to(torch.float32)
    g, n = int(detections.shape[0]), int(detections.shape[1])
    valid = valid.to(torch.bool)
    score = detections[..., -2]
    centers = detections[..., 0:2]
    high = valid & (score >= _f32(cfg.score_high))
    low = valid & ~high & (score >= _f32(cfg.score_low))

    mean, cov = _predict(cfg, state["mean"], state["cov"])

    trips = min(t, n)
    # stage 1: confident detections, wide gate
    cost1 = _affinity(cfg, mean, cov, state["tid"], centers, high, cfg.gate_dist)
    td1, dt1 = greedy_assign(cost1, trips, plain)
    # stage 2: still-unmatched tracks rescue low-score detections, tighter gate
    tid2 = torch.where(td1 >= 0, 0, state["tid"])
    cost2 = _affinity(cfg, mean, cov, tid2, centers, low, cfg.gate_dist_low)
    td2, dt2 = greedy_assign(cost2, trips, plain)

    track_det = torch.where(td1 >= 0, td1, td2)
    det_track = torch.where(dt1 >= 0, dt1, dt2)
    matched = track_det >= 0
    gather = torch.where(matched, track_det, 0)

    z_pos = _rows(centers, gather)
    z_vel = None
    if cfg.velocity_cols is not None:
        a, b = cfg.velocity_cols
        z_vel = _rows(detections[..., a:b], gather)

    # scene-dynamics statistic for the temporal-reuse scheduler: mean
    # normalized position innovation over matched tracks, each unmatched
    # HIGH detection charged the full gate (computed pre-update)
    ivx = z_pos[..., 0] - mean[..., 0]
    ivy = z_pos[..., 1] - mean[..., 1]
    i_s = cov[..., 0] + _f32(cfg.r_pos)
    i_d2 = ivx * ivx + ivy * ivy
    newborn_stat = high & (det_track < 0)
    gate_full = _f32(cfg.gate_maha2 if cfg.gate_maha2 > 0 else 9.21)
    n_match_f = matched.to(torch.float32).sum(-1)
    n_new_f = newborn_stat.to(torch.float32).sum(-1)
    innov_sum = torch.where(matched, i_d2 / i_s, 0.0).sum(-1) + gate_full * n_new_f
    innovation = innov_sum / torch.clamp(n_match_f + n_new_f, min=1.0)

    mean, cov = _update(cfg, mean, cov, z_pos, z_vel, matched)

    # misses age; past max_age an active track's slot frees (and is
    # immediately reusable by this frame's births)
    active = state["tid"] > 0
    age = torch.where(matched, 0, state["age"] + 1)
    dead = active & ~matched & (age > int(cfg.max_age))
    tid = torch.where(dead, 0, state["tid"])
    hits = torch.where(matched, state["hits"] + 1, state["hits"])
    box = torch.where(matched[..., None], _rows(detections, gather), state["box"])

    # births: unmatched HIGH detections claim free slots, rank-i slot to
    # rank-i detection (both ascending)
    free = tid == 0
    newborn = high & (det_track < 0)
    free_rank = torch.cumsum(free.to(torch.int32), -1, dtype=torch.int32) - 1
    born_rank = torch.cumsum(newborn.to(torch.int32), -1, dtype=torch.int32) - 1
    n_born = torch.minimum(free.sum(-1, dtype=torch.int32), newborn.sum(-1, dtype=torch.int32))
    takes = free & (free_rank < n_born[:, None])
    placed = newborn & (born_rank < n_born[:, None])
    slot_det, det_slot = _scatter_births(plain, t, n, takes, free_rank, placed, born_rank)

    det_new = _rows(detections, slot_det)
    if cfg.velocity_cols is not None:
        a = cfg.velocity_cols[0]
        bvx, bvy = det_new[..., a], det_new[..., a + 1]
    else:
        bvx = bvy = torch.zeros_like(det_new[..., 0])
    b_mean = torch.stack([det_new[..., 0], det_new[..., 1], bvx, bvy], -1)
    b_cov = torch.stack([torch.full_like(bvx, _f32(cfg.p0_pos)), torch.zeros_like(bvx),
                         torch.full_like(bvx, _f32(cfg.p0_vel))], -1)
    new_ids = state["next_id"][:, None] + free_rank
    mean = torch.where(takes[..., None], b_mean, mean)
    cov = torch.where(takes[..., None], b_cov, cov)
    box = torch.where(takes[..., None], det_new, box)
    tid = torch.where(takes, new_ids, tid)
    age = torch.where(takes, 0, age)
    hits = torch.where(takes, 1, hits)

    box = _refresh_box(cfg, box, mean)

    new_state = {
        "mean": mean,
        "cov": cov,
        "box": box,
        "tid": tid,
        "age": age,
        "hits": hits,
        "next_id": state["next_id"] + n_born,
        "frame": state["frame"] + 1,
        "births": state["births"] + n_born,
        "deaths": state["deaths"] + dead.sum(-1, dtype=torch.int32),
    }
    # per-detection association: matched track slot, else newborn slot,
    # else -1
    assign_slot = torch.where(placed, det_slot, det_track)
    hit = assign_slot >= 0
    det_track_ids = torch.where(hit, tid.gather(1, torch.where(hit, assign_slot, 0).long()), -1)
    outputs = {
        "tracks": box,
        "track_ids": tid,
        "tracks_valid": tid > 0,
        "track_assign": assign_slot,
        "det_track_ids": det_track_ids,
        "innovation": innovation,
    }
    return new_state, outputs


def _coast(cfg: TrackerConfig, state):
    """One predict-only (coast) frame over a group axis: the
    constant-velocity prior advances every slot, covariance inflates by the
    process noise, the reported boxes are refreshed from the predicted mean.
    No association, update, births or deaths; ages and ids are untouched (a
    coast frame is a deliberate skip, not a miss). The same expression
    sequence as ``_step``'s predict and refresh stanzas."""
    mean, cov = _predict(cfg, state["mean"], state["cov"])
    box = _refresh_box(cfg, state["box"], mean)
    tid = state["tid"]
    new_state = dict(state)
    new_state.update(mean=mean, cov=cov, box=box, frame=state["frame"] + 1)
    outputs = {"tracks": box, "track_ids": tid, "tracks_valid": tid > 0}
    return new_state, outputs


# -- the captured steps ----------------------------------------------------------


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


class TrackerStep:
    """The card's form of one step kind, captured per input signature:
    ``step(state, detections, valid) -> (state, outputs)``, or
    ``coast(state) -> (state, outputs)``. ``group``: every tensor carries
    the leading group axis; otherwise the body runs at ``G = 1``. Each
    instance owns its graphs (``graphs``, a ``CapturedFunction``)."""

    def __init__(self, cfg: TrackerConfig, group: bool = False, coast: bool = False) -> None:
        self.cfg, self.group, self.coast = cfg, bool(group), bool(coast)
        kind = ("group_" if group else "") + ("coast" if coast else "step")
        self.graphs = CapturedFunction(self._body, f"tracker_{kind}")

    def _body(self, *leaves):
        if not self.group:
            leaves = tuple(x[None] for x in leaves)
        state = dict(zip(STATE_KEYS, leaves))
        if self.coast:
            new_state, outputs = _coast(self.cfg, state)
        else:
            new_state, outputs = _step(False, self.cfg, state, leaves[-2], leaves[-1])
        new_leaves = [new_state[k] for k in STATE_KEYS]
        if not self.group:
            new_leaves = [x[0] for x in new_leaves]
            outputs = {k: v[0] for k, v in outputs.items()}
        return new_leaves, outputs

    def __call__(self, state, detections=None, valid=None):
        args = [_as_tensor(state[k]) for k in STATE_KEYS]
        if not self.coast:
            args += [_as_tensor(detections), _as_tensor(valid)]
        new_leaves, outputs = self.graphs(*args)
        return dict(zip(STATE_KEYS, new_leaves)), outputs


@functools.lru_cache(maxsize=32)
def make_step(cfg: TrackerConfig) -> TrackerStep:
    """The captured step for one stream: (state, detections, valid) ->
    (state, outputs). Cached per config: one capture a (config, shape)."""
    return TrackerStep(cfg)


@functools.lru_cache(maxsize=32)
def make_group_step(cfg: TrackerConfig) -> TrackerStep:
    """The step over a leading session-group axis: C synchronized cameras
    advance as one replay."""
    return TrackerStep(cfg, group=True)


@functools.lru_cache(maxsize=32)
def make_coast_step(cfg: TrackerConfig) -> TrackerStep:
    """The captured predict-only step for one stream: (state,) -> (state,
    outputs)."""
    return TrackerStep(cfg, coast=True)


@functools.lru_cache(maxsize=32)
def make_group_coast(cfg: TrackerConfig) -> TrackerStep:
    """The coast step over a leading session-group axis."""
    return TrackerStep(cfg, group=True, coast=True)


def reference_step(cfg: TrackerConfig, state, detections, valid):
    """The plain step for one stream, on CPU tensors (JAX's ``np`` branch):
    the oracle the tests and the card's check hold the captured step to.
    Takes tensors or numpy arrays; returns CPU tensors."""
    leaves = [_as_tensor(state[k]) for k in STATE_KEYS]
    det, valid = _as_tensor(detections), _as_tensor(valid)
    _check_plain(*leaves, det, valid)
    new_state, outputs = _step(True, cfg, {k: v[None] for k, v in zip(STATE_KEYS, leaves)},
                               det[None], valid[None])
    return ({k: v[0] for k, v in new_state.items()}, {k: v[0] for k, v in outputs.items()})


def reference_coast(cfg: TrackerConfig, state):
    """The plain coast step for one stream, on CPU tensors."""
    leaves = [_as_tensor(state[k]) for k in STATE_KEYS]
    _check_plain(*leaves)
    new_state, outputs = _coast(cfg, {k: v[None] for k, v in zip(STATE_KEYS, leaves)})
    return ({k: v[0] for k, v in new_state.items()}, {k: v[0] for k, v in outputs.items()})
