"""The port's tracker (``ops/tracking.py``) against the JAX package's, on
the CPU.

Bars (JAX's own, ``tests/test_tracking.py``): ids, associations, the track
table's validity and every integer leaf of the state bitwise equal; float
leaves within 1e-5 (the largest difference seen here is 0: the port keeps
JAX's reference expression order). The port's plain step
(``reference_step``, JAX's ``np`` branch) and its card form (``make_step``,
run eagerly on CPU tensors) are each held to JAX's ``reference_step`` and to
the jitted ``make_step``, over seeded drives, a tie, a NaN centre, fully
gated frames, 6- and 9-column rows, groups, coasts and id namespaces.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_client_tpu.ops import tracking as jtr
from triton_client_tpu.runtime.sessions import id_base_for as jid_base_for

from triton_client_tpu_torch.ops import tracking as ttr
from triton_client_tpu_torch.runtime.sessions import id_base_for
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(max_tracks=8, max_age=2)
JCFG, TCFG = jtr.TrackerConfig(**KW), ttr.TrackerConfig(**KW)
DET_DIM = 11  # [x y z dx dy dz heading vx vy score label]
INT_KEYS = ("tid", "age", "hits", "next_id", "frame", "births", "deaths")
EXACT_OUT = ("track_assign", "det_track_ids", "track_ids", "tracks_valid")


def _frame(rows, det_dim=DET_DIM, n_slots=6):
    """(n_slots, det_dim) detections + valid mask from (x, y, vx, vy, score)."""
    det = np.zeros((n_slots, det_dim), np.float32)
    valid = np.zeros((n_slots,), bool)
    for i, (x, y, vx, vy, score) in enumerate(rows):
        det[i, 0], det[i, 1] = x, y
        det[i, 3:6] = (4.0, 2.0, 1.5)
        if det_dim >= 9:
            det[i, 7], det[i, 8] = vx, vy
        det[i, -2] = score
        det[i, -1] = 1.0
        valid[i] = True
    return det, valid


def _drive(n_frames=12, seed=0, n_objects=3, n_slots=6, det_dim=DET_DIM):
    """tests/test_tracking.py's scripted drive: movers with noise, clutter,
    periodic score dips (the low-score stage) and a leaver."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-15.0, 15.0, (n_objects, 2)).astype(np.float32)
    vel = rng.uniform(-1.0, 1.0, (n_objects, 2)).astype(np.float32)
    frames = []
    for k in range(n_frames):
        rows = []
        for i in range(n_objects):
            score = 0.2 if (k + i) % 4 == 3 else 0.9
            if k >= 8 and i == n_objects - 1:
                continue  # one object leaves the scene
            x, y = pos[i] + rng.normal(0.0, 0.05, 2)
            rows.append((x, y, vel[i, 0], vel[i, 1], score))
        rows.append((rng.uniform(40.0, 60.0), rng.uniform(40.0, 60.0), 0, 0, 0.06))
        frames.append(_frame(rows, det_dim=det_dim, n_slots=n_slots))
        pos += vel
    return frames


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got_state, got_out, want_state, want_out, where="", keys=EXACT_OUT):
    """Integers and flags bitwise, floats within JAX's 1e-5; returns the
    largest float difference."""
    worst = 0.0
    for key in keys:
        np.testing.assert_array_equal(_np(got_out[key]), _np(want_out[key]), err_msg=f"{where}{key}")
    for key in INT_KEYS:
        np.testing.assert_array_equal(_np(got_state[key]), _np(want_state[key]),
                                      err_msg=f"{where}{key}")
    for key in ("mean", "cov", "box"):
        a, b = _np(got_state[key]), _np(want_state[key])
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=f"{where}{key}")
        worst = max(worst, float(np.abs(a - b).max()) if a.size else 0.0)
    for key in ("tracks", "innovation"):
        if key in want_out:
            np.testing.assert_allclose(_np(got_out[key]), _np(want_out[key]), atol=1e-5,
                                       err_msg=f"{where}{key}")
    return worst


def _run_all(frames, jcfg=JCFG, tcfg=TCFG, det_dim=DET_DIM, id_base=0):
    """Drive JAX's reference and jitted step and the port's plain and
    captured steps over ``frames``, asserting agreement frame by frame."""
    jref = jtr.init_state(jcfg, det_dim, id_base)
    jdev = jtr.init_state(jcfg, det_dim, id_base)
    tref = ttr.init_state(tcfg, det_dim, id_base)
    tdev = ttr.init_state(tcfg, det_dim, id_base)
    jstep, tstep = jtr.make_step(jcfg), ttr.make_step(tcfg)
    worst = 0.0
    for k, (det, valid) in enumerate(frames):
        jref, jo = jtr.reference_step(jcfg, jref, det, valid)
        jdev, jdo = jstep(jdev, det, valid)
        tref, to = ttr.reference_step(tcfg, tref, det, valid)
        tdev, tdo = tstep(tdev, torch.from_numpy(det), torch.from_numpy(valid))
        for key in EXACT_OUT:  # JAX's own device/host bar
            np.testing.assert_array_equal(np.asarray(jdo[key]), np.asarray(jo[key]))
        worst = max(worst, _assert_same(tref, to, jref, jo, f"plain frame {k}: "))
        worst = max(worst, _assert_same(tdev, tdo, jref, jo, f"card form frame {k}: "))
        _assert_same(tdev, tdo, jdev, jdo, f"card form vs jit frame {k}: ")
    return tdev, worst


# -- greedy association -------------------------------------------------------


def _random_cost(rng, t, n, gated=0.3):
    cost = rng.normal(0.0, 10.0, (t, n)).astype(np.float32)
    cost[rng.random((t, n)) < gated] = jtr.GATED
    return cost


@pytest.mark.parametrize("seed", range(4))
def test_greedy_assign_bitwise_random(seed):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        t, n = int(rng.integers(1, 9)), int(rng.integers(1, 9))
        cost = _random_cost(rng, t, n)
        trips = min(t, n)
        want = jtr.greedy_assign(np, cost.copy(), trips)
        jit = jtr.greedy_assign(jnp, jnp.asarray(cost), trips)
        for plain in (True, False):
            got = ttr.greedy_assign(torch.from_numpy(cost), trips, plain=plain)
            for g, w, j in zip(got, want, jit):
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g.numpy(), w)
                np.testing.assert_array_equal(g.numpy(), np.asarray(j))


@pytest.mark.parametrize("case", ["ties", "nan_row", "nan_first", "fully_gated", "one_row"])
def test_greedy_assign_edge_cases(case):
    """Equal affinities take the first maximum row-major; a NaN ranks as the
    maximum (and matches nothing, every later trip stuck on it), as
    ``jnp.argmax`` and ``np.argmax`` rank it."""
    cost = {
        "ties": np.full((4, 5), -1.0, np.float32),
        "nan_row": np.array([[-1, -2, -3], [np.nan, -1, -2], [-4, -5, -0.5]], np.float32),
        "nan_first": np.array([[np.nan, -1.0], [-1.0, np.nan]], np.float32),
        "fully_gated": np.full((3, 3), jtr.GATED, np.float32),
        "one_row": np.array([[-3.0, -1.0, -1.0, jtr.GATED]], np.float32),
    }[case]
    trips = min(cost.shape)
    want = jtr.greedy_assign(np, cost.copy(), trips)
    jit = jtr.greedy_assign(jnp, jnp.asarray(cost), trips)
    for plain in (True, False):
        got = ttr.greedy_assign(torch.from_numpy(cost), trips, plain=plain)
        for g, w, j in zip(got, want, jit):
            np.testing.assert_array_equal(g.numpy(), w)
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    if case == "fully_gated":
        assert (want[0] == -1).all() and (want[1] == -1).all()


def test_greedy_assign_group_axis_is_per_group():
    rng = np.random.default_rng(5)
    costs = np.stack([_random_cost(rng, 6, 7) for _ in range(3)])
    costs[1, 2, :] = np.nan
    for plain in (True, False):
        td, dt = ttr.greedy_assign(torch.from_numpy(costs), 6, plain=plain)
        for g in range(3):
            w_td, w_dt = jtr.greedy_assign(np, costs[g].copy(), 6)
            np.testing.assert_array_equal(td[g].numpy(), w_td)
            np.testing.assert_array_equal(dt[g].numpy(), w_dt)


def test_greedy_assign_one_to_one():
    cost = np.random.default_rng(0).normal(0.0, 1.0, (5, 7)).astype(np.float32)
    td, dt = ttr.greedy_assign(torch.from_numpy(cost), 5)
    matched = td[td >= 0].tolist()
    assert len(matched) == len(set(matched))
    for ti, di in enumerate(td.tolist()):
        if di >= 0:
            assert int(dt[di]) == ti


# -- the step -------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_drive_bitwise_parity(seed):
    _, worst = _run_all(_drive(n_frames=16, seed=seed))
    assert worst <= 1e-5


def test_drive_many_objects_fills_every_slot():
    """More movers than slots: births stop at the free slots, ids stay
    bitwise (max_tracks 8, 12 objects, 16-row frames)."""
    state, _ = _run_all(_drive(n_frames=10, seed=7, n_objects=12, n_slots=16))
    assert int(state["births"]) >= 8


def test_tie_drive():
    """Two tracks equidistant from two detections (a symmetric cross):
    the first maximum row-major decides, in every package."""
    f0 = _frame([(0.0, 0.0, 0, 0, 0.9), (2.0, 0.0, 0, 0, 0.9)])
    f1 = _frame([(1.0, 1.0, 0, 0, 0.9), (1.0, -1.0, 0, 0, 0.9)])
    f2 = _frame([(1.0, 0.0, 0, 0, 0.9), (1.0, 0.0, 0, 0, 0.9), (1.0, 0.0, 0, 0, 0.2)])
    _run_all([f0, f1, f2, f1])


def test_nan_centre_drive():
    """A NaN centre makes its affinities NaN: it ranks first and matches
    nothing, so its frame associates nothing, as in JAX."""
    frames = _drive(n_frames=6, seed=1)
    det, valid = frames[3]
    det = det.copy()
    det[0, 0] = np.nan
    frames[3] = (det, valid)
    _run_all(frames)


def test_fully_gated_frames():
    """Detections far outside every gate, then none valid: no match, births
    only of high-score rows."""
    near = _frame([(0.0, 0.0, 0, 0, 0.9), (3.0, 0.0, 0, 0, 0.9)])
    far = _frame([(80.0, 80.0, 0, 0, 0.9), (-80.0, 80.0, 0, 0, 0.3)])
    empty = (near[0], np.zeros_like(near[1]))
    _run_all([near, far, empty, empty, empty, near])


def test_six_column_rows_without_velocity():
    """2D rows [x1 y1 x2 y2 score label] with velocity_cols None (what the
    session layer narrows the default to for them)."""
    jcfg = jtr.TrackerConfig(velocity_cols=None, **KW)
    tcfg = ttr.TrackerConfig(velocity_cols=None, **KW)
    rng = np.random.default_rng(3)
    frames = []
    base = rng.uniform(0.0, 20.0, (3, 2)).astype(np.float32)
    for k in range(8):
        det = np.zeros((5, 6), np.float32)
        det[:3, 0:2] = base + 0.3 * k + rng.normal(0, 0.05, (3, 2))
        det[:3, 2:4] = det[:3, 0:2] + 10.0
        det[:3, 4] = (0.9, 0.3 if k % 3 == 2 else 0.8, 0.7)
        valid = np.array([True, True, True, False, False])
        frames.append((det, valid))
    _run_all(frames, jcfg, tcfg, det_dim=6)


def test_nine_column_rows_feed_score_and_label_as_velocity():
    """PointPillars' and SECOND's rows [box7 score label] under the default
    velocity_cols=(7, 9): score and label enter the velocity update in both
    packages (ROADMAP.md Queue 3)."""
    jcfg = jtr.TrackerConfig(**KW)
    assert jcfg.velocity_cols == (7, 9)
    _run_all(_drive(n_frames=10, seed=4, det_dim=9), jcfg, TCFG, det_dim=9)


@pytest.mark.parametrize("ns", [1, 2])
def test_id_namespaces(ns):
    """A namespace's ids carry its prefix and the epoch's, in both packages;
    two namespaces never share an id."""
    base = id_base_for(ns, 5)
    assert base == jid_base_for(ns, 5)
    state, _ = _run_all(_drive(), id_base=base)
    live = state["tid"][state["tid"] > 0]
    assert bool((live >> 27 == ns).all()) and bool(((live >> 16) & 2047 == 5).all())


def test_ids_monotone_and_births_counted():
    step = ttr.make_step(TCFG)
    state = ttr.init_state(TCFG, DET_DIM)
    seen = set()
    for det, valid in _drive():
        state, out = step(state, det, valid)
        live = out["track_ids"][out["tracks_valid"]]
        assert bool((live > 0).all())
        seen.update(live.tolist())
    assert int(state["births"]) == len(seen)
    assert int(state["deaths"]) >= 1  # the leaver dies


def test_low_score_continues_but_never_births():
    step = ttr.make_step(TCFG)
    state = ttr.init_state(TCFG, DET_DIM)
    state, out = step(state, *_frame([(0.0, 0.0, 0.5, 0.0, 0.9)]))
    tid0 = int(out["det_track_ids"][0])
    assert tid0 > 0
    state, out = step(state, *_frame([(0.5, 0.0, 0.5, 0.0, 0.2), (20.0, 20.0, 0.0, 0.0, 0.2)]))
    assert int(out["det_track_ids"][0]) == tid0 and int(out["det_track_ids"][1]) == -1
    assert int(state["births"]) == 1


@pytest.mark.parametrize("group", [1, 3])
def test_group_step_equals_each_camera_alone(group):
    """The group body over G cameras equals G independent reference steps,
    and JAX's vmapped step."""
    jg, tg = jtr.make_group_step(JCFG), ttr.make_group_step(TCFG)
    drives = [_drive(n_frames=10, seed=10 + c) for c in range(group)]
    base_j = jtr.init_state(JCFG, DET_DIM)
    jstate = {k: np.stack([v] * group) for k, v in base_j.items()}
    jstate["next_id"] = np.asarray([1 + 1000 * c for c in range(group)], np.int32)
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
    refs = []
    for c in range(group):
        r = ttr.init_state(TCFG, DET_DIM)
        r["next_id"] = torch.tensor(1 + 1000 * c, dtype=torch.int32)
        refs.append(r)
    for k in range(10):
        dets = np.stack([drives[c][k][0] for c in range(group)])
        valids = np.stack([drives[c][k][1] for c in range(group)])
        jstate, jo = jg(jstate, dets, valids)
        tstate, to = tg(tstate, torch.from_numpy(dets), torch.from_numpy(valids))
        _assert_same(tstate, to, jstate, jo, f"frame {k} vs vmap: ")
        for c in range(group):
            refs[c], ro = ttr.reference_step(TCFG, refs[c], dets[c], valids[c])
            _assert_same({key: v[c] for key, v in tstate.items()},
                         {key: v[c] for key, v in to.items()}, refs[c], ro,
                         f"frame {k} camera {c}: ")
    if group > 1:
        live = [set(tstate["tid"][c][tstate["tid"][c] > 0].tolist()) for c in range(group)]
        assert all(live) and not (live[0] & live[1])


@pytest.mark.parametrize("group", [0, 2])
def test_coast_matches_reference(group):
    """Coast frames between keyframes: the port's plain and captured coast
    against JAX's reference_coast (and its vmapped coast for a group)."""
    frames = _drive(n_frames=8, seed=2)
    jref = jtr.init_state(JCFG, DET_DIM)
    tref = ttr.init_state(TCFG, DET_DIM)
    for k, (det, valid) in enumerate(frames):
        if k % 3 == 2:
            jref, jo = jtr.reference_coast(JCFG, jref)
            tref, to = ttr.reference_coast(TCFG, tref)
            keys = ttr.COAST_OUTPUT_KEYS[1:]
            assert set(to) == set(ttr.COAST_OUTPUT_KEYS)
        else:
            jref, jo = jtr.reference_step(JCFG, jref, det, valid)
            tref, to = ttr.reference_step(TCFG, tref, det, valid)
            keys = EXACT_OUT
        _assert_same(tref, to, jref, jo, f"frame {k}: ", keys)
    if group:
        jstate = {k: np.stack([np.asarray(v)] * group) for k, v in jref.items()}
        tstate = {k: torch.stack([v] * group) for k, v in tref.items()}
        jstate, jo = jtr.make_group_coast(JCFG)(jstate)
        tstate, to = ttr.make_group_coast(TCFG)(tstate)
    else:
        jstate, jo = jtr.make_coast_step(JCFG)(jref)
        tstate, to = ttr.make_coast_step(TCFG)(tref)
    _assert_same(tstate, to, jstate, jo, "captured coast: ", ttr.COAST_OUTPUT_KEYS[1:])


def test_outputs_are_int32_tensors():
    state, out = ttr.make_step(TCFG)(ttr.init_state(TCFG, DET_DIM),
                                     *_frame([(0.0, 0.0, 0.0, 0.0, 0.9)]))
    assert set(out) == set(ttr.OUTPUT_KEYS) and set(state) == set(ttr.STATE_KEYS)
    for key in ("track_ids", "track_assign", "det_track_ids", "tid", "age", "hits", "next_id"):
        v = out.get(key, state.get(key))
        assert isinstance(v, torch.Tensor) and v.dtype == torch.int32, key
    assert out["tracks_valid"].dtype == torch.bool
    assert out["tracks"].dtype == torch.float32 and out["innovation"].shape == ()


def test_plain_step_refuses_a_device_tensor():
    state = {k: v.to("meta") for k, v in ttr.init_state(TCFG, DET_DIM).items()}
    det, valid = _frame([(0.0, 0.0, 0.0, 0.0, 0.9)])
    with pytest.raises(ValueError, match="CPU tensors only"):
        ttr.reference_step(TCFG, state, det, valid)


def test_config_validated_and_steps_cached():
    with pytest.raises(ValueError):
        ttr.TrackerConfig(velocity_cols=(9, 7))
    assert ttr.make_step(TCFG) is ttr.make_step(ttr.TrackerConfig(**KW))
    assert ttr.make_step(TCFG) is not ttr.make_group_step(TCFG)
    assert ttr.STATE_KEYS == jtr.STATE_KEYS and ttr.OUTPUT_KEYS == jtr.OUTPUT_KEYS
    assert ttr.COAST_OUTPUT_KEYS == jtr.COAST_OUTPUT_KEYS
    assert np.float32(ttr.GATED) == jtr.GATED
    assert dataclasses.asdict(ttr.TrackerConfig()) == dataclasses.asdict(jtr.TrackerConfig())
