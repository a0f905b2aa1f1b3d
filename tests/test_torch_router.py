"""The port's front-door router (``runtime/router.py``) against the JAX
package's, on the CPU.

- Held against JAX's module on scripted fake channels that both packages
  drive alike: ``RetryBudget`` on seeded deposit/spend sequences;
  ``_rendezvous_score`` bitwise over 1,000 stream ids x 3 endpoint sets,
  ``pick_affinity`` and its minimal disruption on a replica's loss;
  seeded p2c ``pick`` sequences; ejection, the doubling hold, probe flips
  and the panic ladder on a patched clock; ``FrontDoorRouter`` on the
  cases of JAX's ``TestRouterRetries``, ``TestHedging`` and
  ``TestChannelDeadline`` (tests/test_router.py), hedges won and lost on
  pending futures, the router's own deadline, and the affinity handoff.
  ``stats()`` and ``snapshot()["replicas"]`` are equal key for key; only
  ``hedge_delay_s`` may differ, by at most 1 ms, because the runs' own
  request walls enter the latency histogram it is read from.
- The tracer role on the fakes (tests/test_tracing.py's router cases): the
  same spans with the same tags in both packages.
- Live on the CPU, two in-process port ``InferenceServer``s over a tiny
  model (tests/test_router.py's live cases): hedged outputs bitwise equal
  to unhedged ones; a drain during a hedged request loses no response;
  ``replica_down`` flips readiness and ``route`` prints it; the
  ``RouterCollector`` exports every ``tpu_router_*`` family; a traced
  hedged request has sibling attempt spans, the loser ``cancelled=True``,
  and the winner's server summary grafted once. The chaos run (a replica
  killed and one drained under open-loop load) is ``slow``, as JAX's is.
"""

import random
import threading
import time
import types

import grpc
import numpy as np
import pytest

from triton_client_tpu.channel import base as jbase
from triton_client_tpu.channel import grpc_channel as jgc
from triton_client_tpu.obs import trace as jtrace
from triton_client_tpu.runtime import router as jrouter

from triton_client_tpu_torch.channel import base as tbase
from triton_client_tpu_torch.channel import grpc_channel as tgc
from triton_client_tpu_torch.obs import trace as ttrace
from triton_client_tpu_torch.runtime import faults
from triton_client_tpu_torch.runtime import router as trouter
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {
    "jax": types.SimpleNamespace(router=jrouter, base=jbase, trace=jtrace, grpc=jgc),
    "port": types.SimpleNamespace(router=trouter, base=tbase, trace=ttrace, grpc=tgc),
}
X = np.arange(8, dtype=np.float32).reshape(2, 4)
# hedge_delay_s is a quantile of the router's own latency histogram, which
# the runs' request walls feed: the one number of stats() allowed to differ
HEDGE_DELAY_TOL_S = 1e-3


class FakeRpcError(grpc.RpcError):
    """A grpc.RpcError answering code()/details() with a named status, so
    the channel's ladder and both routers classify it as a server's."""

    def __init__(self, name, details=""):
        super().__init__(details or name)
        self._code = getattr(grpc.StatusCode, name)
        self._details = details

    def code(self):
        return self._code

    def details(self):
        return self._details


PENDING = object()  # a script's answer: the attempt stays in flight


class _Pending:
    """The handle of an attempt in flight: completes when the test says so
    (``finish``) or when the router cancels it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fns = []
        self._done = False
        self.cancelled = False
        self.value = None

    def subscribe(self, fn):
        with self._lock:
            if not self._done:
                self._fns.append(fn)
                return
        fn()

    def _complete(self):
        with self._lock:
            self._done, fns, self._fns = True, self._fns, []
        for fn in fns:
            fn()

    def cancel(self):
        with self._lock:
            if self._done:
                return False
            self.cancelled = True
        self._complete()
        return True

    def finish(self, value):
        self.value = value
        self._complete()

    def resolve(self):
        if self.cancelled:
            raise FakeRpcError("CANCELLED", "cancelled")
        if isinstance(self.value, BaseException):
            raise self.value
        return self.value


def _raise(e):
    raise e


class Fleet:
    """Replica stand-ins for one package's router. ``script(ep, request,
    n)`` (``n``: the attempt's ordinal over the fleet) returns a response,
    raises, or returns :data:`PENDING`; lazy futures run the script on the
    resolving thread, so the state machine runs deterministically."""

    def __init__(self, pkg, script, ready=True):
        self.pkg = pkg
        self.script = script
        self.ready = {}  # endpoint, or (endpoint, model) -> ready
        self.default_ready = ready
        self.calls = []  # (endpoint, sequence_start) per attempt
        self.pending = []
        self.closed = set()

    def channel(self, endpoint):
        fleet = self

        class _Channel:
            def do_inference_async(self, request):
                n = len(fleet.calls)
                fleet.calls.append((endpoint, bool(request.sequence_start)))
                answer = fleet.script(endpoint, request, n)
                if answer is PENDING:
                    p = _Pending()
                    fleet.pending.append(p)
                    return fleet.pkg.base.InferFuture(p.resolve, cancel=p.cancel,
                                                      subscribe=p.subscribe)
                if isinstance(answer, BaseException):
                    return fleet.pkg.base.InferFuture(lambda: _raise(answer))
                return fleet.pkg.base.InferFuture(lambda: answer)

            def do_inference(self, request):
                return self.do_inference_async(request).result()

            def server_ready(self, timeout_s=None):
                return fleet.ready.get(endpoint, fleet.default_ready)

            def model_ready(self, model_name, model_version="", timeout_s=None):
                return fleet.ready.get((endpoint, model_name), True)

            def get_metadata(self, model_name, model_version=""):
                return (endpoint, model_name)

            def close(self):
                fleet.closed.add(endpoint)

        return _Channel()

    def ok(self, request):
        return self.pkg.base.InferResponse(
            model_name=request.model_name, model_version="1",
            outputs={"y": np.asarray(request.inputs["x"]) * 2.0}, request_id=request.request_id)


def _router(pkg, endpoints, script, seed=0, **kw):
    kw.setdefault("probe_interval_s", 0.0)  # no background prober
    fleet = Fleet(pkg, lambda ep, req, n: script(fleet, ep, req, n))
    r = pkg.router.FrontDoorRouter(list(endpoints), channel_factory=fleet.channel, **kw)
    r.replica_set._rng = random.Random(seed)
    return r, fleet


def _request(pkg, **kw):
    return pkg.base.InferRequest("double", {"x": X}, **kw)


def _outcome(fn):
    try:
        resp = fn()
    except Exception as e:
        return ("raised", jrouter._status_name(e), e.details() if hasattr(e, "details") else "")
    return ("ok", resp.outputs["y"].tobytes())


def _compare_stats(got: dict, want: dict) -> None:
    got, want = dict(got), dict(want)
    g, w = got.pop("hedge_delay_s"), want.pop("hedge_delay_s")
    assert abs(g - w) <= HEDGE_DELAY_TOL_S, (g, w)
    assert got == want


def _both(scenario):
    """Run ``scenario(pkg)`` on both packages; it returns (router, fleet,
    outcomes). Their outcomes, the fleets' call logs, ``stats()`` and
    ``snapshot()["replicas"]`` are held equal; the port's run is returned."""
    runs = {}
    for name, pkg in PKGS.items():
        r, fleet, outcomes = scenario(pkg)
        try:
            runs[name] = (outcomes, fleet.calls, r.stats(), r.snapshot(), fleet)
        finally:
            r.close()
    (t_out, t_calls, t_stats, t_snap, t_fleet) = runs["port"]
    (j_out, j_calls, j_stats, j_snap, _) = runs["jax"]
    assert t_out == j_out
    assert t_calls == j_calls
    _compare_stats(t_stats, j_stats)
    assert t_snap["replicas"] == j_snap["replicas"]
    assert set(t_snap) == set(j_snap)
    return t_out, t_calls, t_stats, t_snap, t_fleet


# -- RetryBudget -----------------------------------------------------------------------


@pytest.mark.parametrize("ratio,cap,initial,seed", [
    (0.2, 10.0, 3.0, 0), (0.5, 10.0, 1.0, 1), (1.0, 2.0, 0.0, 2), (0.0, 5.0, 3.0, 3),
    (0.3, 1.5, 9.0, 4),
])
def test_retry_budget_equals_jax(ratio, cap, initial, seed):
    budgets = [pkg.router.RetryBudget(ratio=ratio, cap=cap, initial=initial)
               for pkg in PKGS.values()]
    rng = random.Random(seed)
    for _ in range(300):
        if rng.random() < 0.55:
            for b in budgets:
                b.deposit()
        else:
            assert len({b.try_spend() for b in budgets}) == 1
        assert len({(b.tokens, b.floor_hits, b.spent) for b in budgets}) == 1
    assert budgets[0].tokens <= cap


def test_retry_budget_floor_and_cap():
    b = trouter.RetryBudget(ratio=0.5, cap=10.0, initial=1.0)
    assert b.try_spend() is True and b.tokens == 0.0
    assert b.try_spend() is False and b.floor_hits == 1
    b.deposit()
    b.deposit()
    assert b.try_spend() is True and b.spent == 2
    b = trouter.RetryBudget(ratio=1.0, cap=2.0, initial=0.0)
    for _ in range(100):
        b.deposit()
    assert b.tokens == 2.0  # a quiet period cannot bank a storm


# -- rendezvous affinity ---------------------------------------------------------------


ENDPOINT_SETS = [
    [f"host{i}:8001" for i in range(3)],
    ["127.0.0.1:8001", "127.0.0.1:8011"],
    ["unix:/tmp/a.sock", "10.0.0.7:9000", "replica-b:8001", "replica-c:8001", "[::1]:5"],
]


@pytest.mark.parametrize("endpoints", ENDPOINT_SETS, ids=["three", "two", "five"])
def test_rendezvous_scores_and_affinity_equal_jax(endpoints):
    sids = [f"stream-{s}" for s in range(1000)]
    for sid in sids:
        for ep in endpoints:
            assert trouter._rendezvous_score(sid, ep) == jrouter._rendezvous_score(sid, ep)
    sets = {name: pkg.router.ReplicaSet(endpoints, channel_factory=Fleet(pkg, None).channel,
                                        probe_interval_s=0.0)
            for name, pkg in PKGS.items()}
    homes = {}
    for sid in sids:
        picks = []
        for rs in sets.values():
            rep = rs.pick_affinity(sid)
            picks.append(rep.endpoint)
            rs.release(rep)
        assert picks[0] == picks[1]
        homes[sid] = picks[0]
    assert set(homes.values()) == set(endpoints)  # every replica owns a share
    # minimal disruption: the lost replica's streams move, no other stream does
    lost = endpoints[0]
    for sid in sids:
        moved = []
        for rs in sets.values():
            dead = [r for r in rs.replicas if r.endpoint == lost]
            rep = rs.pick_affinity(sid, exclude=dead)
            moved.append(rep.endpoint)
            rs.release(rep)
        assert moved[0] == moved[1] != lost
        if homes[sid] != lost:
            assert moved[0] == homes[sid]
    for rs in sets.values():
        rs.close()


# -- ReplicaSet on a patched clock -----------------------------------------------------


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def perf_counter(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.router, "time", c)
    return c


def _sets(n=2, ready=True, **kw):
    kw.setdefault("probe_interval_s", 0.0)
    out = {}
    for name, pkg in PKGS.items():
        fleet = Fleet(pkg, None, ready=ready)
        rs = pkg.router.ReplicaSet([f"r{i}" for i in range(n)], channel_factory=fleet.channel,
                                   **kw)
        rs._rng = random.Random(5)
        out[name] = (rs, fleet)
    return out


def _same(sets, fn):
    """Apply ``fn(rs, fleet)`` to both sets; results and snapshots equal."""
    res = [fn(rs, fleet) for rs, fleet in sets.values()]
    assert res[0] == res[1]
    snaps = [rs.snapshot() for rs, _ in sets.values()]
    assert snaps[0] == snaps[1]
    return res[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_p2c_picks_equal_jax(seed):
    sets = _sets(4)
    for rs, _ in sets.values():
        rs._rng = random.Random(seed)
    ops = random.Random(100 + seed)
    held = {name: [] for name in sets}
    for _ in range(300):
        roll = ops.random()
        if roll < 0.55 or not held["port"]:
            excl = ops.sample(range(4), ops.randrange(0, 3))
            picks = []
            for name, (rs, _) in sets.items():
                rep = rs.pick(exclude=[rs.replicas[i] for i in excl])
                held[name].append(rep)
                picks.append(rep.endpoint)
                assert rep.endpoint not in [f"r{i}" for i in excl]
            assert picks[0] == picks[1]
        else:
            k = ops.randrange(len(held["port"]))
            for name, (rs, _) in sets.items():
                rs.release(held[name].pop(k))
        assert _same(sets, lambda rs, f: [r.inflight for r in rs.replicas]) is not None


def test_p2c_prefers_less_loaded_and_counts_inflight():
    sets = _sets(2)

    def drive(rs, fleet):
        a, b = rs.replicas
        a.inflight = 5
        picks = []
        for _ in range(8):
            pick = rs.pick()
            picks.append(pick.endpoint)
            rs.release(pick)
        a.inflight = 0
        pick = rs.pick(exclude=[a])
        out = (picks, pick.endpoint, b.inflight)
        rs.release(pick)
        return out + (b.inflight,)

    assert _same(sets, drive) == (["r1"] * 8, "r1", 1, 0)


def test_ejection_threshold_and_doubling_hold(clock):
    sets = _sets(2, eject_threshold=3, base_ejection_s=100.0, max_ejection_s=350.0)

    def fail(rs, fleet, n=1):
        rep = rs.replicas[0]
        for _ in range(n):
            rs.record_failure(rep, connection_class=True)
        return (rep.ejected(clock.t), rep.ejected_until, rep.ejections, rs.ejections_total,
                rs.available_count())

    assert _same(sets, lambda rs, f: fail(rs, f, 2))[0] is False  # 2 of 3: still in
    assert _same(sets, fail)[:2] == (True, 1100.0)
    clock.t += 100.0  # the hold is over
    assert _same(sets, lambda rs, f: rs.available_count()) == 2
    assert _same(sets, lambda rs, f: fail(rs, f, 3))[:4] == (True, 1300.0, 2, 2)  # doubled
    clock.t += 200.0
    assert _same(sets, lambda rs, f: fail(rs, f, 3))[:3] == (True, 1650.0, 3)  # capped at 350
    # a success breaks the streak
    clock.t += 350.0
    _same(sets, lambda rs, f: fail(rs, f, 2))
    _same(sets, lambda rs, f: rs.record_success(rs.replicas[0]))
    assert _same(sets, lambda rs, f: fail(rs, f, 2))[0] is False


def test_non_connection_failures_never_eject(clock):
    sets = _sets(1, eject_threshold=1)

    def drive(rs, fleet):
        for _ in range(10):
            rs.record_failure(rs.replicas[0], connection_class=False)
        return rs.replicas[0].ejected(clock.t), rs.replicas[0].failures

    assert _same(sets, drive) == (False, 10)


def test_probe_flips_rotation_and_clears_passive_state(clock):
    sets = _sets(2, ready=False, models=("double",))

    def first(rs, fleet):
        before = rs.replicas[0].probe_ready  # optimistic before the first probe
        rs.probe_once()
        return before, rs.available_count()

    assert _same(sets, first) == (True, 0)

    def recover(rs, fleet):
        fleet.default_ready = True
        fleet.ready[("r1", "double")] = False  # live and ready, its model is not
        rs.replicas[0].draining = True
        rs.replicas[0].consecutive_failures = 2
        rs.probe_once()
        r0 = rs.replicas[0]
        return r0.probe_ready, r0.draining, r0.consecutive_failures, rs.available_count()

    assert _same(sets, recover) == (True, False, 0, 1)


def test_panic_ladder_always_picks(clock):
    sets = _sets(3, eject_threshold=1, base_ejection_s=100.0)

    def drive(rs, fleet):
        out = []
        for rep in rs.replicas:
            rs.record_failure(rep, connection_class=True)
        out.append(rs.available_count())
        rs.replicas[1].draining = True
        for _ in range(6):  # non-draining first
            rep = rs.pick()
            out.append(rep.endpoint)
            rs.release(rep)
        for rep in rs.replicas:
            rep.draining = True
        rep = rs.pick(exclude=rs.replicas[:2])  # then anything not excluded
        out.append(rep.endpoint)
        rs.release(rep)
        out.append(rs.pick(exclude=rs.replicas))  # nothing left: None
        out.append(rs.pick_affinity("s", exclude=rs.replicas))
        return out

    got = _same(sets, drive)
    assert got[0] == 0 and "r1" not in got[1:7] and got[7:] == ["r2", None, None]


def test_close_closes_channels():
    for rs, fleet in _sets(2).values():
        rs.close()
        assert fleet.closed == {"r0", "r1"}


# -- FrontDoorRouter: the retry discipline ----------------------------------------------


def _fail_first(name, details):
    def script(fleet, ep, req, n):
        return FakeRpcError(name, details) if n == 0 else fleet.ok(req)

    return script


def _always(name, details):
    return lambda fleet, ep, req, n: FakeRpcError(name, details)


def _one_request(endpoints, script, n=1, **kw):
    def scenario(pkg):
        r, fleet = _router(pkg, endpoints, script, **kw)
        return r, fleet, [_outcome(lambda: r.do_inference(_request(pkg))) for _ in range(n)]

    return scenario


def test_unavailable_fails_over_and_spends_budget():
    out, calls, s, _, _ = _both(_one_request(["a", "b"], _fail_first("UNAVAILABLE", "refused")))
    assert out == [("ok", (X * 2.0).tobytes())]
    assert s["failovers"] == 1 and s["retries_spent"] == 1
    assert s["drain_failovers"] == 0 and s["errors_total"] == 0
    assert calls[0][0] != calls[1][0]  # the retry went elsewhere


def test_drain_failover_is_free_and_pulls_replica():
    out, calls, s, snap, _ = _both(
        _one_request(["a", "b"], _fail_first("UNAVAILABLE", "server draining")))
    assert out[0][0] == "ok"
    assert s["drain_failovers"] == 1 and s["failovers"] == 1 and s["retries_spent"] == 0
    assert [r["endpoint"] for r in snap["replicas"] if r["draining"]] == [calls[0][0]]


@pytest.mark.parametrize("name", ["RESOURCE_EXHAUSTED", "DEADLINE_EXCEEDED", "INTERNAL"])
def test_sheds_deadlines_and_errors_are_never_retried(name):
    out, calls, s, _, _ = _both(_one_request(["a", "b"], _always(name, "no")))
    assert out == [("raised", name, "no")] and len(calls) == 1
    assert s["errors_total"] == 1 and s["failovers"] == 0


def test_failure_storm_hits_budget_floor_without_amplification():
    out, calls, s, _, _ = _both(_one_request(
        ["a", "b"], _always("UNAVAILABLE", "refused"), n=3, retry_budget_ratio=0.0,
        max_attempts=10, eject_threshold=1000))
    assert [o[1] for o in out] == ["UNAVAILABLE"] * 3
    assert s["retry_budget_floor_hits"] >= 1 and s["retry_budget_tokens"] == 0.0
    assert s["retries_spent"] == 3 and len(calls) == 6 and s["errors_total"] == 3


def test_max_attempts_caps_failover_chain():
    _, calls, _, _, _ = _both(_one_request(
        ["a", "b", "c"], _always("UNAVAILABLE", "refused"), max_attempts=2,
        retry_budget_cap=100.0, eject_threshold=1000))
    assert len(calls) == 2


def test_ejection_via_router_failures():
    def script(fleet, ep, req, n):
        return FakeRpcError("UNAVAILABLE", "refused") if ep == "a" else fleet.ok(req)

    def scenario(pkg):
        r, fleet = _router(pkg, ["a", "b"], script, eject_threshold=2, base_ejection_s=60.0,
                           retry_budget_cap=100.0, retry_budget_ratio=1.0)
        out = []
        for _ in range(64):
            out.append(_outcome(lambda: r.do_inference(_request(pkg))))
            if r.stats()["ejections_total"] >= 1:
                break
        del fleet.calls[:]
        out += [_outcome(lambda: r.do_inference(_request(pkg))) for _ in range(2)]
        return r, fleet, out

    out, calls, s, snap, _ = _both(scenario)
    assert s["ejections_total"] == 1 and all(o[0] == "ok" for o in out)
    assert {r["endpoint"]: r["ejected"] for r in snap["replicas"]} == {"a": True, "b": False}
    assert calls == [("b", False), ("b", False)]  # with a ejected, straight to b


def test_affinity_handoff_restarts_the_stream_on_the_runner_up():
    owner = max(["a", "b"], key=lambda e: (jrouter._rendezvous_score("cam-0", e), e))

    def script(fleet, ep, req, n):
        return FakeRpcError("UNAVAILABLE", "refused") if ep == owner else fleet.ok(req)

    def scenario(pkg):
        r, fleet = _router(pkg, ["a", "b"], script, hedge_min_samples=1, eject_threshold=2)
        for _ in range(200):  # hedging armed (a stream must still never hedge), its
            r._latency.observe(0.001)  # delay held by these samples, not the runs' walls
        out = [_outcome(lambda k=k: r.do_inference(_request(
            pkg, sequence_id="cam-0", sequence_start=(k == 0)))) for k in range(4)]
        return r, fleet, out

    out, calls, s, snap, _ = _both(scenario)
    runner_up = "b" if owner == "a" else "a"
    assert all(o[0] == "ok" for o in out)
    # two frames fail on the owner and re-home with sequence_start; then the
    # owner is ejected and the next frames go straight to the runner-up,
    # continuing the restarted session
    assert calls == [(owner, True), (runner_up, True), (owner, False), (runner_up, True),
                     (runner_up, False), (runner_up, False)]
    assert s["affinity_routed"] == 4 and s["affinity_handoffs"] == 2
    assert s["hedges_launched"] == 0 and s["failovers"] == 2 and s["ejections_total"] == 1


# -- FrontDoorRouter: hedging -----------------------------------------------------------


def test_no_hedge_below_min_samples():
    def scenario(pkg):
        r, fleet = _router(pkg, ["a", "b"], lambda f, ep, req, n: f.ok(req))
        assert r._hedge_delay_s() is None
        return r, fleet, [_outcome(lambda: r.do_inference(_request(pkg))) for _ in range(5)]

    assert _both(scenario)[2]["hedges_launched"] == 0


def test_hedge_delay_tracks_quantile():
    delays = []
    for pkg in PKGS.values():
        r, _ = _router(pkg, ["a", "b"], None, hedge_min_samples=10)
        for _ in range(20):
            r._latency.observe(0.04)
        delays.append(r._hedge_delay_s())
        r.close()
    assert delays[0] == delays[1] and 0.02 <= delays[0] <= 0.06


def test_hedge_budget_denies_past_fraction():
    def scenario(pkg):
        r, fleet = _router(pkg, ["a", "b"], None, hedge_budget_fraction=0.05)
        out = [r._hedge_allowed()]  # the floor population is 20: one hedge
        r._hedges_launched = 1
        out.append(r._hedge_allowed())
        return r, fleet, out

    out, _, s, _, _ = _both(scenario)
    assert out == [True, False] and s["hedges_denied"] == 1


def _hedged(win):
    """The primary stays pending; the hedge answers at once (``win="hedge"``)
    or stays pending while a timer answers the primary (``"primary"``)."""

    def script(fleet, ep, req, n):
        if n == 0 and win == "primary":
            threading.Timer(0.05, lambda: fleet.pending[0].finish(fleet.ok(req))).start()
        if n == 0 or win == "primary":
            return PENDING
        return fleet.ok(req)

    def scenario(pkg):
        r, fleet = _router(pkg, ["a", "b"], script, hedge_min_samples=10,
                           hedge_budget_fraction=1.0)
        for _ in range(20):
            r._latency.observe(0.001)
        return r, fleet, [_outcome(lambda: r.do_inference(_request(pkg)))]

    return scenario


@pytest.mark.parametrize("win", ["hedge", "primary"])
def test_first_winner_takes_the_request_and_the_loser_is_cancelled(win):
    out, calls, s, snap, fleet = _both(_hedged(win))
    assert out == [("ok", (X * 2.0).tobytes())]
    assert len(calls) == 2 and calls[0][0] != calls[1][0]
    assert s["hedges_launched"] == 1
    assert (s["hedges_won"], s["hedges_lost"]) == ((1, 0) if win == "hedge" else (0, 1))
    loser = fleet.pending[0] if win == "hedge" else fleet.pending[1]
    assert loser.cancelled
    assert all(r["inflight"] == 0 for r in snap["replicas"])  # the cancel released it


def test_router_deadline_cancels_what_is_in_flight():
    def scenario(pkg):
        r, fleet = _router(pkg, ["a", "b"], lambda f, ep, req, n: PENDING)
        req = _request(pkg, deadline_s=time.perf_counter() + 0.05)
        return r, fleet, [_outcome(lambda: r.do_inference(req))]

    out, calls, s, snap, fleet = _both(scenario)
    assert out[0][:2] == ("raised", "DEADLINE_EXCEEDED")
    assert "router deadline expired with 1 attempt(s) in flight" in out[0][2]
    assert fleet.pending[0].cancelled and s["errors_total"] == 1
    assert all(r["inflight"] == 0 for r in snap["replicas"])


def test_get_metadata_asks_an_available_replica_first():
    for pkg in PKGS.values():
        r, _ = _router(pkg, ["a", "b"], None)
        r.replica_set.replicas[0].draining = True
        assert r.get_metadata("double") == ("b", "double")
        assert r.fetch_channel() is r.replica_set
        r.close()


def test_attach_quality_names_its_item():
    r, _ = _router(PKGS["port"], ["a"], None)
    with pytest.raises(NotImplementedError, match="item 8"):
        r.attach_quality(object())
    r.close()


# -- the channel's deadline discipline (TestChannelDeadline) ---------------------------


def _deadline_case(pkg, case):
    chan = pkg.grpc.GRPCChannel("127.0.0.1:1", timeout_s=30.0,
                                retries=0 if case == "capped" else 3,
                                backoff_s=1.0 if case == "backoff" else 0.1)
    seen = []
    try:
        if case == "expired":
            def method(request, timeout=None):
                seen.append(timeout)
                raise AssertionError("must not reach the wire")

            return _outcome(lambda: chan._call(method, None,
                                               deadline_s=time.perf_counter() - 1.0))[:2], seen
        if case == "backoff":
            def method(request, timeout=None):
                seen.append(timeout)
                raise FakeRpcError("UNAVAILABLE", "connection refused")

            t0 = time.perf_counter()
            out = _outcome(lambda: chan._call(method, None,
                                              retryable=(grpc.StatusCode.UNAVAILABLE,),
                                              deadline_s=t0 + 0.2))[:2]
            assert time.perf_counter() - t0 < 0.2  # no sleep was taken
            return out, len(seen)
        if case == "capped":
            def method(request, timeout=None):
                seen.append(timeout)
                return "ok"

            assert chan._call(method, None, deadline_s=time.perf_counter() + 0.5) == "ok"
            return seen[0] <= 0.5, len(seen)
        fut = chan.do_inference_async(
            pkg.base.InferRequest("double", {"x": X}, deadline_s=time.perf_counter() - 1.0))
        return _outcome(fut.result)[:2], isinstance(fut, pkg.base.InferFuture)
    finally:
        chan.close()


@pytest.mark.parametrize("case", ["expired", "backoff", "capped", "async"])
def test_channel_deadline_discipline_equals_jax(case):
    got, want = (_deadline_case(PKGS[k], case) for k in ("port", "jax"))
    assert got == want
    assert got[0] in (("raised", "DEADLINE_EXCEEDED"), True)


# -- the tracer role on the fakes ------------------------------------------------------


def _traced(script, inbound=False):
    def scenario(pkg):
        tracer = pkg.trace.Tracer(capacity=8)
        r, fleet = _router(pkg, ["r0", "r1"], script, tracer=tracer)
        shipped = []
        inner = fleet.script

        def recording(ep, req, n):
            shipped.append(req.trace.context)
            return inner(ep, req, n)

        fleet.script = recording
        carrier = None
        if inbound:
            carrier = pkg.trace.RequestTrace(1, context=pkg.trace.TraceContext.new())
        out = [_outcome(lambda: r.do_inference(_request(pkg, request_id="q1", trace=carrier)))]
        (tr,) = tracer.recent()
        fleet.trace, fleet.shipped, fleet.inbound = tr, shipped, carrier
        return r, fleet, out

    return scenario


def _span_rows(tr):
    return sorted((s.name, tuple(sorted((s.attrs or {}).items()))) for s in tr.spans)


def _traced_both(script, inbound=False):
    traces = {}
    for name, pkg in PKGS.items():
        r, fleet, out = _traced(script, inbound)(pkg)
        r.close()
        traces[name] = (out, fleet)
    (t_out, t_fleet), (j_out, j_fleet) = traces["port"], traces["jax"]
    assert t_out == j_out
    assert _span_rows(t_fleet.trace) == _span_rows(j_fleet.trace)
    assert t_fleet.trace.status == j_fleet.trace.status
    return t_out, t_fleet


def test_trace_originates_a_context_and_an_attempt_span():
    _, fleet = _traced_both(lambda f, ep, req, n: f.ok(req))
    tr = fleet.trace
    assert tr.status == "ok" and tr.request_id == "q1" and tr.context is not None
    (shipped,) = fleet.shipped  # the attempt carries a CHILD of the router's context
    assert shipped.trace_id == tr.context.trace_id
    assert shipped.parent_span_id != tr.context.parent_span_id
    (att,) = [s for s in tr.spans if s.name == "attempt"]
    assert att.attrs["attempt"] == 0 and att.attrs["kind"] == "primary"
    assert [s.name for s in tr.spans].count("route") == 1


def test_trace_forwards_an_inbound_context():
    _, fleet = _traced_both(lambda f, ep, req, n: f.ok(req), inbound=True)
    assert fleet.trace.context.trace_id == fleet.inbound.context.trace_id
    assert fleet.trace.context.parent_span_id != fleet.inbound.context.parent_span_id


def test_trace_grafts_the_server_summary_once():
    import json

    summary = json.dumps({"w": 30000, "st": "ok", "s": [["device_execute", 10000, 10000]]})

    def script(fleet, ep, req, n):
        resp = fleet.ok(req)
        resp.parameters = {ttrace.SUMMARY_PARAM_KEY: summary}
        return resp

    _, fleet = _traced_both(script)
    (dev,) = [s for s in fleet.trace.spans if s.name == "srv.device_execute"]
    assert dev.duration_s == pytest.approx(0.01, abs=1e-6) and dev.attrs["kind"] == "primary"


def test_trace_retry_attempts_are_sibling_spans():
    _, fleet = _traced_both(_fail_first("UNAVAILABLE", ""))
    atts = sorted((s for s in fleet.trace.spans if s.name == "attempt"),
                  key=lambda s: s.attrs["attempt"])
    assert [a.attrs["kind"] for a in atts] == ["primary", "retry"]
    assert atts[0].attrs["error"] == "UNAVAILABLE" and "error" not in atts[1].attrs
    a, b = fleet.shipped
    assert a.trace_id == b.trace_id == fleet.trace.context.trace_id
    assert a.parent_span_id != b.parent_span_id


def test_trace_error_finishes_with_its_status():
    out, fleet = _traced_both(_always("RESOURCE_EXHAUSTED", "shed"))
    assert out[0][0] == "raised" and fleet.trace.status == "RESOURCE_EXHAUSTED"


# -- live: two port servers on loopback -------------------------------------------------


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    prev = faults.install_fault_plan(None)
    yield
    faults.install_fault_plan(prev)


def _repo(sleep_s=0.0):
    from triton_client_tpu_torch.config import ModelSpec, TensorSpec
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    spec = ModelSpec(name="double", version="1", inputs=(TensorSpec("x", (-1, 4), "FP32"),),
                     outputs=(TensorSpec("y", (-1, 4), "FP32"),))

    def infer(inputs):
        if sleep_s:
            time.sleep(sleep_s)
        return {"y": inputs["x"] * 2.0}

    repo = ModelRepository()
    repo.register(spec, infer)
    return repo


def _server(repo, **kw):
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.runtime.batching import BatchingChannel
    from triton_client_tpu_torch.runtime.server import InferenceServer

    chan = BatchingChannel(CUDAChannel(repo, device="cpu"), max_batch=4, timeout_us=2000,
                           merge_hold_us=0)
    server = InferenceServer(repo, chan, address="127.0.0.1:0", **kw)
    server.start()
    return server


@pytest.fixture
def fleet2():
    servers = []

    def start(n=2, sleep_s=0.0, **kw):
        repo = _repo(sleep_s)
        servers.extend(_server(repo, **kw) for _ in range(n))
        return servers, [f"127.0.0.1:{s.port}" for s in servers]

    yield start
    for s in servers:
        s.stop()


def _infer(chan, **kw):
    return chan.do_inference(tbase.InferRequest("double", {"x": X}, **kw))


def test_hedged_outputs_bitwise_identical_to_unhedged(fleet2):
    _, endpoints = fleet2(sleep_s=0.15)
    plain = trouter.FrontDoorRouter(endpoints, probe_interval_s=0.0, hedge_min_samples=10**9)
    try:
        reference = _infer(plain).outputs["y"]
        assert plain.stats()["hedges_launched"] == 0
    finally:
        plain.close()
    hedged = trouter.FrontDoorRouter(endpoints, probe_interval_s=0.0, hedge_min_samples=10,
                                     hedge_budget_fraction=1.0)
    try:
        for _ in range(20):  # the quantile far below the 0.15 s service time
            hedged._latency.observe(0.01)
        resp = _infer(hedged)
        s = hedged.stats()
        assert s["hedges_launched"] == 1 and s["hedges_won"] + s["hedges_lost"] == 1
        assert resp.outputs["y"].tobytes() == reference.tobytes()
        assert s["errors_total"] == 0
        assert {r["transport"] for r in hedged.snapshot()["replicas"]} == {"shm"}
    finally:
        hedged.close()


def test_drain_during_hedged_request_no_lost_response(fleet2):
    servers, endpoints = fleet2(sleep_s=0.4)
    r = trouter.FrontDoorRouter(endpoints, probe_interval_s=0.0, hedge_min_samples=10,
                                hedge_budget_fraction=1.0)
    try:
        for _ in range(20):
            r._latency.observe(0.02)
        results = []
        t = threading.Thread(target=lambda: results.append(_infer(r)))
        t.start()
        time.sleep(0.2)  # the primary and the hedge are both in flight
        assert r.stats()["hedges_launched"] == 1
        drained = {}
        dt = threading.Thread(target=lambda: drained.update(ok=servers[0].drain(timeout_s=10.0)))
        dt.start()
        t.join(timeout=10.0)
        dt.join(timeout=15.0)
        assert len(results) == 1  # exactly one resolution
        np.testing.assert_array_equal(results[0].outputs["y"], X * 2.0)
        assert drained["ok"] is True
        s = r.stats()
        assert s["requests_total"] == 1 and s["errors_total"] == 0
    finally:
        r.close()


def test_replica_down_flips_readiness_and_route_prints_it(fleet2, capsys):
    from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel
    from triton_client_tpu_torch.cli.tools import route

    servers, (ep,) = fleet2(n=1, replica_of="cell0/r1")
    client = GRPCChannel(ep, retries=0)
    plan = lambda: faults.FaultPlan(  # noqa: E731
        [{"point": "replica_down", "model": "cell0/r1", "count": 1}], seed=7)
    try:
        assert client.server_ready() is True
        faults.install_fault_plan(plan())
        assert client.server_ready() is False  # consumes the flag
        assert client.server_ready() is True  # the window is over
        faults.install_fault_plan(plan())
        with pytest.raises(grpc.RpcError) as e:
            _infer(client)
        assert e.value.code() == grpc.StatusCode.UNAVAILABLE
        assert "draining" not in (e.value.details() or "")  # ejection-class, not a drain
        np.testing.assert_array_equal(_infer(client).outputs["y"], X * 2.0)
    finally:
        client.close()
    route([ep, "-m", "double", "--timeout", "5.0"])
    out = capsys.readouterr().out
    assert "IN-ROTATION" in out and "replica_of=cell0/r1" in out and "1/1 in rotation" in out
    assert "transport=shm" in out
    faults.install_fault_plan(plan())
    with pytest.raises(SystemExit) as ei:
        route([ep, "-m", "double", "--timeout", "5.0"])
    out = capsys.readouterr().out
    assert ei.value.code == 1 and "NOT-READY" in out and "0/1 in rotation" in out
    servers[0].stop()
    with pytest.raises(SystemExit) as ei:
        route([ep, "--timeout", "0.5"])
    assert ei.value.code == 1 and "DEAD" in capsys.readouterr().out


def test_route_is_a_command():
    from triton_client_tpu_torch import __main__ as entry

    assert "route" in entry.COMMANDS


def test_collector_exports_every_router_family(fleet2):
    pytest.importorskip("prometheus_client")
    _, (ep,) = fleet2(n=1)
    r = trouter.FrontDoorRouter([ep], probe_interval_s=0.0)
    try:
        _infer(r)
        fams = {m.name: m for m in trouter.RouterCollector(r).collect()}
        want = {f[: -len("_total")] for f in trouter.RouterCollector.COUNTERS}
        want |= {"tpu_router_retry_budget_tokens", "tpu_router_hedge_delay_seconds",
                 "tpu_router_replica_available", "tpu_router_replica_inflight"}
        assert set(fams) == want  # prometheus strips a counter's _total
        assert set(trouter.RouterCollector.COUNTERS) == {
            f for f in _jax_collector_families() if f.endswith("_total")}
        assert fams["tpu_router_requests"].samples[0].value == 1.0
        avail = fams["tpu_router_replica_available"].samples
        assert avail[0].labels["endpoint"] == ep and avail[0].value == 1.0
    finally:
        r.close()


def _jax_collector_families():
    """The counter family names JAX's RouterCollector yields (read from its
    output on a fake fleet, with the _total suffix put back)."""
    r, _ = _router(PKGS["jax"], ["a"], None)
    try:
        out = set()
        for m in jrouter.RouterCollector(r).collect():
            out.add(m.name + "_total" if m.type == "counter" else m.name)
        return out
    finally:
        r.close()


def test_traced_hedged_request_joins_one_timeline(fleet2):
    _, endpoints = fleet2(sleep_s=0.15)
    tracer = ttrace.Tracer(capacity=16)
    router = trouter.FrontDoorRouter(endpoints, probe_interval_s=0.0, hedge_min_samples=10,
                                     hedge_budget_fraction=1.0, tracer=tracer)
    try:
        for _ in range(20):
            router._latency.observe(0.01)
        t0 = time.perf_counter()
        resp = _infer(router, request_id="joined-1")
        wall = time.perf_counter() - t0
        np.testing.assert_allclose(resp.outputs["y"], X * 2.0)
        assert router.stats()["hedges_launched"] == 1
        (tr,) = tracer.recent()
        names = [s.name for s in tr.spans]
        assert "route" in names and "wire_send" in names and "wire_recv" in names
        atts = sorted((s for s in tr.spans if s.name == "attempt"),
                      key=lambda s: s.attrs["attempt"])
        assert [a.attrs["kind"] for a in atts] == ["primary", "hedge"]
        assert len({a.attrs["endpoint"] for a in atts}) == 2
        (winner,) = [a for a in atts if not a.attrs.get("cancelled")]
        # the winner's summary grafted once: every server span is the
        # winner's, and the device was timed once though two replicas ran
        srv = [s for s in tr.spans if s.name.startswith("srv.")]
        assert srv and {s.attrs["attempt"] for s in srv} == {winner.attrs["attempt"]}
        assert names.count("srv.device_execute") == 1 and "srv.batch_queue" in names
        assert tr.wall_s() >= 0.95 * wall - 0.01
    finally:
        router.close()


@pytest.mark.slow
def test_chaos_replica_kill_and_drain_keeps_goodput(fleet2):
    """Open loop against 3 replicas; one is stopped and another drained
    mid-run: every scheduled request completes or surfaces an error, at
    least 90% complete, goodput recovers, hedges stay in their budget."""
    from triton_client_tpu_torch.utils.loadgen import run_open_loop

    servers, endpoints = fleet2(n=3)
    router = trouter.FrontDoorRouter(endpoints, models=("double",), probe_interval_s=0.25,
                                     probe_timeout_s=1.0, timeout_s=10.0, eject_threshold=2,
                                     base_ejection_s=0.5)
    scen = [("double", {"x": X})]
    try:
        steady = run_open_loop(router, scen, rate_qps=30.0, duration_s=1.5, seed=7,
                               deadline_s=10.0)
        assert steady.completed == steady.scheduled, steady.errors
        steady_goodput = steady.goodput_qps(1000.0)

        def chaos():
            time.sleep(0.8)
            servers[0].stop()
            servers[1].drain(timeout_s=10.0)

        ct = threading.Thread(target=chaos)
        ct.start()
        chaotic = run_open_loop(router, scen, rate_qps=30.0, duration_s=3.0, seed=8,
                                deadline_s=10.0, warm=False)
        ct.join(timeout=20.0)
        assert chaotic.completed + len(chaotic.errors) == chaotic.scheduled
        assert chaotic.completed >= 0.9 * chaotic.scheduled, chaotic.errors[:5]
        time.sleep(2 * 0.25 + 0.1)
        recovered = run_open_loop(router, scen, rate_qps=30.0, duration_s=1.5, seed=9,
                                  deadline_s=10.0, warm=False)
        assert recovered.completed == recovered.scheduled, recovered.errors[:5]
        assert recovered.goodput_qps(1000.0) >= 0.9 * steady_goodput
        s = router.stats()
        assert s["hedges_launched"] <= 0.05 * max(s["requests_total"], 20)
        assert s["requests_total"] == steady.scheduled + chaotic.scheduled + \
            recovered.scheduled + 1  # the steady window's warm request
    finally:
        router.close()
