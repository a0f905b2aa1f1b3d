"""Front-door router: health-aware replica routing with tail tolerance (the
port's copy of ``runtime/router.py``).

``FrontDoorRouter`` owns N ``GRPCChannel`` endpoints, one ``serve`` replica
each (``serve --replica-of LABEL``), and routes inference across them with
the four disciplines a replicated front door needs (*The Tail at Scale*,
Envoy's outlier detection):

- **health**: a probe loop calls ServerReady (and ModelReady for a set of
  models) on every replica each interval, and passive outlier ejection
  holds a replica out after consecutive connection-class failures, for a
  hold that doubles with each ejection. A drain is not a death: a
  not-ready probe or an UNAVAILABLE "draining" answer takes the replica
  out of rotation without abandoning its in-flight attempts and without
  charging the retry budget.
- **load**: power of two choices over the replicas' in-flight counts.
- **tail tolerance**: a request unanswered past the router's own latency
  quantile is hedged on a second replica; the first answer wins and the
  loser is cancelled. Hedges are capped at a fraction of the traffic.
- **retry discipline**: a token-bucket budget shared by the set: each
  routed request deposits ``ratio`` tokens and a failover retry spends
  one, so a failing fleet surfaces errors instead of amplifying them.
  Retries and hedges respect the request's remaining ``deadline_s``.

Stateful requests (``sequence_id``) are pinned to one replica by
rendezvous hashing and never hedged; on failover the stream re-homes to
its runner-up with ``sequence_start`` set, and its session restarts there.

The router quacks like a ``BaseChannel``, so ``utils/loadgen.py`` drives a
fleet as it drives one server. It reaches ``grpc`` only through the
default channel factory (``GRPCChannel``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import queue
import random
import threading
import time
from typing import Callable, Sequence

from triton_client_tpu_torch.channel.base import InferFuture, InferRequest, InferResponse
from triton_client_tpu_torch.obs.histogram import LatencyHistogram, quantile_from_snapshot
from triton_client_tpu_torch.obs.logs import log_tag
from triton_client_tpu_torch.obs.trace import (
    SUMMARY_PARAM_KEY,
    TraceContext,
    decode_span_summary,
    graft_span_summary,
)

log = logging.getLogger(__name__)

# Status-code names the router classifies on: names, not grpc.StatusCode
# members, so any exception with .code() classifies (RpcErrors, the
# channel's DeadlineExceededRpcError, test fakes).
_CONNECTION_CLASS = ("UNAVAILABLE",)  # eject-worthy, retry elsewhere
_SHED = "RESOURCE_EXHAUSTED"          # a deliberate server shed: never retried
_DEADLINE = "DEADLINE_EXCEEDED"       # the caller's budget is gone: surface


def _status_name(exc: BaseException) -> str | None:
    code = getattr(exc, "code", None)
    if not callable(code):
        return None
    try:
        c = code()
    except Exception:
        return None
    return getattr(c, "name", None) or (str(c) if c is not None else None)


def _is_draining(exc: BaseException) -> bool:
    details = getattr(exc, "details", None)
    if not callable(details):
        return False
    try:
        return "draining" in (details() or "")
    except Exception:
        return False


class RetryBudget:
    """Token-bucket retry budget shared across a replica set: tokens accrue
    at ``ratio`` a routed request, a retry costs one, the bucket is capped
    so a quiet period cannot bank a burst. ``floor_hits`` counts denials."""

    def __init__(self, ratio: float = 0.2, cap: float = 10.0, initial: float = 3.0) -> None:
        self._ratio = float(ratio)
        self._cap = float(cap)
        self._tokens = min(float(initial), self._cap)
        self._floor_hits = 0
        self._spent = 0

    def deposit(self) -> None:
        self._tokens = min(self._tokens + self._ratio, self._cap)

    def try_spend(self) -> bool:
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            self._spent += 1
            return True
        self._floor_hits += 1
        return False

    @property
    def tokens(self) -> float:
        return self._tokens

    @property
    def floor_hits(self) -> int:
        return self._floor_hits

    @property
    def spent(self) -> int:
        return self._spent


class Replica:
    """One endpoint's routing state, mutated under the owning
    ``ReplicaSet``'s lock; the channel itself is thread-safe."""

    __slots__ = (
        "endpoint", "channel", "inflight", "consecutive_failures",
        "ejected_until", "ejections", "probe_ready", "draining",
        "successes", "failures",
    )

    def __init__(self, endpoint: str, channel) -> None:
        self.endpoint = endpoint
        self.channel = channel
        self.inflight = 0
        self.consecutive_failures = 0
        self.ejected_until = 0.0
        self.ejections = 0
        # optimistic until the first probe: a router in front of a healthy
        # fleet routes before its first probe
        self.probe_ready = True
        self.draining = False
        self.successes = 0
        self.failures = 0

    def ejected(self, now: float) -> bool:
        return now < self.ejected_until

    def available(self, now: float) -> bool:
        return self.probe_ready and not self.draining and not self.ejected(now)


class ReplicaSet:
    """The replicas: health probing, outlier ejection, p2c and affinity
    picks (apart from the hedging state machine, so it tests alone)."""

    def __init__(
        self,
        endpoints: Sequence[str],
        *,
        channel_factory: Callable[[str], object] | None = None,
        models: Sequence[str] = (),
        probe_interval_s: float = 0.5,
        probe_timeout_s: float = 1.0,
        eject_threshold: int = 3,
        base_ejection_s: float = 1.0,
        max_ejection_s: float = 30.0,
        timeout_s: float = 30.0,
    ) -> None:
        if not endpoints:
            raise ValueError("a replica set needs at least one endpoint")
        if channel_factory is None:
            from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel

            # retries=0: the router is the retry policy. A channel-level
            # ladder under it would retry a dying replica while the budget
            # thinks no retry happened
            def channel_factory(ep):
                return GRPCChannel(ep, timeout_s=timeout_s, retries=0)

        self._lock = threading.Lock()
        self.replicas = [Replica(ep, channel_factory(ep)) for ep in endpoints]
        self._models = tuple(models)
        self._probe_interval_s = float(probe_interval_s)
        self._probe_timeout_s = float(probe_timeout_s)
        self._eject_threshold = int(eject_threshold)
        self._base_ejection_s = float(base_ejection_s)
        self._max_ejection_s = float(max_ejection_s)
        self._ejections_total = 0
        self._rng = random.Random()
        self._stop = threading.Event()
        self._prober: threading.Thread | None = None
        if self._probe_interval_s > 0:
            self._prober = threading.Thread(
                target=self._probe_loop, name="router-prober", daemon=True)
            self._prober.start()

    # -- health ---------------------------------------------------------------

    def _probe_loop(self) -> None:
        while not self._stop.wait(self._probe_interval_s):
            try:
                self.probe_once()
            except Exception:
                log.exception("router probe pass failed")

    def probe_once(self) -> None:
        """One active health pass over every replica (tests call it without
        the background thread)."""
        for rep in self.replicas:
            ready = rep.channel.server_ready(timeout_s=self._probe_timeout_s)
            if ready:
                for model in self._models:
                    if not rep.channel.model_ready(model, timeout_s=self._probe_timeout_s):
                        ready = False
                        break
            with self._lock:
                was = rep.probe_ready
                rep.probe_ready = ready
                if ready:
                    # an affirmative probe supersedes stale passive signals:
                    # the drain flag and the failure streak are over
                    rep.draining = False
                    rep.consecutive_failures = 0
                elif was:
                    log.warning("replica %s failed health probe; out of rotation",
                                rep.endpoint)

    def record_success(self, rep: Replica) -> None:
        with self._lock:
            rep.successes += 1
            rep.consecutive_failures = 0

    def record_failure(self, rep: Replica, connection_class: bool) -> None:
        """Passive outlier signal: connection-class failures streak toward
        ejection; the others count but never eject (a model returning
        INTERNAL is no reason to burn a replica)."""
        with self._lock:
            rep.failures += 1
            if not connection_class:
                return
            rep.consecutive_failures += 1
            if rep.consecutive_failures >= self._eject_threshold:
                hold = min(self._base_ejection_s * (2.0 ** rep.ejections), self._max_ejection_s)
                rep.ejected_until = time.perf_counter() + hold
                rep.ejections += 1
                rep.consecutive_failures = 0
                self._ejections_total += 1
                log.warning("ejecting replica %s for %.1fs (%d consecutive connection "
                            "failures, ejection #%d)", rep.endpoint, hold,
                            self._eject_threshold, rep.ejections)

    def mark_draining(self, rep: Replica) -> None:
        with self._lock:
            if not rep.draining:
                log.info("replica %s is draining; out of rotation", rep.endpoint)
            rep.draining = True

    # -- load -----------------------------------------------------------------

    def _pool(self, now: float, exclude: Sequence[Replica]) -> list[Replica]:
        """The candidates, under the lock: the available replicas less
        ``exclude``; if none, the panic ladder: the non-draining ones (they
        may have recovered), then anything not excluded. A request is
        always attempted somewhere rather than failed on the floor."""
        pool = [r for r in self.replicas if r.available(now) and r not in exclude]
        if not pool:
            pool = [r for r in self.replicas if not r.draining and r not in exclude]
        if not pool:
            pool = [r for r in self.replicas if r not in exclude]
        return pool

    def pick(self, exclude: Sequence[Replica] = ()) -> Replica | None:
        """Power of two choices over the candidates (a hedge excludes the
        replica it hedges); counts the pick in flight."""
        now = time.perf_counter()
        with self._lock:
            pool = self._pool(now, exclude)
            if not pool:
                return None
            if len(pool) == 1:
                pick = pool[0]
            else:
                a, b = self._rng.sample(pool, 2)
                pick = a if a.inflight <= b.inflight else b
            pick.inflight += 1
            return pick

    def pick_affinity(self, stream_id: str, exclude: Sequence[Replica] = ()) -> Replica | None:
        """Rendezvous (highest-random-weight) pick for a stateful stream:
        every router hashing ``stream_id`` over the same endpoints lands on
        the same replica, and when it dies only its streams move, each to
        its runner-up. Same ladder and in-flight count as :meth:`pick`;
        ``exclude`` is the failover path (the dead owner)."""
        now = time.perf_counter()
        with self._lock:
            pool = self._pool(now, exclude)
            if not pool:
                return None
            pick = max(pool, key=lambda r: (_rendezvous_score(stream_id, r.endpoint), r.endpoint))
            pick.inflight += 1
            return pick

    def release(self, rep: Replica) -> None:
        with self._lock:
            rep.inflight -= 1

    # -- surface --------------------------------------------------------------

    def available_count(self) -> int:
        now = time.perf_counter()
        with self._lock:
            return sum(1 for r in self.replicas if r.available(now))

    def snapshot(self) -> list[dict]:
        now = time.perf_counter()
        with self._lock:
            return [
                {
                    "endpoint": r.endpoint,
                    # the negotiated transport (uds+shm, shm, uds, grpc); a
                    # custom channel factory may not expose one
                    "transport": getattr(r.channel, "transport", "grpc"),
                    "inflight": r.inflight,
                    "probe_ready": r.probe_ready,
                    "draining": r.draining,
                    "ejected": r.ejected(now),
                    "ejections": r.ejections,
                    "consecutive_failures": r.consecutive_failures,
                    "successes": r.successes,
                    "failures": r.failures,
                }
                for r in self.replicas
            ]

    @property
    def ejections_total(self) -> int:
        with self._lock:
            return self._ejections_total

    def close(self) -> None:
        self._stop.set()
        if self._prober is not None:
            self._prober.join(timeout=2 * self._probe_interval_s + 2.0)
        for rep in self.replicas:
            try:
                rep.channel.close()
            except Exception:
                pass


def _rendezvous_score(stream_id: str, endpoint: str) -> int:
    """Stable 64-bit weight of (stream, endpoint): hashlib, not hash(), so
    every process and every restart agrees."""
    digest = hashlib.blake2b(f"{stream_id}|{endpoint}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big")


class _AttemptCarrier:
    """Trace stand-in on an attempt's request. The transport reads only
    ``.context`` off ``request.trace``; handing it the router's own trace
    would land channel spans on the router's row once per raced sibling.
    Each attempt carries a fresh child context instead, and only the
    winner's server summary is grafted back."""

    __slots__ = ("context",)

    def __init__(self, context: TraceContext) -> None:
        self.context = context


class _Attempt:
    __slots__ = ("replica", "future", "kind", "index", "t_sent")

    def __init__(self, replica: Replica, future: InferFuture, kind: str, index: int = 0,
                 t_sent: float = 0.0):
        self.replica = replica
        self.future = future
        self.kind = kind  # "primary" | "retry" | "hedge"
        self.index = index  # attempt ordinal within the request
        self.t_sent = t_sent

    def attrs(self, **extra) -> dict:
        out = {"attempt": self.index, "endpoint": self.replica.endpoint, "kind": self.kind}
        out.update(extra)
        return out


class FrontDoorRouter:
    """Routes inference across a ``ReplicaSet`` with hedging and a shared
    retry budget. Quacks like a ``BaseChannel``.

    - ``hedge_quantile`` / ``hedge_min_samples``: the hedge delay is the
      router's own end-to-end latency quantile, and nothing is hedged until
      the histogram holds ``hedge_min_samples`` observations.
    - ``hedge_budget_fraction``: hedges never exceed this fraction of the
      routed requests (of at least 20).
    - ``max_attempts``: attempts a request (primary and failover retries);
      a hedge is the same attempt raced, and does not count.
    - ``tracer``: an ``obs.trace.Tracer``. The router is then the trace's
      origin (or forwards an inbound ``request.trace.context``): each
      attempt carries a child context on the wire, attempts land as sibling
      ``attempt`` spans tagged {attempt, endpoint, kind} (hedge losers with
      ``cancelled=True``), and the winner's span summary is grafted once.
    """

    def __init__(
        self,
        endpoints: Sequence[str],
        *,
        channel_factory: Callable[[str], object] | None = None,
        models: Sequence[str] = (),
        probe_interval_s: float = 0.5,
        probe_timeout_s: float = 1.0,
        eject_threshold: int = 3,
        base_ejection_s: float = 1.0,
        max_ejection_s: float = 30.0,
        timeout_s: float = 30.0,
        hedge_quantile: float = 0.95,
        hedge_min_samples: int = 50,
        hedge_budget_fraction: float = 0.05,
        retry_budget_ratio: float = 0.2,
        retry_budget_cap: float = 10.0,
        max_attempts: int = 3,
        tracer=None,
    ) -> None:
        self.replica_set = ReplicaSet(
            endpoints,
            channel_factory=channel_factory,
            models=models,
            probe_interval_s=probe_interval_s,
            probe_timeout_s=probe_timeout_s,
            eject_threshold=eject_threshold,
            base_ejection_s=base_ejection_s,
            max_ejection_s=max_ejection_s,
            timeout_s=timeout_s,
        )
        self._timeout_s = float(timeout_s)
        self._hedge_quantile = float(hedge_quantile)
        self._hedge_min_samples = int(hedge_min_samples)
        self._hedge_budget_fraction = float(hedge_budget_fraction)
        self._max_attempts = max(1, int(max_attempts))
        self._tracer = tracer
        self._latency = LatencyHistogram()
        self._lock = threading.Lock()
        self._budget = RetryBudget(ratio=retry_budget_ratio, cap=retry_budget_cap)
        self._requests_total = 0
        self._hedges_launched = 0
        self._hedges_won = 0
        self._hedges_lost = 0
        self._hedges_denied = 0
        self._failovers = 0
        self._drain_failovers = 0
        self._affinity_routed = 0
        self._affinity_handoffs = 0
        self._errors = 0

    def attach_quality(self, quality) -> None:
        """The quality plane at the front door is not ported yet."""
        from triton_client_tpu_torch.runtime.server import not_ported

        raise not_ported("quality")

    # -- BaseChannel quack ----------------------------------------------------

    def register_channel(self) -> None:  # channels are dialled in __init__
        pass

    def fetch_channel(self):
        return self.replica_set

    def get_metadata(self, model_name: str, model_version: str = ""):
        """The model contract from a replica, available ones first (replicas
        serve identical repositories; a failure falls through to the next)."""
        last: Exception | None = None
        now = time.perf_counter()
        for rep in sorted(self.replica_set.replicas, key=lambda r: not r.available(now)):
            try:
                return rep.channel.get_metadata(model_name, model_version)
            except Exception as e:
                last = e
        raise last if last is not None else RuntimeError("no replicas")

    def do_inference_async(self, request: InferRequest) -> InferFuture:
        """A lazy future over the routed call: the hedging state machine runs
        on whichever thread resolves it (loadgen's resolver pool)."""
        return InferFuture(lambda: self.do_inference(request))

    # -- routing core ---------------------------------------------------------

    def _hedge_delay_s(self) -> float | None:
        """The hedge trigger, the rolling end-to-end quantile; None (no
        hedging) until enough samples exist to trust it."""
        snap = self._latency.snapshot()
        if snap["count"] < self._hedge_min_samples:
            return None
        return quantile_from_snapshot(snap, self._hedge_quantile)

    def _hedge_allowed(self) -> bool:
        with self._lock:
            allowed = (self._hedges_launched + 1
                       <= self._hedge_budget_fraction * max(self._requests_total, 20))
            if not allowed:
                self._hedges_denied += 1
            return allowed

    def _launch(self, rep: Replica, request: InferRequest, done: queue.SimpleQueue, kind: str,
                index: int = 0, ctx: TraceContext | None = None) -> _Attempt:
        """Issue one attempt on ``rep``. Its done-callback releases the
        replica's in-flight count and posts the completion; it runs on the
        transport's completion thread, so it only queues."""
        out = request
        if ctx is not None:
            out = dataclasses.replace(request, trace=_AttemptCarrier(ctx.child()))
        t_sent = time.perf_counter()
        fut = rep.channel.do_inference_async(out)
        att = _Attempt(rep, fut, kind, index, t_sent)
        released = []  # a once-flag: gRPC may fire twice

        def _on_done() -> None:
            if not released:
                released.append(True)
                self.replica_set.release(rep)
                done.put(att)

        fut.add_done_callback(_on_done)
        return att

    def do_inference(self, request: InferRequest) -> InferResponse:
        """Route one request, inside the router's trace when a tracer is
        set: forwarding an inbound context (a middle hop) or originating
        one (the front door)."""
        if self._tracer is None:
            return self._route(request, None, None)
        inbound = getattr(request.trace, "context", None) if request.trace is not None else None
        ctx = inbound.child() if inbound is not None else TraceContext.new()
        trace = self._tracer.start(model=request.model_name, request_id=request.request_id,
                                   context=ctx)
        try:
            resp = self._route(request, trace, ctx)
        except BaseException as e:
            self._tracer.finish(trace, status=_status_name(e) or type(e).__name__)
            raise
        self._tracer.finish(trace, status="ok")
        return resp

    @staticmethod
    def _attempt_span(trace, att: _Attempt, **extra) -> None:
        """Close ``att``'s sibling ``attempt`` span on the router's trace."""
        if trace is not None:
            trace.add("attempt", att.t_sent, time.perf_counter(), att.attrs(**extra))

    def _cancel_all(self, trace, outstanding: list[_Attempt]) -> None:
        for o in outstanding:
            o.future.cancel()
            self._attempt_span(trace, o, cancelled=True)

    def _route(self, request: InferRequest, trace, ctx: TraceContext | None) -> InferResponse:
        t0 = time.perf_counter()
        with self._lock:
            self._requests_total += 1
            self._budget.deposit()
        deadline = request.deadline_s
        done: queue.SimpleQueue = queue.SimpleQueue()
        stream_id = request.sequence_id
        if stream_id:
            # a stateful request: its session lives on one replica, which
            # rendezvous hashing pins, and it is never hedged (a hedge would
            # run the tracking step twice)
            hedge_delay = None
            rep = self.replica_set.pick_affinity(stream_id)
            with self._lock:
                self._affinity_routed += 1
        else:
            hedge_delay = self._hedge_delay_s()
            rep = self.replica_set.pick()
        if rep is None:
            raise RuntimeError("replica set is empty")
        outstanding = [self._launch(rep, request, done, "primary", 0, ctx)]
        attempts_made = 1
        attempt_idx = 0  # span ordinal: hedges count here, not in attempts_made
        hedge_spent = False

        while True:
            # wait for the next completion, or the hedge trigger
            timeout: float | None = None
            if deadline is not None:
                timeout = max(deadline - time.perf_counter(), 0.001)
            if hedge_delay is not None and not hedge_spent and len(outstanding) == 1:
                until_hedge = max(t0 + hedge_delay - time.perf_counter(), 0.0)
                timeout = until_hedge if timeout is None else min(timeout, until_hedge)
            try:
                att = done.get(timeout=timeout)
            except queue.Empty:
                if deadline is not None and time.perf_counter() >= deadline:
                    # nobody waits any more: abandon what is in flight (its
                    # callbacks release the slots) and surface the deadline
                    self._cancel_all(trace, outstanding)
                    self._count_error()
                    raise _deadline_error(
                        "router deadline expired with %d attempt(s) in flight"
                        % len(outstanding))
                hedge_spent = True  # one hedge a request, win or lose
                if self._hedge_allowed():
                    hrep = self.replica_set.pick(exclude=[o.replica for o in outstanding])
                    if hrep is not None:
                        with self._lock:
                            self._hedges_launched += 1
                        attempt_idx += 1
                        if log.isEnabledFor(logging.DEBUG):
                            log.debug("hedging on %s after %.1f ms%s", hrep.endpoint,
                                      hedge_delay * 1e3, log_tag(trace, request.request_id))
                        outstanding.append(
                            self._launch(hrep, request, done, "hedge", attempt_idx, ctx))
                continue

            outstanding = [o for o in outstanding if o is not att]
            try:
                resp = att.future.result()
            except BaseException as e:
                self._attempt_span(trace, att, error=_status_name(e) or type(e).__name__)
                if not self._on_attempt_failure(att, e):
                    # not retryable (shed, deadline, unknown): the attempts
                    # in flight can no longer change the outcome
                    self._cancel_all(trace, outstanding)
                    self._count_error()
                    raise
                if outstanding:
                    continue  # the raced hedge is already the retry
                retry_rep = self._try_retry(att, e, attempts_made, deadline,
                                            tag=log_tag(trace, request.request_id),
                                            stream_id=stream_id)
                if retry_rep is None:
                    self._count_error()
                    raise
                if stream_id:
                    # the failover handoff: the session re-homes to the
                    # rendezvous runner-up and restarts there (a fresh epoch,
                    # disjoint track ids), never resuming the old owner's state
                    request = dataclasses.replace(request, sequence_start=True)
                    with self._lock:
                        self._affinity_handoffs += 1
                    log.warning("stream %s re-homed %s -> %s (session restarts)%s", stream_id,
                                att.replica.endpoint, retry_rep.endpoint,
                                log_tag(trace, request.request_id))
                attempts_made += 1
                attempt_idx += 1
                outstanding.append(
                    self._launch(retry_rep, request, done, "retry", attempt_idx, ctx))
                continue

            # the winner
            t_recv = time.perf_counter()
            self.replica_set.record_success(att.replica)
            hedge_in_flight = any(o.kind == "hedge" for o in outstanding)
            # hedge losers stay visible as cancelled sibling spans, with no
            # server summary grafted: the timeline counts device time once
            self._cancel_all(trace, outstanding)
            if trace is not None:
                self._attempt_span(trace, att)
                summary = decode_span_summary((resp.parameters or {}).get(SUMMARY_PARAM_KEY, ""))
                if summary is not None:
                    graft_span_summary(trace, summary, att.t_sent, t_recv, attrs=att.attrs())
                trace.add("route", t0, time.perf_counter())
            with self._lock:
                if att.kind == "hedge":
                    self._hedges_won += 1
                elif hedge_in_flight:
                    self._hedges_lost += 1
            self._latency.observe(time.perf_counter() - t0)
            return resp

    def _on_attempt_failure(self, att: _Attempt, exc: BaseException) -> bool:
        """Classify one failed attempt and update health; True when another
        replica may retry it."""
        name = _status_name(exc)
        if name in _CONNECTION_CLASS:
            if _is_draining(exc):
                # an orchestrated drain: out of rotation, no ejection streak
                self.replica_set.mark_draining(att.replica)
            else:
                self.replica_set.record_failure(att.replica, connection_class=True)
            return True
        # a shed (retrying feeds the overload), a spent deadline, or an
        # application error (another replica says the same no): count, do
        # not eject, do not retry
        self.replica_set.record_failure(att.replica, connection_class=False)
        return False

    def _try_retry(self, att: _Attempt, exc: BaseException, attempts_made: int,
                   deadline: float | None, tag: str = "",
                   stream_id: str = "") -> Replica | None:
        """Gate and pick of a failover retry: a drain failover is free, any
        other spends a token. A stream re-picks by rendezvous less the dead
        owner, so all its frames land on one survivor. None: surface."""
        if attempts_made >= self._max_attempts:
            return None
        if deadline is not None and time.perf_counter() >= deadline:
            return None
        draining = _is_draining(exc)
        if not draining:
            with self._lock:
                if not self._budget.try_spend():
                    log.warning("retry budget at floor (%d denials); surfacing failure "
                                "from %s%s", self._budget.floor_hits, att.replica.endpoint, tag)
                    return None
        if stream_id:
            rep = self.replica_set.pick_affinity(stream_id, exclude=[att.replica])
        else:
            rep = self.replica_set.pick(exclude=[att.replica])
        if rep is None:
            return None
        with self._lock:
            self._failovers += 1
            if draining:
                self._drain_failovers += 1
        return rep

    def _count_error(self) -> None:
        with self._lock:
            self._errors += 1

    # -- surface --------------------------------------------------------------

    def stats(self) -> dict:
        """Flat counters, collector-style (tests and scripts diff two)."""
        hedge_delay = self._hedge_delay_s()
        with self._lock:
            return {
                "requests_total": self._requests_total,
                "errors_total": self._errors,
                "hedges_launched": self._hedges_launched,
                "hedges_won": self._hedges_won,
                "hedges_lost": self._hedges_lost,
                "hedges_denied": self._hedges_denied,
                "failovers": self._failovers,
                "drain_failovers": self._drain_failovers,
                "affinity_routed": self._affinity_routed,
                "affinity_handoffs": self._affinity_handoffs,
                "retry_budget_tokens": self._budget.tokens,
                "retry_budget_floor_hits": self._budget.floor_hits,
                "retries_spent": self._budget.spent,
                "ejections_total": self.replica_set.ejections_total,
                "replicas_total": len(self.replica_set.replicas),
                "replicas_available": self.replica_set.available_count(),
                "hedge_delay_s": hedge_delay if hedge_delay else 0.0,
            }

    def snapshot(self) -> dict:
        """``stats()`` with each replica's detail and the latency histogram:
        what ``route`` and the collector read."""
        snap = self.stats()
        snap["replicas"] = self.replica_set.snapshot()
        snap["latency"] = self._latency.snapshot()
        return snap

    def close(self) -> None:
        self.replica_set.close()


def _deadline_error(msg: str):
    """The channel's client-local DEADLINE_EXCEEDED, so a router deadline
    classifies like any other."""
    from triton_client_tpu_torch.channel.grpc_channel import DeadlineExceededRpcError

    return DeadlineExceededRpcError(msg)


class RouterCollector:
    """Prometheus collector over a ``FrontDoorRouter`` snapshot, registered
    as ``RuntimeCollector`` is: ``registry.register(RouterCollector(r))``.
    ``prometheus_client`` is imported in ``collect()`` only."""

    COUNTERS = {
        "tpu_router_requests_total": ("requests_total", "routed requests"),
        "tpu_router_errors_total": ("errors_total", "surfaced errors"),
        "tpu_router_hedges_total": ("hedges_launched", "hedges launched"),
        "tpu_router_hedges_won_total": ("hedges_won", "hedges that won"),
        "tpu_router_failovers_total": ("failovers", "failover retries"),
        "tpu_router_affinity_routed_total": (
            "affinity_routed", "stream requests routed by rendezvous"),
        "tpu_router_affinity_handoffs_total": (
            "affinity_handoffs", "stream sessions re-homed on failover"),
        "tpu_router_ejections_total": ("ejections_total", "ejections"),
        "tpu_router_retry_budget_floor_total": (
            "retry_budget_floor_hits", "retries denied at budget floor"),
    }

    def __init__(self, router: FrontDoorRouter) -> None:
        self._router = router

    def collect(self):
        from prometheus_client.core import CounterMetricFamily, GaugeMetricFamily

        snap = self._router.snapshot()
        for fam, (key, help_) in self.COUNTERS.items():
            c = CounterMetricFamily(fam, help_)
            c.add_metric([], float(snap[key]))
            yield c
        g = GaugeMetricFamily("tpu_router_retry_budget_tokens", "retry-budget token level")
        g.add_metric([], float(snap["retry_budget_tokens"]))
        yield g
        g = GaugeMetricFamily("tpu_router_hedge_delay_seconds", "current hedge trigger delay")
        g.add_metric([], float(snap["hedge_delay_s"]))
        yield g
        healthy = GaugeMetricFamily("tpu_router_replica_available",
                                    "1 if the replica is in rotation", labels=["endpoint"])
        inflight = GaugeMetricFamily("tpu_router_replica_inflight",
                                     "live in-flight attempts on the replica",
                                     labels=["endpoint"])
        for r in snap["replicas"]:
            ok = r["probe_ready"] and not r["draining"] and not r["ejected"]
            healthy.add_metric([r["endpoint"]], 1.0 if ok else 0.0)
            inflight.add_metric([r["endpoint"]], float(r["inflight"]))
        yield healthy
        yield inflight
