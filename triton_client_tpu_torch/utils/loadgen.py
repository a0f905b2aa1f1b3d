"""Closed- and open-loop gRPC load generators for serving benchmarks (port
of ``utils/loadgen.py``, without the streaming replay).

The role Triton's ``perf_analyzer`` plays in the reference's ecosystem
(its README benchmarks the server with concurrent closed-loop clients):
N threads, each with its own ``GRPCChannel``, issuing one ModelInfer after
another against a KServe v2 endpoint (the port's ``serve``), with a
warm-before-measure barrier so neither the threads' ramp nor a first
request's graph capture biases the measured window.

Client lifecycle per thread:
  1. staggered connect and one warm request (staggering avoids N
     simultaneous payload uploads blowing deadlines on a small host);
  2. barrier: every thread arrives, warmed or failed;
  3. closed loop until ``stop`` is set, per-request latency recorded;
  4. channel closed (which unregisters its shared-memory regions), counts
     merged under a lock.

``run_pool`` returns after every client thread has exited: a straggler
blocked on a slow request is waited out (bounded by the request deadline),
never left running into the next measurement.

Open loop (the MLPerf-Inference "server scenario"): ``run_pool``'s closed
loop hides queueing collapse, because each client waits for its response
before it sends again, so the offered load slows down with the server
(coordinated omission). ``run_open_loop`` issues requests on a seeded
Poisson schedule (``poisson_schedule``) that does not wait on the server:
the dispatcher never blocks on a response, and every latency is measured
from the request's scheduled arrival, so a request issued late still
charges the server for the wait. Unanswered or failed requests score +Inf
in the percentile (``co_percentile``), so saturation reads as a blown
p99, never as a shrunk sample. ``slo_capacity_search`` searches the
offered rate for the largest one whose p99 meets an SLO.

Not ported yet: ``run_streams``, ``synthetic_stream`` and their scoring
(``StreamStats``, ``StreamsResult``), which replay tracked streams and
wait for the streaming sessions (ROADMAP.md Queue 1 item 8, step 4). A
list of addresses (a replica fleet) needs the front-door router (item 8,
step 5).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class PoolResult:
    served_frames: int
    wall_s: float
    latencies_ms: list = field(default_factory=list)
    errors: list = field(default_factory=list)

    @property
    def fps(self) -> float:
        return self.served_frames / self.wall_s if self.wall_s > 0 else 0.0


def run_pool(
    address: str,
    model_name: str,
    inputs: dict,
    clients: int,
    duration_s: float,
    deadline_s: float = 300.0,
    use_shared_memory: bool | None = None,
    stagger_s: float = 0.25,
    on_window_start=None,
    mode: str = "unary",
    inflight: int = 1,
    stream_group: int = 1,
) -> PoolResult:
    """Drive ``clients`` closed-loop threads for ``duration_s`` and
    return counts/latencies. ``on_window_start`` fires after the warm
    barrier, immediately before the timed window — the hook for
    clearing server-side accounting (batcher stats, occupancy taps).

    ``mode`` selects the client protocol (it puts numbers on the
    reference's --streaming/--async flags, main.py:59-70):
      * 'unary'  — one synchronous ModelInfer per iteration (default);
      * 'stream' — ONE long-lived ModelStreamInfer session per client,
        ``inflight`` requests pipelined inside it (latency = send ->
        matching response; responses preserve order on a stream);
      * 'async'  — ModelInfer call-futures with ``inflight`` in the
        air per client (the --async --inflight N path).

    ``use_shared_memory=None`` (default) lets each channel
    auto-negotiate its transport from the endpoint — shm on loopback /
    unix: targets, plain wire otherwise; pass True/False to pin it.

    ``stream_group`` (stream mode only) packs that many frames into one
    ModelStreamInfer message (the multi-frame group protocol); it is
    clamped to ``inflight`` because a closed-loop client can never have
    more than ``inflight`` frames buffered toward a group.
    """
    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel

    if mode not in ("unary", "stream", "async"):
        raise ValueError(f"unknown pool mode {mode!r}")
    inflight = max(1, int(inflight))
    # a group can only fill from frames the closed loop has in flight
    stream_group = max(1, min(int(stream_group), inflight))

    served: list = []
    latencies: list = []
    errors: list = []
    lock = threading.Lock()
    stop = threading.Event()
    ready = threading.Barrier(clients + 1)
    # the warm phase is bounded by one request deadline plus the
    # connect stagger: a barrier timeout shorter than deadline_s would
    # break the barrier while a slow warm (a first request's graph
    # capture) is still legitimate
    barrier_timeout_s = deadline_s + stagger_s * clients + 60.0

    def client_loop(idx: int):
        n, mine = 0, []  # n counts only completions INSIDE the window
        chan = req = None
        try:
            time.sleep(stagger_s * (idx % 4))
            chan = GRPCChannel(
                address,
                timeout_s=deadline_s,
                use_shared_memory=use_shared_memory,
            )
            req = InferRequest(model_name=model_name, inputs=inputs)
            chan.do_inference(req)  # connection + server path warm
        except Exception as e:
            with lock:
                errors.append(repr(e))
            chan = None
        try:
            # EVERY thread reaches the barrier, warm or not — a failed
            # warm must not strand the caller's wait
            ready.wait(timeout=barrier_timeout_s)
        except threading.BrokenBarrierError:
            pass
        try:
            if chan is not None and mode == "unary":
                while not stop.is_set():
                    t0 = time.perf_counter()
                    chan.do_inference(req)
                    mine.append((time.perf_counter() - t0) * 1e3)
                    # a completion racing the window close (the final
                    # in-flight request) is drained but NOT counted —
                    # fps must be completions-in-window / window, not
                    # diluted by the post-stop drain time
                    if not stop.is_set():
                        n += 1
            elif chan is not None and mode == "stream":
                import queue as _q

                sent: _q.Queue = _q.Queue(maxsize=inflight)

                def gen():
                    # closed-loop through the stream: the bounded queue
                    # caps in-flight requests; put blocks until a
                    # response frees a slot. The timestamp is taken
                    # AFTER the slot is granted, immediately before the
                    # request goes to gRPC — timing the backpressure
                    # wait would double-count the previous in-flight
                    # request's latency
                    while not stop.is_set():
                        cell = [0.0]
                        sent.put(cell)
                        cell[0] = time.perf_counter()
                        yield req

                for _resp in chan.infer_stream(
                    gen(),
                    stream_timeout_s=deadline_s,
                    group_size=stream_group,
                ):
                    t0 = sent.get()[0]
                    mine.append((time.perf_counter() - t0) * 1e3)
                    if not stop.is_set():
                        n += 1
            elif chan is not None:  # async futures, inflight in the air
                from collections import deque

                air: deque = deque()
                while not stop.is_set():
                    while len(air) < inflight and not stop.is_set():
                        air.append(
                            (time.perf_counter(), chan.do_inference_async(req))
                        )
                    if not air:  # stop raced the fill loop
                        break
                    t0, fut = air.popleft()
                    fut.result()
                    mine.append((time.perf_counter() - t0) * 1e3)
                    if not stop.is_set():
                        n += 1
                while air:  # drain, uncounted
                    air.popleft()[1].result()
        except Exception as e:  # a dying client must still report
            with lock:
                errors.append(repr(e))
        finally:
            if chan is not None:
                try:
                    chan.close()
                except Exception:
                    pass
            with lock:
                served.append(n)
                latencies.extend(mine)

    threads = [
        threading.Thread(target=client_loop, args=(i,)) for i in range(clients)
    ]
    for t in threads:
        t.start()
    wall = 0.0
    try:
        try:
            ready.wait(timeout=barrier_timeout_s)
        except threading.BrokenBarrierError as e:
            # a broken barrier aborts the window but must NOT skip the
            # stop/join in the finally — clients swallow
            # BrokenBarrierError and enter their request loop, so
            # without stop.set() they would keep issuing requests into
            # the caller's next measurement until server teardown
            with lock:
                errors.append(f"warm barrier broke: {e!r}")
        else:
            if on_window_start is not None:
                on_window_start()
            t_start = time.perf_counter()
            time.sleep(duration_s)
            # the measured window closes HERE: stragglers are drained
            # in the finally so nothing survives into the caller's
            # next measurement, but their drain time must not dilute
            # the reported rate
            wall = time.perf_counter() - t_start
    finally:
        stop.set()
        # wait stragglers OUT: an in-flight request is bounded by the
        # gRPC deadline, so this join always terminates
        for t in threads:
            t.join(timeout=deadline_s + 60.0)
        alive = [t for t in threads if t.is_alive()]
        if alive:
            errors.append(
                f"{len(alive)} client threads still alive after join"
            )
    return PoolResult(
        served_frames=sum(served),
        wall_s=wall,
        latencies_ms=latencies,
        errors=errors,
    )


# -- open-loop (MLPerf server-scenario) driver --------------------------------


def poisson_schedule(
    rate_qps: float,
    duration_s: float,
    seed: int = 0,
    weights=None,
):
    """Seeded Poisson arrival plan: ``(offsets_s, scenario_idx)``.

    ``offsets_s`` are arrival times relative to window start
    (exponential inter-arrival gaps at ``rate_qps``); ``scenario_idx``
    picks a traffic-mix entry per arrival, proportional to ``weights``
    (all zeros when no mix). Pure function of its arguments — the same
    seed replays the identical request timeline, which is what makes an
    open-loop capacity number reproducible and the determinism test
    possible."""
    import numpy as np

    rate = float(rate_qps)
    if rate <= 0 or duration_s <= 0:
        empty = np.zeros(0)
        return empty, np.zeros(0, dtype=int)
    rng = np.random.default_rng(int(seed))
    offsets = np.zeros(0)
    draw = max(16, int(rate * duration_s * 1.5) + 32)
    last = 0.0
    while last < duration_s:
        gaps = rng.exponential(1.0 / rate, size=draw)
        offsets = np.concatenate([offsets, last + np.cumsum(gaps)])
        last = float(offsets[-1])
    offsets = offsets[offsets < duration_s]
    if weights is not None and len(weights) > 1:
        w = np.asarray(weights, dtype=float)
        picks = rng.choice(len(w), size=len(offsets), p=w / w.sum())
    else:
        picks = np.zeros(len(offsets), dtype=int)
    return offsets, picks


@dataclass
class OpenLoopResult:
    offered_qps: float
    scheduled: int
    completed: int
    wall_s: float
    # completion - SCHEDULED arrival (not actual send): a request the
    # dispatcher issued late still charges the server for the backlog
    latencies_ms: list = field(default_factory=list)
    errors: list = field(default_factory=list)

    @property
    def achieved_qps(self) -> float:
        return self.completed / self.wall_s if self.wall_s > 0 else 0.0

    def percentile(self, q: float) -> float:
        """Coordinated-omission-safe percentile over the SCHEDULED
        population: requests that never completed (errors, drops) rank
        as +Inf, so a saturated probe cannot launder its tail by
        shedding samples."""
        return co_percentile(self.latencies_ms, self.scheduled, q)

    def attainment(self, slo_ms: float) -> float:
        """Fraction of SCHEDULED requests that completed within
        ``slo_ms``."""
        if self.scheduled <= 0:
            return 1.0
        ok = sum(1 for v in self.latencies_ms if v <= slo_ms)
        return ok / self.scheduled

    def goodput_qps(self, slo_ms: float) -> float:
        """SLO-met completions per second of the scheduled window —
        the capacity number that matters under shedding: offered load
        the server *served within budget*, not load it survived."""
        if self.wall_s <= 0:
            return 0.0
        return sum(1 for v in self.latencies_ms if v <= slo_ms) / self.wall_s

    @property
    def shed_count(self) -> int:
        """Requests the server deliberately rejected with
        RESOURCE_EXHAUSTED (admission door / bounded queue) — distinct
        from transport faults in the same ``errors`` list."""
        return sum(
            1 for e in self.errors if "RESOURCE_EXHAUSTED" in str(e)
        )

    @property
    def shed_rate(self) -> float:
        """Shed fraction of the SCHEDULED population."""
        if self.scheduled <= 0:
            return 0.0
        return self.shed_count / self.scheduled


def co_percentile(latencies_ms, scheduled: int, q: float) -> float:
    """Percentile ``q`` (0..100) of ``latencies_ms`` ranked within a
    population of ``scheduled`` requests; the missing tail is +Inf."""
    n = max(int(scheduled), len(latencies_ms))
    if n <= 0:
        return 0.0
    import math

    rank = min(n, max(1, math.ceil(q / 100.0 * n)))
    lats = sorted(latencies_ms)
    return lats[rank - 1] if rank <= len(lats) else float("inf")


def _dial(target, deadline_s: float):
    """Resolve a loadgen target into ``(channel, owned)``.

    Target shapes:
      * ``"host:port"`` — one endpoint, a fresh ``GRPCChannel``
        (owned: closed by the caller when the window ends);
      * ``["host:port", ...]`` — a replica set, which raises until the
        front-door router is ported (module docstring);
      * a channel-shaped object (anything with ``do_inference_async``)
        — used as-is and NOT closed, so one channel can be driven across
        several windows."""
    if isinstance(target, str):
        from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel

        return GRPCChannel(target, timeout_s=deadline_s), True
    if isinstance(target, (list, tuple)):
        raise NotImplementedError(
            "a list of addresses is driven through the front-door router, which is not "
            "ported yet (ROADMAP.md Queue 1 item 8, step 5: runtime/router.py)"
        )
    if hasattr(target, "do_inference_async"):
        return target, False
    raise TypeError(
        f"loadgen target must be an address, a list of addresses, or a "
        f"channel, not {type(target).__name__}"
    )


def run_open_loop(
    address,
    scenarios,
    rate_qps: float,
    duration_s: float,
    seed: int = 0,
    deadline_s: float = 60.0,
    warm: bool = True,
    resolvers: int = 16,
    request_factory=None,
) -> OpenLoopResult:
    """Drive one open-loop window against a KServe v2 endpoint.

    ``address`` is a ``_dial`` target: one endpoint string, or an
    already-built channel (driven, not closed).

    ``scenarios``: the traffic mix — a list of ``(model_name, inputs)``
    or ``(model_name, inputs, weight)`` tuples; arrivals pick a
    scenario proportionally to weight (seeded, like the schedule).

    Dispatch discipline: ONE thread walks the pre-generated schedule,
    sleeping to each arrival and issuing via the non-blocking gRPC call
    future — it never waits for a response, so the offered rate is
    independent of server health. A bounded pool of resolver threads
    drains completions and records latency from the scheduled arrival.
    At heavy overload the pool itself queues, which can only OVERSTATE
    tail latency — the conservative direction for a capacity search.
    Completions after the window still count (with their true
    latency); ``wall_s`` is the scheduled window.

    ``request_factory``: optional per-arrival hook
    ``(base_request, arrival_index) -> InferRequest`` replacing the
    default reuse of one InferRequest per scenario, e.g. to stamp a
    deterministic per-arrival ``request_id``; any exception falls back to
    the shared base request."""
    import queue as _q

    from triton_client_tpu_torch.channel.base import InferRequest

    scenarios = [
        (s[0], s[1], float(s[2]) if len(s) > 2 else 1.0) for s in scenarios
    ]
    if not scenarios:
        raise ValueError("run_open_loop needs at least one scenario")
    offsets, picks = poisson_schedule(
        rate_qps, duration_s, seed=seed, weights=[s[2] for s in scenarios]
    )
    latencies: list = []
    errors: list = []
    completed = [0]
    lock = threading.Lock()
    pending: _q.Queue = _q.Queue()

    def resolve_loop() -> None:
        while True:
            item = pending.get()
            if item is None:
                return
            t_sched, fut = item
            try:
                fut.result()
            except Exception as e:
                with lock:
                    errors.append(repr(e))
                continue
            lat_ms = (time.perf_counter() - t_sched) * 1e3
            with lock:
                latencies.append(lat_ms)
                completed[0] += 1

    chan, owned = _dial(address, deadline_s)
    try:
        requests = [
            InferRequest(model_name=m, inputs=inputs)
            for m, inputs, _w in scenarios
        ]
        if warm:
            for req in requests:
                chan.do_inference(req)
        workers = [
            threading.Thread(
                target=resolve_loop, daemon=True, name=f"openloop-res-{i}"
            )
            for i in range(max(1, int(resolvers)))
        ]
        for w in workers:
            w.start()
        t_base = time.perf_counter()
        for i, (off, pick) in enumerate(zip(offsets, picks)):
            target = t_base + float(off)
            delay = target - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            # behind schedule: issue immediately, latency still counts
            # from `target` — the CO-safe accounting
            req = requests[pick]
            if request_factory is not None:
                try:
                    req = request_factory(req, i)
                except Exception:
                    req = requests[pick]
            pending.put((target, chan.do_inference_async(req)))
        for _ in workers:
            pending.put(None)
        for w in workers:
            # a straggler is bounded by the gRPC deadline
            w.join(timeout=deadline_s + 30.0)
        alive = [w for w in workers if w.is_alive()]
        if alive:
            errors.append(f"{len(alive)} resolver threads still alive")
    finally:
        if owned:
            try:
                chan.close()
            except Exception:
                pass
    return OpenLoopResult(
        offered_qps=float(rate_qps),
        scheduled=len(offsets),
        completed=completed[0],
        wall_s=float(duration_s),
        latencies_ms=latencies,
        errors=errors,
    )


def slo_capacity_search(
    address,
    scenarios,
    slo_ms: float,
    duration_s: float = 5.0,
    seed: int = 0,
    qps_lo: float = 1.0,
    qps_hi: float = 512.0,
    iters: int = 5,
    percentile: float = 99.0,
    deadline_s: float | None = None,
) -> dict:
    """Max offered qps with ``percentile`` latency <= ``slo_ms``.

    The MLPerf-Inference server-scenario headline: exponential growth
    from ``qps_lo`` brackets the knee, then a geometric bisection
    (``iters`` probes, or until hi/lo < 1.15) narrows it. Every probe
    is one seeded open-loop window; probe seeds differ so schedules
    are independent but the WHOLE search replays from ``seed``.
    Returns the capacity plus the p50/p99/p999 measured AT capacity
    and the full probe log.

    ``address`` takes the same target shapes as ``run_open_loop``; one
    channel is dialled and shared across every probe."""
    if deadline_s is None:
        # the gRPC deadline must comfortably exceed the SLO so a miss
        # is measured, not truncated into an error
        deadline_s = max(30.0, slo_ms / 1e3 * 20.0)
    chan, owned = _dial(address, deadline_s)
    probes: list[dict] = []
    best: OpenLoopResult | None = None

    def probe(qps: float):
        res = run_open_loop(
            chan, scenarios, rate_qps=qps, duration_s=duration_s,
            seed=seed + len(probes) + 1, deadline_s=deadline_s,
            warm=len(probes) == 0,  # first probe warms the path
        )
        p = res.percentile(percentile)
        probes.append(
            {
                "offered_qps": round(qps, 3),
                "p_ms": round(p, 3) if p != float("inf") else None,
                "scheduled": res.scheduled,
                "completed": res.completed,
                "errors": len(res.errors),
            }
        )
        return p <= slo_ms, res

    try:
        ok, res = probe(qps_lo)
        if not ok:
            return {
                "slo_ms": slo_ms,
                "percentile": percentile,
                "slo_capacity_qps": 0.0,
                "goodput_qps": round(res.goodput_qps(slo_ms), 3),
                "shed_rate": round(res.shed_rate, 4),
                "p50_ms": res.percentile(50.0),
                "p99_ms": res.percentile(99.0),
                "p999_ms": res.percentile(99.9),
                "probes": probes,
            }
        lo, hi, best = qps_lo, None, res
        q = qps_lo
        while q < qps_hi:
            q = min(qps_hi, q * 2.0)
            ok, res = probe(q)
            if ok:
                lo, best = q, res
            else:
                hi = q
                break
        if hi is not None:
            for _ in range(max(0, int(iters))):
                if hi / lo < 1.15:
                    break
                mid = (lo * hi) ** 0.5
                ok, res = probe(mid)
                if ok:
                    lo, best = mid, res
                else:
                    hi = mid
        p50 = best.percentile(50.0)
        p99 = best.percentile(99.0)
        p999 = best.percentile(99.9)
        return {
            "slo_ms": slo_ms,
            "percentile": percentile,
            "slo_capacity_qps": round(lo, 3),
            "goodput_qps": round(best.goodput_qps(slo_ms), 3),
            "shed_rate": round(best.shed_rate, 4),
            "achieved_qps": round(best.achieved_qps, 3),
            "p50_ms": round(p50, 3) if p50 != float("inf") else None,
            "p99_ms": round(p99, 3) if p99 != float("inf") else None,
            "p999_ms": round(p999, 3) if p999 != float("inf") else None,
            "probes": probes,
        }
    finally:
        if owned:
            try:
                chan.close()
            except Exception:
                pass
