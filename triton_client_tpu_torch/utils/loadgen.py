"""Closed-loop, open-loop and streaming-replay gRPC load generators for
serving benchmarks (port of ``utils/loadgen.py``).

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

Streaming replay (``run_streams``): N timestamped sequences, one thread
and one ``sequence_id`` each, replayed at their recorded pace against the
server's streaming sessions (``runtime/sessions.py``), latency charged
from each frame's scheduled time, and the track ids each response carries
scored against the replayer's ground truth (ID switches, fragmentation,
id aliases). ``synthetic_stream`` generates such a sequence from a seed.

Every generator also takes a list of addresses: a replica fleet, driven
through the front-door router (``runtime/router.py``), so capacity
numbers become fleet numbers and streams are routed by affinity.
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
      * ``["host:port", ...]`` — a replica set: a fresh
        ``FrontDoorRouter`` over the endpoints (owned);
      * a channel-shaped object (anything with ``do_inference_async``)
        — used as-is and NOT closed, so a caller-configured router
        (custom hedge/budget knobs, a warm latency histogram) can be
        driven across several windows."""
    if isinstance(target, str):
        from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel

        return GRPCChannel(target, timeout_s=deadline_s), True
    if isinstance(target, (list, tuple)):
        from triton_client_tpu_torch.runtime.router import FrontDoorRouter

        return FrontDoorRouter(list(target), timeout_s=deadline_s), True
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

    ``address`` is a ``_dial`` target: one endpoint string, a list of
    endpoints (a fleet behind a ``FrontDoorRouter``), or an already-built
    channel or router (driven, not closed).

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
    channel is dialled and shared across every probe: a list of
    endpoints dials ONE router, so its rolling hedge quantile and health
    state carry over and the fleet capacity measures the steady-state
    front door, not a cold one per probe."""
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


# -- streaming replay -----------------------------------------------------------


@dataclass
class StreamStats:
    """One replayed stream's ledger.

    Latencies are measured from each frame's SCHEDULED send time (the
    recorded timestamp replayed against the stream's epoch), so a frame
    issued late because the previous one stalled still charges the server,
    the coordinated-omission discipline of ``run_open_loop``.
    ``inter_frame_ms`` is completion to completion: the cadence the
    stream's consumer sees. ``frames_detected`` / ``frames_coasted`` /
    ``frames_partial`` split the OK frames by the response's
    ``reuse_mode`` output (0 full detector, 1 tracker coast, 2 ROI-tile
    partial); ``coast_track_drops`` counts bound ground-truth tracks whose
    id vanished from a coast frame's live track set."""

    stream_id: str
    frames_sent: int = 0
    frames_ok: int = 0
    frames_detected: int = 0
    frames_coasted: int = 0
    frames_partial: int = 0
    coast_track_drops: int = 0
    wall_s: float = 0.0
    latencies_ms: list = field(default_factory=list)
    inter_frame_ms: list = field(default_factory=list)
    id_switches: int = 0
    fragmentation: int = 0
    # track id -> the ground-truth object it was first bound to; ``aliases``
    # counts REBINDS (a track id later seen on another object)
    track_map: dict = field(default_factory=dict)
    aliases: int = 0
    errors: list = field(default_factory=list)

    @property
    def sustained_fps(self) -> float:
        return self.frames_ok / self.wall_s if self.wall_s > 0 else 0.0

    def inter_frame_p99(self) -> float:
        if not self.inter_frame_ms:
            return 0.0
        return co_percentile(self.inter_frame_ms, len(self.inter_frame_ms), 99.0)


@dataclass
class StreamsResult:
    streams: list = field(default_factory=list)
    wall_s: float = 0.0

    @property
    def frames_sent(self) -> int:
        return sum(s.frames_sent for s in self.streams)

    @property
    def frames_ok(self) -> int:
        return sum(s.frames_ok for s in self.streams)

    @property
    def goodput(self) -> float:
        """Fraction of replayed frames that came back OK."""
        sent = self.frames_sent
        return self.frames_ok / sent if sent else 0.0

    @property
    def id_switches(self) -> int:
        return sum(s.id_switches for s in self.streams)

    @property
    def fragmentation(self) -> int:
        return sum(s.fragmentation for s in self.streams)

    @property
    def aliases(self) -> int:
        return sum(s.aliases for s in self.streams)

    @property
    def frames_coasted(self) -> int:
        return sum(s.frames_coasted for s in self.streams)

    @property
    def frames_partial(self) -> int:
        return sum(s.frames_partial for s in self.streams)

    @property
    def coast_track_drops(self) -> int:
        return sum(s.coast_track_drops for s in self.streams)

    def summary(self) -> dict:
        per99 = [s.inter_frame_p99() for s in self.streams]
        fps = [s.sustained_fps for s in self.streams]
        return {
            "streams": len(self.streams),
            "frames_sent": self.frames_sent,
            "frames_ok": self.frames_ok,
            "goodput": round(self.goodput, 4),
            "frames_detected": sum(s.frames_detected for s in self.streams),
            "frames_coasted": self.frames_coasted,
            "frames_partial": self.frames_partial,
            "coast_track_drops": self.coast_track_drops,
            "id_switches": self.id_switches,
            "fragmentation": self.fragmentation,
            "track_id_aliases": self.aliases,
            "min_sustained_fps": round(min(fps), 3) if fps else 0.0,
            "worst_inter_frame_p99_ms": round(max(per99), 3) if per99 else 0.0,
            "wall_s": round(self.wall_s, 3),
        }


def synthetic_stream(
    n_frames: int,
    fps: float = 10.0,
    n_objects: int = 4,
    det_dim: int = 11,
    seed: int = 0,
    speed: float = 1.0,
    clutter: int = 2,
    dynamics: str | None = None,
    phase_frames: int = 12,
):
    """A synthetic timestamped detection stream for replay: ``n_objects``
    constant-velocity movers plus ``clutter`` low-score distractors a frame.
    Yields ``(offset_s, inputs, gt_ids)`` frames in the shape ``run_streams``
    replays: ``inputs`` carries ``detections`` (N, det_dim) float32 rows
    ``[x y z dx dy dz heading vx vy ... score label]`` and a ``valid`` bool
    mask; ``gt_ids`` aligns ground-truth object ids with rows (clutter rows
    are -1, never scored).

    ``dynamics`` shapes the scene motion: None (constant-velocity movers),
    ``"static"`` (objects hold position), ``"pan"`` (one coherent drift for
    every object), ``"burst"`` (static with high-speed velocities re-drawn
    every ``phase_frames`` frames) or ``"mixed"`` (static -> pan -> burst
    phases of ``phase_frames`` each). The same arguments give the JAX
    package's stream bit for bit."""
    import numpy as np

    if det_dim < 11:
        raise ValueError("synthetic_stream needs det_dim >= 11")
    if dynamics not in (None, "static", "pan", "burst", "mixed"):
        raise ValueError(f"dynamics must be None/static/pan/burst/mixed, not {dynamics!r}")
    phase_frames = max(1, int(phase_frames))
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-20.0, 20.0, size=(n_objects, 2))
    base_vel = rng.uniform(-1.0, 1.0, size=(n_objects, 2)) * speed
    pan_vel = rng.uniform(-1.0, 1.0, size=(1, 2)) * speed * 2.0
    dt = 1.0 / fps
    n_rows = n_objects + clutter
    vel = base_vel
    for k in range(n_frames):
        if dynamics is not None:
            phase = dynamics
            if dynamics == "mixed":
                phase = ("static", "pan", "burst")[(k // phase_frames) % 3]
            if phase == "static":
                vel = np.zeros_like(base_vel)
            elif phase == "pan":
                vel = np.broadcast_to(pan_vel, base_vel.shape)
            elif phase == "burst" and k % phase_frames == 0:
                # a burst edge: new high-speed velocities, held through the phase
                vel = rng.uniform(-1.0, 1.0, base_vel.shape) * speed * 4.0
        det = np.zeros((n_rows, det_dim), dtype=np.float32)
        det[:n_objects, 0:2] = pos + rng.normal(0.0, 0.05, pos.shape)
        det[:n_objects, 3:6] = (4.0, 2.0, 1.5)
        det[:n_objects, 7:9] = vel
        det[:n_objects, -2] = 0.9
        if clutter:
            det[n_objects:, 0:2] = rng.uniform(-30.0, 30.0, (clutter, 2))
            det[n_objects:, -2] = 0.05
        gt = np.concatenate([np.arange(n_objects, dtype=np.int64),
                             np.full((clutter,), -1, dtype=np.int64)])
        inputs = {"detections": det, "valid": np.ones((n_rows,), dtype=np.bool_)}
        yield (k * dt, inputs, gt)
        pos = pos + vel * dt


def _score_tracking(stats, det_tids, gt_ids, gt_to_tid, tids_per_gt):
    """Fold one frame's track assignment into the stream's ID-switch counter
    and per-object track-id sets. ``det_tids``: the server's per-detection
    track ids; ``gt_ids``: the replayer's aligned ground truth (-1 rows are
    clutter, never scored)."""
    import numpy as np

    tids = np.asarray(det_tids).reshape(-1)
    gts = np.asarray(gt_ids).reshape(-1)
    if tids.shape[0] != gts.shape[0]:
        return
    for g, tid in zip(gts.tolist(), tids.tolist()):
        if g < 0 or tid < 0:
            continue
        prev = gt_to_tid.get(g)
        if prev is not None and prev != tid:
            stats.id_switches += 1
        gt_to_tid[g] = tid
        tids_per_gt.setdefault(g, set()).add(tid)
        bound = stats.track_map.setdefault(tid, g)
        if bound != g:
            stats.aliases += 1


def _score_coast(stats, outputs, gt_to_tid) -> None:
    """Score one coasted frame: with no per-detection assignment, the
    checkable claim is track persistence: every ground-truth object's bound
    track id must still be live in the frame's ``track_ids`` /
    ``tracks_valid``. Each vanished binding counts one
    ``coast_track_drops``."""
    import numpy as np

    tids = outputs.get("track_ids")
    if tids is None or not gt_to_tid:
        return
    live = np.asarray(tids).reshape(-1)
    valid = outputs.get("tracks_valid")
    if valid is not None:
        mask = np.asarray(valid, bool).reshape(-1)
        if mask.shape == live.shape:
            live = live[mask]
    live_set = {int(t) for t in live.tolist() if t > 0}
    stats.coast_track_drops += sum(1 for tid in gt_to_tid.values() if tid not in live_set)


def run_streams(
    target,
    model_name: str,
    n_streams: int,
    source,
    deadline_s: float = 60.0,
    stream_id_prefix: str = "stream",
    track_output: str = "det_track_ids",
    realtime: bool = True,
) -> StreamsResult:
    """Replay ``n_streams`` timestamped sequences at their recorded pace: the
    streaming-session counterpart of ``run_pool``'s stateless closed loop.

    ``target`` is a ``_dial`` shape (an endpoint, a list of endpoints,
    routed with session affinity through a ``FrontDoorRouter``, or a
    built channel or router).
    ``source(stream_idx)`` returns an iterable of ``(offset_s, inputs)`` or
    ``(offset_s, inputs, gt_ids)`` frames (:func:`synthetic_stream`). Every
    stream gets its own thread and ``sequence_id``; the first frame carries
    ``sequence_start``, the last ``sequence_end``, so the server's session
    slots open and close with the replay.

    Pacing: frame ``i`` is sent no earlier than ``epoch + offset_i`` and
    never before frame ``i-1`` resolved (a session's frames are ordered).
    With ``realtime=False`` the offsets are ignored and each stream replays
    back to back. Latency is charged from the SCHEDULED time.

    ID switches and fragmentation need ground truth: frames that carry
    ``gt_ids`` are scored against the ``track_output`` tensor of each
    response (an ID switch: a ground-truth object's track id changed
    between consecutive sightings; fragmentation: distinct track ids per
    object beyond the first)."""
    from triton_client_tpu_torch.channel.base import InferRequest

    if n_streams < 1:
        raise ValueError("run_streams needs n_streams >= 1")
    chan, owned = _dial(target, deadline_s)
    results = [StreamStats(f"{stream_id_prefix}-{i}") for i in range(n_streams)]
    ready = threading.Barrier(n_streams + 1)

    def stream_loop(idx: int) -> None:
        import numpy as np

        stats = results[idx]
        frames = []
        for f in source(idx):
            gt = f[2] if len(f) > 2 else None
            frames.append((float(f[0]), f[1], gt))
        gt_to_tid: dict = {}
        tids_per_gt: dict = {}
        try:
            ready.wait(timeout=deadline_s)
        except threading.BrokenBarrierError:
            return
        t0 = time.perf_counter()
        last_done = None
        for k, (off, inputs, gt) in enumerate(frames):
            sched = t0 + off if realtime else time.perf_counter()
            delay = sched - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            req = InferRequest(
                model_name=model_name,
                inputs=inputs,
                sequence_id=stats.stream_id,
                sequence_start=(k == 0),
                sequence_end=(k == len(frames) - 1),
            )
            stats.frames_sent += 1
            try:
                resp = chan.do_inference(req)
            except Exception as e:  # the stream outlives one lost frame
                stats.errors.append(e)
                continue
            now = time.perf_counter()
            stats.frames_ok += 1
            stats.latencies_ms.append((now - sched) * 1e3)
            if last_done is not None:
                stats.inter_frame_ms.append((now - last_done) * 1e3)
            last_done = now
            mode = resp.outputs.get("reuse_mode")
            mode = 0 if mode is None else int(np.asarray(mode).reshape(-1)[0])
            if mode == 1:
                stats.frames_coasted += 1
            elif mode == 2:
                stats.frames_partial += 1
            else:
                stats.frames_detected += 1
            if gt is None:
                continue
            if mode == 1:
                # coasted: no per-detection assignment came back; score
                # track persistence instead of ID switches
                _score_coast(stats, resp.outputs, gt_to_tid)
            else:
                tids = resp.outputs.get(track_output)
                if tids is not None:
                    _score_tracking(stats, tids, gt, gt_to_tid, tids_per_gt)
        stats.wall_s = time.perf_counter() - t0
        stats.fragmentation = sum(len(s) - 1 for s in tids_per_gt.values())

    threads = [threading.Thread(target=stream_loop, args=(i,), name=f"stream-{i}", daemon=True)
               for i in range(n_streams)]
    t_start = time.perf_counter()
    try:
        for t in threads:
            t.start()
        ready.wait(timeout=deadline_s)
        for t in threads:
            t.join()
    finally:
        if owned:
            try:
                chan.close()
            except Exception:
                pass
    return StreamsResult(streams=results, wall_s=time.perf_counter() - t_start)
