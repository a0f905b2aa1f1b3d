"""``serve``: a disk model repository behind the KServe v2 gRPC server (the
port's copy of ``cli/serve.py``).

    python -m triton_client_tpu_torch serve --model-repository <root>

Scans the repository (``runtime/disk_repository.scan_disk``), serves it
through ``CUDAChannel`` (optionally behind the window or continuous
batcher) and answers KServe v2 on ``--address``, so the reference's ROS
tooling and ``tritonclient`` callers connect unchanged. Needs ``grpcio``
on the serving host. Runs on ``cuda`` (``--device cpu`` runs the kernels'
plain versions); without a card it raises "no CUDA device" before
scanning, as ``detect2d``/``detect3d`` do.

``--uds`` (default ``auto``, as in the JAX CLI) also listens on a unix
socket, printed at startup; same-host clients dial ``grpc:unix:<path>``
and negotiate shared memory there.

``--metrics-port`` (a port, or ``auto`` for an ephemeral one) serves the
telemetry endpoint: ``/metrics``, ``/traces``, ``/snapshot``, ``/profile``
and ``/history`` (``obs/http.py``), with the SLO plane (``--slo-ms``), the
metric history (``--history-*``) and the continuous op sampler
(``--op-sample-*``) behind it.

``--hbm-budget`` (MB) and ``--tenants`` (a ``tenants.yaml`` path) attach
the model lifecycle (``runtime/lifecycle.py``): models start COLD, page in
on their first request (their CUDA graphs captured) and page out
LRU-within-priority under the budget (their graphs released); tenants get
quotas, in-flight caps at admission and, on the continuous batcher, fair
shares. With a lifecycle, ``--warmup`` prefetches the models in list
order while the next one fits beside those already warm, and stops at the
first that would evict another (or cannot fit at all).

``--max-sessions`` (default 64, as in the JAX CLI; 0 disables),
``--session-ttl-s`` and ``--session-id-namespace`` attach the streaming
sessions (``runtime/sessions.py``) to the channel: a request carrying a
``sequence_id`` parameter gets device-resident per-stream tracker state,
and its response carries the track tensors.

``--replica-of LABEL`` makes this server one replica of a named fleet:
the label rides ServerMetadata's extensions (``route`` prints it) and
keys the ``replica_down`` fault point. Clients drive a fleet through the
front-door router (``runtime/router.py``).

The JAX CLI's flags for layers the port does not serve yet keep their
off values here and raise at any other value, naming the ROADMAP item
(:data:`UNPORTED`). ``--metrics-port`` defaults differently from the JAX
CLI, which turns it on (0: off here).
"""

from __future__ import annotations

import argparse
import logging
import threading

log = logging.getLogger(__name__)

# one-time warning for --batch-timeout-us on the continuous scheduler
_timeout_warned = False

# dest -> (flag, default (the off value), what); what keys
# runtime/server.ROADMAP_ITEMS
UNPORTED = {
    "mesh": ("--mesh", "", "mesh"),
    "canary": ("--canary", [], "quality"),
    "quality_sample": ("--quality-sample", 0.0, "quality"),
    "quality_window": ("--quality-window", 32, "quality"),
    "quality_promote_after": ("--quality-promote-after", 3, "quality"),
    "quality_pin_fused_off": ("--quality-pin-fused-off", False, "quality"),
    "temporal_reuse": ("--temporal-reuse", "off", "temporal"),
    "temporal_k_max": ("--temporal-k-max", 8, "temporal"),
    "temporal_tile": ("--temporal-tile", 8, "temporal"),
    "temporal_forced_k": ("--temporal-forced-k", 0, "temporal"),
}


def _metrics_port(value: str):
    """``auto`` (an ephemeral port) or a port number (0: off)."""
    return "auto" if value == "auto" else int(value)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="KServe v2 inference server (PyTorch/CUDA port)")
    p.add_argument("-r", "--model-repository", required=True,
                   help="model repository root (the examples/ layout)")
    p.add_argument("-a", "--address", default="0.0.0.0:8001")
    p.add_argument("--uds", default="auto",
                   help="unix-socket listener beside TCP: 'auto' (default) picks a socket of "
                   "this process under the temporary directory, 'unix:/path.sock' or "
                   "'/path.sock' pins it, 'off' disables. Same-host clients dialing the unix: "
                   "target skip the TCP stack and negotiate shared-memory tensors")
    p.add_argument("--max-workers", type=int, default=8)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="default cuda; cpu runs the kernels' plain versions")
    p.add_argument("--batching", action="store_true",
                   help="micro-batch concurrent requests (--batcher continuous unless given)")
    p.add_argument("--batcher", default=None, choices=("none", "window", "continuous"),
                   help="batch scheduler in front of the channel: 'continuous' (EDF, packed "
                   "ragged execution, live pad buckets), 'window' (the admission-window "
                   "merge) or 'none' (default without --batching)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--batch-timeout-us", type=int, default=None,
                   help="max wait for batch-mates (window batcher only, default 2000; the "
                   "continuous scheduler has no window and ignores it)")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="formed batches executing at once behind a batcher, and the "
                   "channel's staging slots (1 is serial)")
    p.add_argument("--max-merge", type=int, default=None,
                   help="frame cap of one device batch (default --max-batch)")
    p.add_argument("--merge-hold-us", type=int, default=0,
                   help="window batcher: hold a dispatch this long on a shallow queue")
    p.add_argument("--pad-buckets", action="store_true",
                   help="window batcher: pad each device batch to the next power of two")
    p.add_argument("--metrics-port", type=_metrics_port, default=0,
                   help="telemetry endpoint: Prometheus metrics on /metrics (Triton :8002 "
                   "parity), Chrome-trace JSON on /traces, raw collector state on /snapshot, "
                   "a torch.profiler window on /profile, the metric history on /history "
                   "('auto': an ephemeral port, printed at startup; 0 disables)")
    p.add_argument("--op-sample-interval", type=float, default=0.0,
                   help="continuous op-level sampling: take a short torch.profiler window "
                   "every this many seconds and export top-K per-op device time at "
                   "tpu_serving_op_device_seconds{model,op,kind} (obs/sampler.py; capture "
                   "share of wall time is structurally capped at 1%%). 0 disables. Requires "
                   "--metrics-port")
    p.add_argument("--op-sample-window", type=float, default=0.2,
                   help="length of one sampler capture window in seconds (clamped so "
                   "window/interval never exceeds the 1%% duty-cycle budget)")
    p.add_argument("--history-interval", type=float, default=10.0,
                   help="metric-history ring spacing in seconds: per-model×tenant "
                   "launch/device-time rates, utilization and MFU snapshots served at "
                   "/history (0 disables)")
    p.add_argument("--history-capacity", type=int, default=360,
                   help="metric-history ring depth (default 360 x 10s = 1h)")
    p.add_argument("--history-path", default="",
                   help="persist the metric-history ring to this JSON file on stop and "
                   "restore from it on startup (empty disables)")
    p.add_argument("--slo-ms", type=float, default=0.0,
                   help="per-request latency SLO: requests are deadline-stamped at admission "
                   "and scored met/missed per model+priority (tpu_serving_slo_requests_total); "
                   "violating traces export at /traces?slo_violations=1. 0 disables scoring "
                   "(latency histograms still export). Requires --metrics-port.")
    p.add_argument("--slo-tail-capacity", type=int, default=64,
                   help="bounded ring of SLO-violating / p99+ exemplar traces")
    p.add_argument("--admission", type=int, default=0,
                   help="per-model admitted-but-unfinished request cap: beyond it (or when "
                   "the estimated queue wait already exceeds a request's deadline budget) new "
                   "requests are rejected with RESOURCE_EXHAUSTED before parse. Enabling "
                   "admission also arms deadline shedding in the batcher and the channel (see "
                   "--shed-expired). 0 = no admission control")
    p.add_argument("--admission-concurrency", type=int, default=4,
                   help="assumed per-model service concurrency for the estimated-wait "
                   "admission math (batcher width x pipeline depth, roughly)")
    p.add_argument("--shed-expired", action="store_true",
                   help="fail requests whose deadline already expired at batcher-merge and "
                   "pre-launch with DEADLINE_EXCEEDED instead of executing them "
                   "(deadline_expired_launches stays 0 while tpu_serving_shed_total grows); "
                   "implied by --admission > 0")
    p.add_argument("--breaker-threshold", type=int, default=5,
                   help="consecutive launch/readback failures that open a model's circuit "
                   "breaker (UNAVAILABLE until a timed probe); 0 disables")
    p.add_argument("--breaker-reset-s", type=float, default=10.0)
    p.add_argument("--drain-timeout", type=float, default=10.0,
                   help="SIGTERM: not-ready, refuse new requests, finish in-flight ones "
                   "up to this many seconds")
    p.add_argument("--fault-plan", default="",
                   help="JSON fault-injection plan (runtime/faults.py), chaos testing only")
    p.add_argument("--trace-capacity", type=int, default=256,
                   help="recent request traces kept; 0 turns request tracing off")
    p.add_argument("--warmup", action="store_true",
                   help="capture every registered model's graphs before serving; with "
                   "--hbm-budget/--tenants, prefetch models in list order while the next fits "
                   "without an eviction")
    p.add_argument("--precision", default="", choices=["", "f32", "bf16", "int8w", "int8"],
                   help="serving precision policy of EVERY repository entry, over each "
                   "config.yaml model.precision (runtime/precision.py): bf16 = parameters, "
                   "compute and float wire inputs in bfloat16; int8w = int8 weights with "
                   "per-channel scales; int8 = int8w plus the int8 wire where an entry "
                   "carries calibrated scales (none from a config.yaml: float32 wire)")
    p.add_argument("--hbm-budget", type=float, default=0.0,
                   help="device-memory paging budget in MB for the models' parameters and graph "
                   "pools (runtime/lifecycle.py): models start COLD, page in (capture their "
                   "CUDA graphs) on first request, and evict LRU-within-priority (release "
                   "their graphs) under pressure: register more models than fit at once. "
                   "0 = every model stays resident")
    p.add_argument("--tenants", default="",
                   help="tenants.yaml path mapping models to tenants with memory quotas, "
                   "fair-share weights and in-flight caps (see docs/OPERATIONS.md "
                   "'Multi-tenant serving')")
    p.add_argument("--max-sessions", type=int, default=64,
                   help="streaming-session slot pool size (runtime/sessions.py): requests "
                   "carrying a sequence_id parameter get device-resident per-stream tracker "
                   "state in one of this many slots; ended and TTL-expired slots are reclaimed, "
                   "a full unreclaimable pool sheds with RESOURCE_EXHAUSTED. 0 disables sessions "
                   "(sequence params pass through untracked)")
    p.add_argument("--session-ttl-s", type=float, default=60.0,
                   help="idle seconds before a streaming session's slot is reclaimable (streams "
                   "that vanish without sequence_end)")
    p.add_argument("--session-id-namespace", type=int, default=0,
                   help="track-id namespace (0-15) stamped into this replica's track ids: give "
                   "each replica of a fleet a distinct value so ids stay globally unique across "
                   "session re-homing")
    p.add_argument("--replica-of", default="",
                   help="replica-set label: this server is one replica of the named fleet. "
                   "Advertised via ServerMetadata extensions (the `route` tool reads it back) "
                   "and keys the replica_down fault point so a chaos plan can kill one labeled "
                   "replica")
    p.add_argument("-v", "--verbose", action="store_true")
    for dest, (flag, default, what) in UNPORTED.items():
        kw = {"dest": dest, "default": default,
              "help": f"not ported yet ({what}); raises unless {default!r}"}
        if isinstance(default, bool):
            kw["action"] = "store_true"
        elif isinstance(default, list):
            kw["action"] = "append"
            kw["default"] = []
        else:
            kw["type"] = type(default)
        p.add_argument(flag, **kw)
    return p


def check_unported(args) -> None:
    """Raise NotImplementedError naming the item of the first unported flag
    set away from its off value."""
    from triton_client_tpu_torch.runtime.server import not_ported

    for dest, (flag, default, what) in UNPORTED.items():
        value = getattr(args, dest, default)
        if value != default:
            raise not_ported(what, f"{flag} {value}")


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
    try:
        server = build_server(args)
    except NotImplementedError as e:
        raise SystemExit(f"serve: {e}") from None
    server.start()
    # flush: supervisors parse this line through a pipe
    print(f"KServe v2 gRPC server listening on port {server.port}", flush=True)
    if server.uds_address:
        print(f"unix socket: {server.uds_address}", flush=True)
    if server.metrics_enabled:
        print(f"telemetry on :{server.metrics_port} (/metrics /traces /snapshot /profile "
              "/history)", flush=True)

    import signal

    def _sigterm(signum, frame):
        print(f"SIGTERM: draining (timeout {args.drain_timeout:.1f}s)", flush=True)
        drained = server.drain(timeout_s=args.drain_timeout)
        print("drain complete" if drained else "drain timeout: stragglers cancelled", flush=True)

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        server.wait()
    except KeyboardInterrupt:
        server.stop()
    # a clean stop leaves none of the server's threads behind
    alive = sorted(t.name for t in threading.enumerate() if t is not threading.current_thread())
    print(f"serve stopped; threads alive: {alive}", flush=True)


def prefetch_fitting(lifecycle, models) -> int:
    """Prefetch ``models`` in order while each fits without an eviction;
    stop at the first that does not (its estimate is over the room left,
    its measured cost evicted another, or it cannot fit at all). Returns
    how many were prefetched."""
    from triton_client_tpu_torch.runtime.lifecycle import HBMBudgetExceededError

    done = 0
    for name, version in models:
        evictions = lifecycle.stats()["evictions"]
        if not lifecycle.fits(name, version):
            break
        try:
            lifecycle.prefetch(name, version)
        except HBMBudgetExceededError:
            break
        if lifecycle.stats()["evictions"] > evictions:
            break
        done += 1
    print(f"warmup: {done} of {len(models)} models prefetched under the budget", flush=True)
    return done


def build_server(args):
    """Repository scan, channel stack and InferenceServer (not started)
    from parsed ``main`` args, so tests and embedders can stand a server up
    on a loopback port without blocking in ``wait()``."""
    check_unported(args)
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.device import resolve_device
    from triton_client_tpu_torch.runtime.disk_repository import scan_disk
    from triton_client_tpu_torch.runtime.server import InferenceServer

    # the device first: without a card this raises before any scan
    device = resolve_device(getattr(args, "device", None))
    repo = scan_disk(args.model_repository, device=device,
                     precision=getattr(args, "precision", "") or None)
    # multi-tenant model lifecycle: budgeted paging and tenant policy
    tenants = None
    if getattr(args, "tenants", ""):
        from triton_client_tpu_torch.runtime.lifecycle import load_tenants

        tenants = load_tenants(args.tenants)
    lifecycle = None
    budget_mb = float(getattr(args, "hbm_budget", 0.0) or 0.0)
    if budget_mb > 0 or tenants is not None:
        from triton_client_tpu_torch.runtime.lifecycle import ModelLifecycleManager

        lifecycle = ModelLifecycleManager(repo, budget_bytes=int(budget_mb * (1 << 20)),
                                          tenants=tenants)
    for name, version in repo.list_models():
        model = repo.get(name, version)
        print(f"loaded {name}:{version} ({model.spec.platform}, device={device.type}) "
              f"precision={model.spec.extra.get('precision', 'f32')}")
        if getattr(args, "warmup", False) and model.warmup is not None and lifecycle is None:
            model.warmup()

    if getattr(args, "fault_plan", ""):
        from triton_client_tpu_torch.runtime.faults import FaultPlan, install_fault_plan

        with open(args.fault_plan) as fh:
            plan = FaultPlan.from_json(fh.read())
        install_fault_plan(plan)
        print(f"FAULT PLAN ACTIVE (seed {plan.seed}, {len(plan.rules)} rule(s)) — chaos "
              "testing only", flush=True)

    # admission implies deadline shedding: an overload plane that rejects at
    # the door but still executes expired work would shed the wrong requests
    shed = bool(getattr(args, "shed_expired", False)) or getattr(args, "admission", 0) > 0
    channel = CUDAChannel(
        repo, device=device, pipeline_depth=getattr(args, "pipeline_depth", 2),
        shed_expired=shed,
        breaker_threshold=getattr(args, "breaker_threshold", 5),
        breaker_reset_s=getattr(args, "breaker_reset_s", 10.0),
    )
    if lifecycle is not None:
        channel.attach_lifecycle(lifecycle)
        print(f"model lifecycle: hbm_budget={f'{budget_mb:g}MB' if budget_mb > 0 else 'unlimited'} "
              f"tenants={len(tenants.tenants()) if tenants else 0} "
              "(models page in on demand, evict LRU-within-priority)", flush=True)
        if getattr(args, "warmup", False):
            prefetch_fitting(lifecycle, repo.list_models())
    # streaming sessions: device-resident per-stream tracker state keyed by
    # the KServe sequence_id parameter, on the staged channel under any batcher
    max_sessions = int(getattr(args, "max_sessions", 64) or 0)
    if max_sessions > 0:
        from triton_client_tpu_torch.runtime.sessions import SessionManager

        ttl_s = float(getattr(args, "session_ttl_s", 60.0))
        namespace = int(getattr(args, "session_id_namespace", 0))
        channel.attach_sessions(SessionManager(max_sessions=max_sessions, ttl_s=ttl_s,
                                               id_namespace=namespace))
        print(f"streaming sessions: max_sessions={max_sessions} ttl={ttl_s:g}s "
              f"id_namespace={namespace} (device-resident tracking keyed by sequence_id)",
              flush=True)
    batcher = getattr(args, "batcher", None) or (
        "continuous" if getattr(args, "batching", False) else "none"
    )
    if batcher != "none":
        from triton_client_tpu_torch.runtime.batching import BatchingChannel
        from triton_client_tpu_torch.runtime.continuous import ContinuousBatchingChannel

        timeout_us = getattr(args, "batch_timeout_us", None)
        common = dict(max_batch=args.max_batch, pipeline_depth=args.pipeline_depth,
                      max_merge=getattr(args, "max_merge", None), shed_expired=shed)
        if batcher == "continuous":
            if timeout_us is not None:
                global _timeout_warned
                if not _timeout_warned:
                    _timeout_warned = True
                    log.warning("--batch-timeout-us has no effect with the continuous "
                                "scheduler (it has no admission window)")
            channel = ContinuousBatchingChannel(channel, **common)
            if tenants is not None:
                # deficit-round-robin fair share folded into the EDF order
                channel.attach_tenants(tenants)
            note = "windowless"
        else:
            timeout_us = 2000 if timeout_us is None else timeout_us
            channel = BatchingChannel(
                channel, timeout_us=timeout_us,
                pad_to_buckets=getattr(args, "pad_buckets", False),
                merge_hold_us=getattr(args, "merge_hold_us", 0), **common,
            )
            note = f"timeout={timeout_us}us"
        print(f"micro-batching[{batcher}]: max_batch={args.max_batch} {note} "
              f"pipeline_depth={args.pipeline_depth}", flush=True)
    uds = getattr(args, "uds", "auto") or "off"
    return InferenceServer(
        repo,
        channel,
        address=args.address,
        uds_address=None if uds == "off" else uds,
        max_workers=args.max_workers,
        metrics_port=getattr(args, "metrics_port", 0),
        trace_capacity=getattr(args, "trace_capacity", 256),
        slo_ms=getattr(args, "slo_ms", 0.0),
        slo_tail_capacity=getattr(args, "slo_tail_capacity", 64),
        admission_max_queue=getattr(args, "admission", 0),
        admission_concurrency=getattr(args, "admission_concurrency", 4),
        op_sample_interval_s=getattr(args, "op_sample_interval", 0.0),
        op_sample_window_s=getattr(args, "op_sample_window", 0.2),
        history_interval_s=getattr(args, "history_interval", 10.0),
        history_capacity=getattr(args, "history_capacity", 360),
        history_path=getattr(args, "history_path", "") or None,
        lifecycle=lifecycle,
        tenants=tenants,
        replica_of=getattr(args, "replica_of", "") or None,
    )


if __name__ == "__main__":
    main()
