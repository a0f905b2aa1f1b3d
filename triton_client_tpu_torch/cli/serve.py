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

The JAX CLI's flags for layers the port does not serve yet keep their
off values here and raise at any other value, naming the ROADMAP item
(:data:`UNPORTED`). Three of them default differently from the JAX CLI,
which turns them on: ``--uds`` (``off``), ``--metrics-port`` (0) and
``--max-sessions`` (0).
"""

from __future__ import annotations

import argparse
import logging

log = logging.getLogger(__name__)

# one-time warning for --batch-timeout-us on the continuous scheduler
_timeout_warned = False

# dest -> (flag, default (the off value), what); what keys
# runtime/server.ROADMAP_ITEMS
UNPORTED = {
    "uds": ("--uds", "off", "unix socket"),
    "mesh": ("--mesh", "", "mesh"),
    "metrics_port": ("--metrics-port", 0, "telemetry"),
    "op_sample_interval": ("--op-sample-interval", 0.0, "telemetry"),
    "op_sample_window": ("--op-sample-window", 0.2, "telemetry"),
    "history_interval": ("--history-interval", 0.0, "telemetry"),
    "history_capacity": ("--history-capacity", 360, "telemetry"),
    "history_path": ("--history-path", "", "telemetry"),
    "canary": ("--canary", [], "quality"),
    "quality_sample": ("--quality-sample", 0.0, "quality"),
    "quality_window": ("--quality-window", 32, "quality"),
    "quality_promote_after": ("--quality-promote-after", 3, "quality"),
    "quality_pin_fused_off": ("--quality-pin-fused-off", False, "quality"),
    "slo_ms": ("--slo-ms", 0.0, "slo"),
    # deadlines come only from the SLO plane: without it these shed nothing
    "admission_concurrency": ("--admission-concurrency", 4, "slo"),
    "shed_expired": ("--shed-expired", False, "slo"),
    "slo_tail_capacity": ("--slo-tail-capacity", 64, "slo"),
    "hbm_budget": ("--hbm-budget", 0.0, "lifecycle"),
    "tenants": ("--tenants", "", "tenants"),
    "max_sessions": ("--max-sessions", 0, "sessions"),
    "session_ttl_s": ("--session-ttl-s", 60.0, "sessions"),
    "session_id_namespace": ("--session-id-namespace", 0, "sessions"),
    "temporal_reuse": ("--temporal-reuse", "off", "temporal"),
    "temporal_k_max": ("--temporal-k-max", 8, "temporal"),
    "temporal_tile": ("--temporal-tile", 8, "temporal"),
    "temporal_forced_k": ("--temporal-forced-k", 0, "temporal"),
    "replica_of": ("--replica-of", "", "router"),
}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="KServe v2 inference server (PyTorch/CUDA port)")
    p.add_argument("-r", "--model-repository", required=True,
                   help="model repository root (the examples/ layout)")
    p.add_argument("-a", "--address", default="0.0.0.0:8001")
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
    p.add_argument("--admission", type=int, default=0,
                   help="per-model admitted-but-unfinished request cap (RESOURCE_EXHAUSTED "
                   "beyond it, before parse). 0: off")
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
                   help="capture every registered model's graphs before serving")
    p.add_argument("--precision", default="", choices=["", "f32", "bf16", "int8w", "int8"],
                   help="serving precision policy of EVERY repository entry, over each "
                   "config.yaml model.precision (runtime/precision.py): bf16 = parameters, "
                   "compute and float wire inputs in bfloat16; int8w and int8 are not ported")
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
    set away from its off value, or of an unported precision policy."""
    from triton_client_tpu_torch.runtime.precision import PrecisionPolicy
    from triton_client_tpu_torch.runtime.server import not_ported

    PrecisionPolicy.parse(getattr(args, "precision", "") or None)
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
    for name, version in repo.list_models():
        model = repo.get(name, version)
        print(f"loaded {name}:{version} ({model.spec.platform}, device={device.type}) "
              f"precision={model.spec.extra.get('precision', 'f32')}")
        if getattr(args, "warmup", False) and model.warmup is not None:
            model.warmup()

    if getattr(args, "fault_plan", ""):
        from triton_client_tpu_torch.runtime.faults import FaultPlan, install_fault_plan

        with open(args.fault_plan) as fh:
            plan = FaultPlan.from_json(fh.read())
        install_fault_plan(plan)
        print(f"FAULT PLAN ACTIVE (seed {plan.seed}, {len(plan.rules)} rule(s)) — chaos "
              "testing only", flush=True)

    channel = CUDAChannel(
        repo, device=device, pipeline_depth=getattr(args, "pipeline_depth", 2),
        breaker_threshold=getattr(args, "breaker_threshold", 5),
        breaker_reset_s=getattr(args, "breaker_reset_s", 10.0),
    )
    batcher = getattr(args, "batcher", None) or (
        "continuous" if getattr(args, "batching", False) else "none"
    )
    if batcher != "none":
        from triton_client_tpu_torch.runtime.batching import BatchingChannel
        from triton_client_tpu_torch.runtime.continuous import ContinuousBatchingChannel

        timeout_us = getattr(args, "batch_timeout_us", None)
        common = dict(max_batch=args.max_batch, pipeline_depth=args.pipeline_depth,
                      max_merge=getattr(args, "max_merge", None))
        if batcher == "continuous":
            if timeout_us is not None:
                global _timeout_warned
                if not _timeout_warned:
                    _timeout_warned = True
                    log.warning("--batch-timeout-us has no effect with the continuous "
                                "scheduler (it has no admission window)")
            channel = ContinuousBatchingChannel(channel, **common)
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
    return InferenceServer(
        repo,
        channel,
        address=args.address,
        max_workers=args.max_workers,
        trace_capacity=getattr(args, "trace_capacity", 256),
        admission_max_queue=getattr(args, "admission", 0),
    )


if __name__ == "__main__":
    main()
