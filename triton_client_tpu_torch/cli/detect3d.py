"""3D detection entry point (the port's copy of ``cli/detect3d.py``).

In-process (``-u cuda``, the default): build PointPillars, SECOND-IoU or
CenterPoint (``-m``, or a dataset YAML with ``--config``, or a repository
entry with ``-r``), register it with its warmup (a graph a point bucket),
and run ``InferenceDriver`` over ``CUDAChannel`` with
``drivers.channel_infer3d``. Remote (``-u
grpc:<host:port>`` or ``grpc:unix:<path>``): the same adapter over a
``GRPCChannel`` to ``serve``, its host prep configured from the served
metadata; the client builds no model and does no device work. Prints one
JSON summary: the driver's stats under ``driver``, ``eval`` with
``--gt``, then the run's detections and, in-process, the kernel launches
(over the driver's run, its warmup calls included) or, remote, the
transport. As in the JAX CLI, a 3D dispatch takes one cloud: ``-b`` does
not batch.

``--sweeps N`` aggregates the last N scans of a replay into one cloud with
a Δt column (``ops/sweeps.sweep_source``, on the client in remote mode);
``--poses <file.jsonl>`` moves the older sweeps into the keyframe's frame.
N defaults to the config's ``nsweeps`` (10 for
``data/nusc_centerpoint.yaml``) and to 1 for ``-u grpc:``. Δt comes from the
frames' timestamps: the wall clock at read, as in the JAX CLI, or
``--scan-period S`` (frame i at i * S s) for a run that repeats bit for bit.

Usage:
  python -m triton_client_tpu_torch detect3d -i synthetic:16
  python -m triton_client_tpu_torch detect3d -m second_iou -i synthetic:16 --async
  python -m triton_client_tpu_torch detect3d -i ./clouds --score 0.3 --sink jsonl -o out
  python -m triton_client_tpu_torch detect3d -r repo -m pointpillar_kitti --gt gt3d.jsonl
  python -m triton_client_tpu_torch detect3d -u grpc:127.0.0.1:8001 -m pointpillar_kitti
  python -m triton_client_tpu_torch detect3d --config data/nusc_centerpoint.yaml -i ./sweeps \
      --sweeps 10 --poses poses.jsonl --scan-period 0.05
  python -m triton_client_tpu_torch detect3d -i synthetic:2 --device cpu \
      --pc-range 0,-6.4,-3,12.8,6.4,1 --voxel-size 0.2,0.2,4
  python -m triton_client_tpu_torch detect3d -m second_iou -i synthetic:2 --device cpu \
      --pc-range 0,-6.4,-3,12.8,6.4,1 --voxel-size 0.4,0.4,0.5
"""

from __future__ import annotations

import argparse
import dataclasses

from triton_client_tpu_torch.cli.common import add_common_flags

_ITEM_BAG = "6 (io/bag_io.py: the bag reader)"


def _floats(n: int):
    def parse(text: str) -> tuple[float, ...]:
        values = tuple(float(v) for v in text.split(","))
        if len(values) != n:
            raise argparse.ArgumentTypeError(f"want {n} comma-separated numbers, got {text!r}")
        return values

    return parse


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_flags(parser)
    parser.add_argument("--score", type=float, default=None, help="score gate, default 0.1")
    parser.add_argument("--z-offset", type=float, default=None, help="sensor z correction")
    parser.add_argument(
        "--vfe", default=None, choices=("auto", "grouped"),
        help="auto: the scatter VFE (keeps every pillar); grouped: the capped (V, K) voxelizer",
    )
    parser.add_argument(
        "--pc-range", type=_floats(6), default=None,
        help="point-cloud range x0,y0,z0,x1,y1,z1 in m (default the model's KITTI range: "
        "0,-39.68,-3,69.12,39.68,1 for pointpillars, 0,-40,-3,70.4,40,1 for second_iou)",
    )
    parser.add_argument(
        "--voxel-size", type=_floats(3), default=None,
        help="voxel size dx,dy,dz in m (default 0.16,0.16,4 for pointpillars, 0.2,0.2,0.4 "
        "for second_iou)",
    )
    parser.add_argument(
        "--config", default="",
        help="dataset/model YAML (data/kitti_pointpillars.yaml, data/nusc_centerpoint.yaml, "
        "...); overrides -m",
    )
    parser.add_argument(
        "--sweeps", type=int, default=None,
        help="aggregate the last N scans with a per-point time-lag column before inference "
        "(nuScenes 10-sweep semantics); default: the config's nsweeps (1 for -u grpc:)",
    )
    parser.add_argument(
        "--poses", default="",
        help="ego poses for --sweeps > 1: a pose JSONL ({frame_id, pose: [x, y, z, qx, qy, qz, "
        "qw]}); older sweeps move into the keyframe's sensor frame. Without it sweeps stack "
        "untransformed (exact only for a stationary platform)",
    )
    parser.add_argument(
        "--scan-period", type=float, default=None,
        help="stamp replay frame i at i * S seconds (the Δt of --sweeps); default: the wall "
        "clock at read",
    )
    args = parser.parse_args(argv)
    # the raw argv, so the --repo guards can tell a passed flag from a default
    import sys

    args.argv = list(argv) if argv is not None else sys.argv[1:]
    return args


def _check_poses_args(args, nsweeps: int | None = None) -> None:
    """The JAX CLI's ``--poses`` guards, decidable from the arguments (and
    the resolved ``nsweeps`` once known): called before the model build
    and again with the real ``nsweeps``."""
    if not args.poses:
        return
    import os

    too_few = nsweeps <= 1 if nsweeps is not None else (args.sweeps is not None
                                                          and args.sweeps <= 1)
    if too_few:
        raise SystemExit("--poses only affects multi-sweep aggregation; add --sweeps N")
    if args.poses == "odom" or args.poses.startswith("odom:"):
        raise SystemExit(f"--poses odom[:topic] reads an input bag's odometry topic, which is "
                         f"not ported yet (ROADMAP.md Queue 1 item {_ITEM_BAG}); pass a pose "
                         "JSONL")
    if not os.path.exists(args.poses):
        raise SystemExit(f"--poses: no such pose file {args.poses!r}")


def _build(args):
    """-> (pipeline, spec): seeded weights at the model's default grid (or
    ``--config``'s, then ``--pc-range``/``--voxel-size``), or with
    ``--repo`` the entry's."""
    if args.repo:
        from triton_client_tpu_torch.cli.common import flags_given, load_repo_pipeline

        overrides = {k: v for k, v in (("score_thresh", args.score), ("z_offset", args.z_offset),
                                       ("vfe", args.vfe)) if v is not None}
        return load_repo_pipeline(args, overrides, "3d", conflicts={
            "--config": bool(args.config),
            "--dtype": flags_given(args.argv, "--dtype"),
            "--pc-range": args.pc_range is not None,
            "--voxel-size": args.voxel_size is not None,
        })
    from triton_client_tpu_torch.models.centerpoint import CenterPointConfig
    from triton_client_tpu_torch.models.pointpillars import PointPillarsConfig
    from triton_client_tpu_torch.models.second import SECONDConfig
    from triton_client_tpu_torch.pipelines.detect3d import BUILDERS_3D, default_detect3d_config

    from triton_client_tpu_torch.cli.common import parse_dtype

    if args.config:
        from triton_client_tpu_torch.dataset_config import detect3d_from_yaml

        name, model_cfg, cfg = detect3d_from_yaml(args.config)
    else:
        name = args.model_name or "pointpillars"
        if name not in BUILDERS_3D:
            raise SystemExit(f"unknown 3D model '{name}' (choose from {sorted(BUILDERS_3D)})")
        cfg = default_detect3d_config(name)
        model_cfg = {"second_iou": SECONDConfig, "centerpoint": CenterPointConfig}.get(
            name, PointPillarsConfig)()
    for field, value in (("score_thresh", args.score), ("z_offset", args.z_offset),
                         ("vfe", args.vfe)):
        if value is not None:
            cfg = dataclasses.replace(cfg, **{field: value})
    voxel = model_cfg.voxel
    if args.pc_range is not None:
        voxel = dataclasses.replace(voxel, point_cloud_range=args.pc_range)
    if args.voxel_size is not None:
        voxel = dataclasses.replace(voxel, voxel_size=args.voxel_size)
    model_cfg = dataclasses.replace(model_cfg, voxel=voxel)
    pipe, spec, _ = BUILDERS_3D[name](model_cfg=model_cfg, config=cfg, device=args.device,
                                      dtype=parse_dtype(args.dtype))
    return pipe, spec


def main(argv=None) -> None:
    from triton_client_tpu_torch.cli.common import (
        CountingSink,
        _check_async_flags,
        check_unported,
        grpc_channel,
        make_sink,
        print_report,
        remote,
        run_driver,
    )
    from triton_client_tpu_torch.drivers.driver import channel_infer3d
    from triton_client_tpu_torch.io.sources import open_source

    args = parse_args(argv)
    if args.input.startswith("ros:") and (args.sweeps or 1) > 1:
        # live aggregation needs stamps and ego poses the subscribed topics
        # do not carry, as in the JAX CLI
        raise SystemExit("--sweeps > 1 is replay-only (bag/.npy sources); the live ROS path "
                         "runs single-sweep")
    check_unported(args)
    _check_poses_args(args)
    if args.streaming:
        raise SystemExit("--streaming is the 2D remote path (detect2d -u grpc:...)")
    if args.async_set:
        _check_async_flags(args)

    def source_and_sink(nsweeps: int):
        _check_poses_args(args, nsweeps)
        source = open_source(args.input, args.limit, kind="pointcloud", period=args.scan_period)
        if nsweeps > 1:
            from triton_client_tpu_torch.io.bag_io import pose_lookup_from_jsonl
            from triton_client_tpu_torch.ops.sweeps import sweep_source

            source = sweep_source(source, nsweeps,
                                  pose_lookup_from_jsonl(args.poses) if args.poses else None)
        return (source,
                CountingSink(make_sink(args), lambda result: len(result["pred_scores"])))

    if remote(args):
        if not args.model_name:
            raise SystemExit("--channel grpc:... requires -m/--model-name")
        if args.repo:
            raise SystemExit("--repo is in-process mode; in remote mode the SERVER loads the "
                             "repository (serve -r ...)")
        if (args.config or args.score is not None or args.vfe is not None
                or args.pc_range is not None or args.voxel_size is not None):
            raise SystemExit("--config/--score/--vfe/--pc-range/--voxel-size are server-side in "
                             "remote mode: set them in the model repository entry's config.yaml")
        channel = grpc_channel(args)
        infer = channel_infer3d(channel, args.model_name, model_version=args.model_version,
                                z_offset=args.z_offset,  # None -> the served value
                                asynchronous=args.async_set)
        source, sink = source_and_sink(args.sweeps or 1)
        stats, summary = run_driver(args, infer, source, sink, 1, "3d")
        print_report(stats, summary, {
            "model": args.model_name,
            "transport": channel.stats()["transport"],
            "scans": stats.frames,
            "detections": sink.detections,
        })
        channel.close()
        return

    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.ops import gpu_decode3d, gpu_suppress3d, gpu_voxel
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    pipe, spec = _build(args)
    repo = ModelRepository()
    repo.register(spec, pipe.infer_fn(), warmup=pipe.warmup)  # a graph a point bucket
    channel = CUDAChannel(repo, device=pipe.device, pipeline_depth=args.pipeline_depth)
    repo.get(spec.name).warmup()
    infer = channel_infer3d(channel, spec.name, asynchronous=args.async_set)

    counters = {
        "segment_mean": gpu_voxel.launches,
        "residual_decode_3d": gpu_decode3d.launches,
        "suppress_pack_3d": gpu_suppress3d.launches,
    }
    for counter in counters.values():
        counter.reset()
    nsweeps = args.sweeps if args.sweeps is not None else pipe.config.nsweeps
    source, sink = source_and_sink(nsweeps)
    stats, summary = run_driver(args, infer, source, sink, 1, "3d")
    print_report(stats, summary, {
        "model": spec.name,
        "sweeps": nsweeps,
        "device": str(pipe.device),
        "fused_stages": spec.extra["fused_stages"],
        "vfe": "scatter" if pipe.use_scatter else "grouped",
        "grid": list(pipe.model.cfg.voxel.grid_size),
        "scans": stats.frames,
        "detections": sink.detections,
        "kernel_launches": {k: c.count for k, c in counters.items()},
        "graphs": pipe.graph_stats(),
        "channel": {k: v for k, v in channel.stats().items() if k != "breaker"},
    })


if __name__ == "__main__":
    main()
