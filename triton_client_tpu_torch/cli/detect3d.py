"""3D detection entry point (port of the in-process path of
``cli/detect3d.py``): build PointPillars or SECOND-IoU, register it with
its warmup (a graph a point bucket), and run ``InferenceDriver`` over
``CUDAChannel`` with ``drivers.channel_infer3d``. Prints one JSON
summary: the driver's stats under ``driver``, then the run's detections
and kernel launches (over the driver's run, its warmup calls included).
As in the JAX CLI, a 3D dispatch takes one cloud: ``-b`` does not batch.

Usage:
  python -m triton_client_tpu_torch detect3d -i synthetic:16
  python -m triton_client_tpu_torch detect3d -m second_iou -i synthetic:16 --async
  python -m triton_client_tpu_torch detect3d -i ./clouds --score 0.3 --sink jsonl -o out
  python -m triton_client_tpu_torch detect3d -i synthetic:2 --device cpu \
      --pc-range 0,-6.4,-3,12.8,6.4,1 --voxel-size 0.2,0.2,4
  python -m triton_client_tpu_torch detect3d -m second_iou -i synthetic:2 --device cpu \
      --pc-range 0,-6.4,-3,12.8,6.4,1 --voxel-size 0.4,0.4,0.5
"""

from __future__ import annotations

import argparse
import dataclasses

from triton_client_tpu_torch.cli.common import add_common_flags


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
    parser.add_argument(
        "-m", "--model-name", default="pointpillars", help="pointpillars | second_iou"
    )
    parser.add_argument(
        "-i", "--input", default="synthetic:16", help="synthetic[:N] or a directory of .npy clouds"
    )
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
    return parser.parse_args(argv)


def main(argv=None) -> None:
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.cli.common import (
        CountingSink,
        _check_async_flags,
        make_sink,
        print_report,
    )
    from triton_client_tpu_torch.drivers.driver import InferenceDriver, channel_infer3d
    from triton_client_tpu_torch.io.sources import open_source
    from triton_client_tpu_torch.models.pointpillars import PointPillarsConfig
    from triton_client_tpu_torch.models.second import SECONDConfig
    from triton_client_tpu_torch.ops import gpu_decode3d, gpu_suppress3d, gpu_voxel
    from triton_client_tpu_torch.pipelines.detect3d import BUILDERS_3D, default_detect3d_config
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    args = parse_args(argv)
    if args.async_set:
        _check_async_flags(args)
    name = args.model_name
    if name not in BUILDERS_3D:
        raise SystemExit(f"unknown 3D model '{name}' (choose from {sorted(BUILDERS_3D)})")
    cfg = default_detect3d_config(name)
    for field, value in (("score_thresh", args.score), ("z_offset", args.z_offset),
                         ("vfe", args.vfe)):
        if value is not None:
            cfg = dataclasses.replace(cfg, **{field: value})
    model_cfg = SECONDConfig() if name == "second_iou" else PointPillarsConfig()
    voxel = model_cfg.voxel
    if args.pc_range is not None:
        voxel = dataclasses.replace(voxel, point_cloud_range=args.pc_range)
    if args.voxel_size is not None:
        voxel = dataclasses.replace(voxel, voxel_size=args.voxel_size)
    model_cfg = dataclasses.replace(model_cfg, voxel=voxel)
    pipe, spec, _ = BUILDERS_3D[name](model_cfg=model_cfg, config=cfg, device=args.device)
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
    sink = CountingSink(make_sink(args), lambda result: len(result["pred_scores"]))
    driver = InferenceDriver(
        infer,
        open_source(args.input, args.limit, kind="pointcloud"),
        sink=sink,
        prefetch=args.prefetch,
        warmup=args.warmup,
        inflight=args.inflight if args.async_set else 1,
    )
    stats = driver.run(max_frames=args.limit)
    print_report(stats, {
        "model": spec.name,
        "device": str(pipe.device),
        "fused_stages": spec.extra["fused_stages"],
        "vfe": "scatter" if pipe.use_scatter else "grouped",
        "grid": list(model_cfg.voxel.grid_size),
        "scans": stats.frames,
        "detections": sink.detections,
        "kernel_launches": {k: c.count for k, c in counters.items()},
        "graphs": pipe.graph_stats(),
        "channel": {k: v for k, v in channel.stats().items() if k != "breaker"},
    })


if __name__ == "__main__":
    main()
