"""3D detection entry point (port of the in-process path of
``cli/detect3d.py``): build PointPillars or SECOND-IoU, register it, and
send each point cloud through ``CUDAChannel`` with
``drivers.channel_infer3d``. Prints one JSON summary.

Usage:
  python -m triton_client_tpu_torch detect3d -i synthetic:16
  python -m triton_client_tpu_torch detect3d -m second_iou -i synthetic:16
  python -m triton_client_tpu_torch detect3d -i ./clouds --score 0.3
  python -m triton_client_tpu_torch detect3d -i synthetic:2 --device cpu \
      --pc-range 0,-6.4,-3,12.8,6.4,1 --voxel-size 0.2,0.2,4
  python -m triton_client_tpu_torch detect3d -m second_iou -i synthetic:2 --device cpu \
      --pc-range 0,-6.4,-3,12.8,6.4,1 --voxel-size 0.4,0.4,0.5
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np


def _floats(n: int):
    def parse(text: str) -> tuple[float, ...]:
        values = tuple(float(v) for v in text.split(","))
        if len(values) != n:
            raise argparse.ArgumentTypeError(f"want {n} comma-separated numbers, got {text!r}")
        return values

    return parse


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "-m", "--model-name", default="pointpillars", help="pointpillars | second_iou"
    )
    parser.add_argument(
        "-i", "--input", default="synthetic:16", help="synthetic[:N] or a directory of .npy clouds"
    )
    parser.add_argument("--limit", type=int, default=0, help="max scans")
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
        "--device", default=None, choices=("cuda", "cpu"),
        help="default cuda; cpu runs the kernels' plain versions",
    )
    parser.add_argument("--warmup", type=int, default=1)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.drivers.driver import channel_infer3d
    from triton_client_tpu_torch.io.sources import open_source
    from triton_client_tpu_torch.models.pointpillars import PointPillarsConfig
    from triton_client_tpu_torch.models.second import SECONDConfig
    from triton_client_tpu_torch.ops import gpu_decode3d, gpu_suppress3d, gpu_voxel
    from triton_client_tpu_torch.pipelines.detect3d import BUILDERS_3D, default_detect3d_config
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    args = parse_args(argv)
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
    repo.register(spec, pipe.infer_fn())
    channel = CUDAChannel(repo, device=pipe.device)
    channel.register_channel()
    infer = channel_infer3d(channel, spec.name)

    scans = list(open_source(args.input, args.limit, kind="pointcloud"))
    for scan in scans[: args.warmup]:
        infer(scan.data)
    counters = {
        "segment_mean": gpu_voxel.launches,
        "residual_decode_3d": gpu_decode3d.launches,
        "suppress_pack_3d": gpu_suppress3d.launches,
    }
    for counter in counters.values():
        counter.reset()
    detections = 0
    latencies = []
    t0 = time.perf_counter()
    for scan in scans:
        t = time.perf_counter()
        out = infer(scan.data)
        latencies.append(time.perf_counter() - t)
        detections += len(out["pred_scores"])
    wall = time.perf_counter() - t0
    print(
        json.dumps(
            {
                "model": spec.name,
                "device": str(pipe.device),
                "fused_stages": spec.extra["fused_stages"],
                "vfe": "scatter" if pipe.use_scatter else "grouped",
                "grid": list(model_cfg.voxel.grid_size),
                "scans": len(scans),
                "detections": detections,
                "wall_s": wall,
                "scans_per_s": len(scans) / wall if wall > 0 else None,
                "p50_ms": float(np.median(latencies)) * 1e3 if latencies else None,
                "kernel_launches": {k: c.count for k, c in counters.items()},
            }
        )
    )


if __name__ == "__main__":
    main()
