"""2D detection entry point (port of the in-process path of
``cli/detect2d.py``): build the pipeline, register it, and send each
frame through ``CUDAChannel``. Prints one JSON summary.

Usage:
  python -m triton_client_tpu_torch detect2d -i synthetic:32
  python -m triton_client_tpu_torch detect2d -i synthetic:2:48x80 --input-size 64 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-m", "--model-name", default="yolov5n", help="yolov5[nsmlx]")
    parser.add_argument("-c", "--classes", type=int, default=80, help="number of classes")
    parser.add_argument("-i", "--input", default="synthetic:32", help="synthetic[:N[:HxW]]")
    parser.add_argument("--limit", type=int, default=0, help="max frames")
    parser.add_argument("--input-size", type=int, default=512, help="model input H=W")
    parser.add_argument("--conf", type=float, default=0.3)
    parser.add_argument("--iou", type=float, default=0.45)
    parser.add_argument("--names", default="", help="class-names file")
    parser.add_argument(
        "--device", default=None, choices=("cuda", "cpu"),
        help="default cuda; cpu runs the kernels' plain versions",
    )
    parser.add_argument("--warmup", type=int, default=1)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.io.sources import open_source
    from triton_client_tpu_torch.ops import gpu_decode, gpu_nms
    from triton_client_tpu_torch.pipelines.detect2d import (
        Detect2DConfig,
        build_yolov5_pipeline,
        load_class_names,
    )
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    args = parse_args(argv)
    name = args.model_name
    if not name.startswith("yolov5"):
        raise SystemExit(f"unknown 2D model '{name}' (only yolov5[nsmlx] is ported)")
    hw = (args.input_size, args.input_size)
    cfg = Detect2DConfig(
        model_name=name,
        input_hw=hw,
        num_classes=args.classes,
        conf_thresh=args.conf,
        iou_thresh=args.iou,
        class_names=load_class_names(args.names) if args.names else (),
    )
    pipe, spec, _ = build_yolov5_pipeline(
        variant=name[len("yolov5"):] or "n",
        num_classes=args.classes,
        input_hw=hw,
        config=cfg,
        device=args.device,
    )
    repo = ModelRepository()
    repo.register(spec, pipe.infer_fn())
    channel = CUDAChannel(repo, device=pipe.device)
    channel.register_channel()

    def infer(frame):
        return channel.do_inference(
            InferRequest(model_name=spec.name, inputs={"images": frame.data[None]})
        )

    frames = list(open_source(args.input, args.limit))
    for frame in frames[: args.warmup]:
        infer(frame)
    gpu_decode.launches.reset()
    gpu_nms.launches.reset()
    detections = 0
    latencies = []
    t0 = time.perf_counter()
    for frame in frames:
        resp = infer(frame)
        latencies.append(resp.latency_s)
        detections += int(resp.outputs["valid"].sum())
    wall = time.perf_counter() - t0
    print(
        json.dumps(
            {
                "model": spec.name,
                "device": str(pipe.device),
                "fused_stages": spec.extra["fused_stages"],
                "frames": len(frames),
                "detections": detections,
                "wall_s": wall,
                "fps": len(frames) / wall if wall > 0 else None,
                "p50_ms": float(np.median(latencies)) * 1e3 if latencies else None,
                "kernel_launches": {
                    "decode_nms_2d": gpu_decode.launches.count,
                    "greedy_nms": gpu_nms.launches.count,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
