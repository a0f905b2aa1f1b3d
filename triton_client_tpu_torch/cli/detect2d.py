"""2D detection entry point (port of the in-process path of
``cli/detect2d.py``): build the pipeline, register it with its warmup,
and run ``InferenceDriver`` over ``CUDAChannel``, as the JAX CLI wires
``InferenceDriver`` over ``TPUChannel``. Prints one JSON summary: the
driver's stats under ``driver``, then the run's detections and kernel
launches (counted over the driver's run, its warmup calls included).

Usage:
  python -m triton_client_tpu_torch detect2d -i synthetic:32
  python -m triton_client_tpu_torch detect2d -i synthetic:32 --async --inflight 2
  python -m triton_client_tpu_torch detect2d -i synthetic:32 -b 8 --sink jsonl -o out
  python -m triton_client_tpu_torch detect2d -i synthetic:2:48x80 --input-size 64 --device cpu
"""

from __future__ import annotations

import argparse
import functools

from triton_client_tpu_torch.cli.common import add_common_flags


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_flags(parser)
    parser.add_argument("-m", "--model-name", default="yolov5n", help="yolov5[nsmlx]")
    parser.add_argument("-c", "--classes", type=int, default=80, help="number of classes")
    parser.add_argument("-i", "--input", default="synthetic:32", help="synthetic[:N[:HxW]]")
    parser.add_argument("--input-size", type=int, default=512, help="model input H=W")
    parser.add_argument("--conf", type=float, default=0.3)
    parser.add_argument("--iou", type=float, default=0.45)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.cli.common import (
        CountingSink,
        _check_async_flags,
        load_names,
        make_sink,
        print_report,
    )
    from triton_client_tpu_torch.drivers.driver import InferenceDriver, channel_infer
    from triton_client_tpu_torch.io.sources import open_source
    from triton_client_tpu_torch.ops import gpu_decode, gpu_nms
    from triton_client_tpu_torch.pipelines.detect2d import Detect2DConfig, build_yolov5_pipeline
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    args = parse_args(argv)
    if args.async_set:
        _check_async_flags(args)
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
        class_names=load_names(args.names),
    )
    pipe, spec, _ = build_yolov5_pipeline(
        variant=name[len("yolov5"):] or "n",
        num_classes=args.classes,
        input_hw=hw,
        config=cfg,
        device=args.device,
    )
    source = open_source(args.input, args.limit)
    repo = ModelRepository()
    # every graph the run needs, captured before traffic: the source's
    # frame size at the driver's batch size
    warmup = functools.partial(pipe.warmup, source.hw, batch_sizes=(args.batch_size,))
    repo.register(spec, pipe.infer_fn(), warmup=warmup)
    channel = CUDAChannel(repo, device=pipe.device, pipeline_depth=args.pipeline_depth)
    repo.get(spec.name).warmup()
    infer = channel_infer(channel, spec.name, asynchronous=args.async_set)

    gpu_decode.launches.reset()
    gpu_nms.launches.reset()
    sink = CountingSink(make_sink(args), lambda result: result["valid"].sum())
    driver = InferenceDriver(
        infer,
        source,
        sink=sink,
        prefetch=max(args.prefetch, args.batch_size),
        warmup=args.warmup,
        batch_size=args.batch_size,
        inflight=args.inflight if args.async_set else 1,
    )
    stats = driver.run(max_frames=args.limit)
    print_report(stats, {
        "model": spec.name,
        "device": str(pipe.device),
        "fused_stages": spec.extra["fused_stages"],
        "frames": stats.frames,
        "detections": sink.detections,
        "kernel_launches": {
            "decode_nms_2d": gpu_decode.launches.count,
            "greedy_nms": gpu_nms.launches.count,
        },
        "graphs": pipe.graph_stats(),
        "channel": {k: v for k, v in channel.stats().items() if k != "breaker"},
    })


if __name__ == "__main__":
    main()
