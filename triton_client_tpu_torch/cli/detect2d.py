"""2D detection entry point (the port's copy of ``cli/detect2d.py``).

In-process (``-u cuda``, the default): build YOLOv5 (or load it from a
repository entry with ``-r``), register it with its warmup, and run
``InferenceDriver`` over ``CUDAChannel``, as the JAX CLI wires
``InferenceDriver`` over ``TPUChannel``. Remote (``-u grpc:<host:port>``
or ``grpc:unix:<path>``): the reference's topology, the model in a
``serve`` process and this client only sending frames and sinking
detections, over the wire or shared memory (``--shm``/``--no-shm``,
auto by default); the client builds no model and does no device work.
Prints one JSON summary: the driver's stats under ``driver``, ``eval``
with ``--gt``, then the run's detections and, in-process, the kernel
launches (counted over the driver's run, its warmup calls included) or,
remote, the transport the channel used.

Usage:
  python -m triton_client_tpu_torch detect2d -i synthetic:32
  python -m triton_client_tpu_torch detect2d -i synthetic:32 -b 8 --sink jsonl -o out
  python -m triton_client_tpu_torch detect2d -r repo -m yolov5_crop --gt gt.jsonl
  python -m triton_client_tpu_torch detect2d -u grpc:127.0.0.1:8001 -m yolov5_crop --async
  python -m triton_client_tpu_torch detect2d -u grpc:unix:/tmp/s.sock -m yolov5_crop --streaming
  python -m triton_client_tpu_torch detect2d -i synthetic:2:48x80 --input-size 64 --device cpu
"""

from __future__ import annotations

import argparse
import functools

from triton_client_tpu_torch.cli.common import add_common_flags

# the ROADMAP.md Queue 1 items of the JAX CLI's options the port lacks
_ITEM_FAMILIES = "7 (models/yolov4.py, models/retinanet.py)"
_ITEM_SERVING = "8 (drivers/multicam.py, channel/sharded_channel.py)"


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_flags(parser)
    parser.add_argument("--mesh", default="", help="not ported yet (multi-card serving)")
    parser.add_argument("--cameras", type=int, default=1,
                        help="not ported yet (the lockstep multi-camera driver)")
    parser.add_argument(
        "--stream-timeout-s", type=float, default=3600.0,
        help="whole-stream deadline for --streaming (0 = unbounded)",
    )
    parser.add_argument("--input-size", type=int, default=512, help="model input H=W")
    # None: the model's defaults (yolov5: 0.3 / 0.45)
    parser.add_argument("--conf", type=float, default=None)
    parser.add_argument("--iou", type=float, default=None)
    parser.add_argument(
        "--mxu-opt", action="store_true",
        help="yolov5: the s2d stem and 32-channel floor of examples/yolov5_crop (the same "
        "detection function; upstream weights import losslessly)",
    )
    args = parser.parse_args(argv)
    # the raw argv, so the --repo guards can tell a passed flag from a default
    import sys

    args.argv = list(argv) if argv is not None else sys.argv[1:]
    return args


def build(args):
    """-> (pipeline, spec): ``yolov5[nsmlx]`` with seeded weights, or with
    ``--repo`` the repository entry's trained weights and config.yaml
    (``--conf``/``--iou`` still override)."""
    if args.repo:
        from triton_client_tpu_torch.cli.common import flags_given, load_repo_pipeline

        overrides = {}
        if args.conf is not None:
            overrides["conf_thresh"] = args.conf
        if args.iou is not None:
            overrides["iou_thresh"] = args.iou
        return load_repo_pipeline(
            args, overrides, "2d",
            conflicts={
                "--input-size": flags_given(args.argv, "--input-size"),
                "--classes": flags_given(args.argv, "-c", "--classes"),
                "--scaling": flags_given(args.argv, "-s", "--scaling"),
                "--dtype": flags_given(args.argv, "--dtype"),
                "--mxu-opt": args.mxu_opt,
            },
        )
    from triton_client_tpu_torch.cli.common import load_names, parse_dtype
    from triton_client_tpu_torch.pipelines.detect2d import Detect2DConfig, build_yolov5_pipeline

    name = args.model_name or "yolov5n"
    if not name.startswith("yolov5"):
        raise SystemExit(f"unknown 2D model '{name}': only yolov5[nsmlx] is ported (the other "
                         f"families are ROADMAP.md Queue 1 item {_ITEM_FAMILIES})")
    hw = (args.input_size, args.input_size)
    cfg = Detect2DConfig(
        model_name=name,
        input_hw=hw,
        num_classes=args.classes,
        conf_thresh=0.3 if args.conf is None else args.conf,
        iou_thresh=0.45 if args.iou is None else args.iou,
        scaling=args.scaling,
        class_names=load_names(args.names),
    )
    pipe, spec, _ = build_yolov5_pipeline(
        variant=name[len("yolov5"):] or "n",
        num_classes=args.classes,
        input_hw=hw,
        config=cfg,
        device=args.device,
        dtype=parse_dtype(args.dtype),
        s2d=args.mxu_opt,
        ch_floor=32 if args.mxu_opt else 0,
    )
    return pipe, spec


def _run_streaming(args, channel, spec) -> None:
    """Every source frame through ONE bidirectional ModelStreamInfer stream,
    responses sunk as they arrive: requests pipeline instead of waiting a
    round trip a frame."""
    import itertools
    import time

    import numpy as np

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.cli.common import CountingSink, make_sink, print_report
    from triton_client_tpu_torch.drivers.driver import latency_stats
    from triton_client_tpu_torch.io.sources import open_source

    source = open_source(args.input, args.limit)
    frames = iter(source)
    first = next(frames, None)
    if first is None:
        raise SystemExit("input source is empty")
    # warmup through the unary path, so a server-side capture never lands
    # in the streamed latencies
    for _ in range(args.warmup):
        channel.do_inference(InferRequest(args.model_name, {"images": np.asarray(first.data)[None]},
                                          model_version=args.model_version))

    in_flight, sent = {}, {}

    def req_iter():
        for i, frame in enumerate(itertools.chain([first], frames)):
            if args.limit and i >= args.limit:
                break
            rid = str(i)
            in_flight[rid] = frame
            sent[rid] = time.perf_counter()
            yield InferRequest(args.model_name, {"images": np.asarray(frame.data)[None]},
                               model_version=args.model_version, request_id=rid)

    sink = CountingSink(make_sink(args), lambda result: result["valid"].sum())
    latencies = []
    n = 0
    t0 = time.perf_counter()
    stream_timeout = args.stream_timeout_s if args.stream_timeout_s > 0 else None
    try:
        for resp in channel.infer_stream(req_iter(), stream_timeout_s=stream_timeout):
            latencies.append(time.perf_counter() - sent.pop(resp.request_id))
            frame = in_flight.pop(resp.request_id)
            out = {k: (v[0] if np.ndim(v) > 0 and np.shape(v)[0] == 1 else v)
                   for k, v in resp.outputs.items()}
            sink.write(frame, out)
            n += 1
    finally:
        sink.close()
    wall = time.perf_counter() - t0
    print_report(latency_stats(latencies, frames=n, wall_s=wall, ticks=n), None, {
        "model": spec.name, "streaming": True, "transport": channel.stats()["transport"],
        "frames": n, "detections": sink.detections,
    })


def _check_remote(args) -> None:
    """The JAX CLI's remote-mode guards: the server owns the model."""
    if not args.model_name:
        raise SystemExit("--channel grpc:... requires -m/--model-name")
    if args.repo:
        raise SystemExit("--repo is in-process mode; in remote mode the SERVER loads the "
                         "repository (serve -r ...)")
    if args.conf is not None or args.iou is not None:
        raise SystemExit("--conf/--iou are server-side in remote mode: set them in the model "
                         "repository entry's config.yaml")
    if args.mesh:
        raise SystemExit("--mesh is server-side in remote mode: pass it to 'serve --mesh ...' "
                         "instead")
    if args.streaming:
        if args.gt:
            raise SystemExit("--gt is unary-mode only; drop --streaming to evaluate")
        if args.profile or args.profile_trace:
            raise SystemExit("--profile/--profile-trace are not wired for the streaming path; "
                             "per-request latency is already in the report")


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
    from triton_client_tpu_torch.drivers.driver import channel_infer
    from triton_client_tpu_torch.io.sources import open_source

    args = parse_args(argv)
    check_unported(args)
    if args.cameras > 1:
        raise SystemExit(f"--cameras is not ported yet (ROADMAP.md Queue 1 item {_ITEM_SERVING})")
    if args.async_set:
        _check_async_flags(args)

    if remote(args):
        _check_remote(args)
        channel = grpc_channel(args)
        spec = channel.get_metadata(args.model_name, args.model_version)
        if args.streaming:
            _run_streaming(args, channel, spec)
            channel.close()
            return
        infer = channel_infer(channel, args.model_name, model_version=args.model_version,
                              asynchronous=args.async_set)
        sink = CountingSink(make_sink(args), lambda result: result["valid"].sum())
        stats, summary = run_driver(args, infer, open_source(args.input, args.limit), sink,
                                    args.batch_size, "2d")
        print_report(stats, summary, {
            "model": spec.name,
            "transport": channel.stats()["transport"],
            "frames": stats.frames,
            "detections": sink.detections,
        })
        channel.close()
        return

    if args.streaming:
        raise SystemExit("--streaming is the remote ModelStreamInfer path; use -u "
                         "grpc:<host:port> (in-process inference has no wire to stream over)")
    if args.mesh:
        raise SystemExit(f"--mesh is not ported yet (ROADMAP.md Queue 1 item {_ITEM_SERVING})")
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.ops import gpu_decode, gpu_nms
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    pipe, spec = build(args)
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
    stats, summary = run_driver(args, infer, source, sink, args.batch_size, "2d")
    print_report(stats, summary, {
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
