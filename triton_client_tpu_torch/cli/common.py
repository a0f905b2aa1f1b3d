"""Shared CLI flags and wiring helpers (the port's copy of
``cli/common.py``).

Flag parity with the JAX CLIs: ``-m`` model, ``-x`` version, ``-u``
channel, ``--shm``/``--no-shm``, ``-r`` repository, ``-b`` batch size,
``-c`` class count, ``-s`` scaling, ``-i`` input, ``--gt``, ``--async``
/``--inflight``, ``--streaming``, ``--profile``/``--profile-trace``,
``--dtype``, ``--prefetch``, ``--warmup``, ``--limit``, ``--sink`` with
``-o``, ``--names``. The port adds ``--pipeline-depth`` (the channel's
staging slots) and ``--device``.

``-u`` takes ``cuda`` (in-process, the default: the JAX CLIs' ``tpu``) or
``grpc:<host:port>`` / ``grpc:unix:<path>``, a remote ``serve``. ``-i``
takes ``synthetic[:N[:HxW]]``, an image directory, a video file, a
``.bag``, a directory of ``.npy`` clouds (3D) or ``ros:<topic>`` (a live
topic, where rospy is installed).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Callable

import numpy as np

def add_common_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-m", "--model-name", default="", help="served model name")
    parser.add_argument("-x", "--model-version", default="", help="model version")
    parser.add_argument(
        "-u", "--channel", default="cuda", dest="channel",
        help="inference channel: 'cuda' (in-process, default), 'grpc:<host:port>' (a "
        "remote KServe v2 server such as 'serve') or 'grpc:unix:/path.sock' (the "
        "server's same-host unix socket, printed by serve)",
    )
    parser.add_argument(
        "--shm", action="store_const", const=True, default=None, dest="use_shared_memory",
        help="force the POSIX shared-memory tensor transport. Default is auto: same-host "
        "grpc:/unix: channels negotiate shm on their own, remote ones stay on the wire; "
        "--no-shm pins the wire everywhere",
    )
    parser.add_argument(
        "--no-shm", action="store_const", const=False, dest="use_shared_memory",
        help="force the gRPC wire transport even on a same-host channel",
    )
    parser.add_argument(
        "--profile", action="store_true",
        help="print a per-stage latency table (source/infer/sink) after the run",
    )
    parser.add_argument(
        "--profile-trace", default="",
        help="capture a torch.profiler trace of the run into this directory (Chrome trace "
        "JSON, for Perfetto)",
    )
    parser.add_argument(
        "-r", "--repo", default="",
        help="model repository root: load -m's trained weights from <repo>/<model>/ "
        "(config.yaml + version dirs, the layout serve -r reads) instead of random "
        "init; -x picks the version (default: latest)",
    )
    parser.add_argument("-b", "--batch-size", type=int, default=1)
    parser.add_argument("-c", "--classes", type=int, default=80, help="number of classes")
    parser.add_argument(
        "-s", "--scaling", default="yolo", choices=("yolo", "none", "inception", "vgg", "coco"),
        help="input scaling mode",
    )
    parser.add_argument(
        "-i", "--input", default="synthetic:32",
        help="source: image dir | video file | rosbag (*.bag) | synthetic[:N[:HxW]] | "
        "npy dir (3D) | ros:<topic> (live, needs rospy)",
    )
    parser.add_argument("--limit", type=int, default=0, help="max frames")
    parser.add_argument(
        "--sink", default="null", choices=("null", "images", "jsonl", "bag"),
        help="where detections go: nowhere, annotated PNGs in <output> (2D), "
        "<output>/detections.jsonl, or an output bag in <output> (3D: the input clouds and "
        "a jsk box array a frame)",
    )
    parser.add_argument("-o", "--output", default="./output_data")
    parser.add_argument("--names", default="", help="class-names file")
    parser.add_argument("--gt", default="", help="ground-truth JSONL for eval")
    parser.add_argument(
        "--prometheus-port", type=int, default=0,
        help="with --gt: serve the evaluator's five Summaries on this port after the run "
        "(until interrupted)",
    )
    parser.add_argument(
        "--async", dest="async_set", action="store_true",
        help="pipeline inference with async futures: keep --inflight requests "
        "outstanding so host prep overlaps device or remote compute",
    )
    parser.add_argument(
        "--inflight", type=int, default=2, help="max outstanding requests with --async (>=2)"
    )
    parser.add_argument(
        "--streaming", action="store_true",
        help="remote only: one bidirectional ModelStreamInfer stream for the whole source",
    )
    parser.add_argument("--prefetch", type=int, default=4)
    parser.add_argument("--warmup", type=int, default=1)
    parser.add_argument(
        "--dtype", default="fp32", choices=("fp32", "bf16"),
        help="model compute dtype (bf16: the body in bfloat16; heads, decode and NMS "
        "stay float32)",
    )
    parser.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="the channel's staging slots: launched requests allowed before "
        "staging the next one waits (1 is serial)",
    )
    parser.add_argument(
        "--device", default=None, choices=("cuda", "cpu"),
        help="in-process only: default cuda; cpu runs the kernels' plain versions",
    )


def check_channel(args) -> None:
    """Refuse ``-u`` values other than ``cuda`` and ``grpc:``."""
    if args.channel == "tpu":
        raise SystemExit("-u tpu is the JAX package's in-process channel; this port of it "
                         "runs on CUDA: use -u cuda (the default) or -u grpc:<host:port>")
    if args.channel != "cuda" and not args.channel.startswith("grpc:"):
        raise SystemExit(f"-u {args.channel}: use 'cuda' or 'grpc:<host:port>' / "
                         "'grpc:unix:<path>'")


def remote(args) -> bool:
    return args.channel.startswith("grpc:")


def grpc_channel(args):
    """``-u grpc:...`` -> the port's ``GRPCChannel`` (shared memory per
    ``--shm``/``--no-shm``, auto otherwise)."""
    from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel

    return GRPCChannel(args.channel[len("grpc:"):], use_shared_memory=args.use_shared_memory)


def parse_dtype(name: str):
    """--dtype string -> torch dtype (SystemExit on bad input)."""
    from triton_client_tpu_torch.runtime.precision import parse_compute_dtype

    try:
        return parse_compute_dtype(name)
    except ValueError as e:
        raise SystemExit(str(e))


def _check_async_flags(args) -> None:
    """--async combination guards shared by the 2D/3D entry points."""
    if getattr(args, "streaming", False):
        raise SystemExit("--async and --streaming both pipeline requests; pick one")
    if args.batch_size > 1:
        raise SystemExit(
            "--async pipelines single-frame dispatches; it does not "
            "combine with -b/--batch-size"
        )
    if args.input.startswith("ros:"):
        raise SystemExit("--async is replay-mode only; the live ROS driver already "
                         "overlaps decode and compute through its bounded queue")
    if args.inflight < 2:
        raise SystemExit("--inflight must be >= 2 with --async")


def make_sink(args, class_names: tuple[str, ...] = ()):
    from triton_client_tpu_torch.io.sinks import DetectionLogSink, ImageFileSink, NullSink

    if args.sink == "images":
        return ImageFileSink(args.output, class_names)
    if args.sink == "jsonl":
        return DetectionLogSink(os.path.join(args.output, "detections.jsonl"))
    if args.sink == "bag":
        from triton_client_tpu_torch.io.bag_io import OutputBagSink, default_output_bag

        name = default_output_bag(args.input) if args.input.endswith(".bag") else "output.bag"
        os.makedirs(args.output, exist_ok=True)
        return OutputBagSink(os.path.join(args.output, name))
    return NullSink()


class CountingSink:
    """Passes results on to ``sink`` and counts the detections in them
    (``count(result) -> int``) for the run's summary."""

    def __init__(self, sink, count) -> None:
        self._sink, self._count = sink, count
        self.detections = 0

    def write(self, frame, result) -> None:
        self.detections += int(self._count(result))
        self._sink.write(frame, result)

    def close(self) -> None:
        self._sink.close()


def load_gt_lookup(path: str) -> Callable:
    """GT JSONL: one {"frame_id": int, "boxes": [[x1,y1,x2,y2,cls],...]}
    per line (the replay-mode stand-in for a live GT topic)."""
    table: dict[int, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            table[int(row["frame_id"])] = np.asarray(row["boxes"], np.float64).reshape(-1, 5)

    def lookup(frame):
        return table.get(frame.frame_id)

    return lookup


def flags_given(argv, *names) -> bool:
    """True when any of ``names`` was passed on the command line (exact
    flag or --flag=value form): how the --repo guards tell 'the user asked
    for this' from a parser default."""
    if argv is None:
        import sys

        argv = sys.argv[1:]
    return any(a == n or a.startswith(n + "=") for a in argv for n in names)


def load_repo_pipeline(args, overrides: dict, kind: str, conflicts: dict):
    """--repo -> (pipeline, spec) with trained weights, with the guards both
    detect CLIs share: -m required, an entry of the other kind refused, and
    explicitly set model-shape flags (which the entry's config.yaml owns)
    refused rather than ignored. ``conflicts`` maps flag -> True when set."""
    from triton_client_tpu_torch.runtime.disk_repository import load_pipeline

    if not args.model_name:
        raise SystemExit("--repo requires -m/--model-name")
    bad = sorted(flag for flag, set_ in conflicts.items() if set_)
    if bad:
        raise SystemExit(
            f"{', '.join(bad)} conflict with --repo: the repo entry's "
            "config.yaml owns the model shape; edit the entry instead"
        )
    try:
        return load_pipeline(os.path.join(args.repo, args.model_name), args.model_version,
                             overrides or None, kind=kind, device=args.device)
    except (ValueError, FileNotFoundError, KeyError) as e:
        # KeyError: an unknown config.yaml key; still a usage exit
        raise SystemExit(str(e))


def load_names(path: str) -> tuple[str, ...]:
    if not path:
        return ()
    from triton_client_tpu_torch.pipelines.detect2d import load_class_names

    return load_class_names(path)


def print_report(stats, summary=None, extra=None) -> None:
    out = {"driver": stats.to_dict()}
    if summary is not None:
        out["eval"] = summary
    if extra:
        out.update(extra)
    print(json.dumps(out))


def make_profiler(args):
    """--profile -> StageProfiler (None when off)."""
    if not getattr(args, "profile", False):
        return None
    from triton_client_tpu_torch.obs.profiling import StageProfiler

    return StageProfiler()


def maybe_device_trace(args):
    """--profile-trace <dir> -> a torch.profiler trace context (else no-op)."""
    log_dir = getattr(args, "profile_trace", "")
    if not log_dir:
        return contextlib.nullcontext()
    from triton_client_tpu_torch.obs.profiling import device_trace

    return device_trace(log_dir)


def make_evaluator(args, kind: str):
    """--gt -> (evaluator, gt_lookup), or (None, None)."""
    if not args.gt:
        return None, None
    from triton_client_tpu_torch.eval.detection_map import (
        Detection3DEvaluator,
        DetectionEvaluator,
    )

    if kind == "2d":
        return DetectionEvaluator(), load_gt_lookup(args.gt)
    from triton_client_tpu_torch.io.synthdata import load_gt3d_lookup

    return Detection3DEvaluator(), load_gt3d_lookup(args.gt)


def run_driver(args, infer, source, sink, batch_size: int, kind: str):
    """The shared tail of both CLIs, local and remote: the driver over the
    source with the --gt evaluator, --profile table and --profile-trace
    window. Returns (stats, eval summary or None, evaluator or None)."""
    import sys

    from triton_client_tpu_torch.drivers.driver import InferenceDriver

    evaluator, gt_lookup = make_evaluator(args, kind)
    profiler = make_profiler(args)
    driver = InferenceDriver(
        infer,
        source,
        sink=sink,
        prefetch=max(args.prefetch, batch_size),
        warmup=args.warmup,
        evaluator=evaluator,
        gt_lookup=gt_lookup,
        profiler=profiler,
        batch_size=batch_size,
        inflight=args.inflight if args.async_set else 1,
    )
    with maybe_device_trace(args):
        stats = driver.run(max_frames=args.limit)
    if profiler is not None:
        print(profiler.report(), file=sys.stderr)
    return stats, evaluator.summary() if evaluator is not None else None, evaluator


def serve_eval_metrics(port: int, evaluator) -> None:
    """``--prometheus-port``: observe each evaluated frame into the five
    Summaries of ``EvalPrometheusExporter`` on ``port``, then keep the
    process (and its HTTP server) alive until interrupted, so a scrape can
    happen."""
    import sys
    import time

    from triton_client_tpu_torch.eval.prometheus_export import EvalPrometheusExporter

    exporter = EvalPrometheusExporter(port)
    for frame_stats in evaluator.per_frame_summaries():
        exporter.observe(*frame_stats)
    print(f"serving eval metrics on :{port}; Ctrl-C to exit", file=sys.stderr, flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass


def ros_node(kind: str, infer, topic: str, class_names: tuple[str, ...] = ()):
    """``-i ros:<topic>`` -> the live node of ``drivers/ros.py`` (SystemExit
    with its message where ROS is not installed)."""
    from triton_client_tpu_torch.drivers import ros

    try:
        if kind == "2d":
            return ros.RosDetect2D(infer, sub_topic=topic, pub_topic="/tpu_detections/image",
                                   class_names=class_names)
        return ros.RosDetect3D(infer, sub_topic=topic, pub_topic="/tpu_detections/boxes3d")
    except ImportError as e:
        raise SystemExit(str(e))


def require_ros() -> None:
    """Fail a ``ros:`` input before any model is built where ROS is not
    installed, with the ROS driver's own message."""
    from triton_client_tpu_torch.drivers import ros

    try:
        ros._require_ros()
    except ImportError as e:
        raise SystemExit(str(e))
