"""Shared CLI flags and wiring helpers (the ported subset of
``cli/common.py``).

``-b`` batch size, ``--async``/``--inflight`` futures pipelining,
``--prefetch``, ``--warmup``, ``--limit``, ``--sink null|jsonl`` with
``-o``, ``--names``, and ``--pipeline-depth`` for the channel's staging
slots. The JAX CLI's remote channel, ``--repo``, ``--gt``, the image,
bag and ROS sinks and the profiling flags wait for the layers they drive.
"""

from __future__ import annotations

import argparse
import json
import os


def add_common_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-b", "--batch-size", type=int, default=1)
    parser.add_argument("--limit", type=int, default=0, help="max frames")
    parser.add_argument(
        "--sink", default="null", choices=("null", "jsonl"),
        help="where detections go: nowhere, or <output>/detections.jsonl",
    )
    parser.add_argument("-o", "--output", default="./output_data")
    parser.add_argument("--names", default="", help="class-names file")
    parser.add_argument(
        "--async", dest="async_set", action="store_true",
        help="pipeline inference with async futures: keep --inflight requests "
        "outstanding so host prep overlaps device compute",
    )
    parser.add_argument(
        "--inflight", type=int, default=2, help="max outstanding requests with --async (>=2)"
    )
    parser.add_argument("--prefetch", type=int, default=4)
    parser.add_argument("--warmup", type=int, default=1)
    parser.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="the channel's staging slots: launched requests allowed before "
        "staging the next one waits (1 is serial)",
    )
    parser.add_argument(
        "--device", default=None, choices=("cuda", "cpu"),
        help="default cuda; cpu runs the kernels' plain versions",
    )


def _check_async_flags(args) -> None:
    """--async combination guards shared by the 2D/3D entry points."""
    if args.batch_size > 1:
        raise SystemExit(
            "--async pipelines single-frame dispatches; it does not "
            "combine with -b/--batch-size"
        )
    if args.inflight < 2:
        raise SystemExit("--inflight must be >= 2 with --async")


def make_sink(args):
    from triton_client_tpu_torch.io.sinks import DetectionLogSink, NullSink

    if args.sink == "jsonl":
        return DetectionLogSink(os.path.join(args.output, "detections.jsonl"))
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


def load_names(path: str) -> tuple[str, ...]:
    if not path:
        return ()
    from triton_client_tpu_torch.pipelines.detect2d import load_class_names

    return load_class_names(path)


def print_report(stats, extra=None) -> None:
    out = {"driver": stats.to_dict()}
    if extra:
        out.update(extra)
    print(json.dumps(out))
