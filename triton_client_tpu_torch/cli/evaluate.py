"""Accuracy evaluation entry point (the port's copy of ``cli/evaluate.py``).

Replays an image source against a ground-truth JSONL, computes COCO
101-point mAP at IoU 0.5:0.05:0.95 with per-class P/R/F1, and serves the
reference's five Prometheus Summaries on ``--prometheus-port`` (7658 when
none is given) until interrupted. Replay joins frames and ground truth on
``frame_id``, so nothing has to wait for two topics to line up.

Usage:
  python -m triton_client_tpu_torch evaluate -i frames.bag --gt gt.jsonl
  python -m triton_client_tpu_torch evaluate -r repo -m yolov5_crop -i ./images --gt gt.jsonl
"""

from __future__ import annotations

import argparse
import sys

from triton_client_tpu_torch.cli import detect2d
from triton_client_tpu_torch.cli.common import add_common_flags


def main(argv=None) -> None:
    # evaluate is detect2d with --gt required; the original argv goes on
    # unchanged (every evaluate flag is a detect2d flag), so detect2d's
    # explicit-flag guards see what the user typed
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_flags(parser)
    parser.add_argument("--input-size", type=int, default=512)
    parser.add_argument("--conf", type=float, default=None)
    parser.add_argument("--iou", type=float, default=None)
    parser.add_argument("--width", type=float, default=1.0)
    args = parser.parse_args(argv)
    if not args.gt:
        parser.error("--gt <file.jsonl> is required for evaluation")

    forwarded = list(argv) if argv is not None else list(sys.argv[1:])
    if args.prometheus_port == 0:
        forwarded += ["--prometheus-port", "7658"]
    detect2d.main(forwarded)


if __name__ == "__main__":
    main()
