"""``python -m triton_client_tpu_torch <command>`` dispatch.

Commands ported so far:
  detect2d   — 2D detection over synthetic frames, an image directory, a
               video or a bag, in-process (-u cuda) or as a client of serve
               (-u grpc:<host:port> | grpc:unix:<path>)
  detect3d   — 3D detection (PointPillars, SECOND-IoU, CenterPoint) over
               point clouds (.npy directory, bag, synthetic), in-process or
               as a client of serve
  evaluate   — detect2d against a ground-truth JSONL (--gt), serving the
               evaluator's Prometheus Summaries after the run
  serve      — a disk model repository behind the KServe v2 gRPC server
  pc-extract — bag -> numbered .npy point clouds
  bag-stitch — copy the first N messages of a bag into a new bag
  bag-info   — topics, types and counts of a bag
  repo-index — list a model repository (local dir or grpc:<addr>)
  route      — one health pass over a replica set (live / ready /
               ModelReady, replica_of labels, transport; --watch N)
  trace-dump — --ops PATH ranks the card's ops by device time with their
               owning model, from a --profile-trace capture
  trace-join — merge Chrome-trace dumps onto one timeline (per-source pid
               rows + --offset clock offsets)
  roofline   — per-model compute-/bandwidth-bound classification with the
               attainable-fps ceiling (a results JSON or a model snapshot)
"""

from __future__ import annotations

import sys

COMMANDS = ("detect2d", "detect3d", "evaluate", "serve", "pc-extract", "bag-stitch",
            "bag-info", "repo-index", "route", "trace-dump", "trace-join", "roofline")


def main() -> None:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print(__doc__)
        raise SystemExit(0 if len(sys.argv) >= 2 else 2)
    cmd, argv = sys.argv[1], sys.argv[2:]
    if cmd == "detect2d":
        from triton_client_tpu_torch.cli.detect2d import main as run
    elif cmd == "detect3d":
        from triton_client_tpu_torch.cli.detect3d import main as run
    elif cmd == "evaluate":
        from triton_client_tpu_torch.cli.evaluate import main as run
    elif cmd == "serve":
        from triton_client_tpu_torch.cli.serve import main as run
    elif cmd == "pc-extract":
        from triton_client_tpu_torch.cli.tools import pc_extract as run
    elif cmd == "bag-stitch":
        from triton_client_tpu_torch.cli.tools import bag_stitch as run
    elif cmd == "bag-info":
        from triton_client_tpu_torch.cli.tools import bag_info as run
    elif cmd == "repo-index":
        from triton_client_tpu_torch.cli.tools import repo_index as run
    elif cmd == "route":
        from triton_client_tpu_torch.cli.tools import route as run
    elif cmd == "trace-dump":
        from triton_client_tpu_torch.cli.tools import trace_dump as run
    elif cmd == "trace-join":
        from triton_client_tpu_torch.cli.tools import trace_join as run
    elif cmd == "roofline":
        from triton_client_tpu_torch.cli.tools import roofline as run
    else:
        print(f"unknown command '{cmd}'; commands: {', '.join(COMMANDS)}")
        raise SystemExit(2)
    run(argv)


if __name__ == "__main__":
    main()
