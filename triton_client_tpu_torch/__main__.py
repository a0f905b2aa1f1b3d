"""``python -m triton_client_tpu_torch <command>`` dispatch.

Commands ported so far:
  detect2d   — 2D detection over synthetic frames, in-process (-u cuda) or
               as a client of serve (-u grpc:<host:port> | grpc:unix:<path>)
  detect3d   — 3D detection (PointPillars, SECOND-IoU) over point clouds,
               in-process or as a client of serve
  serve      — a disk model repository behind the KServe v2 gRPC server
"""

from __future__ import annotations

import sys

COMMANDS = ("detect2d", "detect3d", "serve")


def main() -> None:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print(__doc__)
        raise SystemExit(0 if len(sys.argv) >= 2 else 2)
    cmd, argv = sys.argv[1], sys.argv[2:]
    if cmd == "detect2d":
        from triton_client_tpu_torch.cli.detect2d import main as run
    elif cmd == "detect3d":
        from triton_client_tpu_torch.cli.detect3d import main as run
    elif cmd == "serve":
        from triton_client_tpu_torch.cli.serve import main as run
    else:
        print(f"unknown command '{cmd}'; commands: {', '.join(COMMANDS)}")
        raise SystemExit(2)
    run(argv)


if __name__ == "__main__":
    main()
