"""Time the port's loopback socket leg (``chip_smoke.py`` phase 25's) in
several checkouts on one card, alternating them.

    python3 socket_ab.py --out socket_ab.json ROOT_A ROOT_B [--pairs 3]

Each run is a fresh process that imports ``triton_client_tpu_torch`` and
``chip_smoke`` from its checkout, builds phase 25's entries from that
checkout's ``examples/``, serves them with ``InferenceServer`` on
127.0.0.1 and times ``GRPCChannel(use_shared_memory=False).do_inference``,
one request at a time, on phase 25's two timed requests: YOLOv5n at conf
0.05, batch 1 (an FP32 512² frame), and PointPillars on a 120k-point
scan. For each it reports the p50 and mean latency, the server's wall
from the response's span summary (p50), the rest of the round trip
(p50 of latency less wall), and the client's own message build and
serialization and its response parse (p50, outside the RPC). For each
pair the runs go A, B, B, A. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np


def child(root: str, requests: int) -> dict:
    """One checkout's run (see the module docstring)."""
    sys.path.insert(0, root)
    os.chdir(root)  # the entries name data/ files relative to the checkout
    import shutil
    import tempfile

    import chip_smoke as cs
    import torch

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel
    from triton_client_tpu_torch.channel.kserve import codec
    from triton_client_tpu_torch.pipelines.detect3d import prepare_points
    from triton_client_tpu_torch.runtime.disk_repository import scan_disk
    from triton_client_tpu_torch.runtime.server import InferenceServer

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="socket_ab_"))
    try:
        repo = scan_disk(cs.facade_repository(tmp))
        for name, _ in repo.list_models():
            repo.get(name).warmup()
    finally:
        shutil.rmtree(tmp)
    hw = tuple(repo.metadata(cs.FACADE_C005).extra["model_input_hw"])
    frame = np.random.default_rng(25).integers(0, 256, (1, *hw, 3)).astype(np.float32)
    pp = "pointpillar_kitti"
    cfg = repo.metadata(pp).extra
    cloud = cs.uniform_clouds(251, (0.0, -39.68, -3.0, 69.12, 39.68, 1.0), cs.SCAN_POINTS[1],
                              1)[0]
    padded, m = prepare_points(cloud, 4, cfg["point_buckets"], cfg["z_offset"])
    reqs = {"yolov5n_c005_b1": InferRequest(cs.FACADE_C005, {"images": frame}),
            f"{pp}_{cs.SCAN_POINTS[1]}": InferRequest(
                pp, {"points": padded, "num_points": np.asarray(m, np.int32)})}

    server = InferenceServer(repo, CUDAChannel(repo), address="127.0.0.1:0", max_workers=4)
    server.start()
    out = {"root": root}
    try:
        client = GRPCChannel(f"127.0.0.1:{server.port}", timeout_s=120,
                             use_shared_memory=False)
        for label, req in reqs.items():
            for _ in range(10):
                client.do_inference(req)
            lat, wall = [], []
            for _ in range(requests):
                t0 = time.perf_counter()
                resp = client.do_inference(req)
                lat.append(time.perf_counter() - t0)
                summary = json.loads((resp.parameters or {})["trace_summary"])
                wall.append(summary["w"] / 1e6)
            build, parse = [], []
            for _ in range(requests):
                t0 = time.perf_counter()
                msg = codec.build_infer_request(req.model_name, req.inputs,
                                                request_id=req.request_id)
                msg.SerializeToString()
                t1 = time.perf_counter()
                build.append(t1 - t0)
            wire_resp = client._stub.ModelInfer(msg, timeout=60)
            for _ in range(requests):
                t0 = time.perf_counter()
                codec.parse_infer_response(wire_resp)
                parse.append(time.perf_counter() - t0)
            lat_a, wall_a = np.asarray(lat), np.asarray(wall)
            out[label] = {
                "p50_ms": float(np.median(lat_a)) * 1e3,
                "mean_ms": float(lat_a.mean()) * 1e3,
                "server_wall_ms_p50": float(np.median(wall_a)) * 1e3,
                "beyond_server_ms_p50": float(np.median(lat_a - wall_a)) * 1e3,
                "client_build_serialize_ms_p50": float(np.median(build)) * 1e3,
                "client_parse_ms_p50": float(np.median(parse)) * 1e3,
                "requests": requests,
            }
        client.close()
    finally:
        server.stop()
    torch.cuda.synchronize()
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", help="checkouts to compare (A B)")
    ap.add_argument("--pairs", type=int, default=3, help="A B B A rounds")
    ap.add_argument("--requests", type=int, default=200, help="timed requests a leg and run")
    ap.add_argument("--out", default="", help="write every run's JSON here")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child, args.requests)))
        return 0
    if len(args.roots) != 2:
        ap.error("give two checkouts")
    roots = [str(pathlib.Path(r).resolve()) for r in args.roots]
    runs = []
    for pair in range(args.pairs):
        for root in (roots[0], roots[1], roots[1], roots[0]):
            proc = subprocess.run(
                [sys.executable, str(pathlib.Path(__file__).resolve()), "--child", root,
                 "--requests", str(args.requests)],
                capture_output=True, text=True, timeout=900,
            )
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-4000:])
                return proc.returncode
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            run["pair"] = pair
            runs.append(run)
            print(json.dumps(run), flush=True)
    summary = {}
    for root in roots:
        mine = [r for r in runs if r["root"] == root]
        summary[root] = {
            label: {key: [r[label][key] for r in mine] for key in mine[0][label]
                    if key != "requests"}
            for label in mine[0] if label not in ("root", "pair")
        }
    print(json.dumps({"summary": summary}))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps({"runs": runs, "summary": summary},
                                                     indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
