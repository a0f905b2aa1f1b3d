"""Dataset and repository utility commands (the port's copy of the bag
tools and ``repo-index`` of ``cli/tools.py``).

  pc-extract  — PointCloud2 topic of a bag -> numbered .npy point clouds
                (the input of the 3D ``.npy`` replay source).
  bag-stitch  — copy the first N messages (optionally per topic) of a
                bag into a new bag: truncated fixture bags for tests.
  bag-info    — topics, types and counts of a bag (the ``rosbag info``
                equivalent, for hosts with no ROS tooling).
  repo-index  — list a model repository: a local directory (parsed, not
                built) or a live server's RepositoryIndex over gRPC.

Usage:
  python -m triton_client_tpu_torch pc-extract scans.bag -o clouds
  python -m triton_client_tpu_torch bag-stitch scans.bag first10.bag -n 10
  python -m triton_client_tpu_torch bag-info scans.bag
  python -m triton_client_tpu_torch repo-index examples
  python -m triton_client_tpu_torch repo-index grpc:127.0.0.1:8001
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def pc_extract(argv=None) -> None:
    p = argparse.ArgumentParser(description="bag -> .npy point clouds")
    p.add_argument("bag_file")
    p.add_argument("--pc-topic", default=None, help="default: first PointCloud2 topic")
    p.add_argument("-o", "--output", default="./extracted_clouds")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument(
        "--intensity-scale",
        type=float,
        default=1.0,
        help="divide intensity by this (pc_extractor.py normalizes /255)",
    )
    args = p.parse_args(argv)

    from triton_client_tpu_torch.io.bag_io import BagPointCloudSource

    os.makedirs(args.output, exist_ok=True)
    src = BagPointCloudSource(args.bag_file, topic=args.pc_topic, limit=args.limit)
    n = 0
    for i, frame in enumerate(src):
        pts = frame.data.copy()
        if args.intensity_scale != 1.0:
            pts[:, 3] /= args.intensity_scale
        np.save(os.path.join(args.output, f"{i:06d}.npy"), pts)
        n += 1
    print(f"extracted {n} point clouds from {src.topic} -> {args.output}")


def bag_stitch(argv=None) -> None:
    p = argparse.ArgumentParser(description="truncate/copy a bag")
    p.add_argument("in_bag")
    p.add_argument("out_bag")
    p.add_argument("-n", "--count", type=int, default=100, help="max messages")
    p.add_argument("--topics", nargs="*", default=None)
    args = p.parse_args(argv)

    from triton_client_tpu_torch.io import rosbag as rb

    n = 0
    with rb.BagReader(args.in_bag) as r, rb.BagWriter(args.out_bag) as w:
        for topic, bm, t in r.read_messages(topics=args.topics, raw=True):
            if n >= args.count:
                break
            w.write(topic, bm, t=t)
            n += 1
    print(f"wrote {n} messages -> {args.out_bag}")


def bag_info(argv=None) -> None:
    p = argparse.ArgumentParser(description="bag topic/type/count summary")
    p.add_argument("bag_file")
    args = p.parse_args(argv)

    from triton_client_tpu_torch.io import rosbag as rb

    counts: dict[str, int] = {}
    t0, t1 = None, None
    with rb.BagReader(args.bag_file) as r:
        for topic, _, t in r.read_messages(raw=True):
            counts[topic] = counts.get(topic, 0) + 1
            t0 = t if t0 is None else min(t0, t)
            t1 = t if t1 is None else max(t1, t)
        types = {c.topic: c.datatype for c in r.connections.values()}
    if t0 is not None:
        print(f"duration: {t1 - t0:.3f}s  messages: {sum(counts.values())}")
    for topic in sorted(counts):
        print(f"  {topic}  {types.get(topic, '?')}  {counts[topic]} msgs")


def repo_index(argv=None) -> None:
    """List a model repository: local directory (parsed, not built) or a
    live server's RepositoryIndex over gRPC."""
    p = argparse.ArgumentParser(
        description="list model-repository contents (local dir or grpc:<addr>)"
    )
    p.add_argument("target", help="repository root dir or grpc:<host:port>")
    args = p.parse_args(argv)

    if args.target.startswith("grpc:"):
        from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel

        channel = GRPCChannel(args.target[len("grpc:"):])
        try:
            for name, version, state in channel.repository_index():
                print(f"{name}:{version}  {state}")
        finally:
            channel.close()
        return

    import pathlib

    from triton_client_tpu_torch.dataset_config import load_yaml
    from triton_client_tpu_torch.runtime.disk_repository import (
        find_weights,
        version_dirs,
    )

    root = pathlib.Path(args.target)
    if not root.is_dir():
        raise SystemExit(f"{args.target!r} is not a directory or grpc: address")
    for model_dir in sorted(d for d in root.iterdir() if d.is_dir()):
        cfg = model_dir / "config.yaml"
        if not cfg.exists():
            continue
        doc = load_yaml(str(cfg))
        versions = version_dirs(model_dir)
        if not versions:
            print(f"{model_dir.name}:1  family={doc.get('family')}  (fresh-init)")
        for vdir in versions:
            try:
                artifact = find_weights(vdir).name
            except FileNotFoundError:
                artifact = "MISSING WEIGHTS"
            print(
                f"{model_dir.name}:{vdir.name}  family={doc.get('family')}  "
                f"{artifact}"
            )
