"""Dataset, repository and measurement utility commands (the port's copy of
the bag tools, ``repo-index``, ``trace-dump``, ``trace-join`` and
``roofline`` of ``cli/tools.py``).

  pc-extract  — PointCloud2 topic of a bag -> numbered .npy point clouds
                (the input of the 3D ``.npy`` replay source).
  bag-stitch  — copy the first N messages (optionally per topic) of a
                bag into a new bag: truncated fixture bags for tests.
  bag-info    — topics, types and counts of a bag (the ``rosbag info``
                equivalent, for hosts with no ROS tooling).
  repo-index  — list a model repository: a local directory (parsed, not
                built) or a live server's RepositoryIndex over gRPC.
  trace-dump  — a live server's recent request traces (its telemetry
                ``/traces``) as Chrome-trace JSON; ``--ops PATH``: rank the
                card's ops by device time with their owning model, from a
                ``--profile-trace`` directory or a ``.json[.gz]`` trace file
                (``obs/opstats.py``); bare ``--ops``: the same from a live
                capture through ``/profile``.
  trace-join  — merge several Chrome-trace files onto one timeline, each
                source its own process row, shifted by ``--offset NAME=US``
                or by half the best probe round trip of ``--probe
                NAME=URL``.
  roofline    — per-model roofline report (compute- or bandwidth-bound,
                the attainable-fps ceiling, ``obs/roofline.py``) from a
                live server's ``/snapshot`` URL, a results JSON carrying the
                ``roofline_*`` columns or a model snapshot file
                (``{"models": [{"model", "version", "roofline"}]}``).

Usage:
  python -m triton_client_tpu_torch pc-extract scans.bag -o clouds
  python -m triton_client_tpu_torch bag-stitch scans.bag first10.bag -n 10
  python -m triton_client_tpu_torch bag-info scans.bag
  python -m triton_client_tpu_torch repo-index examples
  python -m triton_client_tpu_torch repo-index grpc:127.0.0.1:8001
  python -m triton_client_tpu_torch detect2d -r examples -m yolov5_crop \
      -i synthetic:8:512x512 --profile-trace prof
  python -m triton_client_tpu_torch trace-dump --ops prof -o ops.json
  python -m triton_client_tpu_torch trace-dump --url http://127.0.0.1:8002 -n 50 -o t.json
  python -m triton_client_tpu_torch trace-dump --url http://127.0.0.1:8002 --ops --seconds 2
  python -m triton_client_tpu_torch trace-join client=a.json server=b.json \
      --offset server=1500 -o joined.json
  python -m triton_client_tpu_torch roofline models.json
  python -m triton_client_tpu_torch roofline http://127.0.0.1:8002
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


def trace_dump(argv=None) -> None:
    """Fetch a live server's recent request traces from its telemetry port
    and write Chrome-trace JSON (the face of ``/traces``), or, with
    ``--ops``, a per-op device-time report of a ``torch.profiler``
    capture: a saved one (a path) or a live one through ``/profile``."""
    p = argparse.ArgumentParser(description="dump recent request traces as Chrome-trace JSON")
    p.add_argument("--url", default="http://127.0.0.1:8002",
                   help="telemetry endpoint of the serving process (serve --metrics-port)")
    p.add_argument("-n", "--count", type=int, default=0,
                   help="most recent N traces (0 = everything buffered)")
    p.add_argument("-o", "--output", default="-",
                   help="output file ('-' = stdout); load in Perfetto or chrome://tracing")
    p.add_argument("--timeout", type=float, default=10.0)
    p.add_argument(
        "--ops", nargs="?", const="", default=None, metavar="TRACE",
        help="per-op device-time report instead of a raw trace dump: with a PATH, "
        "summarize that torch.profiler capture (a --profile-trace dir or a .json[.gz] "
        "trace file) offline; bare --ops takes a live capture through <url>/profile first",
    )
    p.add_argument("--seconds", type=float, default=1.0,
                   help="live capture window for bare --ops (the /profile knob)")
    p.add_argument("--top-k", type=int, default=20, help="op rows to keep in the --ops report")
    args = p.parse_args(argv)

    import json
    import sys
    import urllib.request

    if args.ops is None:
        url = args.url.rstrip("/") + "/traces"
        if args.count:
            url += f"?n={args.count}"
        with urllib.request.urlopen(url, timeout=args.timeout) as resp:
            doc = json.load(resp)
        events = doc.get("traceEvents")
        if events is None:
            raise SystemExit(f"{url} returned no traceEvents (not a trace dump?)")
        body = json.dumps(doc)
        if args.output == "-":
            print(body)
        else:
            with open(args.output, "w") as f:
                f.write(body)
            n_req = sum(1 for e in events if e.get("ph") == "X" and e.get("name") == "request")
            print(f"wrote {n_req} request traces ({len(events)} events) -> {args.output}",
                  file=sys.stderr)
        return
    if args.ops:
        from triton_client_tpu_torch.obs import opstats

        summary = opstats.summarize_profile_dir(args.ops, top_k=args.top_k)
    else:
        url = args.url.rstrip("/") + f"/profile?seconds={args.seconds}&top_k={args.top_k}"
        with urllib.request.urlopen(url, timeout=args.timeout + args.seconds) as resp:
            doc = json.load(resp)
        if "op_summary" not in doc:
            raise SystemExit(f"{url} returned no op summary "
                             f"({doc.get('op_summary_error', 'unknown failure')})")
        summary = doc["op_summary"]
    total_us = summary.get("total_op_time_us", 0.0) or 0.0
    print(f"{summary.get('op_count', 0)} distinct ops, "
          f"{total_us / 1e3:.3f} ms total device op time")
    for model, us in sorted((summary.get("models") or {}).items(), key=lambda kv: -kv[1]):
        print(f"  {model}: {us / 1e3:.3f} ms")
    unattr = summary.get("unattributed_us", 0.0)
    if unattr:
        print(f"  (unattributed: {unattr / 1e3:.3f} ms)")
    hdr = f"{'model':<16} {'kind':<14} {'occ':>5} {'ms':>10} {'share':>7}  op"
    print(hdr)
    print("-" * len(hdr))
    for row in summary.get("ops") or []:
        print(
            f"{(row.get('model') or '-'):<16} "
            f"{row.get('kind', '?'):<14} "
            f"{row.get('occurrences', 0):>5} "
            f"{row.get('time_us', 0.0) / 1e3:>10.3f} "
            f"{row.get('share', 0.0):>6.1%}  "
            f"{row.get('op', '?')}"
        )
    if args.output != "-":
        with open(args.output, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"wrote op summary -> {args.output}", file=sys.stderr)


def trace_join(argv=None) -> None:
    """Merge per-process Chrome-trace exports onto one timeline: each input
    file becomes a distinct pid (one process track per source), its events
    shifted by an explicit per-source clock offset (``--offset``)."""
    p = argparse.ArgumentParser(
        description="join client/router/replica Chrome-trace dumps onto one timeline")
    p.add_argument(
        "inputs", nargs="+", metavar="[NAME=]FILE",
        help="Chrome-trace JSON files; NAME labels the source's process track "
        "(default: file basename)",
    )
    p.add_argument(
        "--offset", action="append", default=[], metavar="NAME=US",
        help="shift NAME's events by this many microseconds "
        "(repeatable; positive = later on the joined timeline)",
    )
    p.add_argument(
        "--probe", action="append", default=[], metavar="NAME=URL",
        help="estimate NAME's offset as half the best-of-3 HTTP probe round-trip against "
        "its telemetry URL (repeatable)",
    )
    p.add_argument("-o", "--output", default="-",
                   help="output file ('-' = stdout); load in Perfetto")
    p.add_argument("--timeout", type=float, default=5.0)
    args = p.parse_args(argv)

    import json
    import sys
    import time
    import urllib.request

    def parse_kv(items, what):
        out = {}
        for item in items:
            name, sep, value = item.partition("=")
            if not sep:
                raise SystemExit(f"--{what} wants NAME=VALUE, got {item!r}")
            out[name] = value
        return out

    offsets = {name: float(us) for name, us in parse_kv(args.offset, "offset").items()}
    for name, url in parse_kv(args.probe, "probe").items():
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(url, timeout=args.timeout):
                    pass
            except Exception as e:
                raise SystemExit(f"probe against {url} failed: {e}")
            rtt = time.perf_counter() - t0
            best = rtt if best is None else min(best, rtt)
        offsets[name] = offsets.get(name, 0.0) + best / 2.0 * 1e6
        print(f"probe {name}: rtt {best * 1e3:.3f} ms -> offset {best / 2.0 * 1e3:.3f} ms",
              file=sys.stderr)

    events: list[dict] = []
    for i, item in enumerate(args.inputs):
        name, sep, path = item.partition("=")
        if not sep:
            name, path = "", item
        if not name:
            name = os.path.splitext(os.path.basename(path))[0]
        with open(path) as f:
            doc = json.load(f)
        src = doc.get("traceEvents")
        if src is None:
            raise SystemExit(f"{path}: no traceEvents (not a trace dump?)")
        pid = i + 1
        shift = offsets.get(name, 0.0)
        events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                       "args": {"name": name}})
        n = 0
        for ev in src:
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                continue  # replaced by the source-labelled one above
            ev = dict(ev)
            ev["pid"] = pid
            if "ts" in ev:
                ev["ts"] = round(ev["ts"] + shift, 3)
            events.append(ev)
            n += 1
        print(f"{name}: {n} events, offset {shift / 1e3:+.3f} ms", file=sys.stderr)

    events.sort(key=lambda e: (e.get("ts", -1.0), e.get("pid", 0)))
    body = json.dumps({"traceEvents": events, "displayTimeUnit": "ms"})
    if args.output == "-":
        print(body)
    else:
        with open(args.output, "w") as f:
            f.write(body)
        print(f"wrote {len(events)} joined events -> {args.output}", file=sys.stderr)


def roofline(argv=None) -> None:
    """Per-model roofline report: measured flops/bytes, arithmetic intensity
    against the H100's knee, the binding ceiling and the attainable-fps
    ceiling beside the measured rate, from a live server's ``/snapshot`` or
    a file."""
    p = argparse.ArgumentParser(
        description="per-model roofline classification "
        "(compute- vs bandwidth-bound, attainable-fps ceiling)")
    p.add_argument(
        "source", nargs="?", default="http://127.0.0.1:8002",
        help="telemetry URL of a serving process (reads /snapshot), a results JSON with "
        "the roofline_* columns, or a model snapshot file "
        "({\"models\": [{\"model\", \"version\", \"roofline\"}]})",
    )
    p.add_argument("--timeout", type=float, default=10.0)
    p.add_argument("--json", action="store_true", help="machine-readable JSON output")
    args = p.parse_args(argv)

    import json
    import urllib.request

    if os.path.exists(args.source):
        with open(args.source) as f:
            doc = json.load(f)
    else:
        url = args.source.rstrip("/") + "/snapshot"
        with urllib.request.urlopen(url, timeout=args.timeout) as resp:
            doc = json.load(resp)
    rows = []
    # results rows carry the roofline columns directly
    for r in doc.get("rows") or doc.get("results") or []:
        if not r.get("roofline_bound"):
            continue
        per_call = r.get("flops_per_call") or ((r.get("flops_per_frame") or 0.0) * 1)
        rows.append({
            "model": r.get("metric", "?"),
            "precision": r.get("precision", "f32"),
            "flops": per_call,
            "bytes": r.get("bytes_per_call") or r.get("bytes_per_frame") or 0.0,
            "intensity": r.get("arithmetic_intensity", 0.0),
            "bound": r.get("roofline_bound", "unknown"),
            "attainable_fps": r.get("attainable_fps", 0.0),
            "measured_fps": r.get("value"),
            "attained_fraction": r.get("roofline_attained_ratio"),
        })
    # a model snapshot: each model's obs/roofline.model_row
    for m in doc.get("models") or []:
        roof = m.get("roofline")
        if not roof:
            continue
        rows.append({
            "model": f"{m['model']}:{m['version']}",
            "precision": roof.get("precision", "f32"),
            "flops": roof.get("flops", 0.0),
            "bytes": roof.get("bytes", 0.0),
            "intensity": roof.get("intensity", 0.0),
            "bound": roof.get("bound", "unknown"),
            "attainable_fps": roof.get("attainable_fps", 0.0),
            "measured_fps": roof.get("measured_fps"),
            "attained_fraction": roof.get("attained_fraction"),
        })
    if args.json:
        print(json.dumps({"rows": rows}, indent=2))
        return
    if not rows:
        raise SystemExit(
            "no roofline rows: a model records its measured flops/bytes at its first "
            "launch with a device-time ledger attached, and results JSON needs the "
            "roofline_* columns"
        )
    hdr = (
        f"{'model':<40} {'prec':<6} {'GF/call':>9} {'MB/call':>9} "
        f"{'flop/B':>8} {'bound':<10} {'ceiling fps':>12} {'attained':>9}"
    )
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        attained = (f"{r['attained_fraction']:.1%}"
                    if r.get("attained_fraction") is not None else "-")
        print(
            f"{r['model']:<40} {r['precision']:<6} "
            f"{r['flops'] / 1e9:>9.2f} {r['bytes'] / 1e6:>9.2f} "
            f"{r['intensity']:>8.1f} {r['bound']:<10} "
            f"{r['attainable_fps']:>12.1f} {attained:>9}"
        )
