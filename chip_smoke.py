#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``triton_client_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``triton_client_tpu_torch/
csrc/`` and drives the port's main path: YOLOv5n at 512x512 (the
settings of ``examples/yolov5_crop_base``, random weights from a seed)
served in-process through ``ModelRepository`` and ``CUDAChannel``. One
JSON line per phase:

  1. card      — the card's name and power limit, the kernels' build time
  2. kernels   — each kernel against its plain PyTorch version on the card,
                 at the main path's shapes, over edge-case candidate sets:
                 bitwise equal or the script fails
  3. main_path — requests at batch 1 and 8 through the channel, fused and
                 unfused routes; launch counts read around this phase only
  4. check     — the card's output against the plain tail and the CPU path
  5. times     — kernel and plain-version times (CUDA events), frames/s
                 and p50 latency at batch 1 and 8
  6. profile   — where a request's time goes, under torch.profiler: device
                 ms and busy share per request, device ops per request,
                 the device ops that took the most time, at batch 1 and 8

then the ``{"kernels": [...]}`` record and, last, the ``{"ok": true, ...}``
line. Any failed check exits nonzero; nothing is caught or falls back.
It imports nothing of JAX. Without a CUDA device it exits 2 and prints
no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent
B_MAIN, K_MAIN, MAX_DET, NC = 8, 1024, 300, 2
PROFILE_REQUESTS, PROFILE_TOP = 10, 12
# fp32 non-tensor-core rate and memory rate of an H100 SXM at 700 W
# (NVIDIA H100 data sheet)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# float operations of one IoU test against the chosen box in the
# greedy loop: 2 min, 2 max, 2 sub, 2 clamp, 1 mul, 1 add, 1 sub,
# 1 max, 1 div, 1 compare
IOU_OPS = 14


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(phase: str, card: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": card, **fields}), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean ms of ``fn`` on the card's clock: CUDA events around ``reps``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def live_counts(boxes, live, thresh, max_det):
    """Live candidates at each step of the greedy loop, summed over the
    batch: the IoU tests this run's data needs (the kernel skips the
    dead ones and stops when none is left)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    lane = torch.arange(live.shape[1], device=live.device)
    total = 0
    for _ in range(max_det):
        alive = live > float("-inf")
        n = int(alive.sum())
        if n == 0:
            break
        total += n
        best = live.argmax(1)[:, None]
        g = lambda t: t.gather(1, best)  # noqa: E731
        iw = (torch.minimum(x2, g(x2)) - torch.maximum(x1, g(x1))).clamp(min=0)
        ih = (torch.minimum(y2, g(y2)) - torch.maximum(y1, g(y1))).clamp(min=0)
        inter = iw * ih
        iou = inter / (area + g(area) - inter).clamp(min=1e-9)
        live = torch.where((iou > thresh) | (lane == best), float("-inf"), live)
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.io.sources import SyntheticImageSource
    from triton_client_tpu_torch.ops import cuda_build, gpu_decode, gpu_nms, kernel_cases
    from triton_client_tpu_torch.ops import nms as tnms
    from triton_client_tpu_torch.ops.boxes import xywh2xyxy
    from triton_client_tpu_torch.ops.detect_postprocess import extract_boxes, topk_candidates
    from triton_client_tpu_torch.ops.nms import class_offset_boxes
    from triton_client_tpu_torch.ops.preprocess import normalize_image, resize_bilinear
    from triton_client_tpu_torch.pipelines.detect2d import (
        Detect2DConfig,
        build_yolov5_pipeline,
        load_class_names,
    )
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    dev = torch.device("cuda")

    # -- 1. card ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = smi
    build_s = cuda_build.build_all()
    emit("card", card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), build_s=build_s)

    # -- 2. kernels against their plain versions, on the card -------------------
    def to_dev(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    decode_cases = [
        (kind, seed, fmt, agnostic)
        for kind in kernel_cases.KINDS
        for seed, fmt, agnostic in ((0, "xywh", False), (1, "xyxy", True))
    ] + [("random", 2, "xywh", True), ("ties", 3, "xyxy", False)]
    k1_err = 0.0
    for kind, seed, fmt, agnostic in decode_cases:
        args = to_dev(kernel_cases.batch(kind, B_MAIN, K_MAIN, NC, seed, fmt))
        kw = dict(iou_thresh=0.45, max_det=MAX_DET, box_format=fmt, class_agnostic=agnostic)
        rows, keep = gpu_decode.fused_decode_nms_2d(*args, **kw)
        want_rows, want_keep = gpu_decode.decode_nms_2d_reference(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(keep, want_keep), f"decode_nms_2d keep differs ({kind}, {fmt})")
        check(torch.equal(rows, want_rows), f"decode_nms_2d rows differ ({kind}, {fmt})")
        k1_err = max(k1_err, float((rows - want_rows).abs().max()))
    k2_err = 0
    for kind in kernel_cases.KINDS:
        parts = [kernel_cases.nms_inputs(kind, K_MAIN, seed=40 + i) for i in range(B_MAIN)]
        boxes, scores = to_dev([np.stack([p[0] for p in parts]), np.stack([p[1] for p in parts])])
        idx, valid = gpu_nms.nms_greedy(boxes, scores, 0.45, MAX_DET)
        want_idx, want_valid = gpu_nms.nms_greedy_reference(boxes, scores, 0.45, MAX_DET)
        torch.cuda.synchronize()
        check(torch.equal(valid, want_valid), f"greedy_nms valid differs ({kind})")
        check(torch.equal(idx, want_idx), f"greedy_nms indices differ ({kind})")
        k2_err = max(k2_err, int((idx - want_idx).abs().max()))
    # the pallas route past a block's shared memory raises, launching nothing
    n_big = 10000
    check(not gpu_nms.smem_fits(n_big), f"{n_big} candidates fit shared memory")
    os.environ["TRITON_CLIENT_TPU_NMS"] = "pallas"
    before = gpu_nms.launches.count
    try:
        tnms.nms(torch.zeros((1, n_big, 4), device=dev), torch.zeros((1, n_big), device=dev))
        raised = False
    except ValueError:
        raised = True
    del os.environ["TRITON_CLIENT_TPU_NMS"]
    check(raised and gpu_nms.launches.count == before,
          "TRITON_CLIENT_TPU_NMS=pallas past shared memory did not raise on the card")
    emit("kernels_vs_plain", card, kernels=[
        {"name": "decode_nms_2d", "cases": len(decode_cases), "shape": [B_MAIN, K_MAIN, MAX_DET],
         "match": True, "max_abs_err": k1_err},
        {"name": "greedy_nms", "cases": len(kernel_cases.KINDS), "shape": [B_MAIN, K_MAIN, MAX_DET],
         "match": True, "max_abs_err": k2_err},
    ])

    # -- 3. the main path --------------------------------------------------------
    names = load_class_names(str(ROOT / "data" / "crop.names"))
    check(len(names) == NC, f"data/crop.names holds {len(names)} classes")
    base = Detect2DConfig(
        model_name="yolov5n", input_hw=(512, 512), num_classes=NC, conf_thresh=0.3,
        iou_thresh=0.45, max_det=MAX_DET, max_nms=K_MAIN, class_names=names,
    )
    variants = {
        "yolov5n": base,
        "yolov5n_c005": dataclasses.replace(base, model_name="yolov5n_c005", conf_thresh=0.05),
        "yolov5n_unfused": dataclasses.replace(base, model_name="yolov5n_unfused", fused="off"),
        "yolov5n_c005_unfused": dataclasses.replace(
            base, model_name="yolov5n_c005_unfused", conf_thresh=0.05, fused="off"
        ),
    }
    repo = ModelRepository()
    pipes = {}
    for name, cfg in variants.items():
        # one seed: every variant holds the same weights
        pipe, spec, model = build_yolov5_pipeline(
            variant="n", num_classes=NC, input_hw=(512, 512), config=cfg, device="cuda", seed=0
        )
        repo.register(spec, pipe.infer_fn())
        pipes[name] = (pipe, spec, model)
    check(pipes["yolov5n"][1].extra["fused_stages"] == ["decode_nms"], "auto did not fuse on CUDA")
    check(pipes["yolov5n_unfused"][1].extra["fused_stages"] == [], "off still fused")
    channel = CUDAChannel(repo)
    channel.register_channel()

    frames = np.stack([f.data for f in SyntheticImageSource(40, (480, 640), seed=0)])
    b1 = [frames[i:i + 1] for i in range(4)]
    b8 = [frames[8 + 8 * i: 16 + 8 * i] for i in range(4)]

    def ask(model_name, batch):
        return channel.do_inference(InferRequest(model_name, {"images": batch})).outputs

    for name in variants:  # warm-up (cuDNN picks its algorithms), not counted
        ask(name, b1[0])
        ask(name, b8[0])
    os.environ["TRITON_CLIENT_TPU_NMS"] = "pallas"  # the unfused route's kernel
    gpu_decode.launches.reset()
    gpu_nms.launches.reset()
    out = {}
    for i, batch in enumerate(b1 + b8):
        out[("yolov5n", i)] = ask("yolov5n", batch)
    out["c005"] = ask("yolov5n_c005", b8[0])
    out["unfused"] = ask("yolov5n_unfused", b8[0])
    out["c005_unfused"] = ask("yolov5n_c005_unfused", b8[0])
    launches = {"decode_nms_2d": gpu_decode.launches.count, "greedy_nms": gpu_nms.launches.count}
    del os.environ["TRITON_CLIENT_TPU_NMS"]

    for i, batch in enumerate(b1 + b8):
        o = out[("yolov5n", i)]
        n = batch.shape[0]
        check(o["detections"].shape == (n, MAX_DET, 6), f"detections {o['detections'].shape}")
        check(o["valid"].shape == (n, MAX_DET) and o["valid"].dtype == np.bool_, "valid")
        check(bool(np.isfinite(o["detections"]).all()), "non-finite detections")
    check(launches["decode_nms_2d"] == len(b1) + len(b8) + 1,
          f"decode_nms_2d launched {launches['decode_nms_2d']} times for {len(b1) + len(b8) + 1} fused requests")
    check(launches["greedy_nms"] == 2, f"greedy_nms launched {launches['greedy_nms']} times, want 2")
    n_c005 = int(out["c005"]["valid"].sum())
    check(n_c005 > 100, f"conf 0.05 kept only {n_c005} boxes")
    for fused, unfused in (("c005", "c005_unfused"), (("yolov5n", 4), "unfused")):
        check(np.array_equal(out[fused]["valid"], out[unfused]["valid"]), f"{unfused}: valid differs")
        check(np.array_equal(out[fused]["detections"], out[unfused]["detections"]),
              f"{unfused}: rows differ from the fused route")
    emit("main_path", card, model="yolov5n", input_hw=[512, 512], frame_hw=[480, 640],
         requests={"batch1": len(b1), "batch8": len(b8), "batch8_conf0.05": 1,
                   "unfused_batch8": 2},
         detections={"conf0.3": int(sum(out[("yolov5n", i)]["valid"].sum() for i in range(8))),
                     "conf0.05_batch8": n_c005},
         fused_equals_unfused=True, launches=launches)

    # -- 4. checks against the plain tail and the CPU path ------------------------
    _, _, model = pipes["yolov5n_c005"]
    with torch.no_grad():
        x = torch.from_numpy(b8[0]).to(dev).float()
        pred = model.decode(model(normalize_image(resize_bilinear(x, (512, 512)))))
    cls_conf = pred[..., 5:] * pred[..., 4:5]
    cands = topk_candidates(pred[..., :4], cls_conf.amax(-1), cls_conf.argmax(-1), 0.05, K_MAIN)
    n_valid = int(cands[3].sum())
    check(n_valid == B_MAIN * K_MAIN, f"conf 0.05 fills {n_valid} of {B_MAIN * K_MAIN} slots")
    kw1 = dict(iou_thresh=0.45, max_det=MAX_DET, box_format="xywh")
    rows, keep = gpu_decode.fused_decode_nms_2d(*cands, **kw1)
    want_rows, want_keep = gpu_decode.decode_nms_2d_reference(*cands, **kw1)
    check(torch.equal(rows, want_rows) and torch.equal(keep, want_keep),
          "kernel differs from the plain tail on the main path's predictions")
    cpu_rows, cpu_keep = extract_boxes(pred.cpu(), 0.05, 0.45, MAX_DET, K_MAIN, fused=True)
    check(torch.equal(rows.cpu(), cpu_rows) and torch.equal(keep.cpu(), cpu_keep),
          "kernel differs from the plain tail on the CPU")
    # small input, card against the CPU path (same seed, same weights):
    # equal detection count, top rows within the golden-test bar 1e-2
    small = Detect2DConfig(num_classes=NC, input_hw=(128, 128), conf_thresh=0.05, max_det=100)
    gpu_pipe, _, _ = build_yolov5_pipeline(num_classes=NC, input_hw=(128, 128), config=small,
                                           device="cuda", seed=0)
    cpu_pipe, _, _ = build_yolov5_pipeline(num_classes=NC, input_hw=(128, 128), config=small,
                                           device="cpu", seed=0)
    sframes = np.random.default_rng(4).integers(0, 255, (2, 96, 128, 3), dtype=np.uint8)
    g_dets, g_valid = gpu_pipe.infer(sframes)
    c_dets, c_valid = cpu_pipe.infer(sframes)
    check(np.array_equal(g_valid.sum(1), c_valid.sum(1)), "card and CPU keep different counts")
    top_err = float(np.abs(g_dets[:, :5] - c_dets[:, :5]).max())
    check(np.allclose(g_dets[:, :5], c_dets[:, :5], rtol=1e-2, atol=1e-2),
          f"card and CPU top rows differ by {top_err}")
    emit("check", card, kernel_equals_plain_on_main_path=True, candidates=n_valid,
         kept=int(keep.sum()), cpu_vs_card_detections=int(g_valid.sum()),
         cpu_vs_card_top5_max_abs_err=top_err)

    # -- 5. times on the card's clock ---------------------------------------------
    offset = class_offset_boxes(xywh2xyxy(cands[0]), cands[2])
    masked = torch.where(cands[3], cands[1], float("-inf"))
    k1_ms = cuda_ms(lambda: gpu_decode.fused_decode_nms_2d(*cands, **kw1), reps=200)
    k1_plain_ms = cuda_ms(lambda: gpu_decode.decode_nms_2d_reference(*cands, **kw1), reps=5, warmup=1)
    k2_ms = cuda_ms(lambda: gpu_nms.nms_greedy(offset, masked, 0.45, MAX_DET), reps=200)
    k2_plain_ms = cuda_ms(lambda: gpu_nms.nms_greedy_reference(offset, masked, 0.45, MAX_DET),
                          reps=5, warmup=1)
    iou_tests = live_counts(offset, masked, torch.tensor(0.45, device=dev), MAX_DET)
    k1_bytes = B_MAIN * K_MAIN * (16 + 4 + 4 + 1) + B_MAIN * MAX_DET * (24 + 1)
    k2_bytes = B_MAIN * K_MAIN * (16 + 4) + B_MAIN * MAX_DET * (4 + 1)
    ops = iou_tests * IOU_OPS

    def bound(nbytes):
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_FP32_FLOPS * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    k1_bound, k1_by = bound(k1_bytes)
    k2_bound, k2_by = bound(k2_bytes)

    def serve(batches, reps):
        lat = []
        t0 = time.perf_counter()
        for r in range(reps):
            t = time.perf_counter()
            ask("yolov5n", batches[r % len(batches)])
            lat.append(time.perf_counter() - t)
        wall = time.perf_counter() - t0
        n = sum(batches[r % len(batches)].shape[0] for r in range(reps))
        return {"frames_per_s": n / wall, "p50_ms": float(np.median(lat)) * 1e3, "requests": reps}

    e2e = {"batch1": serve(b1, 40), "batch8": serve(b8, 20)}
    emit("times", card, kernel_ms={"decode_nms_2d": k1_ms, "greedy_nms": k2_ms},
         plain_ms={"decode_nms_2d": k1_plain_ms, "greedy_nms": k2_plain_ms},
         iou_tests=iou_tests, in_process=e2e)

    # -- 6. where a request's time goes (the wall includes the profiler's cost) ---
    for batch in (b1[0], b8[0]):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_REQUESTS):
                ask("yolov5n", batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        device_ops = [e for e in prof.events() if e.device_type.name == "CUDA"]
        check(len(device_ops) > 0, "torch.profiler saw no device op")
        device_s = sum(e.device_time_total for e in device_ops) / 1e6
        by_name: dict[str, float] = {}
        for e in prof.key_averages():
            if e.device_type.name == "CUDA":  # names cut to 80 characters can collide: sum them
                key = e.key[:80]
                by_name[key] = by_name.get(key, 0.0) + e.self_device_time_total / PROFILE_REQUESTS / 1e3
        top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:PROFILE_TOP]
        emit("profile", card, batch=batch.shape[0], requests=PROFILE_REQUESTS,
             wall_ms_per_request=wall / PROFILE_REQUESTS * 1e3,
             device_ms_per_request=device_s / PROFILE_REQUESTS * 1e3,
             device_busy_share=device_s / wall, device_idle_share=1.0 - device_s / wall,
             device_ops_per_request=len(device_ops) / PROFILE_REQUESTS,
             top_device_ops_ms_per_request=dict(top))

    record = [
        {"name": "decode_nms_2d", "route": "cuda",
         "source": "triton_client_tpu_torch/csrc/decode_nms_2d.cu",
         "replaces": "triton_client_tpu/ops/pallas_decode.py:155",
         "launches": launches["decode_nms_2d"], "max_abs_err": k1_err, "match": True,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None, "card": card},
        {"name": "greedy_nms", "route": "cuda",
         "source": "triton_client_tpu_torch/csrc/greedy_nms.cu",
         "replaces": "triton_client_tpu/ops/pallas_nms.py:111",
         "launches": launches["greedy_nms"], "max_abs_err": k2_err, "match": True,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None, "card": card},
    ]
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
