#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``triton_client_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``triton_client_tpu_torch/
csrc/`` and drives the port's four main paths, each served in-process
through ``ModelRepository`` and ``CUDAChannel`` (each pipeline captured as
CUDA graphs at registration) with random weights from a seed: YOLOv5n at 512x512 (the settings of ``examples/yolov5_crop_base``),
PointPillars at the full KITTI width (``examples/pointpillar_kitti``),
SECOND-IoU with the dense middle at the full KITTI width
(``examples/second_iou``, the 352 x 400 x 10 grid), and the continuous
batcher in front of the channel: packed ragged batches of KITTI-sized
clouds through the pool model (``models/pool.py``), and YOLOv5n through its
dense merged path; then the KServe v2 façade over a disk repository of the
same three entries. One JSON line per phase:

  1. card      — the card's name and power limit, the kernels' build time
  2. kernels   — each kernel against its plain PyTorch version on the card,
                 at the main path's shapes, over edge-case candidate sets
                 (live NaN scores included), in and out of score order (the
                 two branches of kernels 1 and 2's order passes, read back
                 from their workspaces and counted), and up to the largest
                 K the wrappers take (kernel 2 also at the reference's
                 16,128-box YOLO head): bitwise equal or the script fails
  3. main_path — requests at batch 1 and 8 through the channel, fused and
                 unfused routes; launch counts read around this phase only
  4. check     — the card's output against the plain tail and the CPU path
  5. times     — each kernel's device time (CUDA events around launches
                 queued behind a sleep kernel), its wrapper's call time
                 and its plain version's (CUDA events), frames/s
                 and p50 latency at batch 1 and 8, and of the unfused
                 conf-0.05 route at batch 8 with and without
                 TRITON_CLIENT_TPU_NMS=pallas; on the lines before it,
                 kernels 1 and 2's time by pass (torch.profiler) and the
                 bytes of the workspace a call allocated
  6. profile   — where a request's time goes, under torch.profiler: device
                 ms and busy share per request, device ops per request,
                 the device ops that took the most time, at batch 1 and 8
  7. kernels_vs_plain_3d — the 3D decode and suppress+pack kernels against
                 their plain versions at B = 1, K = 256, max_det 128, over
                 edge cases (ops/kernel_cases.py; the decode in both forms,
                 the gathered one reading 256 of the KITTI head's 321,408
                 anchors, with tied and NaN direction logits), sorted and
                 shuffled (the order path read back as in phase 2), and
                 kernel 4 up to the largest K the wrapper takes
  8. main_path_3d — scans of 20,000 and 120,000 points through the channel,
                 fused and unfused routes; launch counts read around this
                 phase only (kernel 3 in its gathered form on every fused
                 request)
  9. check_3d  — the kernels on the main path's own candidates (kernel 3
                 in both forms, on the head and top-k indices), the card
                 against the CPU path at a tiny grid, the cells of NaN,
                 +-inf, +-1e10 and +-2^31 coordinates on the card against
                 the CPU, and a NaN point keeping no detection on either
 10. times_3d  — the 3D kernels' and plain versions' times (kernel 3 in
                 both forms), scans/s and p50 latency at 20k and 120k
                 points; on the line before it, kernel 4's time by pass and
                 its workspace
 11. profile_3d — phase 6 for a 120k-point scan, and the fused route's
                 stage from the top-k indices to the boxes as it runs (one
                 gathered launch) and as it ran (four gathers, then the
                 kernel): device ops, device ms and host ms a call
 12. kernels_vs_plain_second — the sorted-segment mean against its plain
                 version, bitwise, at N = 131,072 rows and 40,000 slots over
                 edge cases (ops/kernel_cases.py SEGMENT_KINDS)
 13. main_path_second — 20,000- and 120,000-point scans through the channel,
                 fused (voxel stage + 3D tail) and unfused routes; launch
                 counts read around this phase only; occupied and kept cells
 14. check_second — the three kernels on the main path's own inputs (kernel
                 3 in both forms), and the
                 card against the CPU path at a tiny grid
 15. times_second — the segment mean's times, bound and library yardstick,
                 scans/s and p50 latency at 20k and 120k points; on the
                 line before it, its two launches' times (zero, walk)
 16. profile_second — phase 6 for a 120k-point SECOND scan
 17. kernels_vs_plain_ragged — the segment sum (kernel 6) against its plain
                 version, bitwise, over edge cases (ops/kernel_cases.py
                 SEGSUM_CASES: sorted layout ids with the pad id, unsorted,
                 out-of-range, empty segments, one segment; F up to 130, S up
                 to 64, R from 1 to 560,000), and segment_reduce's four ops
                 on the card against the same call on CPU copies
 18. main_path_ragged — 8 seeded KITTI-sized clouds (20,000-120,000 points)
                 through ContinuousBatchingChannel(CUDAChannel(repo)) as one
                 packed group and as a threaded burst of 8 callers; launch
                 counts read around this phase only, the ragged_* stats, the
                 pool model's solo infer_fn calls (0 in the packed group: no
                 silent fallback)
 19. check_ragged — kernel 6 on the main path's own packed rows, each
                 member against a float64 sum, packed and solo, and the card
                 against the CPU port on the same group
 20. times_ragged — kernel 6's times, its one launch's profiler time,
                 bound and index_add_ yardstick; clouds/s and p50 through
                 the batcher beside solo requests
 21. dense_batched_2d — YOLOv5n 512^2 frames through the same scheduler's
                 dense merged path: a group of 8 one-frame requests equals one
                 direct call on the 8 frames stacked, bit for bit
 22. graphs    — each served path as the CUDA graph its pipeline captured
                 at registration (runtime/graphs, the port's jax.jit):
                 YOLOv5n (conf 0.05) at batch 1 and 8, fused, unfused (the
                 fixpoint NMS, a loop the capture cuts in three graphs) and
                 unfused under TRITON_CLIENT_TPU_NMS=pallas, PointPillars and
                 SECOND-IoU fused and unfused at 20k and 120k points. The
                 captured call is bitwise equal to the eager body; each
                 kernel's launches through 5 replays are 5 times one eager
                 call's; a replay on a second input gives that input's
                 result; two requests in flight at pipeline_depth 2, resolved
                 in reverse order, each get their own; no request captures
                 after the registration warmup. Captures, keys and pool bytes
                 per model
 23. times_graphs — the same paths through CUDAChannel, the eager body
                 (registered as the model's infer_fn) against the captured
                 one on the same requests, eager / captured / eager /
                 captured: p50 and frames/s or scans/s; at YOLOv5n batch 1 and
                 PointPillars 120k also the device ops the host issued a
                 request (torch.profiler: cudaGraphLaunch and the copies
                 around it, or every kernel launch) and the busy share
 24. driver    — InferenceDriver over CUDAChannel: 64 seeded 512^2 frames
                 (YOLOv5n conf 0.05) sync, with 2 futures in flight and at
                 batch 8, and 16 seeded clouds (PointPillars) sync and with 2
                 in flight: frames/s and p50 each, the async results bitwise
                 equal to the sync ones frame by frame, batch 8 within 1e-5
                 of batch 1 on every live row
 25. facade    — the KServe v2 façade over a disk repository: scan_disk of
                 copies of examples/yolov5_crop_base, pointpillar_kitti and
                 second_iou (config.yaml only; data/ read from the checkout
                 with yaml_subset) and of the YOLOv5n entry at conf 0.05,
                 served by CUDAChannel with each entry's graphs captured at
                 registration; the server's _Servicer answers every RPC
                 in-process on request bytes (service.invoke): health,
                 metadata, ModelConfig, RepositoryIndex; ModelInfer for
                 YOLOv5n at batch 1 and 8 and both 3D entries at 20k and
                 120k points, each output bitwise equal to
                 CUDAChannel.do_inference; ModelStreamInfer of 8 requests at
                 depth 2, in order, each its own request's result; NOT_FOUND
                 and INVALID_ARGUMENT; kernels 1, 3, 4 and 5 launched once a
                 fused request inside the phase. p50 and frames/s or scans/s
                 through the servicer against the direct channel (YOLOv5n b1,
                 PointPillars 120k) and the servicer's own host ms a request.
                 Where grpc imports, InferenceServer on a loopback port
                 repeats the ModelInfer checks through the port's GRPCChannel
                 ("grpc": true; otherwise "grpc": false and no socket leg)

then the ``{"kernels": [...]}`` record and, last, the ``{"ok": true, ...}``
line. Any failed check exits nonzero; nothing is caught or falls back.
It imports nothing of JAX. Without a CUDA device it exits 2 and prints
no result.
"""

from __future__ import annotations

import dataclasses
import functools
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
# the 3D path: PointPillars' pre_max candidates, max_det rows of 9 columns;
# the anchors of its KITTI head (216 x 248 cells x 6), which kernel 3's
# gathered form reads through the top-k indices
K_3D, MAX_DET_3D, COLS_3D = 256, 128, 9
N_ANCHORS_3D = 321408
SCAN_POINTS = (20000, 120000)  # the source's default; a full HDL-64 scan
SERVE_REQUESTS_3D = 30
# the largest K kernels 1, 2 and 4 take: their order pass's sort of 16,384
# (score, index) keys fills a block's shared memory
K_LARGEST = 16384
# the boxes of a YOLO head at 512 x 512 before any top-k: 3 anchors on
# 64^2 + 32^2 + 16^2 cells (the reference's 16,128-box heads)
K_YOLO_HEAD = 16128
# float operations of kernel 3 per candidate: diag 4, centres 6, sizes
# 3 x (2 clamp, exp, mul), heading 9
DECODE_OPS = 31
# fp32 non-tensor-core rate and memory rate of an H100 SXM at 700 W
# (NVIDIA H100 data sheet)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# float operations of one IoU test against the chosen box in the
# greedy loop: 2 min, 2 max, 2 sub, 2 clamp, 1 mul, 1 add, 1 sub,
# 1 max, 1 div, 1 compare
IOU_OPS = 14
# SECOND's voxel stage: the KITTI cap of occupied cells; the scan size at
# which the card is compared with the CPU below the cap
SECOND_SLOTS = 40000
# the ragged path: 8 clouds a pack, each 20k (the synthetic source's
# default) to 120k points (a full HDL-64 scan); bursts timed in phase 20
RAGGED_CLOUDS, RAGGED_POINTS, RAGGED_ROUNDS = 8, (20000, 120000), 5
# the 2D main path's camera frames
FRAME_HW = (480, 640)
# phases 22-24: replays a launch count is read over; requests a timed path;
# the driver's frames and clouds
GRAPH_REPLAYS, GRAPH_REQUESTS_2D, GRAPH_REQUESTS_3D = 5, 30, 20
DRIVER_FRAMES, DRIVER_CLOUDS = 64, 16
# the CUDA runtime calls by which the host issues device work: each is
# one host-issued device op of a request (phase 23)
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
               "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
# what the main paths serve, for phases 22-24: model -> pipelines, inputs,
# repository and channel
SERVED: dict = {}


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


def kernel_device_ms(fn, counter, reps: int = 50) -> float:
    """Mean device time of one launch by ``fn``, which must launch its
    kernel and nothing else (inputs already of the kernel's types): CUDA
    events around ``reps`` back-to-back calls queued behind a sleep
    kernel, so the card runs them without waiting on the host in between
    (its wrapper's host time, tens of microseconds, would otherwise be
    measured for a kernel of microseconds). Fails unless all ``reps``
    launches were queued before the card reached the first event."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24  # about 9 ms at 1.98 GHz
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        before = counter.count
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        check(counter.count - before == reps, f"{reps} calls launched {counter.count - before} times")
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    fail(f"the card reached the first event before {reps} launches were queued")


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bit patterns, so that a comparison sees -0.0."""
    return t.contiguous().view(torch.int32)


def roofline(nbytes: int, ops: int) -> tuple[float, str]:
    """The least ms the card could take: the larger of ``nbytes`` over the
    memory rate and ``ops`` over the fp32 rate, and which of the two."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def serve(call, inputs, reps: int, unit: str = "scans_per_s", size=lambda x: 1) -> dict:
    """``reps`` closed-loop calls of ``call``, one caller, cycling over
    ``inputs``: ``unit`` (the inputs' ``size`` summed, over the wall) and
    p50 latency, on the host's clock."""
    lat = []
    t0 = time.perf_counter()
    for r in range(reps):
        t = time.perf_counter()
        call(inputs[r % len(inputs)])
        lat.append(time.perf_counter() - t)
    wall = time.perf_counter() - t0
    n = sum(size(inputs[r % len(inputs)]) for r in range(reps))
    return {unit: n / wall, "p50_ms": float(np.median(lat)) * 1e3, "requests": reps}


def uniform_clouds(seed: int, pc_range, points: int, count: int = 2) -> list[np.ndarray]:
    """``count`` (points, 4) float32 clouds drawn uniformly over ``pc_range``."""
    rng = np.random.default_rng(seed)
    r = pc_range
    return [
        np.column_stack([rng.uniform(r[0], r[3], points), rng.uniform(r[1], r[4], points),
                         rng.uniform(r[2], r[5], points), rng.uniform(0, 1, points)]
                        ).astype(np.float32)
        for _ in range(count)
    ]


def card_vs_cpu(card_pipe, cpu_pipe, clouds) -> tuple[float, int]:
    """The same clouds through a 3D pipeline on the card and its twin on
    the CPU (same seed, same weights): equal kept counts and labels, rows
    within 1e-5, the bar at which the CPU tests hold the port to the JAX
    package. Returns the largest row difference and the rows kept."""
    err_max, kept = 0.0, 0
    for pc in clouds:
        g, c = card_pipe.infer(pc), cpu_pipe.infer(pc)
        check(len(g["pred_scores"]) == len(c["pred_scores"]) > 0, "card and CPU keep other counts")
        check(np.array_equal(g["pred_labels"], c["pred_labels"]), "card and CPU labels differ")
        err = max(float(np.abs(g[k] - c[k]).max()) for k in ("pred_boxes", "pred_scores"))
        check(err <= 1e-5, f"card and CPU rows differ by {err}")
        err_max, kept = max(err_max, err), kept + len(g["pred_scores"])
    return err_max, kept


def nan_cells_card_vs_cpu(dev: torch.device) -> dict:
    """Cell assignment of NaN, +-inf, +-1e10 and +-2^31 coordinates on the
    card against the CPU, at the KITTI PointPillars grid: equal cells and
    valid rows, the NaN x row in cell x = 0 and kept (XLA's cast rule,
    ``ops/voxelize.xla_f32_to_i32``). Returns what was compared."""
    from triton_client_tpu_torch.ops import kernel_cases
    from triton_client_tpu_torch.ops.voxelize import VoxelConfig, assign_cells, xla_f32_to_i32

    pts = kernel_cases.special_cloud(200, VoxelConfig().point_cloud_range, seed=3)
    x = torch.from_numpy(np.concatenate([kernel_cases.SPECIAL_COORDS, pts[:, :3].ravel()]))
    check(torch.equal(xla_f32_to_i32(x.to(dev)).cpu(), xla_f32_to_i32(x)),
          "the card's float -> int32 cast differs from the CPU's")
    p, n = torch.from_numpy(pts), torch.tensor(190)
    ijk, valid = assign_cells(p.to(dev), n.to(dev), VoxelConfig())
    want_ijk, want_valid = assign_cells(p, n, VoxelConfig())
    check(torch.equal(ijk.cpu(), want_ijk) and torch.equal(valid.cpu(), want_valid),
          "the card's cells of special coordinates differ from the CPU's")
    check(int(want_ijk[0, 0]) == 0 and bool(want_valid[0]), "a NaN x did not land in cell 0")
    # whether PyTorch's own CUDA cast already follows the rule (reported)
    plain_cast = torch.equal(x.to(dev).to(torch.int32).cpu(), xla_f32_to_i32(x))
    return {"values": int(x.numel()), "points": int(pts.shape[0]), "equal": True,
            "torch_cast_on_card_follows_xla": plain_cast}


def device_profile(run, requests: int) -> dict:
    """Where a request's time goes: ``run`` called ``requests`` times under
    torch.profiler (the wall includes the profiler's cost). Device ms and
    busy share per request, device ops per request, the device ops that
    took the most time."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(requests):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_ops = [e for e in prof.events() if e.device_type.name == "CUDA"]
    check(len(device_ops) > 0, "torch.profiler saw no device op")
    device_s = sum(e.device_time_total for e in device_ops) / 1e6
    by_name: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":  # names cut to 80 characters can collide: sum them
            key = e.key[:80]
            by_name[key] = by_name.get(key, 0.0) + e.self_device_time_total / requests / 1e3
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:PROFILE_TOP]
    return dict(requests=requests, wall_ms_per_request=wall / requests * 1e3,
                device_ms_per_request=device_s / requests * 1e3,
                device_busy_share=device_s / wall, device_idle_share=1.0 - device_s / wall,
                device_ops_per_request=len(device_ops) / requests,
                top_device_ops_ms_per_request=dict(top))


def pass_split(fn, kernel: str, passes=("order", "mask", "scan"), reps: int = 20,
               sessions: int = 3) -> dict:
    """Each pass (launch) of a kernel, named ``<kernel>_<pass>``: its mean
    device µs over the records torch.profiler kept of ``reps`` calls of
    ``fn``, and how many it kept (it has dropped records of µs-long
    kernels, and once every record of a session). Fails unless one of
    ``sessions`` profiler sessions saw every pass by its name; returns that
    session's numbers and how many sessions it took."""
    fn()
    torch.cuda.synchronize()
    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, seen = {}, {}
        for e in prof.key_averages():
            for name in passes:
                if e.device_type.name == "CUDA" and f"{kernel}_{name}" in e.key:
                    us[name] = e.self_device_time_total / e.count
                    seen[name] = e.count
        if set(us) == set(passes):
            return {"us": us, "records_seen": seen, "calls": reps, "sessions": session}
    fail(f"{kernel}: in {sessions} profiler sessions the last saw passes {sorted(us)}")


def with_workspace(run):
    """``run()``, which makes one call of a mask-scan kernel's wrapper
    (kernels 1 and 4), then the workspace buffer that call allocated and
    its arrays' sizes, for reading back what the kernel wrote there."""
    from triton_client_tpu_torch.ops import mask_scan

    seen, allocate = [], mask_scan.workspace

    def record(device, sizes):
        ws, ptrs = allocate(device, sizes)
        seen.append((ws, sizes))
        return ws, ptrs

    mask_scan.workspace = record
    try:
        out = run()
    finally:
        mask_scan.workspace = allocate
    torch.cuda.synchronize()
    check(len(seen) == 1, f"one kernel call allocated {len(seen)} workspaces")
    return out, *seen[0]


def count_order_paths(ws, sizes, live, paths: dict, label: str) -> None:
    """Reads back which order the order pass took for each image (its own,
    or a sort), holds it to what the live scores call for (their own when
    already in visiting order or with a live NaN) and adds the images to
    ``paths``."""
    from triton_client_tpu_torch.ops import mask_scan

    took = mask_scan.took_own_order(ws, sizes).cpu()
    want = (mask_scan.in_visiting_order(live) | torch.isnan(live).any(1)).cpu()
    check(torch.equal(took, want),
          f"{label}: the order pass took its own order {took.tolist()}, not {want.tolist()}")
    paths["input_order"] += int(took.sum())
    paths["sorted"] += int((~took).sum())


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


def live_counts_3d(iou, live, thresh, max_det):
    """Kernel 4's loop on the card in plain PyTorch, counting what this
    run's data needs: the live candidates tested at each step (summed
    over the batch) and the steps that kept a candidate (each reads one
    IoU row)."""
    lane = torch.arange(live.shape[1], device=live.device)
    image = torch.arange(live.shape[0], device=live.device)
    tests = kept = 0
    for _ in range(max_det):
        alive = live > float("-inf")
        n = int(alive.sum())
        if n == 0:
            break
        tests += n
        kept += int(alive.any(1).sum())
        best = live.argmax(1)
        suppress = (iou[image, best] > thresh) | (lane == best[:, None])
        live = torch.where(suppress, float("-inf"), live)
    return tests, kept


def candidate_stage(model, heads, top_idx, reps: int = 200) -> dict:
    """The fused 3D route from the top-k's output to the decoded boxes, as
    it runs (kernel 3 reading its rows through ``top_idx``) and as it ran
    (the gathers of ``topk_candidates``, then kernel 3 on their rows): the
    device ops of one call (torch.profiler, 20 calls), the stage's device
    ms (``kernel_device_ms``: every op of ``reps`` calls queued behind a
    sleep kernel) and its host ms a call (perf_counter over ``reps`` calls
    issued without a wait). torch.profiler may drop records of µs-long
    kernels (phase 10), so a count below the true one is possible, never
    one above it."""
    from triton_client_tpu_torch.models.pointpillars import gather_candidates
    from triton_client_tpu_torch.ops import gpu_decode3d
    from triton_client_tpu_torch.pipelines.detect3d import gathered_decode_args

    args = gathered_decode_args(model, heads, top_idx)
    sel = {"top_idx": top_idx, "scores": None, "labels": None}

    def gathers_then_kernel():
        cand = gather_candidates(heads, model.anchors, sel)
        return gpu_decode3d.fused_residual_decode(cand["deltas"], cand["anchors"],
                                                  cand["dir_bin"], *args[4:])

    def gathered():
        return gpu_decode3d.gather_residual_decode(*args)

    # both stages in one profiler session: every device op that is not the
    # gathered kernel belongs to the gathers-then-kernel stage
    gathered()
    gathers_then_kernel()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            gathered()
            gathers_then_kernel()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    ops = {"gathered_kernel": [n for n in names if "residual_decode_3d_kernel<true>" in n]}
    ops["gathers_then_kernel"] = [n for n in names if "residual_decode_3d_kernel<true>" not in n]
    out = {}
    for name, fn in (("gathered_kernel", gathered), ("gathers_then_kernel", gathers_then_kernel)):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        out[name] = {"device_ops_per_call": len(ops[name]) / 20,
                     "ops": sorted(set(n[:60] for n in ops[name])),
                     "device_ms": kernel_device_ms(fn, gpu_decode3d.launches, reps=50),
                     "host_ms": host_ms}
    check(torch.equal(bits(gpu_decode3d.gather_residual_decode(*args)),
                      bits(gathers_then_kernel())), "the two stages' boxes differ")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.io.sources import SyntheticImageSource
    from triton_client_tpu_torch.ops import (
        cuda_build,
        gpu_decode,
        gpu_decode3d,
        gpu_nms,
        gpu_suppress3d,
        gpu_voxel,
        kernel_cases,
        mask_scan,
    )
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
    from triton_client_tpu_torch.ops import gpu_segment

    # each kernel's launches, then kernel 3's in its gathered form (also
    # counted in gpu_decode3d.launches)
    counters = (gpu_decode.launches, gpu_nms.launches, gpu_decode3d.launches,
                gpu_suppress3d.launches, gpu_voxel.launches, gpu_segment.launches,
                gpu_decode3d.gathered_launches)

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

    # every kind as drawn (not in score order: the order pass sorts) and as
    # topk_candidates hands candidates over (in order: taken as it stands),
    # then K past one group of 32 mask words, up to the largest K taken
    decode_cases = [
        (kind, seed, fmt, agnostic, K_MAIN, MAX_DET, sort)
        for kind in kernel_cases.KINDS
        for seed, fmt, agnostic in ((0, "xywh", False), (1, "xyxy", True))
        for sort in (False, True)
    ] + [("random", 2, "xywh", True, K_MAIN, MAX_DET, False),
         ("ties", 3, "xyxy", False, K_MAIN, MAX_DET, False)] + [
        ("random", 4, "xywh", False, k, max_det, sort)
        for k, max_det in ((1025, 1025), (K_LARGEST, MAX_DET), (K_LARGEST, K_LARGEST))
        for sort in (False, True)
    ]
    check(gpu_decode.smem_fits(K_LARGEST) and not gpu_decode.smem_fits(K_LARGEST + 1),
          f"decode_nms_2d does not take K up to {K_LARGEST} exactly")
    k1_err = 0.0
    k1_order_paths = {"input_order": 0, "sorted": 0}
    for kind, seed, fmt, agnostic, k, max_det, sort in decode_cases:
        arrays = kernel_cases.batch(kind, B_MAIN, k, NC, seed, fmt)
        if sort:
            arrays = kernel_cases.score_sorted(*arrays)
        args = to_dev(arrays)
        kw = dict(iou_thresh=0.45, max_det=max_det, box_format=fmt, class_agnostic=agnostic)
        label = f"{kind}, K {k}, max_det {max_det}, {fmt}, sorted {sort}"
        (rows, keep), ws, sizes = with_workspace(
            lambda: gpu_decode.fused_decode_nms_2d(*args, **kw))
        live = torch.where(args[3], args[1], float("-inf"))
        count_order_paths(ws, sizes, live, k1_order_paths, f"decode_nms_2d ({label})")
        del ws
        want_rows, want_keep = gpu_decode.decode_nms_2d_reference(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(keep, want_keep), f"decode_nms_2d keep differs ({label})")
        check(torch.equal(bits(rows), bits(want_rows)), f"decode_nms_2d rows differ ({label})")
        check(kind != "nan" or not keep.any(), "decode_nms_2d kept a box beside a live NaN")
        k1_err = max(k1_err, float((rows - want_rows).abs().max()))
    check(min(k1_order_paths.values()) > 0, f"an order path was not taken: {k1_order_paths}")
    # kernel 2: every kind as drawn (the order pass sorts) and in score
    # order (taken as it stands, as the unfused route's top-k hands them
    # over), then the reference's 16,128-box heads and the largest N taken
    k2_err = 0
    k2_order_paths = {"input_order": 0, "sorted": 0}
    nms_cases = [(kind, K_MAIN, MAX_DET, sort) for kind in kernel_cases.KINDS
                 for sort in (False, True)] + [
        ("random", n, max_det, sort)
        for n, max_det in ((K_YOLO_HEAD, MAX_DET), (K_LARGEST, MAX_DET), (K_LARGEST, K_LARGEST))
        for sort in (False, True)
    ]
    check(gpu_nms.smem_fits(K_YOLO_HEAD) and gpu_nms.smem_fits(K_LARGEST)
          and not gpu_nms.smem_fits(K_LARGEST + 1),
          f"greedy_nms does not take N up to {K_LARGEST} exactly")
    for i, (kind, n, max_det, sort) in enumerate(nms_cases):
        boxes, scores = kernel_cases.nms_batch(kind, B_MAIN if n == K_MAIN else 2, n, 40 + 8 * i,
                                               sort)
        boxes, scores = to_dev([boxes, scores])
        label = f"{kind}, N {n}, max_det {max_det}, sorted {sort}"
        (idx, valid), ws, sizes = with_workspace(
            lambda: gpu_nms.nms_greedy(boxes, scores, 0.45, max_det))
        count_order_paths(ws, sizes, scores, k2_order_paths, f"greedy_nms ({label})")
        del ws
        want_idx, want_valid = gpu_nms.nms_greedy_reference(boxes, scores, 0.45, max_det)
        torch.cuda.synchronize()
        check(torch.equal(valid, want_valid), f"greedy_nms valid differs ({label})")
        check(torch.equal(idx, want_idx), f"greedy_nms indices differ ({label})")
        if kind == "nan":  # every slot invalid, at the first NaN's index
            first_nan = torch.isnan(scores).to(torch.int8).argmax(1, keepdim=True).to(torch.int32)
            check(not valid.any() and torch.equal(idx, first_nan.expand_as(idx)),
                  "greedy_nms: a live NaN did not empty every slot at its index")
        k2_err = max(k2_err, int((idx - want_idx).abs().max()))
    check(min(k2_order_paths.values()) > 0, f"an order path was not taken: {k2_order_paths}")
    # the pallas route past a block's shared memory raises, launching nothing
    n_big = K_LARGEST + 1
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
         "largest_k": K_LARGEST, "images_by_order_path": k1_order_paths,
         "match": True, "max_abs_err": k1_err},
        {"name": "greedy_nms", "cases": len(nms_cases), "shape": [B_MAIN, K_MAIN, MAX_DET],
         "largest_k": K_LARGEST, "yolo_head_k": K_YOLO_HEAD,
         "images_by_order_path": k2_order_paths, "match": True, "max_abs_err": k2_err},
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
        # each batch size this run sends the variant: 1 and 8, and every
        # size the batcher may merge for yolov5n_c005 (phase 21)
        sizes = range(1, B_MAIN + 1) if name == "yolov5n_c005" else (1, B_MAIN)
        repo.register(spec, pipe.infer_fn(),
                      warmup=functools.partial(pipe.warmup, FRAME_HW, batch_sizes=sizes))
        pipes[name] = (pipe, spec, model)
    check(pipes["yolov5n"][1].extra["fused_stages"] == ["decode_nms"], "auto did not fuse on CUDA")
    check(pipes["yolov5n_unfused"][1].extra["fused_stages"] == [], "off still fused")
    channel = CUDAChannel(repo)
    channel.register_channel()
    # every graph before traffic (the registration warmup); the unfused
    # routes also under TRITON_CLIENT_TPU_NMS=pallas, which phases 3, 5
    # and 22 serve
    for name in variants:
        repo.get(name).warmup()
    os.environ["TRITON_CLIENT_TPU_NMS"] = "pallas"
    for name in ("yolov5n_unfused", "yolov5n_c005_unfused"):
        repo.get(name).warmup()
    del os.environ["TRITON_CLIENT_TPU_NMS"]

    frames = np.stack([f.data for f in SyntheticImageSource(40, FRAME_HW, seed=0)])
    SERVED["yolov5n"] = {"pipes": pipes, "repo": repo, "channel": channel, "frames": frames}
    b1 = [frames[i:i + 1] for i in range(4)]
    b8 = [frames[8 + 8 * i: 16 + 8 * i] for i in range(4)]

    def ask(model_name, batch):
        return channel.do_inference(InferRequest(model_name, {"images": batch})).outputs

    for name in variants:  # warm-up (cuDNN picks its algorithms), not counted
        ask(name, b1[0])
        ask(name, b8[0])
    os.environ["TRITON_CLIENT_TPU_NMS"] = "pallas"  # the unfused route's kernel
    for counter in counters:
        counter.reset()
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
    # topk_candidates hands them over in score order: the order pass takes it as it stands
    kw1 = dict(iou_thresh=0.45, max_det=MAX_DET, box_format="xywh")
    (rows, keep), ws, sizes = with_workspace(lambda: gpu_decode.fused_decode_nms_2d(*cands, **kw1))
    check(bool(mask_scan.took_own_order(ws, sizes).all()),
          "the order pass sorted the main path's candidates")
    k1_workspace_bytes = ws.numel()
    del ws
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
    k1_call_ms = cuda_ms(lambda: gpu_decode.fused_decode_nms_2d(*cands, **kw1), reps=200)
    k1_args = (cands[0].float(), cands[1].float(), cands[2].float(), cands[3].bool())
    k1_ms = kernel_device_ms(lambda: gpu_decode.fused_decode_nms_2d(*k1_args, **kw1),
                             gpu_decode.launches)
    k1_plain_ms = cuda_ms(lambda: gpu_decode.decode_nms_2d_reference(*cands, **kw1), reps=5, warmup=1)
    k2_call_ms = cuda_ms(lambda: gpu_nms.nms_greedy(offset, masked, 0.45, MAX_DET), reps=200)
    k2_ms = kernel_device_ms(lambda: gpu_nms.nms_greedy(offset, masked, 0.45, MAX_DET),
                             gpu_nms.launches)
    k2_plain_ms = cuda_ms(lambda: gpu_nms.nms_greedy_reference(offset, masked, 0.45, MAX_DET),
                          reps=5, warmup=1)
    iou_tests = live_counts(offset, masked, torch.tensor(0.45, device=dev), MAX_DET)
    k1_bytes = B_MAIN * K_MAIN * (16 + 4 + 4 + 1) + B_MAIN * MAX_DET * (24 + 1)
    k2_bytes = B_MAIN * K_MAIN * (16 + 4) + B_MAIN * MAX_DET * (4 + 1)
    ops = iou_tests * IOU_OPS
    k1_bound, k1_by = roofline(k1_bytes, ops)
    k2_bound, k2_by = roofline(k2_bytes, ops)

    def serve2d(batches, reps):
        return serve(lambda b: ask("yolov5n", b), batches, reps, "frames_per_s",
                     lambda b: b.shape[0])

    e2e = {"batch1": serve2d(b1, 40), "batch8": serve2d(b8, 20)}
    # the unfused conf-0.05 route at batch 8 (300 kept an image), through
    # the sequential loop as deployed by default and through kernel 2
    # under the override; recorded, not claimed (host-bound)
    e2e["c005_unfused_batch8"] = serve(lambda b: ask("yolov5n_c005_unfused", b), b8, 20,
                                       "frames_per_s", lambda b: b.shape[0])
    os.environ["TRITON_CLIENT_TPU_NMS"] = "pallas"
    before = gpu_nms.launches.count
    e2e["c005_unfused_batch8_pallas"] = serve(lambda b: ask("yolov5n_c005_unfused", b), b8, 20,
                                              "frames_per_s", lambda b: b.shape[0])
    del os.environ["TRITON_CLIENT_TPU_NMS"]
    check(gpu_nms.launches.count - before == 20, "the override's requests did not launch kernel 2")
    k1_passes = pass_split(lambda: gpu_decode.fused_decode_nms_2d(*k1_args, **kw1),
                           "decode_nms_2d")
    emit("passes", card, kernel="decode_nms_2d", shape=[B_MAIN, K_MAIN, MAX_DET],
         kept=int(keep.sum()), workspace_bytes=k1_workspace_bytes, **k1_passes)
    (k2_idx, k2_valid), ws, sizes = with_workspace(
        lambda: gpu_nms.nms_greedy(offset, masked, 0.45, MAX_DET))
    check(bool(mask_scan.took_own_order(ws, sizes).all()),
          "the order pass sorted the main path's candidates (kernel 2)")
    k2_workspace_bytes = ws.numel()
    del ws
    want_idx, want_valid = gpu_nms.nms_greedy_reference(offset, masked, 0.45, MAX_DET)
    check(torch.equal(k2_idx, want_idx) and torch.equal(k2_valid, want_valid),
          "greedy_nms differs on the main path's candidates")
    k2_passes = pass_split(lambda: gpu_nms.nms_greedy(offset, masked, 0.45, MAX_DET),
                           "greedy_nms")
    emit("passes", card, kernel="greedy_nms", shape=[B_MAIN, K_MAIN, MAX_DET],
         kept=int(k2_valid.sum()), workspace_bytes=k2_workspace_bytes, **k2_passes)
    emit("times", card, kernel_ms={"decode_nms_2d": k1_ms, "greedy_nms": k2_ms},
         call_ms={"decode_nms_2d": k1_call_ms, "greedy_nms": k2_call_ms},
         plain_ms={"decode_nms_2d": k1_plain_ms, "greedy_nms": k2_plain_ms},
         bound_ms={"decode_nms_2d": k1_bound, "greedy_nms": k2_bound},
         iou_tests=iou_tests, in_process=e2e)

    # -- 6. where a request's time goes (the wall includes the profiler's cost) ---
    for batch in (b1[0], b8[0]):
        emit("profile", card, batch=batch.shape[0],
             **device_profile(lambda: ask("yolov5n", batch), PROFILE_REQUESTS))

    record_3d = run_3d(card, dev, counters)
    record_second, second_launches = run_second(card, dev, counters)
    for row in record_3d:  # kernels 3-4 run on both 3D paths
        row["launches_by_path"] = {"pointpillars": row["launches"],
                                   "second_iou": second_launches[row["name"]]}
    record_ragged = run_ragged(card, dev, counters)
    run_dense_batched(card, counters, repo, channel, frames)
    run_graphs(card, dev, counters)
    run_driver(card)
    run_facade(card, counters)

    record = [
        {"name": "decode_nms_2d", "route": "cuda",
         "source": "triton_client_tpu_torch/csrc/decode_nms_2d.cu",
         "replaces": "triton_client_tpu/ops/pallas_decode.py:155",
         "launches": launches["decode_nms_2d"], "max_abs_err": k1_err, "match": True,
         "ms": k1_ms, "call_ms": k1_call_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "passes_us": k1_passes["us"],
         "workspace_bytes": k1_workspace_bytes,
         "library_ms": None, "card": card},
        {"name": "greedy_nms", "route": "cuda",
         "source": "triton_client_tpu_torch/csrc/greedy_nms.cu",
         "replaces": "triton_client_tpu/ops/pallas_nms.py:111",
         "launches": launches["greedy_nms"], "max_abs_err": k2_err, "match": True,
         "ms": k2_ms, "call_ms": k2_call_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "passes_us": k2_passes["us"],
         "workspace_bytes": k2_workspace_bytes,
         "library_ms": None, "card": card},
        *record_3d,
        *record_second,
        *record_ragged,
    ]
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def run_3d(card: str, dev: torch.device, counters) -> list[dict]:
    """Phases 7-11: the PointPillars path. ``counters`` are every kernel's
    launch counters, all set to 0 just before the main path. Returns the
    3D kernels' rows of the ``{"kernels": [...]}`` record."""
    import dataclasses as dc

    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.drivers.driver import channel_infer3d
    from triton_client_tpu_torch.io.sources import SyntheticPointCloudSource
    from triton_client_tpu_torch.models.pointpillars import PointPillarsConfig
    from triton_client_tpu_torch.ops import gpu_decode3d, gpu_suppress3d, kernel_cases, mask_scan
    from triton_client_tpu_torch.ops.voxelize import VoxelConfig
    from triton_client_tpu_torch.pipelines.detect3d import (
        Detect3DConfig,
        build_pointpillars_pipeline,
        gathered_decode_args,
        prepare_points,
    )
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a))[None].to(dev) for a in arrays]

    def decode_match(got, want, label):
        """Bitwise in every column, -0.0 included: the kernel's expf,
        sqrtf and division are the libdevice functions PyTorch's CUDA ops
        call, and --fmad=false rounds each product and sum as they do."""
        check(torch.equal(bits(got), bits(want)), f"residual_decode_3d differs ({label})")

    # -- 7. the 3D kernels against their plain versions, on the card ------------
    for i, kind in enumerate(kernel_cases.DECODE3D_KINDS):
        args = on_card(*kernel_cases.decode3d_inputs(kind, K_3D, seed=50 + i))
        got = gpu_decode3d.fused_residual_decode(*args)
        want = gpu_decode3d.residual_decode_reference(*args)
        torch.cuda.synchronize()
        decode_match(got, want, kind)
        # the gathered form at the KITTI PointPillars head: K_3D of its
        # anchors, direction logits as drawn, tied and with NaNs
        for j, dir_kind in enumerate(kernel_cases.DIR_KINDS):
            gargs = [torch.from_numpy(a).to(dev) for a in kernel_cases.gather_decode3d_inputs(
                kind, 1, N_ANCHORS_3D, K_3D, dir_kind, seed=55 + 3 * i + j)]
            got = gpu_decode3d.gather_residual_decode(*gargs)
            want = gpu_decode3d.gather_residual_decode_reference(*gargs)
            torch.cuda.synchronize()
            decode_match(got, want, f"{kind}, gathered, direction logits {dir_kind}")
    k4_cases = 0
    k4_order_paths = {"input_order": 0, "sorted": 0}

    def k4_call(run, srows, label):
        """``run()``, one kernel-4 call over ``srows``, with its order
        path read back and counted."""
        out, ws, sizes = with_workspace(run)
        count_order_paths(ws, sizes, srows[..., COLS_3D - 2], k4_order_paths,
                          f"suppress_pack_3d ({label})")
        return out

    def k4_match(iou, srows, max_det, label):
        got = k4_call(lambda: gpu_suppress3d.suppress_pack_3d(iou, srows, 0.01, max_det), srows,
                      label)
        want = gpu_suppress3d.suppress_pack_3d_reference(iou, srows, 0.01, max_det)
        torch.cuda.synchronize()
        check(torch.equal(got[1], want[1]) and torch.equal(bits(got[0]), bits(want[0])),
              f"suppress_pack_3d differs ({label})")

    for i, kind in enumerate(kernel_cases.SUPPRESS3D_KINDS):
        boxes, scores, labels = on_card(*kernel_cases.suppress3d_inputs(kind, K_3D, seed=60 + i))
        iou, srows = gpu_suppress3d.sorted_candidates(boxes, scores, labels)
        rows, keep = k4_call(lambda: gpu_suppress3d.fused_suppress_pack_3d(
            boxes, scores, labels, 0.01, MAX_DET_3D), srows, kind)
        want_rows, want_keep = gpu_suppress3d.suppress_pack_3d_reference(
            iou, srows, 0.01, MAX_DET_3D
        )
        torch.cuda.synchronize()
        check(torch.equal(keep, want_keep), f"suppress_pack_3d keep differs ({kind})")
        check(torch.equal(bits(rows), bits(want_rows)), f"suppress_pack_3d rows differ ({kind})")
        k4_cases += 1
        # the same candidates shuffled: the order pass sorts them
        perm = torch.from_numpy(np.random.default_rng(61 + i).permutation(K_3D)).to(dev)
        k4_match(iou[:, perm][:, :, perm].contiguous(), srows[:, perm].contiguous(),
                 MAX_DET_3D, f"{kind}, shuffled")
        k4_cases += 1
        if kind == "nan":
            check(not keep.any(), "suppress_pack_3d kept a row beside a live NaN")
    iou, srows = on_card(*kernel_cases.planted_iou(K_3D, seed=70))  # IoU == the threshold
    k4_match(iou, srows, MAX_DET_3D, "at the threshold")
    k4_cases += 1
    # K past one group of 32 mask words, up to the largest K taken
    check(gpu_suppress3d.smem_fits(K_LARGEST, COLS_3D)
          and not gpu_suppress3d.smem_fits(K_LARGEST + 1, COLS_3D),
          f"suppress_pack_3d does not take K up to {K_LARGEST} exactly")
    for k, max_dets in ((1300, (1300,)), (K_LARGEST, (MAX_DET_3D, K_LARGEST))):
        iou, srows = on_card(*kernel_cases.sparse_iou(k, 4.0 / k, seed=71))
        perm = torch.from_numpy(np.random.default_rng(72).permutation(k)).to(dev)
        shuffled = iou[:, perm][:, :, perm].contiguous(), srows[:, perm].contiguous()
        for max_det in max_dets:
            k4_match(iou, srows, max_det, f"sparse, K {k}, max_det {max_det}")
            k4_match(*shuffled, max_det, f"sparse, K {k}, max_det {max_det}, shuffled")
            k4_cases += 2
        del iou, srows, shuffled
    check(min(k4_order_paths.values()) > 0, f"an order path was not taken: {k4_order_paths}")
    n_big = K_LARGEST + 1  # past the largest K the wrapper takes: raises, launches nothing
    before = gpu_suppress3d.launches.count
    try:
        gpu_suppress3d.suppress_pack_3d(torch.zeros((1, 1, 1), device=dev).expand(1, n_big, n_big),
                                        torch.zeros((1, n_big, COLS_3D), device=dev))
        raised = False
    except ValueError:
        raised = True
    check(raised and gpu_suppress3d.launches.count == before,
          "suppress_pack_3d past shared memory did not raise on the card")
    emit("kernels_vs_plain_3d", card, kernels=[
        {"name": "residual_decode_3d", "cases": len(kernel_cases.DECODE3D_KINDS),
         "gathered_cases": len(kernel_cases.DECODE3D_KINDS) * len(kernel_cases.DIR_KINDS),
         "shape": [1, K_3D, 7], "gathered_from": [1, N_ANCHORS_3D, 7], "match": True,
         "max_abs_err": 0.0},
        {"name": "suppress_pack_3d", "cases": k4_cases, "shape": [1, K_3D, MAX_DET_3D, COLS_3D],
         "largest_k": K_LARGEST, "images_by_order_path": k4_order_paths,
         "match": True, "max_abs_err": 0.0},
    ])

    # -- 8. the main path: full-width KITTI PointPillars through the channel ----
    repo = ModelRepository()
    pipes = {}
    for name, fused in (("pointpillars", "auto"), ("pointpillars_unfused", "off")):
        pipe, spec, model = build_pointpillars_pipeline(
            config=Detect3DConfig(model_name=name, fused=fused), device="cuda", seed=0
        )  # one seed: both hold the same weights
        repo.register(spec, pipe.infer_fn(), warmup=pipe.warmup)  # a graph a point bucket
        pipes[name] = (pipe, spec, model)
    check(pipes["pointpillars"][1].extra["fused_stages"] == ["decode_nms"], "auto did not fuse")
    check(pipes["pointpillars_unfused"][1].extra["fused_stages"] == [], "off still fused")
    pipe, spec, model = pipes["pointpillars"]
    check(model.cfg.voxel.grid_size == (432, 496, 1) and pipe.use_scatter, "not the KITTI grid")
    channel = CUDAChannel(repo)
    channel.register_channel()
    infer = {name: channel_infer3d(channel, name) for name in pipes}
    scans = {
        n: [f.data for f in SyntheticPointCloudSource(3, points=n, seed=i)]
        for i, n in enumerate(SCAN_POINTS)
    }
    for name in pipes:
        repo.get(name).warmup()
    SERVED["pointpillars"] = {"pipes": pipes, "repo": repo, "channel": channel, "scans": scans}
    for name in pipes:  # warm-up, not counted
        for n in SCAN_POINTS:
            infer[name](scans[n][0])
    torch.cuda.synchronize()
    for counter in counters:
        counter.reset()
    out = {n: [infer["pointpillars"](pc) for pc in scans[n]] for n in SCAN_POINTS}
    repeat = infer["pointpillars"](scans[SCAN_POINTS[1]][0])
    fused_requests = sum(len(v) for v in scans.values()) + 1
    before = [gpu_decode3d.launches.count, gpu_suppress3d.launches.count]
    unfused = {n: infer["pointpillars_unfused"](scans[n][0]) for n in SCAN_POINTS}
    after = [gpu_decode3d.launches.count, gpu_suppress3d.launches.count]
    launches = {c_name: c.count for c_name, c in
                (("residual_decode_3d", gpu_decode3d.launches),
                 ("suppress_pack_3d", gpu_suppress3d.launches))}
    gathered = gpu_decode3d.gathered_launches.count
    check(before == after, "the unfused route launched a 3D kernel")
    for k_name, count in launches.items():
        check(count == fused_requests,
              f"{k_name} launched {count} times for {fused_requests} fused requests")
    check(gathered == fused_requests,
          f"kernel 3's gathered form launched {gathered} times for {fused_requests} requests")
    kept = {}
    for n in SCAN_POINTS:
        for o in out[n]:
            check(o["pred_boxes"].shape[1] == 7 and bool(np.isfinite(o["pred_boxes"]).all()),
                  "non-finite or misshapen boxes")
            check(len(o["pred_scores"]) <= MAX_DET_3D and o["pred_labels"].min() >= 1, "rows")
        kept[n] = [len(o["pred_scores"]) for o in out[n]]
        check(min(kept[n]) > 0, f"no detection kept at {n} points")
        for key in unfused[n]:  # fused rows equal the unfused ones, by value
            check(np.array_equal(out[n][0][key], unfused[n][key]), f"fused != unfused {key} ({n})")
    for key in repeat:
        check(np.array_equal(repeat[key], out[SCAN_POINTS[1]][0][key]),
              f"the same scan twice gave other {key}")
    bitwise_repeat = all(repeat[k].tobytes() == out[SCAN_POINTS[1]][0][k].tobytes() for k in repeat)
    # live candidates: the gate + top-k of the same scans, launching nothing
    live = {}
    with torch.no_grad():
        for n in SCAN_POINTS:
            padded, m = prepare_points(scans[n][0], 4, Detect3DConfig().point_buckets)
            heads = model.from_points(torch.from_numpy(padded).to(dev),
                                      torch.tensor(m, dtype=torch.int32, device=dev))
            cand = model.topk_candidates(heads, K_3D, Detect3DConfig().score_thresh)
            live[n] = int(torch.isfinite(cand["scores"]).sum())
            check(live[n] > 0, f"no live candidate at {n} points")
    emit("main_path_3d", card, model="pointpillars", grid=list(model.cfg.voxel.grid_size),
         anchors=int(model.anchors.shape[0]), points=list(SCAN_POINTS),
         requests={"fused": fused_requests, "unfused": len(unfused)},
         live_candidates=live, kept=kept, fused_equals_unfused=True,
         repeat_equal=True, repeat_bitwise=bitwise_repeat, launches=launches,
         launches_gathered_form=gathered,
         deterministic_sum_route="index_put_(accumulate=True), models/pointpillars.pillar_sums")

    # -- 9. kernels on the main path's own candidates; the card against the CPU --
    with torch.no_grad():
        padded, m = prepare_points(scans[SCAN_POINTS[1]][1], 4, Detect3DConfig().point_buckets)
        heads = model.from_points(torch.from_numpy(padded).to(dev),
                                  torch.tensor(m, dtype=torch.int32, device=dev))
        cand = model.topk_candidates(heads, K_3D, Detect3DConfig().score_thresh)
        sel = model.topk_indices(heads, K_3D, Detect3DConfig().score_thresh)
    dec_args = (cand["deltas"], cand["anchors"], cand["dir_bin"])
    gather_args = gathered_decode_args(model, heads, sel["top_idx"])
    check(gather_args[0].shape[1] == N_ANCHORS_3D, "not the KITTI head's anchors")
    boxes = gpu_decode3d.gather_residual_decode(*gather_args)
    decode_match(boxes, gpu_decode3d.gather_residual_decode_reference(*gather_args),
                 "main path, gathered")
    decode_match(gpu_decode3d.fused_residual_decode(*dec_args),
                 gpu_decode3d.residual_decode_reference(*dec_args), "main path")
    check(torch.equal(bits(boxes), bits(gpu_decode3d.residual_decode_reference(*dec_args))),
          "the gathered form differs from the ungathered chain on the main path")
    iou, srows = gpu_suppress3d.sorted_candidates(boxes, cand["scores"], cand["labels"])
    # sorted_candidates hands them over in score order: taken as it stands
    got, ws, sizes = with_workspace(
        lambda: gpu_suppress3d.suppress_pack_3d(iou, srows, 0.01, MAX_DET_3D))
    check(bool(mask_scan.took_own_order(ws, sizes).all()),
          "the order pass sorted the main path's 3D candidates")
    k4_workspace_bytes = ws.numel()
    del ws
    want = gpu_suppress3d.suppress_pack_3d_reference(iou, srows, 0.01, MAX_DET_3D)
    check(torch.equal(got[1], want[1]) and torch.equal(bits(got[0]), bits(want[0])),
          "suppress_pack_3d differs on the main path's candidates")
    # the tiny grid of tests/test_pointpillars.py, same seed on both devices
    tiny = PointPillarsConfig(
        voxel=VoxelConfig(point_cloud_range=(0.0, -6.4, -3.0, 12.8, 6.4, 1.0),
                          voxel_size=(0.2, 0.2, 4.0), max_voxels=512, max_points_per_voxel=8),
        backbone_layers=(1, 1, 1),
    )
    tiny_cfg = Detect3DConfig(point_buckets=(2048,), max_det=16, pre_max=64)
    card_pipe, _, _ = build_pointpillars_pipeline(tiny, tiny_cfg, device="cuda", seed=0)
    cpu_pipe, _, _ = build_pointpillars_pipeline(tiny, dc.replace(tiny_cfg, fused="on"),
                                                 device="cpu", seed=0)
    tiny_err, tiny_kept = card_vs_cpu(
        card_pipe, cpu_pipe, uniform_clouds(9, tiny.voxel.point_cloud_range, 500)
    )
    nan_cells = nan_cells_card_vs_cpu(dev)
    # one NaN x wipes every score on both devices, as in the JAX package
    nan_pc = uniform_clouds(9, tiny.voxel.point_cloud_range, 500)[0]
    nan_pc[7, 0] = np.nan
    nan_kept = [len(p.infer(nan_pc)["pred_scores"]) for p in (card_pipe, cpu_pipe)]
    check(nan_kept == [0, 0], f"a NaN point kept {nan_kept} detections (card, CPU), want 0")
    emit("check_3d", card, kernels_equal_plain_on_main_path=True, candidates=int(
        torch.isfinite(cand["scores"]).sum()), kept=int(got[1].sum()),
        cpu_vs_card_kept=tiny_kept, cpu_vs_card_max_abs_err=tiny_err,
        nan_cells_card_equals_cpu=nan_cells, nan_point_kept_card_cpu=nan_kept)

    # -- 10. times on the card's clock ---------------------------------------------
    # kernel 3 as the main path launches it (gathered) and in the TPU
    # kernel's form on the rows topk_candidates gathers
    k3_call_ms = cuda_ms(lambda: gpu_decode3d.gather_residual_decode(*gather_args), reps=500)
    k3_ms = kernel_device_ms(lambda: gpu_decode3d.gather_residual_decode(*gather_args),
                             gpu_decode3d.launches)
    k3_plain_ms = cuda_ms(lambda: gpu_decode3d.gather_residual_decode_reference(*gather_args),
                          reps=100)
    k3_rows_ms = kernel_device_ms(lambda: gpu_decode3d.fused_residual_decode(*dec_args),
                                  gpu_decode3d.launches)
    k4_call_ms = cuda_ms(lambda: gpu_suppress3d.suppress_pack_3d(iou, srows, 0.01, MAX_DET_3D),
                         reps=200)
    k4_ms = kernel_device_ms(lambda: gpu_suppress3d.suppress_pack_3d(iou, srows, 0.01, MAX_DET_3D),
                             gpu_suppress3d.launches)
    k4_plain_ms = cuda_ms(
        lambda: gpu_suppress3d.suppress_pack_3d_reference(iou, srows, 0.01, MAX_DET_3D),
        reps=5, warmup=1,
    )
    tests, kept_steps = live_counts_3d(iou, srows[..., COLS_3D - 2].clone(),
                                       torch.tensor(0.01, device=dev), MAX_DET_3D)
    n_cand = K_3D  # B = 1
    nb = model.cfg.num_dir_bins
    # each candidate's box-head row, anchor and direction logits, its
    # index, its box written
    k3_bytes = n_cand * (7 * 4 + 7 * 4 + 4 * nb + 8 + 7 * 4)
    # the IoU rows of the kept steps, the sorted rows, the packed output
    k4_bytes = kept_steps * K_3D * 4 + K_3D * COLS_3D * 4 + MAX_DET_3D * (COLS_3D * 4 + 1)
    k3_bound, k3_by = roofline(k3_bytes, n_cand * (DECODE_OPS + nb - 1))  # and the argmax
    k4_bound, k4_by = roofline(k4_bytes, tests)  # one compare per live candidate a step

    e2e = {f"points{n}": serve(infer["pointpillars"], scans[n], SERVE_REQUESTS_3D)
           for n in SCAN_POINTS}
    k4_passes = pass_split(
        lambda: gpu_suppress3d.suppress_pack_3d(iou, srows, 0.01, MAX_DET_3D), "suppress_pack_3d"
    )
    emit("passes_3d", card, kernel="suppress_pack_3d", shape=[1, K_3D, MAX_DET_3D, COLS_3D],
         kept=int(got[1].sum()), workspace_bytes=k4_workspace_bytes,
         **k4_passes)
    emit("times_3d", card,
         kernel_ms={"residual_decode_3d": k3_ms, "suppress_pack_3d": k4_ms},
         kernel_ms_ungathered_form={"residual_decode_3d": k3_rows_ms},
         call_ms={"residual_decode_3d": k3_call_ms, "suppress_pack_3d": k4_call_ms},
         plain_ms={"residual_decode_3d": k3_plain_ms, "suppress_pack_3d": k4_plain_ms},
         bound_ms={"residual_decode_3d": k3_bound, "suppress_pack_3d": k4_bound},
         live_tests=tests, kept_steps=kept_steps, in_process=e2e)

    # -- 11. where a 120k-point request's time goes -------------------------------
    pc = scans[SCAN_POINTS[1]][0]
    emit("profile_3d", card, points=SCAN_POINTS[1],
         **device_profile(lambda: infer["pointpillars"](pc), PROFILE_REQUESTS),
         candidate_stage=candidate_stage(model, heads, sel["top_idx"]))

    return [
        {"name": "residual_decode_3d", "route": "cuda",
         "source": "triton_client_tpu_torch/csrc/residual_decode_3d.cu",
         "replaces": "triton_client_tpu/ops/pallas_decode.py:233",
         "launches": launches["residual_decode_3d"], "max_abs_err": 0.0, "match": True,
         "ms": k3_ms, "call_ms": k3_call_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_by, "form": "gathered", "ms_ungathered_form": k3_rows_ms,
         "launches_gathered_form": gathered,
         "library_ms": None, "card": card},
        {"name": "suppress_pack_3d", "route": "cuda",
         "source": "triton_client_tpu_torch/csrc/suppress_pack_3d.cu",
         "replaces": "triton_client_tpu/ops/pallas_decode.py:321",
         "launches": launches["suppress_pack_3d"], "max_abs_err": 0.0, "match": True,
         "ms": k4_ms, "call_ms": k4_call_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
         "bound_by": k4_by, "passes_us": k4_passes["us"],
         "workspace_bytes": k4_workspace_bytes,
         "library_ms": None, "card": card},
    ]


def run_second(card: str, dev: torch.device, counters) -> tuple[list[dict], dict]:
    """Phases 12-16: the SECOND-IoU path (dense middle), kernel 5 new and
    kernels 3-4 on its tail. ``counters`` are every kernel's launch
    counters, all set to 0 just before the main path. Returns the segment
    mean's row of the ``{"kernels": [...]}`` record and the main path's
    launch counts of every 3D kernel."""
    import dataclasses as dc

    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.drivers.driver import channel_infer3d
    from triton_client_tpu_torch.io.sources import SyntheticPointCloudSource
    from triton_client_tpu_torch.models.second import SECONDConfig
    from triton_client_tpu_torch.ops import gpu_decode3d, gpu_suppress3d, gpu_voxel, kernel_cases
    from triton_client_tpu_torch.ops.voxelize import VoxelConfig, assign_cells, linearize_zyx
    from triton_client_tpu_torch.pipelines.detect3d import (
        Detect3DConfig,
        build_second_pipeline,
        gathered_decode_args,
        prepare_points,
    )
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    k5_err = 0.0  # the largest |kernel - plain| over every comparison below

    def segment_match(valsT, slots, label):
        nonlocal k5_err
        got = gpu_voxel.sorted_segment_mean(valsT, slots, SECOND_SLOTS)
        want = gpu_voxel.sorted_segment_mean_reference(valsT, slots, SECOND_SLOTS)
        torch.cuda.synchronize()
        check(torch.equal(bits(got), bits(want)), f"segment_mean differs ({label})")
        k5_err = max(k5_err, float((got - want).abs().max()))

    # -- 12. the segment mean against its plain version, on the card ------------
    n_main = Detect3DConfig().point_buckets[-1]  # the 120k-point scan's bucket
    for i, kind in enumerate(kernel_cases.SEGMENT_KINDS):
        n = 4096 if kind == "one_slot" else n_main  # the plain version loops over the slot
        valsT, slots = (torch.from_numpy(a).to(dev)
                        for a in kernel_cases.segment_inputs(kind, n, SECOND_SLOTS, seed=80 + i))
        segment_match(valsT, slots, kind)
    before = gpu_voxel.launches.count
    try:  # a strided view is refused, launching nothing
        gpu_voxel.sorted_segment_mean(torch.zeros((n_main, 8), device=dev).T,
                                      torch.zeros(n_main, dtype=torch.int32, device=dev), 4)
        raised = False
    except ValueError:
        raised = True
    check(raised and gpu_voxel.launches.count == before, "a strided valsT did not raise")
    emit("kernels_vs_plain_second", card, kernels=[
        {"name": "segment_mean", "cases": len(kernel_cases.SEGMENT_KINDS),
         "shape": [8, n_main, SECOND_SLOTS], "match": True, "max_abs_err": k5_err},
    ])

    # -- 13. the main path: full-width KITTI SECOND-IoU through the channel -----
    repo = ModelRepository()
    pipes = {}
    for name, fused in (("second_iou", "auto"), ("second_iou_unfused", "off")):
        pipe, spec, model = build_second_pipeline(
            config=Detect3DConfig(model_name=name, fused=fused), device="cuda", seed=0
        )  # one seed: both hold the same weights
        repo.register(spec, pipe.infer_fn(), warmup=pipe.warmup)  # a graph a point bucket
        pipes[name] = (pipe, spec, model)
    check(pipes["second_iou"][1].extra["fused_stages"] == ["voxelize_scatter", "decode_nms"],
          "auto did not fuse both SECOND stages")
    check(pipes["second_iou_unfused"][1].extra["fused_stages"] == [], "off still fused")
    pipe, spec, model = pipes["second_iou"]
    voxel = model.cfg.voxel
    check(voxel.grid_size == (352, 400, 10) and voxel.max_voxels == SECOND_SLOTS
          and pipe.use_scatter, "not the KITTI SECOND grid")
    channel = CUDAChannel(repo)
    channel.register_channel()
    infer = {name: channel_infer3d(channel, name) for name in pipes}
    scans = {
        n: [f.data for f in SyntheticPointCloudSource(3, points=n, seed=20 + i)]
        for i, n in enumerate(SCAN_POINTS)
    }
    for name in pipes:
        repo.get(name).warmup()
    SERVED["second_iou"] = {"pipes": pipes, "repo": repo, "channel": channel, "scans": scans}
    for name in pipes:  # warm-up, not counted
        for n in SCAN_POINTS:
            infer[name](scans[n][0])
    torch.cuda.synchronize()
    for counter in counters:
        counter.reset()
    out = {n: [infer["second_iou"](pc) for pc in scans[n]] for n in SCAN_POINTS}
    repeat = infer["second_iou"](scans[SCAN_POINTS[1]][0])
    fused_requests = sum(len(v) for v in scans.values()) + 1
    kernels_3d = (("segment_mean", gpu_voxel.launches),
                  ("residual_decode_3d", gpu_decode3d.launches),
                  ("suppress_pack_3d", gpu_suppress3d.launches))
    before = [c.count for _, c in kernels_3d]
    unfused = {n: infer["second_iou_unfused"](scans[n][0]) for n in SCAN_POINTS}
    launches = {k_name: c.count for k_name, c in kernels_3d}
    all_launches = [c.count for c in counters[:-1]]  # each kernel once
    check(before == list(launches.values()), "the unfused route launched a kernel")
    for k_name, count in launches.items():
        check(count == fused_requests,
              f"{k_name} launched {count} times for {fused_requests} fused requests")
    check(sum(all_launches) == 3 * fused_requests, "a 2D kernel launched on the SECOND path")
    gathered = gpu_decode3d.gathered_launches.count
    check(gathered == fused_requests,
          f"kernel 3's gathered form launched {gathered} times for {fused_requests} requests")

    kept = {}
    for n in SCAN_POINTS:
        for o in out[n]:
            check(o["pred_boxes"].shape[1] == 7 and bool(np.isfinite(o["pred_boxes"]).all()),
                  "non-finite or misshapen boxes")
            check(len(o["pred_scores"]) <= MAX_DET_3D and o["pred_labels"].min() >= 1, "rows")
        kept[n] = [len(o["pred_scores"]) for o in out[n]]
        check(min(kept[n]) > 0, f"no detection kept at {n} points")
    for key in repeat:
        check(repeat[key].tobytes() == out[SCAN_POINTS[1]][0][key].tobytes(),
              f"the same scan twice gave other {key}")
    # below the cap, fused rows equal the unfused ones within 1e-5
    small = SCAN_POINTS[0]
    f0, u0 = out[small][0], unfused[small]
    check(len(f0["pred_scores"]) == len(u0["pred_scores"]), "fused and unfused keep other counts")
    check(np.array_equal(f0["pred_labels"], u0["pred_labels"]), "fused and unfused labels differ")
    fu_err = max(float(np.abs(f0[k] - u0[k]).max(initial=0.0))
                 for k in ("pred_boxes", "pred_scores"))
    check(fu_err <= 1e-5, f"fused and unfused rows differ by {fu_err} at {small} points")
    fu_bitwise = all(f0[k].tobytes() == u0[k].tobytes() for k in f0)
    big = SCAN_POINTS[1]
    big_differs = any(out[big][0][k].tobytes() != unfused[big][k].tobytes() for k in unfused[big])

    # occupied and kept cells, the live candidates (launches here are not counted)
    cells, live = {}, {}
    with torch.no_grad():
        for n in SCAN_POINTS:
            padded, m = prepare_points(scans[n][0], 4, Detect3DConfig().point_buckets)
            pts = torch.from_numpy(padded).to(dev)
            cnt = torch.tensor(m, dtype=torch.int32, device=dev)
            vid, n_cells = linearize_zyx(*assign_cells(pts, cnt, voxel), voxel)
            occupied = int(torch.unique(vid[vid < n_cells]).numel())
            volume = gpu_voxel.fused_mean_volume(pts, cnt, voxel)
            kept_cells = int((volume != 0).any(-1).sum())
            check(kept_cells == min(occupied, SECOND_SLOTS),
                  f"{n} points: {occupied} occupied cells, the fused route kept {kept_cells}")
            cells[n] = {"occupied": occupied, "kept": kept_cells, "bucket": int(padded.shape[0])}
            cand = model.topk_candidates(model.from_volume(volume), K_3D,
                                         Detect3DConfig().score_thresh)
            live[n] = int(torch.isfinite(cand["scores"]).sum())
            check(live[n] > 0, f"no live candidate at {n} points")
    check(cells[SCAN_POINTS[0]]["occupied"] < SECOND_SLOTS, "the small scan does not fit the cap")
    check(cells[big]["kept"] == SECOND_SLOTS, "the 120k scan did not fill the cap")
    emit("main_path_second", card, model="second_iou", grid=list(voxel.grid_size),
         max_voxels=voxel.max_voxels, anchors=int(model.anchors.shape[0]),
         points=list(SCAN_POINTS), requests={"fused": fused_requests, "unfused": len(unfused)},
         cells=cells, live_candidates=live, kept=kept,
         fused_equals_unfused={str(small): True, "max_abs_err": fu_err, "bitwise": fu_bitwise,
                               f"differs_at_{big}": big_differs},
         repeat_bitwise=True, launches=launches, launches_gathered_form=gathered,
         deterministic_sum_route="index_put_(accumulate=True), models/pointpillars.pillar_sums")

    # -- 14. kernels on the main path's own inputs; the card against the CPU -----
    with torch.no_grad():
        padded, m = prepare_points(scans[big][1], 4, Detect3DConfig().point_buckets)
        pts = torch.from_numpy(padded).to(dev)
        cnt = torch.tensor(m, dtype=torch.int32, device=dev)
        valsT, slots, _ = gpu_voxel.slot_rows(pts, cnt, voxel)
        segment_match(valsT, slots, "main path")
        heads = model.from_volume(gpu_voxel.fused_mean_volume(pts, cnt, voxel))
        cand = model.topk_candidates(heads, K_3D, Detect3DConfig().score_thresh)
        sel = model.topk_indices(heads, K_3D, Detect3DConfig().score_thresh)
    dec_args = (cand["deltas"], cand["anchors"], cand["dir_bin"])
    gather_args = gathered_decode_args(model, heads, sel["top_idx"])
    boxes = gpu_decode3d.gather_residual_decode(*gather_args)
    check(torch.equal(bits(boxes),
                      bits(gpu_decode3d.gather_residual_decode_reference(*gather_args))),
          "residual_decode_3d's gathered form differs on SECOND's candidates")
    check(torch.equal(bits(gpu_decode3d.fused_residual_decode(*dec_args)),
                      bits(gpu_decode3d.residual_decode_reference(*dec_args))),
          "residual_decode_3d differs on SECOND's candidates")
    check(torch.equal(bits(boxes), bits(gpu_decode3d.residual_decode_reference(*dec_args))),
          "the gathered form differs from the ungathered chain on SECOND's candidates")
    check(torch.equal(sel["scores"], cand["scores"]) and torch.equal(sel["labels"], cand["labels"]),
          "topk_indices and topk_candidates select differently")
    iou, srows = gpu_suppress3d.sorted_candidates(boxes, cand["scores"], cand["labels"])
    got = gpu_suppress3d.suppress_pack_3d(iou, srows, 0.01, MAX_DET_3D)
    want = gpu_suppress3d.suppress_pack_3d_reference(iou, srows, 0.01, MAX_DET_3D)
    check(torch.equal(got[1], want[1]) and torch.equal(bits(got[0]), bits(want[0])),
          "suppress_pack_3d differs on SECOND's candidates")
    # the tiny grid of tests/test_torch_second.py, same seed on both devices
    tiny = SECONDConfig(
        voxel=VoxelConfig(point_cloud_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
                          voxel_size=(0.5, 0.5, 0.5), max_voxels=1024, max_points_per_voxel=5),
        middle_filters=(8, 16), backbone_layers=(1, 1), backbone_filters=(16, 32),
        upsample_filters=(16, 16),
    )
    tiny_cfg = Detect3DConfig(model_name="second_iou", point_buckets=(1024,), max_det=16,
                              pre_max=64)
    card_pipe, _, _ = build_second_pipeline(tiny, tiny_cfg, device="cuda", seed=0)
    cpu_pipe, _, _ = build_second_pipeline(tiny, dc.replace(tiny_cfg, fused="on"),
                                           device="cpu", seed=0)
    check(card_pipe.fused_stages == cpu_pipe.fused_stages, "card and CPU route differently")
    tiny_err, tiny_kept = card_vs_cpu(
        card_pipe, cpu_pipe, uniform_clouds(11, tiny.voxel.point_cloud_range, 600)
    )
    emit("check_second", card, kernels_equal_plain_on_main_path=True,
         segment_rows=int(slots.numel()), live_rows=int((slots < SECOND_SLOTS).sum()),
         candidates=int(torch.isfinite(cand["scores"]).sum()), kept=int(got[1].sum()),
         cpu_vs_card_kept=tiny_kept, cpu_vs_card_max_abs_err=tiny_err)

    # -- 15. times on the card's clock ---------------------------------------------
    def k5():
        return gpu_voxel.sorted_segment_mean(valsT, slots, SECOND_SLOTS)

    k5_call_ms = cuda_ms(k5, reps=200)
    k5_ms = kernel_device_ms(k5, gpu_voxel.launches)
    k5_plain_ms = cuda_ms(
        lambda: gpu_voxel.sorted_segment_mean_reference(valsT, slots, SECOND_SLOTS), reps=20
    )
    # the library yardstick: one index_reduce_ "mean" over the live rows
    # (a prefix: the dump rows sort last), as (rows, 8) with int64 ids
    n_live = int((slots < SECOND_SLOTS).sum())
    rows_aos = valsT[:, :n_live].T.contiguous()
    ids = slots[:n_live].long()
    lib_out = torch.zeros((SECOND_SLOTS, 8), device=dev)

    def library():
        return lib_out.index_reduce_(0, ids, rows_aos, "mean", include_self=False)

    library_ms = cuda_ms(library, reps=200)
    # index_reduce_ divides by the row count; the weights here are all 1
    check(torch.allclose(library().T, k5(), rtol=1e-5, atol=0), "index_reduce_ disagrees")
    n_rows = valsT.shape[1]
    # what this run's rows need: the live rows' 8 values and slot id, each
    # read once, and 8 means a slot written; the dump rows are never read
    # (the zero launch's 8 x slots writes and the dump rows' ids, which the
    # row-parallel pass reads, are the design's cost, not counted)
    k5_bytes = 9 * n_live * 4 + 8 * SECOND_SLOTS * 4
    k5_ops = 8 * n_live + 8 * SECOND_SLOTS  # the adds this run's rows need, one division a mean
    k5_bound, k5_by = roofline(k5_bytes, k5_ops)

    e2e = {name: {f"points{n}": serve(infer[name], scans[n], SERVE_REQUESTS_3D)
                  for n in SCAN_POINTS}
           for name in pipes}
    k5_passes = pass_split(k5, "segment_mean", passes=("zero", "walk"))
    emit("passes_second", card, kernel="segment_mean", shape=[8, n_rows, SECOND_SLOTS],
         live_rows=n_live, **k5_passes)
    emit("times_second", card, kernel_ms={"segment_mean": k5_ms},
         call_ms={"segment_mean": k5_call_ms}, plain_ms={"segment_mean": k5_plain_ms},
         library_ms={"segment_mean": library_ms},
         library_call="Tensor.index_reduce_(0, ids, rows, 'mean', include_self=False)",
         bound_ms={"segment_mean": k5_bound}, bound_by={"segment_mean": k5_by},
         bytes=k5_bytes, ops=k5_ops, rows=n_rows, live_rows=n_live, in_process=e2e)

    # -- 16. where a 120k-point SECOND request's time goes -------------------------
    pc = scans[big][0]
    emit("profile_second", card, points=big,
         **device_profile(lambda: infer["second_iou"](pc), PROFILE_REQUESTS))

    return [
        {"name": "segment_mean", "route": "cuda",
         "source": "triton_client_tpu_torch/csrc/segment_mean.cu",
         "replaces": "triton_client_tpu/ops/pallas_voxel.py:194",
         "launches": launches["segment_mean"], "max_abs_err": k5_err, "match": True,
         "ms": k5_ms, "call_ms": k5_call_ms, "plain_ms": k5_plain_ms, "bound_ms": k5_bound,
         "bound_by": k5_by, "passes_us": k5_passes["us"], "library_ms": library_ms,
         "card": card},
    ], launches


def burst(chan, requests) -> tuple[list, list[float], float]:
    """``requests`` sent at once, one caller thread each, released by a
    barrier: the responses, each request's latency and the burst's wall
    (host clock). A caller's error fails the script."""
    import threading

    n = len(requests)
    out, lat, errors = [None] * n, [0.0] * n, []
    gate = threading.Barrier(n + 1)

    def call(i):
        try:
            gate.wait(timeout=60.0)
            t = time.perf_counter()
            out[i] = chan.do_inference(requests[i])
            lat[i] = time.perf_counter() - t
        except Exception as e:  # reported below, not swallowed
            errors.append(repr(e))

    threads = [threading.Thread(target=call, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    gate.wait(timeout=60.0)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=120.0)
    wall = time.perf_counter() - t0
    check(not errors and all(not t.is_alive() for t in threads), f"burst failed: {errors[:3]}")
    return out, lat, wall


def run_ragged(card: str, dev: torch.device, counters) -> list[dict]:
    """Phases 17-20: packed ragged batches through the continuous batcher,
    kernel 6 new. ``counters`` are every kernel's launch counters, all set
    to 0 just before the main path. Returns the segment sum's row of the
    ``{"kernels": [...]}`` record."""
    import concurrent.futures

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.io.sources import SyntheticPointCloudSource
    from triton_client_tpu_torch.models.pool import POOL_W, PoolModel, pool_spec
    from triton_client_tpu_torch.ops import gpu_segment, kernel_cases
    from triton_client_tpu_torch.parallel.ragged_kernels import (
        RaggedLayout,
        pack_rows,
        segment_reduce,
    )
    from triton_client_tpu_torch.runtime.continuous import ContinuousBatchingChannel
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    k6_err = 0.0  # the largest |kernel - plain| over every comparison below

    def segsum_match(v, ids, s, label):
        nonlocal k6_err
        got = gpu_segment.segment_sum(v, ids, s)
        want = gpu_segment.segment_sum_reference(v, ids, s)
        torch.cuda.synchronize()
        check(torch.equal(bits(got), bits(want)), f"segment_sum differs ({label})")
        k6_err = max(k6_err, float((got - want).abs().max()) if got.numel() else 0.0)

    # -- 17. the segment sum against its plain version, on the card -------------
    for i, (kind, r, f, s) in enumerate(kernel_cases.SEGSUM_CASES):
        v, ids = (torch.from_numpy(a).to(dev)
                  for a in kernel_cases.segsum_inputs(kind, r, f, s, seed=90 + i))
        segsum_match(v, ids, s, f"{kind} R={r} F={f} S={s}")
    empty = gpu_segment.segment_sum(torch.ones((0, 4), device=dev),
                                    torch.zeros(0, dtype=torch.int32, device=dev), 8)
    check(empty.shape == (8, 4) and not bool(empty.any()), "R = 0 did not give zeros")
    check(gpu_segment.segment_sum(torch.ones((5, 4), device=dev),
                                  torch.zeros(5, dtype=torch.int32, device=dev), 0).shape == (0, 4),
          "S = 0")
    before = gpu_segment.launches.count
    try:  # mixed devices are refused, launching nothing
        gpu_segment.segment_sum(torch.ones((5, 4), device=dev),
                                torch.zeros(5, dtype=torch.int32), 2)
        raised = False
    except ValueError:
        raised = True
    check(raised and gpu_segment.launches.count == before, "mixed devices did not raise")
    v, ids = kernel_cases.segsum_inputs("out_of_range", kernel_cases.SEGSUM_MAIN_ROWS, 4, 8,
                                        seed=99)
    reduce_ops = {}
    for op in ("sum", "mean", "max", "min"):
        got = segment_reduce(torch.from_numpy(v).to(dev), torch.from_numpy(ids).to(dev), 8, op)
        want = segment_reduce(torch.from_numpy(v), torch.from_numpy(ids), 8, op)
        check(torch.equal(bits(got.cpu()), bits(want)), f"segment_reduce {op}: card != plain route")
        reduce_ops[op] = True
    emit("kernels_vs_plain_ragged", card, kernels=[
        {"name": "segment_sum", "cases": len(kernel_cases.SEGSUM_CASES), "match": True,
         "max_abs_err": k6_err, "shapes": [list(c[1:]) for c in kernel_cases.SEGSUM_CASES]},
    ], segment_reduce_equals_plain_route=reduce_ops)

    # -- 18. the main path: packed ragged batches through the continuous batcher --
    rng = np.random.default_rng(17)
    sizes = [int(n) for n in rng.integers(RAGGED_POINTS[0], RAGGED_POINTS[1] + 1, RAGGED_CLOUDS)]
    clouds = [next(iter(SyntheticPointCloudSource(1, points=n, seed=40 + i))).data
              for i, n in enumerate(sizes)]
    biases = [rng.standard_normal((1, 4)).astype(np.float32) for _ in sizes]
    model = PoolModel("cuda")
    solo_calls = [0]

    def counted_infer_fn(inputs):
        solo_calls[0] += 1
        return model.infer_fn(inputs)

    repo = ModelRepository()
    repo.register(pool_spec(), counted_infer_fn, ragged_fn=model.ragged_fn)
    inner = CUDAChannel(repo)
    inner.register_channel()
    cont = ContinuousBatchingChannel(inner, max_batch=RAGGED_CLOUDS)
    burst_chan = ContinuousBatchingChannel(inner, max_batch=RAGGED_CLOUDS, pipeline_depth=1)

    def requests():
        return [InferRequest("pool", {"points": c, "bias": b}, request_id=str(i))
                for i, (c, b) in enumerate(zip(clouds, biases))]

    def packed_group():
        reqs = requests()
        futs = [concurrent.futures.Future() for _ in reqs]
        cont._run_ragged_group([(None, r, f) for r, f in zip(reqs, futs)])
        return [f.result(timeout=120.0).outputs["pooled"] for f in futs]

    try:
        packed_group()  # warm-up, not counted
        inner.do_inference(requests()[0])
        burst(burst_chan, requests())
        torch.cuda.synchronize()
        base_cont, base_burst = cont.stats(), burst_chan.stats()
        for counter in counters:
            counter.reset()
        solo_calls[0] = 0
        packed = packed_group()
        group_solo_calls = solo_calls[0]
        group_launches = gpu_segment.launches.count
        burst_out, _, _ = burst(burst_chan, requests())
        launches = {"segment_sum": gpu_segment.launches.count}
        all_launches = [c.count for c in counters[:-1]]  # each kernel once
        burst_solo_calls = solo_calls[0] - group_solo_calls
        s_cont, s_burst = cont.stats(), burst_chan.stats()
    finally:
        cont.close()
        burst_chan.close()
    keys = ("ragged_batches", "ragged_segments", "ragged_rows", "ragged_pad_rows",
            "ragged_fallbacks", "merge_fallbacks", "kernel_failures")
    group_stats = {k: s_cont[k] - base_cont[k] for k in keys}
    burst_stats = {k: s_burst[k] - base_burst[k] for k in keys}
    occ = {k: v - base_burst["merge_occupancy"].get(k, 0)
           for k, v in s_burst["merge_occupancy"].items()
           if v > base_burst["merge_occupancy"].get(k, 0)}
    lone, packs = occ.get(1, 0), sum(v for k, v in occ.items() if k > 1)
    layout = RaggedLayout(tuple(sizes))
    check(group_stats["ragged_batches"] == 1, f"the packed group counted {group_stats}")
    check(group_stats["ragged_rows"] == layout.total and group_stats["ragged_segments"] == 8,
          f"the packed group's stats {group_stats}")
    check(group_solo_calls == 0, f"infer_fn ran {group_solo_calls} times in the packed group")
    for label, st in (("packed group", group_stats), ("burst", burst_stats)):
        fell = {k: st[k] for k in ("ragged_fallbacks", "merge_fallbacks", "kernel_failures")}
        check(not any(fell.values()), f"the {label} fell back or failed: {fell}")
    check(group_launches == 1, f"segment_sum launched {group_launches} times for 1 packed group")
    check(burst_stats["ragged_batches"] >= 1, f"the burst never packed: {burst_stats}")
    # no silent fallback: lone groups ran solo, every larger group packed
    check(burst_stats["ragged_batches"] == packs and burst_solo_calls == lone,
          f"burst groups {occ}: {burst_stats['ragged_batches']} packed, {burst_solo_calls} solo")
    check(launches["segment_sum"] == group_stats["ragged_batches"] + burst_stats["ragged_batches"],
          f"segment_sum launched {launches['segment_sum']} times for "
          f"{group_stats['ragged_batches'] + burst_stats['ragged_batches']} packed batches")
    check(sum(all_launches) == launches["segment_sum"],
          "another kernel launched on the ragged path")
    for o in packed + [r.outputs["pooled"] for r in burst_out]:
        check(o.shape == (4,) and bool(np.isfinite(o).all()), "non-finite or misshapen pooled")
    emit("main_path_ragged", card, model="pool", clouds=RAGGED_CLOUDS, points=sizes,
         packed_rows=layout.padded_rows, live_rows=layout.total, seg_bucket=layout.seg_bucket,
         requests={"packed_group": RAGGED_CLOUDS, "burst": RAGGED_CLOUDS},
         launches=launches, packed_group_stats=group_stats, burst_stats=burst_stats,
         burst_merge_occupancy=occ, infer_fn_calls={"packed_group": group_solo_calls,
                                                    "burst": burst_solo_calls},
         pad_fraction={"packed_group": s_cont["pad_fraction"], "burst": s_burst["pad_fraction"]})

    # -- 19. kernel 6 on the main path's own rows; members against float64 -------
    ids = torch.from_numpy(layout.segment_ids).to(dev)
    with torch.no_grad():
        feat = torch.tanh(torch.from_numpy(pack_rows(clouds, layout)).to(dev)
                          @ torch.from_numpy(POOL_W).to(dev))
    segsum_match(feat, ids, layout.launch_segments, "main path")
    w64 = POOL_W.astype(np.float64)
    solo = [inner.do_inference(r).outputs["pooled"] for r in requests()]
    cpu_repo = ModelRepository()
    cpu_model = PoolModel("cpu")
    cpu_repo.register(pool_spec(), cpu_model.infer_fn, ragged_fn=cpu_model.ragged_fn)
    cpu_cont = ContinuousBatchingChannel(CUDAChannel(cpu_repo, "cpu"))
    try:
        reqs = requests()
        futs = [concurrent.futures.Future() for _ in reqs]
        cpu_cont._run_ragged_group([(None, r, f) for r, f in zip(reqs, futs)])
        cpu_packed = [f.result(timeout=300.0).outputs["pooled"] for f in futs]
    finally:
        cpu_cont.close()
    worst = {"packed": 0.0, "solo": 0.0, "card_vs_cpu": 0.0}
    for i, (c, b) in enumerate(zip(clouds, biases)):
        terms = np.tanh(c.astype(np.float64) @ w64)
        want, bound = terms.sum(0) + b[0], 1e-6 * np.abs(terms).sum(0)
        for name, got in (("packed", packed[i]), ("solo", solo[i]),
                          ("card_vs_cpu", cpu_packed[i] - packed[i] + want)):
            ratio = float((np.abs(got - want) / bound).max())
            check(ratio <= 1.0, f"cloud {i} ({name}) is {ratio} x the float64 bound off")
            worst[name] = max(worst[name], ratio)
    emit("check_ragged", card, kernel_equals_plain_on_main_path=True,
         packed_rows=int(feat.shape[0]), bound="1e-6 x sum|tanh(points @ W)| per column",
         worst_error_over_bound=worst)

    # -- 20. times on the card's clock ---------------------------------------------
    s = layout.launch_segments

    def k6():
        return gpu_segment.segment_sum(feat, ids, s)

    k6_call_ms = cuda_ms(k6, reps=200)
    k6_ms = kernel_device_ms(k6, gpu_segment.launches)
    k6_plain_ms = cuda_ms(lambda: gpu_segment.segment_sum_reference(feat, ids, s), reps=3,
                          warmup=1)
    # its one launch's device time, as torch.profiler reports it; fails if
    # the profiler does not see the kernel by its name
    k6_passes = pass_split(k6, "segment_sum", passes=("chunks_fold",))
    total = layout.total  # index_add_ refuses the pad id: the pad rows are sliced off
    lib_ids, lib_v = ids[:total], feat[:total]

    def library():
        return torch.zeros((s, feat.shape[1]), device=dev).index_add_(0, lib_ids, lib_v)

    library_ms = cuda_ms(library, reps=200)
    # index_add_ adds with atomics in any order: held to the bound of a
    # sum of n terms in any order, (n - 1) x 2^-24 x sum|v|, n the rows
    lib_bound = (total * 2.0**-24) * torch.zeros((s, 4), device=dev).index_add_(
        0, lib_ids, lib_v.abs())
    check(bool(((library() - k6()).abs() <= lib_bound).all()), "index_add_ disagrees")
    # every row's id read once, the kept rows' values read once, the sums
    # written once; the pad rows' values are never needed
    k6_bytes = feat.shape[0] * 4 + total * feat.shape[1] * 4 + s * feat.shape[1] * 4
    k6_ops = total * feat.shape[1]  # one add a kept value
    k6_bound, k6_by = roofline(k6_bytes, k6_ops)

    burst_chan = ContinuousBatchingChannel(inner, max_batch=RAGGED_CLOUDS, pipeline_depth=1)
    try:
        burst(burst_chan, requests())  # warm-up
        lat, wall = [], 0.0
        for _ in range(RAGGED_ROUNDS):
            _, ls, w = burst(burst_chan, requests())
            lat += ls
            wall += w
        bs = burst_chan.stats()
    finally:
        burst_chan.close()
    check(bs["ragged_fallbacks"] == 0 and bs["kernel_failures"] == 0,
          f"a timed burst fell back or failed: {bs['ragged_fallbacks']} fallbacks, "
          f"{bs['kernel_failures']} kernel failures")
    batched = {"clouds_per_s": len(lat) / wall, "p50_ms": float(np.median(lat)) * 1e3,
               "requests": len(lat), "ragged_batches": bs["ragged_batches"],
               "ragged_fallbacks": bs["ragged_fallbacks"],
               "merge_occupancy": bs["merge_occupancy"]}
    solo_e2e = serve(inner.do_inference, requests(), RAGGED_ROUNDS * RAGGED_CLOUDS,
                     "clouds_per_s")
    emit("times_ragged", card, kernel_ms={"segment_sum": k6_ms},
         call_ms={"segment_sum": k6_call_ms}, plain_ms={"segment_sum": k6_plain_ms},
         library_ms={"segment_sum": library_ms},
         library_call="torch.zeros(S, F).index_add_(0, ids[:total], v[:total])",
         bound_ms={"segment_sum": k6_bound}, bound_by={"segment_sum": k6_by},
         passes=k6_passes,
         bytes=k6_bytes, ops=k6_ops, rows=int(feat.shape[0]), live_rows=total, segments=s,
         features=int(feat.shape[1]),
         in_process={"batcher_burst_of_8": batched, "solo_channel_one_caller": solo_e2e})

    return [
        {"name": "segment_sum", "route": "cuda",
         "source": "triton_client_tpu_torch/csrc/segment_sum.cu",
         "replaces": "triton_client_tpu/parallel/ragged_kernels.py:220",
         "launches": launches["segment_sum"], "max_abs_err": k6_err, "match": True,
         "ms": k6_ms, "call_ms": k6_call_ms, "plain_ms": k6_plain_ms, "bound_ms": k6_bound,
         "bound_by": k6_by, "passes_us": k6_passes["us"], "library_ms": library_ms,
         "card": card},
    ]


def run_dense_batched(card: str, counters, repo, channel, frames: np.ndarray) -> None:
    """Phase 21: YOLOv5n 512^2 through the continuous batcher's dense merged
    path (``repo`` and ``channel`` serve phase 3's models, ``frames`` are
    its frames). No kernel-6 launch may happen here."""
    import concurrent.futures

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.ops import gpu_decode, gpu_segment
    from triton_client_tpu_torch.runtime.continuous import ContinuousBatchingChannel

    name = "yolov5n_c005"  # conf 0.05: every frame keeps detections, kernel 1 runs
    singles = [frames[i:i + 1] for i in range(B_MAIN)]
    stacked = np.concatenate(singles)
    direct = channel.do_inference(InferRequest(name, {"images": stacked})).outputs
    cont = ContinuousBatchingChannel(CUDAChannel(repo), max_batch=B_MAIN)
    try:
        for counter in counters:
            counter.reset()
        futs = [concurrent.futures.Future() for _ in singles]
        cont._run_group([(None, InferRequest(name, {"images": f}), fut)
                         for f, fut in zip(singles, futs)])
        merged = [fut.result(timeout=120.0).outputs for fut in futs]
        white_box = cont.stats()
        # one caller at a time: each frame is a group of one (batch 1)
        solo = [cont.do_inference(InferRequest(name, {"images": f})).outputs for f in singles]
        # 8 callers at once: the dispatcher merges what has queued
        burst_out, _, _ = burst(cont, [InferRequest(name, {"images": f}) for f in singles])
        stats = cont.stats()
        launches = {"decode_nms_2d": gpu_decode.launches.count,
                    "segment_sum": gpu_segment.launches.count}
    finally:
        cont.close()
    check(white_box["padded_frames"] == 0, "the white-box group of 8 was padded")
    fell = {k: stats[k] for k in ("merge_fallbacks", "kernel_failures")}
    check(not any(fell.values()), f"a merged YOLOv5n group fell back or failed: {fell}")
    check(launches["segment_sum"] == 0, "segment_sum launched on the dense path")
    check(launches["decode_nms_2d"] == 1 + stats["merges"],
          f"decode_nms_2d launched {launches['decode_nms_2d']} times for {1 + stats['merges']} "
          f"device calls")
    occ = stats["merge_occupancy"]
    check(sum(k * v for k, v in occ.items()) == 2 * B_MAIN, f"merge occupancy {occ}")
    kept = []
    top_err = 0.0
    for i, m in enumerate(merged):
        for key in ("detections", "valid"):
            check(m[key].tobytes() == direct[key][i:i + 1].tobytes(),
                  f"frame {i}: merged {key} differ from the direct stacked call")
        kept.append(int(m["valid"].sum()))
        # other batch sizes may take other cuDNN algorithms: phase 4's bar
        for o in (solo[i], burst_out[i].outputs):
            check(int(o["valid"].sum()) == kept[-1], f"frame {i}: kept count differs at batch "
                  f"{o['valid'].shape[0]}")
            err = float(np.abs(o["detections"][0, :5] - direct["detections"][i, :5]).max())
            top_err = max(top_err, err)
            check(np.allclose(o["detections"][0, :5], direct["detections"][i, :5], rtol=1e-2,
                              atol=1e-2), f"frame {i}: top rows differ by {err}")
    check(min(kept) > 0, "a frame kept no detection")
    emit("dense_batched_2d", card, model=name, input_hw=[512, 512], frames=B_MAIN,
         merged_equals_direct_bitwise=True, kept=kept, solo_and_burst_top5_max_abs_err=top_err,
         merge_occupancy=occ, padded_frames=stats["padded_frames"],
         pad_fraction=stats["pad_fraction"], live_bucket_table=stats["live_bucket_table"],
         launches=launches, **fell)


def request_profile(run, requests: int) -> dict:
    """``device_profile`` plus the device ops the host issued a request:
    the CUDA runtime calls that launch device work (``LAUNCH_APIS``: a
    captured request's ``cudaGraphLaunch`` and the copies around it, an
    eager request's every kernel), counted by torch.profiler."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(requests):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    device_ops = [e for e in events if e.device_type.name == "CUDA"]
    check(len(device_ops) > 0, "torch.profiler saw no device op")
    device_s = sum(e.device_time_total for e in device_ops) / 1e6
    issued: dict[str, int] = {}
    for e in events:
        if e.device_type.name == "CPU" and e.name in LAUNCH_APIS:
            issued[e.name] = issued.get(e.name, 0) + 1
    return {"requests": requests, "wall_ms_per_request": wall / requests * 1e3,
            "device_ms_per_request": device_s / requests * 1e3,
            "device_busy_share": device_s / wall, "device_ops_per_request": len(device_ops) / requests,
            "host_issued_ops_per_request": sum(issued.values()) / requests,
            "host_issued_by_call": {k: v / requests for k, v in sorted(issued.items())}}


def run_graphs(card: str, dev: torch.device, counters) -> None:
    """Phases 22-23: each served path's CUDA graph against its eager body
    (``runtime/graphs``), then eager against captured through
    ``CUDAChannel`` on the same requests."""
    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.pipelines.detect3d import prepare_points

    def on_card_2d(batch):
        return (torch.from_numpy(batch).to(dev),)

    def on_card_3d(pc, pipe):
        padded, m = prepare_points(pc, pipe.model.cfg.voxel.point_features,
                                   pipe.config.point_buckets)
        return (torch.from_numpy(padded).to(dev), torch.tensor(m, dtype=torch.int32).to(dev))

    def request_3d(name, pc, pipe):
        padded, m = prepare_points(pc, pipe.model.cfg.voxel.point_features,
                                   pipe.config.point_buckets)
        return InferRequest(name, {"points": padded, "num_points": np.asarray(m, np.int32)})

    frames = SERVED["yolov5n"]["frames"]
    paths = []  # (label, model, route override, (input a, input b), requests a, b)
    for b in (1, B_MAIN):
        pair = (frames[:b], frames[B_MAIN + B_MAIN: B_MAIN + B_MAIN + b])
        # conf 0.05: 300 detections an image, so two inputs give two results;
        # the unfused route as deployed (the fixpoint, a loop the capture
        # cuts, runtime/graphs.fixed_point) and with kernel 2
        for model_name, route in (("yolov5n_c005", None), ("yolov5n_c005_unfused", None),
                                  ("yolov5n_c005_unfused", "pallas")):
            pipe = SERVED["yolov5n"]["pipes"][model_name][0]
            paths.append((f"{model_name}{'_pallas' if route else ''}_b{b}", "yolov5n", model_name,
                          route, tuple(on_card_2d(x) for x in pair),
                          tuple(InferRequest(model_name, {"images": x}) for x in pair)))
    for family in ("pointpillars", "second_iou"):
        served = SERVED[family]
        for model_name, (pipe, _, _) in served["pipes"].items():
            for n in SCAN_POINTS:
                pair = served["scans"][n][:2]
                paths.append((f"{model_name}_{n}", family, model_name, None,
                              tuple(on_card_3d(pc, pipe) for pc in pair),
                              tuple(request_3d(model_name, pc, pipe) for pc in pair)))

    # -- 22. the captured graph against the eager body ---------------------------
    rows = {}
    for label, family, model_name, route, (a, b), (req_a, req_b) in paths:
        served = SERVED[family]
        pipe = served["pipes"][model_name][0]
        if route:
            os.environ["TRITON_CLIENT_TPU_NMS"] = route
        try:
            pipe._jit(*a)  # captured already at registration; a no-op capture check
            torch.cuda.synchronize()
            before = [c.count for c in counters]
            eager_a = pipe.run(*a)
            torch.cuda.synchronize()
            per_call = [c.count - x for c, x in zip(counters, before)]
            eager_b = pipe.run(*b)
            captures_before = pipe.graph_stats()["captures"]
            torch.cuda.synchronize()
            before = [c.count for c in counters]
            got = [pipe._jit(*a) for _ in range(GRAPH_REPLAYS)]
            torch.cuda.synchronize()
            replayed = [c.count - x for c, x in zip(counters, before)]
            got_b = pipe._jit(*b)
            check(pipe.graph_stats()["captures"] == captures_before,
                  f"{label}: a request captured a graph after the registration warmup")
            check(replayed == [GRAPH_REPLAYS * n for n in per_call],
                  f"{label}: {GRAPH_REPLAYS} replays launched {replayed}, eager once {per_call}")
            for out in got:
                check(all(torch.equal(bits(g) if g.dtype == torch.float32 else g,
                                      bits(e) if e.dtype == torch.float32 else e)
                          for g, e in zip(out, eager_a)),
                      f"{label}: the captured call differs from the eager body")
            check(all(torch.equal(bits(g) if g.dtype == torch.float32 else g,
                                  bits(e) if e.dtype == torch.float32 else e)
                      for g, e in zip(got_b, eager_b)),
                  f"{label}: a replay on a second input did not give that input's result")
            check(not all(torch.equal(x, y) for x, y in zip(eager_a, eager_b)),
                  f"{label}: the two inputs give the same result; the check shows nothing")
            # two requests in flight at pipeline_depth 2, resolved in reverse
            channel = served["channel"]
            check(channel.pipeline_depth == 2, "the channel is not at pipeline_depth 2")
            fut_a = channel.do_inference_async(req_a)
            fut_b = channel.do_inference_async(req_b)
            out_b, out_a = fut_b.result().outputs, fut_a.result().outputs
            for out, eager, which in ((out_a, eager_a, "first"), (out_b, eager_b, "second")):
                for key, want in zip(("detections", "valid"), eager):
                    check(out[key].tobytes() == want.cpu().numpy().tobytes(),
                          f"{label}: the {which} of two requests in flight got other {key}")
        finally:
            os.environ.pop("TRITON_CLIENT_TPU_NMS", None)
        rows[label] = {"launches_per_call": {c_name: n for c_name, n in
                                             zip(COUNTER_NAMES, per_call) if n},
                       "replays": GRAPH_REPLAYS, "bitwise": True, "second_input": True,
                       "two_in_flight_reversed": True}
    models = {}
    for family in ("yolov5n", "pointpillars", "second_iou"):
        for model_name, (pipe, _, _) in SERVED[family]["pipes"].items():
            models[model_name] = pipe.graph_stats()
    emit("graphs", card, paths=rows, graphs_by_model=models,
         pool_bytes_total=sum(m["pool_bytes"] for m in models.values()),
         reserved_bytes=torch.cuda.memory_reserved(dev))

    # -- 23. eager against captured through the channel, same requests ----------
    times = {}
    for label, family, model_name, route, _, (req_a, req_b) in paths:
        served = SERVED[family]
        pipe, spec, _ = served["pipes"][model_name]
        eager_name = f"{model_name}_eager"
        try:
            served["repo"].get(eager_name)
        except KeyError:  # the eager body served as the model's infer_fn
            served["repo"].register(dataclasses.replace(spec, name=eager_name), pipe.device_fn())
        if route:
            os.environ["TRITON_CLIENT_TPU_NMS"] = route
        try:
            reps = GRAPH_REQUESTS_2D if family == "yolov5n" else GRAPH_REQUESTS_3D
            unit = "frames_per_s" if family == "yolov5n" else "scans_per_s"
            size = (lambda r: r.inputs["images"].shape[0]) if family == "yolov5n" else (lambda r: 1)
            row = {}
            for mode, name in (("eager", eager_name), ("captured", model_name), ("eager2", eager_name),
                               ("captured2", model_name)):
                reqs = [dataclasses.replace(r, model_name=name) for r in (req_a, req_b)]
                row[mode] = serve(served["channel"].do_inference, reqs, reps, unit, size)
            if label in ("yolov5n_c005_b1", f"pointpillars_{SCAN_POINTS[1]}"):
                for mode, name in (("eager", eager_name), ("captured", model_name)):
                    req = dataclasses.replace(req_a, model_name=name)
                    row[f"profile_{mode}"] = request_profile(
                        lambda: served["channel"].do_inference(req), PROFILE_REQUESTS)
        finally:
            os.environ.pop("TRITON_CLIENT_TPU_NMS", None)
        times[label] = row
    emit("times_graphs", card, requests_per_mode=[GRAPH_REQUESTS_2D, GRAPH_REQUESTS_3D],
         paths=times)


COUNTER_NAMES = ("decode_nms_2d", "greedy_nms", "residual_decode_3d", "suppress_pack_3d",
                 "segment_mean", "segment_sum", "residual_decode_3d_gathered")


def run_driver(card: str) -> None:
    """Phase 24: ``InferenceDriver`` over ``CUDAChannel`` on seeded 512^2
    frames (YOLOv5n) and seeded clouds (PointPillars): sync, ``--async``
    with 2 in flight, and batch 8 (2D)."""
    from triton_client_tpu_torch.drivers.driver import (
        InferenceDriver,
        channel_infer,
        channel_infer3d,
    )
    from triton_client_tpu_torch.io.sources import SyntheticImageSource, SyntheticPointCloudSource

    class Recording:
        def __init__(self):
            self.rows = {}

        def write(self, frame, result):
            self.rows[frame.frame_id] = {k: np.asarray(v) for k, v in result.items()}

        def close(self):
            pass

    def drive(infer, source, **kw):
        sink = Recording()
        stats = InferenceDriver(infer, source, sink=sink, warmup=1, **kw).run()
        return stats, sink.rows

    out = {}
    channel = SERVED["yolov5n"]["channel"]
    name = "yolov5n_c005"  # 300 detections an image
    source = SyntheticImageSource(DRIVER_FRAMES, (512, 512), seed=24)
    runs = {
        "sync": drive(channel_infer(channel, name), source),
        "async_inflight2": drive(channel_infer(channel, name, asynchronous=True), source,
                                 inflight=2),
        "batch8": drive(channel_infer(channel, name), source, batch_size=B_MAIN),
    }
    sync = runs["sync"][1]
    check(len(sync) == DRIVER_FRAMES, f"the sync run delivered {len(sync)} frames")
    for mode, (stats, rows) in runs.items():
        check(stats.frames == DRIVER_FRAMES and sorted(rows) == sorted(sync),
              f"{mode}: {stats.frames} frames, ids {sorted(rows)[:4]}...")
    for i, row in runs["async_inflight2"][1].items():
        for key in ("detections", "valid"):
            check(row[key].tobytes() == sync[i][key].tobytes(),
                  f"frame {i}: the async run's {key} differ from the sync run's")
    b8_err, live, other_keep = 0.0, 0, []
    for i, row in runs["batch8"][1].items():
        if not np.array_equal(row["valid"], sync[i]["valid"]):
            other_keep.append(i)
            continue
        rows_b8, rows_b1 = row["detections"][row["valid"]], sync[i]["detections"][sync[i]["valid"]]
        live += len(rows_b1)
        if len(rows_b1):
            b8_err = max(b8_err, float(np.abs(rows_b8 - rows_b1).max()))
    print(json.dumps({"batch8_vs_batch1": {"frames_keeping_other_rows": other_keep,
                                           "max_abs_err": b8_err, "live_rows": live}}), flush=True)
    check(not other_keep, f"frames {other_keep}: batch 8 keeps other rows than batch 1")
    check(b8_err <= 1e-5, f"batch 8 differs from batch 1 by {b8_err} on a live row")
    out[name] = {m: {**st.to_dict(), "detections": int(sum(r["valid"].sum() for r in rows.values()))}
                      for m, (st, rows) in runs.items()}
    out[name]["async_equals_sync_bitwise"] = True
    out[name]["batch8_vs_batch1_max_abs_err"] = b8_err
    out[name]["live_rows"] = live

    channel = SERVED["pointpillars"]["channel"]
    source = SyntheticPointCloudSource(DRIVER_CLOUDS, seed=24)
    runs = {
        "sync": drive(channel_infer3d(channel, "pointpillars"), source),
        "async_inflight2": drive(channel_infer3d(channel, "pointpillars", asynchronous=True),
                                 source, inflight=2),
    }
    sync = runs["sync"][1]
    check(len(sync) == DRIVER_CLOUDS, f"the sync run delivered {len(sync)} clouds")
    for i, row in runs["async_inflight2"][1].items():
        for key in ("pred_boxes", "pred_scores", "pred_labels"):
            check(row[key].tobytes() == sync[i][key].tobytes(),
                  f"cloud {i}: the async run's {key} differ from the sync run's")
    out["pointpillars"] = {m: {**st.to_dict(), "detections": int(sum(len(r["pred_scores"])
                                                                    for r in rows.values()))}
                           for m, (st, rows) in runs.items()}
    out["pointpillars"]["async_equals_sync_bitwise"] = True
    emit("driver", card, frames=DRIVER_FRAMES, frame_hw=[512, 512], clouds=DRIVER_CLOUDS, **out)


# phase 25: the disk repository's entries (configs only); the YOLOv5n entry
# is served twice, as it stands (conf 0.3) and at conf 0.05 (detections on
# random weights); requests a timed path, requests of the stream
FACADE_ENTRIES = ("yolov5_crop_base", "pointpillar_kitti", "second_iou")
FACADE_C005 = "yolov5_crop_base_c005"
FACADE_REQUESTS, FACADE_STREAM = 30, 8


def facade_repository(tmp: pathlib.Path) -> pathlib.Path:
    """A repository root holding copies of the three portable entries'
    ``config.yaml`` and the conf-0.05 YOLOv5n entry derived from one."""
    for name in FACADE_ENTRIES:
        (tmp / name).mkdir()
        (tmp / name / "config.yaml").write_bytes(
            (ROOT / "examples" / name / "config.yaml").read_bytes())
    text = (ROOT / "examples" / FACADE_ENTRIES[0] / "config.yaml").read_text()
    check("conf_thresh: 0.3" in text, "examples/yolov5_crop_base changed its conf_thresh")
    (tmp / FACADE_C005).mkdir()
    (tmp / FACADE_C005 / "config.yaml").write_text(
        text.replace("conf_thresh: 0.3", "conf_thresh: 0.05"))
    return tmp


def run_facade(card: str, counters) -> None:
    """Phase 25: the KServe v2 façade. ``scan_disk`` builds the disk
    repository (its YAML read by ``yaml_subset``), ``CUDAChannel`` serves it
    with each entry's graphs captured at registration, and the server's
    ``_Servicer`` answers every RPC in-process on request bytes
    (``channel/kserve/service.invoke``: the deserializer and serializer
    grpc would use, an ``InProcessContext``). Where ``grpc`` imports, the
    same checks run through ``InferenceServer`` on a loopback port and the
    port's ``GRPCChannel``."""
    import shutil
    import tempfile

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.channel.kserve import codec, pb, service
    from triton_client_tpu_torch.obs.trace import Tracer
    from triton_client_tpu_torch.pipelines.detect3d import prepare_points
    from triton_client_tpu_torch.runtime.disk_repository import scan_disk
    from triton_client_tpu_torch.runtime.server import _Servicer

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="facade_repo_"))
    cwd = os.getcwd()
    os.chdir(ROOT)  # the entries name data/ files relative to the checkout
    try:
        t0 = time.perf_counter()
        repo = scan_disk(facade_repository(tmp))
        for name, _ in repo.list_models():
            repo.get(name).warmup()
        build_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp)
    channel = CUDAChannel(repo)
    tracer = Tracer(capacity=4 * FACADE_REQUESTS)
    servicer = _Servicer(repo, channel, stream_pipeline_depth=2, tracer=tracer)
    names = [n for n, _ in repo.list_models()]
    check(sorted(names) == sorted(FACADE_ENTRIES + (FACADE_C005,)), f"scanned {names}")
    for name in names:
        spec = repo.metadata(name)
        check("decode_nms" in spec.extra["fused_stages"], f"{name}: not fused on the card")

    def rpc(method, msg, context=None):
        return service.METHODS[method][1].FromString(
            service.invoke(servicer, method, msg.SerializeToString(), context))

    # -- health, metadata, config, index -----------------------------------------
    check(rpc("ServerLive", pb.ServerLiveRequest()).live, "ServerLive")
    check(rpc("ServerReady", pb.ServerReadyRequest()).ready, "ServerReady")
    meta = rpc("ServerMetadata", pb.ServerMetadataRequest())
    check(meta.name == "triton_client_tpu_torch" and "binary_tensor_data" in meta.extensions,
          "ServerMetadata")
    index = rpc("RepositoryIndex", pb.RepositoryIndexRequest())
    check(sorted((m.name, m.version, m.state) for m in index.models)
          == sorted((n, "1", "READY") for n in names), "RepositoryIndex")
    configs = {}
    for name in names:
        check(rpc("ModelReady", pb.ModelReadyRequest(name=name)).ready, f"ModelReady {name}")
        md = rpc("ModelMetadata", pb.ModelMetadataRequest(name=name))
        spec = repo.metadata(name)
        check([t.name for t in md.inputs] == [t.name for t in spec.inputs]
              and md.platform == "torch", f"ModelMetadata {name}")
        cfg = rpc("ModelConfig", pb.ModelConfigRequest(name=name)).config
        params = {k: json.loads(v) for k, v in cfg.parameters.items()}
        check(params == json.loads(json.dumps(spec.extra)), f"ModelConfig parameters {name}")
        configs[name] = {"max_batch_size": cfg.max_batch_size,
                         "inputs": [list(t.dims) for t in cfg.input]}
    check(not rpc("ModelReady", pb.ModelReadyRequest(name="nope")).ready, "ModelReady nope")

    # -- the requests ----------------------------------------------------------------
    rng = np.random.default_rng(25)
    hw = tuple(repo.metadata(FACADE_C005).extra["model_input_hw"])
    frames = rng.integers(0, 256, (B_MAIN + FACADE_STREAM + 1, *hw, 3)).astype(np.float32)
    requests = {  # label -> (model, inputs)
        "yolov5n_c005_b1": (FACADE_C005, {"images": frames[:1]}),
        f"yolov5n_c005_b{B_MAIN}": (FACADE_C005, {"images": frames[1:1 + B_MAIN]}),
        "yolov5n_conf0.3_b1": (FACADE_ENTRIES[0], {"images": frames[:1]}),
    }
    for model in FACADE_ENTRIES[1:]:
        pipe_cfg = repo.metadata(model).extra
        for i, n in enumerate(SCAN_POINTS):
            pc = uniform_clouds(250 + i, (0.0, -39.68, -3.0, 69.12, 39.68, 1.0), n, 1)[0]
            padded, m = prepare_points(pc, 4, pipe_cfg["point_buckets"], pipe_cfg["z_offset"])
            requests[f"{model}_{n}"] = (model, {"points": padded,
                                                "num_points": np.asarray(m, np.int32)})
    stream_frames = [frames[1 + B_MAIN + i: 2 + B_MAIN + i] for i in range(FACADE_STREAM)]

    def wire(model, inputs, rid=""):
        return codec.build_infer_request(model, inputs, request_id=rid).SerializeToString()

    def through_servicer(payload):
        return codec.parse_infer_response(pb.ModelInferResponse.FromString(
            service.invoke(servicer, "ModelInfer", payload)))

    # the direct channel's answers, and one uncounted pass through the
    # servicer (any capture happens here, outside the counted window)
    direct = {label: channel.do_inference(InferRequest(m, x)).outputs
              for label, (m, x) in requests.items()}
    direct_stream = [channel.do_inference(InferRequest(FACADE_C005, {"images": f})).outputs
                     for f in stream_frames]
    payloads = {label: wire(m, x, label) for label, (m, x) in requests.items()}
    for payload in payloads.values():
        through_servicer(payload)
    torch.cuda.synchronize()

    # -- the counted window: ModelInfer and ModelStreamInfer through the servicer -----
    for counter in counters:
        counter.reset()
    got = {label: through_servicer(p) for label, p in payloads.items()}
    stream_out = [pb.ModelStreamInferResponse.FromString(b) for b in service.invoke(
        servicer, "ModelStreamInfer",
        [wire(FACADE_C005, {"images": f}, f"s{i}") for i, f in enumerate(stream_frames)])]
    torch.cuda.synchronize()
    launches = dict(zip(COUNTER_NAMES, (c.count for c in counters)))
    fused_2d = 3 + FACADE_STREAM
    scans_3d = 2 * len(SCAN_POINTS)
    want_launches = {"decode_nms_2d": fused_2d, "greedy_nms": 0,
                     "residual_decode_3d": scans_3d, "suppress_pack_3d": scans_3d,
                     "segment_mean": len(SCAN_POINTS), "segment_sum": 0,
                     "residual_decode_3d_gathered": scans_3d}
    check(launches == want_launches, f"façade launches {launches}, want {want_launches}")

    for label, out in got.items():
        want = direct[label]
        check(sorted(out) == sorted(want), f"{label}: outputs {sorted(out)}")
        for key in want:
            check(out[key].dtype == want[key].dtype and out[key].shape == want[key].shape
                  and out[key].tobytes() == want[key].tobytes(),
                  f"{label}: {key} through the servicer differs from CUDAChannel.do_inference")
        check(bool(np.isfinite(out["detections"]).all()), f"{label}: non-finite detections")
    kept = {label: int(out["valid"].sum()) for label, out in got.items()}
    check(kept["yolov5n_c005_b1"] > 0 and kept[f"yolov5n_c005_b{B_MAIN}"] > 0,
          f"conf 0.05 kept nothing: {kept}")
    check(all(v > 0 for k, v in kept.items() if not k.startswith("yolov5n")), f"3D kept {kept}")
    check(len(stream_out) == FACADE_STREAM, f"{len(stream_out)} stream responses")
    for i, (resp, want) in enumerate(zip(stream_out, direct_stream)):
        check(not resp.error_message, f"stream {i}: {resp.error_message}")
        check(resp.infer_response.id == f"s{i}", f"stream response {i} is {resp.infer_response.id}")
        out = codec.parse_infer_response(resp.infer_response)
        check(all(out[k].tobytes() == want[k].tobytes() for k in want),
              f"stream response {i} is not its request's result")
    check(any(stream_out[0].infer_response.raw_output_contents[0] != r.infer_response
              .raw_output_contents[0] for r in stream_out[1:]),
          "the stream's requests all give one result; the order check shows nothing")

    # -- errors ------------------------------------------------------------------------
    codes = {}
    for label, payload in (
        ("unknown_model", wire("nope", {"images": frames[:1]})),
        ("wrong_shape", wire(FACADE_C005, {"images": frames[:1, :, :, :2]})),
    ):
        ctx = service.InProcessContext()
        try:
            service.invoke(servicer, "ModelInfer", payload, ctx)
        except service.RpcAborted:
            pass
        codes[label] = ctx.aborted[0] if ctx.aborted else "OK"
    check(codes == {"unknown_model": "NOT_FOUND", "wrong_shape": "INVALID_ARGUMENT"},
          f"status codes {codes}")

    # -- times: servicer against the direct channel, on the same requests ------------
    times = {}
    for label, unit, size in (("yolov5n_c005_b1", "frames_per_s", lambda r: 1),
                              (f"pointpillar_kitti_{SCAN_POINTS[1]}", "scans_per_s",
                               lambda r: 1)):
        model, inputs = requests[label]
        req = InferRequest(model, inputs)
        payload = payloads[label]
        row = {}
        for mode in ("direct", "servicer", "direct2", "servicer2"):
            call = (lambda _x: channel.do_inference(req)) if mode.startswith("direct") else (
                lambda _x: service.invoke(servicer, "ModelInfer", payload))
            row[mode] = serve(call, [None], FACADE_REQUESTS, unit, size)
        times[label] = row
    # the servicer's own host time a request: the message decode, its spans
    # outside the channel (admission, parse, encode, the span summary, the
    # accounting), the response encode
    host = {}
    for label in times:
        payload = payloads[label]
        t = time.perf_counter()
        for _ in range(FACADE_REQUESTS):
            pb.ModelInferRequest.FromString(payload)
        decode_ms = (time.perf_counter() - t) / FACADE_REQUESTS * 1e3
        resp = pb.ModelInferResponse.FromString(service.invoke(servicer, "ModelInfer", payload))
        t = time.perf_counter()
        for _ in range(FACADE_REQUESTS):
            resp.SerializeToString()
        serialize_ms = (time.perf_counter() - t) / FACADE_REQUESTS * 1e3
        traces = [tr for tr in tracer.recent() if tr.request_id == label][-FACADE_REQUESTS:]
        inside, channel_ms, spans = [], [], {}
        for tr in traces:
            ch = sum(s.duration_s for s in tr.spans if s.name == "channel")
            inside.append((tr.wall_s() - ch) * 1e3)
            channel_ms.append(ch * 1e3)
            for s in tr.spans:
                if s.name in ("parse", "encode"):
                    spans.setdefault(s.name, []).append(s.duration_s * 1e3)
        check(len(traces) >= FACADE_REQUESTS // 2, f"{label}: {len(traces)} traces kept")
        host[label] = {"decode_message_ms": decode_ms, "serialize_response_ms": serialize_ms,
                       "outside_channel_ms_p50": float(np.median(inside)),
                       "channel_ms_p50": float(np.median(channel_ms)),
                       **{f"{k}_ms_p50": float(np.median(v)) for k, v in spans.items()},
                       "servicer_host_ms": decode_ms + serialize_ms + float(np.median(inside)),
                       "request_bytes": len(payload),
                       "response_bytes": len(resp.SerializeToString())}

    # -- the socket leg ------------------------------------------------------------------
    try:
        import grpc  # noqa: F401
        grpc_ok = True
    except ImportError:
        grpc_ok = False
    socket_leg = None
    if grpc_ok:
        from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel
        from triton_client_tpu_torch.runtime.server import InferenceServer

        server = InferenceServer(repo, channel, address="127.0.0.1:0", max_workers=4)
        server.start()
        try:
            client = GRPCChannel(f"127.0.0.1:{server.port}", timeout_s=120)
            check(client.server_live() and client.server_ready(), "grpc: not live")
            for label, (m, x) in requests.items():
                out = client.do_inference(InferRequest(m, x)).outputs
                check(all(out[k].tobytes() == direct[label][k].tobytes() for k in direct[label]),
                      f"grpc {label}: differs from CUDAChannel.do_inference")
            socket_leg = {"requests_checked": len(requests)}
            for label in times:  # the timed paths, through the socket
                model, inputs = requests[label]
                req = InferRequest(model, inputs)
                socket_leg[label] = serve(lambda _x: client.do_inference(req), [None],
                                          FACADE_REQUESTS, "frames_per_s"
                                          if label.startswith("yolov5n") else "scans_per_s")
            client.close()
        finally:
            server.stop()
    emit("facade", card, build_and_capture_s=build_s, entries=names, model_configs=configs,
         requests=sorted(requests), stream=FACADE_STREAM, bitwise_equal_to_channel=True,
         kept=kept, launches=launches, status_codes=codes, times=times, servicer_host=host,
         grpc=grpc_ok, socket_leg=socket_leg)


if __name__ == "__main__":
    sys.exit(main())
