#!/usr/bin/env python3
"""Times the port's kernels 1, 2, 4, 5 and 6 of several checkouts on one card,
in turns, so that two versions are compared on the same card in one run.

    python3 kernel_ab.py PARENT . . PARENT

Each argument is the root of a checkout of this repository; each runs in a
process of its own, in the order given, and builds its own kernels. One JSON
line per run: the checkout, the card's name and power limit, and the device
ms of one call of kernels 1 (``fused_decode_nms_2d``), 2 (``nms_greedy``),
4 (``suppress_pack_3d``), 5 (``sorted_segment_mean``) and 6
(``segment_sum``), timed by ``chip_smoke.kernel_device_ms`` of this
script's own checkout, whichever checkout is timed. The inputs are the main
paths': for kernels 1, 2 and 4 seeded ``ops/kernel_cases.py`` candidates,
every slot valid and in score order, as the main paths hand them over
(kernels 1 and 2 at B = 8, K = 1024, max_det 300; kernel 4 at B = 1,
K = 256, max_det 128 on the IoU matrix of random rotated boxes); for kernel
5 the slot rows of ``chip_smoke.py`` phase 14's 120,000-point scan at the
KITTI SECOND grid (N = 131,072, 40,000 slots); for kernel 6 phase 19's
packed rows of 8 clouds of 20k-120k points (R = 655,360, F = 4, S = 8).
Off the main paths, from this script's own ``ops/kernel_cases.py`` (the
same inputs for every checkout): kernel 5 on its long-slot cases at N =
131,072 and 40,000 slots (``segment_mean_one_slot``: every row in one
slot; ``segment_mean_long_slot``: 512 rows in one slot among short ones),
and kernel 6 at wide rows (``segment_sum_f64``: R = 131,072, F = 64,
S = 64; ``segment_sum_f130``: F = 130, S = 64).
Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import torch


def measure() -> dict:
    """The five kernels' device ms, for the checkout in the working
    directory."""
    import numpy as np

    from chip_smoke import (  # this script's own checkout
        RAGGED_CLOUDS,
        RAGGED_POINTS,
        SCAN_POINTS,
        SECOND_SLOTS,
        kernel_device_ms,
    )

    # this script's own cases, under a name of their own, so that the
    # package imported below is the checkout's
    here = pathlib.Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location(
        "_ab_kernel_cases", here / "triton_client_tpu_torch" / "ops" / "kernel_cases.py")
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)

    sys.path.insert(0, os.getcwd())  # the checkout under test
    from triton_client_tpu_torch.io.sources import SyntheticPointCloudSource
    from triton_client_tpu_torch.models.pool import POOL_W
    from triton_client_tpu_torch.models.second import SECONDConfig
    from triton_client_tpu_torch.ops import (
        cuda_build,
        gpu_decode,
        gpu_nms,
        gpu_segment,
        gpu_suppress3d,
        gpu_voxel,
        kernel_cases,
    )
    from triton_client_tpu_torch.parallel.ragged_kernels import RaggedLayout, pack_rows
    from triton_client_tpu_torch.pipelines.detect3d import Detect3DConfig, prepare_points

    dev = torch.device("cuda")
    cuda_build.build_all()
    boxes, scores, classes, valid = kernel_cases.batch("random", 8, 1024, 2, seed=0)
    valid[:] = True
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], 1)
    scores, classes = np.take_along_axis(scores, order, 1), np.take_along_axis(classes, order, 1)
    k1 = [torch.from_numpy(a).to(dev) for a in (boxes, scores, classes.astype(np.float32), valid)]
    kw = dict(iou_thresh=0.45, max_det=300, box_format="xywh")
    c, h = k1[0][..., :2], k1[0][..., 2:] * 0.5
    k2 = (torch.cat([c - h, c + h], -1).contiguous(), k1[1])
    b3, s3, l3 = (torch.from_numpy(a)[None].to(dev)
                  for a in kernel_cases.suppress3d_inputs("random", 256, seed=60))
    iou, rows = gpu_suppress3d.sorted_candidates(b3, s3, l3)
    # kernel 5: phase 14's scan (the second of three at seed 21)
    big = [f.data for f in SyntheticPointCloudSource(3, points=SCAN_POINTS[1], seed=21)][1]
    padded, m = prepare_points(big, 4, Detect3DConfig().point_buckets)
    voxel = SECONDConfig().voxel
    assert voxel.max_voxels == SECOND_SLOTS, voxel.max_voxels
    valsT, slots, _ = gpu_voxel.slot_rows(torch.from_numpy(padded).to(dev),
                                          torch.tensor(m, dtype=torch.int32, device=dev), voxel)
    # kernel 6: phase 19's packed rows
    rng = np.random.default_rng(17)
    sizes = tuple(int(n) for n in rng.integers(RAGGED_POINTS[0], RAGGED_POINTS[1] + 1,
                                               RAGGED_CLOUDS))
    clouds = [next(iter(SyntheticPointCloudSource(1, points=n, seed=40 + i))).data
              for i, n in enumerate(sizes)]
    layout = RaggedLayout(sizes)
    ids = torch.from_numpy(layout.segment_ids).to(dev)
    feat = torch.tanh(torch.from_numpy(pack_rows(clouds, layout)).to(dev)
                      @ torch.from_numpy(POOL_W).to(dev))
    # off the main paths: kernel 5's long slots, kernel 6's wide rows
    k5_off = {kind: [torch.from_numpy(a).to(dev)
                     for a in cases.segment_inputs(kind, 131072, SECOND_SLOTS, seed=5)]
              for kind in ("one_slot", "long_slot")}
    k6_off = {f: [torch.from_numpy(a).to(dev) for a in cases.segsum_inputs(kind, 131072, f, 64)]
              for kind, f in (("layout", 64), ("out_of_range", 130))}

    def k5(v, sl):
        return kernel_device_ms(lambda: gpu_voxel.sorted_segment_mean(v, sl, SECOND_SLOTS),
                                gpu_voxel.launches)

    def k6(v, i, s):
        return kernel_device_ms(lambda: gpu_segment.segment_sum(v, i, s), gpu_segment.launches)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return {"card": smi[0], "ms": {
        "decode_nms_2d": kernel_device_ms(lambda: gpu_decode.fused_decode_nms_2d(*k1, **kw),
                                          gpu_decode.launches),
        "greedy_nms": kernel_device_ms(lambda: gpu_nms.nms_greedy(*k2, 0.45, 300),
                                       gpu_nms.launches),
        "suppress_pack_3d": kernel_device_ms(
            lambda: gpu_suppress3d.suppress_pack_3d(iou, rows, 0.01, 128),
            gpu_suppress3d.launches),
        "segment_mean": k5(valsT, slots),
        "segment_sum": k6(feat, ids, layout.launch_segments),
        "segment_mean_one_slot": k5(*k5_off["one_slot"]),
        "segment_mean_long_slot": k5(*k5_off["long_slot"]),
        "segment_sum_f64": k6(*k6_off[64], 64),
        "segment_sum_f130": k6(*k6_off[130], 64),
    }, "shapes": {"segment_mean": [8, int(slots.numel()), SECOND_SLOTS],
                  "segment_sum": [int(feat.shape[0]), int(feat.shape[1]),
                                  layout.launch_segments]}}


def main(roots: list[str]) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; nothing run", file=sys.stderr)
        return 2
    me = str(pathlib.Path(__file__).resolve())
    for root in roots:
        out = subprocess.run([sys.executable, me, "--measure"], cwd=root, capture_output=True,
                             text=True, timeout=600)
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"checkout": str(pathlib.Path(root).resolve()), **row}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--measure"]:
        print(json.dumps(measure()))
        sys.exit(0)
    sys.exit(main(sys.argv[1:] or ["."]))
