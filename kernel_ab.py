#!/usr/bin/env python3
"""Times the port's greedy-NMS kernels of several checkouts on one card, in
turns, so that two versions are compared on the same card in one run.

    python3 kernel_ab.py PARENT . . PARENT

Each argument is the root of a checkout of this repository; each runs in a
process of its own, in the order given, and builds its own kernels. One JSON
line per run: the checkout, the card's name and power limit, and the device
ms of one call of kernels 1 (``fused_decode_nms_2d``), 2 (``nms_greedy``)
and 4 (``suppress_pack_3d``), timed by ``chip_smoke.kernel_device_ms`` of
this script's own checkout, whichever checkout is timed. The inputs are
seeded ``ops/kernel_cases.py`` candidates at the main paths' shapes, every
slot valid and in score order, as the main paths hand them over: kernels 1
and 2 at B = 8, K = 1024, max_det 300; kernel 4 at B = 1, K = 256,
max_det 128 on the IoU matrix of random rotated boxes. Needs a CUDA device;
exits 2 without one.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import torch


def measure() -> dict:
    """The three kernels' device ms, for the checkout in the working
    directory."""
    import numpy as np

    from chip_smoke import kernel_device_ms  # this script's own checkout

    sys.path.insert(0, os.getcwd())  # the checkout under test
    from triton_client_tpu_torch.ops import (
        cuda_build,
        gpu_decode,
        gpu_nms,
        gpu_suppress3d,
        kernel_cases,
    )

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
    }}


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
