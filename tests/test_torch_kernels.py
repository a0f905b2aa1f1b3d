"""The port's two greedy-suppression kernels against the JAX package's
TPU kernels.

On the CPU each wrapper runs its plain PyTorch version, which must equal
the Pallas kernel run in interpret mode BITWISE: rows and keep for the
fused decode+NMS tail, index sequences (invalid slots included) and
valid for greedy NMS. The CUDA kernels themselves are held against the
plain versions on the card (``cuda``-marked tests here, and
``chip_smoke.py``). The JAX package is imported inside the tests that
use it, so the card's machine, which has no JAX, runs the ``cuda`` tests
with ``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from triton_client_tpu_torch.ops import cuda_build, gpu_decode, gpu_nms, kernel_cases

B = 2

# (kind, K, max_det, box_format, class_agnostic)
DECODE_CASES = [
    ("random", 1024, 300, "xywh", False),  # the main path's shapes
    ("random", 100, 32, "xyxy", True),
    ("ties", 1024, 32, "xywh", True),
    ("ties", 100, 300, "xyxy", False),
    ("all_invalid", 100, 32, "xywh", False),
    ("chain", 100, 300, "xyxy", False),
    ("large", 1024, 32, "xywh", False),
]


def _jax_decode(boxes, scores, classes, valid, max_det, fmt, agnostic):
    import jax.numpy as jnp
    from triton_client_tpu.ops.pallas_decode import fused_decode_nms_2d as jax_fused

    rows, keep = [], []
    for i in range(boxes.shape[0]):
        r, k = jax_fused(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(classes[i]),
            jnp.asarray(valid[i]), iou_thresh=0.45, max_det=max_det, box_format=fmt,
            class_agnostic=agnostic, interpret=True,
        )
        rows.append(np.asarray(r))
        keep.append(np.asarray(k))
    return np.stack(rows), np.stack(keep)


@pytest.mark.parametrize("kind,k,max_det,fmt,agnostic", DECODE_CASES)
def test_decode_nms_2d_plain_matches_tpu_kernel_bitwise(kind, k, max_det, fmt, agnostic):
    boxes, scores, classes, valid = kernel_cases.batch(kind, B, k, seed=11, box_format=fmt)
    want_rows, want_keep = _jax_decode(boxes, scores, classes, valid, max_det, fmt, agnostic)
    rows, keep = gpu_decode.decode_nms_2d_reference(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(classes),
        torch.from_numpy(valid), iou_thresh=0.45, max_det=max_det, box_format=fmt,
        class_agnostic=agnostic,
    )
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    if kind == "all_invalid":
        assert not want_keep.any()
    elif kind == "chain":
        # greedy keeps every second box of the chain
        assert want_keep.sum(1).tolist() == [50, 50]


NMS_CASES = [
    ("random", 1024, 300),
    ("ties", 1024, 300),
    ("random", 100, 32),
    ("all_invalid", 100, 32),
    ("chain", 100, 300),
]


@pytest.mark.parametrize("kind,n,max_det", NMS_CASES)
def test_nms_greedy_plain_matches_tpu_kernel(kind, n, max_det):
    import jax.numpy as jnp
    from triton_client_tpu.ops.pallas_nms import nms_pallas as jax_nms_pallas

    parts = [kernel_cases.nms_inputs(kind, n, seed=5 + i) for i in range(B)]
    boxes = np.stack([p[0] for p in parts])
    scores = np.stack([p[1] for p in parts])
    idx, valid = gpu_nms.nms_greedy_reference(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, max_det
    )
    for i in range(B):
        want_idx, want_valid = jax_nms_pallas(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.45, max_det=max_det,
            interpret=True,
        )
        # identical sequences, invalid slots (index 0) included
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(want_valid))


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    gpu_decode.launches.reset()
    gpu_nms.launches.reset()
    boxes, scores, classes, valid = kernel_cases.batch("random", B, 64, seed=3)
    args = [torch.from_numpy(a) for a in (boxes, scores, classes, valid)]
    rows, keep = gpu_decode.fused_decode_nms_2d(*args, max_det=16)
    want = gpu_decode.decode_nms_2d_reference(*args, max_det=16)
    assert torch.equal(rows, want[0]) and torch.equal(keep, want[1])
    nb, ns = kernel_cases.nms_inputs("random", 64)
    idx, val = gpu_nms.nms_greedy(torch.from_numpy(nb)[None], torch.from_numpy(ns)[None], 0.45, 16)
    want_idx, want_val = gpu_nms.nms_greedy_reference(
        torch.from_numpy(nb)[None], torch.from_numpy(ns)[None], 0.45, 16
    )
    assert torch.equal(idx, want_idx) and torch.equal(val, want_val)
    assert gpu_decode.launches.count == 0
    assert gpu_nms.launches.count == 0


def test_smem_limits():
    # the main path's K = 1024 fits with room to spare; past the 227 KB
    # a block may use, the wrappers raise on CUDA tensors
    assert gpu_decode.smem_bytes(1024) == 40960 and gpu_nms.smem_bytes(1024) == 24576
    assert gpu_decode.smem_fits(1024) and gpu_nms.smem_fits(1024)
    assert not gpu_decode.smem_fits(8192) and not gpu_nms.smem_fits(16128)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: pytest -m cuda, chip_smoke.py)")
    cuda_build.build_all()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,k,max_det,fmt,agnostic", DECODE_CASES)
def test_decode_nms_2d_kernel_matches_plain_on_card(cuda_device, kind, k, max_det, fmt, agnostic):
    arrays = kernel_cases.batch(kind, 8, k, seed=21, box_format=fmt)
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    before = gpu_decode.launches.count
    rows, keep = gpu_decode.fused_decode_nms_2d(
        *args, iou_thresh=0.45, max_det=max_det, box_format=fmt, class_agnostic=agnostic
    )
    want_rows, want_keep = gpu_decode.decode_nms_2d_reference(
        *args, iou_thresh=0.45, max_det=max_det, box_format=fmt, class_agnostic=agnostic
    )
    torch.cuda.synchronize()
    assert gpu_decode.launches.count == before + 1
    assert torch.equal(keep, want_keep)
    assert torch.equal(rows, want_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,max_det", NMS_CASES)
def test_nms_greedy_kernel_matches_plain_on_card(cuda_device, kind, n, max_det):
    parts = [kernel_cases.nms_inputs(kind, n, seed=31 + i) for i in range(8)]
    boxes = torch.from_numpy(np.stack([p[0] for p in parts])).to(cuda_device)
    scores = torch.from_numpy(np.stack([p[1] for p in parts])).to(cuda_device)
    idx, valid = gpu_nms.nms_greedy(boxes, scores, 0.45, max_det)
    want_idx, want_valid = gpu_nms.nms_greedy_reference(boxes, scores, 0.45, max_det)
    torch.cuda.synchronize()
    assert torch.equal(idx, want_idx) and torch.equal(valid, want_valid)


@pytest.mark.cuda
def test_pallas_route_past_shared_memory_raises_on_card(cuda_device, monkeypatch):
    """TRITON_CLIENT_TPU_NMS=pallas on a CUDA tensor launches the kernel
    or raises: past a block's shared memory it raises, and nothing runs."""
    from triton_client_tpu_torch.ops import nms as tnms

    n = 10000
    assert not gpu_nms.smem_fits(n)
    monkeypatch.setenv("TRITON_CLIENT_TPU_NMS", "pallas")
    boxes = torch.rand((1, n, 2), device=cuda_device).repeat(1, 1, 2)
    scores = torch.rand((1, n), device=cuda_device)
    before = gpu_nms.launches.count
    with pytest.raises(ValueError, match="shared memory"):
        tnms.nms(boxes, scores, 0.45, 300)
    assert gpu_nms.launches.count == before
