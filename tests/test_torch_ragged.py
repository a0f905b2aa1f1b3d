"""The port's packed-ragged primitives against the JAX package.

  * ``runtime/padding.py`` and the numpy part of
    ``parallel/ragged_kernels.py`` (``ragged_row_bucket``,
    ``RaggedLayout``, ``pack_rows``) give arrays equal to JAX's;
  * the plain segment sum (kernel 6's plain version, what
    ``ops/gpu_segment.segment_sum`` runs on a CPU tensor) agrees with the
    Pallas kernel in interpret mode and with ``jax.ops.segment_sum`` on
    every ``kernel_cases.SEGSUM_KINDS`` case, at rtol 1e-5 and atol
    1e-6 x sum|v|: the plain version sums in chunked row order, the one-hot
    product in Eigen's blocked order and XLA's scatter in its own, so the
    bits differ by rounding;
  * ``segment_reduce`` for sum, mean, max and min, and 1-D values,
    against JAX's ``segment_reduce``: max, min and the counts behind the
    mean exactly, each mean at rtol 1e-5 and atol 1e-6 x its own
    segment's mean |v| (a tolerance sized for sums would pass a mean
    divided by a count one off).

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_client_tpu.parallel import ragged_kernels as jrk
from triton_client_tpu.runtime import padding as jpad
from triton_client_tpu_torch.ops import gpu_segment, kernel_cases
from triton_client_tpu_torch.parallel import ragged_kernels as trk
from triton_client_tpu_torch.runtime import padding as tpad

# (R, F, S) for the Pallas comparison: small enough for interpret mode
SHAPES = [(2500, 4, 8), (131, 130, 64), (1, 1, 1), (7, 64, 8)]


def _tol(values):
    return dict(rtol=1e-5, atol=1e-6 * float(np.abs(values).sum()))


def _assert_means_close(got, want, values, ids, num_segments):
    """Each segment's mean within rtol 1e-5 and atol 1e-6 x that
    segment's sum |v| / count."""
    v = np.abs(values.reshape(values.shape[0], -1)).astype(np.float64)
    live = (ids >= 0) & (ids < num_segments)
    abs_sum = np.zeros((num_segments, v.shape[1]))
    np.add.at(abs_sum, ids[live], v[live])
    count = np.bincount(ids[live], minlength=num_segments)[:, None]
    atol = (1e-6 * abs_sum / np.maximum(count, 1)).reshape(
        (num_segments,) + got.shape[1:])
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err <= atol + 1e-5 * np.abs(want)), float((err - atol).max())


def _assert_reduce_matches(got, want, op, values, ids, num_segments):
    if op in ("max", "min"):
        np.testing.assert_array_equal(got, want)
    elif op == "mean":
        _assert_means_close(got, want, values, ids, num_segments)
    else:
        np.testing.assert_allclose(got, want, **_tol(values))


# -- padding helpers --


def test_bucket_tables_equal_jax():
    for n in range(0, 300):
        assert tpad.bucket(n) == jpad.bucket(n)
        for m in (1, 2, 3, 4, 6, 8):
            assert tpad.bucket_for(n, m) == jpad.bucket_for(n, m), (n, m)


@pytest.mark.parametrize("sizes,pad", [((3, 0, 2), 3), ((0, 0), 2), ((5,), 0), ((1, 4), 1)])
def test_pad_rows_and_batch_equal_jax(sizes, pad):
    rng = np.random.default_rng(sum(sizes) + pad)
    parts = [rng.standard_normal((n, 3, 2)).astype(np.float32) for n in sizes]
    got, want = tpad.pad_rows(parts, pad), jpad.pad_rows(parts, pad)
    assert len(got) == len(want)
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    arr = np.concatenate(parts)
    for target in (arr.shape[0], arr.shape[0] + 5):
        if arr.shape[0]:
            np.testing.assert_array_equal(tpad.pad_batch(arr, target), jpad.pad_batch(arr, target))
    for total in (0, 1, arr.shape[0]):
        np.testing.assert_array_equal(tpad.unpad_rows(arr, total), jpad.unpad_rows(arr, total))
    t = torch.from_numpy(arr)
    assert torch.equal(tpad.unpad_rows(t, 1), t[: min(1, arr.shape[0])])


# -- the ragged layout --


def test_ragged_row_bucket_equals_jax():
    for n in list(range(0, 2100)) + [4999, 5000, 65536, 131073, 560_000, 655_361, 10**6]:
        assert trk.ragged_row_bucket(n) == jrk.ragged_row_bucket(n), n


@pytest.mark.parametrize(
    "sizes", [(3, 11, 8, 40, 5), (1,), (0, 4), (20000, 120000, 71234), (5, 1, 1, 1, 4, 4, 17, 9)]
)
def test_ragged_layout_and_pack_rows_equal_jax(sizes):
    t, j = trk.RaggedLayout(sizes), jrk.RaggedLayout(sizes)
    for attr in ("n_segments", "total", "padded_rows", "seg_bucket", "launch_segments",
                 "pad_rows"):
        assert getattr(t, attr) == getattr(j, attr), attr
    np.testing.assert_array_equal(t.offsets, j.offsets)
    np.testing.assert_array_equal(t.segment_ids, j.segment_ids)
    assert t.segment_ids.dtype == np.int32
    rng = np.random.default_rng(len(sizes))
    parts = [rng.standard_normal((n, 4)).astype(np.float32) for n in sizes]
    np.testing.assert_array_equal(trk.pack_rows(parts, t), jrk.pack_rows(parts, j))
    with pytest.raises(ValueError, match="pack_rows"):
        trk.pack_rows(parts[:-1], t)


# -- the segment sum (kernel 6's plain version) --


@pytest.mark.parametrize("kind", kernel_cases.SEGSUM_KINDS)
@pytest.mark.parametrize("r,f,s", SHAPES)
def test_segment_sum_plain_matches_tpu_kernel_and_xla(kind, r, f, s):
    v, ids = kernel_cases.segsum_inputs(kind, r, f, s, seed=r + f + s)
    got = gpu_segment.segment_sum(torch.from_numpy(v), torch.from_numpy(ids), s)
    assert got.dtype == torch.float32 and got.shape == (s, f)
    pallas = np.asarray(jrk.segment_sum_pallas(jnp.asarray(v), jnp.asarray(ids), s, interpret=True))
    xla = np.asarray(jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(ids), num_segments=s))
    np.testing.assert_allclose(got.numpy(), pallas, **_tol(v))
    np.testing.assert_allclose(got.numpy(), xla, **_tol(v))
    if kind == "empty_segments":
        assert not got[1::2].any()


def _sum_in_kernel_order(v, ids, s):
    """The kernel's documented summation order (``csrc/segment_sum.cu``),
    as a float32 loop over rows in numpy, written apart from the plain
    version: each sum from +0.0; in every 128-row sub-chunk, lane l's rows
    l, l + 32, l + 64, l + 96 in order; the 32 lane sums by halving (lane i
    with i + 16, then i + 8, 4, 2, 1); each 1024-row chunk's 8 sub-chunk
    sums in order; the chunk sums in 8 contiguous groups of ceil(C / 8) in
    order; then the 8 group sums."""
    r, f = v.shape
    lanes, sub, chunk, groups = 32, 128, 1024, 8
    chunks = max(1, -(-r // chunk))
    chunk_sums = np.zeros((chunks, s, f), np.float32)
    for c in range(chunks):
        for k in range(groups):
            lane_sums = np.zeros((lanes, s, f), np.float32)
            for lane in range(lanes):
                for j in range(sub // lanes):
                    row = c * chunk + k * sub + lane + lanes * j
                    if row < r and 0 <= ids[row] < s:
                        lane_sums[lane, ids[row]] = lane_sums[lane, ids[row]] + v[row]
            width = lanes
            while width > 1:
                width //= 2
                lane_sums = lane_sums[:width] + lane_sums[width:2 * width]
            chunk_sums[c] = chunk_sums[c] + lane_sums[0]
    g = -(-chunks // groups)
    out = np.zeros((s, f), np.float32)
    for w in range(groups):
        acc = np.zeros((s, f), np.float32)
        for c in range(w * g, min(chunks, (w + 1) * g)):
            acc = acc + chunk_sums[c]
        out = out + acc
    return out


def _row_order_sum(v, ids, s):
    out = np.zeros((s, v.shape[1]), np.float32)
    for row in range(v.shape[0]):
        if 0 <= ids[row] < s:
            out[ids[row]] = out[ids[row]] + v[row]
    return out


@pytest.mark.parametrize("r,f,s", kernel_cases.SEGSUM_BOUNDARY_SHAPES)
def test_segment_sum_reference_follows_the_kernel_order_bitwise(r, f, s):
    """On the ``decades`` kind, where another grouping changes the bits, at
    R around every boundary of the order: the plain version equals the
    numpy loop in the documented order bit for bit, and past two
    sub-chunks it differs from a plain row-order sum somewhere."""
    v, ids = kernel_cases.segsum_inputs("decades", r, f, s, seed=r + f + s)
    got = gpu_segment.segment_sum_reference(torch.from_numpy(v), torch.from_numpy(ids), s)
    want = _sum_in_kernel_order(v, ids, s)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    if r > 2 * 128:
        assert (want.view(np.int32) != _row_order_sum(v, ids, s).view(np.int32)).any()


def test_segment_sum_spans_chunks_in_order():
    """Past one chunk the plain version sums lane by lane, sub-chunk by
    sub-chunk, chunk by chunk and group by group, as the kernel does: equal
    to that order bit for bit, and held to a float64 sum and to XLA, with the sums at
    every segment nonzero."""
    r = 3 * gpu_segment.CHUNK + 17
    v, ids = kernel_cases.segsum_inputs("layout", r, 4, 8, seed=5)
    got = gpu_segment.segment_sum_reference(torch.from_numpy(v), torch.from_numpy(ids), 8)
    np.testing.assert_array_equal(got.numpy(), _sum_in_kernel_order(v, ids, 8))
    want = np.zeros((8, 4))
    live = ids < 8
    np.add.at(want, ids[live], v[live].astype(np.float64))
    assert (want != 0).all()
    np.testing.assert_allclose(got.numpy(), want, **_tol(v))
    xla = np.asarray(jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(ids), num_segments=8))
    np.testing.assert_allclose(got.numpy(), xla, **_tol(v))


def test_segment_sum_empty_inputs_and_no_launch_on_cpu():
    gpu_segment.launches.reset()
    z = gpu_segment.segment_sum(torch.zeros((0, 4)), torch.zeros(0, dtype=torch.int32), 8)
    assert z.shape == (8, 4) and not z.any()
    assert gpu_segment.segment_sum(torch.ones((5, 3)), torch.zeros(5, dtype=torch.int64),
                                   0).shape == (0, 3)
    v, ids = kernel_cases.segsum_inputs("unsorted", 300, 4, 8, seed=2)
    a = gpu_segment.segment_sum(torch.from_numpy(v).double(), torch.from_numpy(ids).long(), 8)
    b = gpu_segment.segment_sum_reference(torch.from_numpy(v), torch.from_numpy(ids), 8)
    assert torch.equal(a, b)  # float64 values and int64 ids are cast as the kernel casts them
    assert gpu_segment.launches.count == 0


def test_segment_sum_wrapper_checks_its_inputs():
    v, ids = torch.zeros((8, 4)), torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="segment_sum"):
        gpu_segment.segment_sum(v, ids[:7], 2)
    with pytest.raises(ValueError, match="segment_sum"):
        gpu_segment.segment_sum(v[:, 0], ids, 2)
    with pytest.raises(ValueError, match="integer"):
        gpu_segment.segment_sum(v, ids.float(), 2)
    with pytest.raises(ValueError, match="segment_sum"):
        gpu_segment.segment_sum(v, ids, -1)
    with pytest.raises(ValueError, match="segment_sum"):  # not the CPU, not CUDA
        gpu_segment.segment_sum(v.to("meta"), ids.to("meta"), 2)
    with pytest.raises(ValueError, match="segment_sum"):  # mixed devices
        gpu_segment.segment_sum(v, ids.to("meta"), 2)


def test_non_finite_rows_stay_in_their_segment():
    """A per-segment sum keeps an inf in its own segment; the TPU kernel's
    one-hot product turns it into NaN in every segment (0 * inf), which is
    why the cases are finite."""
    v, ids = kernel_cases.segsum_inputs("unsorted", 64, 4, 8, seed=9)
    v[3, 1] = np.inf
    got = gpu_segment.segment_sum(torch.from_numpy(v), torch.from_numpy(ids), 8).numpy()
    assert np.isinf(got[ids[3], 1]) and np.isfinite(np.delete(got, ids[3], 0)).all()
    pallas = np.asarray(jrk.segment_sum_pallas(jnp.asarray(v), jnp.asarray(ids), 8, interpret=True))
    assert np.isnan(pallas[:, 1]).sum() >= 7


# -- segment_reduce --


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("kind", ["layout", "out_of_range", "empty_segments"])
def test_segment_reduce_matches_jax(op, kind):
    v, ids = kernel_cases.segsum_inputs(kind, 1500, 4, 8, seed=21)
    got = trk.segment_reduce(torch.from_numpy(v), torch.from_numpy(ids), 8, op).numpy()
    want = np.asarray(jrk.segment_reduce(jnp.asarray(v), jnp.asarray(ids), 8, op))
    assert got.shape == want.shape == (8, 4) and got.dtype == np.float32
    _assert_reduce_matches(got, want, op, v, ids, 8)


@pytest.mark.parametrize("kind", ["layout", "out_of_range", "empty_segments"])
def test_segment_counts_behind_the_mean_equal_jax(kind):
    """The mean divides by the counts the kernel sums over a ones
    column; they equal JAX's exactly."""
    _v, ids = kernel_cases.segsum_inputs(kind, 1500, 4, 8, seed=21)
    ones = np.ones((ids.shape[0], 1), np.float32)
    got = trk.segment_reduce(torch.from_numpy(ones), torch.from_numpy(ids), 8, "sum").numpy()
    want = np.asarray(jrk.segment_reduce(jnp.asarray(ones), jnp.asarray(ids), 8, "sum"))
    np.testing.assert_array_equal(got, want)
    live = (ids >= 0) & (ids < 8)
    np.testing.assert_array_equal(got[:, 0], np.bincount(ids[live], minlength=8))


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_segment_reduce_1d_matches_jax(op):
    v, ids = kernel_cases.segsum_inputs("unsorted", 777, 1, 5, seed=4)
    got = trk.segment_reduce(torch.from_numpy(v[:, 0]), torch.from_numpy(ids), 5, op).numpy()
    want = np.asarray(jrk.segment_reduce(jnp.asarray(v[:, 0]), jnp.asarray(ids), 5, op))
    assert got.shape == want.shape == (5,)
    _assert_reduce_matches(got, want, op, v[:, 0], ids, 5)


def test_segment_reduce_refuses_an_unknown_op():
    with pytest.raises(ValueError, match="op"):
        trk.segment_reduce(torch.zeros((2, 2)), torch.zeros(2, dtype=torch.int32), 2, "prod")
