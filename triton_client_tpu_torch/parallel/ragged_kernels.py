"""Packed ragged batches: the segment table and the segment reduction
(the port of the single-device part of ``parallel/ragged_kernels.py``).

A 3D scan's point count swings 2-10x between frames, so padding every
member of a merged batch to the widest member ships mostly dead rows. A
packed batch concatenates the members' rows back to back and carries a
row -> segment table beside them, so one call processes every request
at its true size:

  * :class:`RaggedLayout` — the row-offset / segment-id table of one
    packed batch, built on the host by the scheduler;
  * :func:`pack_rows` — concatenate per-request row blocks, padded to a
    bucketed row count; pad rows belong to a dead segment;
  * :func:`segment_reduce` — the reduction every ragged model body is
    written against: sum and mean launch kernel 6
    (``ops/gpu_segment.segment_sum``) on a CUDA tensor at any size, max
    and min are plain PyTorch.

Packing never changes a row's values, and a segment's rows stay
contiguous and in request order. The shard-major helpers of the JAX
module (``partition_segments`` to ``unshard_segments``) wait for the
multi-GPU channel, and its TPU tiling helpers (``kernel_block_rows``,
``assert_block_divides_buckets``) have no use here.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from triton_client_tpu_torch.ops.gpu_segment import segment_sum
from triton_client_tpu_torch.runtime.padding import bucket

_SUBLANES = 8


def _round_up(n: int, m: int) -> int:
    return ((max(1, n) + m - 1) // m) * m


def ragged_row_bucket(n: int) -> int:
    """Padded row count for a packed batch: 8 steps per power-of-two
    octave, a multiple of 8. The power-of-two table would waste up to
    half of a large packed batch; this one pads by less than an eighth of
    the power-of-two bucket (up to a quarter of the rows just past a power
    of two) and keeps the set of packed shapes log-bounded."""
    n = max(1, n)
    step = max(_SUBLANES, bucket(n) // 8)
    return _round_up(n, step)


@dataclasses.dataclass(frozen=True)
class RaggedLayout:
    """Row-offset / segment-id table of one packed ragged batch.

    ``sizes[i]`` is request *i*'s row count; ``offsets`` is the exclusive
    prefix sum (length ``n_segments + 1``); ``padded_rows`` the bucketed
    row count every packed array is padded to (pad rows carry segment id
    ``n_segments``, one past the last real segment, so every reduction
    drops them); ``seg_bucket`` the bucketed segment count the model
    body is called with (``launch_segments``)."""

    sizes: tuple[int, ...]

    @property
    def n_segments(self) -> int:
        return len(self.sizes)

    @property
    def total(self) -> int:
        return int(sum(self.sizes))

    @functools.cached_property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(np.asarray(self.sizes, np.int64))]).astype(np.int32)

    @property
    def padded_rows(self) -> int:
        return ragged_row_bucket(self.total)

    @property
    def seg_bucket(self) -> int:
        return bucket(self.n_segments)

    @property
    def launch_segments(self) -> int:
        """The ``num_segments`` the channel hands the ragged body."""
        return self.seg_bucket

    @functools.cached_property
    def segment_ids(self) -> np.ndarray:
        """(padded_rows,) int32; pad rows get id ``n_segments``."""
        ids = np.full(self.padded_rows, self.n_segments, np.int32)
        ids[: self.total] = np.repeat(
            np.arange(self.n_segments, dtype=np.int32), np.asarray(self.sizes, np.int64)
        )
        return ids

    @property
    def pad_rows(self) -> int:
        return self.padded_rows - self.total


def pack_rows(parts: list[np.ndarray], layout: RaggedLayout) -> np.ndarray:
    """Concatenate per-request row blocks into one packed array padded to
    ``layout.padded_rows``. Pad rows replicate the last real row (never
    zeros, the rule of ``runtime/padding.pad_rows``) and belong to the
    dead segment, so their outputs are never read."""
    if [int(p.shape[0]) for p in parts] != list(layout.sizes):
        raise ValueError(
            f"pack_rows: part sizes {[p.shape[0] for p in parts]} != "
            f"layout sizes {list(layout.sizes)}"
        )
    packed = np.concatenate([np.asarray(p) for p in parts])
    pad = layout.padded_rows - packed.shape[0]
    if pad > 0:
        fill = (
            np.repeat(packed[-1:], pad, axis=0)
            if packed.shape[0]
            else np.zeros((pad, *packed.shape[1:]), packed.dtype)
        )
        packed = np.concatenate([packed, fill])
    return packed


def segment_reduce(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, op: str = "sum"
) -> torch.Tensor:
    """Segment-aware reduction: ``values`` (R, F) or (R,), ``segment_ids``
    (R,) -> leading dim ``num_segments``; ids outside [0, num_segments)
    are dropped.

    ``sum`` runs kernel 6 (its plain version on a CPU tensor); ``mean`` is
    that sum over ``max(count, 1)``, the counts from a second launch over
    a ones column. ``max`` and ``min`` are ``scatter_reduce`` (the TPU had
    no kernel for them either), with empty segments 0."""
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"segment_reduce: op must be sum, mean, max or min, got {op!r}")
    squeeze = values.dim() == 1
    v = values[:, None] if squeeze else values
    if op in ("sum", "mean"):
        out = segment_sum(v, segment_ids, num_segments)
        if op == "mean":
            ones = torch.ones((v.shape[0], 1), dtype=torch.float32, device=v.device)
            counts = segment_sum(ones, segment_ids, num_segments)
            out = out / torch.clamp(counts, min=1.0)
    else:
        ids = segment_ids.to(torch.int64)
        # out-of-range rows land in a dump row; include_self=False leaves
        # an empty segment at its initial 0
        slot = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
        out = torch.zeros((num_segments + 1, v.shape[1]), dtype=v.dtype, device=v.device)
        out.scatter_reduce_(0, slot[:, None].expand(-1, v.shape[1]), v,
                            "amax" if op == "max" else "amin", include_self=False)
        out = out[:num_segments]
    return out[:, 0] if squeeze else out
