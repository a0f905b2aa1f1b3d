"""Batch padding and bucketing (the port's copy of ``runtime/padding.py``).

numpy only. The batchers pad merged request groups to a bounded set of
device batch sizes:

  * :func:`bucket`      — the next-power-of-two table;
  * :func:`bucket_for`  — the smallest bucketed size that also divides
    into ``multiple`` shards (a data-parallel channel's width; 1 on one
    card, where it is :func:`bucket`);
  * :func:`pad_rows` / :func:`pad_batch` / :func:`unpad_rows` — the
    padding policy. Pad rows REPLICATE a real row rather than
    zero-filling: zeros can steer a model down another path (other NMS
    survivors, other argmax ties), a copied row cannot, which keeps a
    padded launch's real rows equal to an unpadded one's.
"""

from __future__ import annotations

import numpy as np


def bucket(n: int) -> int:
    """Smallest power of two >= n (the padded device batch size)."""
    b = 1
    while b < n:
        b *= 2
    return b


def bucket_for(n: int, multiple: int = 1) -> int:
    """Smallest bucketed batch size >= n that splits evenly into
    ``multiple`` shards: round to the power-of-two table first, then up
    to the next multiple of ``multiple``. At least ``multiple`` rows, one
    a shard."""
    if multiple <= 1:
        return bucket(n)
    if n <= multiple:
        return multiple
    b = bucket(n)
    return multiple * -(-b // multiple)


def pad_rows(parts: list[np.ndarray], pad: int) -> list[np.ndarray]:
    """Append ``pad`` replicated rows (copies of the first non-empty
    part's first row) to a list of batch fragments about to be
    concatenated. A 0-row fragment has no row to copy, so the first
    non-empty one is used; an all-empty list zero-fills."""
    if pad <= 0:
        return parts
    for p in parts:
        if p.shape[0]:
            return list(parts) + [np.repeat(p[:1], pad, axis=0)]
    return list(parts) + [np.zeros((pad, *parts[0].shape[1:]), parts[0].dtype)]


def pad_batch(arr: np.ndarray, target: int) -> np.ndarray:
    """Pad one batch-leading array up to ``target`` rows by replicating
    its first row (no-op when already at target)."""
    if arr.shape[0] >= target:
        return arr
    return np.concatenate(pad_rows([arr], target - arr.shape[0]))


def unpad_rows(arr, total: int):
    """Slice the real ``total`` rows back off a padded batch output
    (numpy array or tensor)."""
    if arr.ndim >= 1 and arr.shape[0] > total:
        return arr[:total]
    return arr
