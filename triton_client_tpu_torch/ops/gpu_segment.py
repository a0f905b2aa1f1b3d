"""The segment sum of packed ragged batches (kernel 6).

Kernel: ``segment_sum`` replaces the TPU kernel
``triton_client_tpu/parallel/ragged_kernels.py::segment_sum_pallas``.
Source: ``csrc/segment_sum.cu``. Given values (R, F) and segment ids (R,)
in any order, it returns ``out[s, f] = sum of v[r, f] over the rows r
with ids[r] == s`` for ``0 <= s < num_segments``, float32; rows whose id
lies outside [0, num_segments) are dropped (the packing's pad id among
them). R = 0 and ``num_segments`` = 0 are allowed.

What bounds it on an H100: bytes, every row's id and the kept rows'
values read once. R is 10^5-10^6 on the ragged path while S x F is ~32, so
the kernel gets its parallelism from the rows, in one launch: a block of
eight warps sums a chunk of ``CHUNK`` rows, each warp a sub-chunk of
``SUB`` rows, each lane ``LANE_ROWS`` of them (rows ``l, l + 32, ...``)
into one sum per (segment, feature) pair of a 32-pair tile, all in
registers (the grid walks the feature tiles, a block the segment tiles
over the rows it loaded once); a fixed butterfly over the 32 lanes gives the sub-chunk's sums;
the block adds its sub-chunk sums in order; the last block to finish adds
the chunk sums in ``GROUPS`` contiguous groups, then the group sums, in
order. No atomics touch a sum, so the result is the same on every run
(``index_add_`` on CUDA sums with atomics in an order that changes from
run to run). The only atomic is a ticket a tile, in a zeroed buffer
which the kernel leaves at zero: an eager launch takes the one kept per
device and stream (``_tickets``); a launch captured into a CUDA graph
takes the buffer its graph owns (:func:`owned_tickets`), allocated before
the capture began, and raises if there is none.

``segment_sum_reference`` is the plain version in that order: it equals
the kernel bit for bit. On the CPU it is what ``segment_sum`` runs.
``segment_sum`` launches the kernel for CUDA tensors; nothing falls back.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from triton_client_tpu_torch.ops import cuda_build

SOURCE = "segment_sum.cu"
CHUNK = 1024  # rows a block sums (kChunk in the source)
GROUPS = 8  # sub-chunks a chunk, and groups of chunks the fold adds (kWarps)
SUB = CHUNK // GROUPS  # rows a warp sums (kSub)
LANES = 32
LANE_ROWS = SUB // LANES  # rows a lane sums, 32 apart (kRows)
FT_MAX = 8  # features a tile at most
_GRID_Y = 65535

_P, _I = ctypes.c_void_p, ctypes.c_int
# segment_sum_launch(vals, ids, r, f, s, partial, tickets, out, stream)
_ARGTYPES = {"segment_sum_launch": [_P, _P, _I, _I, _I, _P, _P, _P, _P]}

launches = cuda_build.LaunchCounter()

_tickets_lock = threading.Lock()
_tickets_by_stream: dict[tuple[int, int], torch.Tensor] = {}
# the ticket buffer this thread's capture owns (an OwnedTickets), if any
_owned = threading.local()


class OwnedTickets:
    """The ticket buffer of one captured graph. It is sized and zeroed by
    the eager warmup calls that precede the capture (so the allocation
    comes from the ordinary caching allocator, never from the graph's
    private pool), captured launches then point at it, and it lives as
    long as the graph that holds this object."""

    __slots__ = ("buf",)

    def __init__(self) -> None:
        self.buf: torch.Tensor | None = None


@contextlib.contextmanager
def owned_tickets():
    """Give this thread's launches, eager warmups and the capture after
    them, one ticket buffer of their own; yields the ``OwnedTickets`` the
    caller keeps beside the graph."""
    if getattr(_owned, "tickets", None) is not None:
        raise RuntimeError("owned_tickets is already open on this thread")
    _owned.tickets = held = OwnedTickets()
    try:
        yield held
    finally:
        _owned.tickets = None


def tiles(num_segments: int, f: int) -> tuple[int, int]:
    """The launch's (feature tiles, segment tiles): a tile holds 32
    (segment, feature) pairs, ft features (the power of two at or above
    min(F, FT_MAX)) by 32 // ft segments. The launch's grid walks the
    feature tiles; each block walks the segment tiles."""
    ft = 1
    while ft < min(f, FT_MAX):
        ft *= 2
    return -(-f // ft), -(-num_segments // (LANES // ft))


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The zeroed ticket counters of kernel launches on ``stream``: one a
    tile, grown on demand. Launches on one stream run in order and each
    leaves its tickets at zero, so they can share them; another stream
    gets its own. The buffer is keyed by the stream's handle and kept for
    the life of the process, so only streams that outlive their launches
    may call the kernel: PyTorch's own streams (the default stream and its
    pool of ``torch.cuda.Stream``) are never destroyed, so a handle names
    one stream for good and the buffers are as many as those streams. An
    external stream (``torch.cuda.ExternalStream``) destroyed while a
    launch is in flight could pass its handle, and these tickets, to a new
    stream that runs beside that launch.

    Inside :func:`owned_tickets` the buffer is the owned one, grown only
    outside a capture. A launch captured with no owned buffer, or one too
    small, raises: a buffer allocated inside a capture would come from the
    graph's private pool, which later eager launches must not read."""
    held = getattr(_owned, "tickets", None)
    capturing = torch.cuda.is_current_stream_capturing()
    if held is not None:
        if held.buf is None or held.buf.numel() < n:
            if capturing:
                raise RuntimeError(
                    f"segment_sum: a captured launch needs {n} tickets and its graph owns "
                    f"{0 if held.buf is None else held.buf.numel()}; an eager call at the same "
                    "shapes must precede the capture"
                )
            held.buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        return held.buf
    if capturing:
        raise RuntimeError(
            "segment_sum: launched under a CUDA graph capture with no owned ticket buffer; "
            "capture it inside gpu_segment.owned_tickets()"
        )
    key = (device.index, stream)
    with _tickets_lock:
        buf = _tickets_by_stream.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
            _tickets_by_stream[key] = buf
        return buf


def _lane_tree(x: torch.Tensor) -> torch.Tensor:
    """(..., 32, F) lane sums -> (..., F) by the kernel's butterfly: lane i
    with lane i + 16, then i with i + 8, 4, 2 and 1."""
    half = LANES // 2
    while half:
        x = x[..., :half, :] + x[..., half:2 * half, :]
        half //= 2
    return x[..., 0, :]


def segment_sum_reference(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its summation order.

    values (R, F) float32, segment_ids (R,) integer -> (num_segments, F)
    float32, each sum from +0.0: (1) in each sub-chunk of ``SUB`` rows,
    lane l's rows l, l + 32, ... in order, each row's value where its id
    is the segment and +0.0 elsewhere; (2) the sub-chunk's 32 lane sums by
    the butterfly tree (:func:`_lane_tree`); (3) each chunk's ``GROUPS``
    sub-chunk sums in order; (4) the chunk sums in ``GROUPS`` contiguous
    groups of ceil(C / GROUPS), each in chunk order; (5) the group sums in
    order. Missing rows and chunks are zeros, which change no sum that
    started at +0.0. Steps 1-2 loop over the segments, 3-5 take them all
    at once."""
    r, f = values.shape
    dev = values.device
    out = torch.zeros((num_segments, f), dtype=torch.float32, device=dev)
    if r == 0 or num_segments == 0 or f == 0:
        return out
    chunks = -(-r // CHUNK)
    subs = chunks * GROUPS
    pad = chunks * CHUNK - r
    ids = torch.nn.functional.pad(segment_ids.to(torch.int64), (0, pad), value=-1)
    ids = ids.view(subs, LANE_ROWS, LANES)  # row j * 32 + l of a sub-chunk
    vals = torch.nn.functional.pad(values.to(torch.float32), (0, 0, 0, pad))
    vals = vals.view(subs, LANE_ROWS, LANES, f)
    zero = vals.new_zeros(())
    sub_sums = []
    for seg in range(num_segments):
        picked = torch.where((ids == seg)[..., None], vals, zero)
        lane = torch.zeros((subs, LANES, f), dtype=torch.float32, device=dev)
        for j in range(LANE_ROWS):
            lane = lane + picked[:, j]
        sub_sums.append(_lane_tree(lane))
    part = torch.stack(sub_sums).view(num_segments, chunks, GROUPS, f)
    chunk_sums = torch.zeros((num_segments, chunks, f), dtype=torch.float32, device=dev)
    for w in range(GROUPS):
        chunk_sums = chunk_sums + part[:, :, w]
    g = -(-chunks // GROUPS)
    chunk_sums = torch.nn.functional.pad(chunk_sums, (0, 0, 0, GROUPS * g - chunks))
    chunk_sums = chunk_sums.view(num_segments, GROUPS, g, f)
    group_sums = torch.zeros((num_segments, GROUPS, f), dtype=torch.float32, device=dev)
    for j in range(g):
        group_sums = group_sums + chunk_sums[:, :, j]
    for w in range(GROUPS):
        out = out + group_sums[:, w]
    return out


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(R, F) values (cast to float32) + (R,) integer segment ids (cast to
    int32, as the TPU kernel casts them) -> (num_segments, F) float32
    segment sums, out-of-range ids dropped.

    CUDA tensors launch ``csrc/segment_sum.cu`` on the current stream;
    CPU tensors run :func:`segment_sum_reference`."""
    if values.dim() != 2 or segment_ids.dim() != 1 or segment_ids.shape[0] != values.shape[0]:
        raise ValueError(
            f"segment_sum: values (R, F) with segment_ids (R,), got {tuple(values.shape)}, "
            f"{tuple(segment_ids.shape)}"
        )
    if segment_ids.dtype.is_floating_point or segment_ids.dtype == torch.bool:
        raise ValueError(f"segment_sum: integer segment_ids, got {segment_ids.dtype}")
    r, f = values.shape
    if num_segments < 0 or r >= 2**31 or num_segments * f >= 2**31 or tiles(
            num_segments, f)[0] > _GRID_Y:
        raise ValueError(f"segment_sum: num_segments {num_segments}, values {tuple(values.shape)}")
    if values.device.type == "cpu" and segment_ids.device.type == "cpu":
        return segment_sum_reference(values, segment_ids, num_segments)
    if values.device.type != "cuda" or segment_ids.device != values.device:
        raise ValueError(f"segment_sum: inputs on {values.device} and {segment_ids.device}")
    vals = values.to(torch.float32).contiguous()
    ids = segment_ids.to(torch.int32).contiguous()
    out = torch.empty((num_segments, f), dtype=torch.float32, device=vals.device)
    if num_segments == 0 or f == 0:
        return out
    ty, tz = tiles(num_segments, f)
    partial = torch.empty((ty * tz, max(1, -(-r // CHUNK)), LANES), dtype=torch.float32,
                          device=vals.device)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    tickets = _tickets(vals.device, stream, ty * tz)
    with torch.cuda.device(vals.device):
        err = cuda_build.load(SOURCE, _ARGTYPES).segment_sum_launch(
            vals.data_ptr(), ids.data_ptr(), r, f, num_segments, partial.data_ptr(),
            tickets.data_ptr(), out.data_ptr(), stream,
        )
    cuda_build.check_launch("segment_sum", err)
    launches.add()
    return out
