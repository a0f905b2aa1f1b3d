"""The suppression bitmask and one-warp scan of the decode+NMS (kernel 1),
greedy NMS (kernel 2) and 3D suppress+pack (kernel 4) kernels, in plain
PyTorch: the pieces of ``csrc/mask_scan.cuh`` that
``gpu_decode.decode_nms_2d_mask_scan_reference``,
``gpu_nms.nms_greedy_mask_scan_reference`` and
``gpu_suppress3d.suppress_pack_3d_mask_scan_reference`` run, and the
workspace the three wrappers carve.

The greedy loop (argmax over live scores, ties to the lowest index; kill
the pick and every live candidate it suppresses; repeat) keeps exactly
the candidates found by visiting the live ones in (score descending,
index ascending) order and keeping each that no earlier kept one
suppresses, up to ``max_det``. A live NaN is the loop's first pick and
an invalid one, so with a live NaN nothing is kept.
"""

from __future__ import annotations

import torch

from triton_client_tpu_torch.device import scalar_on


def words(k: int) -> int:
    """32-bit words of one mask row over ``k`` candidates."""
    return (k + 31) // 32


def row_stride(k: int) -> int:
    """int32 words between the starts of two mask rows in the kernels'
    workspace: ``words(k)`` rounded up to four, so that every row starts on
    16 bytes (the scan stages rows 16 bytes a copy)."""
    return -(-words(k) // 4) * 4


def sort_slots(k: int) -> int:
    """Slots of the order pass's bitonic sort: the power of two at or
    above ``k``."""
    return 1 << max(0, k - 1).bit_length()


def order_smem_bytes(k: int) -> int:
    """Dynamic shared memory of the order pass over ``k`` candidates: the
    bitonic sort's (score, index) keys and the live scores. The launch
    passes this count to the kernel, which carves its arrays from it."""
    return 8 * sort_slots(k) + 4 * k


def smem_bytes(k: int) -> int:
    """Dynamic shared memory of the larger of a kernel's two one-block
    passes over ``k`` candidates: the order pass (the bitonic sort's
    (score, index) keys and the live scores) or the scan (two buffers of up
    to 256 staged mask rows of 32 words, one buffer's diagonal blocks
    transposed, and the kept list, sized for ``max_det >= k``)."""
    return max(order_smem_bytes(k), 4 * (min(k, 256) * 65 + k))


def visiting_order(live: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, K) live scores (-inf = dead) -> the (B, K) int64 candidate at
    each position of the visiting order and the (B,) int64 number of
    positions to visit: the live candidates, 0 with a live NaN."""
    order = torch.sort(live, dim=1, descending=True, stable=True).indices
    count = (live > float("-inf")).sum(1)
    return order, torch.where(torch.isnan(live).any(1), 0, count)


def in_visiting_order(live: torch.Tensor) -> torch.Tensor:
    """(B,) bool: whether each image's live scores are already in visiting
    order, the order pass's test for taking the input's own order."""
    a, b = live[:, :-1], live[:, 1:]
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    b_above = torch.where(nan_a | nan_b, nan_b & ~nan_a, b > a)
    return ~b_above.any(1)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., n) bool -> (..., words(n)) int32 words, bit i of word w for
    column 32 w + i, as the kernels lay out a mask row (their rows lie
    ``row_stride(n)`` words apart)."""
    n = bits.shape[-1]
    w = words(n)
    padded = torch.nn.functional.pad(bits.to(torch.int64), (0, 32 * w - n))
    packed = (padded.reshape(*bits.shape[:-1], w, 32) << torch.arange(32)).sum(-1)
    return (packed - ((packed >> 31) << 32)).to(torch.int32)  # two's complement


def box_mask(x1, y1, x2, y2, area, iou_thresh) -> torch.Tensor:
    """The 2D kernels' suppression bitmask (``csrc/box_iou.cuh``'s mask
    tile) over (B, K) xyxy coordinates and areas in visiting order: bit q
    of row p is set when the box at position p, as the chosen box ("+ 0.0"
    on its values, as the loop picks them), suppresses the one at position
    q, by the loop's IoU test. Returns (B, K, words(K)) int32 words."""

    def chosen(t):  # row p: the suppressing candidate
        return t[:, :, None] + 0.0

    def other(t):  # column q
        return t[:, None, :]

    iw = torch.clamp(torch.minimum(other(x2), chosen(x2)) - torch.maximum(other(x1), chosen(x1)),
                     min=0.0)
    ih = torch.clamp(torch.minimum(other(y2), chosen(y2)) - torch.maximum(other(y1), chosen(y1)),
                     min=0.0)
    inter = iw * ih
    iou = inter / torch.clamp(other(area) + chosen(area) - inter, min=1e-9)
    thresh = scalar_on(iou_thresh, torch.float32, area.device)
    return pack_bits(iou > thresh)


def scan(mask: torch.Tensor, live_n: torch.Tensor, max_det: int):
    """The scan over (B, K, words(K)) int32 mask rows in visiting order, as
    the kernels run it: positions [0, live_n) 32 at a time (one removed
    word). A chunk's open positions are those its removed word leaves; its
    kept set is the fixpoint of "open and not suppressed by a kept position
    before it in the chunk", iterated from all open ones; the first ones up
    to ``max_det`` are kept and their rows ORed into the removed set.
    Returns the (B, max_det) int64 kept positions (0 past the kept ones)
    and the (B, max_det) bool keep."""
    b = mask.shape[0]
    kept = torch.zeros((b, max_det), dtype=torch.int64)
    keep = torch.zeros((b, max_det), dtype=torch.bool)
    rows = (mask.to(torch.int64) & 0xFFFFFFFF).tolist()
    for i in range(b):
        live = int(live_n[i])
        removed = [0] * mask.shape[2]
        taken: list[int] = []
        for c in range(words(live)):
            if len(taken) == max_det:
                break
            span = min(32, live - 32 * c)
            diag = [rows[i][32 * c + j][c] for j in range(span)]
            # col[t]: the positions j < t of the chunk that suppress 32 c + t
            col = [sum((diag[j] >> t & 1) << j for j in range(t)) for t in range(span)]
            is_open = [not removed[c] >> t & 1 for t in range(span)]
            took = sum(1 << t for t in range(span) if is_open[t])
            while True:
                nxt = sum(1 << t for t in range(span) if is_open[t] and not col[t] & took)
                if nxt == took:
                    break
                took = nxt
            chunk = [32 * c + t for t in range(span) if took >> t & 1][: max_det - len(taken)]
            taken += chunk
            for p in chunk:
                removed = [r | m for r, m in zip(removed, rows[i][p])]
        kept[i, : len(taken)] = torch.tensor(taken, dtype=torch.int64)
        keep[i, : len(taken)] = True
    return kept.to(mask.device), keep.to(mask.device)


def _offsets(sizes: tuple[int, ...]) -> tuple[list[int], int]:
    """Byte offsets of ``sizes`` int32 arrays laid one after another, each
    on a 16-byte boundary, and the bytes of the whole."""
    offsets, total = [], 0
    for s in sizes:
        offsets.append(total)
        total += -(-s // 4) * 16
    return offsets, total


def workspace_bytes(sizes: tuple[int, ...]) -> int:
    """Bytes of the workspace :func:`workspace` allocates for ``sizes``."""
    return _offsets(sizes)[1]


def took_own_order(ws: torch.Tensor, sizes: tuple[int, ...]) -> torch.Tensor:
    """(B,) bool, read back from a kernel's workspace ``ws`` (allocated by
    :func:`workspace` for ``sizes``) after its launch: whether the order
    pass took each image's own order (live scores already in visiting
    order, or a live NaN) rather than sorting it. The three kernels keep
    the live counts, then these flags, in their third array."""
    offset, n = _offsets(sizes)[0][2], sizes[2]
    return ws[offset : offset + 4 * n].view(torch.int32)[n // 2 :].bool()


def workspace(device, sizes: tuple[int, ...]) -> tuple[torch.Tensor, list[int]]:
    """One ``torch.empty`` buffer in device memory holding ``sizes`` int32
    arrays, each on a 16-byte boundary: the buffer (keep it alive until the
    launch is queued) and the arrays' device addresses."""
    offsets, total = _offsets(sizes)
    ws = torch.empty(total, dtype=torch.uint8, device=device)
    return ws, [ws.data_ptr() + o for o in offsets]
