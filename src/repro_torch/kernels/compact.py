"""Stream compaction: ascending ids of set mask entries, -1 padded, plus
counts — per shard of a wave, or over one mask — and one mask's exclusive
prefix sum.

The wrappers of ``csrc/compact.cu``, the ports of the TPU kernels in
``repro/kernels/compact.py``: ``compact_batched``
(``repro_compact_batched``; TPU ``mask_prefix_sum_batched`` +
``compact_batched``) and ``mask_prefix_sum`` / ``compact``
(``repro_mask_scan``; TPU ``mask_prefix_sum`` + ``compact``).  Both run
one single-pass scan with decoupled look-back over 4096-row tiles of
each shard (the single mask is one shard): one launch a call.  CUDA tensors launch the kernels; CPU tensors run the plain
versions (``ref.compact_batched_ref``, ``ref.mask_prefix_sum_ref``,
``ref.compact_ref``).  All give the TPU kernels' output byte for byte.

The scan's state — a 64-bit ticket, then one status word a tile — lives
in a buffer the kernel keeps per (device, stream)
(``_build.stream_state``) and only it writes.  It is zero-filled once,
when it is allocated or grown and when the 32-bit epoch that tags every
status word wraps; a call passes its epoch and the ticket value it starts
at, so no call zeroes or allocates scratch.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from . import ref as _ref

__all__ = ["compact_batched", "mask_prefix_sum", "compact", "SCAN_TILE",
           "EPOCH_LIMIT", "next_epoch"]

#: mask rows per block of the scan (256 threads × 16 bytes)
SCAN_TILE = 4096
#: epochs run 1 .. EPOCH_LIMIT - 1 (the status word's upper 32 bits; a
#: zero-filled word holds epoch 0)
EPOCH_LIMIT = 1 << 32


def next_epoch(epoch: int) -> Tuple[int, bool]:
    """The epoch of the call after one at ``epoch`` (0 for a fresh
    buffer), and whether it wrapped — the buffer is then zero-filled, so
    no status word left by an earlier call carries the new epoch."""
    if epoch + 1 < EPOCH_LIMIT:
        return epoch + 1, False
    return 1, True


def _scan(counter: str, entry: str, mask: torch.Tensor, out: torch.Tensor,
          count: torch.Tensor, shards: int, n: int, *args) -> None:
    """Launch ``entry`` over ``shards`` masks of ``n`` rows on the current
    stream with its state, ticket and epoch; ``args`` go between the state
    and the ticket."""
    dev = mask.device
    st = _build.stream_state("mask_scan", dev)
    tiles = shards * -(-n // SCAN_TILE)
    with st.lock:
        st.reserve(1 + tiles, dev)
        epoch, wrapped = next_epoch(st.epoch)
        if wrapped:
            st.buf.zero_()
            st.ticket = 0
        _build.launch(counter, entry, dev, mask, out, count, st.buf, *args,
                      st.ticket, epoch)
        st.ticket += tiles
        st.epoch = epoch


def compact_batched(masks: torch.Tensor):
    """masks [S, N] bool → (indices [S, N] int32, -1 padded; counts [S]
    int32)."""
    _build.require(masks, "masks", torch.bool, 2)
    if masks.device.type == "cpu":
        return _ref.compact_batched_ref(masks)
    s, n = masks.shape
    if not (s and n):
        return (torch.full((s, n), -1, dtype=torch.int32,
                           device=masks.device),
                torch.zeros((s,), dtype=torch.int32, device=masks.device))
    idx = torch.empty((s, n), dtype=torch.int32, device=masks.device)
    counts = torch.empty((s,), dtype=torch.int32, device=masks.device)
    _scan("compact_batched", "repro_compact_batched", masks, idx, counts, s,
          n, s, n)
    return idx, counts


def _mask_scan(mask: torch.Tensor, ids: bool, counter: str):
    """One ``repro_mask_scan`` call: (out [N] int32, count int32 scalar)."""
    n = int(mask.shape[0])
    dev = mask.device
    if n == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    _scan(counter, "repro_mask_scan", mask, out, count, 1, n, n, int(ids))
    return out, count[0]


def mask_prefix_sum(mask: torch.Tensor):
    """mask [N] bool → (exclusive prefix count [N] int32, count int32
    scalar)."""
    _build.require(mask, "mask", torch.bool, 1)
    if mask.device.type == "cpu":
        return _ref.mask_prefix_sum_ref(mask)
    return _mask_scan(mask, False, "mask_prefix_sum")


def compact(mask: torch.Tensor):
    """mask [N] bool → (ascending ids of set entries [N] int32, -1
    padded; count int32 scalar)."""
    _build.require(mask, "mask", torch.bool, 1)
    if mask.device.type == "cpu":
        return _ref.compact_ref(mask)
    return _mask_scan(mask, True, "compact")
