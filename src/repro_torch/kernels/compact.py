"""Stream compaction: ascending ids of set mask entries, -1 padded, plus
counts — per shard of a wave, or over one mask — and one mask's exclusive
prefix sum.

The wrappers of ``csrc/compact.cu``, the ports of the TPU kernels in
``repro/kernels/compact.py``: ``compact_batched``
(``repro_compact_batched``; TPU ``mask_prefix_sum_batched`` +
``compact_batched``) and ``mask_prefix_sum`` / ``compact``
(``repro_mask_scan``; TPU ``mask_prefix_sum`` + ``compact``).  Both run
one multi-block scan over 4096-row tiles, with a shard axis for the wave
(the single mask is one shard).  CUDA tensors launch the kernels; CPU
tensors run the plain versions (``ref.compact_batched_ref``,
``ref.mask_prefix_sum_ref``, ``ref.compact_ref``).  All give the TPU
kernels' output byte for byte.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["compact_batched", "mask_prefix_sum", "compact", "SCAN_TILE"]

#: mask rows per block of the scan (256 threads × 16 bytes)
SCAN_TILE = 4096


def _scratch(shards: int, n: int, device) -> torch.Tensor:
    """The scan's tile counts and offsets: 2 · shards · ⌈n / 4096⌉ int32."""
    return torch.empty((2 * shards * -(-n // SCAN_TILE),),
                       dtype=torch.int32, device=device)


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
    if s > 65535:
        raise ValueError(f"compact_batched: the kernel's grid takes at most "
                         f"65535 shards, got {s}")
    idx = torch.empty((s, n), dtype=torch.int32, device=masks.device)
    counts = torch.empty((s,), dtype=torch.int32, device=masks.device)
    _build.launch("compact_batched", "repro_compact_batched",
                  masks.device, masks, idx, counts,
                  _scratch(s, n, masks.device), s, n)
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
    _build.launch(counter, "repro_mask_scan", dev, mask, out,
                  count, _scratch(1, n, dev), n, int(ids))
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
