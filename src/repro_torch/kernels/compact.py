"""Wave-stacked stream compaction: ascending ids of each shard's set mask
entries, -1 padded, plus counts.

The wrapper of ``csrc/compact.cu`` (``repro_compact_batched``), the port
of the TPU kernel ``repro/kernels/compact.py`` ``mask_prefix_sum_batched``
+ ``compact_batched``.  CUDA tensors launch the kernel; CPU tensors run
the plain version (``ref.compact_batched_ref``).  Both give the TPU
kernel's output byte for byte.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["compact_batched"]


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
    _build.launch("compact_batched", "compact", "repro_compact_batched",
                  masks.device, masks, idx, counts, s, n)
    return idx, counts
