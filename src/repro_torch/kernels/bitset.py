"""Wave-stacked bitmap AND-reduce with per-shard popcounts.

The wrapper of ``csrc/bitset.cu`` (``repro_bitmap_intersect_batched``),
the port of the TPU kernel ``repro/kernels/bitset.py``
``bitmap_intersect_batched``.  CUDA tensors launch the kernel; CPU
tensors run the plain version (``ref.bitmap_intersect_batched_ref``).
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["bitmap_intersect_batched"]


def bitmap_intersect_batched(stack: torch.Tensor):
    """[S, K, W] uint32 words (int32 bits; K ≥ 1) → (AND over K
    [S, W] int32, per-shard popcounts [S] int32).  Zero-padded ragged W is
    sound as long as every shard's row 0 is its valid-doc bitmap."""
    _build.require(stack, "stack", torch.int32, 3)
    s, k, w = stack.shape
    if k < 1:
        raise ValueError("bitmap_intersect_batched needs K >= 1 bitmaps")
    if stack.device.type == "cpu":
        return _ref.bitmap_intersect_batched_ref(stack)
    if not (s and w):
        return (torch.zeros((s, w), dtype=torch.int32, device=stack.device),
                torch.zeros((s,), dtype=torch.int32, device=stack.device))
    out = torch.empty((s, w), dtype=torch.int32, device=stack.device)
    counts = torch.empty((s,), dtype=torch.int32, device=stack.device)
    _build.launch("bitmap_intersect_batched", "bitset",
                  "repro_bitmap_intersect_batched", stack.device,
                  stack, out, counts, s, k, w)
    return out, counts
