"""Bitmap kernels: the wave-stacked and the single-shard AND-reduce with
popcounts, and word-wise bitmap algebra.

The wrappers of ``csrc/bitset.cu``, the ports of the TPU kernels in
``repro/kernels/bitset.py``: ``bitmap_intersect_batched`` and
``bitmap_intersect`` (one entry, ``repro_bitmap_intersect``, over
[S, K, W]; the single stack is S = 1) and ``bitset_binary``
(``repro_bitset_binary``).  A shard wider than ``INTERSECT_BLOCK_WORDS``
takes several blocks, which close on a word a shard in a buffer the
kernel keeps per (device, stream) (``_build.stream_state``), zero-filled
once and left at 0 by every call.  CUDA tensors launch the kernels; CPU
tensors run the plain versions (``ref.bitmap_intersect_batched_ref``,
``ref.bitmap_intersect_ref``, ``ref.bitset_binary_ref``).  uint32 words
travel as int32 tensors holding the same bits.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["bitmap_intersect_batched", "bitmap_intersect", "bitset_binary",
           "BINARY_OPS", "INTERSECT_BLOCK_WORDS", "intersect_state_words"]

#: bitset_binary's ops, by their code in the kernel
BINARY_OPS = {"and": 0, "or": 1, "andnot": 2}
#: the widest shard (in words) one block of the intersect kernel takes
#: alone (256 threads × 4 words)
INTERSECT_BLOCK_WORDS = 1024


def intersect_state_words(shards: int, words: int) -> int:
    """int64 words of state the intersect kernel needs for ``shards``
    shards of ``words`` words: none when a block takes a shard, else one a
    shard (blocks arrived and bits so far)."""
    return shards if words > INTERSECT_BLOCK_WORDS else 0


def _intersect(counter: str, stack: torch.Tensor, out: torch.Tensor,
               counts: torch.Tensor, s: int, k: int, w: int) -> None:
    """One ``repro_bitmap_intersect`` launch over [s, k, w]."""
    dev = stack.device
    need = intersect_state_words(s, w)
    if not need:
        _build.launch(counter, "repro_bitmap_intersect", dev, stack, out,
                      counts, s, k, w, None)
        return
    st = _build.stream_state("bitmap_intersect", dev)
    with st.lock:
        st.reserve(need, dev)
        _build.launch(counter, "repro_bitmap_intersect", dev, stack, out,
                      counts, s, k, w, st.buf)


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
    _intersect("bitmap_intersect_batched", stack, out, counts, s, k, w)
    return out, counts


def bitmap_intersect(stack: torch.Tensor):
    """[K, W] uint32 words (int32 bits; K ≥ 1) → (AND over K [W] int32,
    total popcount as an int32 scalar tensor)."""
    _build.require(stack, "stack", torch.int32, 2)
    k, w = stack.shape
    if k < 1:
        raise ValueError("bitmap_intersect needs K >= 1 bitmaps")
    if stack.device.type == "cpu":
        return _ref.bitmap_intersect_ref(stack)
    if w == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=stack.device),
                torch.zeros((), dtype=torch.int32, device=stack.device))
    out = torch.empty((w,), dtype=torch.int32, device=stack.device)
    count = torch.empty((1,), dtype=torch.int32, device=stack.device)
    _intersect("bitmap_intersect", stack, out, count, 1, k, w)
    return out, count[0]


def bitset_binary(a: torch.Tensor, b: torch.Tensor, op: str = "and"):
    """Two [W] uint32 word arrays (int32 bits) → [W] int32: ``and``,
    ``or`` or ``andnot`` (a & ~b)."""
    _build.require(a, "a", torch.int32, 1)
    _build.require(b, "b", torch.int32, 1)
    if op not in BINARY_OPS:
        raise ValueError(f"bitset_binary: unknown op {op!r}")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("bitset_binary: a and b differ in shape or device")
    if a.device.type == "cpu":
        return _ref.bitset_binary_ref(a, b, op)
    w = int(a.shape[0])
    out = torch.empty_like(a)
    if w:
        _build.launch("bitset_binary", "repro_bitset_binary",
                      a.device, a, b, out, w, BINARY_OPS[op])
    return out
