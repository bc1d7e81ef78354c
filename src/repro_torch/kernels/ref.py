"""Plain PyTorch versions of the four hand-written CUDA kernels.

These are the semantic ground truth on this side of the port, the
counterparts of ``repro/kernels/ref.py``'s jnp oracles.  The kernel
wrappers run them for tensors on the CPU (the tests), and ``chip_smoke.py``
holds every CUDA kernel against them on the card.  They are written for
clarity, not speed: they repeat the arithmetic, never the kernels' design.

uint32 words travel as ``torch.int32`` tensors holding the same bits.
Torch's ``>>`` on a signed word is an arithmetic shift, so every shift is
masked afterwards or done on int64-widened words.  A 64-bit (hi, lo) word
pair is compared through :func:`key64`, which packs it into an int64 with
the top bit flipped: signed order on the flipped value is unsigned order
on the pair (timestamp sort keys set bit 63, so an unflipped compare would
be wrong).
"""
from __future__ import annotations

import torch

__all__ = ["key64", "split64", "popcount_words",
           "bitmap_intersect_batched_ref", "compact_batched_ref",
           "segment_agg_ref", "refine_tracks_batched_ref", "refine_no_hits",
           "FH_NONE", "LH_NONE"]

_LO32 = 0xFFFFFFFF
_TOP = -(1 << 63)                       # int64 with only bit 63 set

#: first-hit "no hit" key (all-ones word pair) and last-hit dual (zeros),
#: in :func:`key64`'s flipped form
FH_NONE = (1 << 63) - 1
LH_NONE = _TOP


def key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) uint32 word pairs (int32 bits) → int64 whose signed order
    is the pairs' unsigned 64-bit order (bit 63 flipped)."""
    u = ((hi.to(torch.int64) & _LO32) << 32) | (lo.to(torch.int64) & _LO32)
    return u ^ _TOP


def split64(k: torch.Tensor):
    """Inverse of :func:`key64`: flipped int64 keys → (hi, lo) int32
    words (the int64 → int32 cast keeps the low 32 bits)."""
    u = k ^ _TOP
    return (u >> 32).to(torch.int32), u.to(torch.int32)


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Per-word SWAR popcount of uint32 words (int32 bits) → int64."""
    x = words.to(torch.int64) & _LO32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _LO32) >> 24


# ----------------------------------------------------------------- bitsets

def bitmap_intersect_batched_ref(stack: torch.Tensor):
    """AND-reduce [S, K, W] probe words → (bitmaps [S, W] int32,
    popcounts [S] int32)."""
    s, k, w = stack.shape
    bm = torch.full((s, w), -1, dtype=torch.int32, device=stack.device)
    for i in range(k):
        bm = bm & stack[:, i]
    return bm, popcount_words(bm).sum(dim=1).to(torch.int32)


# ------------------------------------------------------------- compaction

def compact_batched_ref(masks: torch.Tensor):
    """masks [S, N] bool → (ascending ids of set entries [S, N] int32,
    -1 padded; counts [S] int32).  The drop-mode scatter of the JAX
    version becomes a scatter into an N+1 buffer whose last column
    swallows the unset entries, then a slice."""
    s, n = masks.shape
    counts = masks.sum(dim=1, dtype=torch.int32)
    slot = torch.where(masks, torch.cumsum(masks, dim=1) - 1,
                       torch.full_like(masks, n, dtype=torch.int64))
    cols = torch.arange(n, dtype=torch.int32,
                        device=masks.device).expand(s, n)
    idx = torch.full((s, n + 1), -1, dtype=torch.int32, device=masks.device)
    idx.scatter_(1, slot, cols)
    return idx[:, :n].contiguous(), counts


# -------------------------------------------------------- group-by partials

def segment_agg_ref(group_ids: torch.Tensor, values: torch.Tensor,
                    num_groups: int):
    """Per-group (count int32, sum float64, sumsq float64) over
    ``group_ids`` [N] int32 (rows with ids < 0 are masked out).  Sums
    accumulate in float64 in row order on the CPU, bit-equal to the numpy
    oracle's ``bincount``."""
    dev = group_ids.device
    keep = group_ids >= 0
    g = group_ids[keep].to(torch.int64)
    v = values[keep].to(torch.float64)
    cnt = torch.zeros(num_groups, dtype=torch.int32, device=dev)
    cnt.index_add_(0, g, torch.ones_like(g, dtype=torch.int32))
    s = torch.zeros(num_groups, dtype=torch.float64, device=dev)
    s.index_add_(0, g, v)
    s2 = torch.zeros(num_groups, dtype=torch.float64, device=dev)
    s2.index_add_(0, g, v * v)
    return cnt, s, s2


# ------------------------------------------------------------ track refine

def refine_no_hits(s: int, c: int, d: int, device, with_first_hits: bool,
                   with_analytics: bool, mask: torch.Tensor):
    """``mask`` with all-"no hit" reduction tables of the requested
    shape — the refine output when no point can be evaluated."""
    if not (with_first_hits or with_analytics):
        return mask
    fh = split64(torch.full((s, c, d), FH_NONE, dtype=torch.int64,
                            device=device))
    if not with_analytics:
        return (mask, *fh)
    lh = split64(torch.full((s, c, d), LH_NONE, dtype=torch.int64,
                            device=device))
    cnt = torch.zeros((s, c, d), dtype=torch.int32, device=device)
    return (mask, *fh, *lh, cnt)


def refine_tracks_batched_ref(pts: torch.Tensor, rows: torch.Tensor,
                              cov: torch.Tensor, num_docs: int,
                              with_first_hits: bool = False,
                              with_analytics: bool = False):
    """Exact Tesseract refine over a wave: pts [S, 4, P] words (key_hi,
    key_lo, t_hi, t_lo), rows [S, P] int32 doc ids (-1 pad), cov
    [C, 8, R] words (range lo, range hi, window w0, window w1 as (hi, lo)
    pairs) → hit masks [S, num_docs] bool: a doc passes iff for every
    constraint some point lies in one of its ranges ``[lo, hi)`` during
    ``[w0, w1]``.

    ``with_first_hits`` adds the first-hit (hi, lo) word tables
    [S, C, num_docs] (lexicographic min over the doc's hits, all-ones
    when none); ``with_analytics`` returns ``(mask, fh_hi, fh_lo, lh_hi,
    lh_lo, count)`` with the last-hit max tables (zeros when none) and
    int32 hit counts.  Every point is tested against every range slot
    (no reliance on the ranges being sorted)."""
    s, _, p = pts.shape
    c_n = int(cov.shape[0])
    dev = pts.device
    if s == 0 or num_docs == 0 or p == 0 or c_n == 0:
        # no docs → nothing passes; no points → no constraint can hit;
        # no constraints → vacuous truth
        fill = s > 0 and num_docs > 0 and c_n == 0
        mask = torch.full((s, num_docs), fill, dtype=torch.bool, device=dev)
        return refine_no_hits(s, c_n, num_docs, dev, with_first_hits,
                              with_analytics, mask)
    key = key64(pts[:, 0], pts[:, 1]).reshape(-1)             # [S*P]
    t = key64(pts[:, 2], pts[:, 3]).reshape(-1)
    # flat doc slot per point; padding points land in a dropped column
    safe = torch.where(rows >= 0, rows, num_docs).to(torch.int64)
    slot = (safe + torch.arange(s, device=dev)[:, None]
            * (num_docs + 1)).reshape(-1)
    flat = s * (num_docs + 1)
    lo = key64(cov[:, 0], cov[:, 1])                          # [C, R]
    hi = key64(cov[:, 2], cov[:, 3])
    w0 = key64(cov[:, 4, 0], cov[:, 5, 0])                    # [C]
    w1 = key64(cov[:, 6, 0], cov[:, 7, 0])

    def per_doc(x):
        return x.reshape(s, num_docs + 1)[:, :num_docs]

    out = torch.ones((s, num_docs), dtype=torch.bool, device=dev)
    fh, lh, cnts = [], [], []
    for c in range(c_n):
        in_cov = torch.zeros_like(key, dtype=torch.bool)
        for r in range(lo.shape[1]):
            in_cov |= (key >= lo[c, r]) & (key < hi[c, r])
        hit = in_cov & (t >= w0[c]) & (t <= w1[c])
        doc_hit = torch.zeros(flat, dtype=torch.int32, device=dev)
        doc_hit.index_add_(0, slot, hit.to(torch.int32))
        out &= per_doc(doc_hit) > 0
        if with_first_hits or with_analytics:
            first = torch.full((flat,), FH_NONE, dtype=torch.int64,
                               device=dev)
            first.scatter_reduce_(0, slot, torch.where(hit, t, FH_NONE),
                                  reduce="amin")
            fh.append(per_doc(first))
        if with_analytics:
            last = torch.full((flat,), LH_NONE, dtype=torch.int64,
                              device=dev)
            last.scatter_reduce_(0, slot, torch.where(hit, t, LH_NONE),
                                 reduce="amax")
            lh.append(per_doc(last))
            cnts.append(per_doc(doc_hit))
    if not (with_first_hits or with_analytics):
        return out
    res = (out, *split64(torch.stack(fh, dim=1)))
    if with_analytics:
        res += (*split64(torch.stack(lh, dim=1)), torch.stack(cnts, dim=1))
    return res
