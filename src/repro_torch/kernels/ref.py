"""Plain PyTorch versions of the hand-written CUDA kernels.

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

import math

import torch

__all__ = ["key64", "split64", "popcount_words", "bitset_binary_ref",
           "bitmap_intersect_ref", "bitmap_intersect_batched_ref",
           "mask_prefix_sum_ref", "compact_ref", "compact_batched_ref",
           "segment_agg_ref", "refine_tracks_batched_ref",
           "refine_tracks_multi_ref", "refine_no_hits", "FH_NONE",
           "LH_NONE", "flash_attention_ref", "FLASH_REL", "flash_tolerance",
           "ssm_scan_ref", "selective_scan_ref"]

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

def bitset_binary_ref(a: torch.Tensor, b: torch.Tensor,
                      op: str = "and") -> torch.Tensor:
    """Word-wise bitmap algebra over two [W] word arrays: ``and``, ``or``
    or ``andnot`` (a & ~b)."""
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "andnot":
        return a & ~b
    raise ValueError(f"bitset_binary: unknown op {op!r}")


def bitmap_intersect_ref(stack: torch.Tensor):
    """AND-reduce [K, W] probe words → (bitmap [W] int32, total popcount
    as an int32 scalar)."""
    bm, cnt = bitmap_intersect_batched_ref(stack[None])
    return bm[0], cnt[0]


def bitmap_intersect_batched_ref(stack: torch.Tensor):
    """AND-reduce [S, K, W] probe words → (bitmaps [S, W] int32,
    popcounts [S] int32)."""
    s, k, w = stack.shape
    bm = torch.full((s, w), -1, dtype=torch.int32, device=stack.device)
    for i in range(k):
        bm = bm & stack[:, i]
    return bm, popcount_words(bm).sum(dim=1).to(torch.int32)


# ------------------------------------------------------------- compaction

def mask_prefix_sum_ref(mask: torch.Tensor):
    """mask [N] bool → (exclusive prefix count [N] int32, count as an
    int32 scalar)."""
    m = mask.to(torch.int32)
    pos = (torch.cumsum(m, dim=0) - m).to(torch.int32)
    return pos, m.sum(dtype=torch.int32)


def compact_ref(mask: torch.Tensor):
    """mask [N] bool → (ascending ids of set entries [N] int32, -1
    padded; count as an int32 scalar)."""
    idx, counts = compact_batched_ref(mask[None])
    return idx[0], counts[0]


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
    ``group_ids`` [N] int32; rows whose id is < 0 or >= ``num_groups`` are
    dropped, as by the JAX package's kernel and ``segment_sum``.  Sums
    accumulate in float64 in row order on the CPU, bit-equal to the numpy
    oracle's ``bincount``."""
    dev = group_ids.device
    keep = (group_ids >= 0) & (group_ids < num_groups)
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

def refine_no_hits(lead: tuple, c: int, d: int, device,
                   with_first_hits: bool, with_analytics: bool,
                   mask: torch.Tensor):
    """``mask`` with all-"no hit" reduction tables of shape
    ``(*lead, c, d)`` — the refine output when no point can be
    evaluated."""
    if not (with_first_hits or with_analytics):
        return mask
    shape = (*lead, c, d)
    fh = split64(torch.full(shape, FH_NONE, dtype=torch.int64,
                            device=device))
    if not with_analytics:
        return (mask, *fh)
    lh = split64(torch.full(shape, LH_NONE, dtype=torch.int64,
                            device=device))
    cnt = torch.zeros(shape, dtype=torch.int32, device=device)
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
        return refine_no_hits((s,), c_n, num_docs, dev, with_first_hits,
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


def refine_tracks_multi_ref(pts: torch.Tensor, rows: torch.Tensor,
                            cov: torch.Tensor, num_docs: int,
                            with_first_hits: bool = False,
                            with_analytics: bool = False):
    """Refine for Q coalesced queries sharing one wave: cov [Q, C, 8, R]
    (one :func:`refine_tracks_batched_ref` table per query) against
    pts [S, 4, P] / rows [S, P] → masks [Q, S, num_docs] (+ tables
    [Q, S, C, num_docs] under ``with_first_hits`` / ``with_analytics``,
    in that function's order)."""
    q_n, c_n = int(cov.shape[0]), int(cov.shape[1])
    s = int(pts.shape[0])
    if q_n == 0 or s == 0:
        mask = torch.zeros((q_n, s, num_docs), dtype=torch.bool,
                           device=pts.device)
        return refine_no_hits((q_n, s), c_n, num_docs, pts.device,
                              with_first_hits, with_analytics, mask)
    outs = [refine_tracks_batched_ref(pts, rows, cov[q], num_docs,
                                      with_first_hits, with_analytics)
            for q in range(q_n)]
    if not (with_first_hits or with_analytics):
        return torch.stack(outs)
    return tuple(torch.stack(planes) for planes in zip(*outs))


# --------------------------------------------------------- flash attention

def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        softcap=None, scale=None):
    """Reference GQA attention (``repro/kernels/ref.py:298``).

    q [B, Hq, Sq, D]; k, v [B, Hkv, Skv, D]; Hq % Hkv == 0.  Query i sits
    at absolute position ``skv - sq + i`` (the decode offset); ``window``
    keeps keys in [i - window + 1, i]; ``softcap`` is tanh soft-capping.
    Computed in float32, returned in q's dtype.  A row with every key
    masked gets the mean of V (softmax over equal -1e30 logits), as the
    JAX reference does.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


#: flash_attention against this plain version, by output dtype.  bf16: one
#: ulp at the bottom of a binade (2^-7): both round the output once, and
#: the tensor-core kernel rounds P to bf16 before P·V (2^-9 a term, which
#: averages out over the keys).  float32 (SIMT): an exp approximation and
#: another summation order; ``FLASH_CASES`` in ``tests/test_torch_cuda.py``
#: hold it at 2^-12.
FLASH_REL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -12}


def flash_tolerance(want):
    """(atol, rtol) that hold a flash_attention output to ``want``, its
    plain version: rtol is ``FLASH_REL`` (an ulp of the element in bf16),
    atol the same share of max |want| (an ulp of the largest element), so
    the bound scales with the tensor compared.  Two bf16 ulps of an
    element always pass; a kernel that drops the partial last key tile at
    Whisper's encoder inputs does not (``tests/test_torch_lm.py``)."""
    rel = FLASH_REL[want.dtype]
    return rel * float(want.float().abs().max()), rel


# ------------------------------------------------------------- SSM scan

def ssm_scan_ref(a, bx, h0=None):
    """Diagonal linear recurrence h_t = a_t * h_{t-1} + bx_t
    (``repro/kernels/ref.py:360``): a, bx [B, L, D], optional h0 [B, D]
    (zeros) → (hs [B, L, D], final state [B, D]), in a's dtype."""
    bsz, length, d = a.shape
    h = torch.zeros((bsz, d), dtype=a.dtype, device=a.device) \
        if h0 is None else h0.to(a.dtype)
    hs = torch.empty_like(a)
    for t in range(length):
        h = a[:, t] * h + bx[:, t]
        hs[:, t] = h
    return hs, h


#: steps a chunk of :func:`selective_scan_ref`: it bounds the chunk's
#: [B, chunk, dI·N] intermediates; the result does not depend on it
SELECTIVE_CHUNK = 256


def selective_scan_ref(dt, x, b, c, A, h0=None):
    """A Mamba layer's selective scan as the unfused chain computes it
    (``repro/ml/mamba.py``'s chunk maths): dt, x [B, L, dI] and b, c
    [B, L, N] upcast to float32, A [dI, N], optional h0 [B, dI, N] (zeros)
    → (y [B, L, dI], final state [B, dI, N]).  A chunk at a time:
    a = exp(dt·A) and bx = (dt·x)·b over [B, c, dI, N], the recurrence
    through :func:`ssm_scan_ref` from the last chunk's state, y = Σ_n h·c."""
    bsz, length, di = dt.shape
    n = A.shape[1]
    h = torch.zeros((bsz, di * n), dtype=torch.float32, device=dt.device) \
        if h0 is None else h0.float().reshape(bsz, di * n)
    ys = [torch.zeros((bsz, 0, di), dtype=torch.float32, device=dt.device)]
    for c0 in range(0, length, SELECTIVE_CHUNK):
        cut = slice(c0, c0 + SELECTIVE_CHUNK)
        dc = dt[:, cut].float()
        cl = dc.shape[1]
        a = torch.exp(dc[..., None] * A)                    # [B, c, dI, N]
        bx = (dc * x[:, cut].float())[..., None] \
            * b[:, cut].float()[:, :, None]                 # [B, c, dI, N]
        hs, h = ssm_scan_ref(a.reshape(bsz, cl, di * n),
                             bx.reshape(bsz, cl, di * n), h)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs.view(bsz, cl, di, n),
                               c[:, cut].float()))
    return torch.cat(ys, dim=1), h.view(bsz, di, n)
