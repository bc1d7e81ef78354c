"""Fused per-wave pipeline: probe → refine → compact → segment-agg as ONE
logical dispatch (paper §4: pipelined evaluation).

The port of ``repro/kernels/fused.py``'s wave composition.  Where the JAX
package fuses the stages into one ``jax.jit``, here the four hand-written
kernels (``bitset``, ``refine``, ``compact``, ``segment_agg``) and the
small tensor ops between them are enqueued on one stream with no host
sync between stages: the only sync is the caller's read-back of the
outputs.  On CPU tensors every stage is its plain PyTorch version.

Inputs are the wave-stacked buffers the backend builds:

* ``probe_stack`` [S, K, W] int32 words — row 0 the shard's valid-doc
  bitmap, rows 1.. the probe bitmaps, pad rows copies of row 0.
* ``ns`` [S] int32 — per-shard doc counts (rows beyond are padding).
* ``pts``/``rows``/``cov`` — packed ragged tracks + constraint cover, or
  ``None`` when the plan has no refine stage.
* ``codes`` [S, N] int32 — per-row group codes already offset into the
  wave-global group space (-1 = padding), or ``None`` without aggregation.
* ``vals`` — tuple of [S, N] float value stacks, one per distinct
  aggregated column (a single zeros stack for count-only plans).

Returns ``(cand [S], sel_idx [S, N], sel_counts [S], segs)`` with ``cand``
the pre-refine candidate counts, ``sel_idx``/``sel_counts`` the compacted
survivor row ids, and ``segs`` a list of ``(count, sum, sumsq)`` triples
(5-tuples with per-group min/max for ``minmax`` slots) over the
wave-global group space (``None`` without aggregation).

``profile=True`` synchronises after each stage and records its wall-clock
into :func:`stage_times`.  This module never imports ``kernels.ops``
(ops wraps *it* and owns launch counting).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

import torch

from . import bitset as _bitset
from . import compact as _compact
from . import ref as _ref
from . import refine as _refine
from . import segment_agg as _seg

__all__ = ["run_wave_fused", "first_hit_before", "record_stage",
           "stage_times", "reset_stage_times"]


# --------------------------------------------------------------------------
# Per-stage wall-clock (profile runs); engines run in worker threads.
# --------------------------------------------------------------------------

_STAGE_MS: Dict[str, float] = {}
_STAGE_LOCK = threading.Lock()


def record_stage(name: str, ms: float) -> None:
    """Accumulate ``ms`` milliseconds of wall-clock under stage ``name``."""
    with _STAGE_LOCK:
        _STAGE_MS[name] = _STAGE_MS.get(name, 0.0) + ms


def stage_times() -> Dict[str, float]:
    """Snapshot of accumulated per-stage milliseconds since last reset."""
    with _STAGE_LOCK:
        return dict(_STAGE_MS)


def reset_stage_times() -> None:
    with _STAGE_LOCK:
        _STAGE_MS.clear()


# --------------------------------------------------------------------------
# Stage bodies
# --------------------------------------------------------------------------

def _mask_stage(bm: torch.Tensor, ns: torch.Tensor,
                num_docs: int) -> torch.Tensor:
    """Word bitmaps [S, W] → per-doc bool masks [S, num_docs].  The
    arithmetic shift of an int32 word is harmless here: ``& 1`` keeps
    only the shifted-in bit 0."""
    docs = torch.arange(num_docs, dtype=torch.int64, device=bm.device)
    words = bm[:, docs >> 5]
    bits = (words >> (docs & 31).to(torch.int32)) & 1
    return (bits != 0) & (docs[None, :] < ns[:, None])


def _unpack_sort_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """uint32 (hi, lo) packed-timestamp words → float64, the inverse of
    the order-preserving IEEE-754 sort-key map (``exec.refine``)."""
    k = ((hi.to(torch.int64) & 0xFFFFFFFF) << 32) \
        | (lo.to(torch.int64) & 0xFFFFFFFF)
    bits = torch.where(k < 0, k & 0x7FFFFFFFFFFFFFFF, ~k)   # k<0: bit 63
    return bits.view(torch.float64)


def first_hit_before(fh_hi, fh_lo, i: int, j: int) -> torch.Tensor:
    """Strict first-hit order for edge (i, j): constraint ``i``'s first
    hit lies before ``j``'s (constraint axis second to last)."""
    return _ref.key64(fh_hi[..., i, :], fh_lo[..., i, :]) \
        < _ref.key64(fh_hi[..., j, :], fh_lo[..., j, :])


def _reduction_verdict(fh_hi, fh_lo, lh_hi, lh_lo, cnt, edges,
                       min_counts, dwells) -> torch.Tensor:
    """Per-doc verdict recomputed from the reduction tables.  The
    kernel's all-hit mask can't express k=0 (vacuous) constraints, so the
    verdict ANDs per-constraint ``ok`` terms built from the count table
    instead: ``doc_hit ≡ cnt > 0`` exactly."""
    out = None
    for c in range(cnt.shape[-2]):
        doc_hit = cnt[..., c, :] > 0
        k = int(min_counts[c]) if c < len(min_counts) else 1
        if k == 1:
            ok = doc_hit
        elif k <= 0:
            ok = torch.ones_like(doc_hit)
        else:
            ok = cnt[..., c, :] >= k
        d = dwells[c] if c < len(dwells) else None
        if d is not None:
            span = _unpack_sort_key(lh_hi[..., c, :], lh_lo[..., c, :]) \
                - _unpack_sort_key(fh_hi[..., c, :], fh_lo[..., c, :])
            ok = ok & doc_hit & (span >= float(d))
        out = ok if out is None else (out & ok)
    for i, j in edges:               # A-then-B: first hit of i before j's
        out = out & first_hit_before(fh_hi, fh_lo, i, j)
    return out


def _has_reductions(min_counts, dwells) -> bool:
    return any(int(k) != 1 for k in min_counts) \
        or any(d is not None for d in dwells)


def _refine_stage(pts, rows, cov, num_docs: int,
                  edges: Tuple[Tuple[int, int], ...],
                  min_counts: Tuple[int, ...] = (),
                  dwells: Tuple[Optional[float], ...] = ()):
    wa = _has_reductions(min_counts, dwells)
    wf = bool(edges) and not wa
    r = _refine.refine_tracks_batched(pts, rows, cov, num_docs,
                                      with_first_hits=wf,
                                      with_analytics=wa)
    if wa:
        _, fh_hi, fh_lo, lh_hi, lh_lo, cnt = r
        return _reduction_verdict(fh_hi, fh_lo, lh_hi, lh_lo, cnt, edges,
                                  min_counts, dwells)
    if not wf:
        return r
    out, fh_hi, fh_lo = r
    for i, j in edges:
        out = out & first_hit_before(fh_hi, fh_lo, i, j)
    return out


def _agg_stage(mask, codes, vals, total_groups: int,
               minmax: Tuple[bool, ...] = ()):
    """Per-value-slot segment partials over the wave-global group space.
    Slots flagged in ``minmax`` add per-group min/max planes (±inf for
    groups without rows, dropped by the backend's ``count > 0`` filter)."""
    gc = torch.where(mask, codes, -1).reshape(-1)
    # masked rows reduce into one extra slot that is sliced off (a boolean
    # gather would need a host sync for its length)
    slot = (torch.where(gc >= 0, gc, total_groups).to(torch.int64)
            if any(minmax) else None)
    segs = []
    for k, v in enumerate(vals):
        vv = v.reshape(-1)
        seg = _seg.segment_agg(gc, vv, total_groups)
        if k < len(minmax) and minmax[k]:
            mn = torch.full((total_groups + 1,), float("inf"),
                            dtype=vv.dtype, device=vv.device)
            mx = torch.full((total_groups + 1,), float("-inf"),
                            dtype=vv.dtype, device=vv.device)
            mn.scatter_reduce_(0, slot, vv, reduce="amin")
            mx.scatter_reduce_(0, slot, vv, reduce="amax")
            seg = (*seg, mn[:total_groups], mx[:total_groups])
        segs.append(seg)
    return segs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_wave_fused(probe_stack, ns, pts=None, rows=None, cov=None,
                   codes=None, vals=(), *, num_docs: int,
                   edges=(), min_counts=(), dwells=(),
                   total_groups: int = 0, profile: bool = False,
                   minmax=()):
    """Run one wave through the fused pipeline (see module docstring)."""
    edges = tuple(tuple(e) for e in edges)
    min_counts = tuple(int(k) for k in min_counts)
    dwells = tuple(None if d is None else float(d) for d in dwells)
    minmax = tuple(bool(m) for m in minmax)
    dev = probe_stack.device
    clock = time.perf_counter
    t0 = clock()
    bm, _ = _bitset.bitmap_intersect_batched(probe_stack)
    mask = _mask_stage(bm, ns, num_docs)
    cand = mask.sum(dim=1, dtype=torch.int32)
    if profile:
        _sync(dev)
        t1 = clock()
        record_stage("probe", (t1 - t0) * 1e3)
        t0 = t1
    if pts is not None:
        mask = mask & _refine_stage(pts, rows, cov, num_docs, edges,
                                    min_counts, dwells)
        if profile:
            _sync(dev)
            t1 = clock()
            record_stage("refine", (t1 - t0) * 1e3)
            t0 = t1
    sel_idx, sel_counts = _compact.compact_batched(mask)
    if profile:
        _sync(dev)
        t1 = clock()
        record_stage("compact", (t1 - t0) * 1e3)
        t0 = t1
    segs = None
    if total_groups > 0:
        segs = _agg_stage(mask, codes, tuple(vals), total_groups, minmax)
        if profile:
            _sync(dev)
            record_stage("agg", (clock() - t0) * 1e3)
    return cand, sel_idx, sel_counts, segs
