"""Entry points for the port's kernels, with the logical dispatch counter.

Every public op records one **launch** per call in a process-wide counter
(:func:`launch_counts` / :func:`reset_launch_counts`) — one logical
dispatch, which is what the batched execution path amortizes (one
``*_batched`` launch per wave of shards instead of one per shard).  Tests
and ``chip_smoke.py`` use it to assert the ⌈shards/wave⌉ contract.
:func:`run_wave_fused` is one logical dispatch covering *all* stages of a
wave (probe → refine → compact → segment-agg; see ``kernels.fused``).

There is no implementation switch: each op takes the device of its
inputs.  CUDA tensors launch the hand-written kernels (whose own
per-kernel counter is ``kernels._build.kernel_launches``); CPU tensors
run their plain PyTorch versions.
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Dict

from . import bitset as _bitset
from . import compact as _compact
from . import flash_attention as _fa
from . import fused as _fused
from . import merge as _merge
from . import refine as _refine
from . import segment_agg as _seg
from . import selective_scan as _sel
from . import ssm_scan as _ssm

__all__ = ["bitmap_binary", "bitmap_intersect", "bitmap_intersect_batched",
           "compact", "compact_batched", "segment_agg", "refine_tracks",
           "refine_tracks_batched", "refine_tracks_multi", "run_wave_fused",
           "run_wave_fused_multi", "postings_bitmap", "segment_hll",
           "merge_partials", "flash_attention", "ssm_scan",
           "selective_scan", "launch_counts", "reset_launch_counts",
           "record_launch"]


# --------------------------------------------------------------------------
# Launch counting — engines dispatch from many worker threads concurrently,
# so the process-wide counter is lock-protected.
# --------------------------------------------------------------------------

_LAUNCHES: Counter = Counter()
_LAUNCH_LOCK = threading.Lock()


def record_launch(op: str) -> None:
    """Count one logical kernel dispatch under ``op``."""
    with _LAUNCH_LOCK:
        _LAUNCHES[op] += 1


def launch_counts() -> Dict[str, int]:
    """Snapshot of per-op dispatch counts, over all threads, since the
    last reset."""
    with _LAUNCH_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    """Zero the counter."""
    with _LAUNCH_LOCK:
        _LAUNCHES.clear()


# --------------------------------------------------------------------------
# Ops
# --------------------------------------------------------------------------

def bitmap_binary(a, b, op: str = "and"):
    """Word-wise ``and`` / ``or`` / ``andnot`` of two [W] bitmaps."""
    record_launch("bitmap_binary")
    return _bitset.bitset_binary(a, b, op)


def bitmap_intersect(stack):
    """Single-shard AND-reduce [K, W] → (bitmap [W], total popcount)."""
    record_launch("bitmap_intersect")
    return _bitset.bitmap_intersect(stack)


def bitmap_intersect_batched(stack):
    """Wave-stacked AND-reduce [S, K, W] → (bitmaps [S, W], counts [S])."""
    record_launch("bitmap_intersect_batched")
    return _bitset.bitmap_intersect_batched(stack)


def compact(mask):
    """Single-mask compaction [N] → (indices [N], -1 padded; count)."""
    record_launch("compact")
    return _compact.compact(mask)


def compact_batched(masks):
    """Wave-stacked compaction [S, N] → (indices [S, N], counts [S])."""
    record_launch("compact_batched")
    return _compact.compact_batched(masks)


def segment_agg(group_ids, values, num_groups: int):
    """Per-group (count, sum, sumsq) over [N] group ids (< 0 masked)."""
    record_launch("segment_agg")
    return _seg.segment_agg(group_ids, values, num_groups)


def refine_tracks(pts, rows, cov, num_docs: int,
                  with_first_hits: bool = False,
                  with_analytics: bool = False):
    """One shard's refine [4, P] × [C, 8, R] → hit mask [num_docs]
    (+ tables [C, num_docs], as ``refine_tracks_batched``)."""
    record_launch("refine_tracks")
    return _refine.refine_tracks(pts, rows, cov, num_docs,
                                 with_first_hits=with_first_hits,
                                 with_analytics=with_analytics)


def refine_tracks_batched(pts, rows, cov, num_docs: int,
                          with_first_hits: bool = False,
                          with_analytics: bool = False):
    """Wave-stacked refine [S, 4, P] × [C, 8, R] → hit masks
    [S, num_docs] (+ first-hit word tables under ``with_first_hits``; the
    full reduction family under ``with_analytics``) — one launch."""
    record_launch("refine_tracks_batched")
    return _refine.refine_tracks_batched(pts, rows, cov, num_docs,
                                         with_first_hits=with_first_hits,
                                         with_analytics=with_analytics)


def refine_tracks_multi(pts, rows, cov, num_docs: int,
                        with_first_hits: bool = False,
                        with_analytics: bool = False):
    """Q coalesced queries' refine: shared [S, 4, P] tracks × per-query
    [Q, C, 8, R] tables → hit masks [Q, S, num_docs] (+ tables
    [Q, S, C, num_docs]) — one launch."""
    record_launch("refine_tracks_multi")
    return _refine.refine_tracks_multi(pts, rows, cov, num_docs,
                                       with_first_hits=with_first_hits,
                                       with_analytics=with_analytics)


def run_wave_fused(probe_stack, ns, pts=None, rows=None, cov=None,
                   codes=None, vals=(), *, num_docs: int, edges=(),
                   min_counts=(), dwells=(), total_groups: int = 0,
                   profile: bool = False, minmax=()):
    """Whole-wave pipeline (probe → refine → compact → segment-agg) as ONE
    logical dispatch — see ``kernels.fused``.  The fused path's
    ⌈shards/wave⌉ *total*-dispatch contract hangs off this counter."""
    record_launch("run_wave_fused")
    return _fused.run_wave_fused(probe_stack, ns, pts, rows, cov, codes,
                                 vals, num_docs=num_docs, edges=edges,
                                 min_counts=min_counts, dwells=dwells,
                                 total_groups=total_groups, profile=profile,
                                 minmax=minmax)


def run_wave_fused_multi(probe_stacks, ns, pts=None, rows=None, cov=None, *,
                         num_docs: int, edges_multi=(), min_counts_multi=(),
                         dwells_multi=()):
    """Q coalesced queries through one wave (probe → refine → compact) as
    ONE logical dispatch — see ``kernels.fused``.  Q coalesced queries
    still cost ⌈shards/wave⌉ **total** dispatches: the serve-layer
    contract hangs off this counter."""
    record_launch("run_wave_fused_multi")
    return _fused.run_wave_fused_multi(probe_stacks, ns, pts, rows, cov,
                                       num_docs=num_docs,
                                       edges_multi=edges_multi,
                                       min_counts_multi=min_counts_multi,
                                       dwells_multi=dwells_multi)


def postings_bitmap(ids, t_min, t_max, t0: float, t1: float, n_docs: int):
    """Spacetime postings OR + track-span prune on the device (the tail of
    ``SpaceTimeIndex.lookup``; plain PyTorch, as the JAX package's is
    plain jnp) — one logical dispatch."""
    record_launch("postings_bitmap")
    return _fused.postings_bitmap(ids, t_min, t_max, t0, t1, n_docs)


def segment_hll(group_ids, regs, num_groups: int):
    """Per-group HyperLogLog register max: group_ids [N] (< 0 masked out)
    × regs [N, M] uint8 register rows → [num_groups, M] maxed planes.
    Plain PyTorch, as the JAX package's is plain jnp, but one logical
    dispatch all the same."""
    record_launch("segment_hll")
    return _fused.segment_hll(group_ids, regs, num_groups)


def merge_partials(cnt, s, s2, mn, mx, msk):
    """Cross-partition combine of aligned segment-aggregate state stacks
    [S, K, G] (counts/sums/sum-squares in states order, min/max planes
    element-wise, presence masks OR) — one logical dispatch: the
    partitioned launch contract is Σ_p ⌈shards_p/wave⌉ fused dispatches
    plus exactly one combine per aggregated query."""
    record_launch("merge_partials")
    return _merge.merge_partials(cnt, s, s2, mn, mx, msk)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    softcap=None, scale=None):
    """Forward GQA attention q [B, Hq, Sq, D] × k/v [B, Hkv, Skv, D] →
    [B, Hq, Sq, D] (causal at the decode offset, window, softcap)."""
    record_launch("flash_attention")
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale)


def ssm_scan(a, bx, h0=None):
    """h_t = a_t * h_{t-1} + bx_t over [B, L, D] from h0 [B, D] (zeros) →
    (h [B, L, D], h_final [B, D])."""
    record_launch("ssm_scan")
    return _ssm.ssm_scan(a, bx, h0)


def selective_scan(dt, x, b, c, A, h0=None):
    """A Mamba layer's selective scan in one launch: dt, x [B, L, dI],
    b, c [B, L, N], A [dI, N] from h0 [B, dI, N] (zeros) → (y [B, L, dI],
    h_final [B, dI, N]), float32."""
    record_launch("selective_scan")
    return _sel.selective_scan(dt, x, b, c, A, h0)
