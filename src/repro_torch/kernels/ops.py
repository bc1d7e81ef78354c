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
from . import fused as _fused
from . import refine as _refine
from . import segment_agg as _seg

__all__ = ["bitmap_intersect_batched", "compact_batched", "segment_agg",
           "refine_tracks_batched", "run_wave_fused", "launch_counts",
           "reset_launch_counts", "record_launch"]


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

def bitmap_intersect_batched(stack):
    """Wave-stacked AND-reduce [S, K, W] → (bitmaps [S, W], counts [S])."""
    record_launch("bitmap_intersect_batched")
    return _bitset.bitmap_intersect_batched(stack)


def compact_batched(masks):
    """Wave-stacked compaction [S, N] → (indices [S, N], counts [S])."""
    record_launch("compact_batched")
    return _compact.compact_batched(masks)


def segment_agg(group_ids, values, num_groups: int):
    """Per-group (count, sum, sumsq) over [N] group ids (< 0 masked)."""
    record_launch("segment_agg")
    return _seg.segment_agg(group_ids, values, num_groups)


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
