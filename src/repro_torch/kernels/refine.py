"""Exact Tesseract track refine (the ragged point-in-cover × time-window
pass, paper §2): over a wave of shards, over one shard, and for Q
coalesced queries sharing a wave.

The wrappers of ``csrc/refine.cu``, the ports of the TPU kernels in
``repro/kernels/refine.py``: ``refine_tracks_batched``
(``repro_refine_tracks_batched``), ``refine_tracks`` (the same entry at
S=1, as the TPU wrapper is) and ``refine_tracks_multi``
(``repro_refine_tracks_multi``), all three output modes.  CUDA tensors
launch the kernel; CPU tensors run the plain versions
(``ref.refine_tracks_batched_ref``, ``ref.refine_tracks_multi_ref``).

Inputs are the packed integer words of ``exec/refine.py``: ``pts``
[S, 4, P] (Morton key hi/lo, sort-keyed timestamp hi/lo), ``rows`` [S, P]
doc id per point (-1 pad), ``cov`` [C, 8, R] per constraint cover ranges
and window ([Q, C, 8, R] for the multi-query kernel, padded by
``pack_constraints_multi``).  The kernel needs each constraint's ranges
sorted and disjoint (a normalized ``AreaTree``; pad slots are the empty
range [2^64-1, 0) and sort last), because it binary-searches them.  The
first/last-hit tables come back as (hi, lo) uint32 word planes (int32
bits), the layout of the JAX package's kernel.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["refine_tracks_batched", "refine_tracks", "refine_tracks_multi",
           "MAX_CONSTRAINTS"]

#: the per-doc constraint bitset is one int32 word (bit 31 stays clear so
#: the all-hit compare never meets the sign bit)
MAX_CONSTRAINTS = 30


def _check(pts, rows, cov, cov_rank: int):
    _build.require(pts, "pts", torch.int32, 3)
    _build.require(rows, "rows", torch.int32, 2)
    _build.require(cov, "cov", torch.int32, cov_rank)
    s, four, p = pts.shape
    c, eight, r = cov.shape[-3:]
    if four != 4 or eight != 8 or tuple(rows.shape) != (s, p):
        raise ValueError(f"refine: bad shapes pts {tuple(pts.shape)}, rows "
                         f"{tuple(rows.shape)}, cov {tuple(cov.shape)}")
    if c > MAX_CONSTRAINTS:
        raise ValueError(f"refine: {c} constraints exceed the "
                         f"{MAX_CONSTRAINTS}-bit per-doc bitset")
    if not (pts.device == rows.device == cov.device):
        raise ValueError("refine: inputs lie on different devices")


def _launch(counter: str, entry: str, pts, rows, cov, num_docs: int,
            with_first_hits: bool, with_analytics: bool):
    """Launch ``entry`` on CUDA tensors; ``cov`` [Q, C, 8, R] for the
    multi entry, [C, 8, R] otherwise.  Outputs carry a leading query axis
    exactly when ``cov`` does."""
    dev = pts.device
    lead = tuple(cov.shape[:-3]) + (int(pts.shape[0]),)
    c, _, r = cov.shape[-3:]
    p = int(pts.shape[2])
    if 0 in lead or num_docs == 0 or p == 0 or c == 0 or r == 0:
        fill = 0 not in lead and num_docs > 0 and c == 0
        mask = torch.full((*lead, num_docs), fill, dtype=torch.bool,
                          device=dev)
        return _ref.refine_no_hits(lead, c, num_docs, dev, with_first_hits,
                                   with_analytics, mask)
    mode = 2 if with_analytics else (1 if with_first_hits else 0)
    bits = torch.empty((*lead, num_docs), dtype=torch.int32, device=dev)
    table = (*lead, c, num_docs) if mode else (0,)
    first = torch.empty(table, dtype=torch.int64, device=dev)
    last = torch.empty(table if mode == 2 else (0,), dtype=torch.int64,
                       device=dev)
    count = torch.empty(table if mode == 2 else (0,), dtype=torch.int32,
                        device=dev)
    dims = (*lead, p, c, r, num_docs)          # (Q,) S, P, C, R, D
    _build.launch(counter, entry, dev, pts, rows, cov, *dims,
                  mode, bits, first, last, count)
    mask = bits == (1 << c) - 1
    if mode == 0:
        return mask
    # the kernel keeps each hit time as one uint64 (t_hi << 32 | t_lo)
    # so 64-bit atomics can min/max it; split back into word planes
    out = (mask, (first >> 32).to(torch.int32), first.to(torch.int32))
    if mode == 2:
        out += ((last >> 32).to(torch.int32), last.to(torch.int32), count)
    return out


def refine_tracks_batched(pts: torch.Tensor, rows: torch.Tensor,
                          cov: torch.Tensor, num_docs: int,
                          with_first_hits: bool = False,
                          with_analytics: bool = False):
    """pts [S, 4, P] int32 words, rows [S, P] int32, cov [C, 8, R] int32
    words → hit masks [S, num_docs] bool; ``with_first_hits`` adds
    first-hit (hi, lo) tables [S, C, num_docs]; ``with_analytics`` returns
    ``(mask, fh_hi, fh_lo, lh_hi, lh_lo, count)``."""
    _check(pts, rows, cov, 3)
    if pts.device.type == "cpu":
        return _ref.refine_tracks_batched_ref(pts, rows, cov, num_docs,
                                              with_first_hits,
                                              with_analytics)
    return _launch("refine_tracks_batched", "repro_refine_tracks_batched",
                   pts, rows, cov, num_docs, with_first_hits,
                   with_analytics)


def refine_tracks(pts: torch.Tensor, rows: torch.Tensor, cov: torch.Tensor,
                  num_docs: int, with_first_hits: bool = False,
                  with_analytics: bool = False):
    """One shard: pts [4, P], rows [P], cov [C, 8, R] → hit mask
    [num_docs] bool (+ tables [C, num_docs], as
    :func:`refine_tracks_batched` at S=1)."""
    _build.require(pts, "pts", torch.int32, 2)
    _build.require(rows, "rows", torch.int32, 1)
    pts, rows = pts[None], rows[None]
    _check(pts, rows, cov, 3)
    if pts.device.type == "cpu":
        out = _ref.refine_tracks_batched_ref(pts, rows, cov, num_docs,
                                             with_first_hits,
                                             with_analytics)
    else:
        out = _launch("refine_tracks", "repro_refine_tracks_batched", pts,
                      rows, cov, num_docs, with_first_hits, with_analytics)
    if isinstance(out, tuple):
        return tuple(o[0] for o in out)
    return out[0]


def refine_tracks_multi(pts: torch.Tensor, rows: torch.Tensor,
                        cov: torch.Tensor, num_docs: int,
                        with_first_hits: bool = False,
                        with_analytics: bool = False):
    """Q coalesced queries against one wave's shared tracks: pts
    [S, 4, P], rows [S, P], cov [Q, C, 8, R] → hit masks [Q, S, num_docs]
    bool (+ tables [Q, S, C, num_docs], in
    :func:`refine_tracks_batched`'s order)."""
    _check(pts, rows, cov, 4)
    if pts.device.type == "cpu":
        return _ref.refine_tracks_multi_ref(pts, rows, cov, num_docs,
                                            with_first_hits, with_analytics)
    return _launch("refine_tracks_multi", "repro_refine_tracks_multi", pts,
                   rows, cov, num_docs, with_first_hits, with_analytics)
