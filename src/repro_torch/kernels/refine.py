"""Exact Tesseract track refine over a wave of shards (the ragged
point-in-cover × time-window pass, paper §2).

The wrapper of ``csrc/refine.cu`` (``repro_refine_tracks_batched``), the
port of the TPU kernel ``repro/kernels/refine.py``
``refine_tracks_batched``, all three output modes.  CUDA tensors launch
the kernel; CPU tensors run the plain version
(``ref.refine_tracks_batched_ref``).

Inputs are the packed integer words of ``exec/refine.py``: ``pts``
[S, 4, P] (Morton key hi/lo, sort-keyed timestamp hi/lo), ``rows`` [S, P]
doc id per point (-1 pad), ``cov`` [C, 8, R] per constraint cover ranges
and window.  The kernel needs each constraint's ranges sorted and
disjoint (a normalized ``AreaTree``; pad slots are the empty range
[2^64-1, 0) and sort last), because it binary-searches them.  The
first/last-hit tables come back as (hi, lo) uint32 word planes (int32
bits), the layout of the JAX package's kernel.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["refine_tracks_batched", "MAX_CONSTRAINTS"]

#: the per-doc constraint bitset is one int32 word (bit 31 stays clear so
#: the all-hit compare never meets the sign bit)
MAX_CONSTRAINTS = 30


def refine_tracks_batched(pts: torch.Tensor, rows: torch.Tensor,
                          cov: torch.Tensor, num_docs: int,
                          with_first_hits: bool = False,
                          with_analytics: bool = False):
    """pts [S, 4, P] int32 words, rows [S, P] int32, cov [C, 8, R] int32
    words → hit masks [S, num_docs] bool; ``with_first_hits`` adds
    first-hit (hi, lo) tables [S, C, num_docs]; ``with_analytics`` returns
    ``(mask, fh_hi, fh_lo, lh_hi, lh_lo, count)``."""
    _build.require(pts, "pts", torch.int32, 3)
    _build.require(rows, "rows", torch.int32, 2)
    _build.require(cov, "cov", torch.int32, 3)
    s, four, p = pts.shape
    c, eight, r = cov.shape
    if four != 4 or eight != 8 or tuple(rows.shape) != (s, p):
        raise ValueError(f"refine: bad shapes pts {tuple(pts.shape)}, rows "
                         f"{tuple(rows.shape)}, cov {tuple(cov.shape)}")
    if c > MAX_CONSTRAINTS:
        raise ValueError(f"refine: {c} constraints exceed the "
                         f"{MAX_CONSTRAINTS}-bit per-doc bitset")
    if not (pts.device == rows.device == cov.device):
        raise ValueError("refine: inputs lie on different devices")
    if pts.device.type == "cpu":
        return _ref.refine_tracks_batched_ref(pts, rows, cov, num_docs,
                                              with_first_hits,
                                              with_analytics)
    dev = pts.device
    if s == 0 or num_docs == 0 or p == 0 or c == 0 or r == 0:
        fill = s > 0 and num_docs > 0 and c == 0
        mask = torch.full((s, num_docs), fill, dtype=torch.bool, device=dev)
        return _ref.refine_no_hits(s, c, num_docs, dev, with_first_hits,
                                   with_analytics, mask)
    mode = 2 if with_analytics else (1 if with_first_hits else 0)
    bits = torch.empty((s, num_docs), dtype=torch.int32, device=dev)
    table = (s, c, num_docs) if mode else (0,)
    first = torch.empty(table, dtype=torch.int64, device=dev)
    last = torch.empty(table if mode == 2 else (0,), dtype=torch.int64,
                       device=dev)
    count = torch.empty(table if mode == 2 else (0,), dtype=torch.int32,
                        device=dev)
    _build.launch("refine_tracks_batched", "refine",
                  "repro_refine_tracks_batched", dev, pts, rows, cov,
                  s, p, c, r, num_docs, mode, bits, first, last, count)
    mask = bits == (1 << c) - 1
    if mode == 0:
        return mask
    # the kernel keeps each hit time as one uint64 (t_hi << 32 | t_lo)
    # so 64-bit atomics can min/max it; split back into word planes
    out = (mask, (first >> 32).to(torch.int32), first.to(torch.int32))
    if mode == 2:
        out += ((last >> 32).to(torch.int32), last.to(torch.int32), count)
    return out
