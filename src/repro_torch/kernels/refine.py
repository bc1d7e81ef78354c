"""Exact Tesseract track refine (the ragged point-in-cover × time-window
pass, paper §2): over a wave of shards, over one shard, and for Q
coalesced queries sharing a wave.

The wrappers of ``csrc/refine.cu``'s one entry point
(``repro_refine_tracks``), the ports of the TPU kernels in
``repro/kernels/refine.py``: ``refine_tracks_batched`` (Q = 1),
``refine_tracks`` (the same at S=1, as the TPU wrapper is) and
``refine_tracks_multi``, all three output modes.  Each counts one launch
under its own name.  CUDA tensors launch the kernel; CPU tensors run the
plain versions (``ref.refine_tracks_batched_ref``,
``ref.refine_tracks_multi_ref``).

Inputs are the packed integer words of ``exec/refine.py``: ``pts``
[S, 4, P] (Morton key hi/lo, sort-keyed timestamp hi/lo), ``rows`` [S, P]
doc id per point (-1 pad), ``cov`` [C, 8, R] per constraint cover ranges
and window ([Q, C, 8, R] for the multi-query kernel, padded by
``pack_constraints_multi``).  The kernel needs each constraint's range
lo words sorted (a normalized ``AreaTree``; pad slots are the empty range
[2^64-1, 0) and sort last), because it searches them.  The first/last-hit
tables come back as (hi, lo) uint32 word planes (int32 bits), the layout
of the JAX package's kernel.  One cooperative launch writes every output
(the mask and the word planes included), and they are views of one buffer
(:func:`alloc_outputs`) that also holds the kernel's scratch.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["refine_tracks_batched", "refine_tracks", "refine_tracks_multi",
           "alloc_outputs", "MAX_CONSTRAINTS"]

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


def _record_words(c: int, r: int) -> int:
    """64-bit words of one query's table as the kernel lays it out in its
    scratch: C windows, C fence arrays, C arrays of (lo, hi) pairs
    (``record_words`` in ``csrc/refine.cu``, which checks the size)."""
    return c * (2 + 2 * -(-r // 64) + 2 * r)


def alloc_outputs(lead: tuple, c: int, r: int, num_docs: int, mode: int,
                  device):
    """One int64 buffer for a launch of ``repro_refine_tracks``, cut into
    the kernel's scratch and its outputs.  Returns ``(scratch, outputs)``.
    ``scratch`` is (tab, acc, first, last, bits): the laid-out tables,
    then ``acc``, the words the kernel zeroes, one slice holding the
    complemented first hit and the last hit int64 [*lead, C, D], the
    per-doc bitsets int32 [*lead, D], the count and last the kernel's
    work-item counter.  ``outputs`` is the wrapper's result: the mask
    [*lead, D] bool, then in mode 1 the first-hit (hi, lo) planes
    [*lead, C, D] int32, in mode 2 also the last-hit planes and the count
    (a view inside ``acc``).  Slices a mode does not use are ``None``."""
    d = num_docs
    q = 1
    for x in lead[:-1]:
        q *= int(x)
    n = q * int(lead[-1]) * d
    t = n * c
    tab = q * _record_words(c, r)
    n1, n2 = t if mode >= 1 else 0, t if mode == 2 else 0
    # first, last; bits, count; the kernel's work-item counter
    acc = n1 + n2 + -(-(n + n2) // 2) + 1
    w64 = tab + acc
    n32 = 2 * n1 + 2 * n2                     # fh and lh (hi, lo) planes
    buf = torch.empty((-(-(8 * w64 + 4 * n32 + n) // 8),), dtype=torch.int64,
                      device=device)
    first, last = buf[tab:tab + n1], buf[tab + n1:tab + n1 + n2]
    a32 = buf[tab + n1 + n2:w64].view(torch.int32)
    p32 = buf[w64:].view(torch.int32)
    planes = [p32[k * t:(k + 1) * t].view(*lead, c, d)
              for k in range(n32 // max(t, 1))]
    mask = buf[w64:].view(torch.uint8)[4 * n32:4 * n32 + n] \
        .view(torch.bool).view(*lead, d)
    scratch = (buf[:tab], buf[tab:w64], first if n1 else None,
               last if n2 else None, a32[:n])
    if mode == 2:
        planes.append(a32[n:n + n2].view(*lead, c, d))
    return scratch, (mask, *planes)


def _launch(counter: str, pts, rows, cov, num_docs: int,
            with_first_hits: bool, with_analytics: bool):
    """Launch ``repro_refine_tracks`` on CUDA tensors; ``cov``
    [Q, C, 8, R] for the multi-query wrapper, [C, 8, R] otherwise.
    Outputs carry a leading query axis exactly when ``cov`` does."""
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
    (tab, acc, first, last, bits), out = alloc_outputs(lead, c, r,
                                                       num_docs, mode, dev)
    planes = out[1:] + (None,) * (5 - len(out[1:]))
    q = lead[0] if len(lead) == 2 else 1
    _build.launch(counter, "repro_refine_tracks", dev, pts, rows, cov, q,
                  lead[-1], p, c, r, num_docs, mode, tab, tab.numel(), acc,
                  acc.numel(), first, last, bits, planes[4],
                  *planes[:4], out[0])
    return out if mode else out[0]


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
    return _launch("refine_tracks_batched", pts, rows, cov, num_docs,
                   with_first_hits, with_analytics)


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
        out = _launch("refine_tracks", pts, rows, cov, num_docs,
                      with_first_hits, with_analytics)
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
    return _launch("refine_tracks_multi", pts, rows, cov, num_docs,
                   with_first_hits, with_analytics)
