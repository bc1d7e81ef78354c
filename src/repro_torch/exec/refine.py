"""Host-side packing + numpy oracle for the ragged track refine.

The exact Tesseract pass — "some track point inside the region's cover
during the window, for every constraint" — runs in two shapes:

  * :func:`refine_tracks_host` — the numpy oracle over raw CSR
    ``(lat, lng, t, row_splits)`` columns, semantically identical to
    ``eval_expr(InSpaceTime)`` (``repro_torch.core.exprs``).  It optionally
    restricts work to candidate docs (the index-probe survivors) via a
    spans-concatenate gather, which is what the per-shard host path runs.
  * the device kernel (``repro_torch.kernels.refine``), which consumes the
    *packed* integer form built here: Morton keys and order-mapped float64
    timestamps split into uint32 (hi, lo) word pairs, plus the per-point
    doc-id expansion of ``row_splits``.  Packing is a pure function of the
    stored track, so the torch backend computes it once per shard at
    ``prime_fdb`` time and keeps it device-resident.

Both shapes are exact bit/integer work on the same inputs, so backend
results are byte-identical (the parity contract the tests enforce) — and
both produce the same per-(doc × constraint) **reduction tables** from the
one-hot compare pass: the **first-hit** table (minimum packed timestamp
among a doc's points satisfying a constraint, :data:`FIRST_HIT_NONE` when
none) that ordered (A-then-B) queries compare edge-wise, the dual
**last-hit** max table (:data:`LAST_HIT_NONE` when none), and the
per-constraint **hit count** — the inputs to ``Tesseract.at_least(k)``
("≥ k points in A") and ``Tesseract.dwell(min_s)`` (last − first ≥ n
seconds, compared on the unpacked float64 values — the sort key preserves
order, not differences).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..fdb.columnar import span_indices
from ..geo import mercator as M

__all__ = ["f64_sort_key", "f64_from_sort_key", "pack_track_points",
           "pack_constraints", "pack_constraints_multi",
           "refine_tracks_host", "reduction_verdict", "FIRST_HIT_NONE",
           "LAST_HIT_NONE"]

_U32 = np.uint64(0xFFFFFFFF)
_SHIFT32 = np.uint64(32)

#: first-hit sentinel: a (cell, t) pair no finite timestamp maps to —
#: ``f64_sort_key`` reaches 0xFFFF… only for NaN payloads, and NaN
#: timestamps never satisfy a window compare, so "no hit" is unambiguous
FIRST_HIT_NONE = np.uint64(0xFFFFFFFFFFFFFFFF)

#: last-hit sentinel, the max-reduce dual: ``f64_sort_key`` reaches 0 only
#: for negative NaN payloads, which never satisfy a window compare
LAST_HIT_NONE = np.uint64(0)


def f64_sort_key(t) -> np.ndarray:
    """Map float64 → uint64 preserving order: flip all bits of negatives,
    set the sign bit of non-negatives (−0.0 is first normalized to +0.0 so
    the two zeros stay equal).  Lets the kernel compare timestamps with
    exact integer word compares instead of device float64."""
    t = np.asarray(t, dtype=np.float64) + 0.0       # −0.0 + 0.0 → +0.0
    bits = t.view(np.uint64)
    neg = bits >> np.uint64(63) != 0
    return np.where(neg, ~bits, bits | np.uint64(1) << np.uint64(63))


def f64_from_sort_key(k) -> np.ndarray:
    """Inverse of :func:`f64_sort_key`: uint64 order key → float64.

    Dwell predicates need real time *differences* — the sort key preserves
    order, not arithmetic — so last/first keys are unpacked before the
    ``last − first >= min_s`` compare.  Sentinel keys unpack to NaN
    payloads, which fail any dwell compare.
    """
    k = np.asarray(k, dtype=np.uint64)
    sign = k >> np.uint64(63) != 0
    bits = np.where(sign, k & ~(np.uint64(1) << np.uint64(63)), ~k)
    return bits.view(np.float64)


def _split_words(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    v = np.asarray(v, dtype=np.uint64)
    return ((v >> _SHIFT32).astype(np.uint32),
            (v & _U32).astype(np.uint32))


def pack_track_points(lat: np.ndarray, lng: np.ndarray, t: np.ndarray,
                      row_splits: Optional[np.ndarray]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """CSR track columns → (pts uint32 [4, P], rows int32 [P]).

    pts rows are (key_hi, key_lo, t_hi, t_lo); rows is the per-point doc
    id (``row_splits`` expanded; identity for singular location fields).
    """
    keys = M.latlng_to_morton(lat, lng)
    k_hi, k_lo = _split_words(keys)
    t_hi, t_lo = _split_words(f64_sort_key(t))
    pts = np.stack([k_hi, k_lo, t_hi, t_lo]).astype(np.uint32)
    if row_splits is None:
        rows = np.arange(keys.size, dtype=np.int32)
    else:
        rows = np.repeat(
            np.arange(row_splits.size - 1, dtype=np.int32),
            np.diff(row_splits))
    return pts, rows


def pack_constraints(constraints: Sequence[Tuple[object, float, float]]
                     ) -> np.ndarray:
    """[(AreaTree, t0, t1), …] → uint32 [C, 8, R] word table.

    Slot r of constraint c holds (cover-range lo, hi) and the constraint's
    (window lo, hi), each split into (hi, lo) 32-bit words.  Range slots
    beyond the region's cover are the empty range (lo = 2^64−1, hi = 0) —
    never satisfiable — while window words fill every slot so the kernel
    and reference can read them from any slot.
    """
    n_c = len(constraints)
    r_pad = 128
    for region, _, _ in constraints:
        r_pad = max(r_pad, -(-int(region.lo.size) // 128) * 128)
    cov = np.zeros((n_c, 8, r_pad), dtype=np.uint32)
    cov[:, 0, :] = 0xFFFFFFFF                      # empty-range padding
    cov[:, 1, :] = 0xFFFFFFFF
    for c, (region, t0, t1) in enumerate(constraints):
        r = int(region.lo.size)
        if r:
            cov[c, 0, :r], cov[c, 1, :r] = _split_words(region.lo)
            cov[c, 2, :r], cov[c, 3, :r] = _split_words(region.hi)
        w0_hi, w0_lo = _split_words(f64_sort_key(t0))
        w1_hi, w1_lo = _split_words(f64_sort_key(t1))
        cov[c, 4, :] = w0_hi
        cov[c, 5, :] = w0_lo
        cov[c, 6, :] = w1_hi
        cov[c, 7, :] = w1_lo
    return cov


def pack_constraints_multi(constraints_list) -> np.ndarray:
    """Q queries' constraint lists → one uint32 ``[Q, C_max, 8, R_max]``
    table for the multi-query refine kernel.

    Per-query tables (:func:`pack_constraints`) are padded to a common
    shape: the range axis with the never-hit empty range, the constraint
    axis with **always-hit** pad constraints — one range slot covering the
    whole key space ``[0, 2^64)`` with a ``[0, 2^64)`` window, satisfied
    by any doc that has at least one point.  Padding is sound because
    every query carries ≥1 real constraint (the coalescer guarantees it):
    a doc passing its real constraints necessarily has a point, so the pad
    bit is set too; a doc with no points fails its real constraints
    anyway.  Pad constraints never appear in ordering edges.
    """
    covs = [pack_constraints(list(cons)) for cons in constraints_list]
    if not covs:
        return np.zeros((0, 0, 8, 128), dtype=np.uint32)
    c_max = max(c.shape[0] for c in covs)
    r_max = max(c.shape[2] for c in covs)
    out = np.zeros((len(covs), c_max, 8, r_max), dtype=np.uint32)
    # never-hit default for every slot of every (possibly padded) row
    out[:, :, 0, :] = 0xFFFFFFFF
    out[:, :, 1, :] = 0xFFFFFFFF
    for q, cov in enumerate(covs):
        c, _, r = cov.shape
        out[q, :c, :, :r] = cov
        # re-assert never-hit on the R pad of real constraints (the copy
        # above overwrote columns [:r] only; [r:] keeps the default) and
        # fill the C pad rows with the always-hit constraint
        for cp in range(c, c_max):
            out[q, cp, 0, 0] = 0        # key >= 0
            out[q, cp, 1, 0] = 0
            out[q, cp, 2, 0] = 0xFFFFFFFF   # key < 2^64−1 (keys are 60-bit)
            out[q, cp, 3, 0] = 0xFFFFFFFF
            out[q, cp, 4, :] = 0        # window [0, 2^64−1]: always true
            out[q, cp, 5, :] = 0
            out[q, cp, 6, :] = 0xFFFFFFFF
            out[q, cp, 7, :] = 0xFFFFFFFF
    return out


def reduction_verdict(first: np.ndarray, last: np.ndarray,
                      count: np.ndarray, edges: Sequence[Tuple[int, int]]
                      = (), min_counts: Optional[Sequence[int]] = None,
                      dwells: Optional[Sequence[Optional[float]]] = None
                      ) -> np.ndarray:
    """Per-doc verdict recomputed from host reduction tables.

    ``first``/``last`` uint64 [n_docs, C], ``count`` int [n_docs, C] —
    the tables :func:`refine_tracks_host` (or the synced kernel outputs)
    produce.  The kernel's all-constraints-hit mask can't express a
    ``k = 0`` (vacuous) constraint, so the torch backend recomputes the
    verdict from the count table whenever reductions are present:
    ``doc_hit ≡ count > 0`` exactly, byte-equal to the oracle's verdict.
    """
    n_docs, n_c = count.shape
    out = np.ones(n_docs, dtype=bool)
    for c in range(n_c):
        doc_hit = count[:, c] > 0
        k = 1 if min_counts is None else int(min_counts[c])
        if k == 1:
            ok = doc_hit
        elif k <= 0:
            ok = np.ones(n_docs, dtype=bool)
        else:
            ok = count[:, c] >= k
        d = None if dwells is None else dwells[c]
        if d is not None:
            span = f64_from_sort_key(last[:, c]) \
                - f64_from_sort_key(first[:, c])
            ok = ok & doc_hit & (span >= float(d))
        out &= ok
    for i, j in edges:
        out &= first[:, i] < first[:, j]
    return out


def refine_tracks_host(lat: np.ndarray, lng: np.ndarray, t: np.ndarray,
                       row_splits: Optional[np.ndarray], n_docs: int,
                       constraints: Sequence[Tuple[object, float, float]],
                       candidates: Optional[np.ndarray] = None,
                       edges: Sequence[Tuple[int, int]] = (),
                       with_first_hits: bool = False,
                       min_counts: Optional[Sequence[int]] = None,
                       dwells: Optional[Sequence[Optional[float]]] = None,
                       with_analytics: bool = False):
    """Numpy oracle: exact per-doc refine mask [n_docs] bool.

    ``candidates`` (bool [n_docs]) restricts evaluation to the index-probe
    survivors — docs outside it come back False, and because the per-doc
    verdict is independent of other docs, the result equals
    ``full_refine & candidates`` bit for bit.

    ``edges`` is the ordering DAG over ``constraints``: edge ``(i, j)``
    additionally requires the doc's **first hit** of constraint ``i`` to be
    strictly before its first hit of constraint ``j``, where first hit =
    the lexicographic-minimum packed timestamp (``f64_sort_key``) among the
    doc's points satisfying the constraint, or :data:`FIRST_HIT_NONE` when
    none do.  Equal first hits do not count as before.

    ``min_counts[c] = k`` replaces the "≥ 1 hit" verdict for constraint
    ``c`` with "≥ k hits" (each satisfying track point counts once).
    ``k = 0`` is vacuously true — the constraint stops filtering (the
    planner also drops its index probe so un-hit docs survive to refine).
    ``dwells[c] = d`` additionally requires the doc to have spent at least
    ``d`` seconds in the constraint: ≥ 1 hit and
    ``t(last hit) − t(first hit) >= d`` on the unpacked float64 values
    (inclusive at the threshold; a single hit satisfies only ``d <= 0``).

    ``with_first_hits`` returns ``(mask, first)`` with ``first`` the
    uint64 ``[n_docs, C]`` first-hit table (sentinel outside ``candidates``
    when restricted); ``with_analytics`` returns
    ``(mask, first, last, count)`` adding the uint64 last-hit table
    (:data:`LAST_HIT_NONE` when no hit) and int64 hit-count table — the
    parity surfaces the CUDA kernel must match byte for byte.
    """
    n_c = len(constraints)
    edges = list(edges)
    any_dwell = dwells is not None and any(d is not None for d in dwells)
    need_first = bool(edges) or with_first_hits or with_analytics or any_dwell
    need_last = with_analytics or any_dwell
    need_count = with_analytics or min_counts is not None
    first = np.full((n_docs, n_c), FIRST_HIT_NONE, dtype=np.uint64) \
        if need_first else None
    last = np.full((n_docs, n_c), LAST_HIT_NONE, dtype=np.uint64) \
        if need_last else None
    count = np.zeros((n_docs, n_c), dtype=np.int64) if need_count else None

    def ok_of(c, doc_hit):
        ok = doc_hit
        if min_counts is not None and int(min_counts[c]) != 1:
            k = int(min_counts[c])
            ok = np.ones(n_docs, dtype=bool) if k <= 0 else count[:, c] >= k
        if dwells is not None and dwells[c] is not None:
            span = f64_from_sort_key(last[:, c]) \
                - f64_from_sort_key(first[:, c])
            ok = ok & doc_hit & (span >= float(dwells[c]))
        return ok

    def finish(out):
        for i, j in edges:
            out &= first[:, i] < first[:, j]
        if with_analytics:
            return out, first, last, count
        return (out, first) if with_first_hits else out

    if n_docs == 0:
        return finish(np.zeros(0, dtype=bool))
    if row_splits is None:                         # singular location + t
        keys = M.latlng_to_morton(lat, lng)
        cand = None if candidates is None \
            else np.asarray(candidates, dtype=bool)
        out = np.ones(n_docs, dtype=bool) if cand is None else cand.copy()
        tkey = f64_sort_key(t) if (need_first or need_last) else None
        for c, (region, t0, t1) in enumerate(constraints):
            hit = region.contains(keys) & (t >= t0) & (t <= t1)
            masked = hit if cand is None else hit & cand
            if need_first:
                first[:, c] = np.where(masked, tkey, FIRST_HIT_NONE)
            if need_last:
                last[:, c] = np.where(masked, tkey, LAST_HIT_NONE)
            if need_count:
                count[:, c] = masked.astype(np.int64)
            out &= ok_of(c, masked) if (min_counts is not None
                                        or any_dwell) else hit
        return finish(out)
    if candidates is not None:
        cand = np.asarray(candidates, dtype=bool)
        ids = np.nonzero(cand)[0]
        flat = span_indices(row_splits[ids], row_splits[ids + 1])
        lat, lng, t = lat[flat], lng[flat], t[flat]
        row_of = np.repeat(ids, np.diff(row_splits)[ids])
        out = cand.copy()
    else:
        row_of = np.repeat(np.arange(n_docs), np.diff(row_splits))
        out = np.ones(n_docs, dtype=bool)
    keys = M.latlng_to_morton(lat, lng)
    tkey = f64_sort_key(t) if (need_first or need_last) else None
    for c, (region, t0, t1) in enumerate(constraints):
        hit = region.contains(keys) & (t >= t0) & (t <= t1)
        doc_hit = np.zeros(n_docs, dtype=bool)
        if hit.size:
            np.logical_or.at(doc_hit, row_of, hit)
            if need_first:
                np.minimum.at(first[:, c], row_of,
                              np.where(hit, tkey, FIRST_HIT_NONE))
            if need_last:
                np.maximum.at(last[:, c], row_of,
                              np.where(hit, tkey, LAST_HIT_NONE))
            if need_count:
                np.add.at(count[:, c], row_of, hit)
        out &= ok_of(c, doc_hit)
    return finish(out)
