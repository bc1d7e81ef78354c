"""Pluggable execution backends for the query hot path.

The paper's time-to-first-result hinges on per-shard primitives — bitmap
intersection of the index probes, exact track refine, mask compaction and
group-by partial aggregation — which an :class:`ExecBackend` supplies
behind one seam, so the logical plan stays engine- and backend-agnostic:

  * ``numpy`` — the host reference, the parity oracle (a copy of the JAX
    package's, so the port never imports it),
  * ``torch`` — :class:`TorchBackend`, which launches the port's
    hand-written CUDA kernels through :mod:`repro_torch.kernels.ops` on a
    CUDA device, or their plain PyTorch versions when the caller asks for
    the CPU.

**Batched multi-shard ops.**  The engines dispatch *waves* of shards
(:mod:`repro_torch.exec.batched`) through ``probe_shards`` /
``refine_tracks_batched`` / ``compact_masks`` /
``segment_aggregate_batched``: the torch backend pads the wave's ragged
per-shard shapes into one stacked buffer and launches **one** kernel per
wave, while the numpy base-class implementations loop shard-by-shard —
the oracle the batched path must match byte-for-byte.

**Single-shard seam.**  ``intersect_bitmaps`` / ``select_ids`` /
``compact_mask`` / ``segment_aggregate`` / ``refine_tracks`` serve the
paths that work shard by shard: ``.filter()`` and the server's record
ops, the best-effort retry of a failed shard, and a mixer aggregate.

**Multi-query ops.**  The query server coalesces Q compatible queries
onto one wave: ``probe_shards_multi`` / ``refine_tracks_multi`` /
``run_wave_fused_multi`` fold the query axis into one launch each.

**Fused wave dispatch.**  ``run_wave_fused`` runs a whole wave's probe →
refine → compact → segment-agg chain as ONE logical dispatch
(:mod:`repro_torch.kernels.fused`): the numpy base class is the
loop-over-stages oracle; the torch override enqueues the four kernels on
one stream with no host sync between stages.  The launch contract is
⌈shards/wave⌉ fused dispatches per query.  Engines fall back to the
per-primitive path when the op declines or is ineligible (see
``exec.batched``).

The torch backend keeps stable per-FDb buffers (column values, packed
track words) device-resident across queries — ``prime_fdb`` /
:mod:`repro_torch.exec.device_cache` — with one cache a card: a query
over P > 1 partitions runs partition p's waves on card p mod D of the
exec mesh (``partition_context``).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..fdb.columnar import Column, ColumnBatch
from ..fdb.index import (bitmap_from_ids, bitmap_stack, ids_from_bitmap,
                         mask_from_bitmap)
from ..kernels import fused as _fused
from ..kernels import ops as _ops
from ..kernels.refine import MAX_CONSTRAINTS
from ..launch.mesh import make_exec_mesh
from .device_cache import DeviceCache, to_device, to_host
from .refine import (FIRST_HIT_NONE, LAST_HIT_NONE, pack_constraints,
                     pack_constraints_multi, pack_track_points,
                     reduction_verdict, refine_tracks_host)


def _has_red(min_counts, dwells) -> bool:
    """True when the per-constraint reductions change the verdict — a
    non-default min count or any dwell predicate."""
    return ((min_counts is not None
             and any(int(k) != 1 for k in min_counts))
            or (dwells is not None and any(d is not None for d in dwells)))


def _segment_minmax_host(codes: np.ndarray, values: np.ndarray,
                         num_groups: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host per-group (min, max) float64 — the oracle for the fused agg
    tail's min/max slots.  Groups with no rows keep ±inf fills (dropped by
    the ``count > 0`` keep-filter downstream)."""
    codes = np.asarray(codes, dtype=np.int64)
    keep = codes >= 0
    if not keep.all():
        codes, values = codes[keep], np.asarray(values)[keep]
    v = np.asarray(values, dtype=np.float64)
    mn = np.full(num_groups, np.inf)
    mx = np.full(num_groups, -np.inf)
    np.minimum.at(mn, codes, v)
    np.maximum.at(mx, codes, v)
    return mn, mx

__all__ = ["ExecBackend", "NumpyBackend", "TorchBackend", "register_backend",
           "backend_names", "get_backend", "as_backend"]


class ExecBackend:
    """Interface every execution backend implements.

    All methods take and return **host** numpy arrays; a device-resident
    backend owns its own transfers (and may cache device buffers keyed by
    array identity).  Contracts:

      * ``intersect_bitmaps(full, bitmaps)`` → uint32 word bitmap: AND of
        ``full`` (the shard's valid-doc mask) and every probe bitmap.
      * ``select_ids(bitmap, n)`` → ascending int64 doc ids of set bits.
      * ``compact_mask(mask)`` → ascending int64 positions of True entries.
      * ``segment_aggregate(codes, values, num_groups)`` →
        ``(count[G] int64, sum[G] float64, sumsq[G] float64)`` with rows
        whose code is negative ignored.
    """

    name: str = "abstract"
    #: True when the batched ops amortize real kernel launches; engines
    #: then default to multi-shard waves.  Loop-over-shards backends keep
    #: a default wave of 1 so per-shard thread parallelism is preserved
    #: (an explicit wave=/$REPRO_EXEC_WAVE still forces wider waves).
    batched_dispatch: bool = False

    def intersect_bitmaps(self, full: np.ndarray,
                          bitmaps: Sequence[np.ndarray]) -> np.ndarray:
        raise NotImplementedError

    def select_ids(self, bitmap: np.ndarray, n: int) -> np.ndarray:
        raise NotImplementedError

    def compact_mask(self, mask: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def segment_aggregate(self, codes: np.ndarray, values: np.ndarray,
                          num_groups: int
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        raise NotImplementedError

    # -------------------------------------------------- batched (per wave)
    # Base-class implementations loop shard-by-shard over the single-shard
    # primitives: that *is* the oracle the batched overrides must match
    # byte-for-byte (ragged shard sizes, empty shards included).

    def probe_shards(self, fulls: Sequence[np.ndarray],
                     probes: Sequence[Sequence[np.ndarray]]
                     ) -> List[np.ndarray]:
        """Per-shard AND of valid-doc bitmap and probe bitmaps, one wave."""
        return [self.intersect_bitmaps(f, ps)
                for f, ps in zip(fulls, probes)]

    def compact_masks(self, masks: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Per-shard positions of True entries, one wave."""
        return [self.compact_mask(m) for m in masks]

    def segment_aggregate_batched(
            self, codes: Sequence[np.ndarray], values: Sequence[np.ndarray],
            num_groups: Sequence[int]
            ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Per-shard (count, sum, sumsq) over shard-local group codes."""
        return [self.segment_aggregate(c, v, g)
                for c, v, g in zip(codes, values, num_groups)]

    # ------------------------------------------------------- track refine
    def refine_tracks(self, batch, path: str, constraints,
                      candidates: Optional[np.ndarray] = None,
                      edges=(), with_first_hits: bool = False,
                      min_counts=None, dwells=None,
                      with_analytics: bool = False):
        """Exact Tesseract refine over the ragged track at ``path``:
        per-doc bool mask [batch.n], True iff for *every* ``(region, t0,
        t1)`` constraint some track point lies inside the region's cover
        during the window.  ``candidates`` (bool mask) restricts the docs
        considered — the result equals ``full_refine & candidates`` bit
        for bit, and feeds ``compact_masks`` directly.

        ``edges`` is the ordering DAG over the constraint list: edge
        ``(i, j)`` additionally requires the doc's **first hit** of
        constraint ``i`` (min packed timestamp among its satisfying
        points) to be strictly before its first hit of ``j`` — equal
        first hits do not count as before.  ``with_first_hits`` returns
        ``(mask, table)`` with ``table`` the uint64 [batch.n, C]
        first-hit table (``exec.refine.FIRST_HIT_NONE`` where a
        constraint never hits) — parity-checked byte-for-byte across
        backends.

        ``min_counts``/``dwells`` generalize the per-constraint verdict
        (≥ k hits; last − first ≥ d seconds — see
        ``exec.refine.refine_tracks_host``); ``with_analytics`` returns
        ``(mask, first, last, count)`` — the full reduction-table family,
        parity-checked across backends.  Host reference: vectorized
        numpy over the shard's CSR columns."""
        lat = batch[path + ".lat"]
        lng = batch[path + ".lng"]
        tt = batch[path + ".t"]
        return refine_tracks_host(lat.values, lng.values, tt.values,
                                  lat.row_splits, batch.n,
                                  list(constraints), candidates,
                                  edges=tuple(edges),
                                  with_first_hits=with_first_hits,
                                  min_counts=min_counts, dwells=dwells,
                                  with_analytics=with_analytics)

    def refine_tracks_batched(self, batches, path: str, constraints,
                              candidates_list=None, edges=(),
                              with_first_hits: bool = False,
                              min_counts=None, dwells=None,
                              with_analytics: bool = False):
        """Per-shard refine masks for one wave — the loop-over-shards
        oracle the batched overrides must match byte-for-byte.  Returns
        the mask list, ``(masks, tables)`` under ``with_first_hits``, or
        ``(masks, firsts, lasts, counts)`` under ``with_analytics``."""
        batches = list(batches)
        if candidates_list is None:
            candidates_list = [None] * len(batches)
        outs = [self.refine_tracks(b, path, constraints, cand, edges=edges,
                                   with_first_hits=with_first_hits,
                                   min_counts=min_counts, dwells=dwells,
                                   with_analytics=with_analytics)
                for b, cand in zip(batches, candidates_list)]
        if with_analytics:
            return ([o[0] for o in outs], [o[1] for o in outs],
                    [o[2] for o in outs], [o[3] for o in outs])
        if with_first_hits:
            return [m for m, _ in outs], [t for _, t in outs]
        return outs

    # -------------------------------------------- multi-query (coalesced)
    # The query-serving layer coalesces Q compatible in-flight queries
    # against ONE resident wave of shards.  Base-class implementations
    # loop query-by-query over the single-query ops — the oracle the
    # stacked overrides must match byte-for-byte per query.

    def probe_shards_multi(self, fulls: Sequence[np.ndarray],
                           probes_multi) -> List[List[np.ndarray]]:
        """Per-query wave probes: ``probes_multi[q][s]`` is query q's
        probe-bitmap list for shard s.  Returns one ``probe_shards``
        result list per query."""
        return [self.probe_shards(fulls, probes) for probes in probes_multi]

    def refine_tracks_multi(self, batches, path: str, constraints_list,
                            candidates_lists=None, edges_list=None,
                            with_first_hits: bool = False,
                            min_counts_list=None, dwells_list=None):
        """Per-query wave refine: Q queries' constraint lists against one
        wave's shared tracks.  Returns one ``refine_tracks_batched``
        result per query (mask list, or ``(masks, tables)`` under
        ``with_first_hits``).  ``min_counts_list``/``dwells_list`` carry
        each query's per-constraint reductions (or ``None``)."""
        batches = list(batches)
        n_q = len(constraints_list)
        if candidates_lists is None:
            candidates_lists = [None] * n_q
        if edges_list is None:
            edges_list = [()] * n_q
        if min_counts_list is None:
            min_counts_list = [None] * n_q
        if dwells_list is None:
            dwells_list = [None] * n_q
        return [self.refine_tracks_batched(batches, path, cons, cands,
                                           edges=edges,
                                           with_first_hits=with_first_hits,
                                           min_counts=mc, dwells=dw)
                for cons, cands, edges, mc, dw in zip(
                    constraints_list, candidates_lists, edges_list,
                    min_counts_list, dwells_list)]

    def run_wave_fused_multi(self, shards, probes_multi, refines,
                             prefetch_shards=None):
        """Q coalesced *selection* queries (no aggregation tail) through
        one wave: returns a per-query list of ``(n_cands, ids_list)``
        pairs, or ``None`` to decline (the server then runs each query
        through the single-query path).  Base implementation is the
        loop-over-queries oracle the stacked override must match
        byte-for-byte per query."""
        out = []
        for probes, rf in zip(probes_multi, refines):
            r = self.run_wave_fused(shards, probes, refine=rf, agg=None)
            if r is None:
                return None
            n_cands, ids_list, _seg = r
            out.append((n_cands, ids_list))
        return out

    # -------------------------------------------------- sketch aggregation
    def segment_hll(self, codes: np.ndarray, reg_idx: np.ndarray,
                    ranks: np.ndarray, num_groups: int,
                    num_regs: int) -> np.ndarray:
        """Grouped HyperLogLog register build: per-row ``(group code,
        register index, rank)`` triples → uint8 ``[num_groups, num_regs]``
        per-group register planes.  The reduce is a plain max with
        identity 0 (= empty register) — commutative and idempotent, so
        the result is independent of row order and of how rows are split
        across shards or partitions (the ``merge_partials`` contract for
        sketches).  Rows with negative codes are ignored.  Host
        reference: one ``np.maximum.at`` scatter."""
        regs = np.zeros((num_groups, num_regs), dtype=np.uint8)
        codes = np.asarray(codes, dtype=np.int64)
        keep = codes >= 0
        if not keep.all():
            codes = codes[keep]
            reg_idx = np.asarray(reg_idx, dtype=np.int64)[keep]
            ranks = np.asarray(ranks, dtype=np.uint8)[keep]
        np.maximum.at(regs, (codes, np.asarray(reg_idx, dtype=np.int64)),
                      np.asarray(ranks, dtype=np.uint8))
        return regs

    # -------------------------------------------------- fused wave pipeline
    def postings_bitmap(self, ids: np.ndarray, t_min: np.ndarray,
                        t_max: np.ndarray, t0: float, t1: float,
                        n_docs: int) -> np.ndarray:
        """OR doc ``ids`` into a word bitmap and prune docs whose track
        span ``[t_min, t_max]`` misses ``[t0, t1]`` — the tail of
        ``SpaceTimeIndex.lookup`` behind the seam (host reference)."""
        bm = bitmap_from_ids(np.asarray(ids, dtype=np.int64), n_docs)
        overlap = (t_min <= t1) & (t_max >= t0)
        return bm & bitmap_from_ids(
            np.nonzero(overlap)[0].astype(np.int64), n_docs)

    def run_wave_fused(self, shards, probes, refine=None, agg=None,
                       prefetch_shards=None, profile=None):
        """Whole-wave probe → refine → compact → (segment-agg) as one
        logical dispatch.  Returns ``(n_cands, ids_list, seg)``: per-shard
        pre-refine candidate counts, selected doc ids, and — when ``agg``
        (an ``exec.batched.FusedAggPlan``) is given — per-shard
        ``(group_keys, [(count, sum, sumsq) per value slot])`` partials
        over each shard's full group space.  May return ``None`` to
        decline, in which case the engine runs the per-primitive path.

        This base implementation is the loop-over-stages oracle the fused
        overrides must match byte-for-byte; ``prefetch_shards`` is a hint
        only (no-op on host backends)."""
        shards = list(shards)
        if not shards:
            return [], [], ([] if agg is not None else None)
        bms = self.probe_shards([sh.all_bitmap() for sh in shards], probes)
        masks = [mask_from_bitmap(bm, sh.n) for bm, sh in zip(bms, shards)]
        n_cands = [int(m.sum()) for m in masks]
        if refine is not None:
            masks = self.refine_tracks_batched(
                [sh.batch for sh in shards], refine.path,
                refine.constraints, masks, edges=refine.edges,
                min_counts=getattr(refine, "min_counts", None),
                dwells=getattr(refine, "dwells", None))
        ids_list = self.compact_masks(masks)
        seg = None
        if agg is not None:
            mm = tuple(getattr(agg, "minmax", ()) or ())
            seg = []
            for sh, ids in zip(shards, ids_list):
                uniq, codes, g = agg.factorize(sh, backend=self)
                if g == 0:
                    seg.append((uniq, []))
                    continue
                csel = codes[ids]
                slots = []
                for k, vp in enumerate(agg.value_paths or [None]):
                    vals = (sh.batch[vp].values[ids] if vp is not None
                            else np.zeros(ids.size))
                    slot = self.segment_aggregate(csel, vals, g)
                    if k < len(mm) and mm[k]:
                        slot = (*slot,
                                *_segment_minmax_host(csel, vals, g))
                    slots.append(slot)
                seg.append((uniq, slots))
        return n_cands, ids_list, seg

    # ------------------------------------------------------ partition layer
    def partition_context(self, part: int, num_parts: int):
        """Context manager the wave scheduler enters around one
        partition's dispatches.  Host backends have nothing to place —
        the partition layer degenerates to running the partitions'
        waves one after another on the same loop."""
        del part, num_parts
        return contextlib.nullcontext()

    def merge_partials(self, states, minmax=(), parts=None):
        """Combine per-shard segment-aggregate states across partitions
        — the partitioned Mixer combine, and the loop-over-partitions
        **oracle** mesh backends must match.

        ``states`` is a flat list of ``(uniq_keys, slots)`` pairs in
        global shard order (partitions are contiguous slices, so
        flattening per-partition results in partition order *is* shard
        order); each slot is ``(count, sum, sum_sq[, min, max])`` vectors
        over that state's own key space.  Returns ``(union_keys,
        merged_slots)`` over the sorted union key space: counts, sums and
        sums-of-squares accumulate **sequentially in states order** with
        absent groups contributing the additive identity 0 (bit-equal to
        the P=1 sequential merge), min/max planes reduce element-wise
        against ±inf, and the per-group presence masks OR (a group is
        live iff some state selected a row for it, which is exactly
        ``merged count > 0`` — counts are non-negative).

        ``minmax`` flags which value slots carry min/max planes;
        ``parts`` (per-partition state counts) is layout metadata for
        mesh-sharding backends — the host oracle just loops in order.
        """
        del parts
        live = [(np.asarray(k), list(slots)) for k, slots in states
                if len(k) and slots]
        if not live:
            return np.zeros(0, np.int64), []
        union = np.unique(np.concatenate([k for k, _ in live]))
        n_slots = max(len(slots) for _, slots in live)
        mm = tuple(minmax)
        mm = mm + (False,) * (n_slots - len(mm))
        g = union.size
        cnt = [np.zeros(g, np.int64) for _ in range(n_slots)]
        s = [np.zeros(g, np.float64) for _ in range(n_slots)]
        s2 = [np.zeros(g, np.float64) for _ in range(n_slots)]
        mn = [np.full(g, np.inf) for _ in range(n_slots)]
        mx = [np.full(g, -np.inf) for _ in range(n_slots)]
        mask = np.zeros(g, bool)
        for keys, slots in live:               # in order over states
            idx = np.searchsorted(union, keys)
            for k, st in enumerate(slots):
                # densify onto the union space, then accumulate — the
                # identical arithmetic a stacked device combine performs
                row_c = np.zeros(g, np.int64)
                row_s = np.zeros(g, np.float64)
                row_s2 = np.zeros(g, np.float64)
                row_c[idx] = np.asarray(st[0], np.int64)
                row_s[idx] = np.asarray(st[1], np.float64)
                row_s2[idx] = np.asarray(st[2], np.float64)
                cnt[k] = cnt[k] + row_c
                s[k] = s[k] + row_s
                s2[k] = s2[k] + row_s2
                if len(st) >= 5:
                    row_mn = np.full(g, np.inf)
                    row_mx = np.full(g, -np.inf)
                    row_mn[idx] = np.asarray(st[3], np.float64)
                    row_mx[idx] = np.asarray(st[4], np.float64)
                    mn[k] = np.minimum(mn[k], row_mn)
                    mx[k] = np.maximum(mx[k], row_mx)
            present = np.zeros(g, bool)
            present[idx] = np.asarray(slots[0][0]) > 0
            mask |= present
        merged = []
        for k in range(n_slots):
            slot = (cnt[k], s[k], s2[k])
            if mm[k]:
                slot = (*slot, mn[k], mx[k])
            merged.append(slot)
        return union, merged

    def prefetch_wave(self, shards, refine=None, agg=None) -> None:
        """Stage a wave's stacked buffers ahead of compute (no-op on host
        backends — there is nothing to upload)."""

    def gather_columns(self, batch, paths: Sequence[str],
                       ids: np.ndarray):
        """Selective column read of ``ids`` rows (host reference)."""
        return batch.select_paths(list(paths)).gather(ids)

    def prime_fdb(self, db) -> int:
        """Make ``db``'s stable buffers backend-resident (no-op on host)."""
        return 0

    def __repr__(self):
        return f"<ExecBackend {self.name}>"


# --------------------------------------------------------------------------
# numpy — host reference implementation (the oracle)
# --------------------------------------------------------------------------

class NumpyBackend(ExecBackend):
    name = "numpy"

    def intersect_bitmaps(self, full, bitmaps):
        bm = full
        for b in bitmaps:
            bm = bm & b
        return bm

    def select_ids(self, bitmap, n):
        return ids_from_bitmap(bitmap, n)

    def compact_mask(self, mask):
        return np.nonzero(mask)[0].astype(np.int64)

    def segment_aggregate(self, codes, values, num_groups):
        codes = np.asarray(codes, dtype=np.int64)
        keep = codes >= 0
        if not keep.all():
            codes, values = codes[keep], np.asarray(values)[keep]
        v = np.asarray(values, dtype=np.float64)
        cnt = np.bincount(codes, minlength=num_groups)[:num_groups]
        s = np.bincount(codes, weights=v, minlength=num_groups)[:num_groups]
        s2 = np.bincount(codes, weights=v * v,
                         minlength=num_groups)[:num_groups]
        return cnt.astype(np.int64), s, s2


# --------------------------------------------------------------------------
# torch — the hand-written CUDA kernels (plain PyTorch versions on the CPU)
# --------------------------------------------------------------------------

class TorchBackend(ExecBackend):
    """Routes the hot loop through :mod:`repro_torch.kernels.ops`: the
    fused wave (``run_wave_fused``), the wave-batched ops a declined wave
    takes (``probe_shards``, ``refine_tracks_batched``, ``compact_masks``,
    ``segment_aggregate_batched``), the single-shard seam the filter and
    retry paths take (``intersect_bitmaps``, ``select_ids``,
    ``compact_mask``, ``segment_aggregate``, ``refine_tracks``) and the
    query server's coalesced ops (``probe_shards_multi``,
    ``refine_tracks_multi``, ``run_wave_fused_multi``) launch the
    hand-written CUDA kernels on ``device``.  The partition layer's
    combine (``merge_partials``) and the grouped sketch build
    (``segment_hll``) are plain PyTorch ops on ``device``, as the JAX
    package's are plain jnp.

    ``device`` defaults to ``"cuda"``, resolved to the calling thread's
    current card (``cuda:<current device>``) at construction: the
    backend's own card.  Without a CUDA device the constructor raises
    rather than carry on elsewhere.  ``device="cpu"`` is the explicit
    request the tests make: every kernel wrapper then runs its plain
    PyTorch version, and aggregates stage float64 values (bit-equal to
    the numpy oracle).  On the card value columns stage as float32, the
    ``segment_agg`` kernel's input type.

    Cards: inside ``partition_context(p, P)`` (P > 1) the calling
    thread's waves run on card p mod D of ``make_exec_mesh(P)``; the
    card is thread-local, because the engines run several partitions
    at once on a thread pool.  ``device`` and ``device_cache`` read the
    calling thread's card, elsewhere the backend's own.  Each card keeps
    its own ``DeviceCache``: a card other than the backend's own is
    filled with every primed buffer the first time a partition runs
    there, and ``prime_fdb`` and the finalizers keep every such card in
    step.
    """

    name = "torch"
    batched_dispatch = True

    def __init__(self, device: Union[None, str, torch.device] = None):
        dev = torch.device("cuda" if device is None else device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"TorchBackend: unsupported device {dev}")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchBackend: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch versions")
        if dev.type == "cuda" and dev.index is None:
            # CUDA's current device is per host thread: pin the one the
            # constructing thread has, not "whichever is current"
            dev = torch.device("cuda", torch.cuda.current_device())
        self._home = dev
        # the calling thread's partition card (partition_context)
        self._local = threading.local()
        self._val_dtype = np.float32 if dev.type == "cuda" else np.float64
        # card → its cache; a card joins on its first partition
        # (_card_cache), under _prime_lock
        self._caches: Dict[torch.device, DeviceCache] = {
            dev: DeviceCache(dev)}
        #: when set to a list, the fused path appends ("prefetch", n) /
        #: ("wave_done", shard_ids) markers
        self.trace_events: Optional[list] = None
        # weak: a collected FDb drops out, and a finalizer evicts its
        # buffers; buffers are refcounted across FDbs because streaming
        # snapshots share Shards (hence arrays)
        self._primed_fdbs: weakref.WeakSet = weakref.WeakSet()
        self._primed_refs: Dict[int, int] = {}
        self._primed_keysets: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._latest_primed: Dict[str, "weakref.ref"] = {}
        # id(track lat values) → (lat values pin, pts [4, P], rows [P])
        self._track_packs: Dict[int, Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]] = {}
        # priming, finalizer release and the pack cache share one lock;
        # reentrant because prime_fdb calls _track_pack while holding it
        self._prime_lock = threading.RLock()

    # ------------------------------------------------- single-shard ops
    def intersect_bitmaps(self, full, bitmaps):
        """One ``bitmap_intersect`` launch over the ``[1+K, W]`` stack of
        the valid-doc bitmap and the probes (none: ``full`` itself)."""
        if not bitmaps:
            return full
        bm, _count = _ops.bitmap_intersect(
            self._up(bitmap_stack([full, *bitmaps])))
        return to_host(bm, np.uint32)

    def select_ids(self, bitmap, n):
        return self.compact_mask(mask_from_bitmap(bitmap, n))

    def compact_mask(self, mask):
        """One single-mask ``compact`` launch → ascending int64 ids."""
        mask = np.asarray(mask, dtype=bool)
        idx, count = _ops.compact(self._up(mask))
        return idx[:int(count)].cpu().numpy().astype(np.int64)

    def segment_aggregate(self, codes, values, num_groups):
        """One ``segment_agg`` launch (float64 staging on the CPU:
        bit-equal to the numpy oracle)."""
        codes32 = np.ascontiguousarray(codes, dtype=np.int32)
        return self._segment_dispatch(codes32, values, num_groups)

    # ------------------------------------------------------------ cards
    @property
    def device(self) -> torch.device:
        """The calling thread's card: its partition's inside
        ``partition_context``, else the backend's own device."""
        return getattr(self._local, "device", None) or self._home

    @property
    def device_cache(self) -> DeviceCache:
        """The resident buffers of the calling thread's card."""
        return self._caches[self.device]

    def device_caches(self) -> Dict[torch.device, DeviceCache]:
        """Every card's cache, the backend's own first."""
        with self._prime_lock:
            return dict(self._caches)

    def _card_cache(self, card: torch.device) -> DeviceCache:
        """``card``'s cache, made on the first partition that runs there
        and filled with every buffer primed so far (partitions are slices
        of each query's pruned shard list, so any card may need any
        shard).  It is published only once full."""
        cache = self._caches.get(card)
        if cache is None:
            with self._prime_lock:
                cache = self._caches.get(card)
                if cache is None:
                    cache = DeviceCache(card)
                    for arr in self._caches[self._home].host_arrays():
                        cache.put(arr)
                    self._caches[card] = cache
        return cache

    # ------------------------------------------------------------ helpers
    def _up(self, arr: np.ndarray) -> torch.Tensor:
        """Transient host array → device tensor (same bits)."""
        return to_device(arr, self.device)

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """Device buffer for ``arr`` (resident when primed, else upload)."""
        dev = self.device_cache.get(arr)
        return dev if dev is not None else self._up(arr)

    def _probe_stack(self, fulls, probes) -> np.ndarray:
        """[S, K, W] words: row 0 the valid-doc bitmap, then the probes,
        pad rows copies of row 0 (an AND no-op); ragged W zero-padded —
        sound because row 0 is zero in the pad region."""
        w = max(f.size for f in fulls)
        k = 1 + max((len(ps) for ps in probes), default=0)
        stack = np.zeros((len(fulls), k, w), dtype=np.uint32)
        for i, (f, ps) in enumerate(zip(fulls, probes)):
            stack[i, 0, :f.size] = f
            for j, b in enumerate(ps):
                stack[i, j + 1, :b.size] = b
            for j in range(len(ps) + 1, k):
                stack[i, j, :f.size] = f
        return stack

    # ------------------------------------------------------------- batched
    def probe_shards(self, fulls, probes):
        """One ``bitmap_intersect_batched`` launch for the whole wave."""
        fulls = list(fulls)
        probes = [list(ps) for ps in probes]
        if not fulls:
            return []
        if max(f.size for f in fulls) == 0:  # a wave of empty shards
            return [f.copy() for f in fulls]
        bms, _counts = _ops.bitmap_intersect_batched(
            self._up(self._probe_stack(fulls, probes)))
        bms = to_host(bms, np.uint32)
        return [bms[i, :f.size].copy() for i, f in enumerate(fulls)]

    def compact_masks(self, masks):
        """One ``compact_batched`` launch for the whole wave (False-pad)."""
        masks = [np.asarray(m, dtype=bool) for m in masks]
        if not masks:
            return []
        n = max(m.size for m in masks)
        if n == 0:
            return [np.zeros(0, dtype=np.int64) for _ in masks]
        stack = np.zeros((len(masks), n), dtype=bool)
        for i, m in enumerate(masks):
            stack[i, :m.size] = m
        idx, counts = _ops.compact_batched(self._up(stack))
        idx, counts = idx.cpu().numpy(), counts.cpu().numpy()
        return [idx[i, :int(counts[i])].astype(np.int64)
                for i in range(len(masks))]

    def _segment_dispatch(self, codes32: np.ndarray, values: np.ndarray,
                          num_groups: int):
        """One segment_agg launch → host (count int64, sum f64, sumsq f64)."""
        cnt, s, s2 = _ops.segment_agg(
            self._up(codes32),
            self._up(np.asarray(values, dtype=self._val_dtype)),
            num_groups)
        return (cnt.cpu().numpy().astype(np.int64), s.cpu().numpy(),
                s2.cpu().numpy())

    def segment_aggregate_batched(self, codes, values, num_groups):
        """One segment launch per wave: shard-local group codes are offset
        into a disjoint global code space, aggregated together, and split
        back per shard."""
        num_groups = [int(g) for g in num_groups]
        total_groups = sum(num_groups)
        if total_groups == 0 or not codes:
            return [(np.zeros(0, np.int64), np.zeros(0), np.zeros(0))
                    for _ in codes]
        offsets = np.concatenate([[0], np.cumsum(num_groups)])
        shifted = []
        for c, off in zip(codes, offsets[:-1]):
            c32 = np.ascontiguousarray(c, dtype=np.int32)
            shifted.append(np.where(c32 >= 0, c32 + np.int32(off),
                                    np.int32(-1)).astype(np.int32))
        codes_cat = np.concatenate(shifted)
        vals_cat = np.concatenate([np.asarray(v) for v in values])
        cnt, s, s2 = self._segment_dispatch(codes_cat, vals_cat,
                                            total_groups)
        out = []
        for g, off in zip(num_groups, offsets[:-1]):
            off = int(off)
            out.append((cnt[off:off + g], s[off:off + g], s2[off:off + g]))
        return out

    # ---------------------------------------------------- device residence
    def _release_primed(self, keys, retire: bool = False) -> None:
        """Drop an FDb's buffer refs; evict at zero refcount (the per-FDb
        GC finalizer, and with ``retire=True`` the eager snapshot-turnover
        path)."""
        with self._prime_lock:
            gone = []
            for key in list(keys):
                n = self._primed_refs.get(key, 0) - 1
                if n <= 0:
                    self._primed_refs.pop(key, None)
                    gone.append(key)
                    self._track_packs.pop(key, None)
                else:
                    self._primed_refs[key] = n
            if gone:
                for cache in self._caches.values():
                    cache.drop(gone, retired=retire)

    def prime_fdb(self, db) -> int:
        """Put ``db``'s stable buffers on the device once (idempotent per
        FDb): column values and row_splits (``gather_columns``) and each
        track's packed refine words (the refine stage), and each
        spacetime index's per-doc track spans (``postings_bitmap``), on
        the backend's own card and on every card a partition has run on.
        Returns the number of buffers newly copied to each of those
        cards (they hold the same ones).  Incremental across
        streaming generations (identity keying), refcounted across FDbs
        that share Shards, released by a finalizer when the FDb is
        collected.  (The
        JAX package also primes bitmaps and the spacetime postings; no
        ported op reads them.)"""
        with self._prime_lock:
            if db in self._primed_fdbs:
                return 0
            home = self._caches[self._home]
            before = len(home)
            primed: List[np.ndarray] = []
            for shard in db.shards:
                for col in shard.batch.columns.values():
                    primed.append(col.values)
                    if col.row_splits is not None:
                        primed.append(col.row_splits)
                for (path, kind), idx in shard.indexes.items():
                    if kind == "spacetime":
                        primed.extend((idx.t_min, idx.t_max))
                        pts, rows = self._track_pack(shard.batch, path,
                                                     pin=True)
                        if pts is not None:
                            primed.extend((pts, rows))
            keys = set()
            for arr in primed:
                for cache in self._caches.values():
                    cache.put(arr)
                keys.add(id(arr))
            for key in keys:
                self._primed_refs[key] = self._primed_refs.get(key, 0) + 1
            self._primed_fdbs.add(db)
            self._primed_keysets[db] = keys
            weakref.finalize(db, self._release_primed, keys)
            uploaded = len(home) - before
            # priming a newer snapshot of the same source retires the
            # replaced generation's exclusive buffers right away
            prev_ref = self._latest_primed.get(db.name)
            prev = prev_ref() if prev_ref is not None else None
            self._latest_primed[db.name] = weakref.ref(db)
            if prev is not None and prev is not db:
                prev_keys = self._primed_keysets.get(prev)
                if prev_keys:
                    stale = prev_keys - keys
                    if stale:
                        prev_keys -= stale
                        self._release_primed(stale, retire=True)
            return uploaded

    def _track_pack(self, batch, path: str, pin: bool = False):
        """(pts, rows) packed refine form for ``batch``'s track at
        ``path``, cached per shard by the lat buffer's identity — only
        when its release is guaranteed (primed FDbs)."""
        lat_path = path + ".lat"
        if lat_path not in batch.columns:
            return None, None
        lat = batch[lat_path]
        hit = self._track_packs.get(id(lat.values))
        if hit is not None:
            return hit[1], hit[2]
        pts, rows = pack_track_points(lat.values, batch[path + ".lng"].values,
                                      batch[path + ".t"].values,
                                      lat.row_splits)
        with self._prime_lock:
            if pin or id(lat.values) in self._primed_refs:
                self._track_packs[id(lat.values)] = (lat.values, pts, rows)
        return pts, rows

    def _stack_tracks(self, packs):
        """Pad each shard's (resident) packed track to the wave max and
        stack: pts [S, 4, P] int32 words, rows [S, P] (-1 pad)."""
        p_max = max(p.shape[1] for p, _ in packs)
        pts_stack = torch.zeros((len(packs), 4, p_max), dtype=torch.int32,
                                device=self.device)
        rows_stack = torch.full((len(packs), p_max), -1, dtype=torch.int32,
                                device=self.device)
        for i, (pts, rows) in enumerate(packs):
            p = pts.shape[1]
            pts_stack[i, :, :p] = self._dev(pts)
            rows_stack[i, :p] = self._dev(rows)
        return pts_stack, rows_stack

    @staticmethod
    def _u64_table(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
        """(hi, lo) word planes [C, n] (int32 bits) → uint64 table [n, C]."""
        return ((hi.view(np.uint32).astype(np.uint64) << np.uint64(32))
                | lo.view(np.uint32).astype(np.uint64)).T.copy()

    @classmethod
    def _host_tables(cls, cand, hi, lo, lhi=None, llo=None, cnt=None):
        """One shard's host reduction tables from its [C, n] word planes:
        the first-hit uint64 [n, C] table, and with the analytics planes
        ``(first, last, count)`` (last-hit uint64, int64 counts) — set to
        the no-hit identities outside ``cand`` (byte parity with the
        restricted host oracle, which never evaluates those docs)."""
        first = cls._u64_table(hi, lo)
        off = None if cand is None else ~np.asarray(cand, dtype=bool)
        if off is not None:
            first[off, :] = FIRST_HIT_NONE
        if cnt is None:
            return first
        last = cls._u64_table(lhi, llo)
        count = cnt.T.astype(np.int64)
        if off is not None:
            last[off, :] = LAST_HIT_NONE
            count[off, :] = 0
        return first, last, count

    def refine_tracks(self, batch, path, constraints, candidates=None,
                      edges=(), with_first_hits: bool = False,
                      min_counts=None, dwells=None,
                      with_analytics: bool = False):
        """One single-shard ``refine_tracks`` launch over the full shard
        track (device-resident when primed), AND-combined with
        ``candidates`` on the host — byte-equal to the restricted numpy
        oracle because a doc's verdict is independent of other docs.
        Ordering edges are a device-side compare over the first-hit
        tables of the same launch; count/dwell reductions (or
        ``with_analytics``) pull the reduction tables and recompute the
        verdict host-side (``exec.refine.reduction_verdict``).  Declines
        to the host oracle on 0 or >30 constraints, an empty shard or a
        missing track, as the JAX package does."""
        constraints = list(constraints)
        edges = [tuple(e) for e in edges]
        pts = rows = None
        if constraints and len(constraints) <= MAX_CONSTRAINTS and batch.n:
            pts, rows = self._track_pack(batch, path)
        if pts is None:
            return super().refine_tracks(batch, path, constraints,
                                         candidates, edges=edges,
                                         with_first_hits=with_first_hits,
                                         min_counts=min_counts,
                                         dwells=dwells,
                                         with_analytics=with_analytics)
        cand = None if candidates is None else np.asarray(candidates, bool)
        args = (self._dev(pts), self._dev(rows),
                self._up(pack_constraints(constraints)), batch.n)
        if with_analytics or _has_red(min_counts, dwells):
            planes = _ops.refine_tracks(*args, with_analytics=True)[1:]
            first, last, count = self._host_tables(
                cand, *(t.cpu().numpy() for t in planes))
            mask = reduction_verdict(first, last, count, edges, min_counts,
                                     dwells)
            if cand is not None:
                mask &= cand
            if with_analytics:
                return mask, first, last, count
            return (mask, first) if with_first_hits else mask
        need_fh = bool(edges) or with_first_hits
        r = _ops.refine_tracks(*args, with_first_hits=need_fh)
        mask_d = r[0] if need_fh else r
        for i, j in edges:
            mask_d = mask_d & _fused.first_hit_before(r[1], r[2], i, j)
        mask = mask_d.cpu().numpy().copy()
        if cand is not None:
            mask &= cand
        if with_first_hits:
            return mask, self._host_tables(cand, r[1].cpu().numpy(),
                                           r[2].cpu().numpy())
        return mask

    def refine_tracks_batched(self, batches, path, constraints,
                              candidates_list=None, edges=(),
                              with_first_hits: bool = False,
                              min_counts=None, dwells=None,
                              with_analytics: bool = False):
        """One ``refine_tracks_batched`` launch for the whole wave: the
        shards' packed point buffers are stacked (device-resident when
        primed) and share the query's constraint table.  Ordering edges
        are compared on the device; count/dwell reductions (or
        ``with_analytics``) pull the reduction tables from the same
        launch and recompute each shard's verdict host-side
        (``exec.refine.reduction_verdict``).  Declines to the host oracle
        on 0 or >30 constraints or a shard without a packed track, as the
        JAX package does."""
        batches = list(batches)
        constraints = list(constraints)
        edges = [tuple(e) for e in edges]
        if candidates_list is None:
            candidates_list = [None] * len(batches)
        need_an = with_analytics or _has_red(min_counts, dwells)
        if not batches:
            if with_analytics:
                return [], [], [], []
            return ([], []) if with_first_hits else []
        packs = [self._track_pack(b, path) for b in batches]
        if not constraints or len(constraints) > MAX_CONSTRAINTS \
                or any(pts is None for pts, _ in packs):
            return super().refine_tracks_batched(
                batches, path, constraints, candidates_list, edges=edges,
                with_first_hits=with_first_hits, min_counts=min_counts,
                dwells=dwells, with_analytics=with_analytics)
        ns = [b.n for b in batches]
        n_max = max(ns)
        p_max = max(pts.shape[1] for pts, _ in packs)
        n_c = len(constraints)
        tables: List[np.ndarray] = []
        lasts: List[np.ndarray] = []
        counts: List[np.ndarray] = []
        if n_max == 0 or p_max == 0:
            tables = [np.full((n, n_c), FIRST_HIT_NONE, dtype=np.uint64)
                      for n in ns]
            lasts = [np.full((n, n_c), LAST_HIT_NONE, dtype=np.uint64)
                     for n in ns]
            counts = [np.zeros((n, n_c), dtype=np.int64) for n in ns]
            if need_an:
                # vacuous (k <= 0) constraints still pass un-hit docs
                masks = [reduction_verdict(f, l, c, edges, min_counts,
                                           dwells)
                         for f, l, c in zip(tables, lasts, counts)]
            else:
                masks = [np.zeros(n, dtype=bool) for n in ns]
        else:
            pts_stack, rows_stack = self._stack_tracks(packs)
            cov = self._up(pack_constraints(constraints))
            if need_an:
                _, fh_hi, fh_lo, lh_hi, lh_lo, cnt = \
                    _ops.refine_tracks_batched(
                        pts_stack, rows_stack, cov, n_max,
                        with_analytics=True)
                hi_h, lo_h = fh_hi.cpu().numpy(), fh_lo.cpu().numpy()
                lhi_h, llo_h = lh_hi.cpu().numpy(), lh_lo.cpu().numpy()
                cnt_h = cnt.cpu().numpy()
                masks = []
                for i, (n, cand) in enumerate(zip(ns, candidates_list)):
                    first, last, count = self._host_tables(
                        cand, hi_h[i, :, :n], lo_h[i, :, :n],
                        lhi_h[i, :, :n], llo_h[i, :, :n], cnt_h[i, :, :n])
                    masks.append(reduction_verdict(first, last, count,
                                                   edges, min_counts,
                                                   dwells))
                    tables.append(first)
                    lasts.append(last)
                    counts.append(count)
            else:
                need_fh = bool(edges) or with_first_hits
                r = _ops.refine_tracks_batched(
                    pts_stack, rows_stack, cov, n_max,
                    with_first_hits=need_fh)
                out_d = r[0] if need_fh else r
                for i, j in edges:
                    out_d = out_d & _fused.first_hit_before(r[1], r[2], i, j)
                out = out_d.cpu().numpy()
                masks = [out[i, :n].copy() for i, n in enumerate(ns)]
                if with_first_hits:
                    hi_h, lo_h = r[1].cpu().numpy(), r[2].cpu().numpy()
                    for i, (n, cand) in enumerate(zip(ns, candidates_list)):
                        tables.append(self._host_tables(
                            cand, hi_h[i, :, :n], lo_h[i, :, :n]))
        for m, cand in zip(masks, candidates_list):
            if cand is not None:
                m &= np.asarray(cand, dtype=bool)
        if with_analytics:
            return masks, tables, lasts, counts
        return (masks, tables) if with_first_hits else masks

    def gather_columns(self, batch, paths, ids):
        """Selective read from device-resident buffers when primed: dense
        columns gather directly; repeated columns run the ragged gather
        (CSR spans-concatenate over the resident value buffer, new
        row_splits built host-side).  Unprimed columns take the host
        gather — identical values either way."""
        sub = batch.select_paths(list(paths))
        ids = np.asarray(ids, dtype=np.int64)
        cols = {}
        ids_d = None
        for p, c in sub.columns.items():
            dev = self.device_cache.get(c.values)
            if dev is None:
                cols[p] = c.gather(ids)
                continue
            if ids_d is None:
                ids_d = torch.from_numpy(ids).to(self.device)
            if c.row_splits is None:
                cols[p] = Column(to_host(dev[ids_d], c.values.dtype), None,
                                 c.vocab)
                continue
            starts = c.row_splits[ids]
            ends = c.row_splits[ids + 1]
            new_splits = np.zeros(ids.size + 1, dtype=np.int64)
            np.cumsum(ends - starts, out=new_splits[1:])
            total = int(new_splits[-1])
            if total == 0:
                vals = c.values[:0].copy()
            else:
                splits_d = torch.from_numpy(new_splits).to(self.device)
                pos = torch.arange(total, dtype=torch.int64,
                                   device=self.device)
                row = torch.searchsorted(splits_d, pos, right=True) - 1
                flat = torch.from_numpy(starts.astype(np.int64)).to(
                    self.device)[row] + pos - splits_d[row]
                vals = to_host(dev[flat], c.values.dtype)
            cols[p] = Column(vals, new_splits, c.vocab)
        return ColumnBatch(sub.schema, cols, ids.size)

    # ------------------------------------------------------ fused wave path
    def _refine_stack(self, shards, packs, path: str):
        """Wave-stacked (pts, rows) device buffers for the fused refine
        stage, keyed in the DeviceCache per wave when every source buffer
        is primed (the per-FDb finalizer then owns eviction)."""
        src = tuple(id(sh.batch[path + ".lat"].values) for sh in shards)
        keyed_ok = all(k in self._primed_refs for k in src)
        key = ("refine_stack",) + src
        if keyed_ok:
            hit = self.device_cache.get_keyed(key)
            if hit is not None:
                return hit
        out = self._stack_tracks(packs)
        if keyed_ok:
            self.device_cache.put_keyed(key, out)
        return out

    def _agg_stacks(self, shards, agg, n_max: int):
        """Offset-coded group-code stack [S, n_max] (-1 pad) plus one
        value stack per aggregated column for the fused segment stage,
        keyed in the DeviceCache per wave.  Values stage as float32 on the
        card (the kernel's input) and float64 on the CPU."""
        facts = [agg.factorize(sh, backend=self) for sh in shards]
        offsets = np.concatenate(
            [[0], np.cumsum([g for _, _, g in facts])]).astype(np.int64)
        total = int(offsets[-1])
        if total == 0:
            return facts, offsets, None, (), 0
        src = tuple(id(sh.batch[agg.key_path].values) for sh in shards)
        keyed_ok = all(k in self._primed_refs for k in src)
        ckey = ("agg_codes", n_max) + src
        codes_dev = self.device_cache.get_keyed(ckey) if keyed_ok else None
        if codes_dev is None:
            codes = np.full((len(shards), n_max), -1, dtype=np.int32)
            for i, (sh, (_, c, g)) in enumerate(zip(shards, facts)):
                if g:
                    codes[i, :sh.n] = c + np.int32(offsets[i])
            codes_dev = self._up(codes)
            if keyed_ok:
                self.device_cache.put_keyed(ckey, codes_dev)
        dt = self._val_dtype
        vals_dev = []
        for vp in (agg.value_paths or [None]):
            if vp is None:
                # count-only plan: a zeros stack so the segment stage
                # still returns per-group row counts
                vals_dev.append(torch.zeros(
                    (len(shards), n_max), device=self.device,
                    dtype=torch.float32 if dt == np.float32
                    else torch.float64))
                continue
            vsrc = tuple(id(sh.batch[vp].values) for sh in shards)
            vok = keyed_ok and all(k in self._primed_refs for k in vsrc)
            vkey = ("agg_vals", np.dtype(dt).name, n_max) + vsrc
            dv = self.device_cache.get_keyed(vkey) if vok else None
            if dv is None:
                stack = np.zeros((len(shards), n_max), dtype=dt)
                for i, sh in enumerate(shards):
                    if sh.n:
                        stack[i, :sh.n] = np.asarray(sh.batch[vp].values, dt)
                dv = self._up(stack)
                if vok:
                    self.device_cache.put_keyed(vkey, dv)
            vals_dev.append(dv)
        return facts, offsets, codes_dev, tuple(vals_dev), total

    def run_wave_fused(self, shards, probes, refine=None, agg=None,
                       prefetch_shards=None, profile=None):
        """One fused dispatch for the whole wave (``kernels.fused``): the
        four kernels run back to back on one stream and the outputs come
        back in one read.  Returns ``None`` to decline to the
        per-primitive path on the JAX package's conditions: a refine spec
        with zero or >30 constraints, a shard without a packed track, or
        a wave whose tracks are all empty.  ``prefetch_shards`` — the
        next wave — are staged before this wave's outputs are read."""
        shards = list(shards)
        probes = [list(ps) for ps in probes]
        if not shards:
            return [], [], ([] if agg is not None else None)
        packs = None
        edges: Tuple = ()
        mcs: Tuple = ()
        dws: Tuple = ()
        if refine is not None:
            cons = list(refine.constraints)
            edges = tuple(tuple(e) for e in refine.edges)
            mcs = tuple(int(k) for k in
                        (getattr(refine, "min_counts", None) or ()))
            dws = tuple(None if d is None else float(d) for d in
                        (getattr(refine, "dwells", None) or ()))
            if not _has_red(mcs, dws):
                mcs, dws = (), ()
            if not cons or len(cons) > MAX_CONSTRAINTS:
                return None
            packs = [self._track_pack(sh.batch, refine.path)
                     for sh in shards]
            if any(p is None for p, _ in packs):
                return None
        ns = [sh.n for sh in shards]
        n_max = max(ns)
        fulls = [sh.all_bitmap() for sh in shards]
        if n_max == 0 or max(f.size for f in fulls) == 0:
            # all-empty wave: nothing to compute, but it still counts one
            # fused dispatch so the ⌈shards/wave⌉ contract stays exact
            _ops.record_launch("run_wave_fused")
            if prefetch_shards:
                self.prefetch_wave(prefetch_shards, refine, agg)
            seg = ([(np.zeros(0, dtype=np.int64), []) for _ in shards]
                   if agg is not None else None)
            return ([0] * len(shards),
                    [np.zeros(0, dtype=np.int64) for _ in shards], seg)
        if refine is not None and max(p.shape[1] for p, _ in packs) == 0:
            return None
        if profile is None:     # explicit config wins over the env knob
            profile = os.environ.get("REPRO_EXEC_PROFILE") == "1"
        t_up = time.perf_counter()
        probe_dev = self._up(self._probe_stack(fulls, probes))
        ns_dev = self._up(np.asarray(ns, dtype=np.int32))
        pts_stack = rows_stack = cov_dev = None
        if refine is not None:
            pts_stack, rows_stack = self._refine_stack(shards, packs,
                                                       refine.path)
            cov_dev = self._up(pack_constraints(cons))
        codes_dev, vals_dev, total = None, (), 0
        facts, offsets = [], None
        if agg is not None:
            facts, offsets, codes_dev, vals_dev, total = \
                self._agg_stacks(shards, agg, n_max)
        if profile:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            _fused.record_stage(
                "upload", (time.perf_counter() - t_up) * 1e3)
        minmax = tuple(getattr(agg, "minmax", ()) or ()) \
            if agg is not None else ()
        cand, sel_idx, sel_counts, segs = _ops.run_wave_fused(
            probe_dev, ns_dev, pts_stack, rows_stack, cov_dev, codes_dev,
            vals_dev, num_docs=n_max, edges=edges, min_counts=mcs,
            dwells=dws, total_groups=total, profile=profile, minmax=minmax)
        # stage wave k+1's buffers before wave k's outputs sync to host
        if prefetch_shards:
            self.prefetch_wave(prefetch_shards, refine, agg)
        idx_h = sel_idx.cpu().numpy()
        counts_h = sel_counts.cpu().numpy()
        n_cands = [int(c) for c in cand.cpu().numpy()]
        ids_list = [idx_h[i, :int(counts_h[i])].astype(np.int64)
                    for i in range(len(shards))]
        seg = None
        if agg is not None:
            # (count, sum, sumsq) triples, or 5-tuples with the per-group
            # min/max planes appended for flagged value slots
            slot_host = []
            for st in (segs or []):
                slot = (st[0].cpu().numpy().astype(np.int64),
                        st[1].cpu().numpy(), st[2].cpu().numpy())
                if len(st) == 5:
                    slot = (*slot,
                            st[3].cpu().numpy().astype(np.float64),
                            st[4].cpu().numpy().astype(np.float64))
                slot_host.append(slot)
            seg = []
            for i, (uniq, _c, g) in enumerate(facts):
                off = int(offsets[i])
                # g == 0 → (uniq, []) exactly like the base-class oracle
                seg.append((uniq,
                            [tuple(a[off:off + g] for a in slot)
                             for slot in slot_host] if g else []))
        return n_cands, ids_list, seg

    # --------------------------------------------- multi-query (coalesced)
    def probe_shards_multi(self, fulls, probes_multi):
        """Q queries' wave probes in ONE ``bitmap_intersect_batched``
        launch: the query axis is folded into the stacked shard axis
        ([Q·S, K, W]) — the AND-reduce is row-independent, so per-query
        slices are byte-equal to the loop-over-queries oracle."""
        fulls = list(fulls)
        probes_multi = [[list(ps) for ps in probes]
                        for probes in probes_multi]
        n_q, n_s = len(probes_multi), len(fulls)
        if n_q == 0:
            return []
        if n_s == 0:
            return [[] for _ in range(n_q)]
        if max(f.size for f in fulls) == 0:
            return [[f.copy() for f in fulls] for _ in range(n_q)]
        stack = self._probe_stack(fulls * n_q,
                                  [ps for probes in probes_multi
                                   for ps in probes])
        bms, _counts = _ops.bitmap_intersect_batched(self._up(stack))
        bms = to_host(bms, np.uint32)
        return [[bms[q * n_s + i, :f.size].copy()
                 for i, f in enumerate(fulls)] for q in range(n_q)]

    def refine_tracks_multi(self, batches, path, constraints_list,
                            candidates_lists=None, edges_list=None,
                            with_first_hits: bool = False,
                            min_counts_list=None, dwells_list=None):
        """Q coalesced queries' refine in ONE ``refine_tracks_multi``
        launch: the wave's track buffers are stacked once and shared, the
        per-query constraint tables ride a leading query axis (padded to
        a common C/R by ``exec.refine.pack_constraints_multi``); each
        query's edges are compared on the device against its slice of the
        first-hit tables, and reductions recompute its verdict host-side
        from its slice with the pad constraints cut off.  Falls back to
        the loop-over-queries oracle when a query has 0 or >30
        constraints, a shard lacks a packed track, or the wave has no
        docs or points, as the JAX package does."""
        batches = list(batches)
        constraints_list = [list(c) for c in constraints_list]
        n_q = len(constraints_list)
        if candidates_lists is None:
            candidates_lists = [None] * n_q
        if edges_list is None:
            edges_list = [()] * n_q
        edges_list = [tuple(tuple(e) for e in es) for es in edges_list]
        if min_counts_list is None:
            min_counts_list = [None] * n_q
        if dwells_list is None:
            dwells_list = [None] * n_q

        def fallback():
            return super(TorchBackend, self).refine_tracks_multi(
                batches, path, constraints_list, candidates_lists,
                edges_list, with_first_hits=with_first_hits,
                min_counts_list=min_counts_list, dwells_list=dwells_list)

        if n_q == 0 or not batches or any(
                not c or len(c) > MAX_CONSTRAINTS for c in constraints_list):
            return fallback()
        packs = [self._track_pack(b, path) for b in batches]
        if any(pts is None for pts, _ in packs):
            return fallback()
        ns = [b.n for b in batches]
        n_max = max(ns)
        if n_max == 0 or max(pts.shape[1] for pts, _ in packs) == 0:
            return fallback()
        pts_stack, rows_stack = self._stack_tracks(packs)
        cov = self._up(pack_constraints_multi(constraints_list))
        cands_q = [c if c is not None else [None] * len(batches)
                   for c in candidates_lists]
        if any(_has_red(mc, dw)
               for mc, dw in zip(min_counts_list, dwells_list)):
            # one analytics launch; every query's verdict is recomputed
            # host-side from its slice of the reduction tables (pad
            # constraints sliced off, so vacuous k=0 stays vacuous)
            planes = [t.cpu().numpy() for t in _ops.refine_tracks_multi(
                pts_stack, rows_stack, cov, n_max, with_analytics=True)[1:]]
            results = []
            for q in range(n_q):
                c_q = len(constraints_list[q])
                masks, tables = [], []
                for i, (n, cand) in enumerate(zip(ns, cands_q[q])):
                    first, last, count = self._host_tables(
                        cand, *(pl[q, i, :c_q, :n] for pl in planes))
                    m = reduction_verdict(first, last, count, edges_list[q],
                                          min_counts_list[q],
                                          dwells_list[q])
                    if cand is not None:
                        m &= np.asarray(cand, dtype=bool)
                    masks.append(m)
                    tables.append(first)
                results.append((masks, tables) if with_first_hits
                               else masks)
            return results
        need_fh = with_first_hits or any(edges_list)
        r = _ops.refine_tracks_multi(pts_stack, rows_stack, cov, n_max,
                                     with_first_hits=need_fh)
        out_d = r
        if need_fh:
            out_d, fh_hi, fh_lo = r
            per_q = []
            for q, edges in enumerate(edges_list):
                m = out_d[q]
                for i, j in edges:
                    m = m & _fused.first_hit_before(fh_hi[q], fh_lo[q], i, j)
                per_q.append(m)
            out_d = torch.stack(per_q)
        out = out_d.cpu().numpy()
        if with_first_hits:
            hi_h, lo_h = fh_hi.cpu().numpy(), fh_lo.cpu().numpy()
        results = []
        for q in range(n_q):
            masks = [out[q, i, :n].copy() for i, n in enumerate(ns)]
            for m, cand in zip(masks, cands_q[q]):
                if cand is not None:
                    m &= np.asarray(cand, dtype=bool)
            if with_first_hits:
                # only the query's real constraints (pad rows cut off)
                c_q = len(constraints_list[q])
                tables = [self._host_tables(cand, hi_h[q, i, :c_q, :n],
                                            lo_h[q, i, :c_q, :n])
                          for i, (n, cand) in enumerate(zip(ns, cands_q[q]))]
                results.append((masks, tables))
            else:
                results.append(masks)
        return results

    def run_wave_fused_multi(self, shards, probes_multi, refines,
                             prefetch_shards=None):
        """Q coalesced selection queries through one wave in ONE
        ``run_wave_fused_multi`` dispatch (``kernels.fused``): per-query
        probe stacks ride a leading query axis folded into the stacked
        probe and compact kernels, the per-query constraint tables a
        leading axis of the multi-query refine kernel, and the wave's
        track buffers are shared.  Declines (``None``; the server then
        runs each query alone) where the JAX package does: a mixed
        refine/no-refine group or mixed paths, a query with 0 or >30
        constraints or with only vacuous (k=0) constraints, a shard
        without a packed track, or a wave whose tracks are all empty."""
        shards = list(shards)
        probes_multi = [[list(ps) for ps in probes]
                        for probes in probes_multi]
        n_q = len(probes_multi)
        if n_q == 0:
            return []
        if not shards:
            return [([], []) for _ in range(n_q)]
        refines = list(refines)
        has_refine = any(r is not None for r in refines)
        packs = None
        empty = tuple(() for _ in range(n_q))
        mcs_multi, dws_multi, edges_multi = empty, empty, empty
        if has_refine:
            if not all(r is not None for r in refines) \
                    or len({r.path for r in refines}) != 1:
                return None
            path = refines[0].path
            cons_list = [list(r.constraints) for r in refines]
            if any(not c or len(c) > MAX_CONSTRAINTS for c in cons_list):
                return None
            mcs = tuple(tuple(int(k) for k in
                              (getattr(r, "min_counts", None) or ()))
                        for r in refines)
            dws = tuple(tuple(None if d is None else float(d) for d in
                              (getattr(r, "dwells", None) or ()))
                        for r in refines)
            if any(_has_red(mc, dw) for mc, dw in zip(mcs, dws)):
                mcs_multi, dws_multi = mcs, dws
            for mc, dw in zip(mcs, dws):
                if mc and all(k <= 0 for k in mc) \
                        and not any(d is not None for d in dw):
                    # an all-vacuous query passes docs with no points; the
                    # always-hit pad constraints cannot express that
                    return None
            packs = [self._track_pack(sh.batch, path) for sh in shards]
            if any(p is None for p, _ in packs):
                return None
            edges_multi = tuple(tuple(tuple(e) for e in r.edges)
                                for r in refines)
        ns = [sh.n for sh in shards]
        n_max = max(ns)
        fulls = [sh.all_bitmap() for sh in shards]
        pre_refine = refines[0] if has_refine else None
        if n_max == 0 or max(f.size for f in fulls) == 0:
            # all-empty wave: still one dispatch, so the coalesced
            # ⌈shards/wave⌉ total-launch contract stays exact
            _ops.record_launch("run_wave_fused_multi")
            if prefetch_shards:
                self.prefetch_wave(prefetch_shards, pre_refine)
            return [([0] * len(shards),
                     [np.zeros(0, dtype=np.int64) for _ in shards])
                    for _ in range(n_q)]
        if has_refine and max(p.shape[1] for p, _ in packs) == 0:
            return None
        stack = self._probe_stack(fulls * n_q, [ps for probes in probes_multi
                                                for ps in probes])
        probe_dev = self._up(stack.reshape((n_q, len(shards))
                                           + stack.shape[1:]))
        ns_dev = self._up(np.asarray(ns, dtype=np.int32))
        pts_stack = rows_stack = cov_dev = None
        if has_refine:
            pts_stack, rows_stack = self._refine_stack(shards, packs, path)
            cov_dev = self._up(pack_constraints_multi(cons_list))
        cand, sel_idx, sel_counts = _ops.run_wave_fused_multi(
            probe_dev, ns_dev, pts_stack, rows_stack, cov_dev,
            num_docs=n_max, edges_multi=edges_multi,
            min_counts_multi=mcs_multi, dwells_multi=dws_multi)
        # stage wave k+1's buffers before wave k's outputs sync to host
        if prefetch_shards:
            self.prefetch_wave(prefetch_shards, pre_refine)
        cand_h = cand.cpu().numpy()
        idx_h = sel_idx.cpu().numpy()
        counts_h = sel_counts.cpu().numpy()
        return [([int(c) for c in cand_h[q]],
                 [idx_h[q, i, :int(counts_h[q, i])].astype(np.int64)
                  for i in range(len(shards))]) for q in range(n_q)]

    def postings_bitmap(self, ids, t_min, t_max, t0, t1, n_docs):
        """Postings OR + span prune as one device pass over the resident
        ``t_min``/``t_max`` buffers (``kernels.fused.postings_bitmap``);
        the per-shard probe of the retry path reaches it."""
        bm = _ops.postings_bitmap(
            self._up(np.asarray(ids, dtype=np.int64)), self._dev(t_min),
            self._dev(t_max), float(t0), float(t1), n_docs)
        return to_host(bm, np.uint32)

    def prefetch_wave(self, shards, refine=None, agg=None) -> None:
        """Stage the next wave's keyed stacked buffers (refine point
        stacks, offset group codes, value stacks) so its fused dispatch
        starts from resident device memory.  Nothing here syncs."""
        shards = list(shards)
        if not shards:
            return
        if self.trace_events is not None:
            self.trace_events.append(("prefetch", len(shards)))
        n_max = max(sh.n for sh in shards)
        if n_max == 0:
            return
        if refine is not None:
            cons = list(refine.constraints)
            if cons and len(cons) <= MAX_CONSTRAINTS:
                packs = [self._track_pack(sh.batch, refine.path)
                         for sh in shards]
                if all(p is not None for p, _ in packs) and \
                        max(p.shape[1] for p, _ in packs) > 0:
                    self._refine_stack(shards, packs, refine.path)
        if agg is not None:
            self._agg_stacks(shards, agg, n_max)

    # ------------------------------------------------------ sketch aggregation
    def segment_hll(self, codes, reg_idx, ranks, num_groups: int,
                    num_regs: int) -> np.ndarray:
        """One ``segment_hll`` dispatch: the (group, register) pair folds
        into a composite int64 segment id and the rank plane max-reduces
        on the device (``scatter_reduce_`` amax — an exact uint8 max, so
        the result is byte-equal to the host scatter oracle)."""
        codes = np.asarray(codes, dtype=np.int64)
        reg_idx = np.asarray(reg_idx, dtype=np.int64)
        composite = np.where(codes >= 0, codes * num_regs + reg_idx, -1)
        out = _ops.segment_hll(
            self._up(composite),
            self._up(np.asarray(ranks, dtype=np.uint8)[:, None]),
            num_groups * num_regs)
        return out[:, 0].cpu().numpy().reshape(num_groups, num_regs)

    # ------------------------------------------------------ partition layer
    def partition_card(self, part: int, num_parts: int) -> torch.device:
        """The card partition ``part`` of ``num_parts`` runs on: card
        ``part mod D`` of ``make_exec_mesh(num_parts)``; the backend's
        own device for one partition or on the CPU."""
        if num_parts <= 1 or self._home.type != "cuda":
            return self._home
        mesh = make_exec_mesh(num_parts, self._home)
        return mesh[part % len(mesh)]

    @contextlib.contextmanager
    def partition_context(self, part: int, num_parts: int):
        """The engines enter this around each partition's waves: the
        calling thread's waves run on ``partition_card(part, num_parts)``
        (the JAX package pins partition p to device p mod D the same way)
        and read that card's resident buffers.  The choice is the
        thread's own (``threading.local``, with CUDA's current device of
        the thread set to match), because the engines run partitions
        concurrently; it is undone on exit.  On a backend on the CPU, and
        for one partition, it changes nothing."""
        if num_parts <= 1 or self._home.type != "cuda":
            yield
            return
        card = self.partition_card(part, num_parts)
        self._card_cache(card)
        prev = getattr(self._local, "device", None)
        self._local.device = card
        try:
            with torch.cuda.device(card):
                yield
        finally:
            self._local.device = prev

    def merge_partials(self, states, minmax=(), parts=None):
        """One-dispatch device combine of the per-shard segment states:
        the states came back to the host from each partition's card;
        align every state to the sorted union key space there, stack
        ``[S, K, G]`` planes once (identity fill: 0 for count/sum/sum_sq,
        ±inf for min/max, False for presence), upload them to the first
        card of the exec mesh (``partition_card(0, P)``, P = ``len(parts)``;
        the backend's own device without ``parts``) and make **one**
        ``ops.merge_partials`` call, which accumulates in states order —
        bit-equal to the numpy oracle (``kernels/merge.py``).  No
        cross-card reduction runs: per-card subtotals would change the
        float sums' order.  With no live state it still makes one combine
        call, so the launch contract stays exact."""
        dev = self.partition_card(0, len(parts) if parts else 1)
        states = [(np.asarray(k), list(slots)) for k, slots in states]
        live = [st for st in states if len(st[0]) and st[1]]
        if not live:
            zero = torch.zeros((1, 1, 0), dtype=torch.float64, device=dev)
            _ops.merge_partials(zero.to(torch.int64), zero, zero, zero,
                                zero, torch.zeros((1, 0), dtype=torch.bool,
                                                  device=dev))
            return np.zeros(0, np.int64), []
        union = np.unique(np.concatenate([k for k, _ in live]))
        n_states = len(live)
        n_slots = max(len(slots) for _, slots in live)
        mm = tuple(minmax)
        mm = mm + (False,) * (n_slots - len(mm))
        g = union.size
        cnt = np.zeros((n_states, n_slots, g), np.int64)
        s = np.zeros((n_states, n_slots, g), np.float64)
        s2 = np.zeros((n_states, n_slots, g), np.float64)
        mn = np.full((n_states, n_slots, g), np.inf)
        mx = np.full((n_states, n_slots, g), -np.inf)
        msk = np.zeros((n_states, g), bool)
        for si, (keys, slots) in enumerate(live):
            idx = np.searchsorted(union, keys)
            for k, st in enumerate(slots):
                cnt[si, k, idx] = np.asarray(st[0], np.int64)
                s[si, k, idx] = np.asarray(st[1], np.float64)
                s2[si, k, idx] = np.asarray(st[2], np.float64)
                if len(st) >= 5:
                    mn[si, k, idx] = np.asarray(st[3], np.float64)
                    mx[si, k, idx] = np.asarray(st[4], np.float64)
            msk[si, idx] = np.asarray(slots[0][0]) > 0
        out = _ops.merge_partials(*(to_device(a, dev) for a in
                                    (cnt, s, s2, mn, mx, msk)))
        o_cnt, o_s, o_s2, o_mn, o_mx = [x.cpu().numpy() for x in out[:5]]
        merged = []
        for k in range(n_slots):
            slot = (o_cnt[k], o_s[k], o_s2[k])
            if mm[k]:
                slot = (*slot, o_mn[k], o_mx[k])
            merged.append(slot)
        return union, merged


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_FACTORIES: Dict[str, Callable[[], ExecBackend]] = {}
_INSTANCES: Dict[str, ExecBackend] = {}


def register_backend(name: str, factory: Callable[[], ExecBackend]) -> None:
    """Register (or replace) a backend under ``name``."""
    _FACTORIES[name] = factory
    _INSTANCES.pop(name, None)


def backend_names() -> List[str]:
    return sorted(_FACTORIES)


register_backend("numpy", NumpyBackend)
register_backend("torch", TorchBackend)


def get_backend(spec: Optional[str] = None) -> ExecBackend:
    """Resolve a backend name (default ``torch``, which runs on CUDA).
    No environment variable changes the default: the numpy oracle is
    chosen only by name or instance."""
    name = spec or "torch"
    if name not in _FACTORIES:
        raise ValueError(f"unknown exec backend {name!r}; "
                         f"registered: {backend_names()}")
    if name not in _INSTANCES:
        _INSTANCES[name] = _FACTORIES[name]()
    return _INSTANCES[name]


def as_backend(spec: Union[None, str, ExecBackend]) -> ExecBackend:
    """Accept None (``torch``), a registered name, or an instance."""
    if isinstance(spec, ExecBackend):
        return spec
    return get_backend(spec)
