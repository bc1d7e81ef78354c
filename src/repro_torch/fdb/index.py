"""FDb secondary indices (paper §4.1.2) with bitmap postings.

Each shard carries fine-grained indices mapping index values → document ids
*within the shard*, so queries "selectively access the relevant data records
without first having to load the partitions".  Postings are surfaced as
fixed-width bitmaps (uint32 words over the shard's docs) because bitmap
AND/OR/ANDNOT is the query-time hot loop — that is the CUDA ``bitset``
kernel's job on device; numpy here is the host/build-side reference.

Index kinds:
  * ``tag``      — inverted index for discrete values (strings/ints)
  * ``range``    — sorted values + doc ids for numeric BETWEEN / comparisons
  * ``location`` — sorted 60-bit Morton keys; selected by AreaTree ranges
  * ``area``     — cell → docs postings over area-tree cells at a fixed
                   level; selects docs whose *geometry* (path/region)
                   intersects a query region (paper Fig. 5)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..geo import mercator as M
from ..geo.areatree import AreaTree

__all__ = [
    "bitmap_zeros", "bitmap_full", "bitmap_from_ids", "ids_from_bitmap",
    "mask_from_bitmap", "bitmap_stack", "popcount_words",
    "bitmap_and", "bitmap_or", "bitmap_andnot", "bitmap_not", "bitmap_count",
    "TagIndex", "RangeIndex", "LocationIndex", "AreaIndex",
]


# --------------------------------------------------------------------------
# Bitmaps (uint32 words).  Device-side equivalents live in repro_torch.kernels.
# --------------------------------------------------------------------------

def _nwords(n: int) -> int:
    return (n + 31) // 32


def bitmap_zeros(n: int) -> np.ndarray:
    return np.zeros(_nwords(n), dtype=np.uint32)


def bitmap_full(n: int) -> np.ndarray:
    bm = np.full(_nwords(n), 0xFFFFFFFF, dtype=np.uint32)
    tail = n % 32
    if tail and bm.size:
        bm[-1] = np.uint32((1 << tail) - 1)
    return bm


def bitmap_from_ids(ids: np.ndarray, n: int) -> np.ndarray:
    bm = bitmap_zeros(n)
    ids = np.asarray(ids, dtype=np.int64)
    if ids.size:
        np.bitwise_or.at(bm, ids >> 5,
                         (np.uint32(1) << (ids & 31).astype(np.uint32)))
    return bm


def mask_from_bitmap(bm: np.ndarray, n: int) -> np.ndarray:
    """Word bitmap → per-doc bool mask [n] (compaction-kernel input)."""
    return np.unpackbits(bm.view(np.uint8), bitorder="little")[:n] \
        .view(np.bool_)


def ids_from_bitmap(bm: np.ndarray, n: int) -> np.ndarray:
    return np.nonzero(mask_from_bitmap(bm, n))[0].astype(np.int64)


def bitmap_stack(bitmaps: Sequence[np.ndarray]) -> np.ndarray:
    """Stack K same-length bitmaps into one C-contiguous [K, W] uint32
    buffer — the exact word-level layout ``kernels.ops.bitmap_intersect``
    consumes, so device dispatch needs no per-bit expansion or re-copy."""
    if not bitmaps:
        raise ValueError("bitmap_stack of zero bitmaps")
    return np.stack(bitmaps).astype(np.uint32, copy=False)


def bitmap_and(a, b):
    return a & b


def bitmap_or(a, b):
    return a | b


def bitmap_andnot(a, b):
    return a & ~b


def bitmap_not(a, n: int):
    return bitmap_full(n) & ~a


_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


def popcount_words(bm: np.ndarray) -> int:
    """Set bits of a uint32 word array, without per-bit expansion."""
    return int(_POP8[bm.view(np.uint8)].sum())


def bitmap_count(bm: np.ndarray) -> int:
    return popcount_words(bm)


# --------------------------------------------------------------------------
# Tag index
# --------------------------------------------------------------------------

@dataclass
class TagIndex:
    """Inverted index: discrete value → sorted doc ids."""

    keys: np.ndarray          # sorted unique int64 keys (string hash or int)
    splits: np.ndarray        # int64 [K+1] CSR into doc_ids
    doc_ids: np.ndarray       # int64 [total]
    n_docs: int
    vocab: Optional[Dict[str, int]] = None   # for string tags: str -> key

    @staticmethod
    def build(values: np.ndarray, n_docs: int,
              row_splits: Optional[np.ndarray] = None,
              vocab: Optional[List[str]] = None) -> "TagIndex":
        values = np.asarray(values)
        if row_splits is not None:
            docs = np.repeat(np.arange(n_docs, dtype=np.int64),
                             np.diff(row_splits))
        else:
            docs = np.arange(n_docs, dtype=np.int64)
        keys = values.astype(np.int64)
        order = np.lexsort((docs, keys))
        keys_s, docs_s = keys[order], docs[order]
        uniq, starts = np.unique(keys_s, return_index=True)
        splits = np.concatenate([starts, [keys_s.size]]).astype(np.int64)
        vmap = {s: i for i, s in enumerate(vocab)} if vocab is not None else None
        return TagIndex(uniq, splits, docs_s, n_docs, vmap)

    def _key_of(self, value) -> Optional[int]:
        if self.vocab is not None:
            if not isinstance(value, str):
                value = str(value)
            if value not in self.vocab:
                return None
            return self.vocab[value]
        return int(value)

    def lookup(self, value) -> np.ndarray:
        k = self._key_of(value)
        if k is None:
            return bitmap_zeros(self.n_docs)
        i = np.searchsorted(self.keys, k)
        if i >= self.keys.size or self.keys[i] != k:
            return bitmap_zeros(self.n_docs)
        ids = self.doc_ids[self.splits[i]:self.splits[i + 1]]
        return bitmap_from_ids(ids, self.n_docs)

    def lookup_any(self, values: Sequence) -> np.ndarray:
        bm = bitmap_zeros(self.n_docs)
        for v in values:
            bm |= self.lookup(v)
        return bm


# --------------------------------------------------------------------------
# Range index
# --------------------------------------------------------------------------

@dataclass
class RangeIndex:
    sorted_values: np.ndarray
    doc_ids: np.ndarray
    n_docs: int

    @staticmethod
    def build(values: np.ndarray, n_docs: int,
              row_splits: Optional[np.ndarray] = None) -> "RangeIndex":
        values = np.asarray(values)
        if row_splits is not None:
            docs = np.repeat(np.arange(n_docs, dtype=np.int64),
                             np.diff(row_splits))
        else:
            docs = np.arange(n_docs, dtype=np.int64)
        order = np.argsort(values, kind="stable")
        return RangeIndex(values[order], docs[order], n_docs)

    def lookup(self, lo=None, hi=None, lo_incl=True, hi_incl=True
               ) -> np.ndarray:
        v = self.sorted_values
        a = 0 if lo is None else int(
            np.searchsorted(v, lo, side="left" if lo_incl else "right"))
        b = v.size if hi is None else int(
            np.searchsorted(v, hi, side="right" if hi_incl else "left"))
        if b <= a:
            return bitmap_zeros(self.n_docs)
        return bitmap_from_ids(self.doc_ids[a:b], self.n_docs)


# --------------------------------------------------------------------------
# Location index
# --------------------------------------------------------------------------

@dataclass
class LocationIndex:
    """Sorted Morton keys of point locations → docs; selected by area ranges."""

    sorted_keys: np.ndarray    # uint64
    doc_ids: np.ndarray
    n_docs: int

    @staticmethod
    def build(lat: np.ndarray, lng: np.ndarray, n_docs: int,
              row_splits: Optional[np.ndarray] = None) -> "LocationIndex":
        keys = M.latlng_to_morton(lat, lng)
        if row_splits is not None:
            docs = np.repeat(np.arange(n_docs, dtype=np.int64),
                             np.diff(row_splits))
        else:
            docs = np.arange(n_docs, dtype=np.int64)
        order = np.argsort(keys, kind="stable")
        return LocationIndex(keys[order], docs[order], n_docs)

    def lookup(self, area: AreaTree) -> np.ndarray:
        """Docs whose location lies inside ``area`` (bbox or region, §4.1.2)."""
        if area.is_empty:
            return bitmap_zeros(self.n_docs)
        starts = np.searchsorted(self.sorted_keys, area.lo, side="left")
        ends = np.searchsorted(self.sorted_keys, area.hi, side="left")
        total = int(np.sum(ends - starts))
        if total == 0:
            return bitmap_zeros(self.n_docs)
        ids = np.concatenate([self.doc_ids[a:b]
                              for a, b in zip(starts, ends) if b > a])
        return bitmap_from_ids(ids, self.n_docs)


# --------------------------------------------------------------------------
# Area index
# --------------------------------------------------------------------------

@dataclass
class AreaIndex:
    """Cell → docs postings over area-tree cells at a fixed level.

    Indexes *geometries* (paths expanded to strips, regions, points expanded
    to circles — paper §4.1.2/Fig. 5).  A doc posts into every level-``level``
    cell its representative area touches; a query region selects the union of
    postings of the cells it covers → "all areas that intersect this region".
    """

    level: int
    cells: np.ndarray        # sorted unique uint64 cell indices (not aligned)
    splits: np.ndarray       # CSR into doc_ids
    doc_ids: np.ndarray
    n_docs: int

    @staticmethod
    def build(doc_areas: Sequence[AreaTree], level: int) -> "AreaIndex":
        shift = np.uint64(6 * (M.MAX_LEVEL - level))
        cell_list: List[np.ndarray] = []
        doc_list: List[np.ndarray] = []
        one = np.uint64(1)
        for doc, area in enumerate(doc_areas):
            if area.is_empty:
                continue
            c0 = area.lo >> shift
            c1 = (area.hi - one) >> shift
            counts = (c1 - c0 + one).astype(np.int64)
            total = int(counts.sum())
            base = np.repeat(c0, counts)
            offs = (np.arange(total, dtype=np.uint64)
                    - np.repeat(np.cumsum(counts) - counts, counts)
                    .astype(np.uint64))
            cs = np.unique(base + offs)
            cell_list.append(cs)
            doc_list.append(np.full(cs.size, doc, dtype=np.int64))
        if not cell_list:
            z = np.zeros(0, dtype=np.uint64)
            return AreaIndex(level, z, np.zeros(1, dtype=np.int64),
                             np.zeros(0, dtype=np.int64), len(doc_areas))
        cells = np.concatenate(cell_list)
        docs = np.concatenate(doc_list)
        order = np.lexsort((docs, cells))
        cells, docs = cells[order], docs[order]
        uniq, starts = np.unique(cells, return_index=True)
        splits = np.concatenate([starts, [cells.size]]).astype(np.int64)
        return AreaIndex(level, uniq, splits, docs, len(doc_areas))

    def lookup_region(self, region: AreaTree) -> np.ndarray:
        """All docs whose indexed area intersects ``region``."""
        if region.is_empty or self.cells.size == 0:
            return bitmap_zeros(self.n_docs)
        shift = np.uint64(6 * (M.MAX_LEVEL - self.level))
        one = np.uint64(1)
        c0 = region.lo >> shift
        c1 = (region.hi - one) >> shift
        bm = bitmap_zeros(self.n_docs)
        for lo, hi in zip(c0, c1):
            a = int(np.searchsorted(self.cells, lo, side="left"))
            b = int(np.searchsorted(self.cells, hi, side="right"))
            if b > a:
                ids = self.doc_ids[self.splits[a]:self.splits[b]]
                bm |= bitmap_from_ids(ids, self.n_docs)
        return bm

    def lookup_points(self, lat, lng) -> np.ndarray:
        """All docs whose indexed area covers any of the given points."""
        keys = M.latlng_to_morton(np.asarray(lat), np.asarray(lng))
        shift = np.uint64(6 * (M.MAX_LEVEL - self.level))
        cells = np.unique(keys >> shift)
        bm = bitmap_zeros(self.n_docs)
        idx = np.searchsorted(self.cells, cells)
        for i, c in zip(idx, cells):
            if i < self.cells.size and self.cells[i] == c:
                ids = self.doc_ids[self.splits[i]:self.splits[i + 1]]
                bm |= bitmap_from_ids(ids, self.n_docs)
        return bm
