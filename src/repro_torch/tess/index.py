"""Space-time postings index for trip tracks (paper §2, §6: Tesseract).

The paper's headline workload asks for "all trips passing through region A
during time window T1 *and* region B during T2" over petabyte-scale track
data.  Per shard we build one :class:`SpaceTimeIndex` per indexed track
field: every track point posts into a **(area-tree cell × time bucket)**
key, and postings are surfaced as the same uint32-word bitmaps the rest of
the query hot loop uses — so a Tesseract constraint probe is a bitmap OR
over matching keys, and a multi-constraint query is a stacked bitmap AND
handled by the ``bitset`` kernel through the ``ExecBackend`` seam.

Key layout: ``(cell_index << TIME_BITS) | bucket`` with the cell index the
6·level-bit Morton prefix of the point (the same level-``level`` cells the
``area`` index and :func:`repro_torch.geo.areatree.cover` produce) and the bucket
``floor((t - epoch) / bucket_s)``.  Keys of one cell are contiguous, so a
region cover (disjoint Morton ranges) translates into a few ``searchsorted``
spans with a post-filter on the bucket field — no per-cell probing.

The index also keeps each doc's ``[t_min, t_max]`` track span and prunes
docs whose span misses the query window with the same offset-overlap test
:class:`repro_torch.core.sketches.IntervalSet` uses (overlap ⇔ ``t_min ≤ q_hi``
and ``t_max ≥ q_lo``) — cheap, and it removes the cell-granularity false
positives of trips that pass the region at a different time of day.

Probes are **conservative**: a returned doc's track touches a covered cell
during an overlapping bucket, which is a superset of exactly passing through
the region during the window.  The planner therefore also compiles the
constraint into a ``RefineSpec``: the exact point-in-cover × time-window
pass runs *on device* behind the backend's ``refine_tracks`` /
``refine_tracks_batched`` ops (the CUDA ``refine`` kernel over the
shard's resident CSR track buffers; see ``repro_torch.core.planner`` and
``repro_torch.exec.refine``), and its per-doc hit mask feeds the selection
compaction.

Time is bucketed relative to ``epoch``: build clamps points outside
``[epoch, epoch + 2^20·bucket_s)`` into the boundary buckets — pick
``epoch`` ≤ the dataset's earliest timestamp for time discrimination.
Query windows entirely outside the representable range return no
candidates when nothing was clamped on that side (the common case; they
must not alias onto unrelated bucket-0 / MAX_BUCKET postings), and
collapse onto the boundary bucket when build did clamp points there —
conservative either way, so ``find()`` always agrees with the exact
``filter()`` semantics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..fdb.columnar import span_indices
from ..fdb.index import bitmap_from_ids, bitmap_zeros
from ..geo import mercator as M
from ..geo.areatree import AreaTree

__all__ = ["SpaceTimeIndex", "TIME_BITS", "MAX_BUCKET"]

TIME_BITS = 20                        # buckets per key: 2^20 ≈ 18 years @ 15 min
MAX_BUCKET = (1 << TIME_BITS) - 1
_TB = np.uint64(TIME_BITS)
_BMASK = np.uint64(MAX_BUCKET)
_ONE = np.uint64(1)


@dataclass
class SpaceTimeIndex:
    """(cell × time-bucket) → docs postings over one repeated track field."""

    level: int                 # area-tree cell level of the spatial key part
    bucket_s: float            # time bucket width, seconds
    epoch: float               # t of bucket 0
    keys: np.ndarray           # sorted unique uint64 (cell << TIME_BITS) | bucket
    splits: np.ndarray         # int64 [K+1] CSR into doc_ids
    doc_ids: np.ndarray        # int64 [total]
    t_min: np.ndarray          # float64 [n_docs]; +inf for empty tracks
    t_max: np.ndarray          # float64 [n_docs]; -inf for empty tracks
    n_docs: int
    #: build saw points clamped into the boundary buckets (t < epoch /
    #: past bucket 2^20−1) — out-of-range query windows must then stay
    #: conservative and probe the boundary bucket instead of short-
    #: circuiting to empty
    clamped_lo: bool = False
    clamped_hi: bool = False

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(lat: np.ndarray, lng: np.ndarray, t: np.ndarray, n_docs: int,
              row_splits: Optional[np.ndarray] = None, *,
              level: int = 6, bucket_s: float = 900.0,
              epoch: float = 0.0) -> "SpaceTimeIndex":
        if not 0 < level <= (64 - TIME_BITS) // 6:
            # the packed key is (6·level cell bits) << TIME_BITS | bucket;
            # beyond level 7 it would overflow uint64 and silently corrupt
            # lookups, so reject at build time
            raise ValueError(f"spacetime index level must be in "
                             f"[1, {(64 - TIME_BITS) // 6}], got {level}")
        if bucket_s <= 0:
            raise ValueError("bucket_s must be positive")
        lat = np.asarray(lat, dtype=np.float64)
        lng = np.asarray(lng, dtype=np.float64)
        t = np.asarray(t, dtype=np.float64)
        if row_splits is not None:
            docs = np.repeat(np.arange(n_docs, dtype=np.int64),
                             np.diff(row_splits))
        else:
            docs = np.arange(n_docs, dtype=np.int64)[: lat.size]
        t_min = np.full(n_docs, np.inf)
        t_max = np.full(n_docs, -np.inf)
        if t.size:
            np.minimum.at(t_min, docs, t)
            np.maximum.at(t_max, docs, t)
        if lat.size == 0:
            return SpaceTimeIndex(level, bucket_s, epoch,
                                  np.zeros(0, dtype=np.uint64),
                                  np.zeros(1, dtype=np.int64),
                                  np.zeros(0, dtype=np.int64),
                                  t_min, t_max, n_docs)
        shift = np.uint64(6 * (M.MAX_LEVEL - level))
        cell = M.latlng_to_morton(lat, lng) >> shift
        # Build-side clamp: points before ``epoch`` post into bucket 0 and
        # points past bucket 2^20−1 into MAX_BUCKET, so out-of-range data
        # stays discoverable by windows that reach (or overshoot toward)
        # the boundary buckets.  ``epoch`` should be ≤ the dataset's
        # earliest t (and the bucket width wide enough for its span) for
        # the index to discriminate in time; the ``clamped_lo``/
        # ``clamped_hi`` flags remember that the clamp fired, so
        # :meth:`_bucket_range` only short-circuits out-of-range windows
        # to empty when no clamped postings exist to alias onto.
        raw_bucket = np.floor((t - epoch) / bucket_s)
        clamped_lo = bool(np.any(raw_bucket < 0))
        clamped_hi = bool(np.any(raw_bucket > MAX_BUCKET))
        bucket = np.clip(raw_bucket, 0, MAX_BUCKET).astype(np.uint64)
        ck = (cell << _TB) | bucket
        order = np.lexsort((docs, ck))
        ck_s, docs_s = ck[order], docs[order]
        # dedupe (key, doc) pairs — a track may linger in one cell+bucket
        keep = np.ones(ck_s.size, dtype=bool)
        keep[1:] = (ck_s[1:] != ck_s[:-1]) | (docs_s[1:] != docs_s[:-1])
        ck_s, docs_s = ck_s[keep], docs_s[keep]
        uniq, starts = np.unique(ck_s, return_index=True)
        splits = np.concatenate([starts, [ck_s.size]]).astype(np.int64)
        return SpaceTimeIndex(level, bucket_s, epoch, uniq, splits, docs_s,
                              t_min, t_max, n_docs, clamped_lo, clamped_hi)

    # ----------------------------------------------------------------- lookup
    def _bucket_range(self, t0: float, t1: float
                      ) -> Optional[Tuple[int, int]]:
        """Bucket span of ``[t0, t1]``, or ``None`` when the window misses
        every posted bucket.

        Build time clamps out-of-range *points* into the boundary buckets
        (0 / ``MAX_BUCKET``), which keeps probes conservative for windows
        that reach a boundary.  A window that ends before ``epoch`` or
        starts past bucket 2^20−1 must NOT be clamped the same way when no
        such points exist — that would alias it onto the boundary buckets
        and probe unrelated postings — so it reports no intersection
        instead.  When build *did* clamp points on that side
        (``clamped_lo``/``clamped_hi``), the window collapses onto the
        boundary bucket: those postings are a genuine superset of the
        window's matches, preserving the conservative contract even when
        ``epoch`` was chosen inside the data's time span.
        """
        b0 = np.floor((t0 - self.epoch) / self.bucket_s)
        b1 = np.floor((t1 - self.epoch) / self.bucket_s)
        if b1 < 0 and not self.clamped_lo:
            return None
        if b0 > MAX_BUCKET and not self.clamped_hi:
            return None
        return (int(np.clip(b0, 0, MAX_BUCKET)),
                int(np.clip(b1, 0, MAX_BUCKET)))

    def lookup(self, region: AreaTree, t0: float, t1: float,
               backend=None) -> np.ndarray:
        """Candidate docs with a track point in a cell covering ``region``
        during a bucket overlapping ``[t0, t1]`` (superset of exact).

        The postings OR is a single spans-concatenate gather: per cover
        range, ``searchsorted`` bounds the key span; matching keys across
        *all* ranges are collected at once (bucket post-filter included)
        and their CSR doc lists concatenated without any per-key Python
        loop — the key-fan-out cost is one vectorized gather.

        ``backend`` (an ``ExecBackend``) lowers the tail — the doc-id OR
        into a word bitmap plus the ``[t_min, t_max]`` span prune — behind
        the exec seam (``postings_bitmap``), running it on device over the
        primed span buffers; ``None`` keeps the host math.
        """
        if region.is_empty or t1 < t0 or self.keys.size == 0:
            return bitmap_zeros(self.n_docs)
        br = self._bucket_range(t0, t1)
        if br is None:                 # window outside representable range
            return bitmap_zeros(self.n_docs)
        b0, b1 = br
        shift = np.uint64(6 * (M.MAX_LEVEL - self.level))
        c0 = region.lo >> shift
        c1 = (region.hi - _ONE) >> shift          # inclusive cell ranges
        a = np.searchsorted(self.keys, (c0 << _TB) | np.uint64(b0),
                            side="left")
        b = np.searchsorted(self.keys, (c1 << _TB) | np.uint64(b1),
                            side="right")
        kidx = span_indices(a, b)                 # key slots, all ranges
        if kidx.size == 0:
            return bitmap_zeros(self.n_docs)
        bk = self.keys[kidx] & _BMASK
        kidx = kidx[(bk >= b0) & (bk <= b1)]      # bucket post-filter
        if kidx.size == 0:
            return bitmap_zeros(self.n_docs)
        ids = self.doc_ids[span_indices(self.splits[kidx],
                                        self.splits[kidx + 1])]
        if backend is not None:
            return backend.postings_bitmap(ids, self.t_min, self.t_max,
                                           t0, t1, self.n_docs)
        bm = bitmap_from_ids(ids, self.n_docs)
        # IntervalSet-style span prune: drop docs whose whole track misses
        # the window (kills same-place-different-time false positives).
        overlap = (self.t_min <= t1) & (self.t_max >= t0)
        return bm & bitmap_from_ids(
            np.nonzero(overlap)[0].astype(np.int64), self.n_docs)

    def span(self) -> Optional[Tuple[float, float]]:
        """Time span ``(lo, hi)`` covered by any track point in this
        shard, or ``None`` when unknown (no docs, or no doc has points).

        This is the shard-level partition statistic behind the planner's
        time-partitioned shard pruning: a query window ``[t0, t1]`` with
        ``t1 < lo`` or ``t0 > hi`` cannot match any doc here — docs with
        points all miss the window (their per-doc ``[t_min, t_max]``
        spans lie inside ``[lo, hi]``), and docs without points match no
        space-time constraint at all.  ``None`` means "keep the shard"
        (unknown is never grounds to prune)."""
        if self.n_docs == 0 or self.t_min.size == 0:
            return None
        lo = float(np.min(self.t_min))
        hi = float(np.max(self.t_max))
        if not (np.isfinite(lo) and np.isfinite(hi)):
            return None                       # every track empty
        return lo, hi

    def num_keys(self) -> int:
        return int(self.keys.size)

    def __repr__(self):
        return (f"SpaceTimeIndex(level={self.level}, "
                f"bucket_s={self.bucket_s}, keys={self.keys.size}, "
                f"docs={self.n_docs})")
