"""64-way area trees (paper §4.1.2, Figure 5).

The paper indexes geospatial regions with *area trees*: quad-trees whose
nodes split 8×8 (=64 children), matching the spherical-Mercator gridding.
Because our Morton keys use 6 bits per level (3 x-bits + 3 y-bits), a node at
level *l* is exactly a 6*l-bit Morton prefix and its 64 children are the 64
possible next-6-bit extensions.  An area is therefore a set of canonical
cells ≡ a set of aligned, disjoint Morton-key ranges.

This module represents an ``AreaTree`` in its *normalized range form*: a
sorted array of disjoint half-open uint64 key ranges ``[lo, hi)``.  The three
set operations the paper calls out (union, intersection, difference —
"combined in a fast, efficient manner") are linear merges over the range
lists; ``node_masks`` recovers the paper's per-node 64-bit child-occupancy
bitmask form, which is what the CUDA ``bitset`` kernel operates on at query
time (postings bitmaps use the same word-wise bit algebra).

Covers are built by recursive 64-way refinement with a vectorized
cell-classifier (OUT / FULL / PARTIAL), exactly the paper's construction for
points-with-radius, path strips, and polygonal regions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np

from . import mercator as M

OUT, PARTIAL, FULL = 0, 1, 2
_U1 = np.uint64(1)
_KEY_SPACE = _U1 << np.uint64(60)

__all__ = ["AreaTree", "OUT", "PARTIAL", "FULL", "cover"]


def _merge_ranges(lo: np.ndarray, hi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sort + coalesce overlapping/adjacent [lo, hi) ranges."""
    if lo.size == 0:
        return lo, hi
    order = np.argsort(lo, kind="stable")
    lo, hi = lo[order], hi[order]
    # Running max of hi; a new group starts where lo > max(hi so far).
    run_hi = np.maximum.accumulate(hi)
    new_group = np.ones(lo.size, dtype=bool)
    new_group[1:] = lo[1:] > run_hi[:-1]
    group = np.cumsum(new_group) - 1
    n = group[-1] + 1
    out_lo = lo[new_group]
    out_hi = np.zeros(n, dtype=np.uint64)
    np.maximum.at(out_hi, group, hi)
    return out_lo, out_hi


@dataclass(frozen=True)
class AreaTree:
    """Normalized area: disjoint, sorted, half-open Morton-key ranges."""

    lo: np.ndarray  # uint64 [n]
    hi: np.ndarray  # uint64 [n]

    # ---------------------------------------------------------------- basics
    @staticmethod
    def empty() -> "AreaTree":
        z = np.zeros(0, dtype=np.uint64)
        return AreaTree(z, z.copy())

    @staticmethod
    def everything() -> "AreaTree":
        return AreaTree(np.array([0], dtype=np.uint64),
                        np.array([_KEY_SPACE], dtype=np.uint64))

    @staticmethod
    def from_ranges(lo, hi) -> "AreaTree":
        lo = np.asarray(lo, dtype=np.uint64).ravel()
        hi = np.asarray(hi, dtype=np.uint64).ravel()
        keep = hi > lo
        return AreaTree(*_merge_ranges(lo[keep], hi[keep]))

    @staticmethod
    def from_cells(cells, levels) -> "AreaTree":
        cells = np.asarray(cells, dtype=np.uint64).ravel()
        levels = np.broadcast_to(np.asarray(levels), cells.shape)
        sizes = _U1 << (np.uint64(6) * (np.uint64(M.MAX_LEVEL) - levels.astype(np.uint64)))
        return AreaTree.from_ranges(cells, cells + sizes)

    @property
    def is_empty(self) -> bool:
        return self.lo.size == 0

    def num_keys(self) -> int:
        return int(np.sum(self.hi - self.lo))

    def area_m2(self, lat_hint: float = 0.0) -> float:
        """Approximate ground area (m²); exact only near ``lat_hint``."""
        mpu = float(M.meters_per_unit_at(lat_hint))
        # One key = one level-10 cell = one (2^0)² block of the finest grid...
        # keys are spread over a 2^30×2^30 grid → each key covers one grid
        # cell of (METERS_PER_CELL·cos(lat))² only at level 10; a key range of
        # size s covers s cells of the finest grid.
        return self.num_keys() * mpu * mpu

    # ------------------------------------------------------------- set algebra
    def union(self, other: "AreaTree") -> "AreaTree":
        return AreaTree(*_merge_ranges(np.concatenate([self.lo, other.lo]),
                                       np.concatenate([self.hi, other.hi])))

    def intersect(self, other: "AreaTree") -> "AreaTree":
        a, b = self, other
        if a.is_empty or b.is_empty:
            return AreaTree.empty()
        # For every range in a, clip against b via searchsorted (vectorized
        # two-sided overlap): pair (i, j) overlaps iff a.lo < b.hi and b.lo < a.hi.
        lo_out, hi_out = [], []
        i = j = 0
        al, ah, bl, bh = a.lo, a.hi, b.lo, b.hi
        while i < al.size and j < bl.size:
            lo = max(al[i], bl[j])
            hi = min(ah[i], bh[j])
            if lo < hi:
                lo_out.append(lo)
                hi_out.append(hi)
            if ah[i] <= bh[j]:
                i += 1
            else:
                j += 1
        return AreaTree(np.array(lo_out, dtype=np.uint64),
                        np.array(hi_out, dtype=np.uint64))

    def difference(self, other: "AreaTree") -> "AreaTree":
        a, b = self, other
        if a.is_empty or b.is_empty:
            return AreaTree(a.lo.copy(), a.hi.copy())
        lo_out, hi_out = [], []
        j = 0
        for i in range(a.lo.size):
            cur = a.lo[i]
            end = a.hi[i]
            while j < b.lo.size and b.hi[j] <= cur:
                j += 1
            k = j
            while k < b.lo.size and b.lo[k] < end:
                if b.lo[k] > cur:
                    lo_out.append(cur)
                    hi_out.append(b.lo[k])
                cur = max(cur, b.hi[k])
                if cur >= end:
                    break
                k += 1
            if cur < end:
                lo_out.append(cur)
                hi_out.append(end)
        return AreaTree(np.array(lo_out, dtype=np.uint64),
                        np.array(hi_out, dtype=np.uint64))

    def intersects(self, other: "AreaTree") -> bool:
        return not self.intersect(other).is_empty

    # ------------------------------------------------------------- membership
    def contains(self, keys) -> np.ndarray:
        """Vectorized point membership for Morton ``keys`` → bool array."""
        keys = np.asarray(keys, dtype=np.uint64)
        if self.is_empty:
            return np.zeros(keys.shape, dtype=bool)
        idx = np.searchsorted(self.lo, keys, side="right") - 1
        ok = idx >= 0
        safe = np.where(ok, idx, 0)
        return ok & (keys < self.hi[safe])

    # ------------------------------------------------ canonical-cell views
    def to_cells(self) -> Tuple[np.ndarray, np.ndarray]:
        """Decompose into maximal canonical cells → (cell_ids, levels)."""
        cells, levels = [], []
        for lo, hi in zip(self.lo.tolist(), self.hi.tolist()):
            cur = lo
            while cur < hi:
                # Largest aligned block starting at cur that fits in [cur, hi).
                lev = M.MAX_LEVEL
                while lev > 0:
                    size = 1 << (6 * (M.MAX_LEVEL - lev + 1))
                    if cur % size == 0 and cur + size <= hi:
                        lev -= 1
                    else:
                        break
                size = 1 << (6 * (M.MAX_LEVEL - lev))
                cells.append(cur)
                levels.append(lev)
                cur += size
        return (np.array(cells, dtype=np.uint64),
                np.array(levels, dtype=np.int8))

    def node_masks(self, level: int):
        """Paper's 8×8 node form: {parent cell id at ``level-1`` → uint64 mask}.

        Bit *k* of the mask is set iff child *k* (the k-th 6-bit extension) is
        at least partially covered.  Used by tests for the bitset kernel and
        for interop with bitmap postings.
        """
        if level < 1:
            raise ValueError("level must be ≥ 1")
        shift = 6 * (M.MAX_LEVEL - level)
        parent_shift = 6 * (M.MAX_LEVEL - level + 1)
        masks: dict = {}
        for lo, hi in zip(self.lo.tolist(), self.hi.tolist()):
            c0 = lo >> shift                 # first covered child index
            c1 = (hi - 1) >> shift           # last covered child index
            for c in range(c0, c1 + 1):
                pidx = c >> 6                # parent index at level-1
                masks[pidx] = masks.get(pidx, 0) | (1 << (c & 63))
        return {np.uint64(p << parent_shift): np.uint64(m)
                for p, m in masks.items()}

    # ------------------------------------------------------------ convenience
    def __or__(self, o):
        return self.union(o)

    def __and__(self, o):
        return self.intersect(o)

    def __sub__(self, o):
        return self.difference(o)

    def __eq__(self, o):
        return (isinstance(o, AreaTree) and np.array_equal(self.lo, o.lo)
                and np.array_equal(self.hi, o.hi))

    # ------------------------------------------------------------ constructors
    @staticmethod
    def from_box(ix0: int, iy0: int, ix1: int, iy1: int,
                 max_level: int = 7) -> "AreaTree":
        """Cover the closed integer-Mercator rect [ix0,ix1]×[iy0,iy1]."""
        x0, x1 = sorted((int(ix0), int(ix1)))
        y0, y1 = sorted((int(iy0), int(iy1)))

        def classify(cx, cy, half):
            # cell box: [cx-half, cx+half) per axis
            lx, hx = cx - half, cx + half - 1
            ly, hy = cy - half, cy + half - 1
            outside = (hx < x0) | (lx > x1) | (hy < y0) | (ly > y1)
            inside = (lx >= x0) & (hx <= x1) & (ly >= y0) & (hy <= y1)
            return np.where(outside, OUT, np.where(inside, FULL, PARTIAL))

        return cover(classify, max_level)

    @staticmethod
    def from_circle(cx: int, cy: int, radius_units: float,
                    max_level: int = 7) -> "AreaTree":
        """Cover a circle (paper: point expanded by a confidence radius)."""
        cx, cy, r = float(cx), float(cy), float(radius_units)

        def classify(qx, qy, half):
            d = np.hypot(qx.astype(np.float64) - cx, qy.astype(np.float64) - cy)
            half_diag = half * np.sqrt(2.0)
            return np.where(d > r + half_diag, OUT,
                            np.where(d + half_diag <= r, FULL, PARTIAL))

        return cover(classify, max_level)

    @staticmethod
    def from_path(xs, ys, width_units: float, max_level: int = 7) -> "AreaTree":
        """Cover a polyline's envelope strip of half-width ``width_units``.

        This is the paper's probabilistic-path representation (Fig. 5/6): a
        curvilinear strip around the waypoints.  The cover is the union over
        per-segment capsules.
        """
        xs = np.asarray(xs, dtype=np.float64)
        ys = np.asarray(ys, dtype=np.float64)
        if xs.size == 1:
            return AreaTree.from_circle(xs[0], ys[0], width_units, max_level)
        ax, ay = xs[:-1], ys[:-1]
        bx, by = xs[1:], ys[1:]
        w = float(width_units)

        def classify(qx, qy, half):
            d = _point_segments_min_dist(qx.astype(np.float64),
                                         qy.astype(np.float64),
                                         ax, ay, bx, by)
            half_diag = half * np.sqrt(2.0)
            return np.where(d > w + half_diag, OUT,
                            np.where(d + half_diag <= w, FULL, PARTIAL))

        return cover(classify, max_level)

    @staticmethod
    def from_polygon(xs, ys, max_level: int = 7) -> "AreaTree":
        """Cover a simple polygon given integer-Mercator vertices."""
        xs = np.asarray(xs, dtype=np.float64)
        ys = np.asarray(ys, dtype=np.float64)
        ex0, ey0 = xs, ys
        ex1, ey1 = np.roll(xs, -1), np.roll(ys, -1)

        def classify(qx, qy, half):
            qx = qx.astype(np.float64)
            qy = qy.astype(np.float64)
            crosses = _segments_hit_boxes(ex0, ey0, ex1, ey1, qx, qy, half)
            center_in = _points_in_polygon(qx, qy, xs, ys)
            return np.where(crosses, PARTIAL, np.where(center_in, FULL, OUT))

        return cover(classify, max_level)


# --------------------------------------------------------------------------
# Recursive 64-way covering
# --------------------------------------------------------------------------

def cover(classify: Callable, max_level: int, *, conservative: bool = True
          ) -> AreaTree:
    """Build an area by 64-way refinement.

    ``classify(cx, cy, half)`` receives vectorized cell centers and half-edge
    (in integer-Mercator units, float) and returns OUT/PARTIAL/FULL per cell.
    PARTIAL cells at ``max_level`` are kept when ``conservative``.
    """
    if not 0 < max_level <= M.MAX_LEVEL:
        raise ValueError("max_level out of range")
    full_lo: list = []
    full_hi: list = []
    # Level-1 seed: the 64 children of the root.
    frontier = (np.arange(64, dtype=np.uint64)
                << np.uint64(6 * (M.MAX_LEVEL - 1)))
    level = 1
    while frontier.size:
        edge = np.uint64(1 << (30 - 3 * level))          # cell edge, units
        fx, fy = M.deinterleave(frontier)                 # min corner
        half = float(edge) / 2.0
        cx = fx.astype(np.float64) + half
        cy = fy.astype(np.float64) + half
        cls = np.asarray(classify(cx, cy, half))
        full = frontier[cls == FULL]
        if level == max_level and conservative:
            full = np.concatenate([full, frontier[cls == PARTIAL]])
        if full.size:
            size = _U1 << np.uint64(6 * (M.MAX_LEVEL - level))
            full_lo.append(full)
            full_hi.append(full + size)
        if level == max_level:
            break
        partial = frontier[cls == PARTIAL]
        if partial.size == 0:
            break
        child_shift = np.uint64(6 * (M.MAX_LEVEL - level - 1))
        kids = np.arange(64, dtype=np.uint64) << child_shift
        frontier = (partial[:, None] + kids[None, :]).ravel()
        level += 1
    if not full_lo:
        return AreaTree.empty()
    return AreaTree.from_ranges(np.concatenate(full_lo), np.concatenate(full_hi))


# --------------------------------------------------------------------------
# Vectorized geometry helpers (host-side numpy)
# --------------------------------------------------------------------------

def _point_segments_min_dist(qx, qy, ax, ay, bx, by):
    """Min distance from each query point to any segment (vectorized Q×S)."""
    dx = (bx - ax)[None, :]
    dy = (by - ay)[None, :]
    px = qx[:, None] - ax[None, :]
    py = qy[:, None] - ay[None, :]
    seg_len2 = np.maximum(dx * dx + dy * dy, 1e-12)
    t = np.clip((px * dx + py * dy) / seg_len2, 0.0, 1.0)
    ex = px - t * dx
    ey = py - t * dy
    return np.sqrt(ex * ex + ey * ey).min(axis=1)


def _points_in_polygon(qx, qy, vx, vy):
    """Ray-casting point-in-polygon, vectorized over query points."""
    inside = np.zeros(qx.shape, dtype=bool)
    n = vx.size
    j = n - 1
    for i in range(n):
        cond = ((vy[i] > qy) != (vy[j] > qy))
        # An edge only crosses the ray where `cond` holds, and there
        # |qy − vy[i]| < |denom|, so the quotient is bounded by the edge's
        # x-extent.  Degenerate/near-horizontal edges (cond all-False)
        # divide by the placeholder 1.0 instead — no overflow, result
        # masked out either way.
        denom = vy[j] - vy[i]
        xin = (vx[j] - vx[i]) * np.where(cond, qy - vy[i], 0.0) \
            / np.where(cond, denom, 1.0) + vx[i]
        inside ^= cond & (qx < xin)
        j = i
    return inside


def _segments_hit_boxes(ax, ay, bx, by, cx, cy, half):
    """Does any segment intersect each axis-aligned box? (slab test, Q×S)."""
    x0 = (cx - half)[:, None]
    x1 = (cx + half)[:, None]
    y0 = (cy - half)[:, None]
    y1 = (cy + half)[:, None]
    dx = (bx - ax)[None, :]
    dy = (by - ay)[None, :]
    axb = ax[None, :]
    ayb = ay[None, :]
    eps = 1e-12
    dxs = np.where(np.abs(dx) < eps, eps, dx)
    dys = np.where(np.abs(dy) < eps, eps, dy)
    tx1 = (x0 - axb) / dxs
    tx2 = (x1 - axb) / dxs
    ty1 = (y0 - ayb) / dys
    ty2 = (y1 - ayb) / dys
    tmin = np.maximum(np.minimum(tx1, tx2), np.minimum(ty1, ty2))
    tmax = np.minimum(np.maximum(tx1, tx2), np.maximum(ty1, ty2))
    # Degenerate axes: segment parallel to a slab → require inside that slab.
    para_x = np.abs(dx) < eps
    para_y = np.abs(dy) < eps
    in_x = (axb >= x0) & (axb <= x1)
    in_y = (ayb >= y0) & (ayb <= y1)
    hit = (tmax >= np.maximum(tmin, 0.0)) & (tmin <= 1.0)
    hit = np.where(para_x & ~in_x, False, hit)
    hit = np.where(para_y & ~in_y, False, hit)
    return hit.any(axis=1)
