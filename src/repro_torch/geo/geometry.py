"""Geospatial toolkit (paper §4.2.2: distance estimation, projections, …).

The port of ``repro/geo/geometry.py``: the host-side numpy utilities,
copied, plus the device variant of the distance as a torch function
(:func:`mercator_dist_m_torch`, the reference's ``mercator_dist_m_jnp``).
Device-side geometry works in integer-Mercator space with float32 deltas
around shard-local origins, as the reference's does.
"""
from __future__ import annotations

import numpy as np
import torch

from . import mercator as M

EARTH_RADIUS_M = 6_371_008.8

__all__ = [
    "haversine_m", "polyline_length_m", "mercator_dist_m",
    "point_segment_dist", "bbox_of", "Box", "mercator_dist_m_torch",
]


class Box:
    """Closed integer-Mercator bounding box."""

    __slots__ = ("x0", "y0", "x1", "y1")

    def __init__(self, x0: int, y0: int, x1: int, y1: int):
        self.x0, self.x1 = sorted((int(x0), int(x1)))
        self.y0, self.y1 = sorted((int(y0), int(y1)))

    @staticmethod
    def from_latlng(lat0, lng0, lat1, lng1) -> "Box":
        ix, iy = M.latlng_to_xy(np.array([lat0, lat1]), np.array([lng0, lng1]))
        return Box(int(ix[0]), int(iy[0]), int(ix[1]), int(iy[1]))

    def contains(self, ix, iy):
        ix = np.asarray(ix)
        iy = np.asarray(iy)
        return ((ix >= self.x0) & (ix <= self.x1)
                & (iy >= self.y0) & (iy <= self.y1))

    def center(self):
        return (self.x0 + self.x1) // 2, (self.y0 + self.y1) // 2

    def __repr__(self):
        return f"Box({self.x0},{self.y0},{self.x1},{self.y1})"


def haversine_m(lat0, lng0, lat1, lng1):
    """Great-circle distance in meters (vectorized, numpy)."""
    lat0, lng0, lat1, lng1 = (np.radians(np.asarray(a, dtype=np.float64))
                              for a in (lat0, lng0, lat1, lng1))
    dlat = lat1 - lat0
    dlng = lng1 - lng0
    h = (np.sin(dlat / 2.0) ** 2
         + np.cos(lat0) * np.cos(lat1) * np.sin(dlng / 2.0) ** 2)
    return 2.0 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(h, 0.0, 1.0)))


def mercator_dist_m(ix0, iy0, ix1, iy1):
    """Euclidean distance in ground meters between integer-Mercator points.

    Uses the local Mercator scale at the midpoint latitude — accurate to
    well under 1% for distances up to tens of km (the paper's use cases).
    """
    ix0 = np.asarray(ix0, dtype=np.float64)
    iy0 = np.asarray(iy0, dtype=np.float64)
    ix1 = np.asarray(ix1, dtype=np.float64)
    iy1 = np.asarray(iy1, dtype=np.float64)
    mid_lat, _ = M.xy_to_latlng((ix0 + ix1) / 2, (iy0 + iy1) / 2)
    mpu = M.meters_per_unit_at(mid_lat)
    return np.hypot(ix1 - ix0, iy1 - iy0) * mpu


def mercator_dist_m_torch(ix0, iy0, ix1, iy1, meters_per_unit):
    """Device-side distance over tensors (the deltas taken in the inputs'
    dtype, then float32): caller supplies the local Mercator scale."""
    dx = (ix1 - ix0).to(torch.float32)
    dy = (iy1 - iy0).to(torch.float32)
    return torch.sqrt(dx * dx + dy * dy) * meters_per_unit


def polyline_length_m(xs, ys):
    """Ground length of a polyline given integer-Mercator vertices."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    if xs.size < 2:
        return 0.0
    return float(np.sum(mercator_dist_m(xs[:-1], ys[:-1], xs[1:], ys[1:])))


def point_segment_dist(px, py, ax, ay, bx, by):
    """Distance (in input units) from points to segments, broadcast."""
    px = np.asarray(px, dtype=np.float64)
    py = np.asarray(py, dtype=np.float64)
    dx = np.asarray(bx, dtype=np.float64) - ax
    dy = np.asarray(by, dtype=np.float64) - ay
    seg2 = np.maximum(dx * dx + dy * dy, 1e-12)
    t = np.clip(((px - ax) * dx + (py - ay) * dy) / seg2, 0.0, 1.0)
    ex = px - (ax + t * dx)
    ey = py - (ay + t * dy)
    return np.hypot(ex, ey)


def bbox_of(xs, ys) -> Box:
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    return Box(int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max()))
