"""Integer spherical-Mercator projection (paper §4.1.2 ``location`` index).

The paper stores locations as an integer representation of the Mercator
projection with "a precision of several centimeters".  We use a 30-bit grid
per axis: the Earth's Mercator square is divided into 2^30 × 2^30 cells,
giving a cell edge of 40075 km / 2^30 ≈ 3.7 cm at the equator.

Latitudes above 85.05°N / below 85.05°S are not representable (paper: "not
indexable without some translation"); they are clamped by default and can be
made to raise instead.

Morton (Z-order) keys interleave the two 30-bit coordinates into a 60-bit
key.  Six bits per level (3 x-bits + 3 y-bits) make a Morton prefix exactly
an *area-tree* cell (8×8 split per node — paper §4.1.2 ``area``), so one key
space serves both the location index and the area index.
"""
from __future__ import annotations

import numpy as np

MAX_LEVEL = 10                  # 6 bits/level * 10 levels = 60-bit Morton keys
BITS_PER_AXIS = 3 * MAX_LEVEL   # 30
GRID = np.uint64(1) << np.uint64(BITS_PER_AXIS)          # 2**30 cells/axis
EARTH_CIRCUMFERENCE_M = 40_075_016.686                    # equatorial, meters
METERS_PER_CELL = EARTH_CIRCUMFERENCE_M / float(GRID)     # ≈ 0.0373 m
MAX_MERCATOR_LAT = 85.05112877980659                      # atan(sinh(pi))

__all__ = [
    "MAX_LEVEL", "BITS_PER_AXIS", "GRID", "METERS_PER_CELL", "MAX_MERCATOR_LAT",
    "latlng_to_xy", "xy_to_latlng", "interleave", "deinterleave",
    "latlng_to_morton", "morton_to_latlng", "cell_of", "cell_range",
    "meters_per_unit_at", "EARTH_CIRCUMFERENCE_M",
]


def latlng_to_xy(lat, lng, *, clamp: bool = True):
    """Project (lat, lng) degrees → integer Mercator (ix, iy), vectorized.

    Returns uint64 arrays in [0, 2^30).  ``iy`` grows *southwards* (standard
    web-Mercator tile convention).
    """
    lat = np.asarray(lat, dtype=np.float64)
    lng = np.asarray(lng, dtype=np.float64)
    if clamp:
        lat = np.clip(lat, -MAX_MERCATOR_LAT, MAX_MERCATOR_LAT)
    elif np.any(np.abs(lat) > MAX_MERCATOR_LAT):
        raise ValueError("latitude outside Mercator-indexable range (±85.05°)")
    x = (lng / 360.0 + 0.5) % 1.0
    lat_r = np.radians(lat)
    y = 0.5 - np.log(np.tan(lat_r) + 1.0 / np.cos(lat_r)) / (2.0 * np.pi)
    n = float(GRID)
    ix = np.minimum((x * n).astype(np.uint64), GRID - np.uint64(1))
    iy = np.minimum(np.maximum(y, 0.0) * n, n - 1).astype(np.uint64)
    return ix, iy


def xy_to_latlng(ix, iy):
    """Inverse projection: integer Mercator cell *centers* → (lat, lng) degrees."""
    n = float(GRID)
    x = (np.asarray(ix, dtype=np.float64) + 0.5) / n
    y = (np.asarray(iy, dtype=np.float64) + 0.5) / n
    lng = (x - 0.5) * 360.0
    lat = np.degrees(np.arctan(np.sinh((0.5 - y) * 2.0 * np.pi)))
    return lat, lng


def _spread3(v: np.ndarray) -> np.ndarray:
    """Spread the low 30 bits of v so bit i lands at position 2*i (uint64)."""
    v = v.astype(np.uint64)
    v = (v | (v << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v << np.uint64(2))) & np.uint64(0x3333333333333333)
    v = (v | (v << np.uint64(1))) & np.uint64(0x5555555555555555)
    return v


def _unspread3(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64) & np.uint64(0x5555555555555555)
    v = (v | (v >> np.uint64(1))) & np.uint64(0x3333333333333333)
    v = (v | (v >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return v


def interleave(ix, iy) -> np.ndarray:
    """Morton-interleave two 30-bit coords → 60-bit key (x in even bits)."""
    return _spread3(np.asarray(ix)) | (_spread3(np.asarray(iy)) << np.uint64(1))


def deinterleave(key):
    key = np.asarray(key, dtype=np.uint64)
    return _unspread3(key), _unspread3(key >> np.uint64(1))


def latlng_to_morton(lat, lng, *, clamp: bool = True) -> np.ndarray:
    ix, iy = latlng_to_xy(lat, lng, clamp=clamp)
    return interleave(ix, iy)


def morton_to_latlng(key):
    ix, iy = deinterleave(key)
    return xy_to_latlng(ix, iy)


def cell_of(key, level: int) -> np.ndarray:
    """Area-tree cell id containing ``key`` at ``level`` (Morton prefix).

    A level-``l`` cell is identified by its 6*l-bit Morton prefix, left-aligned
    in the 60-bit key space (so cell ids at any level sort in Morton order).
    """
    if not 0 <= level <= MAX_LEVEL:
        raise ValueError(f"level must be in [0, {MAX_LEVEL}]")
    shift = np.uint64(6 * (MAX_LEVEL - level))
    return (np.asarray(key, dtype=np.uint64) >> shift) << shift


def cell_range(cell, level: int):
    """[lo, hi) Morton-key range covered by a level-``level`` cell id."""
    shift = np.uint64(6 * (MAX_LEVEL - level))
    lo = np.asarray(cell, dtype=np.uint64)
    return lo, lo + (np.uint64(1) << shift)


def meters_per_unit_at(lat) -> np.ndarray:
    """Ground meters per integer-Mercator unit at a given latitude.

    Mercator stretches by 1/cos(lat); ground distance shrinks accordingly.
    """
    return METERS_PER_CELL * np.cos(np.radians(np.asarray(lat, dtype=np.float64)))
