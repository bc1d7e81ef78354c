"""Advanced analysis structures (paper §4.2.2).

WFL "provides advanced structures such as HyperLogLog sketches for
cardinality estimation of big data, Bloom filters for membership tests, and
interval trees for windowing queries."  All three are mergeable across
shards, which is what makes them usable as distributed aggregates: servers
build partials, the Mixer merges.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field as dc_field
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["splitmix64", "hash_values", "hll_register_rows", "HyperLogLog",
           "BloomFilter", "IntervalSet"]

_U = np.uint64


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 — the workhorse 64-bit mixer."""
    x = np.asarray(x).astype(np.uint64)
    x = (x + _U(0x9E3779B97F4A7C15))
    x = (x ^ (x >> _U(30))) * _U(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U(27))) * _U(0x94D049BB133111EB)
    return x ^ (x >> _U(31))


def hash_values(values, vocab: Optional[Sequence[str]] = None) -> np.ndarray:
    """64-bit hashes for a column: ints are mixed; string codes hash their
    vocab entry (stable across shards, unlike per-shard codes)."""
    values = np.asarray(values)
    if vocab is not None:
        vh = np.array([int.from_bytes(
            hashlib.blake2b(s.encode(), digest_size=8).digest(), "little")
            for s in vocab], dtype=np.uint64)
        return vh[values]
    if values.dtype.kind == "f":
        values = values.view(np.uint64 if values.dtype.itemsize == 8
                             else np.uint32)
    return splitmix64(values)


# --------------------------------------------------------------------------
# HyperLogLog (Flajolet et al. 2007), dense registers, mergeable.
# --------------------------------------------------------------------------

def hll_register_rows(h: np.ndarray, p: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-hash HLL register updates: 64-bit hashes → (register index
    [n] int64, rank [n] uint8).  A sketch is the per-register **max** of
    these rows (zero = empty register), which is what lets grouped sketch
    building run as one segment-max through the execution backend —
    commutative and idempotent, hence partition- and order-invariant."""
    h = np.asarray(h, dtype=np.uint64)
    idx = (h >> _U(64 - p)).astype(np.int64)
    rest = (h << _U(p)) | _U((1 << p) - 1)
    # rank = leading zeros of the remaining 64-p bits, +1
    lz = np.zeros(h.shape, dtype=np.uint8)
    cur = rest.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        mask = cur < (_U(1) << _U(64 - shift))
        lz = np.where(mask, lz + shift, lz)
        cur = np.where(mask, cur << _U(shift), cur)
    rank = np.minimum(lz + 1, 64 - p + 1).astype(np.uint8)
    return idx, rank


@dataclass
class HyperLogLog:
    p: int = 12
    registers: np.ndarray = None  # uint8 [2^p]

    def __post_init__(self):
        if self.registers is None:
            self.registers = np.zeros(1 << self.p, dtype=np.uint8)

    def add_hashes(self, h: np.ndarray) -> "HyperLogLog":
        idx, rank = hll_register_rows(h, self.p)
        np.maximum.at(self.registers, idx, rank)
        return self

    def add(self, values, vocab=None) -> "HyperLogLog":
        return self.add_hashes(hash_values(values, vocab))

    def merge(self, other: "HyperLogLog") -> "HyperLogLog":
        assert self.p == other.p
        np.maximum(self.registers, other.registers, out=self.registers)
        return self

    def estimate(self) -> float:
        m = float(1 << self.p)
        alpha = 0.7213 / (1.0 + 1.079 / m)
        inv = np.ldexp(1.0, -self.registers.astype(np.int64))
        e = alpha * m * m / inv.sum()
        zeros = int((self.registers == 0).sum())
        if e <= 2.5 * m and zeros:
            return m * np.log(m / zeros)     # linear counting
        return float(e)


# --------------------------------------------------------------------------
# Bloom filter (Bloom 1970), double hashing, mergeable.
# --------------------------------------------------------------------------

@dataclass
class BloomFilter:
    num_bits: int = 1 << 16
    num_hashes: int = 5
    bits: np.ndarray = None    # uint32 words

    def __post_init__(self):
        if self.bits is None:
            self.bits = np.zeros((self.num_bits + 31) // 32, dtype=np.uint32)

    def _positions(self, h: np.ndarray) -> np.ndarray:
        h1 = h & _U(0xFFFFFFFF)
        h2 = h >> _U(32)
        ks = np.arange(self.num_hashes, dtype=np.uint64)
        return ((h1[:, None] + ks[None, :] * h2[:, None])
                % _U(self.num_bits)).astype(np.int64)

    def add(self, values, vocab=None) -> "BloomFilter":
        pos = self._positions(hash_values(values, vocab)).ravel()
        np.bitwise_or.at(self.bits, pos >> 5,
                         np.uint32(1) << (pos & 31).astype(np.uint32))
        return self

    def contains(self, values, vocab=None) -> np.ndarray:
        pos = self._positions(hash_values(values, vocab))
        word = self.bits[pos >> 5]
        bit = (word >> (pos & 31).astype(np.uint32)) & np.uint32(1)
        return bit.astype(bool).all(axis=1)

    def merge(self, other: "BloomFilter") -> "BloomFilter":
        assert self.num_bits == other.num_bits
        np.bitwise_or(self.bits, other.bits, out=self.bits)
        return self


# --------------------------------------------------------------------------
# Interval set for windowing queries (CLRS interval trees, vectorized form).
# --------------------------------------------------------------------------

class IntervalSet:
    """Static interval collection with stabbing/overlap queries.

    Stored sorted by start with an augmented running-max of ends — the flat
    (cache-friendly) equivalent of a CLRS interval tree.  ``overlapping``
    returns, for each query window, whether any interval overlaps it;
    ``count_overlaps`` returns how many (via offset counting:
    #overlaps = #starts ≤ q_end − #ends < q_start).
    """

    def __init__(self, starts, ends):
        starts = np.asarray(starts, dtype=np.float64)
        ends = np.asarray(ends, dtype=np.float64)
        if np.any(ends < starts):
            raise ValueError("interval with end < start")
        order = np.argsort(starts, kind="stable")
        self.starts = starts[order]
        self.ends = ends[order]
        self.sorted_ends = np.sort(ends)
        self.max_end_prefix = (np.maximum.accumulate(self.ends)
                               if len(self.ends) else self.ends)

    def __len__(self):
        return self.starts.size

    def count_overlaps(self, q_start, q_end) -> np.ndarray:
        q_start = np.asarray(q_start, dtype=np.float64)
        q_end = np.asarray(q_end, dtype=np.float64)
        n_start_le = np.searchsorted(self.starts, q_end, side="right")
        n_end_lt = np.searchsorted(self.sorted_ends, q_start, side="left")
        return (n_start_le - n_end_lt).astype(np.int64)

    def overlapping(self, q_start, q_end) -> np.ndarray:
        return self.count_overlaps(q_start, q_end) > 0

    def stab(self, q) -> np.ndarray:
        return self.overlapping(q, q)
