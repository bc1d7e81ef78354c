"""Per-group (count, sum, sum of squares) partial aggregation.

The wrapper of ``csrc/segment_agg.cu``, the port of the TPU kernel
``repro/kernels/segment_agg.py`` ``segment_agg``.  CUDA tensors launch the
kernels, which take float32 values (the staging the backend uses on the
card) and accumulate in float64; CPU tensors run the plain version
(``ref.segment_agg_ref``, float64 in row order).  Rows whose group id is
< 0 or >= ``num_groups`` are dropped, as in the JAX package.

The outputs are three views of one buffer (:func:`alloc_outputs`).  Up to
``SHARED_MAX_GROUPS`` groups, ``repro_segment_agg_shared`` runs two
launches: per-block partials into scratch (the same buffer's slabs after
the outputs', kept alive by the views), then a fixed-order combine that
writes every output — no memset, no global atomics, the same bits from
every call.  Above it, ``repro_segment_agg_global`` zero-fills the buffer
and adds with float64 atomics in one pass over the rows, both in one
cooperative launch.

Tolerance: counts are exact.  A sum differs from a row-order float64 sum
of the same float32 values by float64 rounding in another order only
(relative ~N·2^-53); against the numpy oracle's float64 values the
float32 staging dominates (relative 2^-24 per value, so ~1e-7 on a sum of
same-sign values).
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["segment_agg", "alloc_outputs", "slab_doubles", "shared_blocks",
           "SHARED_MAX_GROUPS"]

#: the shared branch's largest group count (``kSharedMaxGroups`` in
#: ``csrc/segment_agg.cu``)
SHARED_MAX_GROUPS = 2048
#: the shared branch's pass 1: rows a block at least (one 128-row step for
#: each of its 8 warps), at most 2 blocks an SM of the H100's 132, and its
#: partials (one slab a block) kept under SCRATCH_BYTES
ROWS_PER_BLOCK = 1024
MAX_BLOCKS = 2 * 132
SCRATCH_BYTES = 4 << 20
_INT32_ROWS = 1 << 31


def slab_doubles(num_groups: int) -> int:
    """Doubles in one [3, G] slab: sum, sum of squares, then G int32
    counts (two to a double)."""
    return 2 * num_groups + (num_groups + 1) // 2


def alloc_outputs(num_groups: int, device, zero: bool = False,
                  slabs: int = 1):
    """One float64 buffer of ``slabs`` [3, G] slabs (:func:`slab_doubles`)
    and views of its first: (count [G] int32, sum [G] float64, sumsq [G]
    float64).  The float64 planes start at doubles 0 and G (8-byte
    aligned); the counts follow them."""
    g = num_groups
    buf = (torch.zeros if zero else torch.empty)(
        (slabs * slab_doubles(g),), dtype=torch.float64, device=device)
    return buf.view(torch.int32)[4 * g:5 * g], buf[:g], buf[g:2 * g]


def shared_blocks(n: int, num_groups: int) -> int:
    """Pass 1's blocks for ``n`` rows of ``num_groups`` groups."""
    cap = max(1, SCRATCH_BYTES // (8 * slab_doubles(num_groups)))
    return max(1, min(-(-n // ROWS_PER_BLOCK), MAX_BLOCKS, cap))


def segment_agg(group_ids: torch.Tensor, values: torch.Tensor,
                num_groups: int):
    """group_ids [N] int32 (rows with ids < 0 or >= ``num_groups`` dropped),
    values [N] float → (count [G] int32, sum [G] float64, sumsq [G]
    float64)."""
    _build.require(group_ids, "group_ids", torch.int32, 1)
    if not isinstance(values, torch.Tensor) or not values.is_floating_point() \
            or values.shape != group_ids.shape:
        raise ValueError("values: expected a float tensor shaped like "
                         "group_ids")
    if values.device != group_ids.device:
        raise ValueError("group_ids and values lie on different devices")
    if group_ids.is_cpu:
        return _ref.segment_agg_ref(group_ids, values, num_groups)
    _build.require(values, "values", torch.float32, 1)
    dev = group_ids.device
    n = int(group_ids.shape[0])
    if n >= _INT32_ROWS:
        raise ValueError(f"segment_agg: the kernels take < 2^31 rows, got "
                         f"{n}")
    if not (n and num_groups):
        return alloc_outputs(num_groups, dev, zero=True)
    # s starts the buffer: its pointer is the kernels' ``out``
    if num_groups <= SHARED_MAX_GROUPS:
        blocks = shared_blocks(n, num_groups)
        cnt, s, s2 = alloc_outputs(num_groups, dev, slabs=1 + blocks)
        _build.launch("segment_agg", "repro_segment_agg_shared", dev,
                      group_ids, values, n, num_groups, s, blocks)
    else:
        cnt, s, s2 = alloc_outputs(num_groups, dev)
        _build.launch("segment_agg", "repro_segment_agg_global", dev,
                      group_ids, values, n, num_groups, s)
    return cnt, s, s2
