"""Per-group (count, sum, sum of squares) partial aggregation.

The wrapper of ``csrc/segment_agg.cu`` (``repro_segment_agg``), the port
of the TPU kernel ``repro/kernels/segment_agg.py`` ``segment_agg``.  CUDA
tensors launch the kernel, which takes float32 values (the staging the
backend uses on the card) and accumulates in float64 with atomics; CPU
tensors run the plain version (``ref.segment_agg_ref``, float64 in row
order).

Tolerance: counts are exact.  On the card the float64 atomics add in no
fixed order, so a sum differs from a row-order float64 sum of the same
float32 values by float64 rounding only (relative ~N·2^-53); against the
numpy oracle's float64 values the float32 staging dominates (relative
2^-24 per value, so ~1e-7 on a sum of same-sign values).
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["segment_agg"]


def segment_agg(group_ids: torch.Tensor, values: torch.Tensor,
                num_groups: int):
    """group_ids [N] int32 (< 0 masked out), values [N] float →
    (count [G] int32, sum [G] float64, sumsq [G] float64)."""
    _build.require(group_ids, "group_ids", torch.int32, 1)
    if not isinstance(values, torch.Tensor) or not values.is_floating_point() \
            or values.shape != group_ids.shape:
        raise ValueError("values: expected a float tensor shaped like "
                         "group_ids")
    if values.device != group_ids.device:
        raise ValueError("group_ids and values lie on different devices")
    if group_ids.device.type == "cpu":
        return _ref.segment_agg_ref(group_ids, values, num_groups)
    _build.require(values, "values", torch.float32, 1)
    dev = group_ids.device
    n = int(group_ids.shape[0])
    if not (n and num_groups):
        return (torch.zeros((num_groups,), dtype=torch.int32, device=dev),
                torch.zeros((num_groups,), dtype=torch.float64, device=dev),
                torch.zeros((num_groups,), dtype=torch.float64, device=dev))
    cnt = torch.empty((num_groups,), dtype=torch.int32, device=dev)
    s = torch.empty((num_groups,), dtype=torch.float64, device=dev)
    s2 = torch.empty((num_groups,), dtype=torch.float64, device=dev)
    _build.launch("segment_agg", "segment_agg", "repro_segment_agg", dev,
                  group_ids, values, n, num_groups, cnt, s, s2)
    return cnt, s, s2
