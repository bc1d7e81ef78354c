"""Cross-partition merge of segment-aggregate states (the Mixer combine).

One query executed over P partitions produces per-shard segment states —
for each value slot a ``(count, sum, sum_sq[, min, max])`` vector over
that shard's group key space.  The backend aligns them to the sorted
union key space on the host; this module combines the aligned
``[S, K, G]`` stacks on their device in one logical dispatch:

* counts / sums / sums-of-squares accumulate **sequentially in states
  order** — an explicit ``acc = acc + x[i]`` from zeros, float64 (int64
  counts) — so the result is bit-equal to the numpy loop-over-partitions
  oracle and to the P=1 sequential merge.  Absent groups contribute the
  additive identity 0, which changes no bits.  A ``sum(dim=0)`` or
  ``cumsum`` promises no order, so neither is used;
* min / max planes reduce element-wise against ±inf identities;
* per-group presence masks OR.

The JAX package (``repro/kernels/merge.py``) runs the same in-order loop
under ``shard_map`` over a ``"part"`` mesh and combines the per-device
subtotals with ``psum`` / ``pmin`` / ``pmax``: on a real multi-device
mesh its float sums become per-device subtotals added in a tree, so they
lose the exact P=1 order.  Here the partitions' waves run on their own
cards, but their states come back to the host, and the backend stacks
them and calls this once on the first card of the exec mesh
(``TorchBackend.merge_partials``): no cross-card reduction, so the whole
loop keeps the exact order.  The reference lowers this to plain jnp (no
Pallas kernel), so it is plain PyTorch here as well.
"""
from __future__ import annotations

import torch

__all__ = ["merge_partials"]


def merge_partials(cnt, s, s2, mn, mx, msk):
    """Combine aligned segment-state stacks.

    ``cnt`` is ``[S, K, G]`` int64, ``s/s2/mn/mx`` ``[S, K, G]`` float64
    and ``msk`` ``[S, G]`` bool, all on one device.  Returns
    ``(cnt, s, s2, mn, mx, msk)`` with the leading states axis reduced."""
    cnt = cnt.to(torch.int64)
    s, s2 = s.to(torch.float64), s2.to(torch.float64)
    mn, mx = mn.to(torch.float64), mx.to(torch.float64)
    msk = msk.to(torch.bool)
    c = torch.zeros_like(cnt[0])
    a = torch.zeros_like(s[0])
    a2 = torch.zeros_like(s2[0])
    lo = torch.full_like(mn[0], float("inf"))
    hi = torch.full_like(mx[0], float("-inf"))
    m = torch.zeros_like(msk[0])
    for i in range(cnt.shape[0]):            # in states order
        c = c + cnt[i]
        a = a + s[i]
        a2 = a2 + s2[i]
        lo = torch.minimum(lo, mn[i])
        hi = torch.maximum(hi, mx[i])
        m = m | msk[i]
    return c, a, a2, lo, hi, m
