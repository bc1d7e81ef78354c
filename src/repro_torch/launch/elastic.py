"""Elastic recovery on the partition axis of query execution.

:func:`reroute_partitions` is host code, copied from the JAX package's
``launch/elastic.py``.  Its ``reshard_plan`` (a train state's topology
move) needs ``ModelBundle`` and comes with the checkpoint and train
launcher (ROADMAP A12).
"""
from __future__ import annotations

from typing import List, Sequence

__all__ = ["reroute_partitions"]


def reroute_partitions(parts: List[List[int]],
                       failed: Sequence[int]) -> List[List[int]]:
    """Partition-axis fault recovery for query execution.

    A partition that trips its FaultPlan check is drained and its shards
    are rerouted round-robin across the surviving partitions — the query
    still covers every shard, just on fewer devices (the engines re-sort
    partials by shard id before merging, so results are unchanged).  The
    partition count is preserved (failed slots become empty) so launch
    accounting stays per-slot.  With no survivors the original assignment
    is returned and the per-shard retry machinery takes over.
    """
    failed_set = {int(i) for i in failed}
    survivors = [i for i in range(len(parts)) if i not in failed_set]
    if not survivors:
        return [list(p) for p in parts]
    out: List[List[int]] = [list(p) if i in survivors else []
                            for i, p in enumerate(parts)]
    orphans = [sid for i in sorted(failed_set) if 0 <= i < len(parts)
               for sid in parts[i]]
    for j, sid in enumerate(orphans):
        out[survivors[j % len(survivors)]].append(sid)
    return out
