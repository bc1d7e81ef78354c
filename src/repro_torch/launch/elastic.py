"""Elastic scaling: restart a job on a different mesh from checkpoints,
and elastic recovery on the partition axis of query execution.

The port of ``repro/launch/elastic.py``.  Checkpoints are mesh-agnostic
(one host npz + manifest), and ``restore_checkpoint(shardings=)``
re-places leaves with the *target* placements, so a train state saved on
mesh A restores bit-exactly onto mesh B (``launch.train --resume``).
:func:`reshard_plan` summarizes what such a move changes (per-device
parameter bytes before/after, from the sharding rules' specs).
:func:`reroute_partitions` is host code, copied from the reference.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

__all__ = ["reshard_plan", "reroute_partitions", "per_device_bytes"]


def per_device_bytes(shapes, specs, mesh) -> int:
    """Bytes one device holds of a tree of (meta) tensors laid out by a
    tree of specs on ``mesh``: each leaf's bytes over the number of
    pieces its spec cuts it into."""
    from ..ml.sharding import leaf_items, spec_divisor
    total = 0.0
    for (_, leaf), (_, spec) in zip(leaf_items(shapes), leaf_items(specs)):
        total += leaf.numel() * leaf.element_size() / \
            max(spec_divisor(spec, mesh), 1)
    return int(total)


def reshard_plan(mb_from, mb_to) -> Dict:
    """Summarize a topology move of the same architecture between two
    ``ModelBundle``s (each on a ``DeviceMesh`` or a ``MeshShape``)."""
    from ..ml.sharding import mesh_sizes
    shape = mb_from.params_shape()
    before = per_device_bytes(shape, mb_from.param_specs(shape),
                              mb_from.mesh)
    after = per_device_bytes(shape, mb_to.param_specs(shape), mb_to.mesh)
    return {
        "from_mesh": mesh_sizes(mb_from.mesh),
        "to_mesh": mesh_sizes(mb_to.mesh),
        "param_bytes_per_device_before": before,
        "param_bytes_per_device_after": after,
        "ratio": after / max(before, 1),
    }


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
