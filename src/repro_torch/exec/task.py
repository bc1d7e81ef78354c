"""The per-shard server task, shared by Warp:AdHoc and Warp:Flume.

This is the unit of distribution and the unit of failure: index probe →
exact track refine (Tesseract constraints, behind the backend's
``refine_tracks`` op) → selective column read → residual filter →
record-parallel ops → (aggregate_produce | pre-sorted batch).  Both
engines schedule it; they differ only in what happens when it fails or
lags (§4.3.5 vs §4.3.6).

Healthy shards normally run through the *fused* wave path instead
(``run_wave_task`` → ``backend.run_wave_fused``, one dispatch per wave);
this per-shard task remains the retry/recovery unit and the per-primitive
oracle the fused results are parity-tested against.  The index probe here
goes through ``probe_shard``, which also lowers the spacetime postings OR
behind the backend seam (``postings_bitmap``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..core.exprs import CollectedTable
from ..core.flow import AggregateOp, LimitOp, SortOp
from ..core.planner import Plan, probe_shard
from ..fdb.columnar import ColumnBatch
from ..fdb.fdb import FDb
from ..fdb.index import mask_from_bitmap
from .backend import as_backend
from .failures import FaultPlan
from .processors import (AggPartial, aggregate_produce, apply_filter,
                         apply_limit, apply_sort, run_record_ops)

__all__ = ["ShardPartial", "run_shard_task"]


@dataclass
class ShardPartial:
    shard_id: int = -1
    batch: Optional[ColumnBatch] = None
    agg: Optional[AggPartial] = None
    rows_scanned: int = 0
    rows_selected: int = 0
    bytes_read: int = 0
    cpu_ms: float = 0.0
    io_ms: float = 0.0
    #: raw fused segment-aggregate state ``(uniq_keys, slots)`` for the
    #: partition layer's ``merge_partials`` combine; only the fused
    #: gather-free agg path fills it (``None`` elsewhere, including the
    #: per-shard retry path — the engines then fall back to the host
    #: AggPartial merge, which is partition-invariant by construction).
    seg: Optional[tuple] = None


def run_shard_task(db: FDb, plan: Plan, shard_id: int,
                   tables: Optional[Dict[int, CollectedTable]],
                   catalog, fault_plan: Optional[FaultPlan] = None,
                   stage: str = "server", backend=None) -> ShardPartial:
    if fault_plan is not None:
        fault_plan.check(stage, shard_id)
    backend = as_backend(backend)
    t0 = time.perf_counter()
    shard = db.shards[shard_id]
    bm = probe_shard(shard, plan.probes, backend)
    if plan.refines:
        mask = mask_from_bitmap(bm, shard.n)
        n_cand = int(mask.sum())
        for rf in plan.refines:
            mask = backend.refine_tracks(shard.batch, rf.path,
                                         rf.constraints, mask,
                                         edges=rf.edges,
                                         min_counts=rf.min_counts,
                                         dwells=rf.dwells)
        ids = backend.compact_mask(mask)
    else:
        ids = backend.select_ids(bm, shard.n)
        n_cand = len(ids)
    t1 = time.perf_counter()
    paths = [p for p in plan.source_paths if p in shard.batch.columns]
    if not paths:
        paths = shard.batch.paths()
    batch = shard.batch.select_paths(paths).gather(ids)
    t2 = time.perf_counter()
    out = ShardPartial(shard_id=shard_id, rows_scanned=shard.n,
                       rows_selected=n_cand, bytes_read=batch.nbytes(),
                       io_ms=(t2 - t1) * 1e3)
    if plan.residual is not None:
        batch = apply_filter(batch, plan.residual, backend)
    batch = run_record_ops(batch, plan.server_ops, catalog, tables,
                           backend=backend)
    if plan.mixer_ops and isinstance(plan.mixer_ops[0], AggregateOp):
        out.agg = aggregate_produce(batch, plan.mixer_ops[0].spec, backend)
    else:
        pre = batch
        if (len(plan.mixer_ops) >= 2
                and isinstance(plan.mixer_ops[0], SortOp)
                and isinstance(plan.mixer_ops[1], LimitOp)):
            pre = apply_limit(apply_sort(pre, plan.mixer_ops[0]),
                              plan.mixer_ops[1].k)
        out.batch = pre
    out.cpu_ms = (time.perf_counter() - t0) * 1e3
    return out
