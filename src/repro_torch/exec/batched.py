"""Batched multi-shard wave execution (the stacked-shard hot path).

Per-shard dispatch pays one kernel launch per shard per primitive — the
dominant scaling cliff once shard counts reach the hundreds the paper runs
(§4–5).  This module groups a plan's shards into **waves** and drives each
wave through the backend's batched ops, so a wave costs:

  * one ``probe_shards`` launch       (stacked bitmap AND + popcount),
  * one ``refine_tracks_batched`` launch per track-refine spec (the exact
    Tesseract point-in-cover × time-window pass, fused on device),
  * one ``compact_masks`` launch      (stacked selection → doc ids),
  * one ``compact_masks`` launch      for the residual filter (if any),
  * one ``segment_aggregate_batched`` launch per aggregated value column,

instead of the same set *per shard* — ⌈shards/wave⌉ launches per primitive
per query (asserted by ``tests/test_batched.py`` / ``tests/test_refine.py``
via the kernel launch counter).  The numpy backend's batched ops loop
shard-by-shard, so the wave runner is byte-identical to the per-shard path
on both backends.

**Fused dispatch.**  When the backend amortizes batched launches and the
plan has no residual filter and at most one refine spec, the wave instead
runs through ``backend.run_wave_fused`` — probe → refine → compact →
(segment-agg) as ONE device dispatch (``kernels.fused``), tightening the
contract to ⌈shards/wave⌉ **total** launches per query.  Plans whose
aggregation is a single dense int-key group-by with only
count/sum/avg/std_dev/min/max (``fused_agg_plan``) skip the column gather
entirely: the fused dispatch returns per-group partial sums and
``_fused_agg_finalize`` reproduces the host aggregation byte-for-byte.
Other plans run the fused selection stages and keep the legacy
gather/processor tail.  ``REPRO_EXEC_FUSED=0`` forces the per-primitive
path (the CI leg that keeps it covered); a backend may also decline a
wave (``run_wave_fused`` → None) and fall back.  ``prefetch_sids`` names
the *next* wave so its stacked buffers upload while this wave computes.

Engines schedule waves onto their worker pools; shards whose fault check
trips at wave start are returned to the caller for the engine's per-shard
retry/recovery machinery (``run_shard_task``), which keeps the failure
unit a single shard.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.exprs import CollectedTable, FieldRef
from ..core.flow import AggregateOp, LimitOp, SortOp
from ..core.planner import (PartitionPlan, Plan, num_partitions,
                            partition_shards)
from ..fdb.fdb import FDb
from ..fdb.index import mask_from_bitmap
from .backend import as_backend
from .failures import FaultPlan, TaskFailure
from .processors import (AggPartial, aggregate_produce_batched, apply_limit,
                         apply_sort, predicate_mask, run_record_ops)
from .task import ShardPartial

__all__ = ["DEFAULT_WAVE", "WAVE_ENV", "FUSED_ENV", "wave_size",
           "partition_waves", "fused_enabled", "FusedAggPlan",
           "fused_agg_plan", "run_wave_task",
           "merge_partition_partials", "resolve_partition_plan"]

DEFAULT_WAVE = 8
WAVE_ENV = "REPRO_EXEC_WAVE"
FUSED_ENV = "REPRO_EXEC_FUSED"


def fused_enabled(override: Optional[bool] = None) -> bool:
    """Fused whole-wave dispatch is on unless ``REPRO_EXEC_FUSED=0``.
    An explicit ``override`` (``ExecConfig.fused``) wins over the env."""
    if override is not None:
        return bool(override)
    return os.environ.get(FUSED_ENV, "") != "0"


def wave_size(spec: Optional[int] = None, backend=None) -> int:
    """Shards per wave: explicit argument > $REPRO_EXEC_WAVE > backend
    default (``DEFAULT_WAVE`` when the backend's batched ops amortize
    kernel launches, else 1 — a loop-over-shards backend gains nothing
    from wide waves and would only lose per-shard thread parallelism)."""
    if spec is not None:
        return max(1, int(spec))
    env = os.environ.get(WAVE_ENV)
    if env:
        return max(1, int(env))
    if backend is not None and not getattr(backend, "batched_dispatch",
                                           False):
        return 1
    return DEFAULT_WAVE


def partition_waves(shard_ids: Sequence[int], wave: int) -> List[List[int]]:
    sids = list(shard_ids)
    return [sids[i:i + wave] for i in range(0, len(sids), wave)]


# --------------------------------------------------------------------------
# Fused aggregation plan — when the group-by can run inside the fused
# dispatch (no column gather at all)
# --------------------------------------------------------------------------

@dataclass
class FusedAggPlan:
    """Group-by lowered into the fused dispatch's segment stage.

    ``key_path`` is the single dense int-key column, ``value_paths`` the
    distinct aggregated columns (one segment slot each, deduplicated in
    first-use order — matching the host path's expression-level dedup),
    and ``slot_of[i]`` maps ``spec.aggs[i]`` to its value slot (``None``
    for count, which reads any slot's per-group row counts).
    """

    spec: object                       # core.exprs.AggSpec
    key_path: str
    value_paths: List[str]
    slot_of: List[Optional[int]]
    #: per value slot: True when some min/max agg reads that column, so
    #: the fused dispatch extends the slot with segment min/max planes
    minmax: Tuple[bool, ...] = ()

    def factorize(self, shard, backend=None):
        """``(group_keys, row_codes int32, num_groups)`` over the shard's
        FULL key column (``np.unique`` — sorted keys, same order the host
        path's single-int-key fast path produces).  Cached through the
        backend's DeviceCache keyed entries when the column is primed, so
        repeated queries skip the host unique."""
        kvals = shard.batch[self.key_path].values
        cache = getattr(backend, "device_cache", None)
        primed = getattr(backend, "_primed_refs", None)
        use_cache = (cache is not None and primed is not None
                     and id(kvals) in primed)
        key = ("agg_fact", id(kvals))
        if use_cache:
            hit = cache.get_keyed(key)
            if hit is not None:
                return hit
        uniq, inv = np.unique(kvals, return_inverse=True)
        out = (uniq, inv.reshape(-1).astype(np.int32), int(uniq.size))
        if use_cache:
            cache.put_keyed(key, out)
        return out


def fused_agg_plan(plan: Plan, shards) -> Optional[FusedAggPlan]:
    """Eligibility for the fused aggregation stage, or ``None``.

    Requirements (everything else falls back to the gather + host
    aggregation tail, still behind the fused *selection* stages):

      * the plan's first mixer op is the aggregate, with no server ops and
        no residual (both need gathered/derived columns host-side),
      * exactly one group key, a plain field ref to a dense non-vocab
        int-like column on every shard,
      * only count/sum/avg/std_dev/min/max aggs (approx_distinct needs the
        selected rows themselves), each over a plain field ref to a dense
        non-vocab numeric column — min/max ride as extra segment planes on
        their value slot,
      * every read-set column dense, so ``bytes_read`` stays exact without
        gathering (ragged nbytes depends on the selected rows' spans).
    """
    if plan.residual is not None or plan.server_ops:
        return None
    if not plan.mixer_ops or not isinstance(plan.mixer_ops[0], AggregateOp):
        return None
    spec = plan.mixer_ops[0].spec
    if len(spec.keys) != 1 or not isinstance(spec.keys[0][1], FieldRef):
        return None
    key_path = spec.keys[0][1].path

    def dense(path: str, int_key: bool = False) -> bool:
        for sh in shards:
            col = sh.batch.columns.get(path)
            if col is None or col.row_splits is not None \
                    or col.vocab is not None:
                return False
            if col.values.dtype.kind not in ("biu" if int_key else "biuf"):
                return False
        return True

    if not dense(key_path, int_key=True):
        return None
    value_paths: List[str] = []
    slot_of: List[Optional[int]] = []
    minmax_slots: set = set()
    for kind, _name, e in spec.aggs:
        if kind == "count" and e is None:
            slot_of.append(None)
            continue
        if kind not in ("sum", "avg", "std_dev", "min", "max") \
                or not isinstance(e, FieldRef) or not dense(e.path):
            return None
        if e.path not in value_paths:
            value_paths.append(e.path)
        slot = value_paths.index(e.path)
        slot_of.append(slot)
        if kind in ("min", "max"):
            minmax_slots.add(slot)
    for sh in shards:
        paths = [p for p in plan.source_paths if p in sh.batch.columns]
        if not paths:
            paths = sh.batch.paths()
        if any(sh.batch[p].row_splits is not None for p in paths):
            return None
    return FusedAggPlan(spec, key_path, value_paths, slot_of,
                        tuple(i in minmax_slots
                              for i in range(len(value_paths))))


def _fused_agg_finalize(agg: FusedAggPlan, uniq: np.ndarray,
                        slots) -> AggPartial:
    """Per-shard ``AggPartial`` from the fused dispatch's segment sums —
    the same accumulator formats ``processors._agg_finalize`` builds, for
    the groups with at least one selected row (the host path factorizes
    the *gathered* rows, so zero-count groups never exist there)."""
    part = AggPartial()
    if len(uniq) == 0 or not slots:
        return part
    cnt = slots[0][0]
    keep = cnt > 0
    if not keep.any():
        return part
    counts = cnt[keep]
    per_agg: List[list] = []
    for (kind, _name, _e), slot in zip(agg.spec.aggs, agg.slot_of):
        if kind == "count":
            per_agg.append([int(c) for c in counts])
            continue
        s = slots[slot][1][keep]
        if kind == "sum":
            per_agg.append([float(x) for x in s])
        elif kind == "avg":
            per_agg.append([(float(x), int(c))
                            for x, c in zip(s, counts)])
        elif kind == "min":
            per_agg.append([float(x) for x in slots[slot][3][keep]])
        elif kind == "max":
            per_agg.append([float(x) for x in slots[slot][4][keep]])
        else:                                            # std_dev
            s2 = slots[slot][2][keep]
            per_agg.append([(float(x), float(y), int(c))
                            for x, y, c in zip(s, s2, counts)])
    for g, v in enumerate(uniq[keep].tolist()):
        part.groups[(v,)] = [col[g] for col in per_agg]
    return part


def run_wave_task(db: FDb, plan: Plan, sids: Sequence[int],
                  tables: Optional[Dict[int, CollectedTable]],
                  catalog, fault_plan: Optional[FaultPlan] = None,
                  stage: str = "server", backend=None,
                  prefetch_sids: Optional[Sequence[int]] = None,
                  fused: Optional[bool] = None,
                  profile: Optional[bool] = None
                  ) -> Tuple[List[ShardPartial], List[int]]:
    """Run one wave of shard tasks through the batched backend seam.

    Returns ``(partials, failed_shard_ids)``: shards whose fault check
    trips are excluded from the wave and handed back for the engine's
    per-shard retry path.  ``prefetch_sids`` — the next wave's shard ids —
    lets a fused backend stage that wave's device buffers while this one
    computes (double-buffered upload; ignored on host backends).
    """
    backend = as_backend(backend)
    failed: List[int] = []
    live: List[int] = []
    for sid in sids:
        if fault_plan is not None:
            try:
                fault_plan.check(stage, sid)
            except TaskFailure:
                failed.append(sid)
                continue
        live.append(sid)
    if not live:
        return [], failed

    t0 = time.perf_counter()
    shards = [db.shards[sid] for sid in live]
    # probe bitmaps stay host-built (index lookups over host postings) so
    # the fused path's launch count is exactly the fused dispatches
    probe_bms = [[p.run(sh) for p in plan.probes] for sh in shards]

    # ---- fused whole-wave dispatch: probe → refine → compact → (agg) in
    # ONE launch when the backend and plan shape allow it
    fused_out = None
    fused_agg: Optional[FusedAggPlan] = None
    if (fused_enabled(fused) and getattr(backend, "batched_dispatch", False)
            and plan.residual is None and len(plan.refines) <= 1):
        fused_agg = fused_agg_plan(plan, shards)
        pre = ([db.shards[s] for s in prefetch_sids]
               if prefetch_sids else None)
        fused_out = backend.run_wave_fused(
            shards, probe_bms,
            plan.refines[0] if plan.refines else None, fused_agg,
            prefetch_shards=pre, profile=profile)
        if fused_out is None:                 # backend declined this wave
            fused_agg = None

    if fused_out is not None:
        n_cands, ids_list, seg = fused_out
        trace = getattr(backend, "trace_events", None)
        if trace is not None:
            trace.append(("wave_done", tuple(live)))
    else:
        # ---- per-primitive path: one launch per primitive per wave
        seg = None
        bms = backend.probe_shards(
            [sh.all_bitmap() for sh in shards], probe_bms)
        masks = [mask_from_bitmap(bm, sh.n) for bm, sh in zip(bms, shards)]
        # rows_selected reports the *index-selected* candidates
        # (pre-refine), matching the per-shard path and tesseract_stats'
        # candidate counts
        n_cands = [int(m.sum()) for m in masks]
        # ---- exact track refine: one fused device launch per wave per
        # spec, emitting per-doc hit masks that feed the selection compact
        for rf in plan.refines:
            masks = backend.refine_tracks_batched(
                [sh.batch for sh in shards], rf.path, rf.constraints,
                masks, edges=rf.edges, min_counts=rf.min_counts,
                dwells=rf.dwells)
        ids_list = backend.compact_masks(masks)
    t1 = time.perf_counter()

    # ---- gather-free aggregation tail: the fused dispatch already holds
    # the per-group sums; bytes_read is exact analytically because the
    # read set is all-dense (fused_agg_plan guarantees it)
    if fused_agg is not None:
        partials = []
        for i, (sid, sh, ids, n_cand) in enumerate(
                zip(live, shards, ids_list, n_cands)):
            paths = [p for p in plan.source_paths if p in sh.batch.columns]
            if not paths:
                paths = sh.batch.paths()
            nbytes = int(ids.size) * sum(
                int(sh.batch[p].values.dtype.itemsize) for p in paths)
            part = ShardPartial(shard_id=sid, rows_scanned=sh.n,
                                rows_selected=n_cand, bytes_read=nbytes)
            uniq, slots = seg[i]
            part.agg = _fused_agg_finalize(fused_agg, uniq, slots)
            part.seg = (uniq, slots)
            partials.append(part)
        io_each = (time.perf_counter() - t1) * 1e3 / len(live)
        cpu_each = (time.perf_counter() - t0) * 1e3 / len(live)
        for part in partials:
            part.io_ms = io_each
            part.cpu_ms = cpu_each
        return partials, failed

    # ---- selective column read (device-resident buffers when primed)
    partials: List[ShardPartial] = []
    batches = []
    for sid, sh, ids, n_cand in zip(live, shards, ids_list, n_cands):
        paths = [p for p in plan.source_paths if p in sh.batch.columns]
        if not paths:
            paths = sh.batch.paths()
        batch = backend.gather_columns(sh.batch, paths, ids)
        partials.append(ShardPartial(shard_id=sid, rows_scanned=sh.n,
                                     rows_selected=n_cand,
                                     bytes_read=batch.nbytes()))
        batches.append(batch)
    t2 = time.perf_counter()

    # ---- residual filter: masks host-evaluated, compacted in one launch
    if plan.residual is not None:
        keeps = backend.compact_masks(
            [predicate_mask(b, plan.residual) for b in batches])
        batches = [b.gather(k) for b, k in zip(batches, keeps)]
    batches = [run_record_ops(b, plan.server_ops, catalog, tables,
                              backend=backend) for b in batches]

    # ---- tail: wave-batched aggregation, or per-shard presort/limit
    if plan.mixer_ops and isinstance(plan.mixer_ops[0], AggregateOp):
        aggs = aggregate_produce_batched(batches, plan.mixer_ops[0].spec,
                                         backend)
        for part, agg in zip(partials, aggs):
            part.agg = agg
    else:
        presort = (len(plan.mixer_ops) >= 2
                   and isinstance(plan.mixer_ops[0], SortOp)
                   and isinstance(plan.mixer_ops[1], LimitOp))
        for part, batch in zip(partials, batches):
            pre = batch
            if presort:
                pre = apply_limit(apply_sort(pre, plan.mixer_ops[0]),
                                  plan.mixer_ops[1].k)
            part.batch = pre

    # profile attribution: wave phases are shared work, split evenly
    io_each = (t2 - t1) * 1e3 / len(live)
    cpu_each = (time.perf_counter() - t0) * 1e3 / len(live)
    for part in partials:
        part.io_ms = io_each
        part.cpu_ms = cpu_each
    return partials, failed


def resolve_partition_plan(partitions, backend, plan: Plan,
                           fault_plan: Optional[FaultPlan] = None,
                           profile=None) -> PartitionPlan:
    """Resolve P (engine arg > ``REPRO_EXEC_PARTITIONS`` > CUDA device
    count for batched backends) and assign the plan's pruned shard list to P
    contiguous partitions.  A partition whose FaultPlan check trips
    (stage ``"partition"``) is drained *before* dispatch and its shards
    rerouted across the surviving partitions
    (``launch.elastic.reroute_partitions``, counted on ``profile.retries``)
    — the partition-axis recovery path both engines share."""
    p = num_partitions(partitions, backend)
    pplan = partition_shards(plan.shard_ids, p)
    if fault_plan is not None and pplan.num_partitions > 1:
        failed = []
        for pi in range(pplan.num_partitions):
            try:
                fault_plan.check("partition", pi)
            except TaskFailure:
                failed.append(pi)
        if failed:
            from ..launch.elastic import reroute_partitions

            rerouted = reroute_partitions(pplan.parts, failed)
            if rerouted != pplan.parts and profile is not None:
                profile.retries += len(failed)
            pplan = PartitionPlan(rerouted)
    return pplan


def merge_partition_partials(db: FDb, plan: Plan,
                             partials: Sequence[ShardPartial],
                             backend, pplan) -> Optional[AggPartial]:
    """The partitioned Mixer combine: fold per-shard fused segment states
    into ONE pre-merged ``AggPartial`` through ``backend.merge_partials``
    (a single recorded combine launch).

    Returns ``None`` when the combine doesn't apply and the caller should
    keep the host ``merge_agg_partials`` fold — P=1 (the legacy sequential
    path *is* the reference), non-aggregate plans, fused-agg-ineligible
    plans, or any partial missing its raw ``seg`` state (e.g. a shard
    recovered through the per-shard retry path).  The host fold is
    partition-invariant anyway — engines sort partials back into shard-id
    order first — so the fallback only costs the merge launch evidence,
    never correctness.

    ``partials`` must already be sorted by shard id: partitions are
    contiguous shard slices, so shard-id order is exactly the states
    order the sequential P=1 reference accumulates in.
    """
    if pplan is None or pplan.num_partitions <= 1:
        return None
    if not partials:
        return None
    if not (plan.mixer_ops and isinstance(plan.mixer_ops[0], AggregateOp)):
        return None
    if any(p.seg is None for p in partials):
        return None
    fused_agg = fused_agg_plan(plan, [db.shards[s] for s in plan.shard_ids])
    if fused_agg is None:
        return None
    by_part = {sid: i for i, part in enumerate(pplan.parts)
               for sid in part}
    counts = [0] * pplan.num_partitions
    for p in partials:
        counts[by_part.get(p.shard_id, 0)] += 1
    uniq, slots = backend.merge_partials([p.seg for p in partials],
                                         minmax=fused_agg.minmax,
                                         parts=counts)
    return _fused_agg_finalize(fused_agg, uniq, slots)
