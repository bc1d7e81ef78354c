"""Warp:AdHoc — the interactive execution engine (paper §4.3.1–§4.3.5).

Clients hand a WFL flow to the *Mixer*, which plans the query, acquires a
micro-cluster of *Servers* from the Catalog manager (execution isolation),
fans shard tasks out, and merges partial results.  Failure handling is
"best effort": a failed server task is retried once, then dropped — the
result reports its *coverage* so the client can decide to retry, exactly
the Dremel-style contract the paper describes for interactive queries.

Per-query profiles (rows scanned, bytes read, CPU/exec time) are appended
to a streaming FDb (§4.1.1: "read-write FDbs … for query profiling"), which
the benchmark harness queries back — with WarpFlow itself.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.exprs import CollectedTable, FieldRef
from ..core.flow import (AggregateOp, DistinctOp, Flow, JoinOp, LimitOp,
                         SortOp)
from ..core.planner import PartitionPlan, Plan, plan_flow
from ..fdb.columnar import ColumnBatch
from ..fdb.fdb import FDb, Shard, _build_shard_indexes
from ..fdb.schema import DOUBLE, INT, STRING, Schema
from .backend import as_backend
from .batched import (merge_partition_partials, partition_waves,
                      resolve_partition_plan, run_wave_task, wave_size)
from .config import ExecConfig
from .catalog import Catalog, default_catalog
from .failures import FaultPlan, TaskFailure
from .processors import (AggPartial, aggregate_consume, aggregate_produce,
                         apply_distinct, apply_filter, apply_limit,
                         apply_sort, merge_agg_partials, run_record_ops)
from .task import ShardPartial as _ShardPartial, run_shard_task

__all__ = ["AdHocEngine", "QueryResult", "default_engine"]


@dataclass
class QueryProfile:
    source: str = ""
    shards_total: int = 0
    shards_done: int = 0
    rows_scanned: int = 0
    rows_selected: int = 0
    bytes_read: int = 0
    cpu_ms: float = 0.0
    io_ms: float = 0.0
    exec_ms: float = 0.0
    retries: int = 0
    dropped_shards: List[int] = dc_field(default_factory=list)

    @property
    def coverage(self) -> float:
        return self.shards_done / max(self.shards_total, 1)

    def record(self) -> dict:
        return {"source": self.source, "shards_total": self.shards_total,
                "shards_done": self.shards_done,
                "rows_scanned": self.rows_scanned,
                "rows_selected": self.rows_selected,
                "bytes_read": self.bytes_read, "cpu_ms": self.cpu_ms,
                "io_ms": self.io_ms, "exec_ms": self.exec_ms,
                "retries": self.retries}


class QueryResult(CollectedTable):
    def __init__(self, batch: ColumnBatch, profile: QueryProfile,
                 plan: Plan):
        super().__init__(batch)
        self.profile = profile
        self.plan = plan

    @property
    def coverage(self) -> float:
        return self.profile.coverage


class AdHocEngine:
    """Mixer + Servers over a thread pool (the always-on micro-cluster)."""

    PROFILE_SCHEMA = Schema.dynamic("warpflow.query_log", {
        "source": STRING, "shards_total": INT, "shards_done": INT,
        "rows_scanned": INT, "rows_selected": INT, "bytes_read": INT,
        "cpu_ms": DOUBLE, "io_ms": DOUBLE, "exec_ms": DOUBLE,
        "retries": INT})

    def __init__(self, catalog: Optional[Catalog] = None,
                 num_servers: int = 8,
                 profile_log=None, backend=None,
                 wave: Optional[int] = None,
                 partitions: Optional[int] = None,
                 config: Optional[ExecConfig] = None):
        self.catalog = catalog or default_catalog()
        self.num_servers = num_servers
        # one consolidated config (see exec.config): explicit config
        # fields > legacy per-field kwargs (deprecation shims) > env >
        # defaults.  The resolved values keep their legacy attributes.
        self.config = (config or ExecConfig()).fill(
            backend=backend, wave=wave, partitions=partitions)
        self.backend = self.config.resolve_backend()
        self.wave = self.config.resolve_wave(self.backend)
        self.partitions = self.config.partitions
        if profile_log is None:
            from ..fdb.streaming import StreamingFDb
            profile_log = StreamingFDb("warpflow.query_log",
                                       self.PROFILE_SCHEMA,
                                       flush_threshold=256)
        self.profile_log = profile_log

    # ------------------------------------------------------------- public
    def collect(self, flow: Flow, fault_plan: Optional[FaultPlan] = None,
                num_servers: Optional[int] = None) -> QueryResult:
        t0 = time.perf_counter()
        plan = plan_flow(flow, self.catalog)
        # execute against the snapshot the planner pinned: for streaming
        # sources a concurrent append swaps the catalog's current view,
        # and a re-resolve here could tear the query across generations
        db = plan.db if plan.db is not None else self.catalog.get(plan.source)
        # device-resident columns: one-time put per FDb (no-op on host
        # backends; for a streaming snapshot only new delta buffers
        # upload — shared sealed shards are already resident)
        self.backend.prime_fdb(db)

        # Broadcast side of hash joins: run the right flow first (recursive
        # query), index it by the right key — the paper's broadcast join.
        tables: Dict[int, CollectedTable] = {}
        for op in plan.server_ops:
            if isinstance(op, JoinOp):
                rres = self.collect(op.right, fault_plan=fault_plan)
                if not isinstance(op.right_key, FieldRef):
                    raise TypeError("join right_key must be a field")
                tables[id(op)] = rres.to_dict(op.right_key.path)

        want = min(len(plan.shard_ids), num_servers or self.num_servers)
        grant = self.catalog.resources.acquire(want)
        profile = QueryProfile(source=plan.source,
                               shards_total=len(plan.shard_ids))
        pplan = self._partition_plan(plan, profile, fault_plan)
        try:
            partials = self._run_servers(db, plan, tables, grant, profile,
                                         fault_plan, pplan)
        finally:
            self.catalog.resources.release(grant)

        batch = self._mixer(plan, partials, profile,
                            premerged=merge_partition_partials(
                                db, plan, partials, self.backend, pplan))
        profile.exec_ms = (time.perf_counter() - t0) * 1e3
        self.profile_log.append(profile.record())
        return QueryResult(batch, profile, plan)

    def save(self, flow: Flow, name: str, num_shards: int = 8,
             schema: Optional[Schema] = None, **kw) -> FDb:
        """Materialize a flow back into a registered FDb (Table 1: save)."""
        res = self.collect(flow, **kw)
        batch = res.batch
        if schema is not None:
            # re-index under the provided (annotated) schema
            from ..fdb.fdb import build_fdb
            db = build_fdb(name, schema, batch.to_records(), num_shards)
        else:
            ids = np.arange(batch.n)
            shards = []
            for i in range(num_shards):
                sub = batch.gather(ids[ids % num_shards == i])
                shards.append(Shard(sub, _build_shard_indexes(sub.schema,
                                                              sub)))
            db = FDb(name, batch.schema, shards)
        self.catalog.register(db)
        return db

    def explain(self, flow: Flow) -> str:
        return plan_flow(flow, self.catalog).describe()

    # ------------------------------------------------------------ servers
    def _partition_plan(self, plan, profile=None,
                        fault_plan=None) -> PartitionPlan:
        """See ``batched.resolve_partition_plan`` — the engines share the
        partition-axis resolution and fault-reroute path."""
        return resolve_partition_plan(self.partitions, self.backend, plan,
                                      fault_plan, profile)

    def _run_partition_wave(self, pplan, pi, db, plan, sids, nxt, tables,
                            fault_plan):
        with self.backend.partition_context(pi, pplan.num_partitions):
            return run_wave_task(db, plan, sids, tables, self.catalog,
                                 fault_plan, backend=self.backend,
                                 prefetch_sids=nxt,
                                 fused=self.config.fused,
                                 profile=self.config.profile)

    def _run_servers(self, db, plan, tables, grant, profile, fault_plan,
                     pplan: Optional[PartitionPlan] = None
                     ) -> List[_ShardPartial]:
        """Per-partition waves of shards through the batched backend
        seam; shards whose fault check trips at wave start fall back to
        the per-shard retry/drop path (best-effort contract unchanged).
        With P=1 this degenerates to the legacy single-loop wave order,
        byte for byte."""
        partials: List[_ShardPartial] = []
        retry: List[int] = []
        if pplan is None:
            pplan = self._partition_plan(plan, profile, fault_plan)
        # each wave names its successor *within its partition* so a fused
        # backend stages wave k+1's buffers on that partition's device
        # while wave k computes
        subs = []
        for pi, part in enumerate(pplan.parts):
            pw = partition_waves(part, self.wave)
            for j, w in enumerate(pw):
                subs.append((pi, w, pw[j + 1] if j + 1 < len(pw)
                             else None))
        with ThreadPoolExecutor(max_workers=grant) as pool:
            futs = [pool.submit(self._run_partition_wave, pplan, pi, db,
                                plan, w, nxt, tables, fault_plan)
                    for pi, w, nxt in subs]
            for f in as_completed(futs):
                done, failed = f.result()
                partials.extend(done)
                profile.shards_done += len(done)
                retry.extend(failed)
            # best-effort: one retry round, then drop (client may re-issue)
            for sid in sorted(retry):
                profile.retries += 1
                try:
                    partials.append(run_shard_task(
                        db, plan, sid, tables, self.catalog, fault_plan,
                        backend=self.backend))
                    profile.shards_done += 1
                except TaskFailure:
                    profile.dropped_shards.append(sid)
        for p in partials:
            profile.rows_scanned += p.rows_scanned
            profile.rows_selected += p.rows_selected
            profile.bytes_read += p.bytes_read
            profile.cpu_ms += p.cpu_ms
            profile.io_ms += p.io_ms
        # deterministic reduction order regardless of completion order
        partials.sort(key=lambda p: p.shard_id)
        return partials

    # -------------------------------------------------------------- mixer
    def _mixer(self, plan: Plan, partials: Sequence[_ShardPartial],
               profile: QueryProfile,
               premerged: Optional[AggPartial] = None) -> ColumnBatch:
        mixer_ops = list(plan.mixer_ops)
        if mixer_ops and isinstance(mixer_ops[0], AggregateOp):
            spec = mixer_ops[0].spec
            # ``premerged`` is the partition layer's single-launch device
            # combine of the per-shard segment states; when absent, fold
            # host-side in shard-id order (P-invariant either way)
            merged = premerged if premerged is not None else \
                merge_agg_partials(
                    [p.agg for p in partials if p.agg is not None], spec)
            batch = aggregate_consume(merged, spec)
            mixer_ops = mixer_ops[1:]
        else:
            batches = [p.batch for p in partials if p.batch is not None]
            if batches:
                batch = ColumnBatch.concat(batches)
            else:
                batch = ColumnBatch(plan.out_schema, {}, 0)
        for op in mixer_ops:
            if isinstance(op, SortOp):
                batch = apply_sort(batch, op)
            elif isinstance(op, LimitOp):
                batch = apply_limit(batch, op.k)
            elif isinstance(op, DistinctOp):
                batch = apply_distinct(batch, op.expr)
            elif isinstance(op, AggregateOp):
                part = aggregate_produce(batch, op.spec, self.backend)
                batch = aggregate_consume(part, op.spec)
            else:
                batch = run_record_ops(batch, [op], self.catalog, None,
                                       backend=self.backend)
        return batch


_DEFAULT_ENGINE: Optional[AdHocEngine] = None


def default_engine() -> AdHocEngine:
    global _DEFAULT_ENGINE
    if _DEFAULT_ENGINE is None:
        _DEFAULT_ENGINE = AdHocEngine()
    return _DEFAULT_ENGINE
