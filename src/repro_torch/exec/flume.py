"""Warp:Flume — the checkpointed batch execution engine (paper §4.3.6).

The same logical plan as Warp:AdHoc, translated into batch stages with:

  * **stage-boundary checkpoints** — every shard task materializes its
    partial to disk with an atomic DONE marker; a re-run of the same job id
    skips completed tasks (auto-recovery after a crash, like Flume's
    checkpoint logs),
  * **retries with rerouting** — a persistently failing task is retried up
    to ``max_attempts`` times ("machine restarts and pipeline retries"),
  * **speculative execution** — when a task lags the median completed-task
    time by ``speculation_factor``, a backup duplicate is launched; first
    result wins (the classic MapReduce straggler mitigation),
  * **auto-scaling** — worker count per stage is sized from the number of
    tasks rather than fixed cluster size.

The paper notes ~25 % overhead versus a hand-written Flume job, bought back
5–10× in development time; ``chip_smoke.py``'s engines phase times the
port's analog (stage checkpointing vs pure in-memory AdHoc) on the card.
A copy of the JAX package's ``exec/flume.py``: host code, the backend
(default ``"torch"``, through :class:`ExecConfig`) does the device work,
and every checkpointed ``ShardPartial`` holds host numpy only, so a
checkpoint written on the card loads on a CPU-only host.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor, Future, wait, FIRST_COMPLETED
from typing import Dict, List, Optional, Set

from ..core.exprs import CollectedTable, FieldRef
from ..core.flow import AggregateOp, DistinctOp, Flow, JoinOp, LimitOp, SortOp
from ..core.planner import PartitionPlan, Plan, plan_flow
from ..fdb.columnar import ColumnBatch
from ..fdb.schema import Schema
from .adhoc import QueryProfile, QueryResult
from .backend import as_backend
from .batched import (merge_partition_partials, partition_waves,
                      resolve_partition_plan, run_wave_task, wave_size)
from .catalog import Catalog, default_catalog
from .config import ExecConfig
from .failures import FaultPlan, TaskFailure
from .processors import (aggregate_consume, aggregate_produce,
                         apply_distinct, apply_limit, apply_sort,
                         merge_agg_partials, run_record_ops)
from .task import ShardPartial, run_shard_task

__all__ = ["FlumeEngine"]


class FlumeEngine:
    def __init__(self, catalog: Optional[Catalog] = None,
                 ckpt_dir: Optional[str] = None,
                 max_workers: int = 8,
                 max_attempts: int = 4,
                 speculation: bool = True,
                 speculation_factor: float = 4.0,
                 backend=None, wave: Optional[int] = None,
                 partitions: Optional[int] = None,
                 config: Optional[ExecConfig] = None):
        self.catalog = catalog or default_catalog()
        # consolidated config (see exec.config): explicit config fields >
        # legacy kwargs (shims) > env > defaults
        self.config = (config or ExecConfig()).fill(
            backend=backend, wave=wave, partitions=partitions)
        self.backend = self.config.resolve_backend()
        self.wave = self.config.resolve_wave(self.backend)
        self.partitions = self.config.partitions
        self.ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                                 "warpflume")
        self.max_workers = max_workers
        self.max_attempts = max_attempts
        self.speculation = speculation
        self.speculation_factor = speculation_factor
        self.stats: Dict[str, int] = {"tasks_run": 0, "tasks_skipped": 0,
                                      "speculative_launched": 0,
                                      "speculative_won": 0, "retries": 0}

    # ----------------------------------------------------------------- api
    def collect(self, flow: Flow, fault_plan: Optional[FaultPlan] = None,
                job_id: Optional[str] = None) -> QueryResult:
        t0 = time.perf_counter()
        plan = plan_flow(flow, self.catalog)
        # pinned snapshot (see AdHocEngine.collect): never re-resolve
        db = plan.db if plan.db is not None else self.catalog.get(plan.source)
        self.backend.prime_fdb(db)          # device-resident columns
        job_id = job_id or self._job_id(flow)
        job_dir = os.path.join(self.ckpt_dir, job_id)
        os.makedirs(job_dir, exist_ok=True)

        tables: Dict[int, CollectedTable] = {}
        for op in plan.server_ops:
            if isinstance(op, JoinOp):
                rres = self.collect(op.right, fault_plan=fault_plan,
                                    job_id=job_id + "-r%08x" % (id(op) & 0xFFFFFFFF))
                if not isinstance(op.right_key, FieldRef):
                    raise TypeError("join right_key must be a field")
                tables[id(op)] = rres.to_dict(op.right_key.path)

        profile = QueryProfile(source=plan.source,
                               shards_total=len(plan.shard_ids))

        # Stage 1: shard tasks with checkpoints + speculation (auto-scaled).
        # Fault-free runs take the batched wave path (per-shard checkpoints
        # still written); with a fault plan installed the engine schedules
        # per-shard tasks so retries, rerouting, and speculation stay at
        # the simulated machine-failure boundary.
        workers = min(self.max_workers, max(1, len(plan.shard_ids)))
        # partition layer: resolve P and reroute partition-axis faults
        # before dispatch (launch.elastic); a fault plan that *only*
        # injects at the partition stage keeps the batched wave path —
        # per-shard faults still force per-shard task scheduling so
        # retries/speculation stay at the machine-failure boundary
        pplan = resolve_partition_plan(self.partitions, self.backend,
                                       plan, fault_plan, profile)
        wave_fn = None
        if fault_plan is None or fault_plan.stages() <= {"partition"}:
            def wave_fn(pi, sids, nxt=None):
                with self.backend.partition_context(pi,
                                                    pplan.num_partitions):
                    return run_wave_task(
                        db, plan, sids, tables, self.catalog, None,
                        stage="server", backend=self.backend,
                        prefetch_sids=nxt, fused=self.config.fused,
                        profile=self.config.profile)
        partials = self._run_stage(
            stage="server", job_dir=job_dir, task_ids=plan.shard_ids,
            fn=lambda sid: run_shard_task(db, plan, sid, tables,
                                          self.catalog, fault_plan,
                                          stage="server",
                                          backend=self.backend),
            workers=workers, profile=profile, wave_fn=wave_fn,
            pplan=pplan)

        # Stage 2 (Mixer): merge + finish — itself checkpointed.
        final_path = os.path.join(job_dir, "final.pkl")
        if os.path.exists(final_path):
            with open(final_path, "rb") as fh:
                batch = pickle.load(fh)
            self.stats["tasks_skipped"] += 1
        else:
            batch = self._mixer(plan, partials,
                                premerged=merge_partition_partials(
                                    db, plan, partials, self.backend,
                                    pplan))
            _atomic_pickle(batch, final_path)
        for p in partials:
            profile.rows_scanned += p.rows_scanned
            profile.rows_selected += p.rows_selected
            profile.bytes_read += p.bytes_read
            profile.cpu_ms += p.cpu_ms
            profile.io_ms += p.io_ms
        profile.shards_done = len(partials)
        profile.exec_ms = (time.perf_counter() - t0) * 1e3
        return QueryResult(batch, profile, plan)

    # --------------------------------------------------------------- stage
    def _run_stage(self, stage: str, job_dir: str, task_ids: List[int],
                   fn, workers: int, profile: QueryProfile,
                   wave_fn=None,
                   pplan: Optional[PartitionPlan] = None
                   ) -> List[ShardPartial]:
        stage_dir = os.path.join(job_dir, stage)
        os.makedirs(stage_dir, exist_ok=True)
        results: Dict[int, ShardPartial] = {}
        todo: List[int] = []
        for sid in task_ids:
            p = self._ckpt_path(stage_dir, sid)
            if os.path.exists(p):                       # auto-recovery
                with open(p, "rb") as fh:
                    results[sid] = pickle.load(fh)
                self.stats["tasks_skipped"] += 1
            else:
                todo.append(sid)

        if wave_fn is not None and todo:
            # batched pre-pass: one stacked dispatch per wave, waves run
            # concurrently on the stage's worker budget, same per-task
            # checkpoint files as the per-shard path.  A wave that errors
            # must not abort its siblings: completed waves still commit
            # their checkpoints (the point of stage-level recovery), and
            # the failed wave's shards fall through to the per-shard
            # machinery below, which retries or raises loudly.
            remaining: List[int] = []
            todo_set = set(todo)
            parts = (pplan.parts if pplan is not None else [list(todo)])
            # waves form *within* each partition (checkpointed shards
            # drop out first); the successor hint stays partition-local
            # so a fused backend prefetches onto that partition's device
            subs = []
            for pi, part in enumerate(parts):
                pw = partition_waves(
                    [sid for sid in part if sid in todo_set], self.wave)
                for j, w in enumerate(pw):
                    subs.append((pi, w, pw[j + 1] if j + 1 < len(pw)
                                 else None))
            with ThreadPoolExecutor(
                    max_workers=min(workers, len(subs))) as pool:
                futs = [(pool.submit(wave_fn, pi, wave, nxt), wave)
                        for pi, wave, nxt in subs]
                for fut, wave in futs:
                    try:
                        done, failed = fut.result()
                    except Exception:
                        remaining.extend(wave)
                        continue
                    for out in done:
                        results[out.shard_id] = out
                        _atomic_pickle(
                            out, self._ckpt_path(stage_dir, out.shard_id))
                    self.stats["tasks_run"] += len(done)
                    remaining.extend(failed)
            todo = remaining

        if not todo:
            return [results[sid] for sid in task_ids if sid in results]

        winner_lock = threading.Lock()
        done_times: List[float] = []

        def attempt(sid: int) -> ShardPartial:
            last: Optional[Exception] = None
            for k in range(self.max_attempts):
                try:
                    t0 = time.perf_counter()
                    out = fn(sid)
                    done_times.append(time.perf_counter() - t0)
                    return out
                except TaskFailure as e:   # reroute / retry with backoff
                    last = e
                    self.stats["retries"] += 1
                    profile.retries += 1
                    time.sleep(0.001 * (2 ** k))
            raise last  # type: ignore[misc]

        def commit(sid: int, out: ShardPartial, speculative: bool) -> bool:
            with winner_lock:
                if sid in results:
                    return False
                results[sid] = out
                if speculative:
                    self.stats["speculative_won"] += 1
            _atomic_pickle(out, self._ckpt_path(stage_dir, sid))
            return True

        stage_errors: List[Exception] = []
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futs: Dict[Future, tuple] = {
                pool.submit(attempt, sid): (sid, False) for sid in todo}
            self.stats["tasks_run"] += len(todo)
            launched_backup: Set[int] = set()
            pending = set(futs)
            start = {sid: time.perf_counter() for sid in todo}
            while pending:
                done, pending = wait(pending, timeout=0.02,
                                     return_when=FIRST_COMPLETED)
                for f in done:
                    sid, spec = futs[f]
                    try:
                        out = f.result()
                    except Exception as e:
                        # exhausted retries: keep draining so *completed*
                        # siblings still commit their checkpoints — the
                        # whole point of stage-level recovery
                        stage_errors.append(e)
                        continue
                    commit(sid, out, spec)
                # straggler detection → speculative backups
                if self.speculation and len(done_times) >= 2:
                    med = sorted(done_times)[len(done_times) // 2]
                    now = time.perf_counter()
                    for f in list(pending):
                        sid, spec = futs[f]
                        if (not spec and sid not in launched_backup
                                and sid not in results
                                and now - start[sid]
                                > self.speculation_factor * max(med, 1e-4)):
                            launched_backup.add(sid)
                            self.stats["speculative_launched"] += 1
                            nf = pool.submit(attempt, sid)
                            futs[nf] = (sid, True)
                            pending.add(nf)
        if stage_errors:
            raise stage_errors[0]
        return [results[sid] for sid in task_ids if sid in results]

    # --------------------------------------------------------------- mixer
    def _mixer(self, plan: Plan, partials: List[ShardPartial],
               premerged=None) -> ColumnBatch:
        mixer_ops = list(plan.mixer_ops)
        if mixer_ops and isinstance(mixer_ops[0], AggregateOp):
            spec = mixer_ops[0].spec
            # ``premerged``: the partition layer's single-launch device
            # combine (see batched.merge_partition_partials)
            merged = premerged if premerged is not None else \
                merge_agg_partials(
                    [p.agg for p in partials if p.agg is not None], spec)
            batch = aggregate_consume(merged, spec)
            mixer_ops = mixer_ops[1:]
        else:
            batches = [p.batch for p in partials if p.batch is not None]
            batch = ColumnBatch.concat(batches) if batches else \
                ColumnBatch(plan.out_schema, {}, 0)
        for op in mixer_ops:
            if isinstance(op, SortOp):
                batch = apply_sort(batch, op)
            elif isinstance(op, LimitOp):
                batch = apply_limit(batch, op.k)
            elif isinstance(op, DistinctOp):
                batch = apply_distinct(batch, op.expr)
            elif isinstance(op, AggregateOp):
                batch = aggregate_consume(
                    aggregate_produce(batch, op.spec, self.backend), op.spec)
            else:
                batch = run_record_ops(batch, [op], self.catalog, None,
                                       backend=self.backend)
        return batch

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _ckpt_path(stage_dir: str, sid: int) -> str:
        return os.path.join(stage_dir, f"task-{sid:05d}.done.pkl")

    @staticmethod
    def _job_id(flow: Flow) -> str:
        return hashlib.blake2b(repr(flow).encode(),
                               digest_size=8).hexdigest()


def _atomic_pickle(obj, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(obj, fh)
    os.replace(tmp, path)     # atomic commit — the DONE marker is the file
