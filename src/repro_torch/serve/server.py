"""Concurrent query serving: admission, coalescing, result caching.

WarpFlow's serving tier (paper §4.3) keeps an always-on micro-cluster
answering many clients against the same resident FDbs.  This module adds
the session-server shape on top of :class:`~repro_torch.exec.adhoc.AdHocEngine`:

  * **Admission** — a bounded pending queue.  ``submit`` returns a
    future; when the queue is full it raises :class:`ServerBusy`
    immediately (back-pressure, never unbounded buffering).
  * **Coalescing** — a scheduler thread drains the pending queue each
    tick and groups *compatible* queries (same FDb, same shard set, no
    residual filter, no joins, at most one track refine on one path with
    ≤ 30 packed constraints) into one **multi-query wave batch**: Q queries ride a single ``run_wave_fused_multi`` dispatch
    per wave, so the whole group costs ⌈shards/wave⌉ device dispatches
    *total* instead of Q×⌈shards/wave⌉.  Queries that do not fit the
    coalesced shape — residual filters, joins, multi-refine plans —
    simply fall through to the engine's single-query path; incompatible
    never means error.
  * **Caching** — a keyed TTL result + postings cache
    (:class:`~repro_torch.serve.result_cache.ResultCache`).  Every cache call
    is wrapped: a broken or fault-injected cache degrades the server to
    recomputation, it never fails a query.

**Concurrency model.**  One condition variable guards the pending deque,
the closed flag, and the stat counters.  ``submit`` (any client thread)
appends under it and raises :class:`ServerBusy` at ``max_pending``; the
daemon scheduler thread drains it each tick (a short
``tick_s`` sleep lets near-simultaneous submits join one batch), or
``run_pending()`` drains synchronously on the caller for deterministic
coalescing.  Execution never holds the lock: each batch plans its
queries, then runs groups through the engine's worker pool.

**Live sources.**  Every query plans against the source's current
snapshot and executes against that pin (``Plan.db``) — appends landing
between coalesced waves can never tear a result across generations; a
query sees either the pre-append or the post-append view, whole.  The
first time a batch touches a source registered live in the catalog
(a :class:`~repro_torch.fdb.streaming.StreamingFDb`), the server wires the
streaming mutation hook into its cache
(:meth:`~repro_torch.fdb.streaming.StreamingFDb.bind_cache`): an append both
bumps the cache's generation token and sweeps the stale snapshot's
entries, so a pre-append cached result is never served after the hook
fires — even within the old entry's TTL.

Each coalesced query's rows are byte-identical to what the single-query
path produces — the multi-query ops sit behind the same
:class:`~repro_torch.exec.backend.ExecBackend` parity seam, with the numpy
base class as the loop-over-queries oracle.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from types import SimpleNamespace
from typing import Dict, List, Optional

from ..core.flow import AggregateOp, Flow, JoinOp
from ..core.planner import Plan, plan_flow
from ..exec.adhoc import AdHocEngine, QueryProfile, QueryResult
from ..exec.backend import ExecBackend
from ..exec.batched import (fused_enabled, partition_waves,
                            resolve_partition_plan)
from ..exec.processors import aggregate_produce_batched, run_record_ops
from ..exec.task import ShardPartial
from ..fdb.index import mask_from_bitmap
from .result_cache import ResultCache

__all__ = ["QueryServer", "ServerBusy"]


class ServerBusy(RuntimeError):
    """Admission queue full — the client should back off and retry."""


class _Pending:
    __slots__ = ("flow", "future", "plan", "key", "cache_key")

    def __init__(self, flow: Flow, future: Future):
        self.flow = flow
        self.future = future
        self.plan: Optional[Plan] = None
        self.key = None                    # coalescing compatibility key
        self.cache_key = None


class QueryServer:
    """Session server: bounded admission + coalescing scheduler + cache.

    ``cache`` is a :class:`ResultCache`, ``None`` for the default one, or
    ``False`` to serve uncached.  ``max_coalesce`` bounds the query axis
    of one multi-query dispatch; ``max_pending`` bounds admission.
    """

    def __init__(self, engine: Optional[AdHocEngine] = None,
                 catalog=None, backend=None, *,
                 config=None,
                 max_pending: int = 64, max_coalesce: int = 16,
                 cache=None, tick_s: float = 0.001, start: bool = True):
        if engine is None:
            engine = AdHocEngine(catalog=catalog, backend=backend,
                                 config=config)
        self.engine = engine
        self.max_pending = int(max_pending)
        self.max_coalesce = max(1, int(max_coalesce))
        self.tick_s = float(tick_s)
        self.cache = (ResultCache() if cache is None
                      else (cache or None))
        self._cv = threading.Condition()
        self._pending: "deque[_Pending]" = deque()
        self._closed = False
        self._watched: set = set()      # live sources wired into the cache
        self._stats = {"admitted": 0, "rejected": 0, "served": 0,
                       "coalesced_queries": 0, "coalesced_batches": 0,
                       "fallback_queries": 0, "cache_hits": 0,
                       "cache_errors": 0}
        self._thread = threading.Thread(target=self._loop,
                                        name="repro-serve-scheduler",
                                        daemon=True)
        if start:
            self._thread.start()

    # ------------------------------------------------------------- public
    def submit(self, flow: Flow) -> Future:
        """Admit ``flow``; returns a future resolving to its
        :class:`QueryResult`.  Raises :class:`ServerBusy` when the
        pending queue is at capacity."""
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("QueryServer is closed")
            if len(self._pending) >= self.max_pending:
                self._stats["rejected"] += 1
                raise ServerBusy(
                    f"admission queue full ({self.max_pending} pending)")
            self._pending.append(_Pending(flow, fut))
            self._stats["admitted"] += 1
            self._cv.notify()
        return fut

    def collect(self, flow: Flow, timeout: Optional[float] = None
                ) -> QueryResult:
        """Blocking convenience: ``submit(flow).result(timeout)``."""
        return self.submit(flow).result(timeout)

    def run_pending(self) -> int:
        """Drain and serve everything pending, synchronously, on the
        calling thread.  With ``start=False`` this makes coalescing
        deterministic — submit Q queries, then serve them as one batch —
        which is what the launch-contract tests and the serve benchmark
        rely on."""
        with self._cv:
            batch = list(self._pending)
            self._pending.clear()
        if batch:
            self._serve_batch(batch)
        return len(batch)

    def stats(self) -> Dict[str, int]:
        with self._cv:
            out = dict(self._stats)
            out["pending"] = len(self._pending)
        if self.cache is not None:
            try:
                out["cache"] = self.cache.stats()
            except Exception:
                pass
        return out

    def close(self, timeout: float = 10.0) -> None:
        """Stop admitting, drain in-flight work, join the scheduler."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout)

    def __enter__(self) -> "QueryServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------- scheduler
    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait(timeout=0.25)
                if not self._pending:
                    if self._closed:
                        return
                    continue
                batch = list(self._pending)
                self._pending.clear()
            # a short tick lets near-simultaneous submits join this batch
            if self.tick_s > 0 and len(batch) < self.max_coalesce:
                time.sleep(self.tick_s)
                with self._cv:
                    while self._pending and len(batch) < 4 * self.max_coalesce:
                        batch.append(self._pending.popleft())
            try:
                self._serve_batch(batch)
            except Exception as e:                 # defensive: never die
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(e)

    def _serve_batch(self, batch: List[_Pending]) -> None:
        groups: Dict[tuple, List[_Pending]] = {}
        singles: List[_Pending] = []
        for p in batch:
            try:
                p.plan = plan_flow(p.flow, self.engine.catalog)
            except Exception as e:
                p.future.set_exception(e)
                continue
            self._watch_live(p.plan.source)
            if self._cache_get(p):
                continue
            p.key = self._compat_key(p.plan)
            if p.key is None:
                singles.append(p)
            else:
                groups.setdefault(p.key, []).append(p)
        for key, grp in groups.items():
            for i in range(0, len(grp), self.max_coalesce):
                chunk = grp[i:i + self.max_coalesce]
                if len(chunk) == 1:
                    singles.extend(chunk)
                    continue
                try:
                    self._run_group(chunk)
                except Exception:
                    # coalesced execution is an optimization, never a
                    # correctness risk: re-run each query solo
                    singles.extend(c for c in chunk if not c.future.done())
        for p in singles:
            self._run_single(p)

    def _run_single(self, p: _Pending) -> None:
        try:
            res = self.engine.collect(p.flow)
            self._cache_put(p, res)
            # stats land before the future resolves, so a client that has
            # its result also sees it counted
            with self._cv:
                self._stats["fallback_queries"] += 1
                self._stats["served"] += 1
            p.future.set_result(res)
        except Exception as e:
            p.future.set_exception(e)

    def _watch_live(self, source: str) -> None:
        """First touch of a live (streaming) source: wire its mutation
        hook into this server's cache, so appends invalidate eagerly."""
        if self.cache is None or source in self._watched:
            return
        self._watched.add(source)
        try:
            live = getattr(self.engine.catalog, "live", None)
            sdb = live(source) if live is not None else None
            if sdb is not None:
                sdb.bind_cache(self.cache)
        except Exception:
            with self._cv:
                self._stats["cache_errors"] += 1

    # -------------------------------------------------------- coalescing
    @staticmethod
    def _compat_key(plan: Plan):
        """Grouping key for plans one multi-query dispatch can carry, or
        ``None`` (single-query path).  Residual filters need host work
        before selection completes, joins need a recursive broadcast
        collect; multi-refine and over-budget constraint sets exceed the
        kernel's packed table.  The pinned snapshot's identity is part of
        the key: two queries planned astride a streaming append must not
        share one dispatch over mixed generations."""
        if plan.residual is not None or \
                any(isinstance(op, JoinOp) for op in plan.server_ops):
            return None
        if len(plan.refines) > 1:
            return None
        refine_path = None
        if plan.refines:
            rf = plan.refines[0]
            if not (1 <= len(rf.constraints) <= 30):
                return None
            refine_path = rf.path
        return (plan.source, id(plan.db), tuple(plan.shard_ids),
                refine_path)

    def _probe_bitmaps(self, db, plan: Plan, sid: int, shard):
        """Host probe bitmaps for one (plan, shard) — served from the
        postings cache when possible."""
        key = None
        if self.cache is not None:
            try:
                key = self.cache.key_for(
                    db, SimpleNamespace(source=plan.source,
                                        probes=plan.probes),
                    kind="postings", extra=(sid,))
                hit = self.cache.get("postings", key)
                if hit is not None:
                    return list(hit)
            except Exception:
                with self._cv:
                    self._stats["cache_errors"] += 1
                key = None
        bms = [p.run(shard) for p in plan.probes]
        if key is not None:
            try:
                self.cache.put("postings", key, list(bms))
            except Exception:
                with self._cv:
                    self._stats["cache_errors"] += 1
        return bms

    @staticmethod
    def _select_wave(backend, shards, probes, refine):
        """Per-primitive selection for one query over one wave — the
        never-declining fallback when the multi dispatch declines."""
        bms = backend.probe_shards([sh.all_bitmap() for sh in shards],
                                   probes)
        masks = [mask_from_bitmap(bm, sh.n) for bm, sh in zip(bms, shards)]
        n_cands = [int(m.sum()) for m in masks]
        if refine is not None:
            masks = backend.refine_tracks_batched(
                [sh.batch for sh in shards], refine.path,
                refine.constraints, masks, edges=refine.edges,
                min_counts=getattr(refine, "min_counts", None),
                dwells=getattr(refine, "dwells", None))
        return n_cands, backend.compact_masks(masks)

    def _run_group(self, chunk: List[_Pending]) -> None:
        """Q compatible queries through shared waves: one multi-query
        fused dispatch per wave, then per-query gather + mixer tails.
        The selection dispatch stays one launch per wave; the per-(query,
        shard) gather tails fan out over the engine's server slots (they
        dominate wall time otherwise — the single-query path gets the
        same parallelism from its per-wave worker threads)."""
        engine = self.engine
        backend = engine.backend
        plans = [p.plan for p in chunk]
        # execute against the snapshot pinned at plan time — a streaming
        # append between planning and this wave must not swap the data
        db = plans[0].db if plans[0].db is not None \
            else engine.catalog.get(plans[0].source)
        backend.prime_fdb(db)
        shard_ids = list(plans[0].shard_ids)
        # the coalesced dispatch rides the same partition layer as the
        # single-query engines: waves form *within* each partition and
        # dispatch under its partition context, so Q coalesced queries
        # cost sum over partitions of ceil(shards_p/wave) multi
        # dispatches.  The per-query tails below gather host-side, so
        # this path keeps the host AggPartial merge (partition-invariant
        # — partials are assembled in shard-id order per query).
        pplan = resolve_partition_plan(getattr(engine, "partitions", None),
                                       backend, plans[0])
        subs = []
        for pi, part in enumerate(pplan.parts):
            pw = partition_waves(part, engine.wave)
            for j, w in enumerate(pw):
                subs.append((pi, w, pw[j + 1] if j + 1 < len(pw)
                             else None))
        refines = [pl.refines[0] if pl.refines else None for pl in plans]
        grant = engine.catalog.resources.acquire(
            min(max(len(shard_ids), 1), engine.num_servers))
        t0 = time.perf_counter()

        def gather_tail(pl, qi, sid, sh, ids, n_cand):
            paths = [c for c in pl.source_paths
                     if c in sh.batch.columns] or sh.batch.paths()
            # the coalesced tail issues Q×S *small* gathers; the host
            # gather is byte-identical by the seam contract (selection by
            # row index) and its cost is linear in gathered bytes, not in
            # per-call device-dispatch overhead
            gb = ExecBackend.gather_columns(backend, sh.batch, paths, ids)
            part = ShardPartial(shard_id=sid, rows_scanned=sh.n,
                                rows_selected=n_cand,
                                bytes_read=gb.nbytes())
            return (qi, sid), (part, gb)

        tail_futs = []
        try:
            with ThreadPoolExecutor(max_workers=grant) as pool:
                for pi, wave_sids, nxt in subs:
                    shards = [db.shards[s] for s in wave_sids]
                    probes_multi = [
                        [self._probe_bitmaps(db, pl, sid, sh)
                         for sid, sh in zip(wave_sids, shards)]
                        for pl in plans]
                    pre = [db.shards[s] for s in nxt] if nxt else None
                    out = None
                    cfg = getattr(self.engine, "config", None)
                    if fused_enabled(cfg.fused if cfg is not None
                                     else None) \
                            and getattr(backend, "batched_dispatch",
                                        False):
                        with backend.partition_context(
                                pi, pplan.num_partitions):
                            out = backend.run_wave_fused_multi(
                                shards, probes_multi, refines,
                                prefetch_shards=pre)
                    if out is None:
                        out = [self._select_wave(backend, shards, probes,
                                                 rf)
                               for probes, rf in zip(probes_multi,
                                                     refines)]
                    # wave k's gathers overlap wave k+1's dispatch
                    for qi, (pl, (n_cands, ids_list)) in enumerate(
                            zip(plans, out)):
                        for sid, sh, ids, n_cand in zip(wave_sids, shards,
                                                        ids_list, n_cands):
                            tail_futs.append(pool.submit(
                                gather_tail, pl, qi, sid, sh, ids, n_cand))
                by_key = dict(f.result() for f in tail_futs)
        finally:
            engine.catalog.resources.release(grant)
        per_query = [[by_key[(qi, sid)] for sid in shard_ids]
                     for qi in range(len(plans))]

        results = []
        for p, pl, pairs in zip(chunk, plans, per_query):
            parts = [part for part, _ in pairs]
            batches = [run_record_ops(gb, pl.server_ops, engine.catalog,
                                      None, backend=backend)
                       for _, gb in pairs]
            if pl.mixer_ops and isinstance(pl.mixer_ops[0], AggregateOp):
                aggs = aggregate_produce_batched(
                    batches, pl.mixer_ops[0].spec, backend)
                for part, agg in zip(parts, aggs):
                    part.agg = agg
            else:
                for part, gb in zip(parts, batches):
                    part.batch = gb
            profile = QueryProfile(source=pl.source,
                                   shards_total=len(shard_ids),
                                   shards_done=len(parts))
            for part in parts:
                profile.rows_scanned += part.rows_scanned
                profile.rows_selected += part.rows_selected
                profile.bytes_read += part.bytes_read
            batch = engine._mixer(pl, parts, profile)
            profile.exec_ms = (time.perf_counter() - t0) * 1e3
            engine.profile_log.append(profile.record())
            results.append((p, QueryResult(batch, profile, pl)))
        # every query finalized — count the batch, then resolve futures,
        # so a client that has its result also sees it counted
        with self._cv:
            self._stats["coalesced_batches"] += 1
            self._stats["coalesced_queries"] += len(results)
            self._stats["served"] += len(results)
        for p, res in results:
            self._cache_put(p, res)
            p.future.set_result(res)

    # ------------------------------------------------------------- cache
    def _cache_get(self, p: _Pending) -> bool:
        if self.cache is None:
            return False
        try:
            db = p.plan.db if p.plan.db is not None \
                else self.engine.catalog.get(p.plan.source)
            p.cache_key = self.cache.key_for(db, p.plan, kind="result")
            hit = self.cache.get("result", p.cache_key)
        except Exception:
            with self._cv:
                self._stats["cache_errors"] += 1
            p.cache_key = None
            return False
        if hit is None:
            return False
        with self._cv:
            self._stats["cache_hits"] += 1
            self._stats["served"] += 1
        p.future.set_result(hit)
        return True

    def _cache_put(self, p: _Pending, res: QueryResult) -> None:
        if self.cache is None:
            return
        try:
            if p.cache_key is None:
                db = p.plan.db if p.plan.db is not None \
                    else self.engine.catalog.get(p.plan.source)
                p.cache_key = self.cache.key_for(db, p.plan, kind="result")
            self.cache.put("result", p.cache_key, res)
        except Exception:
            with self._cv:
                self._stats["cache_errors"] += 1
