"""Read-write (streaming) FDb (paper §4.1.1) with LSM-style delta shards.

The paper implements read-write FDbs on Bigtable "for streaming FDbs,
including for query profiling and data ingestion logs".  We reproduce the
abstraction on the same key-value contract, extended to first-class live
ingestion (ROADMAP Open item 3; CheetahGIS is the reference architecture):

  * **memtable** — raw appended records.  ``append``/``extend`` buffer
    here; crossing ``flush_threshold`` triggers a flush.
  * **delta shards** — each flush freezes one memtable chunk into an
    immutable :class:`~repro_torch.fdb.fdb.Shard` and builds that shard's
    indexes — tag/range/area *and* ``spacetime`` postings — right there,
    **incrementally**: ingesting new data never re-indexes sealed data.
  * **sealed shards** — an LSM-style compaction policy: once
    ``compact_threshold`` small delta shards accumulate, they merge
    (``ColumnBatch.concat`` + one index build) into a single larger
    sealed shard.  Compaction preserves row order (sealed = deltas in
    flush order), so reader views stay byte-stable across a compaction.
    ``compact_threshold=0`` disables the policy (useful when delta
    shards should stay time-partitioned, e.g. for shard-pruning demos);
    :meth:`compact` forces a merge on demand.

    The merge runs on a **background worker**, never on the appending
    thread: crossing the threshold signals a lazily-started daemon, the
    expensive concat + index build happens outside the writer lock, and
    the result commits under the lock by replacing exactly the delta
    prefix it merged — appends land freely during the merge (asserted by
    ``tests/test_streaming.py::test_appends_never_block_on_compaction``).
    ``compact_async=False`` restores the legacy inline-at-flush merge;
    :meth:`drain_compaction` blocks until the policy is satisfied (tests
    and shutdown), :meth:`close` stops the worker.

**Concurrency model.**  All mutation and snapshot state is guarded by one
re-entrant lock; writers (any number of threads) serialize on it, so no
append is lost and a flush boundary never tears a record.  Readers never
hold the lock across query execution: :meth:`snapshot` materializes an
immutable :class:`~repro_torch.fdb.fdb.FDb` view (sealed + delta shards + the
memtable as a tail shard) and hands it out.  Snapshots are cached per
**generation** — a counter bumped by every mutation — so repeated reads
of an unchanged FDb return the *same object*: downstream identity-keyed
machinery (the torch backend's device-buffer priming, the serve tier's
``ResultCache`` FDb tokens) sees one stable identity per generation, and
a query plan that pins its snapshot (``Plan.db``) is immune to appends
landing mid-query — it reads either the pre-append or the post-append
view, never a torn mix.

**Invalidation hook.**  :meth:`add_listener` registers a callback invoked
after every mutation with the now-stale snapshot (the generation readers
may still hold keys against); :meth:`bind_cache` wires that straight into
:meth:`repro_torch.serve.result_cache.ResultCache.invalidate`, so a live
``QueryServer`` can never serve a pre-append cached result once the hook
fires.  Listeners run outside the lock and their errors are swallowed —
ingestion never fails because an observer did.

WarpFlow itself uses this class for its query-profiling log (exec.adhoc
writes one record per query stage).
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence

from .columnar import ColumnBatch
from .fdb import FDb, Shard, _build_shard_indexes
from .schema import Schema

__all__ = ["StreamingFDb"]


class StreamingFDb:
    def __init__(self, name: str, schema: Schema,
                 flush_threshold: int = 4096,
                 compact_threshold: int = 8,
                 compact_async: bool = True):
        self.name = name
        self.schema = schema
        self.flush_threshold = int(flush_threshold)
        #: delta-shard count that triggers an automatic merge into one
        #: sealed shard; 0 disables auto-compaction
        self.compact_threshold = int(compact_threshold)
        #: run threshold-triggered merges on the background worker; False
        #: restores the legacy inline merge on the flushing thread
        self.compact_async = bool(compact_async)
        self._memtable: List[dict] = []
        self._sealed: List[Shard] = []       # large compacted shards
        self._delta: List[Shard] = []        # small recent flushed shards
        self._lock = threading.RLock()
        self._generation = 0
        self._snap: Optional[tuple] = None   # (generation, FDb) cache
        self._listeners: List[Callable[[FDb], None]] = []
        self._compactions = 0
        #: serializes merges (background worker vs forced ``compact()``);
        #: held across the whole merge, while ``_lock`` is only held for
        #: the short prefix-snapshot and commit sections
        self._merge_lock = threading.Lock()
        self._compact_event: Optional[threading.Event] = None
        self._compact_thread: Optional[threading.Thread] = None
        self._closed = False
        #: test seam: called at merge start (outside the writer lock) —
        #: the slow-compaction test injects a sleep here to prove appends
        #: never block on a merge
        self._compact_hook: Optional[Callable[[], None]] = None

    # ----------------------------------------------------------- internals
    @property
    def _shards(self) -> List[Shard]:
        """Flushed shards, sealed-first (back-compat view for tests)."""
        with self._lock:
            return self._sealed + self._delta

    def _stale_snap_locked(self) -> Optional[FDb]:
        """The snapshot a mutation is about to invalidate, if one is
        current (readers may hold cache keys against it)."""
        if self._snap is not None and self._snap[0] == self._generation:
            return self._snap[1]
        return None

    def _notify(self, stale: Optional[FDb]) -> None:
        """Fire mutation listeners (outside the lock) with the now-stale
        snapshot.  Observer failures never fail ingestion."""
        if stale is None:
            return
        for fn in list(self._listeners):
            try:
                fn(stale)
            except Exception:
                pass

    # ------------------------------------------------------------- writes
    def append(self, record: dict) -> None:
        with self._lock:
            stale = self._stale_snap_locked()
            self._memtable.append(record)
            if len(self._memtable) >= self.flush_threshold:
                self._flush_locked()
            self._generation += 1
        self._notify(stale)

    def extend(self, records: Sequence[dict]) -> None:
        with self._lock:
            stale = self._stale_snap_locked()
            self._memtable.extend(records)
            while len(self._memtable) >= self.flush_threshold:
                self._flush_locked()
            self._generation += 1
        self._notify(stale)

    def flush(self) -> None:
        """Freeze the memtable into a delta shard (incremental index
        build included); no-op on an empty memtable."""
        stale = None
        with self._lock:
            if self._memtable:
                stale = self._stale_snap_locked()
                self._flush_locked()
                self._generation += 1
        self._notify(stale)

    def _flush_locked(self) -> None:
        chunk = self._memtable[:self.flush_threshold]
        self._memtable = self._memtable[self.flush_threshold:]
        batch = ColumnBatch.from_records(self.schema, chunk)
        # incremental indexing: only this delta's postings are built —
        # sealed/older delta shards are untouched
        self._delta.append(Shard(batch,
                                 _build_shard_indexes(self.schema, batch)))
        if self.compact_threshold and \
                len(self._delta) >= self.compact_threshold:
            if self.compact_async:
                self._signal_compactor_locked()
            else:
                self._compact_locked()

    # --------------------------------------------------------- compaction
    def compact(self) -> bool:
        """Merge all delta shards into one sealed shard now (synchronous:
        returns after the merge committed).  The merge itself runs
        outside the writer lock, so concurrent appends still land while
        it builds.  Returns True when a merge happened."""
        return self._merge_delta_prefix(min_deltas=2)

    def _compact_locked(self) -> None:
        """Legacy inline merge (``compact_async=False``): runs under the
        writer lock on the flushing thread."""
        batch = ColumnBatch.concat([sh.batch for sh in self._delta])
        self._sealed.append(Shard(batch,
                                  _build_shard_indexes(self.schema, batch)))
        self._delta = []
        self._compactions += 1

    def _signal_compactor_locked(self) -> None:
        """Wake (lazily starting) the background merge worker.  The
        worker holds only a weakref — a collected StreamingFDb (e.g. a
        per-engine query-profile log) is never pinned by its compactor,
        and the thread exits on its next poll."""
        if self._compact_event is None:
            self._compact_event = threading.Event()
            self._compact_thread = threading.Thread(
                target=_compaction_worker,
                args=(weakref.ref(self), self._compact_event),
                name=f"warpflow-compact-{self.name}", daemon=True)
            self._compact_thread.start()
        self._compact_event.set()

    def _merge_delta_prefix(self, min_deltas: int) -> bool:
        """The merge step both the worker and ``compact()`` run: snapshot
        the current delta list under the lock, build the merged shard
        with NO lock held (appends land meanwhile), then commit under the
        lock by replacing exactly the snapshotted prefix — new deltas
        flushed during the merge only ever *extend* the list, so the
        prefix is stable by construction."""
        with self._merge_lock:
            with self._lock:
                to_merge = list(self._delta)
            if len(to_merge) < min_deltas:
                return False
            if self._compact_hook is not None:
                self._compact_hook()
            batch = ColumnBatch.concat([sh.batch for sh in to_merge])
            merged = Shard(batch,
                           _build_shard_indexes(self.schema, batch))
            with self._lock:
                assert self._delta[:len(to_merge)] == to_merge
                stale = self._stale_snap_locked()
                self._sealed.append(merged)
                del self._delta[:len(to_merge)]
                self._compactions += 1
                self._generation += 1
        self._notify(stale)
        return True

    def _compaction_due_locked(self) -> bool:
        return bool(self.compact_threshold
                    and len(self._delta) >= self.compact_threshold)

    def drain_compaction(self, timeout: float = 10.0) -> None:
        """Block until the compaction policy is satisfied and no merge is
        in flight — the deterministic point tests (and shutdown) wait on
        now that threshold merges happen off the appending thread."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                due = self._compaction_due_locked()
            if not due and not self._merge_lock.locked():
                return
            time.sleep(0.002)
        raise TimeoutError(f"compaction of {self.name!r} did not drain "
                           f"within {timeout}s")

    def close(self) -> None:
        """Stop the background compactor (idempotent).  Pending merges
        are abandoned; data is never lost — deltas simply stay unmerged."""
        with self._lock:
            self._closed = True
            ev = self._compact_event
        if ev is not None:
            ev.set()

    # -------------------------------------------------------------- reads
    def snapshot(self) -> FDb:
        """Immutable read view: sealed + delta shards + memtable as a
        final shard.  Cached per generation — unchanged data returns the
        same ``FDb`` object, so device priming and result-cache tokens
        stay stable between mutations."""
        with self._lock:
            if self._snap is not None and self._snap[0] == self._generation:
                return self._snap[1]
            shards = self._sealed + self._delta
            if self._memtable:
                batch = ColumnBatch.from_records(self.schema, self._memtable)
                shards = shards + [
                    Shard(batch, _build_shard_indexes(self.schema, batch))]
            db = FDb(self.name, self.schema, shards)
            self._snap = (self._generation, db)
            return db

    @property
    def generation(self) -> int:
        """Mutation counter; a snapshot is valid while this is unchanged."""
        with self._lock:
            return self._generation

    @property
    def num_docs(self) -> int:
        with self._lock:
            return (sum(s.n for s in self._sealed)
                    + sum(s.n for s in self._delta) + len(self._memtable))

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"generation": self._generation,
                    "sealed_shards": len(self._sealed),
                    "delta_shards": len(self._delta),
                    "memtable_rows": len(self._memtable),
                    "compactions": self._compactions,
                    "docs": (sum(s.n for s in self._sealed)
                             + sum(s.n for s in self._delta)
                             + len(self._memtable))}

    # ---------------------------------------------------------- listeners
    def add_listener(self, fn: Callable[[FDb], None]) -> None:
        """Register ``fn(stale_snapshot)`` to run after every mutation
        that invalidates a live snapshot."""
        with self._lock:
            self._listeners.append(fn)

    def bind_cache(self, cache) -> None:
        """Invalidate ``cache`` entries keyed on a snapshot whenever new
        data lands — the generation-token hook that keeps a live
        ``QueryServer`` from serving pre-append results."""
        invalidate = getattr(cache, "invalidate", None)
        if invalidate is not None:
            self.add_listener(invalidate)


def _compaction_worker(ref: "weakref.ref[StreamingFDb]",
                       event: threading.Event) -> None:
    """Background merge loop: wait for a threshold signal, merge, repeat.
    Holds the StreamingFDb only through a weakref between polls so the
    owner stays collectable; exits when the owner is collected or closed."""
    while True:
        event.wait(timeout=0.5)
        db = ref()
        if db is None:
            return
        try:
            if db._closed:
                return
            if event.is_set():
                event.clear()
                with db._lock:
                    due = db._compaction_due_locked()
                if due:
                    try:
                        db._merge_delta_prefix(
                            min_deltas=max(2, db.compact_threshold))
                    except Exception:
                        pass   # a failed merge never kills ingestion
        finally:
            del db             # never pin across the idle wait
