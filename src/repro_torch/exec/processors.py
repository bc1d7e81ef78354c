"""Stage processors (paper §4.3.6).

"Each stage of a WFL pipeline is internally implemented using *processors*,
such as find processor for find(), map processor for map(), and so on."
Both engines share these: Warp:AdHoc drives them interactively per shard;
Warp:Flume wraps each into a batch-stage function with checkpoints.

Servers evaluate record-parallel processors over their shards' column
batches and emit *partials*; the Mixer merges partials and runs the final
stage (``aggregate_consume``, global sort/limit/distinct).
"""
from __future__ import annotations

import numpy as np
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core.exprs import (AggSpec, CollectedTable, EvalContext, Expr,
                          MakeProto, Val, eval_expr)
from ..core.flow import (AggregateOp, DistinctOp, FilterOp, FlattenOp,
                         JoinOp, LimitOp, MapOp, ModelApplyOp, Op, SortOp,
                         SubFlowOp)
from ..core.sketches import HyperLogLog, hash_values, hll_register_rows
from ..fdb.columnar import Column, ColumnBatch
from ..fdb.fdb import FDb
from ..fdb.index import ids_from_bitmap
from ..fdb.schema import BOOL, DOUBLE, INT, STRING, Schema
from .backend import as_backend

__all__ = ["val_to_column", "apply_map", "apply_filter", "predicate_mask",
           "apply_flatten",
           "apply_sort", "apply_limit", "apply_distinct", "apply_model",
           "apply_hash_join", "apply_sub_flow", "aggregate_produce",
           "aggregate_produce_batched", "merge_agg_partials",
           "aggregate_consume", "partition_by_hash", "AggPartial",
           "run_record_ops"]


# --------------------------------------------------------------------------
# Column/batch helpers
# --------------------------------------------------------------------------

def val_to_column(v: Val, n: int) -> Column:
    if v.table is not None:
        raise TypeError("record-valued expression must be reduced to leaf "
                        "fields before materialization (access .field)")
    vals = v.values
    if vals is None:
        raise TypeError("cannot materialize non-columnar value")
    vals = np.asarray(vals)
    if not v.is_repeated and vals.ndim == 0:
        vals = np.broadcast_to(vals, (n,)).copy()
    return Column(vals, v.splits, v.vocab)


def _dyn_schema(name: str, cols: Dict[str, Column]) -> Schema:
    spec = {}
    for p, c in cols.items():
        if c.vocab is not None:
            t = STRING
        elif c.values.dtype == np.bool_:
            t = BOOL
        elif c.values.dtype.kind in "iu":
            t = INT
        else:
            t = DOUBLE
        spec[p] = (t, c.is_repeated)
    return Schema.dynamic(name, spec)


# --------------------------------------------------------------------------
# Record-parallel processors
# --------------------------------------------------------------------------

def apply_map(batch: ColumnBatch, make: MakeProto) -> ColumnBatch:
    ctx = EvalContext(batch)
    cols = {name: val_to_column(eval_expr(e, ctx), batch.n)
            for name, e in make.fields}
    return ColumnBatch(_dyn_schema(batch.schema.name + "#map", cols), cols,
                       batch.n)


def predicate_mask(batch: ColumnBatch, pred: Expr) -> np.ndarray:
    """Singular predicate → bool row mask [n] (shared by the per-shard
    filter and the wave runner's batched residual compact — one definition
    keeps the paths byte-identical).  Tesseract's exact pass no longer
    routes through here from ``find()``: the planner compiles it to the
    backend's ``refine_tracks`` op; this host evaluation of ``InSpaceTime``
    remains the ``filter()``-path fallback."""
    v = eval_expr(pred, EvalContext(batch))
    if v.is_repeated:
        raise TypeError("filter() predicate must be singular "
                        "(reduce vectors with vsum/vmax/…)")
    mask = np.asarray(v.values, dtype=bool)
    if mask.ndim == 0:
        mask = np.broadcast_to(mask, (batch.n,))
    return mask


def apply_filter(batch: ColumnBatch, pred: Expr,
                 backend=None) -> ColumnBatch:
    mask = predicate_mask(batch, pred)
    return batch.gather(as_backend(backend).compact_mask(mask))


def apply_flatten(batch: ColumnBatch, path: str) -> ColumnBatch:
    target = [p for p in batch.paths()
              if p == path or p.startswith(path + ".")]
    if not target:
        raise KeyError(f"flatten: no columns under {path!r}")
    sp = batch[target[0]].row_splits
    if sp is None:
        raise TypeError(f"flatten: {path!r} is not repeated")
    lens = np.diff(sp)
    n_new = int(sp[-1])
    cols: Dict[str, Column] = {}
    for p in batch.paths():
        c = batch[p]
        if p in target:
            cols[p] = Column(c.values, None, c.vocab)
        elif not c.is_repeated:
            cols[p] = Column(np.repeat(c.values, lens), None, c.vocab)
        else:
            if np.array_equal(c.row_splits, sp):
                cols[p] = Column(c.values, None, c.vocab)
            else:
                raise TypeError(
                    f"flatten: {p!r} is repeated with a different shape")
    return ColumnBatch(_dyn_schema(batch.schema.name + "#flat", cols), cols,
                       n_new)


def apply_sort(batch: ColumnBatch, op: SortOp) -> ColumnBatch:
    v = eval_expr(op.expr, EvalContext(batch))
    order = np.argsort(v.values, kind="stable")
    if op.descending:
        order = order[::-1]
    return batch.gather(order)


def apply_limit(batch: ColumnBatch, k: int) -> ColumnBatch:
    if batch.n <= k:
        return batch
    return batch.gather(np.arange(k))


def apply_distinct(batch: ColumnBatch, expr: Optional[Expr]) -> ColumnBatch:
    if expr is not None:
        v = eval_expr(expr, EvalContext(batch))
        keys = hash_values(v.values, v.vocab)
    else:
        acc = np.zeros(batch.n, dtype=np.uint64)
        for p in batch.paths():
            c = batch[p]
            if c.is_repeated:
                continue
            acc ^= hash_values(c.values, c.vocab) * np.uint64(
                0x9E3779B97F4A7C15)
        keys = acc
    _, first = np.unique(keys, return_index=True)
    return batch.gather(np.sort(first))


def apply_model(batch: ColumnBatch, op: ModelApplyOp) -> ColumnBatch:
    ctx = EvalContext(batch)
    cols = dict(batch.columns)
    ins = {name: np.asarray(eval_expr(e, ctx).values)
           for name, e in op.inputs}
    pred = np.asarray(op.model.apply_columns(ins))
    if pred.shape[0] != batch.n:
        raise ValueError("model output row count mismatch")
    cols[op.output] = Column(pred.astype(np.float64)
                             if pred.dtype.kind == "f" else pred)
    return ColumnBatch(_dyn_schema(batch.schema.name + "#model", cols), cols,
                       batch.n)


# --------------------------------------------------------------------------
# Joins
# --------------------------------------------------------------------------

def apply_hash_join(left: ColumnBatch, right: CollectedTable,
                    left_key: Expr, alias: str) -> ColumnBatch:
    """Inner hash join: left rows × matching right rows (paper Table 1)."""
    lk = eval_expr(left_key, EvalContext(left))
    if lk.is_repeated:
        raise TypeError("join key must be singular")
    rows = right.lookup_rows(np.asarray(lk.values), lk.vocab)
    keep = np.nonzero(rows >= 0)[0]
    lbatch = left.gather(keep)
    rrows = rows[keep]
    cols = dict(lbatch.columns)
    for p, c in right.batch.columns.items():
        cols[f"{alias}.{p}"] = c.gather(rrows)
    return ColumnBatch(_dyn_schema(left.schema.name + "#join", cols), cols,
                       lbatch.n)


def apply_sub_flow(left: ColumnBatch, right_db: FDb, key: Expr,
                   index_path: str, alias: str) -> ColumnBatch:
    """Index join (paper ``sub_flow``): probe the right FDb's tag index per
    key instead of scanning it — one output row per (left row, right doc)."""
    lk = eval_expr(key, EvalContext(left))
    if lk.is_repeated:
        raise TypeError("sub_flow key must be singular")
    keys = np.asarray(lk.values)
    uniq = np.unique(keys)
    left_rows: List[np.ndarray] = []
    right_parts: List[ColumnBatch] = []
    for shard in right_db.shards:
        idx = shard.index(index_path, "tag")
        if idx is None:
            raise RuntimeError(f"sub_flow: no tag index on "
                               f"{right_db.name}.{index_path}")
        for u in uniq:
            u_val = (lk.vocab[int(u)] if lk.vocab is not None else u)
            bm = idx.lookup(u_val)
            ids = ids_from_bitmap(bm, shard.n)
            if ids.size == 0:
                continue
            lrows = np.nonzero(keys == u)[0]
            # cross product left-rows × right-docs
            left_rows.append(np.repeat(lrows, ids.size))
            right_parts.append(shard.batch.gather(
                np.tile(ids, lrows.size)))
    if not left_rows:
        empty_ids = np.zeros(0, dtype=np.int64)
        lbatch = left.gather(empty_ids)
        cols = dict(lbatch.columns)
        for p in right_db.shards[0].batch.paths():
            c = right_db.shards[0].batch[p]
            cols[f"{alias}.{p}"] = c.gather(empty_ids)
        return ColumnBatch(_dyn_schema(left.schema.name + "#subflow", cols),
                           cols, 0)
    lrows_all = np.concatenate(left_rows)
    rbatch = ColumnBatch.concat(right_parts)
    lbatch = left.gather(lrows_all)
    cols = dict(lbatch.columns)
    for p, c in rbatch.columns.items():
        cols[f"{alias}.{p}"] = c
    return ColumnBatch(_dyn_schema(left.schema.name + "#subflow", cols),
                       cols, lbatch.n)


def partition_by_hash(batch: ColumnBatch, key: Expr, num_parts: int
                      ) -> List[ColumnBatch]:
    """Sharder-style hash repartition (paper §4.3.5: "Sharders perform
    intermediate shuffles and joins")."""
    v = eval_expr(key, EvalContext(batch))
    h = hash_values(v.values, v.vocab)
    part = (h % np.uint64(num_parts)).astype(np.int64)
    return [batch.gather(np.nonzero(part == i)[0]) for i in range(num_parts)]


# --------------------------------------------------------------------------
# Distributed aggregation (aggregate_produce / aggregate_consume, §4.3.4)
# --------------------------------------------------------------------------

@dataclass
class AggPartial:
    """Mergeable per-shard aggregation state."""
    groups: Dict[tuple, List[Any]] = dc_field(default_factory=dict)


def _group_codes(key_arrays: List[np.ndarray], n: int
                 ) -> Tuple[np.ndarray, List[tuple]]:
    """Factorize per-row key tuples → (codes [n] int64, unique key tuples).

    The integer codes are what the segment-aggregation backends consume
    (the CUDA ``segment_agg`` kernel runs over group codes).
    """
    if not key_arrays:
        if n == 0:
            return np.zeros(0, dtype=np.int64), []
        return np.zeros(n, dtype=np.int64), [()]
    # integer-like keys only: np.unique would collapse float NaN keys into
    # one group, unlike dict identity (NaN != NaN → one group per row)
    if len(key_arrays) == 1 and key_arrays[0].dtype.kind in "biu":
        uniq, inv = np.unique(key_arrays[0], return_inverse=True)
        return (inv.reshape(-1).astype(np.int64),
                [(v,) for v in uniq.tolist()])
    mapping: Dict[tuple, int] = {}
    codes = np.empty(n, dtype=np.int64)
    for i, k in enumerate(zip(*(a.tolist() for a in key_arrays))):
        codes[i] = mapping.setdefault(k, len(mapping))
    return codes, list(mapping)


@dataclass
class _AggPrep:
    """Host-side per-shard aggregation state, ready for segment dispatch.

    Splitting ``aggregate_produce`` into prepare → segment → finalize lets
    the wave runner batch the segment dispatch across shards (one kernel
    launch per wave) while the per-shard path keeps its original shape.
    """
    codes: np.ndarray                       # int64 [n], group code per row
    uniq_keys: List[tuple]
    counts: np.ndarray                      # int64 [n_groups]
    vals_list: List[Optional[np.ndarray]]   # per agg, None for count
    vocabs: List[Optional[list]]
    seg_arrays: List[np.ndarray]            # distinct columns needing (s,s2)
    seg_slot: List[Optional[int]]           # per agg → index into seg_arrays

    @property
    def n_groups(self) -> int:
        return len(self.uniq_keys)


def _agg_prepare(batch: ColumnBatch, spec: AggSpec) -> Optional[_AggPrep]:
    """Evaluate keys and agg inputs; None when the shard has no groups."""
    ctx = EvalContext(batch)
    key_arrays: List[np.ndarray] = []
    for _, e in spec.keys:
        v = eval_expr(e, ctx)
        if v.is_repeated:
            raise TypeError("group key must be singular")
        vals = np.asarray(v.values)
        if v.vocab is not None:
            vals = np.asarray(v.vocab, dtype=object)[vals]
        key_arrays.append(vals)
    codes, uniq_keys = _group_codes(key_arrays, batch.n)
    if not uniq_keys:
        return None
    counts = np.bincount(codes, minlength=len(uniq_keys))

    vals_list: List[Optional[np.ndarray]] = []
    vocabs: List[Optional[list]] = []
    eval_cache: Dict[str, Tuple[np.ndarray, Optional[list]]] = {}
    for kind, name, e in spec.aggs:
        if e is None:
            vals_list.append(None)
            vocabs.append(None)
            continue
        ekey = repr(e)     # avg+std_dev over the same expr share one eval
        if ekey not in eval_cache:
            v = eval_expr(e, ctx)
            if v.is_repeated:
                raise TypeError(f"aggregate input {name!r} must be singular")
            arr = np.asarray(v.values)
            if arr.ndim == 0:
                arr = np.broadcast_to(arr, (batch.n,))
            eval_cache[ekey] = (arr, v.vocab)
        arr, voc = eval_cache[ekey]
        vals_list.append(arr)
        vocabs.append(voc)

    # count/sum/sumsq route through the backend's segment aggregation
    # (numpy bincount, or the segment_agg kernel via kernels.ops); order
    # statistics and sketches need per-group row sets and stay on host.
    # One dispatch slot per distinct value column, not per agg.
    seg_arrays: List[np.ndarray] = []
    slot_by_id: Dict[int, int] = {}
    seg_slot: List[Optional[int]] = []
    for (kind, _, _), arr in zip(spec.aggs, vals_list):
        if kind in ("sum", "avg", "std_dev"):
            if id(arr) not in slot_by_id:
                slot_by_id[id(arr)] = len(seg_arrays)
                seg_arrays.append(arr)
            seg_slot.append(slot_by_id[id(arr)])
        else:
            seg_slot.append(None)
    return _AggPrep(codes, uniq_keys, counts, vals_list, vocabs,
                    seg_arrays, seg_slot)


def _agg_finalize(prep: _AggPrep, spec: AggSpec,
                  seg_results: List[Tuple[np.ndarray, np.ndarray]],
                  backend=None) -> AggPartial:
    """(s, s2) per segment slot + host order stats/sketches → AggPartial."""
    codes, counts, n_groups = prep.codes, prep.counts, prep.n_groups
    rows_by_group: Optional[List[np.ndarray]] = None

    def _rows() -> List[np.ndarray]:
        nonlocal rows_by_group
        if rows_by_group is None:
            order = np.argsort(codes, kind="stable")
            bounds = np.zeros(n_groups + 1, dtype=np.int64)
            np.cumsum(counts, out=bounds[1:])
            rows_by_group = [order[bounds[g]:bounds[g + 1]]
                             for g in range(n_groups)]
        return rows_by_group

    per_agg: List[List[Any]] = []
    for (kind, name, e), arr, voc, slot in zip(spec.aggs, prep.vals_list,
                                               prep.vocabs, prep.seg_slot):
        if kind == "count":
            per_agg.append([int(c) for c in counts])
        elif kind in ("sum", "avg", "std_dev"):
            s, s2 = seg_results[slot]
            if kind == "sum":
                per_agg.append([float(x) for x in s])
            elif kind == "avg":
                per_agg.append([(float(x), int(c))
                                for x, c in zip(s, counts)])
            else:
                per_agg.append([(float(x), float(y), int(c))
                                for x, y, c in zip(s, s2, counts)])
        elif kind == "min":
            per_agg.append([float(arr[r].min()) for r in _rows()])
        elif kind == "max":
            per_agg.append([float(arr[r].max()) for r in _rows()])
        elif kind == "approx_distinct":
            # grouped sketch build as ONE segment-max through the backend
            # seam: per-row (register index, rank) pairs scatter-max into
            # per-group register planes — byte-equal to building each
            # group's HyperLogLog from its row set, and partition-
            # invariant because register max is commutative + idempotent
            hll_p = HyperLogLog().p
            idx, rank = hll_register_rows(hash_values(arr, voc), hll_p)
            regs = as_backend(backend).segment_hll(
                codes, idx, rank, n_groups, 1 << hll_p)
            per_agg.append([HyperLogLog(hll_p, regs[g].copy())
                            for g in range(n_groups)])
        else:
            raise ValueError(kind)

    part = AggPartial()
    for g, k in enumerate(prep.uniq_keys):
        part.groups[k] = [col[g] for col in per_agg]
    return part


def aggregate_produce(batch: ColumnBatch, spec: AggSpec,
                      backend=None) -> AggPartial:
    backend = as_backend(backend)
    prep = _agg_prepare(batch, spec)
    if prep is None:
        return AggPartial()
    seg_results = []
    for arr in prep.seg_arrays:
        _, s, s2 = backend.segment_aggregate(prep.codes, arr, prep.n_groups)
        seg_results.append((s, s2))
    return _agg_finalize(prep, spec, seg_results, backend=backend)


def aggregate_produce_batched(batches: Sequence[ColumnBatch], spec: AggSpec,
                              backend=None) -> List[AggPartial]:
    """Per-shard partials for a wave with one segment dispatch per value
    column across the whole wave (instead of one per shard) — byte-equal
    to running :func:`aggregate_produce` shard by shard."""
    backend = as_backend(backend)
    preps = [_agg_prepare(b, spec) for b in batches]
    live = [p for p in preps if p is not None]
    n_slots = len(live[0].seg_arrays) if live else 0
    seg_by_prep: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {
        id(p): [] for p in live}
    for slot in range(n_slots):
        results = backend.segment_aggregate_batched(
            [p.codes for p in live],
            [p.seg_arrays[slot] for p in live],
            [p.n_groups for p in live])
        for p, (_, s, s2) in zip(live, results):
            seg_by_prep[id(p)].append((s, s2))
    return [AggPartial() if p is None
            else _agg_finalize(p, spec, seg_by_prep[id(p)], backend=backend)
            for p in preps]


def merge_agg_partials(parts: Sequence[AggPartial], spec: AggSpec
                       ) -> AggPartial:
    out = AggPartial()
    for p in parts:
        for k, accs in p.groups.items():
            if k not in out.groups:
                out.groups[k] = [a if not isinstance(a, HyperLogLog)
                                 else HyperLogLog(a.p, a.registers.copy())
                                 for a in accs]
                continue
            cur = out.groups[k]
            for i, (kind, name, e) in enumerate(spec.aggs):
                if kind == "count":
                    cur[i] += accs[i]
                elif kind == "sum":
                    cur[i] += accs[i]
                elif kind == "avg":
                    cur[i] = (cur[i][0] + accs[i][0], cur[i][1] + accs[i][1])
                elif kind == "std_dev":
                    cur[i] = (cur[i][0] + accs[i][0],
                              cur[i][1] + accs[i][1],
                              cur[i][2] + accs[i][2])
                elif kind == "min":
                    cur[i] = min(cur[i], accs[i])
                elif kind == "max":
                    cur[i] = max(cur[i], accs[i])
                elif kind == "approx_distinct":
                    cur[i].merge(accs[i])
    return out


def aggregate_consume(part: AggPartial, spec: AggSpec) -> ColumnBatch:
    """Finish accumulators → output batch (runs on the Mixer)."""
    keys = sorted(part.groups.keys(), key=lambda t: tuple(map(str, t)))
    n = len(keys)
    cols: Dict[str, Column] = {}
    for j, (name, _) in enumerate(spec.keys):
        col_vals = [k[j] for k in keys]
        if col_vals and isinstance(col_vals[0], str):
            cols[name] = Column.from_strings(col_vals)
        else:
            cols[name] = Column(np.asarray(col_vals))
    for i, (kind, name, e) in enumerate(spec.aggs):
        accs = [part.groups[k][i] for k in keys]
        if kind == "count":
            cols[name] = Column(np.asarray(accs, dtype=np.int64))
        elif kind in ("sum", "min", "max"):
            cols[name] = Column(np.asarray(accs, dtype=np.float64))
        elif kind == "avg":
            cols[name] = Column(np.asarray(
                [s / max(c, 1) for s, c in accs], dtype=np.float64))
        elif kind == "std_dev":
            out = []
            for s, s2, c in accs:
                m = s / max(c, 1)
                out.append(np.sqrt(max(s2 / max(c, 1) - m * m, 0.0)))
            cols[name] = Column(np.asarray(out, dtype=np.float64))
        elif kind == "approx_distinct":
            cols[name] = Column(np.asarray([h.estimate() for h in accs],
                                           dtype=np.float64))
    return ColumnBatch(_dyn_schema("agg", cols), cols, n)


# --------------------------------------------------------------------------
# Server-side record pipeline
# --------------------------------------------------------------------------

def run_record_ops(batch: ColumnBatch, ops: Sequence[Op], catalog,
                   collected_cache: Optional[Dict[int, CollectedTable]] = None,
                   backend=None) -> ColumnBatch:
    """Run record-parallel ops on one shard's (already index-selected) batch."""
    for op in ops:
        if isinstance(op, MapOp):
            batch = apply_map(batch, op.make)
        elif isinstance(op, FilterOp):
            batch = apply_filter(batch, op.pred, backend)
        elif isinstance(op, FlattenOp):
            batch = apply_flatten(batch, op.path)
        elif isinstance(op, ModelApplyOp):
            batch = apply_model(batch, op)
        elif isinstance(op, JoinOp):
            table = collected_cache[id(op)] if collected_cache else None
            if table is None:
                raise RuntimeError("join table missing from broadcast cache")
            batch = apply_hash_join(batch, table, op.left_key, op.alias)
        elif isinstance(op, SubFlowOp):
            batch = apply_sub_flow(batch, catalog.get(op.right_fdb), op.key,
                                   op.index_path, op.alias)
        else:
            raise TypeError(f"non-record op on server: {type(op).__name__}")
    return batch
