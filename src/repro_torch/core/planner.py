"""Query planning (paper §4.3.4).

When a WFL query is submitted, a plan determines (i) which index probes
serve the ``find()`` predicate and what residual must be filtered after the
read, (ii) the minimal viable set of source columns to load (§4.3.3), (iii)
the split between remote (Server) stages, shuffle (Sharder) stages, and the
final Mixer stage, and (iv) the shard subset when sampling.

The planner is shared by both engines: Warp:AdHoc executes the plan
interactively; Warp:Flume translates the same plan into checkpointed batch
stages ("the logical model of data processing is maintained", §4.3).
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..fdb.fdb import FDb, Shard
from ..fdb.schema import Schema
from .exprs import (Between, BinOp, Expr, FieldRef, InRegion, InSet,
                    InSpaceTime, InSpaceTimeSeq, Lit, MakeProto,
                    required_paths)
from .flow import (AggregateOp, DistinctOp, FilterOp, FindOp, Flow,
                   FlattenOp, JoinOp, LimitOp, MapOp, ModelApplyOp, Op,
                   SampleOp, SortOp, SubFlowOp)

__all__ = ["IndexProbe", "RefineSpec", "Plan", "plan_flow",
           "split_find_pred", "probe_shard",
           "PartitionPlan", "partition_shards", "num_partitions",
           "PARTITIONS_ENV"]


# --------------------------------------------------------------------------
# Index probes
# --------------------------------------------------------------------------

@dataclass
class IndexProbe:
    path: str
    kind: str               # tag | range | location | area | spacetime
    args: tuple             # lookup arguments

    #: kinds whose postings are a *superset* of the predicate (cell/bucket
    #: granularity) — the conjunct additionally compiles to a
    #: :class:`RefineSpec`, the exact device-side pass behind the
    #: backend's ``refine_tracks`` op
    REFINE_KINDS = ("spacetime",)

    @property
    def needs_refine(self) -> bool:
        return self.kind in self.REFINE_KINDS

    def run(self, shard: Shard, backend=None) -> np.ndarray:
        """Probe bitmap for this conjunct.  ``backend`` (when given)
        lowers index tails that run behind the exec seam — currently the
        spacetime postings OR + span prune (``postings_bitmap``)."""
        idx = shard.index(self.path, self.kind)
        if idx is None:
            raise RuntimeError(f"missing index {self.kind} on {self.path}")
        if self.kind == "tag":
            vals = self.args[0]
            return idx.lookup_any(vals) if isinstance(vals, tuple) \
                else idx.lookup(vals)
        if self.kind == "range":
            lo, hi = self.args
            return idx.lookup(lo, hi)
        if self.kind == "location":
            return idx.lookup(self.args[0])
        if self.kind == "area":
            return idx.lookup_region(self.args[0])
        if self.kind == "spacetime":
            region, t0, t1 = self.args
            return idx.lookup(region, t0, t1, backend=backend)
        raise ValueError(self.kind)


def _indexable(e: Expr, schema: Schema) -> Optional[IndexProbe]:
    """Match one conjunct against the index vocabulary."""
    if isinstance(e, InRegion):
        f = e.field
        if schema.has(f.path):
            fld = schema.field(f.path)
            if "location" in fld.indexes:
                return IndexProbe(f.path, "location", (e.region,))
            if "area" in fld.indexes:
                return IndexProbe(f.path, "area", (e.region,))
        return None
    if isinstance(e, Between) and isinstance(e.a, FieldRef):
        if schema.has(e.a.path) and "range" in schema.field(e.a.path).indexes:
            return IndexProbe(e.a.path, "range", (e.lo, e.hi))
        return None
    if isinstance(e, BinOp) and e.op in ("eq", "le", "ge", "lt", "gt"):
        fr, lit = None, None
        if isinstance(e.a, FieldRef) and isinstance(e.b, Lit):
            fr, lit, op = e.a, e.b.value, e.op
        elif isinstance(e.b, FieldRef) and isinstance(e.a, Lit):
            flip = {"le": "ge", "ge": "le", "lt": "gt", "gt": "lt",
                    "eq": "eq"}
            fr, lit, op = e.b, e.a.value, flip[e.op]
        else:
            return None
        if not schema.has(fr.path):
            return None
        fld = schema.field(fr.path)
        if op == "eq" and "tag" in fld.indexes:
            return IndexProbe(fr.path, "tag", (lit,))
        if "range" in fld.indexes:
            if op == "eq":
                return IndexProbe(fr.path, "range", (lit, lit))
            if op in ("le", "lt"):
                return IndexProbe(fr.path, "range", (None, lit))
            if op in ("ge", "gt"):
                return IndexProbe(fr.path, "range", (lit, None))
        return None
    if isinstance(e, InSet) and isinstance(e.a, FieldRef):
        if schema.has(e.a.path) and "tag" in schema.field(e.a.path).indexes:
            return IndexProbe(e.a.path, "tag", (tuple(e.values),))
        return None
    if isinstance(e, InSpaceTime) and isinstance(e.field, FieldRef):
        f = e.field
        if schema.has(f.path) and \
                "spacetime" in schema.field(f.path).indexes:
            return IndexProbe(f.path, "spacetime", (e.region, e.t0, e.t1))
        return None
    return None


def _or_leaf_values(e: Expr) -> Optional[Tuple[str, tuple]]:
    """Tag-lookup leaf of a disjunction → (field path, values) or None."""
    if isinstance(e, InSet) and isinstance(e.a, FieldRef):
        return e.a.path, tuple(e.values)
    if isinstance(e, BinOp) and e.op == "eq":
        if isinstance(e.a, FieldRef) and isinstance(e.b, Lit):
            return e.a.path, (e.b.value,)
        if isinstance(e.b, FieldRef) and isinstance(e.a, Lit):
            return e.b.path, (e.a.value,)
    return None


def _indexable_or(e: Expr, schema: Schema) -> Optional[IndexProbe]:
    """Disjunction of tag lookups on one field → ``lookup_any`` bitmap OR.

    ``(p.city == 'SF') | IN(p.city, ['OAK', 'SJ'])`` compiles to one tag
    probe over the union of values — exact (tag postings are exact), so
    nothing is left for the residual filter.
    """
    if not (isinstance(e, BinOp) and e.op == "or"):
        return None
    leaves: List[Expr] = []

    def walk(x: Expr):
        if isinstance(x, BinOp) and x.op == "or":
            walk(x.a)
            walk(x.b)
        else:
            leaves.append(x)

    walk(e)
    path: Optional[str] = None
    values: List[Any] = []
    for leaf in leaves:
        got = _or_leaf_values(leaf)
        if got is None:
            return None
        p, vs = got
        if path is None:
            path = p
        elif path != p:
            return None               # mixed fields: not one bitmap OR
        values.extend(vs)
    if path is None or not schema.has(path) \
            or "tag" not in schema.field(path).indexes:
        return None
    return IndexProbe(path, "tag", (tuple(values),))


@dataclass
class RefineSpec:
    """Exact-refine stage over one ragged track field.

    AND of ``(region, t0, t1)`` space-time constraints, evaluated by the
    execution backend's ``refine_tracks`` / ``refine_tracks_batched`` op
    directly against the shard's resident CSR track buffers (one fused
    device pass), instead of a host residual-filter evaluation.

    ``edges`` is the ordering DAG over the constraint list (indices into
    ``constraints``): edge ``(i, j)`` requires the doc's *first hit* of
    constraint ``i`` — minimum timestamp among its satisfying points — to
    be strictly before its first hit of constraint ``j``.  The refine op
    evaluates edges against the per-(doc × constraint) first-hit table the
    same fused pass produces, so ordering adds no extra launches.

    ``min_counts``/``dwells`` carry the per-constraint count ("≥ k hits";
    ``k = 0`` vacuous) and dwell ("last − first ≥ d seconds") reductions —
    computed from the same one-hot compare pass's reduction tables, zero
    extra launches.  ``None`` means every constraint keeps the default
    (k = 1, no dwell) — the legacy spec shape.
    """
    path: str
    constraints: List[Tuple[Any, float, float]]
    edges: List[Tuple[int, int]] = dc_field(default_factory=list)
    min_counts: Optional[Tuple[int, ...]] = None
    dwells: Optional[Tuple[Optional[float], ...]] = None

    def vacuous(self, c: int) -> bool:
        """True when constraint ``c`` filters nothing: k = 0 and no dwell
        (a dwell forces ≥ 1 hit even under k = 0).  Vacuous windows must
        not prune shards, and their postings must not gate candidates."""
        return (self.min_counts is not None
                and int(self.min_counts[c]) <= 0
                and (self.dwells is None or self.dwells[c] is None))


def split_find_pred(pred: Expr, schema: Schema
                    ) -> Tuple[List[IndexProbe], List[RefineSpec],
                               Optional[Expr]]:
    """AND-split a find() predicate into index probes + track refines +
    residual filter.

    Conjuncts that match an index become probes (bitmap AND); everything
    else is evaluated as a post-read filter.  Two refinements:

      * a disjunction of tag lookups on one field (``IN``/``==``) compiles
        to a single ``TagIndex.lookup_any`` bitmap-OR probe instead of
        falling back to residual filtering,
      * ``InSpaceTime`` conjuncts (Tesseract constraints) compile to
        :class:`RefineSpec`\\ s — grouped per track field, evaluated exactly
        behind the backend's ``refine_tracks`` op — plus a *conservative*
        ``spacetime`` probe when the field is indexed (postings live at
        (cell × time-bucket) granularity).  They never enter the residual,
        so the exact pass runs on device instead of the host evaluator.
        ``InSpaceTimeSeq`` (ordered Tesseract) merges into the same
        per-path spec: its constraints append to the spec's list with one
        conservative probe each, and its ordering edges are offset to the
        merged indices — one fused refine launch per wave either way.
        Per-constraint count/dwell reductions ride the merged spec too;
        a ``k = 0`` (vacuous, "≥ 0 hits") constraint skips its spacetime
        probe — its postings are not a superset of "always true".
    """
    conjuncts: List[Expr] = []

    def walk(e: Expr):
        if isinstance(e, BinOp) and e.op == "and":
            walk(e.a)
            walk(e.b)
        else:
            conjuncts.append(e)

    walk(pred)
    probes: List[IndexProbe] = []
    refine_by_path: Dict[str, Tuple[List[Tuple[Any, float, float]],
                                    List[Tuple[int, int]], List[int],
                                    List[Optional[float]]]] = {}
    residual: List[Expr] = []
    for c in conjuncts:
        if isinstance(c, InSpaceTime) and isinstance(c.field, FieldRef):
            p = _indexable(c, schema)
            if p is not None:
                probes.append(p)
            cons, _, mcs, dws = refine_by_path.setdefault(
                c.field.path, ([], [], [], []))
            cons.append((c.region, c.t0, c.t1))
            mcs.append(1)
            dws.append(None)
            continue
        if isinstance(c, InSpaceTimeSeq) and isinstance(c.field, FieldRef):
            path = c.field.path
            cons, edges, mcs, dws = refine_by_path.setdefault(
                path, ([], [], [], []))
            off = len(cons)
            indexed = schema.has(path) \
                and "spacetime" in schema.field(path).indexes
            c_mcs = c.min_counts or (1,) * len(c.constraints)
            c_dws = c.dwells or (None,) * len(c.constraints)
            for ci, (region, t0, t1) in enumerate(c.constraints):
                if indexed and int(c_mcs[ci]) != 0:
                    probes.append(IndexProbe(path, "spacetime",
                                             (region, t0, t1)))
                cons.append((region, float(t0), float(t1)))
                mcs.append(int(c_mcs[ci]))
                dws.append(None if c_dws[ci] is None else float(c_dws[ci]))
            edges.extend((i + off, j + off) for i, j in c.edges)
            continue
        p = _indexable(c, schema) or _indexable_or(c, schema)
        if p is not None:
            probes.append(p)
        else:
            residual.append(c)
    res: Optional[Expr] = None
    for r in residual:
        res = r if res is None else BinOp("and", res, r)
    refines = []
    for path, (cs, edges, mcs, dws) in refine_by_path.items():
        default = all(k == 1 for k in mcs) and all(d is None for d in dws)
        refines.append(RefineSpec(
            path, cs, edges,
            min_counts=None if default else tuple(mcs),
            dwells=None if default else tuple(dws)))
    return probes, refines, res


def probe_shard(shard: Shard, probes: Sequence[IndexProbe],
                backend=None) -> np.ndarray:
    """Intersect all probe bitmaps through the execution backend.

    The numpy backend folds word-wise AND on the host; the torch backend
    stacks the probe postings into one [K, W] word buffer and AND-reduces
    them with the ``bitset`` kernel (``kernels.ops.bitmap_intersect``).
    """
    from ..exec.backend import as_backend   # lazy: exec imports this module
    be = as_backend(backend)
    return be.intersect_bitmaps(
        shard.all_bitmap(), [p.run(shard, backend=be) for p in probes])


# --------------------------------------------------------------------------
# Plans
# --------------------------------------------------------------------------

@dataclass
class Plan:
    source: str
    schema: Schema                   # source schema
    shard_ids: List[int]             # after sampling
    sample_fraction: float
    probes: List[IndexProbe]
    refines: List[RefineSpec]        # exact track refine behind the seam
    residual: Optional[Expr]
    source_paths: List[str]          # minimal viable read set
    server_ops: List[Op]             # record-parallel per shard
    mixer_ops: List[Op]              # final combine stage
    out_schema: Schema
    stats: Dict[str, Any] = dc_field(default_factory=dict)
    #: the FDb snapshot this plan was made against, pinned at plan time.
    #: Engines and the serve tier execute against *this* object — never a
    #: re-resolved ``catalog.get`` — so a streaming source appending (or
    #: compacting) between planning and execution cannot tear a query
    #: across generations: every query sees exactly one snapshot.
    db: Optional[FDb] = None

    def describe(self) -> str:
        lines = [f"plan for {self.source} "
                 f"[{len(self.shard_ids)} shards, sample={self.sample_fraction}]",
                 f"  read columns: {self.source_paths}"]
        if self.stats.get("pruned_shards"):
            lines.append(f"  time-partition pruning: "
                         f"{self.stats['pruned_shards']} shards skipped")
        for p in self.probes:
            lines.append(f"  index probe: {p.kind}({p.path})")
        for r in self.refines:
            order = f", {len(r.edges)} ordering edges" if r.edges else ""
            red = ""
            if r.min_counts is not None or r.dwells is not None:
                nk = sum(1 for k in (r.min_counts or ()) if int(k) != 1)
                nd = sum(1 for d in (r.dwells or ()) if d is not None)
                red = f", {nk} count / {nd} dwell reductions"
            lines.append(f"  track refine: {r.path} "
                         f"[{len(r.constraints)} constraints{order}{red}]")
        if self.residual is not None:
            lines.append("  residual filter: yes")
        lines.append(f"  server ops: "
                     f"{[type(o).__name__ for o in self.server_ops]}")
        lines.append(f"  mixer ops: "
                     f"{[type(o).__name__ for o in self.mixer_ops]}")
        return "\n".join(lines)


def plan_flow(flow: Flow, catalog) -> Plan:
    schema = catalog.schema_of(flow.source)
    db: FDb = catalog.get(flow.source)

    ops = list(flow.ops)

    # -- sampling: select a shard subset (paper §6: "sampling selects only a
    #    subset of shards to feed the query")
    fraction = 1.0
    kept_ops: List[Op] = []
    for op in ops:
        if isinstance(op, SampleOp):
            fraction *= op.fraction
        else:
            kept_ops.append(op)
    ops = kept_ops
    num_shards = db.num_shards
    n_keep = max(1, int(round(num_shards * fraction)))
    shard_ids = list(range(n_keep))            # round-robin ingest ⇒ unbiased

    # -- find(): split into probes + track refines + residual
    probes: List[IndexProbe] = []
    refines: List[RefineSpec] = []
    residual: Optional[Expr] = None
    if ops and isinstance(ops[0], FindOp):
        probes, refines, residual = split_find_pred(ops[0].pred, schema)
        ops = ops[1:]
    elif any(isinstance(o, FindOp) for o in ops):
        raise ValueError("find() must be the first operator on a source")

    # -- time-partitioned shard pruning (the BigQuery partitioned-table
    #    discipline): a space-time constraint window can only match docs
    #    in shards whose track time span overlaps it.  Constraints AND
    #    per doc, so a shard whose span misses *any* one window holds no
    #    possible match and is dropped from the enumeration — waves
    #    shrink, which the launch counter sees.  Shards with an unknown
    #    span (no spacetime index on the path, empty shard, every track
    #    empty) are conservatively kept.  Round-robin-built FDbs span the
    #    whole time range per shard and are never pruned; time-ordered
    #    streaming ingestion makes delta shards time-partitioned, which
    #    is where pruning bites.
    pruned_shards = 0
    if refines and shard_ids:
        kept: List[int] = []
        for sid in shard_ids:
            shard = db.shards[sid]
            drop = False
            for rf in refines:
                idx = shard.index(rf.path, "spacetime")
                span = idx.span() if idx is not None else None
                if span is None:
                    continue
                lo, hi = span
                # vacuous (k = 0, no dwell) windows filter nothing and
                # must not prune — the other constraints still can
                if any((t1 < lo or t0 > hi)
                       for ci, (_, t0, t1) in enumerate(rf.constraints)
                       if not rf.vacuous(ci)):
                    drop = True
                    break
            if not drop:
                kept.append(sid)
        pruned_shards = len(shard_ids) - len(kept)
        shard_ids = kept

    # -- server/mixer split: everything record-parallel runs on servers; the
    #    first global operator (aggregate/sort/limit/distinct without keys)
    #    and everything after it runs on the mixer over merged partials.
    server_ops: List[Op] = []
    mixer_ops: List[Op] = []
    on_server = True
    for op in ops:
        if on_server and isinstance(op, (MapOp, FilterOp, FlattenOp,
                                         ModelApplyOp, JoinOp, SubFlowOp)):
            server_ops.append(op)
        else:
            on_server = False
            mixer_ops.append(op)

    # -- minimal viable schema: source columns any server-side expression or
    #    raw-collect touches (paper §4.3.3)
    needed: set = set()
    saw_map = False
    residual_ops = [FindOp(residual)] if residual is not None else []
    for op in residual_ops + server_ops + mixer_ops:
        if saw_map:
            break           # later ops see the derived schema, not source
        exprs: List[Expr] = []
        if isinstance(op, FindOp) and op.pred is not None:
            exprs = [op.pred]
        elif isinstance(op, MapOp):
            exprs = [e for _, e in op.make.fields]
        elif isinstance(op, FilterOp):
            exprs = [op.pred]
        elif isinstance(op, SortOp):
            exprs = [op.expr]
        elif isinstance(op, DistinctOp) and op.expr is not None:
            exprs = [op.expr]
        elif isinstance(op, AggregateOp):
            exprs = [e for _, e in op.spec.keys] + \
                [e for _, _, e in op.spec.aggs if e is not None]
        elif isinstance(op, (JoinOp,)):
            exprs = [op.left_key]
        elif isinstance(op, SubFlowOp):
            exprs = [op.key]
        elif isinstance(op, ModelApplyOp):
            exprs = [e for _, e in op.inputs]
        for e in exprs:
            needed.update(required_paths(e, schema))
        if isinstance(op, (MapOp, AggregateOp)):
            saw_map = True
    for p in probes:
        # probes run on indices; location residual verification may still
        # need the columns — include them (cheap) for exactness checks
        if p.kind in ("location",):
            needed.update({p.path + ".lat", p.path + ".lng"})
    if not saw_map and not any(isinstance(o, AggregateOp)
                               for o in server_ops + mixer_ops):
        # raw collect: every stored column is semantically required
        needed.update(schema.leaf_paths())
    source_paths = sorted(x for x in needed
                          if schema.has(x)
                          and schema.field(x).virtual is None)

    out_schema = flow.schema_after(catalog)
    stats: Dict[str, Any] = {}
    if pruned_shards:
        stats["pruned_shards"] = pruned_shards
    return Plan(flow.source, schema, shard_ids, fraction, probes, refines,
                residual, source_paths, server_ops, mixer_ops, out_schema,
                stats=stats, db=db)


# --------------------------------------------------------------------------
# Partition layer: which device runs which shards
# --------------------------------------------------------------------------

#: env override for the number of execution partitions (engine arg wins).
PARTITIONS_ENV = "REPRO_EXEC_PARTITIONS"


@dataclass
class PartitionPlan:
    """Explicit shards -> P partitions assignment for one query.

    The partition layer sits between the planner (which enumerates and
    prunes ``Plan.shard_ids``) and the wave scheduler: each partition's
    shards are waved and dispatched independently (one after another on
    the torch backend's one card), and the per-shard segment-aggregate
    states are combined by a single ``merge_partials`` tail.  Partitions
    are contiguous slices of the pruned shard list, so flattening the
    per-partition results in partition order recovers global shard order
    — which is what keeps the merged aggregation bit-equal to the P=1
    sequential reference.
    """

    parts: List[List[int]]           # partition index -> shard ids

    @property
    def num_partitions(self) -> int:
        return len(self.parts)

    def sizes(self) -> List[int]:
        return [len(p) for p in self.parts]

    def wave_dispatches(self, wave: int) -> int:
        """Launch-contract helper: fused dispatches = sum over partitions
        of ceil(shards_p / wave).  Empty partitions dispatch nothing."""
        wave = max(1, int(wave))
        return sum(-(-len(p) // wave) for p in self.parts if p)

    def merge_combines(self) -> int:
        """Launch-contract helper: one ``merge_partials`` combine per
        aggregated query when more than one partition ran; the P=1 path
        is the legacy sequential merge (no combine launch)."""
        return 1 if sum(1 for p in self.parts if p) > 1 else 0


def partition_shards(shard_ids: Sequence[int], p: int) -> PartitionPlan:
    """Split an (already pruned) shard list into ``p`` contiguous
    partitions, balanced to within one shard (ragged counts allowed:
    ``p`` need not divide ``len(shard_ids)``; with fewer shards than
    partitions the tail partitions are empty)."""
    p = max(1, int(p))
    ids = list(shard_ids)
    base, extra = divmod(len(ids), p)
    parts: List[List[int]] = []
    lo = 0
    for i in range(p):
        hi = lo + base + (1 if i < extra else 0)
        parts.append(ids[lo:hi])
        lo = hi
    return PartitionPlan(parts)


def num_partitions(spec: Optional[int] = None, backend: Any = None) -> int:
    """Resolve the execution partition count: explicit engine arg >
    ``REPRO_EXEC_PARTITIONS`` > the backend's CUDA device count (batched
    backends only — the host oracle, and a backend on the CPU, default to
    a single partition)."""
    if spec is not None:
        return max(1, int(spec))
    import os

    env = os.environ.get(PARTITIONS_ENV, "").strip()
    if env:
        return max(1, int(env))
    if backend is not None and getattr(backend, "batched_dispatch", False):
        from ..launch.mesh import default_exec_partitions

        return default_exec_partitions(backend)
    return 1
