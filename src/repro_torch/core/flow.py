"""WFL flows (paper §3, §4.2, Table 1).

A pipeline is ``fdb('Name').find(...).map(...).aggregate(...).collect()`` —
a lazily-built DAG of operators over a *flow* of records.  Nothing executes
until a materializing operator (``collect``/``save``) hands the DAG to an
execution engine (Warp:AdHoc or Warp:Flume, §4.3).

Operator vocabulary is the paper's Table 1: map, filter, flatten, sort_asc/
sort_desc, limit, distinct, aggregate, join, sub_flow, collect, save — plus
``sample`` (the paper's "querying over a sample to quickly slice through
huge datasets", realized as shard-subset selection) and ``model_apply`` (the
§5 TensorFlow-operator analog, applying a JAX model to flow columns).

Every stage's output schema is derived automatically (Dynamic Protocol
Buffers, §4.3.3): see :meth:`Flow.schema_after`.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..fdb.schema import DOUBLE, INT, STRING, BOOL, Schema
from .exprs import (AggSpec, Expr, ExprProxy, FieldRef, MakeProto, P,
                    infer_spec, _wrap)

__all__ = ["Flow", "fdb", "Op", "FindOp", "MapOp", "FilterOp", "FlattenOp",
           "SortOp", "LimitOp", "DistinctOp", "AggregateOp", "JoinOp",
           "SubFlowOp", "SampleOp", "ModelApplyOp"]


def _trace(fn_or_expr) -> Expr:
    if callable(fn_or_expr) and not isinstance(fn_or_expr, ExprProxy):
        fn_or_expr = fn_or_expr(P)
    return _wrap(fn_or_expr)


# --------------------------------------------------------------------- ops

class Op:
    pass


@dataclass
class FindOp(Op):
    pred: Expr


@dataclass
class MapOp(Op):
    make: MakeProto


@dataclass
class FilterOp(Op):
    pred: Expr


@dataclass
class FlattenOp(Op):
    path: str


@dataclass
class SortOp(Op):
    expr: Expr
    descending: bool = False


@dataclass
class LimitOp(Op):
    k: int


@dataclass
class DistinctOp(Op):
    expr: Optional[Expr] = None


@dataclass
class AggregateOp(Op):
    spec: AggSpec


@dataclass
class JoinOp(Op):
    right: "Flow"
    left_key: Expr
    right_key: Expr
    alias: str = "r"
    strategy: str = "auto"      # auto | broadcast | shuffle


@dataclass
class SubFlowOp(Op):
    """Index join (paper Table 1 ``sub_flow``): per record, probe the other
    FDb's *index* on the key instead of materializing + hashing it."""
    right_fdb: str
    key: Expr
    index_path: str
    alias: str = "r"


@dataclass
class SampleOp(Op):
    fraction: float


@dataclass
class ModelApplyOp(Op):
    model: Any
    inputs: Tuple[Tuple[str, Expr], ...]
    output: str = "prediction"


# -------------------------------------------------------------------- flow

class Flow:
    def __init__(self, source: str, ops: Sequence[Op] = (),
                 session: Optional[Any] = None):
        self.source = source
        self.ops: List[Op] = list(ops)
        self.session = session

    def _push(self, op: Op) -> "Flow":
        return Flow(self.source, self.ops + [op], self.session)

    # -- Table 1 operators --------------------------------------------------
    def find(self, pred) -> "Flow":
        return self._push(FindOp(_trace(pred)))

    def map(self, fn) -> "Flow":
        e = _trace(fn)
        if not isinstance(e, MakeProto):
            raise TypeError("map() must return proto(...)")
        return self._push(MapOp(e))

    def filter(self, pred) -> "Flow":
        return self._push(FilterOp(_trace(pred)))

    def flatten(self, path) -> "Flow":
        if isinstance(path, ExprProxy):
            path = path._expr.path
        return self._push(FlattenOp(path))

    def sort_asc(self, expr) -> "Flow":
        return self._push(SortOp(_trace(expr), False))

    def sort_desc(self, expr) -> "Flow":
        return self._push(SortOp(_trace(expr), True))

    def limit(self, k: int) -> "Flow":
        return self._push(LimitOp(int(k)))

    def distinct_approx(self, expr, name: str = "distinct_approx") -> "Flow":
        """Approximate distinct count of ``expr`` over the whole flow
        (paper §4.2.2 HyperLogLog): one-row result column ``name``.  The
        sketch is register-maxed per partition and merged by the Mixer, so
        the estimate is partition-invariant by contract."""
        spec = AggSpec(())
        spec.approx_distinct(name, expr=_trace(expr))
        return self._push(AggregateOp(spec))

    def distinct(self, expr=None) -> "Flow":
        return self._push(DistinctOp(_trace(expr) if expr is not None
                                     else None))

    def aggregate(self, spec) -> "Flow":
        if callable(spec) and not isinstance(spec, AggSpec):
            spec = spec(P)
        if not isinstance(spec, AggSpec):
            raise TypeError("aggregate() takes group(...).agg(...) spec")
        return self._push(AggregateOp(spec))

    def join(self, right: "Flow", left_key, right_key=None, alias="r",
             strategy="auto") -> "Flow":
        right_key = right_key if right_key is not None else left_key
        return self._push(JoinOp(right, _trace(left_key), _trace(right_key),
                                 alias, strategy))

    def sub_flow(self, right_fdb: str, key, index_path: str,
                 alias="r") -> "Flow":
        return self._push(SubFlowOp(right_fdb, _trace(key), index_path,
                                    alias))

    def tesseract(self, tess, field: str = None) -> "Flow":
        """Space-time trip selection (paper §2 Tesseract queries).

        ``tess`` is a :class:`repro_torch.tess.Tesseract`; its constraints become
        ``InSpaceTime`` conjuncts of a leading ``find()`` (a single
        ``InSpaceTimeSeq`` conjunct when the builder carries ``then()`` /
        ``before()`` ordering edges), which the planner compiles to stacked
        ``spacetime``-index bitmap probes plus the exact point-in-cover ×
        time-window refine — ordering resolved there via per-constraint
        first-hit timestamps.  Compose with other predicates via
        ``find(tess.expr() & ...)`` instead when needed.
        """
        return self._push(FindOp(_trace(tess.expr(field))))

    def sample(self, fraction: float) -> "Flow":
        if not 0.0 < fraction <= 1.0:
            raise ValueError("sample fraction in (0, 1]")
        return self._push(SampleOp(float(fraction)))

    def model_apply(self, model, output="prediction", **inputs) -> "Flow":
        """Apply a model to flow columns (paper §5 TF-operator analog)."""
        ins = tuple((k, _trace(v)) for k, v in inputs.items())
        return self._push(ModelApplyOp(model, ins, output))

    def to_dataset(self, features, target, engine=None, **kw):
        """Materialize this flow as ML training data (paper §5).  The
        training path is not ported yet (ROADMAP.md, queue A item 9)."""
        raise NotImplementedError(
            "to_dataset() needs the training path, which the port has "
            "not reached yet (ROADMAP.md, queue A item 9)")

    # -- materialization ------------------------------------------------------
    def collect(self, engine=None, **kw):
        eng = engine or (self.session.engine if self.session else None)
        if eng is None:
            from ..exec.adhoc import default_engine
            eng = default_engine()
        return eng.collect(self, **kw)

    def save(self, name: str, engine=None, **kw):
        eng = engine or (self.session.engine if self.session else None)
        if eng is None:
            from ..exec.adhoc import default_engine
            eng = default_engine()
        return eng.save(self, name, **kw)

    # -- dynamic schema derivation (§4.3.3) -----------------------------------
    def schema_after(self, catalog) -> Schema:
        schema = catalog.schema_of(self.source)
        for op in self.ops:
            schema = _apply_schema(op, schema, catalog)
        return schema

    def __repr__(self):
        names = [type(o).__name__.replace("Op", "").lower() for o in self.ops]
        return f"Flow({self.source!r} | {' | '.join(names)})"


def _apply_schema(op: Op, schema: Schema, catalog) -> Schema:
    if isinstance(op, (FindOp, FilterOp, SampleOp, SortOp, LimitOp,
                       DistinctOp)):
        return schema
    if isinstance(op, MapOp):
        spec = {name: infer_spec(e, schema) for name, e in op.make.fields}
        return Schema.dynamic(schema.name + "#map", spec)
    if isinstance(op, FlattenOp):
        spec = {}
        for p, (t, rep) in schema.spec().items():
            if p == op.path or p.startswith(op.path + "."):
                spec[p] = (t, False)
            else:
                spec[p] = (t, rep)
        return Schema.dynamic(schema.name + "#flat", spec)
    if isinstance(op, AggregateOp):
        spec: Dict[str, tuple] = {}
        for name, e in op.spec.keys:
            spec[name] = infer_spec(e, schema)
        for kind, name, e in op.spec.aggs:
            spec[name] = (INT, False) if kind in ("count",) else (DOUBLE,
                                                                  False)
        return Schema.dynamic(schema.name + "#agg", spec)
    if isinstance(op, JoinOp):
        spec = dict(schema.spec())
        rschema = op.right.schema_after(catalog)
        for p, s in rschema.spec().items():
            spec[f"{op.alias}.{p}"] = s
        return Schema.dynamic(schema.name + "#join", spec)
    if isinstance(op, SubFlowOp):
        spec = dict(schema.spec())
        rschema = catalog.schema_of(op.right_fdb)
        for p, s in rschema.spec().items():
            spec[f"{op.alias}.{p}"] = s
        return Schema.dynamic(schema.name + "#subflow", spec)
    if isinstance(op, ModelApplyOp):
        spec = dict(schema.spec())
        spec[op.output] = (DOUBLE, False)
        return Schema.dynamic(schema.name + "#model", spec)
    raise TypeError(f"unknown op {type(op).__name__}")


def fdb(name: str, session: Optional[Any] = None) -> Flow:
    """Start a flow from a registered FDb — ``fdb('Roads')`` (paper Fig. 1)."""
    return Flow(name, (), session)
