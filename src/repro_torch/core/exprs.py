"""WFL expression IR (paper §4.2).

WFL transformations are "expressions composed of data types, operators and
higher-order functions".  We embed WFL in Python: flow operators take
lambdas over a record proxy ``p``; evaluating the lambda *traces* an
expression tree (this module), which the engine then

  * type-checks / schema-infers (→ Dynamic Protocol Buffers, §4.3.3),
  * scans for index-usable conjuncts (``find()`` planning, §4.3.4),
  * evaluates vectorized over column batches — singular fields are scalars,
    repeated fields are vectors, and every operator broadcasts over repeated
    operands exactly as §4.2.2 specifies ("the operation is extended to
    every single element within the operand").

The final statement of a WFL body is its return value; in Python that is
simply the lambda's return expression.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..fdb.columnar import Column, ColumnBatch
from ..fdb.schema import (BOOL, DOUBLE, FLOAT, INT, MESSAGE, STRING, UINT,
                          Schema)
from ..geo.areatree import AreaTree
from ..geo import mercator as Mc
from .sketches import BloomFilter, IntervalSet

__all__ = [
    "Expr", "FieldRef", "Lit", "External", "BinOp", "UnOp", "Between",
    "InRegion", "InSet", "InSpaceTime", "InSpaceTimeSeq", "Reduce",
    "GetField", "TableLookup",
    "Func",
    "MakeProto", "ModelApply", "P", "proto", "IN", "BETWEEN",
    "vsum", "vmin", "vmax", "vcount", "vmean", "where",
    "CollectedTable", "Val", "EvalContext", "eval_expr", "required_paths",
    "infer_spec", "group", "AggSpec",
]


# ===========================================================================
# IR nodes
# ===========================================================================

class Expr:
    def children(self) -> Tuple["Expr", ...]:
        return ()


@dataclass(frozen=True)
class FieldRef(Expr):
    path: str


@dataclass(frozen=True)
class Lit(Expr):
    value: Any


@dataclass(frozen=True)
class External(Expr):
    """A captured host object: AreaTree, CollectedTable, BloomFilter, …"""
    obj: Any = dc_field(hash=False)


@dataclass(frozen=True)
class BinOp(Expr):
    op: str
    a: Expr
    b: Expr

    def children(self):
        return (self.a, self.b)


@dataclass(frozen=True)
class UnOp(Expr):
    op: str
    a: Expr

    def children(self):
        return (self.a,)


@dataclass(frozen=True)
class Between(Expr):
    a: Expr
    lo: Any
    hi: Any

    def children(self):
        return (self.a,)


@dataclass(frozen=True)
class InRegion(Expr):
    field: Expr            # FieldRef to a location (message with lat/lng)
    region: Any = dc_field(hash=False)            # AreaTree

    def children(self):
        return (self.field,)


@dataclass(frozen=True)
class InSet(Expr):
    a: Expr
    values: tuple

    def children(self):
        return (self.a,)


@dataclass(frozen=True)
class InSpaceTime(Expr):
    """One Tesseract constraint: the track passes through ``region`` during
    ``[t0, t1]`` — true iff *some* track point is inside the region's cover
    and time window.  Singular (any-reduced) over the repeated track."""
    field: Expr            # FieldRef to a track (repeated lat/lng/t leaves)
    region: Any = dc_field(hash=False)            # AreaTree
    t0: float = 0.0
    t1: float = 0.0

    def children(self):
        return (self.field,)


@dataclass(frozen=True)
class InSpaceTimeSeq(Expr):
    """Ordered Tesseract constraints over one track field (A **then** B).

    Every ``(region, t0, t1)`` constraint must hit (some track point inside
    the region's cover during the window — the plain ``InSpaceTime`` AND),
    and for each ``(i, j)`` ordering edge the track's **first hit** of
    constraint ``i`` (minimum timestamp among its satisfying points) must be
    *strictly* before its first hit of constraint ``j``.  Equal first-hit
    timestamps do not count as before (tie ⇒ edge fails).  Singular
    (any-reduced) over the repeated track, like ``InSpaceTime``.

    Per-constraint **reductions** generalize the any-hit verdict from the
    same one-hot pass: ``min_counts[c] = k`` requires ≥ k satisfying points
    (k = 0 is vacuously true — the constraint stops filtering);
    ``dwells[c] = d`` requires ≥ 1 hit and ``t(last hit) − t(first hit)
    >= d`` seconds (inclusive at the threshold).  ``None`` in either slot
    (or the whole tuple) keeps the plain any-hit semantics.
    """
    field: Expr            # FieldRef to a track (repeated lat/lng/t leaves)
    constraints: Tuple[Tuple[Any, float, float], ...] = \
        dc_field(hash=False, default=())      # [(AreaTree, t0, t1), …]
    edges: Tuple[Tuple[int, int], ...] = ()   # (i, j): first_i < first_j
    min_counts: Optional[Tuple[int, ...]] = None     # "≥ k hits" per slot
    dwells: Optional[Tuple[Optional[float], ...]] = None  # seconds per slot

    def children(self):
        return (self.field,)


@dataclass(frozen=True)
class Reduce(Expr):
    op: str                # sum|min|max|mean|count
    a: Expr

    def children(self):
        return (self.a,)


@dataclass(frozen=True)
class GetField(Expr):
    base: Expr
    name: str

    def children(self):
        return (self.base,)


@dataclass(frozen=True)
class TableLookup(Expr):
    table: Any = dc_field(hash=False)     # CollectedTable
    key: Expr = None

    def children(self):
        return (self.key,)


@dataclass(frozen=True)
class Func(Expr):
    name: str
    args: tuple

    def children(self):
        return tuple(a for a in self.args if isinstance(a, Expr))


@dataclass(frozen=True)
class MakeProto(Expr):
    fields: tuple          # ((name, Expr), ...)

    def children(self):
        return tuple(e for _, e in self.fields)


@dataclass(frozen=True)
class ModelApply(Expr):
    model: Any = dc_field(hash=False)
    inputs: tuple = ()     # ((name, Expr), ...)

    def children(self):
        return tuple(e for _, e in self.inputs)


def _wrap(x) -> Expr:
    if isinstance(x, ExprProxy):
        return x._expr
    if isinstance(x, Expr):
        return x
    if isinstance(x, (bool, int, float, str, np.generic)):
        return Lit(x)
    return External(x)


# ===========================================================================
# Tracing proxies — the `p` in `flow.map(p => ...)`
# ===========================================================================

class ExprProxy:
    __array_priority__ = 1000   # win binops against numpy scalars

    def __init__(self, expr: Expr):
        object.__setattr__(self, "_expr", expr)

    # field access ----------------------------------------------------------
    def __getattr__(self, name: str) -> "ExprProxy":
        if name.startswith("_"):
            raise AttributeError(name)
        e = self._expr
        if isinstance(e, FieldRef):
            return ExprProxy(FieldRef(f"{e.path}.{name}" if e.path else name))
        return ExprProxy(GetField(e, name))

    def __getitem__(self, key) -> "ExprProxy":
        # roads[p.route.id] — dictionary lookup with vector keys
        e = self._expr
        if isinstance(e, External) and isinstance(e.obj, CollectedTable):
            return ExprProxy(TableLookup(e.obj, _wrap(key)))
        raise TypeError("subscript only supported on collected dicts")

    # operators --------------------------------------------------------------
    def _bin(self, op, other, swap=False):
        a, b = _wrap(self), _wrap(other)
        if swap:
            a, b = b, a
        return ExprProxy(BinOp(op, a, b))

    __add__ = lambda s, o: s._bin("add", o)
    __radd__ = lambda s, o: s._bin("add", o, True)
    __sub__ = lambda s, o: s._bin("sub", o)
    __rsub__ = lambda s, o: s._bin("sub", o, True)
    __mul__ = lambda s, o: s._bin("mul", o)
    __rmul__ = lambda s, o: s._bin("mul", o, True)
    __truediv__ = lambda s, o: s._bin("div", o)
    __rtruediv__ = lambda s, o: s._bin("div", o, True)
    __mod__ = lambda s, o: s._bin("mod", o)
    __pow__ = lambda s, o: s._bin("pow", o)
    __eq__ = lambda s, o: s._bin("eq", o)        # type: ignore[assignment]
    __ne__ = lambda s, o: s._bin("ne", o)        # type: ignore[assignment]
    __lt__ = lambda s, o: s._bin("lt", o)
    __le__ = lambda s, o: s._bin("le", o)
    __gt__ = lambda s, o: s._bin("gt", o)
    __ge__ = lambda s, o: s._bin("ge", o)
    __and__ = lambda s, o: s._bin("and", o)
    __rand__ = lambda s, o: s._bin("and", o, True)
    __or__ = lambda s, o: s._bin("or", o)
    __ror__ = lambda s, o: s._bin("or", o, True)
    __neg__ = lambda s: ExprProxy(UnOp("neg", _wrap(s)))
    __invert__ = lambda s: ExprProxy(UnOp("not", _wrap(s)))
    __abs__ = lambda s: ExprProxy(UnOp("abs", _wrap(s)))
    __hash__ = None   # type: ignore[assignment]

    def in_(self, what) -> "ExprProxy":
        return IN(self, what)

    def between(self, lo, hi) -> "ExprProxy":
        return BETWEEN(self, lo, hi)

    def __bool__(self):
        raise TypeError(
            "WFL expressions are lazy; use &, | instead of and/or, "
            "and IN()/BETWEEN() instead of `in`.")


#: The record proxy — `P.field` inside flow lambdas.
P = ExprProxy(FieldRef(""))


def proto(**fields) -> ExprProxy:
    """``proto(a=expr, b=expr)`` — construct the stage's output record."""
    flat: List[Tuple[str, Expr]] = []
    for name, v in fields.items():
        e = _wrap(v)
        if isinstance(e, MakeProto):   # nested proto → dotted paths
            for sub, se in e.fields:
                flat.append((f"{name}.{sub}", se))
        else:
            flat.append((name, e))
    return ExprProxy(MakeProto(tuple(flat)))


def IN(a, what) -> ExprProxy:
    a = _wrap(a)
    if isinstance(what, AreaTree):
        if not isinstance(a, FieldRef):
            raise TypeError("IN(region) requires a location field")
        return ExprProxy(InRegion(a, what))
    if isinstance(what, BloomFilter):
        return ExprProxy(Func("bloom_contains", (a, External(what))))
    if isinstance(what, (list, tuple, set, frozenset)):
        return ExprProxy(InSet(a, tuple(what)))
    raise TypeError(f"IN: unsupported container {type(what).__name__}")


def BETWEEN(a, lo, hi) -> ExprProxy:
    return ExprProxy(Between(_wrap(a), lo, hi))


def vsum(a) -> ExprProxy:
    return ExprProxy(Reduce("sum", _wrap(a)))


def vmin(a) -> ExprProxy:
    return ExprProxy(Reduce("min", _wrap(a)))


def vmax(a) -> ExprProxy:
    return ExprProxy(Reduce("max", _wrap(a)))


def vmean(a) -> ExprProxy:
    return ExprProxy(Reduce("mean", _wrap(a)))


def vcount(a) -> ExprProxy:
    return ExprProxy(Reduce("count", _wrap(a)))


def where(cond, a, b) -> ExprProxy:
    return ExprProxy(Func("where", (_wrap(cond), _wrap(a), _wrap(b))))


def func(name, *args) -> ExprProxy:
    return ExprProxy(Func(name, tuple(_wrap(a) for a in args)))


# ===========================================================================
# Collected tables (`collect().to_dict(key)`)
# ===========================================================================

class CollectedTable:
    """Materialized flow results; supports record access + dict lookups."""

    def __init__(self, batch: ColumnBatch):
        self.batch = batch
        self._key_path: Optional[str] = None
        self._sorted_keys: Optional[np.ndarray] = None
        self._sorted_rows: Optional[np.ndarray] = None
        self._key_vocab_map: Optional[Dict[str, int]] = None

    @property
    def n(self) -> int:
        return self.batch.n

    def to_records(self) -> List[dict]:
        return self.batch.to_records()

    def to_dict(self, key_path) -> "CollectedTable":
        """Index by a key column for ``table[keys]`` lookups in expressions."""
        if isinstance(key_path, ExprProxy):
            assert isinstance(key_path._expr, FieldRef)
            key_path = key_path._expr.path
        col = self.batch[key_path]
        if col.is_repeated:
            raise TypeError("to_dict key must be singular")
        keys = col.values
        if col.vocab is not None:
            self._key_vocab_map = {s: i for i, s in enumerate(col.vocab)}
        order = np.argsort(keys, kind="stable")
        self._key_path = key_path
        self._sorted_keys = keys[order]
        self._sorted_rows = order.astype(np.int64)
        return self

    def __getitem__(self, key):
        """Fig. 1 syntax: ``roads[p.route.id]`` inside a WFL expression."""
        if isinstance(key, (ExprProxy, Expr)):
            return ExprProxy(TableLookup(self, _wrap(key)))
        raise TypeError("collected-table lookup takes a WFL expression key")

    def lookup_rows(self, keys: np.ndarray,
                    key_vocab: Optional[List[str]] = None) -> np.ndarray:
        """Row ids per key (−1 = missing), vectorized."""
        if self._sorted_keys is None:
            raise RuntimeError("call .to_dict(key) before lookups")
        keys = np.asarray(keys)
        if key_vocab is not None:
            if self._key_vocab_map is None:
                raise TypeError("string keys against non-string dict")
            remap = np.array([self._key_vocab_map.get(s, -1)
                              for s in key_vocab], dtype=np.int64)
            keys = remap[keys]
        pos = np.searchsorted(self._sorted_keys, keys)
        pos_c = np.minimum(pos, self._sorted_keys.size - 1)
        hit = (self._sorted_keys.size > 0) & \
            (self._sorted_keys[pos_c] == keys) & (keys >= 0 if key_vocab else True)
        return np.where(hit, self._sorted_rows[pos_c], -1)

    def __repr__(self):
        return f"CollectedTable(n={self.n}, key={self._key_path!r})"


# ===========================================================================
# Evaluation
# ===========================================================================

@dataclass
class Val:
    """A vectorized value over the batch's rows.

    ``splits`` set ⇒ repeated (ragged).  ``table``+``rows`` set ⇒ this is a
    vector of *records* (rows into a CollectedTable) — field access gathers.
    """
    values: np.ndarray = None
    splits: Optional[np.ndarray] = None
    vocab: Optional[List[str]] = None
    table: Optional[CollectedTable] = None

    @property
    def is_repeated(self):
        return self.splits is not None


@dataclass
class EvalContext:
    batch: ColumnBatch
    meters_per_unit: float = 0.06   # local Mercator scale hint

    @property
    def n(self):
        return self.batch.n


def _broadcast(a: Val, b: Val, n: int) -> Tuple[np.ndarray, np.ndarray,
                                                Optional[np.ndarray]]:
    """Align two vals: returns flat arrays + common splits (None=singular)."""
    if a.is_repeated and b.is_repeated:
        if a.splits is not b.splits and not np.array_equal(a.splits, b.splits):
            raise ValueError("binary op on differently-shaped vectors")
        return a.values, b.values, a.splits
    if a.is_repeated:
        lens = np.diff(a.splits)
        bv = b.values if b.values.ndim else np.broadcast_to(b.values, (n,))
        return a.values, np.repeat(bv, lens), a.splits
    if b.is_repeated:
        lens = np.diff(b.splits)
        av = a.values if a.values.ndim else np.broadcast_to(a.values, (n,))
        return np.repeat(av, lens), b.values, b.splits
    return a.values, b.values, None


_BINOPS: Dict[str, Callable] = {
    "add": np.add, "sub": np.subtract, "mul": np.multiply,
    "div": np.divide, "mod": np.mod, "pow": np.power,
    "eq": np.equal, "ne": np.not_equal, "lt": np.less, "le": np.less_equal,
    "gt": np.greater, "ge": np.greater_equal,
    "and": np.logical_and, "or": np.logical_or,
}

_UNOPS: Dict[str, Callable] = {
    "neg": np.negative, "not": np.logical_not, "abs": np.abs,
    "sqrt": np.sqrt, "log": np.log, "exp": np.exp,
    "floor": np.floor, "ceil": np.ceil,
}


def _str_code(lit, vocab: List[str]):
    try:
        return vocab.index(str(lit))
    except ValueError:
        return -1


def eval_expr(expr: Expr, ctx: EvalContext) -> Val:
    n = ctx.n
    if isinstance(expr, FieldRef):
        col = ctx.batch[expr.path]
        return Val(col.values, col.row_splits, col.vocab)
    if isinstance(expr, Lit):
        return Val(np.asarray(expr.value))
    if isinstance(expr, External):
        return Val(values=expr.obj)
    if isinstance(expr, BinOp):
        a = eval_expr(expr.a, ctx)
        b = eval_expr(expr.b, ctx)
        # string comparison: map literal onto vocab codes
        if a.vocab is not None and b.values is not None and b.values.ndim == 0:
            b = Val(np.asarray(_str_code(b.values.item(), a.vocab)))
        elif b.vocab is not None and a.values is not None and a.values.ndim == 0:
            a = Val(np.asarray(_str_code(a.values.item(), b.vocab)))
        fa, fb, sp = _broadcast(a, b, n)
        if expr.op == "div":
            fa = np.asarray(fa, dtype=np.float64)
        return Val(_BINOPS[expr.op](fa, fb), sp)
    if isinstance(expr, UnOp):
        a = eval_expr(expr.a, ctx)
        return Val(_UNOPS[expr.op](a.values), a.splits, None)
    if isinstance(expr, Between):
        a = eval_expr(expr.a, ctx)
        return Val((a.values >= expr.lo) & (a.values <= expr.hi), a.splits)
    if isinstance(expr, InSet):
        a = eval_expr(expr.a, ctx)
        if a.vocab is not None:
            codes = {_str_code(v, a.vocab) for v in expr.values}
            return Val(np.isin(a.values, list(codes)), a.splits)
        return Val(np.isin(a.values, list(expr.values)), a.splits)
    if isinstance(expr, InRegion):
        lat = ctx.batch[expr.field.path + ".lat"]
        lng = ctx.batch[expr.field.path + ".lng"]
        keys = Mc.latlng_to_morton(lat.values, lng.values)
        return Val(expr.region.contains(keys), lat.row_splits)
    if isinstance(expr, InSpaceTime):
        # exact Tesseract constraint: the 1-constraint/no-edges case of
        # the ordered evaluation below (one source of the hit semantics)
        return eval_expr(InSpaceTimeSeq(
            expr.field, ((expr.region, expr.t0, expr.t1),)), ctx)
    if isinstance(expr, InSpaceTimeSeq):
        # ordered Tesseract: AND of every constraint's any-hit (some track
        # point in-cover AND in-window), plus strict first-hit ordering
        # per edge.  First hit = min timestamp among the doc's points
        # satisfying the constraint (+inf when none — such docs already
        # fail the hit AND, so edges never resurrect them); float min
        # order-matches the packed uint64 sort-key min the refine ops use
        # for every non-NaN timestamp.
        lat = ctx.batch[expr.field.path + ".lat"]
        lng = ctx.batch[expr.field.path + ".lng"]
        tt = ctx.batch[expr.field.path + ".t"]
        keys = Mc.latlng_to_morton(lat.values, lng.values)
        mins = expr.min_counts
        dwells = expr.dwells
        any_dwell = dwells is not None and any(d is not None for d in dwells)
        need_first = bool(expr.edges) or any_dwell
        first = np.full((n, len(expr.constraints)), np.inf) \
            if need_first else None
        last = np.full((n, len(expr.constraints)), -np.inf) \
            if any_dwell else None
        count = np.zeros((n, len(expr.constraints)), dtype=np.int64) \
            if mins is not None else None
        out = np.ones(n, dtype=bool)
        row_of = None if lat.row_splits is None else \
            np.repeat(np.arange(n), np.diff(lat.row_splits))
        for c, (region, t0, t1) in enumerate(expr.constraints):
            hit = region.contains(keys) \
                & (tt.values >= t0) & (tt.values <= t1)
            if row_of is None:                  # singular location + t
                doc_hit = np.asarray(hit, dtype=bool)
                if first is not None:
                    first[:, c] = np.where(hit, tt.values, np.inf)
                if last is not None:
                    last[:, c] = np.where(hit, tt.values, -np.inf)
                if count is not None:
                    count[:, c] = doc_hit.astype(np.int64)
            else:
                doc_hit = np.zeros(n, dtype=bool)
                if hit.size:
                    np.logical_or.at(doc_hit, row_of, hit)
                    if first is not None:
                        np.minimum.at(first[:, c], row_of,
                                      np.where(hit, tt.values, np.inf))
                    if last is not None:
                        np.maximum.at(last[:, c], row_of,
                                      np.where(hit, tt.values, -np.inf))
                    if count is not None:
                        np.add.at(count[:, c], row_of, hit)
            ok = doc_hit
            if mins is not None and int(mins[c]) != 1:
                k = int(mins[c])
                ok = np.ones(n, dtype=bool) if k <= 0 else count[:, c] >= k
            if dwells is not None and dwells[c] is not None:
                # + 0.0 normalizes −0.0, matching the packed sort-key
                # round-trip the device reductions difference
                span = (last[:, c] + 0.0) - (first[:, c] + 0.0)
                ok = ok & doc_hit & (span >= float(dwells[c]))
            out &= ok
        for i, j in expr.edges:
            out &= first[:, i] < first[:, j]
        return Val(out)
    if isinstance(expr, Reduce):
        a = eval_expr(expr.a, ctx)
        if not a.is_repeated:
            raise TypeError(f"{expr.op}() over a singular field")
        lens = np.diff(a.splits)
        if expr.op == "count":
            return Val(lens.astype(np.int64))
        vals = np.asarray(a.values, dtype=np.float64)
        starts = a.splits[:-1]
        if expr.op == "sum":
            out = np.add.reduceat(vals, starts) if vals.size else \
                np.zeros(n)
            out = np.where(lens > 0, out, 0.0)
        elif expr.op == "mean":
            s = np.add.reduceat(vals, starts) if vals.size else np.zeros(n)
            out = np.where(lens > 0, s / np.maximum(lens, 1), np.nan)
        elif expr.op == "min":
            out = np.minimum.reduceat(vals, starts) if vals.size else \
                np.full(n, np.nan)
            out = np.where(lens > 0, out, np.nan)
        elif expr.op == "max":
            out = np.maximum.reduceat(vals, starts) if vals.size else \
                np.full(n, np.nan)
            out = np.where(lens > 0, out, np.nan)
        else:
            raise ValueError(expr.op)
        # reduceat quirk: empty segments copy the next element; fixed by the
        # `where` masks above (out is only trusted where lens > 0).
        return Val(out)
    if isinstance(expr, GetField):
        base = eval_expr(expr.base, ctx)
        if base.table is None:
            raise TypeError(f"field access .{expr.name} on non-record value")
        col = base.table.batch[_resolve_col(base.table, expr.name)]
        rows = base.values
        safe = np.maximum(rows, 0)
        if col.is_repeated:
            raise TypeError("nested repeated lookup not supported")
        vals = col.values[safe]
        if col.vocab is None:
            vals = np.where(rows >= 0, vals, 0)
        return Val(vals, base.splits, col.vocab)
    if isinstance(expr, TableLookup):
        key = eval_expr(expr.key, ctx)
        rows = expr.table.lookup_rows(key.values, key.vocab)
        return Val(rows, key.splits, table=expr.table)
    if isinstance(expr, MakeProto):
        raise TypeError("proto() must be the top-level map() result")
    if isinstance(expr, ModelApply):
        cols = {name: eval_expr(e, ctx).values for name, e in expr.inputs}
        return Val(np.asarray(expr.model.apply_columns(cols)))
    if isinstance(expr, Func):
        return _eval_func(expr, ctx)
    raise TypeError(f"cannot evaluate {type(expr).__name__}")


def _resolve_col(table: CollectedTable, name: str) -> str:
    if name in table.batch.columns:
        return name
    # allow bare leaf names for nested paths
    cands = [p for p in table.batch.columns if p.split(".")[-1] == name]
    if len(cands) == 1:
        return cands[0]
    raise KeyError(f"ambiguous or missing field {name!r} in collected table")


def _eval_func(expr: Func, ctx: EvalContext) -> Val:
    name = expr.name
    if name == "where":
        c = eval_expr(expr.args[0], ctx)
        a = eval_expr(expr.args[1], ctx)
        b = eval_expr(expr.args[2], ctx)
        fa, fb, sp = _broadcast(a, b, ctx.n)
        fc, _, sp2 = _broadcast(c, a, ctx.n)
        return Val(np.where(fc, fa, fb), sp or sp2)
    if name == "distance":
        # distance(p.polyline): ground length in meters from repeated lat/lng
        f = expr.args[0]
        assert isinstance(f, FieldRef), "distance() needs a polyline field"
        lat = ctx.batch[f.path + ".lat"]
        lng = ctx.batch[f.path + ".lng"]
        sp = lat.row_splits
        if sp is None:
            raise TypeError("distance() needs a repeated lat/lng polyline")
        out = np.zeros(ctx.n, dtype=np.float64)
        if lat.values.size >= 2:
            ix, iy = Mc.latlng_to_xy(lat.values, lng.values)
            x = ix.astype(np.float64)
            y = iy.astype(np.float64)
            seg = np.hypot(np.diff(x), np.diff(y)) \
                * Mc.meters_per_unit_at(lat.values[:-1])
            # diff j joins flat elements j, j+1 — valid iff same row
            lens = np.diff(sp)
            row_of = np.repeat(np.arange(ctx.n), lens)          # [m]
            valid = row_of[:-1] == row_of[1:]
            np.add.at(out, row_of[:-1][valid], seg[valid])
        return Val(out)
    if name == "bloom_contains":
        a = eval_expr(expr.args[0], ctx)
        bf: BloomFilter = expr.args[1].obj
        return Val(bf.contains(a.values, a.vocab), a.splits)
    if name == "interval_overlaps":
        iv: IntervalSet = expr.args[0].obj
        lo = eval_expr(expr.args[1], ctx)
        hi = eval_expr(expr.args[2], ctx)
        return Val(iv.overlapping(lo.values, hi.values), lo.splits)
    if name == "clip":
        a = eval_expr(expr.args[0], ctx)
        lo = expr.args[1].value if isinstance(expr.args[1], Lit) else expr.args[1]
        hi = expr.args[2].value if isinstance(expr.args[2], Lit) else expr.args[2]
        return Val(np.clip(a.values, lo, hi), a.splits)
    raise KeyError(f"unknown WFL function {name!r}")


# ===========================================================================
# Static analysis: required paths + output schema inference
# ===========================================================================

def required_paths(expr: Expr, schema: Schema) -> List[str]:
    """Leaf paths a query touches → minimal viable schema (§4.3.3)."""
    out: set = set()

    def visit(e: Expr):
        if isinstance(e, FieldRef):
            if schema.has(e.path) and schema.field(e.path).type == MESSAGE:
                for p, f in schema.field(e.path).walk(
                        e.path.rsplit(".", 1)[0] + "."
                        if "." in e.path else ""):
                    if f.type != MESSAGE:
                        out.add(p)
            elif schema.has(e.path):
                out.add(e.path)
        if isinstance(e, InRegion):
            out.add(e.field.path + ".lat")
            out.add(e.field.path + ".lng")
            return
        if isinstance(e, (InSpaceTime, InSpaceTimeSeq)):
            out.add(e.field.path + ".lat")
            out.add(e.field.path + ".lng")
            out.add(e.field.path + ".t")
            return
        if isinstance(e, Func) and e.name == "distance":
            f = e.args[0]
            out.add(f.path + ".lat")
            out.add(f.path + ".lng")
            return
        for c in e.children():
            visit(c)

    visit(expr)
    return sorted(p for p in out if schema.has(p))


_NUMERIC_RESULT = {"add", "sub", "mul", "div", "mod", "pow"}
_BOOL_RESULT = {"eq", "ne", "lt", "le", "gt", "ge", "and", "or"}


def infer_spec(expr: Expr, schema: Optional[Schema]) -> Tuple[str, bool]:
    """Infer (type, repeated) — Dynamic Protocol Buffers schema derivation."""
    if isinstance(expr, FieldRef):
        if schema is not None and schema.has(expr.path):
            f = schema.field(expr.path)
            return f.type, f.repeated
        return DOUBLE, False
    if isinstance(expr, Lit):
        v = expr.value
        if isinstance(v, bool):
            return BOOL, False
        if isinstance(v, int):
            return INT, False
        if isinstance(v, str):
            return STRING, False
        return DOUBLE, False
    if isinstance(expr, BinOp):
        ta, ra = infer_spec(expr.a, schema)
        tb, rb = infer_spec(expr.b, schema)
        rep = ra or rb
        if expr.op in _BOOL_RESULT:
            return BOOL, rep
        if expr.op == "div":
            return DOUBLE, rep
        if ta == tb:
            return ta, rep
        return DOUBLE, rep
    if isinstance(expr, UnOp):
        t, r = infer_spec(expr.a, schema)
        return (BOOL, r) if expr.op == "not" else (t if expr.op in
                                                   ("neg", "abs") else DOUBLE, r)
    if isinstance(expr, (InSpaceTime, InSpaceTimeSeq)):
        return BOOL, False            # any-reduced over the track
    if isinstance(expr, (Between, InSet, InRegion)):
        _, r = infer_spec(expr.children()[0], schema)
        return BOOL, r
    if isinstance(expr, Reduce):
        if expr.op == "count":
            return INT, False
        return DOUBLE, False
    if isinstance(expr, GetField):
        base = expr.base
        if isinstance(base, TableLookup):
            tb = base.table.batch
            col_path = _resolve_col(base.table, expr.name)
            col = tb[col_path]
            t = STRING if col.vocab is not None else (
                BOOL if col.values.dtype == np.bool_
                else INT if col.values.dtype.kind in "iu" else DOUBLE)
            _, rep = infer_spec(base.key, schema) if base.key else (None, False)
            return t, rep
        return DOUBLE, False
    if isinstance(expr, TableLookup):
        _, rep = infer_spec(expr.key, schema)
        return INT, rep
    if isinstance(expr, ModelApply):
        return DOUBLE, False
    if isinstance(expr, Func):
        if expr.name in ("bloom_contains", "interval_overlaps"):
            return BOOL, infer_spec(expr.args[0] if expr.name ==
                                    "bloom_contains" else expr.args[1],
                                    schema)[1]
        if expr.name == "where":
            return infer_spec(expr.args[1], schema)
        return DOUBLE, False
    raise TypeError(f"cannot infer type of {type(expr).__name__}")


# ===========================================================================
# Aggregation specs (paper Table 1: aggregate)
# ===========================================================================

class AggSpec:
    """Built by ``group(keys...).count(...).avg(name=expr)...`` chains."""

    def __init__(self, keys: Sequence = ()):
        self.keys: List[Tuple[str, Expr]] = []
        for i, k in enumerate(keys):
            e = _wrap(k)
            name = e.path.replace(".", "_") if isinstance(e, FieldRef) \
                else f"key{i}"
            self.keys.append((name, e))
        self.aggs: List[Tuple[str, str, Optional[Expr]]] = []

    def _add(self, kind, name=None, expr=None, **kw):
        if kw:
            (name, expr), = kw.items()
        if name is None:
            name = kind
        self.aggs.append((kind, name, _wrap(expr) if expr is not None
                          else None))
        return self

    def count(self, name: str = "count"):
        return self._add("count", name)

    def sum(self, name=None, expr=None, **kw):
        return self._add("sum", name, expr, **kw)

    def avg(self, name=None, expr=None, **kw):
        return self._add("avg", name, expr, **kw)

    def std_dev(self, name=None, expr=None, **kw):
        return self._add("std_dev", name, expr, **kw)

    def min(self, name=None, expr=None, **kw):
        return self._add("min", name, expr, **kw)

    def max(self, name=None, expr=None, **kw):
        return self._add("max", name, expr, **kw)

    def approx_distinct(self, name=None, expr=None, **kw):
        """HyperLogLog cardinality (paper §4.2.2)."""
        return self._add("approx_distinct", name, expr, **kw)


def group(*keys) -> AggSpec:
    return AggSpec(keys)
