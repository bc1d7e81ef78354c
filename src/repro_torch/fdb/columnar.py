"""Column-first record batches (paper §4.1.1: FDb data layout).

FDb "stores data values organized by column sets".  A :class:`ColumnBatch`
is the in-memory unit: a dict of dotted leaf paths → :class:`Column`.

  * singular fields → dense array ``values[n]``
  * repeated fields → ragged pair ``(values[m], row_splits[n+1])``; all
    leaves under the same repeated ancestor share one row_splits array
  * strings → dictionary-encoded ``int32`` codes + per-column vocab (this is
    also what makes tag indices and device-side group-bys cheap)

Gather/concat are the two primitives the query engine needs: index-selected
reads gather only matching docs ("read column-wise from the column sets"),
and the Mixer concatenates partial results.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence

import numpy as np

from .schema import Schema, MESSAGE, STRING, BOOL, INT, UINT, FLOAT, DOUBLE

_DTYPES = {BOOL: np.bool_, INT: np.int64, UINT: np.uint64,
           FLOAT: np.float32, DOUBLE: np.float64, STRING: np.int32}

__all__ = ["Column", "ColumnBatch", "dtype_for", "span_indices"]


def dtype_for(ftype: str):
    return _DTYPES[ftype]


def span_indices(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Concatenate integer ranges ``[starts[i], ends[i])`` into one flat
    int64 index array, fully vectorized (no per-span Python loop).

    This is the spans-concatenate gather behind every CSR read: ragged
    column gathers, postings-list unions, and candidate track slicing.
    """
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(ends, dtype=np.int64) - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    offsets = np.cumsum(lens) - lens               # flat start of each span
    return np.repeat(starts - offsets, lens) + np.arange(total,
                                                         dtype=np.int64)


@dataclass
class Column:
    values: np.ndarray
    row_splits: Optional[np.ndarray] = None        # int64 [n+1] if repeated
    vocab: Optional[List[str]] = None              # strings only

    @property
    def is_repeated(self) -> bool:
        return self.row_splits is not None

    @property
    def num_rows(self) -> int:
        if self.row_splits is not None:
            return self.row_splits.size - 1
        return self.values.shape[0]

    # ------------------------------------------------------------- strings
    def decode(self):
        """Materialize strings (host-side display/collect only)."""
        if self.vocab is None:
            return self.values
        v = np.asarray(self.vocab, dtype=object)
        return v[self.values]

    # -------------------------------------------------------------- gather
    def gather(self, ids: np.ndarray) -> "Column":
        ids = np.asarray(ids, dtype=np.int64)
        if not self.is_repeated:
            return Column(self.values[ids], None, self.vocab)
        starts = self.row_splits[ids]
        ends = self.row_splits[ids + 1]
        new_splits = np.zeros(ids.size + 1, dtype=np.int64)
        np.cumsum(ends - starts, out=new_splits[1:])
        flat = span_indices(starts, ends)          # kept elements, in order
        return Column(self.values[flat], new_splits, self.vocab)

    @staticmethod
    def concat(cols: Sequence["Column"]) -> "Column":
        cols = [c for c in cols]
        if not cols:
            raise ValueError("concat of zero columns")
        rep = cols[0].is_repeated
        if any(c.is_repeated != rep for c in cols):
            raise ValueError("mixed cardinality in concat")
        if cols[0].vocab is not None:
            # Merge vocabs, remap codes.
            merged: Dict[str, int] = {}
            parts = []
            for c in cols:
                remap = np.array([merged.setdefault(s, len(merged))
                                  for s in c.vocab], dtype=np.int32) \
                    if c.vocab else np.zeros(0, dtype=np.int32)
                parts.append(remap[c.values] if c.values.size else c.values)
            vocab = [None] * len(merged)
            for s, i in merged.items():
                vocab[i] = s
            values = np.concatenate(parts) if parts else np.zeros(0, np.int32)
        else:
            vocab = None
            values = np.concatenate([c.values for c in cols])
        if not rep:
            return Column(values, None, vocab)
        offsets = np.cumsum([0] + [c.values.shape[0] for c in cols])
        splits = np.concatenate(
            [np.asarray([0], dtype=np.int64)]
            + [c.row_splits[1:] + off for c, off in zip(cols, offsets)])
        return Column(values, splits, vocab)

    @staticmethod
    def from_strings(strings: Sequence[str],
                     row_splits: Optional[np.ndarray] = None) -> "Column":
        table: Dict[str, int] = {}
        codes = np.array([table.setdefault(s, len(table)) for s in strings],
                         dtype=np.int32)
        vocab = [None] * len(table)
        for s, i in table.items():
            vocab[i] = s
        return Column(codes, row_splits, vocab)


class ColumnBatch:
    """n rows of a schema, stored column-first."""

    def __init__(self, schema: Schema, columns: Dict[str, Column], n: int):
        self.schema = schema
        self.columns = columns
        self.n = int(n)
        for p, c in columns.items():
            if c.num_rows != self.n:
                raise ValueError(f"column {p!r} has {c.num_rows} rows, "
                                 f"batch has {self.n}")

    # ------------------------------------------------------------- access
    def __getitem__(self, path: str) -> Column:
        return self.columns[path]

    def __contains__(self, path: str) -> bool:
        return path in self.columns

    def paths(self) -> List[str]:
        return sorted(self.columns)

    def gather(self, ids: np.ndarray) -> "ColumnBatch":
        return ColumnBatch(self.schema,
                           {p: c.gather(ids) for p, c in self.columns.items()},
                           len(ids))

    def select_paths(self, paths: Sequence[str]) -> "ColumnBatch":
        return ColumnBatch(self.schema.minimal_viable(paths),
                           {p: self.columns[p] for p in paths}, self.n)

    @staticmethod
    def concat(batches: Sequence["ColumnBatch"]) -> "ColumnBatch":
        batches = list(batches)
        if not batches:
            raise ValueError("concat of zero batches")
        if len(batches) == 1:
            return batches[0]
        paths = batches[0].paths()
        cols = {p: Column.concat([b[p] for b in batches]) for p in paths}
        return ColumnBatch(batches[0].schema, cols,
                           sum(b.n for b in batches))

    def nbytes(self) -> int:
        tot = 0
        for c in self.columns.values():
            tot += c.values.nbytes
            if c.row_splits is not None:
                tot += c.row_splits.nbytes
        return tot

    # ------------------------------------------------------ records <-> cols
    @staticmethod
    def from_records(schema: Schema, records: Sequence[dict]) -> "ColumnBatch":
        n = len(records)
        cols: Dict[str, Column] = {}
        splits_cache: Dict[str, np.ndarray] = {}

        def rep_root(path: str) -> Optional[str]:
            parts = path.split(".")
            for i in range(1, len(parts) + 1):
                pre = ".".join(parts[:i])
                if schema.field(pre).repeated:
                    return pre
            return None

        def get(rec: dict, path: str):
            node = rec
            for part in path.split("."):
                if node is None:
                    return None
                if isinstance(node, list):
                    node = [x.get(part) if isinstance(x, dict) else None
                            for x in node]
                else:
                    node = node.get(part) if isinstance(node, dict) else None
            return node

        for path in schema.leaf_paths():
            f = schema.field(path)
            if f.virtual is not None:
                continue
            root = rep_root(path)
            if root is None:
                raw = [get(r, path) for r in records]
                if f.type == STRING:
                    cols[path] = Column.from_strings(
                        ["" if v is None else str(v) for v in raw])
                else:
                    fill = False if f.type == BOOL else 0
                    arr = np.array([fill if v is None else v for v in raw],
                                   dtype=_DTYPES[f.type])
                    cols[path] = Column(arr)
            else:
                flat: list = []
                lens = np.zeros(n, dtype=np.int64)
                for i, r in enumerate(records):
                    v = get(r, path)
                    if v is None:
                        v = []
                    elif not isinstance(v, list):
                        v = [v]
                    lens[i] = len(v)
                    flat.extend(v)
                if root not in splits_cache:
                    sp = np.zeros(n + 1, dtype=np.int64)
                    np.cumsum(lens, out=sp[1:])
                    splits_cache[root] = sp
                sp = splits_cache[root]
                if int(sp[-1]) != len(flat):
                    raise ValueError(
                        f"ragged mismatch under repeated field {root!r} "
                        f"at leaf {path!r}")
                if f.type == STRING:
                    cols[path] = Column.from_strings(
                        [str(x) for x in flat], sp)
                else:
                    arr = np.array(flat, dtype=_DTYPES[f.type]) if flat \
                        else np.zeros(0, dtype=_DTYPES[f.type])
                    cols[path] = Column(arr, sp)
        return ColumnBatch(schema, cols, n)

    def to_records(self) -> List[dict]:
        out: List[dict] = [dict() for _ in range(self.n)]

        def put(rec: dict, path: str, value):
            parts = path.split(".")
            node = rec
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = value

        for path, c in self.columns.items():
            vals = c.decode()
            if c.is_repeated:
                for i in range(self.n):
                    seg = vals[c.row_splits[i]:c.row_splits[i + 1]]
                    put(out[i], path, list(seg.tolist()))
            else:
                for i in range(self.n):
                    v = vals[i]
                    put(out[i], path,
                        v.item() if isinstance(v, np.generic) else v)
        return out

    def __repr__(self):
        return (f"ColumnBatch({self.schema.name!r}, n={self.n}, "
                f"cols={len(self.columns)})")
