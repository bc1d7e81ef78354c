"""Schemas: the Dynamic-Protocol-Buffers analog (paper §4.1.2, §4.3.3).

The paper annotates Protocol Buffers fields with *field options* to declare
indices and column sets, creates schemas dynamically at every pipeline stage
(Dynamic Protocol Buffers), and prunes million-node schema trees down to the
*minimal viable schema* a query touches.

We reproduce the descriptor layer: a :class:`Schema` is a tree of
:class:`Field` descriptors with types ``{bool,int,uint,float,double,string,
message}`` × cardinality ``{singular,repeated}`` plus options:

  * ``index=`` one of ``tag | range | location | area | spacetime`` (and a
    field may carry several indices — "a single field can have multiple
    indices of different types"),
  * ``column_set=`` the column family the field is stored with,
  * ``virtual=`` an expression evaluated at ingest to produce index-only
    values that are never materialized as data columns.

Nested message fields are addressed with dotted paths (``loc.lat``).
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

BOOL, INT, UINT, FLOAT, DOUBLE, STRING, MESSAGE = (
    "bool", "int", "uint", "float", "double", "string", "message")
SCALAR_TYPES = (BOOL, INT, UINT, FLOAT, DOUBLE, STRING)
INDEX_KINDS = ("tag", "range", "location", "area", "spacetime")

__all__ = ["Field", "Schema", "BOOL", "INT", "UINT", "FLOAT", "DOUBLE",
           "STRING", "MESSAGE", "SCALAR_TYPES", "INDEX_KINDS"]


@dataclass
class Field:
    name: str
    type: str
    repeated: bool = False
    fields: List["Field"] = dc_field(default_factory=list)   # for MESSAGE
    indexes: Tuple[str, ...] = ()
    column_set: str = "default"
    virtual: Optional[Callable] = None       # columns-dict -> np array
    index_params: dict = dc_field(default_factory=dict)

    def __post_init__(self):
        if self.type not in SCALAR_TYPES + (MESSAGE,):
            raise ValueError(f"unknown field type {self.type!r}")
        for ix in self.indexes:
            if ix not in INDEX_KINDS:
                raise ValueError(f"unknown index kind {ix!r}")
        if self.type == MESSAGE and self.virtual is not None:
            raise ValueError("virtual fields must be scalar")

    def walk(self, prefix: str = ""):
        path = f"{prefix}{self.name}"
        yield path, self
        for sub in self.fields:
            yield from sub.walk(path + ".")


class Schema:
    """A named tree of fields; the unit registered with the Structure manager."""

    def __init__(self, name: str, fields: Sequence[Field]):
        self.name = name
        self.fields = list(fields)
        self._by_path: Dict[str, Field] = dict(self.walk())
        seen = set()
        for p in self._by_path:
            if p in seen:
                raise ValueError(f"duplicate field path {p!r}")
            seen.add(p)

    # ------------------------------------------------------------- access
    def walk(self):
        for f in self.fields:
            yield from f.walk()

    def field(self, path: str) -> Field:
        try:
            return self._by_path[path]
        except KeyError:
            raise KeyError(f"{self.name} has no field {path!r}; known: "
                           f"{sorted(self._by_path)[:20]}") from None

    def has(self, path: str) -> bool:
        return path in self._by_path

    def leaf_paths(self) -> List[str]:
        return [p for p, f in self._by_path.items() if f.type != MESSAGE]

    def indexed_paths(self) -> List[Tuple[str, Field]]:
        return [(p, f) for p, f in self._by_path.items() if f.indexes]

    def column_sets(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for p, f in self._by_path.items():
            if f.type != MESSAGE and f.virtual is None:
                out.setdefault(f.column_set, []).append(p)
        return out

    def node_count(self) -> int:
        return len(self._by_path)

    # ------------------------------------------- minimal viable schema (§4.3.3)
    def minimal_viable(self, paths: Iterable[str]) -> "Schema":
        """Prune to the smallest field tree covering ``paths``.

        The paper: "generates the minimal viable schema by pruning the
        original structure tree to the smallest set of nodes needed for the
        query at hand (tens of nodes as opposed to millions)".
        """
        want = set()
        for p in paths:
            if not self.has(p):
                raise KeyError(f"unknown field {p!r} in schema {self.name}")
            parts = p.split(".")
            for i in range(1, len(parts) + 1):
                want.add(".".join(parts[:i]))

        def prune(fields: List[Field], prefix: str) -> List[Field]:
            out = []
            for f in fields:
                path = prefix + f.name
                if path in want:
                    if f.type == MESSAGE:
                        kept = prune(f.fields, path + ".")
                        out.append(Field(f.name, f.type, f.repeated, kept,
                                         f.indexes, f.column_set, f.virtual,
                                         f.index_params))
                    else:
                        out.append(f)
                elif any(w.startswith(path + ".") for w in want):
                    kept = prune(f.fields, path + ".")
                    out.append(Field(f.name, f.type, f.repeated, kept,
                                     f.indexes, f.column_set, f.virtual,
                                     f.index_params))
            return out

        return Schema(self.name + "#mvs", prune(self.fields, ""))

    # ------------------------------------------------ dynamic schemas (§4.3.3)
    @staticmethod
    def dynamic(name: str, spec: Dict[str, object]) -> "Schema":
        """Create a schema at runtime from ``{path: type | (type, repeated)}``.

        This is how every WFL pipeline stage gets its implicit output schema
        — the Dynamic Protocol Buffers mechanism.  Dotted paths create nested
        message fields on the fly.
        """
        root: dict = {}
        for path, t in spec.items():
            repeated = False
            if isinstance(t, tuple):
                t, repeated = t
            parts = path.split(".")
            node = root
            for part in parts[:-1]:
                node = node.setdefault(part, {})
                if not isinstance(node, dict):
                    raise ValueError(f"field conflict at {part!r} in {path!r}")
            node[parts[-1]] = (t, repeated)

        def build(node: dict) -> List[Field]:
            out = []
            for fname, val in node.items():
                if isinstance(val, dict):
                    out.append(Field(fname, MESSAGE, fields=build(val)))
                else:
                    t, rep = val
                    out.append(Field(fname, t, repeated=rep))
            return out

        return Schema(name, build(root))

    def spec(self) -> Dict[str, object]:
        """Inverse of :meth:`dynamic` (leaf paths only)."""
        return {p: (f.type, f.repeated) for p, f in self._by_path.items()
                if f.type != MESSAGE}

    def __repr__(self):
        return f"Schema({self.name!r}, {self.node_count()} nodes)"
