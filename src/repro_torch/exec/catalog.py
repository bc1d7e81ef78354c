"""Catalog & Structure managers (paper §4.3.1).

"*Structure manager* maintains a global repository of Protocol Buffers
structures defined statically or registered at run-time.  *Catalog manager*
maintains pointers to all registered FDbs, and maps them to Servers for
query and load distribution."

The Catalog manager here also owns *execution isolation* (§4.3.5): each
query must acquire a micro-cluster of server slots before it runs; when the
pool is exhausted, queries wait in a FIFO queue ("if resources are not
immediately available then the query waits in a queue").
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..fdb.fdb import FDb
from ..fdb.schema import Schema

__all__ = ["Catalog", "StructureManager", "ResourceManager",
           "default_catalog"]


class StructureManager:
    def __init__(self):
        self._schemas: Dict[str, Schema] = {}

    def register(self, schema: Schema) -> None:
        self._schemas[schema.name] = schema

    def get(self, name: str) -> Schema:
        if name not in self._schemas:
            raise KeyError(f"schema {name!r} not registered; known: "
                           f"{sorted(self._schemas)}")
        return self._schemas[name]

    def names(self) -> List[str]:
        return sorted(self._schemas)


class ResourceManager:
    """Server-slot pool with FIFO admission (execution isolation, §4.3.5)."""

    def __init__(self, total_slots: int = 64):
        self.total_slots = total_slots
        self._free = total_slots
        self._cv = threading.Condition()
        self.stats = {"queries": 0, "waited": 0}

    def acquire(self, want: int, timeout: Optional[float] = None) -> int:
        """Blocks until ``min(want, total)`` slots are available; returns
        the grant size."""
        want = max(1, min(want, self.total_slots))
        with self._cv:
            self.stats["queries"] += 1
            if self._free < want:
                self.stats["waited"] += 1
            ok = self._cv.wait_for(lambda: self._free >= want,
                                   timeout=timeout)
            if not ok:
                raise TimeoutError("resource allocation timed out "
                                   "(query queue)")
            self._free -= want
            return want

    def release(self, n: int) -> None:
        with self._cv:
            self._free += n
            self._cv.notify_all()


class Catalog:
    """Registered FDbs + schemas + the shared server pool.

    Sources come in two flavours: **static** (a built :class:`FDb`) and
    **live** (a :class:`~repro_torch.fdb.streaming.StreamingFDb` — anything
    with a ``snapshot()`` method).  ``get`` on a live source returns its
    current generation snapshot, so every query plans against a fresh,
    immutable view; the planner pins that snapshot into ``Plan.db`` and
    engines execute against the pin, never a re-resolve.  :meth:`live`
    exposes the mutable handle itself (the serve tier uses it to wire
    cache-invalidation listeners)."""

    def __init__(self, server_slots: int = 64):
        self._dbs: Dict[str, FDb] = {}
        self._live: Dict[str, object] = {}     # name → StreamingFDb
        self.structures = StructureManager()
        self.resources = ResourceManager(server_slots)

    def register(self, db) -> None:
        """Register a static ``FDb`` or a live streaming source (any
        object with ``name``/``schema``/``snapshot()``)."""
        if isinstance(db, FDb):
            self._dbs[db.name] = db
            self._live.pop(db.name, None)
        elif hasattr(db, "snapshot"):
            self._live[db.name] = db
            self._dbs.pop(db.name, None)
        else:
            raise TypeError(f"cannot register {type(db).__name__}: "
                            f"expected FDb or a snapshot()-able source")
        self.structures.register(db.schema)

    def get(self, name: str) -> FDb:
        live = self._live.get(name)
        if live is not None:
            return live.snapshot()
        if name not in self._dbs:
            raise KeyError(f"FDb {name!r} not registered; known: "
                           f"{sorted(set(self._dbs) | set(self._live))}")
        return self._dbs[name]

    def live(self, name: str):
        """The mutable streaming handle behind ``name``, or ``None`` for
        static (or unknown) sources."""
        return self._live.get(name)

    def schema_of(self, name: str) -> Schema:
        live = self._live.get(name)
        if live is not None:
            return live.schema
        return self.get(name).schema

    def names(self) -> List[str]:
        return sorted(set(self._dbs) | set(self._live))


_DEFAULT: Optional[Catalog] = None


def default_catalog() -> Catalog:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Catalog()
    return _DEFAULT
