"""Query sessions (paper §3.1).

"Query sessions to incrementally build and run queries with partial context
kept in the cluster while the user refines the query.  Also, full
auto-complete support … not just for the language but also for the
structure of the data, and the data values themselves."

A :class:`Session` keeps named intermediate results (collected tables) so a
REPL user can refine a pipeline without re-running earlier stages, and
offers structure- and value-aware completion:

  * ``complete("Roads.")``       → field paths of the Roads schema
  * ``complete("Roads.city=S")`` → values of the city column starting "S"
    (served from the shard tag indices — no data scan)
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..fdb.schema import MESSAGE
from .exprs import CollectedTable
from .flow import Flow, fdb as _fdb

__all__ = ["Session"]


class Session:
    def __init__(self, engine=None, catalog=None, backend=None,
                 config=None):
        """``config`` is an :class:`repro_torch.exec.ExecConfig` bundling the
        execution knobs (backend/wave/partitions/fused/profile) when no
        explicit engine is supplied; the legacy ``backend`` kwarg
        ("numpy", "torch", or an ExecBackend instance) remains as a shim."""
        if engine is None:
            if backend is not None or config is not None:
                from ..exec.adhoc import AdHocEngine
                engine = AdHocEngine(catalog=catalog, backend=backend,
                                     config=config)
            else:
                from ..exec.adhoc import default_engine
                engine = default_engine()
        self.engine = engine
        self.catalog = catalog or engine.catalog
        self.vars: Dict[str, Any] = {}

    # ---------------------------------------------------------------- flows
    def fdb(self, name: str) -> Flow:
        return _fdb(name, session=self)

    def run(self, flow: Flow, name: Optional[str] = None, **kw
            ) -> CollectedTable:
        """Collect and (optionally) keep the result in session context."""
        res = flow.collect(engine=self.engine, **kw)
        if name is not None:
            self.vars[name] = res
        return res

    def __getitem__(self, name: str) -> Any:
        return self.vars[name]

    def serve(self, **kw):
        """A :class:`~repro_torch.serve.QueryServer` bound to this
        session's engine: concurrent submits against the session's
        resident FDbs coalesce into shared multi-query wave dispatches,
        with admission bounds and a TTL result cache (see
        :mod:`repro_torch.serve`)."""
        from ..serve import QueryServer
        return QueryServer(engine=self.engine, **kw)

    # ---------------------------------------------------------- completion
    def complete(self, text: str, limit: int = 20) -> List[str]:
        # value completion: "Db.path=prefix"
        if "=" in text:
            lhs, prefix = text.split("=", 1)
            db_name, _, path = lhs.partition(".")
            db = self.catalog.get(db_name)
            out: set = set()
            for shard in db.shards:
                idx = shard.index(path, "tag")
                if idx is not None and idx.vocab is not None:
                    out.update(v for v in idx.vocab
                               if v.startswith(prefix))
                elif path in shard.batch.columns:
                    col = shard.batch[path]
                    if col.vocab is not None:
                        out.update(v for v in col.vocab
                                   if v.startswith(prefix))
                if len(out) >= limit:
                    break
            return sorted(out)[:limit]
        # structure completion: "Db.pre" → field paths
        if "." in text:
            db_name, _, prefix = text.partition(".")
            if db_name in self.catalog.names():
                schema = self.catalog.schema_of(db_name)
                return sorted(p for p, f in schema.walk()
                              if p.startswith(prefix))[:limit]
        # dataset completion
        return sorted(n for n in self.catalog.names()
                      if n.startswith(text))[:limit]
