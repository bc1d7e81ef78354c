"""Keyed result + postings cache for the query-serving layer.

Serving traffic repeats itself — dashboards refresh the same Tesseract,
sessions re-run a refined flow against the same resident FDb — so the
server memoizes two kinds of derived values:

  * ``"result"``  — a finished :class:`~repro_torch.exec.adhoc.QueryResult`
    for one (FDb, plan) pair,
  * ``"postings"`` — the host-built probe bitmaps for one
    (FDb, plan, shard) triple (the index lookups the coalescer runs
    before every wave dispatch).

Keys are SHA-256 digests over a **canonical byte encoding** of the plan
(regions by their cover-range words, windows and paths by value — never
object identity), prefixed with a per-FDb **generation token** drawn
from a ``WeakKeyDictionary``: a rebuilt FDb under the same name gets a
fresh token, so stale entries can never alias a new dataset.  The token
rides *outside* the digest (``b"<token>|<sha256>"``), which is what
makes :meth:`ResultCache.invalidate` possible: when a live
``StreamingFDb`` appends, its mutation hook
(:meth:`repro_torch.fdb.streaming.StreamingFDb.bind_cache`) calls
``invalidate(stale_snapshot)`` — the token is bumped (future lookups
can never match) and every entry carrying the old token prefix is
swept eagerly.  A plan containing something the canonicalizer does not
understand simply is not cacheable (``key_for`` returns ``None``) —
unknown ≠ equal is the safe direction.

Entries carry a per-kind TTL against an **injectable clock** (tests pin
time), and the cache holds an LRU byte budget over the values' reported
sizes.

**Concurrency model.**  One re-entrant lock guards the entry map, byte
accounting, the token table, and the stat counters; every public method
takes it, so the scheduler thread, worker-pool gather tails, and
streaming mutation listeners can call in concurrently.  Every public
entry point also swallows its own errors: a broken cache degrades the
server to recomputation, it never fails a query — the server
additionally wraps its calls, so even a cache object whose methods
raise (fault-injection tests do exactly that) cannot surface.
"""
from __future__ import annotations

import hashlib
import itertools
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["ResultCache", "DEFAULT_TTL_S", "DEFAULT_MAX_BYTES"]

DEFAULT_TTL_S = {"result": 30.0, "postings": 300.0}
DEFAULT_MAX_BYTES = 64 << 20


def _canon(obj, out) -> None:
    """Append a canonical byte encoding of ``obj`` to ``out``.

    Raises ``TypeError`` on anything it cannot canonicalize — the caller
    treats that plan as uncacheable rather than guessing at equality.
    """
    if obj is None:
        out.append(b"N")
    elif isinstance(obj, bool):
        out.append(b"b1" if obj else b"b0")
    elif isinstance(obj, (int, np.integer)):
        out.append(b"i" + str(int(obj)).encode())
    elif isinstance(obj, (float, np.floating)):
        out.append(b"f" + np.float64(obj).tobytes())
    elif isinstance(obj, str):
        out.append(b"s" + obj.encode("utf-8") + b"\x00")
    elif isinstance(obj, bytes):
        out.append(b"y" + obj + b"\x00")
    elif isinstance(obj, np.ndarray):
        out.append(b"a" + obj.dtype.str.encode()
                   + str(obj.shape).encode() + np.ascontiguousarray(obj)
                   .tobytes())
    elif isinstance(obj, (list, tuple)):
        out.append(b"[")
        for e in obj:
            _canon(e, out)
        out.append(b"]")
    elif isinstance(obj, dict):
        out.append(b"{")
        for k in sorted(obj, key=str):
            _canon(str(k), out)
            _canon(obj[k], out)
        out.append(b"}")
    elif hasattr(obj, "lo") and hasattr(obj, "hi") \
            and isinstance(getattr(obj, "lo"), np.ndarray):
        # AreaTree-shaped region: its cover ranges ARE its query meaning
        out.append(b"R")
        _canon(obj.lo, out)
        _canon(obj.hi, out)
    elif hasattr(obj, "__dict__") and type(obj).__module__.startswith(
            "repro_torch."):
        # plan nodes (IndexProbe, RefineSpec, ops, exprs): canonicalize by
        # type name + instance fields; anything exotic inside raises
        out.append(b"O" + type(obj).__qualname__.encode() + b"\x00")
        _canon(vars(obj), out)
    else:
        raise TypeError(f"uncacheable plan element: {type(obj)!r}")


class ResultCache:
    """Hash-keyed TTL + LRU-byte-budget cache (see module docstring)."""

    def __init__(self, ttl_s: Optional[Dict[str, float]] = None,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 clock=time.monotonic):
        self.ttl_s = dict(DEFAULT_TTL_S)
        if ttl_s:
            self.ttl_s.update(ttl_s)
        self.max_bytes = int(max_bytes)
        self.clock = clock
        self._lock = threading.RLock()
        # key → (value, expires_at, nbytes); move-to-end on hit (LRU)
        self._entries: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._nbytes = 0
        self._tokens: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._next_token = itertools.count(1)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.errors = 0
        self.invalidations = 0

    # ------------------------------------------------------------- keying
    def key_for(self, db, plan, kind: str = "result",
                extra=()) -> Optional[bytes]:
        """Cache key for ``plan`` against ``db``, or ``None`` when the
        plan cannot be canonicalized (→ not cacheable, never wrong)."""
        try:
            with self._lock:
                token = self._tokens.get(db)
                if token is None:
                    token = next(self._next_token)
                    self._tokens[db] = token
            out = [kind.encode(), b"\x00"]
            _canon([getattr(plan, "source", None),
                    list(getattr(plan, "shard_ids", ())),
                    getattr(plan, "probes", ()),
                    getattr(plan, "refines", ()),
                    getattr(plan, "residual", None),
                    getattr(plan, "server_ops", ()),
                    getattr(plan, "mixer_ops", ()),
                    list(extra)], out)
            # token outside the digest → invalidate() can sweep by prefix
            return (str(token).encode() + b"|"
                    + hashlib.sha256(b"".join(out)).digest())
        except Exception:
            with self._lock:
                self.errors += 1
            return None

    def invalidate(self, db) -> int:
        """Expire every entry keyed against ``db``'s current generation
        token and issue a fresh token, so no future ``key_for(db, …)``
        can match a pre-invalidation entry.  This is the streaming-append
        hook (:meth:`repro_torch.fdb.streaming.StreamingFDb.bind_cache`).
        Returns the number of entries swept (0 when ``db`` was never
        keyed)."""
        try:
            with self._lock:
                self.invalidations += 1
                old = self._tokens.get(db)
                self._tokens[db] = next(self._next_token)
                if old is None:
                    return 0
                prefix = str(old).encode() + b"|"
                dead = [k for k in self._entries if k.startswith(prefix)]
                for k in dead:
                    _, _, nbytes = self._entries.pop(k)
                    self._nbytes -= nbytes
                return len(dead)
        except Exception:
            with self._lock:
                self.errors += 1
            return 0

    # ------------------------------------------------------------ get/put
    def get(self, kind: str, key: Optional[bytes]):
        """Live value for ``key`` or ``None`` (expired entries evict)."""
        if key is None:
            return None
        try:
            with self._lock:
                ent = self._entries.get(key)
                if ent is None:
                    self.misses += 1
                    return None
                value, expires_at, nbytes = ent
                if self.clock() >= expires_at:
                    del self._entries[key]
                    self._nbytes -= nbytes
                    self.misses += 1
                    return None
                self._entries.move_to_end(key)
                self.hits += 1
                return value
        except Exception:
            with self._lock:
                self.errors += 1
            return None

    def put(self, kind: str, key: Optional[bytes], value,
            nbytes: Optional[int] = None) -> None:
        if key is None:
            return
        try:
            if nbytes is None:
                nbytes = self._sizeof(value)
            ttl = float(self.ttl_s.get(kind, self.ttl_s.get("result", 30.0)))
            expires_at = self.clock() + ttl
            with self._lock:
                old = self._entries.pop(key, None)
                if old is not None:
                    self._nbytes -= old[2]
                self._entries[key] = (value, expires_at, int(nbytes))
                self._nbytes += int(nbytes)
                while self._nbytes > self.max_bytes and len(self._entries) > 1:
                    _, (_, _, nb) = self._entries.popitem(last=False)
                    self._nbytes -= nb
                    self.evictions += 1
                if self._nbytes > self.max_bytes:      # lone oversize entry
                    self._entries.popitem(last=False)
                    self._nbytes = 0
                    self.evictions += 1
        except Exception:
            with self._lock:
                self.errors += 1

    @staticmethod
    def _sizeof(value) -> int:
        batch = getattr(value, "batch", None)
        if batch is not None and hasattr(batch, "nbytes"):
            return int(batch.nbytes())
        if isinstance(value, np.ndarray):
            return int(value.nbytes)
        if isinstance(value, (list, tuple)):
            return sum(int(a.nbytes) for sub in value
                       for a in (sub if isinstance(sub, (list, tuple))
                                 else [sub])
                       if isinstance(a, np.ndarray)) or 64
        return 64

    # -------------------------------------------------------------- admin
    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._nbytes = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries), "nbytes": self._nbytes,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "errors": self.errors,
                    "invalidations": self.invalidations}
