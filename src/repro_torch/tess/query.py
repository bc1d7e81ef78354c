"""Tesseract queries: multi-constraint space-time trip selection (paper §2).

The paper's motivating workload: *"all trips passing through region A during
time window T1 and region B during T2"*.  A :class:`Tesseract` is the
constraint builder —

    tess = Tesseract(region_a, t0, t1).also(region_b, t2, t3)
    trips = fdb("Trips").tesseract(tess).collect()

and ``then()`` / ``before()`` add *ordering* edges — "through region A
during T1 **and then** region B during T2" — which ride the same refine
pass: the kernel also min-reduces a per-(doc × constraint) **first-hit**
packed timestamp, and the ordering DAG is a strict-less compare over that
table, applied device-side before the mask feeds ``compact_masks``.

The same one-hot compare pass carries the whole reduction family at zero
extra launches: :meth:`Tesseract.at_least` counts a constraint's hits
("≥ k points in A"), and :meth:`Tesseract.dwell` max-reduces a last-hit
table next to the first-hit one and requires ``last − first >= min_s``
seconds in the region.  Constraints can be named (``also(...,
label="work")``) and ordering edges then read ``before("home", "work")``
— the int-index form keeps working.

Each unordered constraint becomes one
:class:`~repro_torch.core.exprs.InSpaceTime` conjunct (ordered builders — and
any builder carrying count/dwell reductions — compile to a single
:class:`~repro_torch.core.exprs.InSpaceTimeSeq` node).
The planner compiles every conjunct into a ``spacetime`` index probe *and*
a :class:`~repro_torch.core.planner.RefineSpec`: per shard, all constraint
postings bitmaps are stacked into **one** batched ``bitset`` kernel launch
through the ``ExecBackend`` seam (``probe_shards`` → ``intersect_bitmaps``),
and the exact pass (point-in-cover × time-window over the ragged track)
runs as **one** fused device launch per wave behind the backend's
``refine_tracks_batched`` op — the CUDA ``refine`` kernel on the torch
backend, a vectorized numpy oracle on the host backend — whose per-doc hit
masks feed the existing ``compact_masks`` selection.  Nothing about the
exact pass runs per-shard on the host anymore; the residual filter is only
used for non-Tesseract conjuncts.

:func:`tesseract_stats` mirrors that hot path outside an engine, reporting
index-probe candidate counts vs. exact-refine counts per shard — the
pruning-ratio evidence the benchmarks track.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

from ..core.exprs import ExprProxy, FieldRef, InSpaceTime, InSpaceTimeSeq
from ..geo.areatree import AreaTree

__all__ = ["Tesseract", "tesseract_stats"]


class Tesseract:
    """Immutable builder of space-time constraints (AND semantics).

    ``also()`` adds an unordered constraint; ``then()`` adds a *sequenced*
    one — the trip's first hit of the previous constraint must be strictly
    before its first hit of the new one (A **then** B).  ``before(i, j)``
    is the general form: an ordering edge between any two constraints by
    index *or label*, so arbitrary ordering DAGs compose on top of
    ``also()``.  ``at_least(k)`` / ``dwell(min_s)`` attach count/dwell
    reductions to a constraint (the most recent by default).
    """

    def __init__(self, region: AreaTree, t0: float, t1: float,
                 field: str = "track", label: Optional[str] = None):
        if t1 < t0:
            raise ValueError("Tesseract window with t1 < t0")
        self.field = field
        self.constraints: Tuple[Tuple[AreaTree, float, float], ...] = (
            (region, float(t0), float(t1)),)
        self.order_edges: Tuple[Tuple[int, int], ...] = ()
        self._labels: Tuple[Optional[str], ...] = (label,)
        self._min_counts: Tuple[int, ...] = (1,)
        self._dwells: Tuple[Optional[float], ...] = (None,)

    def _copy(self) -> "Tesseract":
        out = Tesseract.__new__(Tesseract)
        out.field = self.field
        out.constraints = self.constraints
        out.order_edges = self.order_edges
        out._labels = self._labels
        out._min_counts = self._min_counts
        out._dwells = self._dwells
        return out

    # ------------------------------------------------------------ reductions
    @property
    def min_counts(self) -> Optional[Tuple[int, ...]]:
        """Per-constraint hit-count thresholds, or ``None`` when every
        constraint keeps the default any-hit (k = 1) verdict."""
        if all(k == 1 for k in self._min_counts):
            return None
        return self._min_counts

    @property
    def dwells(self) -> Optional[Tuple[Optional[float], ...]]:
        """Per-constraint dwell thresholds (seconds), or ``None`` when no
        constraint carries one."""
        if all(d is None for d in self._dwells):
            return None
        return self._dwells

    @property
    def labels(self) -> Tuple[Optional[str], ...]:
        return self._labels

    def _resolve(self, c: Union[int, str], what: str) -> int:
        """Constraint selector → index: ints pass through (bounds-checked),
        strings resolve against the labels given to ``also(label=...)``."""
        n = len(self.constraints)
        if isinstance(c, str):
            try:
                return self._labels.index(c)
            except ValueError:
                known = [x for x in self._labels if x is not None]
                raise ValueError(
                    f"{what}: no constraint labelled {c!r} "
                    f"(labels: {known})") from None
        i = int(c)
        if not (0 <= i < n):
            raise ValueError(f"{what}({c}) with {n} constraints")
        return i

    def at_least(self, k: int,
                 constraint: Union[int, str, None] = None) -> "Tesseract":
        """Require ≥ ``k`` track points satisfying a constraint (the most
        recently added one by default; pick another by index or label).
        ``k = 1`` is the plain any-hit verdict; ``k = 0`` makes the
        constraint vacuous — it stops filtering (and the planner drops its
        index probe so un-hit docs survive to the exact pass)."""
        k = int(k)
        if k < 0:
            raise ValueError(f"at_least({k}): count must be >= 0")
        i = len(self.constraints) - 1 if constraint is None \
            else self._resolve(constraint, "at_least")
        out = self._copy()
        mc = list(out._min_counts)
        mc[i] = k
        out._min_counts = tuple(mc)
        return out

    def dwell(self, min_s: float,
              constraint: Union[int, str, None] = None) -> "Tesseract":
        """Require the trip to have *dwelled* ≥ ``min_s`` seconds in a
        constraint (the most recently added one by default): at least one
        hit, and ``t(last hit) − t(first hit) >= min_s`` — inclusive at
        the threshold, so a pair of hits exactly ``min_s`` apart passes
        and a single hit satisfies only ``min_s = 0``.  Rides the same
        refine dispatch as the hit mask (a last-hit max-reduce next to the
        first-hit min-reduce)."""
        min_s = float(min_s)
        if min_s < 0:
            raise ValueError(f"dwell({min_s}): seconds must be >= 0")
        i = len(self.constraints) - 1 if constraint is None \
            else self._resolve(constraint, "dwell")
        out = self._copy()
        dw = list(out._dwells)
        dw[i] = min_s
        out._dwells = tuple(dw)
        return out

    # ----------------------------------------------------------- constraints
    def also(self, region: AreaTree, t0: float, t1: float,
             label: Optional[str] = None) -> "Tesseract":
        """Add another constraint: ... AND through ``region`` during
        ``[t0, t1]`` (no ordering between this and other constraints).
        ``label`` names the constraint for ``before()`` / ``at_least()`` /
        ``dwell()`` selectors."""
        if t1 < t0:
            raise ValueError("Tesseract window with t1 < t0")
        if label is not None and label in self._labels:
            raise ValueError(f"duplicate constraint label {label!r}")
        out = self._copy()
        out.constraints = self.constraints + ((region, float(t0),
                                               float(t1)),)
        out._labels = self._labels + (label,)
        out._min_counts = self._min_counts + (1,)
        out._dwells = self._dwells + (None,)
        return out

    def then(self, region: AreaTree, t0: float, t1: float,
             label: Optional[str] = None) -> "Tesseract":
        """Add a *sequenced* constraint: ... AND THEN through ``region``
        during ``[t0, t1]`` — the trip's first hit of the previous
        constraint must be strictly before its first hit of this one.
        Equal first-hit timestamps do not count as before (tie ⇒ no
        match).  Chains compose: ``A.then(B).then(C)`` requires
        first(A) < first(B) < first(C)."""
        out = self.also(region, t0, t1, label=label)
        k = len(out.constraints) - 1
        out.order_edges = self.order_edges + ((k - 1, k),)
        return out

    def before(self, i: Union[int, str], j: Union[int, str]) -> "Tesseract":
        """Ordering edge between two existing constraints, by index or by
        the label given to ``also(label=...)``: the first hit of
        constraint ``i`` must be strictly before the first hit of ``j`` —
        ``then()`` is sugar for ``also(...).before(k-1, k)``."""
        ii = self._resolve(i, "before")
        jj = self._resolve(j, "before")
        if ii == jj:
            raise ValueError("before() needs two distinct constraints")
        out = self._copy()
        out.order_edges = self.order_edges + ((ii, jj),)
        return out

    def expr(self, field: Optional[str] = None) -> ExprProxy:
        """The WFL predicate — usable directly in ``find()`` and composable
        with other conjuncts.  Unordered, reduction-free constraints
        compile to an AND of per-constraint ``InSpaceTime`` nodes; any
        ordering edge or count/dwell reduction promotes the whole builder
        to a single ``InSpaceTimeSeq`` node so edges and reduction tuples
        travel with the constraint list into the planner."""
        fr = FieldRef(field or self.field)
        if self.order_edges or self.min_counts is not None \
                or self.dwells is not None:
            return ExprProxy(InSpaceTimeSeq(fr, self.constraints,
                                            self.order_edges,
                                            self.min_counts, self.dwells))
        out: Optional[ExprProxy] = None
        for region, t0, t1 in self.constraints:
            e = ExprProxy(InSpaceTime(fr, region, t0, t1))
            out = e if out is None else (out & e)
        return out

    def __repr__(self):
        extras = []
        if self.order_edges:
            extras.append(f"{len(self.order_edges)} ordering edges")
        if self.min_counts is not None:
            extras.append("counts")
        if self.dwells is not None:
            extras.append("dwell")
        tail = (", " + ", ".join(extras)) if extras else ""
        return (f"Tesseract({self.field!r}, "
                f"{len(self.constraints)} constraints{tail})")


def tesseract_stats(db, tess: Tesseract, backend=None,
                    wave: Optional[int] = None) -> Dict[str, Any]:
    """Per-shard index-probe candidates vs. exact-refine survivors.

    Runs the same hot loop the engines run, through the batched seam: per
    wave of shards, one stacked ``probe_shards`` launch ANDs every
    constraint's postings bitmaps, one ``refine_tracks_batched`` launch
    evaluates the exact point-in-cover × time-window pass on device over
    the resident ragged tracks, and one ``compact_masks`` launch per mask
    set turns the bitmaps into candidate/survivor ids.  Reports the
    pruning ratio (fraction of docs the index never touched); 0.0 on an
    empty FDb (an index over zero docs has pruned nothing).  Constraints
    made vacuous with ``at_least(0)`` skip their index probe (their
    postings are not a superset of "always true").
    """
    from ..exec.backend import as_backend     # lazy: exec imports core
    from ..exec.batched import partition_waves, wave_size
    from ..fdb.index import mask_from_bitmap
    be = as_backend(backend)
    be.prime_fdb(db)
    mins = tess.min_counts
    probe_cs = [c for c in range(len(tess.constraints))
                if mins is None or mins[c] != 0]
    per_shard: List[Dict[str, int]] = []
    docs = candidates = refined = 0
    for sids in partition_waves(range(db.num_shards), wave_size(wave, be)):
        shards = [db.shards[sid] for sid in sids]
        idxs = [sh.index(tess.field, "spacetime") for sh in shards]
        if any(ix is None for ix in idxs):
            raise RuntimeError(f"{db.name}.{tess.field} has no spacetime "
                               f"index")
        bms = be.probe_shards(
            [sh.all_bitmap() for sh in shards],
            [[ix.lookup(*tess.constraints[c]) for c in probe_cs]
             for ix in idxs])
        cand_masks = [mask_from_bitmap(bm, sh.n)
                      for bm, sh in zip(bms, shards)]
        ids_list = be.compact_masks(cand_masks)
        refined_masks = be.refine_tracks_batched(
            [sh.batch for sh in shards], tess.field, tess.constraints,
            cand_masks, edges=tess.order_edges,
            min_counts=mins, dwells=tess.dwells)
        keeps = be.compact_masks(refined_masks)
        for sid, sh, ids, keep in zip(sids, shards, ids_list, keeps):
            per_shard.append({"shard": sid, "docs": sh.n,
                              "candidates": int(ids.size),
                              "refined": int(keep.size)})
            docs += sh.n
            candidates += int(ids.size)
            refined += int(keep.size)
    return {"docs": docs, "candidates": candidates, "refined": refined,
            "pruning": (1.0 - candidates / docs) if docs else 0.0,
            "per_shard": per_shard}
