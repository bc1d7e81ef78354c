"""Tesseract: space-time trip indexing and multi-constraint queries.

The subsystem behind the paper's headline workload — "all trips passing
through region A during time window T1 and region B during T2" (§2, §6):

  * :class:`SpaceTimeIndex` — per-shard (area-tree cell × time bucket)
    postings bitmaps over repeated track fields, built at ``build_fdb``
    time next to ``TagIndex``/``RangeIndex`` (declare
    ``indexes=("spacetime",)`` on the track message field),
  * :class:`Tesseract` — the constraint builder whose predicate compiles
    to stacked bitmap AND work on the ``ExecBackend`` seam plus the exact
    refine pass, itself a fused device op (``refine_tracks_batched`` →
    the CUDA ``refine`` kernel over the shard's resident CSR track
    buffers; see ``Flow.tesseract``, ``repro_torch.core.planner`` and
    ``repro_torch.exec.refine``).  ``then()`` / ``before()`` add *ordering*
    edges (A **then** B), resolved in the same fused pass via
    per-constraint first-hit timestamps,
  * :func:`tesseract_stats` — index-probe candidates vs. exact survivors,
    the pruning-ratio report the benchmarks track.
"""
from .index import SpaceTimeIndex
from .query import Tesseract, tesseract_stats

__all__ = ["SpaceTimeIndex", "Tesseract", "tesseract_stats"]
