"""Query-serving subsystem: multi-query coalescing, admission, caching.

``QueryServer`` fronts an :class:`~repro_torch.exec.adhoc.AdHocEngine` with a
bounded admission queue, a coalescing scheduler that batches compatible
concurrent queries into single multi-query wave dispatches
(``ExecBackend.run_wave_fused_multi``), and a TTL result + postings
cache that degrades to recomputation on any fault.
"""
from .result_cache import ResultCache
from .server import QueryServer, ServerBusy

__all__ = ["QueryServer", "ServerBusy", "ResultCache"]
