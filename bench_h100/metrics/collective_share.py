"""The collectives' share of the device time of the traced prefills and
decode steps (rank 0's trace of a cell on a mesh): the union of the
device intervals of its ``nccl*Kernel*`` records inside the harness's
``prefill`` and ``decode`` spans (synchronised at both ends, so that a
span holds its own device work) over the union of all its device
intervals there, in %.  An NCCL kernel's time includes its wait for the
other ranks.  DTensor's host cost shows instead as idle
(``device_idle.serve``, ``decode_idle``)."""
from bench_h100.harness.program import merged, overlap_ns


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    spans = merged((a, b) for name, a, b in tr.spans
                   if name in ("prefill", "decode"))
    nccl = merged((a, b) for name, a, b, _ in tr.device
                  if "nccl" in name and "Kernel" in name)
    if not spans or not nccl:
        return None
    busy = overlap_ns(merged((a, b) for _, a, b, _ in tr.device), spans)
    return 100.0 * overlap_ns(nccl, spans) / busy
