"""The expert FFNs' capacity slots that hold a token: the port's
``moe.dispatched`` over ``moe.slots`` (groups × experts × capacity),
counted by its routing while the profiler recorded, in %.  The
assignments dropped at capacity are ``moe.assigned - moe.dispatched``."""
from bench_h100.harness.program import records, tracing


def read(run):
    recs = records(run)
    if recs is None or not any(r.name == "moe" for r in recs):
        return None
    c = tracing(run).counters()
    if not c.get("moe.slots"):
        return None
    return 100.0 * c["moe.dispatched"] / c["moe.slots"]
