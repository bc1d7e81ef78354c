"""The MoE tails (norm, the routing, the dense [G, S, E, C] dispatch, the
expert FFNs, the combine, the residual): their share of the prefill, Σ
device time of the port's ``moe`` spans inside its ``prefill`` spans
over Σ device time of those prefills (the profiled half of a traced
run), in %."""
from bench_h100.harness.program import prefill_share


def read(run):
    return prefill_share(run, "moe")
