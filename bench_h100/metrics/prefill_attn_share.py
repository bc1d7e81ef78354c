"""The attention layers' mixer half (norm, the projections, RoPE, row 9,
the output product, the residual): their share of the prefill, Σ device
time of the port's ``attn`` spans inside its ``prefill`` spans over Σ
device time of those prefills (the profiled half of a traced run), in %."""
from bench_h100.harness.program import prefill_share


def read(run):
    return prefill_share(run, "attn")
