"""The Mamba layers' mixer half (norm, the projections, the causal conv,
row 10 and the float32 chunk passes around it, the residual): their
share of the prefill, Σ device time of the port's ``mamba`` spans inside
its ``prefill`` spans over Σ device time of those prefills (the profiled
half of a traced run), in %."""
from bench_h100.harness.program import prefill_share


def read(run):
    return prefill_share(run, "mamba")
