"""The share of the traced window in which no operation ran on the card:
1 - (the union of the device's intervals) / window, in %."""
from bench_h100.harness.trace import idle_pct


def read(run):
    return idle_pct(run.trace)
