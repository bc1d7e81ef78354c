"""The share of the traced window in which the card was idle while the
host was inside one of the port's ``decode`` spans (``LM.decode_step``):
the overlap of the trace's device-idle gaps with those spans, over the
window, in %.  With ``batch_idle`` it adds up to at most
``device_idle.serve``."""
from bench_h100.harness.program import idle_in


def read(run):
    return idle_in(run, "decode")
