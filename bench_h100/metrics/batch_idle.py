"""The share of the traced window in which the card was idle while the
host was inside one of the port's ``batch`` spans
(``Server.generate_batch``) but outside its ``prefill`` and ``decode``:
padding, the upload, the argmax and each step's read of the tokens, over
the window, in %.  The idle that neither this nor ``decode_idle`` holds
is the time between the harness's calls."""
from bench_h100.harness.program import idle_in


def read(run):
    return idle_in(run, "batch", without=("prefill", "decode"))
