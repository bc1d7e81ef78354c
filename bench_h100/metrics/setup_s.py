"""From the process's start to the window's first request or step:
imports, the kernels' build (a checkout's first run), the weights made
on the card, the warm-up of the cell's shapes (and, training, the first
steps that the check reads)."""


def read(run):
    return run.setup_s
