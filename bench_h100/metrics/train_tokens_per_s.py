"""Tokens trained by the window's steps over the window (host clock)."""


def read(run):
    d = run.driver
    if getattr(d, "kind", None) != "train" or not d.window_steps:
        return None
    return d.window_steps * d.batch * d.seq / run.window_s
