"""Prompt plus generated tokens of the requests completed in the window,
over the window (host clock).  Each request's own tokens only: not the
padding, not the rows decoded after the request had its tokens."""


def read(run):
    reqs = getattr(run.driver, "requests", None)
    if not reqs:
        return None
    n = sum(r["prompt"] + r["out"] for r in reqs if r["done"])
    return n / run.window_s
