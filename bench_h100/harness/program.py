"""The port's own spans and counters in a traced run, for the readers.

The port records them (``repro_torch.tracing``) while the profiler
records, so the traced half of a window holds them and an untraced run
none.  They are taken from the objects the harness already holds
(``Server.tracing``, ``ModelBundle.tracing``), not imported; a port
without them gives nothing to read.  Span stamps are on the trace's
clock, so a device trace's idle gaps can be put down to the span that the
host was in.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .trace import gaps

Interval = Tuple[int, int]


def tracing(run):
    d = run.driver
    owner = getattr(d, "srv", None) or getattr(d, "bundle", None)
    return getattr(owner, "tracing", None)


def records(run) -> Optional[list]:
    """The program's closed spans inside the traced window, or None."""
    t = tracing(run)
    if run.trace is None or t is None:
        return None
    lo, hi = run.trace.window
    recs = [r for r in t.records()
            if r.t1 is not None and lo <= r.t0 and r.t1 <= hi]
    return recs or None


def prefill_share(run, kind: str) -> Optional[float]:
    """Σ device time of the ``kind`` spans inside the window's ``prefill``
    spans over Σ device time of those prefills, in %."""
    recs = records(run)
    if recs is None:
        return None
    pre = {r.index: r for r in recs if r.name == "prefill"}
    up = {r.index: r.parent for r in recs}

    def inside(r) -> bool:
        p = r.parent
        while p is not None:
            if p in pre:
                return True
            p = up.get(p)
        return False

    mine = [r for r in recs if r.name == kind and inside(r)]
    if not mine:
        return None
    return 100.0 * sum(r.device_ns for r in mine) \
        / sum(r.device_ns for r in pre.values())


def merged(intervals) -> List[Interval]:
    """Sorted, disjoint union of ``intervals``."""
    out: List[list] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def minus(xs: List[Interval], ys: List[Interval]) -> List[Interval]:
    """The parts of ``xs`` outside ``ys`` (both sorted and disjoint)."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append((a, ys[k][0]))
            a = max(a, ys[k][1])
            k += 1
        if a < b:
            out.append((a, b))
    return out


def overlap_ns(xs: List[Interval], ys: List[Interval]) -> int:
    """Length of the intersection of two sorted, disjoint lists."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in(run, name: str, without=()) -> Optional[float]:
    """Device-idle time of the traced window (the gaps of the trace's
    device intervals) while the host was inside a ``name`` span and
    outside every span named in ``without``, over the window, in %.  On
    the CPU (no device records) the whole window is idle."""
    tr = run.trace
    recs = records(run)
    if recs is None or (not tr.device
                        and run.driver.device.type == "cuda"):
        return None
    host = merged((r.t0, r.t1) for r in recs if r.name == name)
    if not host:
        return None
    if without:
        host = minus(host, merged((r.t0, r.t1) for r in recs
                                  if r.name in without))
    idle = gaps([(a, b) for _, a, b, _ in tr.device], tr.window)
    return 100.0 * overlap_ns(host, idle) / (tr.window[1] - tr.window[0])
