"""The traced run's profiler events, reduced in memory (no trace file).

From ``torch.profiler``'s events this keeps the device's activity
(kernels, copies, sets) as (name, start, end, device) in nanoseconds on
the trace's clock, the harness's ``bench.*`` ranges, and the host's
operators, which name the device's idle gaps.  Busy time is the union of
the device intervals, so that work on several streams at once counts
once, and never exceeds the window.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

Interval = Tuple[int, int]

#: a kernel's name in the breakdown is cut to this many characters (C++
#: template names run to thousands)
NAME_CHARS = 120


@dataclass
class Trace:
    window: Interval                              # bench.window
    device: List[tuple] = field(default_factory=list)   # name, t0, t1, dev
    spans: List[tuple] = field(default_factory=list)    # name, t0, t1
    host: List[tuple] = field(default_factory=list)     # name, t0, t1

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernels_in(self, t0: int, t1: int) -> List[tuple]:
        return [k for k in self.device if t0 <= k[1] < t1]

    def busy_s(self, devices=None) -> float:
        """The union of device intervals inside the window, averaged over
        the devices that ran something (or over ``devices``)."""
        per: Dict[int, List[Interval]] = {}
        for _, a, b, dev in self.device:
            per.setdefault(dev, []).append((a, b))
        if not per:
            return 0.0
        n = devices or len(per)
        return sum(union_ns(v, self.window) for v in per.values()) / n / 1e9


def idle_pct(tr: "Trace"):
    """1 - busy / window in %, or None where the trace holds no device
    record (no trace, or a run on the CPU)."""
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def union_ns(intervals: List[Interval], clip: Interval) -> int:
    """Length of the union of ``intervals`` inside ``clip``."""
    lo, hi = clip
    total, cur_a, cur_b = 0, None, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def gaps(intervals: List[Interval], clip: Interval) -> List[Interval]:
    """The stretches of ``clip`` that no interval covers."""
    out, at = [], clip[0]
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, clip[1])))
        at = max(at, b)
        if at >= clip[1]:
            break
    if at < clip[1]:
        out.append((at, clip[1]))
    return [g for g in out if g[1] > g[0]]


def _ns(e, what: str) -> int:
    get = getattr(e, f"{what}_ns", None)
    if get is not None:
        return int(get())
    return int(getattr(e, f"{what}_us")() * 1000)


def reduce(prof) -> Trace:
    """``torch.profiler.profile`` after it stopped → :class:`Trace`."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    device, spans, host = [], [], []
    window = None
    for e in events:
        t0 = _ns(e, "start")
        t1 = t0 + _ns(e, "duration")
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name.startswith("bench."):  # our ranges' device-side copies
                continue
            device.append((name, t0, t1, int(e.device_index())))
        elif name == "bench.window":
            window = (t0, t1)
        elif name.startswith("bench."):
            spans.append((name[6:], t0, t1))
        else:
            host.append((name, t0, t1))
    if window is None:
        raise RuntimeError("the trace holds no bench.window range")
    lo, hi = window
    device = [k for k in device if k[2] > lo and k[1] < hi]
    return Trace(window=window, device=device, spans=spans, host=host)


def breakdown(tr: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps, each named by the innermost harness span and host operator
    running at the gap's middle."""
    per: Dict[str, float] = {}
    for name, a, b, _ in tr.device:
        a, b = max(a, tr.window[0]), min(b, tr.window[1])
        per[name] = per.get(name, 0.0) + (b - a) / 1e9
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps([(a, b) for _, a, b, _ in tr.device], tr.window),
                  key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in idle:
        mid = (a + b) // 2
        span = _innermost(tr.spans, mid) or "window"
        op = _innermost(tr.host, mid)
        named.append([f"{span} / {op}" if op else span, (b - a) / 1e9])
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": named}


def _innermost(events, t: int):
    best = None
    for name, a, b in events:
        if a <= t < b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return best[0] if best else None
