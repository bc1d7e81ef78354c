"""The port's own spans and counters, stamped on the profiler's clock.

A span marks a stretch of the program's work::

    with tracing.span("decode", tokens.device, rows=b, pos=pos):
        ...

**Off** (the default) :func:`span` reads two module globals and returns
one shared no-op context, and :func:`count` returns after the same two
reads: no record, no CUDA event, no ``record_function`` range, no
synchronisation.  **On** after :func:`on`, and while a ``torch.profiler``
records (``torch.autograd.profiler._is_profiler_enabled``, which the
profiler sets on start and clears on stop), each span keeps a
:class:`Record`: its name, its parent (a stack per thread), its batch (the
index of its outermost span, so that every span of one
``Server.generate_batch`` shares the ID of the ``batch`` span), its
attributes, and its host start and end from ``time.time_ns()``, which is
the clock the profiler's events are stamped on.  A reader can then put
an idle gap of a device trace down to the span that the host was in.

The device time of a span on a CUDA device is the time between two
timing events recorded at its start and end on the stream that was the
device's current one as it started; :func:`records` reads it after one
synchronisation of the card.  On the CPU the host's time stands in for
it, so that the readers can be tested at a tiny size.  Spans are
deliberately not profiler ranges: a range's device-side copy would
count as busy time in a trace.  A span with its two events costs the
host some tens of µs on an H100 host (two event creations and records),
so spans sit on layers, not on single operations.

Counters (:func:`count`) add Python numbers on the host, and tensors
(a count the device computed) to a list per name that is summed when
:func:`counters` reads it, with one synchronisation.  Records are kept
in memory up to :data:`CAP`; past it spans are counted by
:func:`dropped` and not kept.  :func:`clear` forgets records and
counters.

The LM path's spans and counters:

* ``batch`` (``Server.generate_batch``; ``rows``): padding, upload, the
  argmax and each step's read of the tokens, around its children;
* ``prefill`` (``LM.prefill``; ``batch``, ``seq``) and ``decode``
  (``LM.decode_step``; ``rows``, ``pos``);
* a block's mixer half (norm, mixer, residual), named by the slot's
  kind: ``attn``, ``mamba``, ``mlstm`` or ``slstm``;
* its tail (norm, MLP or MoE, residual): ``mlp`` or ``moe``;
* ``train.step`` (``ModelBundle.make_train_step``'s step); under a
  checkpoint the blocks' spans open again in the backward's recompute;
* counters ``moe.assigned`` (tokens × top-k), ``moe.dispatched`` (the
  assignments that took a capacity slot) and ``moe.slots`` (groups ×
  experts × capacity): ``moe.assigned - moe.dispatched`` are the expert
  choices dropped at capacity, ``moe.dispatched / moe.slots`` the expert
  FFNs' slots that hold a token.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

__all__ = ["CAP", "Record", "active", "clear", "count", "counters",
           "dropped", "off", "on", "records", "span"]

#: records kept before later spans are dropped (and counted)
CAP = 1 << 16
#: tensors kept a counter before they are summed into one (on the device)
_FOLD = 1024

_on = False
_lock = threading.Lock()
_local = threading.local()
_records: List["Record"] = []
_dropped = 0
_host: Dict[str, float] = {}
_dev: Dict[str, List[torch.Tensor]] = {}


@dataclass(slots=True)
class Record:
    index: int
    name: str
    parent: Optional[int]           # the enclosing span's index
    batch: int                      # the outermost enclosing span's index
    attrs: Dict
    t0: int                         # host ns, time.time_ns()
    t1: Optional[int] = None        # None while the span is open
    device_ns: Optional[int] = None  # read by records()
    _events: Optional[tuple] = field(default=None, repr=False)


def on() -> None:
    """Record from now on, with or without a profiler."""
    global _on
    _on = True


def off() -> None:
    """Record only while a ``torch.profiler`` records."""
    global _on
    _on = False


def active() -> bool:
    return _on or _profiler._is_profiler_enabled


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "device", "attrs", "rec")

    def __init__(self, name, device, attrs):
        self.name, self.device, self.attrs = name, device, attrs
        self.rec = None

    def __enter__(self):
        global _dropped
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        with _lock:
            if len(_records) >= CAP:
                _dropped += 1
                return None
            i = len(_records)
            rec = Record(i, self.name, up.index if up else None,
                         up.batch if up else i, self.attrs, time.time_ns())
            _records.append(rec)
        dev = self.device
        if dev is not None and dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            rec._events = (start, stream, dev)
        stack.append(rec)
        self.rec = rec
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec is None:
            return False
        _local.stack.pop()
        if rec._events is not None:
            start, stream, dev = rec._events
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            rec._events = (start, end, dev)
        rec.t1 = time.time_ns()
        if rec._events is None:
            rec.device_ns = rec.t1 - rec.t0
        return False


def span(name: str, device: Optional[torch.device] = None, **attrs):
    """A context that records ``name`` with ``attrs`` while tracing is
    active; ``device`` is the device of the span's work (its device time
    is timed there when it is a CUDA device)."""
    if not (_on or _profiler._is_profiler_enabled):
        return _NOOP
    return _Span(name, device, attrs)


def count(name: str, n) -> None:
    """Add ``n`` (a number, or a tensor the device computed) to counter
    ``name`` while tracing is active."""
    if not (_on or _profiler._is_profiler_enabled):
        return
    with _lock:
        if isinstance(n, torch.Tensor):
            kept = _dev.setdefault(name, [])
            kept.append(n.detach())
            if len(kept) >= _FOLD:
                _dev[name] = [torch.stack(kept).sum()]
        else:
            _host[name] = _host.get(name, 0) + n


def records() -> List[Record]:
    """Every kept record, with its device time (None while open).  The
    first read after CUDA spans synchronises their cards once."""
    with _lock:
        recs = list(_records)
    todo = [r for r in recs if r._events is not None and r.t1 is not None]
    for dev in {r._events[2] for r in todo}:
        torch.cuda.synchronize(dev)
    for r in todo:
        start, end, _ = r._events
        r.device_ns = int(round(start.elapsed_time(end) * 1e6))
        r._events = None
    return recs


def counters() -> Dict[str, float]:
    """Each counter's sum since the last :func:`clear` (one
    synchronisation where the device counted)."""
    with _lock:
        out = dict(_host)
        dev = {k: list(v) for k, v in _dev.items()}
    if dev:
        sums = torch.stack([torch.stack(v).sum().double()
                            for v in dev.values()]).tolist()
        for k, v in zip(dev, sums):
            v = int(v) if v == int(v) else v
            out[k] = out.get(k, 0) + v
    return out


def dropped() -> int:
    """Spans not kept because :data:`CAP` records were held."""
    return _dropped


def clear() -> None:
    """Forget every record, drop count and counter."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
        _host.clear()
        _dev.clear()
