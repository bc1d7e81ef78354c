"""The harness's own spans and records, around its calls into the port.

A :class:`Recorder` wraps three calls of a ``Server`` on the instance
(``generate_batch``, ``lm.prefill``, ``lm.decode_step``): the program is
not edited.  It keeps a reference to the logits that each prefill and
decode step of a batch returned (no copy, no device work); the serving
driver drops them but for the batches its check samples.  Each span is (name, host start, host end, meta) on
``time.perf_counter``; in a traced run it synchronises the card at both
ends, so that the span holds its own device work, and it opens a
``torch.profiler.record_function("bench.<name>")`` range that the trace
reader finds.  In a run with tracing off it only reads the clock.

A traced run's window has two halves of equal length.  The profiler
records the first (``meta["profiled"]`` True): the device trace's
metrics read it.  It stops at the first span's end past the half, and
the second half runs synchronised spans alone, so that the span metrics
are not slowed by the profiler's cost a host operator.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import torch


class Recorder:
    def __init__(self, traced: bool, device: torch.device):
        self.sync = traced and device.type == "cuda"
        self.device = device
        self.spans: List[tuple] = []
        self.batches: List[Dict] = []
        self._logits: List[torch.Tensor] = []
        self.on = False          # record only inside the window
        #: set by the runner in a traced run: stops the profiler
        self.stop_trace: Optional[Callable[[], None]] = None
        self.profiled = False
        self._range = None

    # ------------------------------------------------------------ window
    def begin_window(self, seconds: float) -> None:
        self.on = True
        self.profiled = self.stop_trace is not None
        self._left = seconds / 2 if self.profiled else seconds
        if self.sync:
            torch.cuda.synchronize(self.device)
        if self.profiled:
            self._range = torch.profiler.record_function("bench.window")
            self._range.__enter__()
        self._t0 = time.perf_counter()

    def window_over(self) -> bool:
        """After each call or step: has the window (or, traced, its
        profiled half) run its time?  The traced half's end stops the
        profiler and starts the second half's clock."""
        if time.perf_counter() - self._t0 < self._left:
            return False
        if not self.profiled:
            return True
        if self.sync:
            torch.cuda.synchronize(self.device)
        self._range.__exit__(None, None, None)
        self.stop_trace()
        self.profiled = False
        self._t0 = time.perf_counter()
        return False

    def end_window(self) -> None:
        self.on = False

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        if not self.on:
            yield
            return
        if self.sync:
            torch.cuda.synchronize(self.device)
        ctx = torch.profiler.record_function(f"bench.{name}") \
            if self.profiled else contextlib.nullcontext()
        meta["profiled"] = self.profiled
        t0 = time.perf_counter()
        with ctx:
            yield
            if self.sync:
                torch.cuda.synchronize(self.device)
        self.spans.append((name, t0, time.perf_counter(), meta))

    def spans_of(self, name: str, profiled: bool) -> List[tuple]:
        """The window's ``name`` spans of the profiled half or of the
        other."""
        return [s for s in self.spans
                if s[0] == name and s[3]["profiled"] == profiled]

    def instrument(self, srv) -> None:
        """Spans around ``srv``'s batch, prefill and decode calls, and a
        record of every batch: its prompts, its ``max_new``, every row's
        tokens as ``generate_batch`` returned them (before ``Server.serve``
        cuts each to its request's length) and the logits [B, 1, V] of
        its prefill and of each decode step."""
        gb, lm = srv.generate_batch, srv.lm
        prefill, decode = lm.prefill, lm.decode_step

        def generate_batch(prompts, max_new=16, greedy=True):
            profiled = self.profiled
            self._logits = []
            with self.span("batch", rows=len(prompts)):
                outs = gb(prompts, max_new=max_new, greedy=greedy)
            if self.on:
                self.batches.append({"prompts": list(prompts),
                                     "profiled": profiled,
                                     "max_new": int(max_new),
                                     "outs": [list(o) for o in outs],
                                     "logits": self._logits})
            self._logits = []
            return outs

        def lm_prefill(p, tokens, frames=None):
            with self.span("prefill", batch=int(tokens.shape[0]),
                           seq=int(tokens.shape[1])):
                out = prefill(p, tokens, frames)
            self._logits.append(out[0])
            return out

        def lm_decode(p, tokens, caches, pos):
            with self.span("decode", rows=int(tokens.shape[0]),
                           pos=int(pos)):
                out = decode(p, tokens, caches, pos)
            self._logits.append(out[0])
            return out

        srv.generate_batch = generate_batch
        lm.prefill = lm_prefill
        lm.decode_step = lm_decode
