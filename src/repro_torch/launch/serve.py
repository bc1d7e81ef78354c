"""Serving driver: batched prefill + greedy decode with continuous
batching.

The port of ``repro/launch/serve.py``.  Requests queue in, the scheduler
packs up to ``max_batch`` active sequences, prompts are left-padded with
token 0 to a common length (no padding mask, as the reference), prefill
runs over the batch (every attention layer through the flash-attention
kernel, every Mamba layer through the selective_scan kernel), and a
decode step advances every active sequence each tick.  Finished
sequences free their slot for queued requests — continuous batching.

This is also the §5 "large-scale model application" driver: WFL
pipelines can hand a column of prompts to ``Server.generate_batch``.

One signature differs from the reference: ``Server`` takes an
``ArchConfig`` where the reference takes an architecture name, so that a
caller can hand it a cut or re-typed configuration
(``dataclasses.replace(cfg, num_layers=8)``).  It runs on CUDA unless
asked for ``device="cpu"``, and raises where there is no GPU.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field as dc_field
from typing import List, Optional

import numpy as np
import torch

from .. import tracing
from ..configs.base import ArchConfig, get_config
from ..ml.transformer import LM

__all__ = ["Request", "Server", "main"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                   # [S] int32
    max_new: int = 16
    out: List[int] = dc_field(default_factory=list)
    done: bool = False


class Server:
    def __init__(self, cfg: ArchConfig, *, reduced: bool = True,
                 max_batch: int = 4, max_len: int = 256, seed: int = 0,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Server: no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        if reduced:
            cfg = cfg.reduced()
        self.cfg = cfg
        self.lm = LM(cfg)
        self.params = self.lm.init(seed, device=self.device)
        self.max_batch = max_batch
        self.max_len = max_len
        #: host counters: prefill calls, decode steps, the prompts' own
        #: tokens, the left-padded positions of the prefills, and the
        #: generated tokens the callers keep (all ``generate_batch``
        #: returns, less what ``serve`` cuts past a request's ``max_new``)
        self.stats = {"prefills": 0, "decode_steps": 0, "prompt_tokens": 0,
                      "padded_positions": 0, "tokens_out": 0}
        #: the port's spans and counters (``repro_torch.tracing``)
        self.tracing = tracing

    # ------------------------------------------------------------- batch
    @torch.inference_mode()
    def generate_batch(self, prompts: List[np.ndarray], max_new: int = 16,
                       greedy: bool = True) -> List[List[int]]:
        """Static batch generation (prompts left-padded to a common
        length)."""
        b = len(prompts)
        with tracing.span("batch", self.device, rows=b):
            s = max(p.shape[0] for p in prompts)
            toks = np.zeros((b, s), np.int32)
            for i, p in enumerate(prompts):
                toks[i, s - p.shape[0]:] = p      # left-pad
            n = sum(p.shape[0] for p in prompts)
            self.stats["prefills"] += 1
            self.stats["prompt_tokens"] += n
            self.stats["padded_positions"] += b * s - n
            logits, caches = self.lm.prefill(
                self.params, torch.from_numpy(toks).to(self.device))
            cur = torch.argmax(logits, dim=-1).to(torch.int32)
            outs = [[t] for t in cur[:, 0].tolist()]
            for t in range(max_new - 1):
                logits, caches = self.lm.decode_step(self.params, cur,
                                                     caches, s + t)
                self.stats["decode_steps"] += 1
                cur = torch.argmax(logits, dim=-1).to(torch.int32)
                for o, tok in zip(outs, cur[:, 0].tolist()):
                    o.append(tok)
            self.stats["tokens_out"] += b * max_new
            return outs

    # ----------------------------------------------- continuous batching
    def serve(self, requests: List[Request], tick_limit: int = 10_000
              ) -> List[Request]:
        """Continuous batching: slots refill as sequences finish."""
        queue = list(requests)
        active: List[Optional[Request]] = []
        ticks = 0
        while (queue or any(r is not None and not r.done for r in active)) \
                and ticks < tick_limit:
            ticks += 1
            active = [r for r in active if r is not None and not r.done]
            while queue and len(active) < self.max_batch:
                active.append(queue.pop(0))
            batch_prompts = [r for r in active if not r.out]
            if batch_prompts:
                outs = self.generate_batch(
                    [r.prompt for r in batch_prompts],
                    max_new=max(r.max_new for r in batch_prompts))
                for r, o in zip(batch_prompts, outs):
                    r.out = o[:r.max_new]
                    r.done = True
                    self.stats["tokens_out"] -= len(o) - len(r.out)
        return requests


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max_new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    srv = Server(get_config(args.arch), reduced=True, device=args.device)
    reqs = [Request(i, rng.integers(
        0, srv.cfg.vocab_size, rng.integers(4, 24)).astype(np.int32),
        max_new=args.max_new) for i in range(args.requests)]
    t0 = time.perf_counter()
    srv.serve(reqs)
    if srv.device.type == "cuda":
        torch.cuda.synchronize(srv.device)
    dt = time.perf_counter() - t0
    done = sum(r.done for r in reqs)
    print(f"served {done}/{len(reqs)} requests in {dt:.2f}s on "
          f"{srv.device}; stats={srv.stats}")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt[{r.prompt.shape[0]}] -> {r.out}")


if __name__ == "__main__":
    main()
