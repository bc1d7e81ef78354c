"""Serving cells: ``launch.serve.Server.serve`` driven call after call.

Each call hands the server the next ``max_batch`` requests of a column
of a WFL pipeline (work dispatched ahead, the column never drains).
``Server.serve`` returns no token before its batch ends, so a request's
reply time is the call's return.  The window runs whole calls: it
closes at the first call that ends at or after ``seconds``.  On a mesh
every rank makes the same calls; rank 0 decides after each call whether
the window has closed and tells the others, so that every rank runs the
same collectives.

The check (``check``) takes a sample of the window's batches, drawn from
the seed as the window runs (a reservoir of ``check_batches``), with the
batch that holds the longest prompt, and replays each through the
float32 reference (``reference.lm``) with the tokens the port served:
its prefill over the batch as the server padded it, then each decode
step with every row's token of the step before.  At every served
position it judges the port's token by the gap between the reference's
largest logit and the reference's logit of that token, and the port's
logits by their distance from the reference's, relative to the
reference's own size.  On a mesh the reference runs as a pipeline of
stages, one a rank (``reference.stages``), and the last rank judges.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from . import port, traffic as T, weights
from ..reference.lm import follow as follow_whole
from .model import dims as dims_of
from .spans import Recorder


class ServeRun:
    kind = "serve"

    def __init__(self, cell, seed: int, device: torch.device, traced: bool,
                 mesh=None):
        self.cell, self.seed, self.device = cell, seed, device
        self.mesh = mesh
        if mesh is None:
            self.rank, self.world = 0, 1
        else:
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.dims = dims_of(cell.config)
        self.traffic = cell.traffic
        self.rec = Recorder(traced, device)
        self.requests: List[Dict] = []
        self.srv = None
        self.window_s = None
        self.n_check = int(self.traffic.get("check_batches", 1))
        self._pick = np.random.default_rng([int(seed) % 2 ** 63, 7])
        self.sample: List[int] = []      # the reservoir: batch indices
        self.longest = None              # (prompt length, batch index)

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        rows = int(self.traffic["max_batch"])
        if self.mesh is None:
            self.srv = port.server(self.dims, rows, self.seed, self.device)
        else:
            self.srv = port.mesh_server(self.dims, rows, self.seed,
                                        self.mesh, self.device)
        self.rec.instrument(self.srv)
        # one call at the largest shapes the mix can draw: the window's
        # calls hold smaller or equal ones
        self._call(T.longest_call(self.traffic, self.dims.vocab,
                                  self.dims.context, self.seed))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _call(self, reqs):
        from repro_torch.launch.serve import Request
        rs = [Request(i, p, max_new=m) for i, (p, m) in enumerate(reqs)]
        t0 = time.perf_counter()
        self.srv.serve(rs)
        return rs, t0, time.perf_counter()

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> None:
        rec = self.rec
        start = time.perf_counter()
        rec.begin_window(seconds)
        i = 0
        while True:
            n_before = len(rec.batches)
            reqs, t0, t1 = self._call(T.requests(
                self.traffic, self.dims.vocab, self.dims.context,
                self.seed, i, T.WINDOW))
            new_of = {id(r.prompt): r.max_new for r in reqs}
            for j in range(n_before, len(rec.batches)):
                b = rec.batches[j]
                b["new"] = [new_of[id(p)] for p in b["prompts"]]
                self._sample(j)
            for r in reqs:
                self.requests.append({
                    "submit": t0, "reply": t1, "done": r.done,
                    "prompt": int(r.prompt.shape[0]),
                    "out": len(r.out), "max_new": r.max_new})
            i += 1
            if self._agree(rec.window_over() if self.rank == 0 else False):
                break
        rec.end_window()
        self.window_s = t1 - start

    def _agree(self, over: bool) -> bool:
        """Rank 0's ``over``, on every rank of a mesh."""
        if self.mesh is None:
            return over
        flag = torch.tensor([int(over)], device=self.device)
        dist.broadcast(flag, 0)
        return bool(flag.item())

    def _sample(self, j: int) -> None:
        """Batch ``j`` into the reservoir with the seed's draw, and the
        logits of every batch that left it (and is not the longest)
        dropped."""
        before = set(self.sample)
        if len(self.sample) < self.n_check:
            self.sample.append(j)
        else:
            r = int(self._pick.integers(0, j + 1))
            if r < self.n_check:
                self.sample[r] = j
        top = max(len(p) for p in self.rec.batches[j]["prompts"])
        if self.longest is None or top > self.longest[0]:
            before.add(self.longest[1] if self.longest else j)
            self.longest = (top, j)
        for i in before | {j}:
            if i not in self.sample and i != self.longest[1]:
                self.rec.batches[i]["logits"] = None

    # ------------------------------------------------------------- check
    def release(self) -> None:
        """Drop the program's state (its parameters and caches)."""
        self.srv = None
        port.free(self.device)

    def check(self, control: bool = False) -> Dict[str, float]:
        """→ the numbers of :func:`numbers`, which the cell's limits pick
        from.  With ``control`` the float8 reference takes the program's
        place: the numbers are those of its first choices and its logits,
        and the program's own are kept beside them, prefixed
        ``program_``."""
        from ..reference.lm import Model, exact_float32, widen
        from ..reference.stages import Pipe, layers_of
        exact_float32()
        judge = self.rank == self.world - 1
        picks = sorted(set(self.sample) | {self.longest[1]}) \
            if self.longest else []
        batches = [self.rec.batches[j] for j in picks]
        for b in batches:
            b["logits"] = [lg[:, 0].float().cpu() for lg in b["logits"]] \
                if judge else None
        self.release()
        if self.mesh is None:
            params = widen(weights.make(self.dims, self.seed, self.device,
                                        "serve"))
            held, follow = None, follow_whole
        else:
            held = layers_of(self.dims.layers, self.dims.period, self.rank,
                             self.world)
            params = widen(weights.stage(
                self.dims, self.seed, self.device, held,
                embed=self.rank == 0 or (judge and self.dims.tie),
                head=judge))
            follow = Pipe(self.rank, self.world, self.device).follow
        port.free(self.device)
        ref = Model(self.dims, params, layers=held)
        ctl = Model(self.dims, params, precision="fp8", layers=held) \
            if control else None
        mine, theirs = [], []
        for b in batches:
            m, c = replay(ref, ctl, b, self.device, follow)
            mine.append(m)
            theirs.append(c)
        del params, ref, ctl
        port.free(self.device)
        out = None
        if judge:
            out = {"checked_tokens": sum(m["gap"].numel() for m in mine),
                   "checked_batches": len(batches)}
            prog = numbers(mine)
            if control:
                out.update(numbers(theirs))
                out.update({f"program_{k}": v for k, v in prog.items()})
            else:
                out.update(prog)
        if self.mesh is not None:
            box = [out]
            dist.broadcast_object_list(box, self.world - 1)
            out = box[0]
        return out


def numbers(parts: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """Over every served position of the replayed batches: the served
    tokens' largest and mean gap below the reference's best logit, the
    share of them at the reference's first choice, and the logits' largest
    and mean distance from the reference's, each position's relative to
    the reference's largest (for the largest) or mean (for the mean)
    magnitude there."""
    cat = _joined(parts)
    g = cat["gap"]
    return {"max_logit_gap": float(g.max()),
            "mean_logit_gap": float(g.mean()),
            "first_choice_share": float((g == 0).float().mean()),
            "logit_err_max": float(cat["err_max"].max()),
            "logit_err_mean": float(cat["err_mean"].mean())}


def _judge(ref, logits, choice, live) -> Dict[str, torch.Tensor]:
    """One position's numbers on its live rows: the gap of ``choice``
    [B] under the reference's logits ``ref`` [B, V], and ``logits``'
    relative distance from ``ref``."""
    ref, logits = ref[live], logits[live]
    chosen = ref.gather(-1, choice[live][:, None])[:, 0]
    diff = (logits - ref).abs()
    mag = ref.abs()
    return {"gap": (ref.max(dim=-1).values - chosen).cpu(),
            "err_max": (diff.amax(-1) / mag.amax(-1)).cpu(),
            "err_mean": (diff.mean(-1) / mag.mean(-1)).cpu()}


def _joined(parts: List[Dict]) -> Dict[str, torch.Tensor]:
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def replay(ref, ctl, batch: Dict, device, follow=follow_whole):
    """One served batch through the reference → the program's numbers at
    each served position (its tokens and its logits against the
    reference's); with ``ctl``, then through the control → the same of
    the control's first choices and logits, judged by the reference's
    logits (kept on the host between the two passes).  ``follow`` gives
    the logits at each position (``reference.stages.Pipe.follow`` on a
    mesh, where ranks other than the last get None and return None)."""
    prompts, outs, new = batch["prompts"], batch["outs"], batch["new"]
    b = len(prompts)
    s = max(p.shape[0] for p in prompts)
    toks = np.zeros((b, s), np.int64)
    for i, p in enumerate(prompts):
        toks[i, s - p.shape[0]:] = p
    toks = torch.from_numpy(toks).to(device)
    served = torch.tensor(outs, dtype=torch.long, device=device)  # [B, n]
    live = torch.tensor([[t < m for t in range(served.shape[1])]
                         for m in new], device=device)
    mine, kept = [], []
    for t, logits in enumerate(follow(ref, toks, served, s)):
        if logits is None:
            continue
        port_logits = batch["logits"][t].to(device)
        mine.append(_judge(logits, port_logits, served[:, t], live[:, t]))
        if ctl is not None:
            kept.append(logits.cpu())
    if ctl is not None:
        theirs = []
        for t, clog in enumerate(follow(ctl, toks, served, s)):
            if clog is None:
                continue
            logits = kept[t].to(device)
            theirs.append(_judge(logits, clog, clog.argmax(-1),
                                 live[:, t]))
    if not mine:
        return None, None
    return _joined(mine), _joined(theirs) if ctl is not None else None
