"""Training cells: ``ml.model.ModelBundle.make_train_step`` step after step.

Set-up builds one bundle with its parameters (the benchmark's float32
weights) and AdamW state, and drives it through the first ``check_steps``
steps with the window's own call and feed (``harness.traffic.
train_batch``, rows that all differ).  It keeps what the check compares:
each step's loss as the step reported it, each leaf's first gradient as
the optimizer got it (from the first moment after one step: m = (1 -
b1) g), and each leaf's change over those steps.  The same object then
runs the window, whole steps until ``seconds`` have passed; each step's
loss is read, as a trainer logs it, which also keeps the host from
running ahead of the card.

The check runs the float32 reference (``reference.train``) over the same
first batches from the same weights.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from . import port, traffic as T, weights
from .model import dims as dims_of
from .spans import Recorder


class TrainRun:
    kind = "train"

    def __init__(self, cell, seed: int, device: torch.device, traced: bool):
        self.cell, self.seed, self.device = cell, seed, device
        self.dims = dims_of(cell.config)
        self.traffic = cell.traffic
        self.rec = Recorder(traced, device)
        self.batch, self.seq = int(self.traffic["batch"]), \
            int(self.traffic["seq_len"])
        self.n_check = int(self.traffic.get("check_steps", 3))
        self.steps = 0
        self.window_steps = 0
        self.window_s = None
        self.readings: Dict = {}

    def feed(self, step: int) -> Dict[str, torch.Tensor]:
        b = T.train_batch(self.dims.vocab, self.batch, self.seq, self.seed,
                          step)
        return {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}

    def one(self):
        with self.rec.span("step", tokens=self.batch * self.seq):
            self.params, self.opt, m = self.step_fn(self.params, self.opt,
                                                    self.feed(self.steps))
            loss = float(m["loss"])
        self.steps += 1
        return loss

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        self.bundle = port.bundle(self.dims, self.traffic["train"],
                                  self.device)
        # float32 master weights, cast as the job's ``param_dtype`` says
        # (the bundle's own cast; the identity for float32)
        self.params = self.bundle._cast_params(
            weights.make(self.dims, self.seed, self.device, "train"))
        start = {k: t.clone() for k, t in weights.leaves(self.params)}
        self.opt = self.bundle.init_opt_state(self.params)
        self.step_fn = self.bundle.make_train_step()
        losses = []
        for i in range(self.n_check):
            losses.append(self.one())
            if i == 0:
                b1 = 0.9           # ml.optim.adamw_update's default
                self.readings["grad"] = {
                    k: float(m.float().norm() / (1 - b1))
                    for k, m in weights.leaves(self.opt["adam"]["m"])}
        self.readings["loss"] = losses
        self.readings["change"] = {
            k: float((t.float() - start[k].float()).norm())
            for k, t in weights.leaves(self.params)}
        del start
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> None:
        rec = self.rec
        start = time.perf_counter()
        rec.begin_window(seconds)
        while True:
            self.one()
            self.window_steps += 1
            t1 = time.perf_counter()
            if rec.window_over():
                break
        rec.end_window()
        self.window_s = t1 - start

    # ------------------------------------------------------------- check
    def release(self) -> None:
        self.params = self.opt = self.step_fn = self.bundle = None
        port.free(self.device)

    def check(self, control: bool = False) -> Dict[str, float]:
        """→ :func:`reference.train.compare`'s numbers.  (``control`` has
        no reference side here: the training control is the program's
        own bf16-parameter path, which the mix's ``param_dtype`` sets.)"""
        from ..reference.lm import exact_float32
        from ..reference.train import compare, run as ref_run
        exact_float32()
        self.release()
        params = weights.make(self.dims, self.seed, self.device, "train")
        ref = ref_run(self.dims, params, [self.feed(i) for i in
                                          range(self.n_check)],
                      self.traffic["train"])
        del params
        port.free(self.device)
        return compare(self.readings, ref)
