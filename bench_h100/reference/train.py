"""The plain reference of the training step, in float32.

The loss is the mean next-token cross-entropy over every position of the
batch (labels as the feed gives them), through the model of
``reference.lm`` (attention and gated-MLP layers; a Mamba or MoE layer is
refused: no training cell has one).  Gradients come from autograd, a row
at a time and summed, so that the activations fit; then the global-norm
clip and AdamW with the job's settings (``traffic/<mix>.json``'s
``train``): b1 0.9, b2 0.95, eps 1e-8, the linear warm-up of the cosine
schedule, and weight decay on every leaf of two or more dims in the
stacked layout, the stacked norm scales among them, as the job defines
it.

``compare`` turns the port's readings and the reference's into the
numbers that the check holds to their limits.
"""
from __future__ import annotations

import math
from statistics import median
from typing import Dict, List

import torch
import torch.nn.functional as F

from ..harness.model import Dims
from ..harness.weights import leaves
from .lm import Model

B1, B2, EPS = 0.9, 0.95, 1e-8


def _loss_sum(model: Model, tokens, labels):
    """Σ over one row's positions of the cross-entropy."""
    d = model.dims
    s = tokens.shape[1]
    pos = torch.arange(s, device=tokens.device)
    x = model.p["embed"][tokens.long()].float()
    for i, lp in enumerate(model.layers):
        h = model.norm(x, lp["norm1"]["scale"])
        q, k, v = model._qkv(h, lp["attn"], pos)
        grp = d.heads // d.kv_heads
        k, v = (t.repeat_interleave(grp, dim=1) for t in (k, v))
        sc = q @ k.transpose(-1, -2) / math.sqrt(d.hd)
        mask = torch.ones((s, s), dtype=torch.bool,
                          device=tokens.device).tril()
        sc = sc.masked_fill(~mask, float("-inf"))
        x = x + model._attn_out(torch.softmax(sc, dim=-1) @ v, lp["attn"])
        x = x + model.mlp(model.norm(x, lp["norm2"]["scale"]), lp["mlp"])
    logits = model.logits(x)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long(), reduction="sum")


def _lr(cfg: dict, step: int) -> float:
    """The cosine schedule with linear warm-up (``step`` from 1)."""
    base, warm = cfg.get("lr", 3e-4), cfg.get("warmup", 100)
    total = cfg.get("total_steps", 10_000)
    if step < warm:
        return base * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return base * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def run(dims: Dims, params: Dict, batches: List[Dict], cfg: dict) -> Dict:
    """``len(batches)`` steps from ``params`` (float32, changed in place)
    → readings: each step's loss, each leaf's first clipped gradient's
    norm and its change's norm over the steps."""
    if any(k != "attn" for k in dims.kinds) or dims.experts:
        raise NotImplementedError("the training reference covers "
                                  "attention and gated-MLP layers")
    named = list(leaves(params))
    start = [t.detach().clone() for _, t in named]
    m = [torch.zeros_like(t) for _, t in named]
    v = [torch.zeros_like(t) for _, t in named]
    clip, wd = cfg.get("clip_norm", 1.0), cfg.get("weight_decay", 0.1)
    out: Dict = {"loss": [], "grad": {}}
    for step, batch in enumerate(batches, start=1):
        for _, t in named:
            t.requires_grad_(True)
        model = Model(dims, params)
        grads = [torch.zeros_like(t) for _, t in named]
        n = batch["tokens"].numel()
        total = 0.0
        for r in range(batch["tokens"].shape[0]):
            loss = _loss_sum(model, batch["tokens"][r:r + 1],
                             batch["labels"][r:r + 1]) / n
            gs = torch.autograd.grad(loss, [t for _, t in named],
                                     allow_unused=True)
            for acc, g in zip(grads, gs):
                if g is not None:
                    acc += g
            total += float(loss.detach())
        out["loss"].append(total)
        with torch.no_grad():
            for _, t in named:
                t.requires_grad_(False)
            gn = math.sqrt(sum(float((g * g).sum()) for g in grads))
            scale = min(clip / max(gn, 1e-9), 1.0)
            grads = [g * scale for g in grads]
            if step == 1:
                out["grad"] = {k: float(g.norm())
                               for (k, _), g in zip(named, grads)}
            lr = _lr(cfg, step)
            c1, c2 = 1 - B1 ** step, 1 - B2 ** step
            for (k, t), g, mi, vi in zip(named, grads, m, v):
                mi.mul_(B1).add_(g, alpha=1 - B1)
                vi.mul_(B2).addcmul_(g, g, value=1 - B2)
                upd = (mi / c1) / (torch.sqrt(vi / c2) + EPS)
                if t.dim() >= 2:
                    upd = upd + wd * t
                t.sub_(lr * upd)
    out["change"] = {k: float((t - s0).norm())
                     for (k, t), s0 in zip(named, start)}
    return out


def _worst_leaf(port: Dict[str, float], ref: Dict[str, float],
                keys) -> float:
    """The worst leaf's gap of norms, against the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    floor = median(ref[k] for k in keys)
    return max(abs(port[k] - ref[k]) / max(ref[k], floor) for k in keys)


def compare(port: Dict, ref: Dict) -> Dict[str, float]:
    """→ ``loss_gap`` (the largest relative gap of a step's loss),
    ``grad_norm_gap`` (the first gradient, the worst leaf) and
    ``change_norm_gap`` (the change over the steps, the worst leaf of
    those whose reference gradient is at least a thousandth of the median
    leaf's: a leaf with none moves by round-off alone)."""
    keys = sorted(ref["grad"])
    gmed = median(ref["grad"][k] for k in keys)
    moved = [k for k in keys if ref["grad"][k] >= 1e-3 * gmed]
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(port["loss"], ref["loss"])),
        "grad_norm_gap": _worst_leaf(port["grad"], ref["grad"], keys),
        "change_norm_gap": _worst_leaf(port["change"], ref["change"], moved),
        "leaves_left_out": len(keys) - len(moved)}
