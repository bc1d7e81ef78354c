"""Optimizer stack: AdamW + global-norm clip + schedules + int8
error-feedback gradient compression.

The port of ``repro/ml/optim.py`` over nested dicts of tensors (the
parameter trees of ``ml.transformer``).  AdamW keeps float32 moments,
counts steps from 1 and decays only leaves with ``ndim >= 2``.
``compress_ef`` quantizes grads plus the carried error to int8 with a
per-tensor scale (error feedback).  The reference's ``compressed_psum``
moves that int8 payload over a mesh axis; it needs a process group of
several cards and is not ported yet (ROADMAP A12, the ML meshes).
"""
from __future__ import annotations

import math

import torch

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "compress_ef", "ef_init", "compressed_psum",
           "tree_map", "tree_leaves"]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (and lists) of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


# ------------------------------------------------------------------ AdamW

def adamw_init(params):
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(params, grads, state, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    step = state["step"] + 1
    t = step.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t

    def upd(p, g, m, v):
        g = g.float()
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        update = (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
        if p.dim() >= 2:    # decay matrices only (norms/bias exempt)
            update = update + weight_decay * p.float()
        return (p.float() - lr * update).to(p.dtype), m2, v2

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_p, new_m, new_v = (_pick(out, i) for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}


def _pick(tree, i):
    """Element ``i`` of every tuple leaf of ``tree`` (dicts/lists of
    tuples)."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def clip_by_global_norm(grads, max_norm: float):
    """→ (grads scaled to global norm ≤ ``max_norm``, the norm before).
    The scale is a float32 scalar, so bf16 grads come back float32, as
    the reference's promotion gives."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), gn


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    """step → float32 learning rate: linear warmup, then cosine decay to
    ``min_ratio · base_lr`` at ``total``."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


# ----------------------------------------------- int8 error-feedback EF21

def ef_init(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _quant_int8(x):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_ef(grads, err):
    """Quantize grads+carried error to int8; return (deq grads, new err).

    Error feedback: e' = (g + e) − deq(quant(g + e)); the residual is
    re-injected next step, preserving convergence under 4× compression.
    """
    def one(g, e):
        x = g.float() + e
        q, scale = _quant_int8(x)
        deq = q.float() * scale
        return deq, x - deq

    out = tree_map(one, grads, err)
    return _pick(out, 0), _pick(out, 1)


def compressed_psum(x, axis_name: str):
    """Mean over a mesh axis moving int8 on the wire — needs a process
    group over several cards, which the port does not have yet."""
    raise NotImplementedError(
        "compressed_psum needs a multi-card process group: the ML meshes "
        "are not ported yet (ROADMAP.md, queue A item A12)")
