"""The model's weights, made on the device from the run's seed.

One ``torch.Generator`` on the device draws every random leaf in one call
each, in the dtype it is served in, in a fixed order, so the same seed
gives the same weights to the port and, made again after the window, to
the reference.  The tree is the port's parameter layout (nested dicts,
the layers of one slot of the layer pattern stacked along a leading
group dim); the references index it layer by layer.  Scales follow the
usual fan-in rule (``1/sqrt(d_in)``), the embedding 0.02; norm scales are
1, biases 0, Mamba's ``A_log`` is ``log(1..N)`` a channel.

``serve``: matrices that every use casts to the activations (bf16) are
made in bf16, the rest (norm scales, Mamba's conv, x/dt projections, A,
D) in float32, the dtypes the served model keeps them in.  ``train``:
every leaf in float32, the master weights.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .model import Dims

BF16_LEAVES = frozenset({"embed", "lm_head", "wq", "wk", "wv", "wo",
                         "w_gate", "w_up", "w_down", "router", "in_proj",
                         "out_proj"})


def make(dims: Dims, seed: int, device, purpose: str = "serve") -> Dict:
    if purpose not in ("serve", "train"):
        raise ValueError(f"purpose {purpose!r}: expected serve or train")
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % 2 ** 63)
    g, per = dims.groups, dims.period

    def dt(name):
        if purpose == "train" or name not in BF16_LEAVES:
            return torch.float32
        return torch.bfloat16

    def rand(name, shape, scale):
        t = torch.randn(shape, generator=gen, dtype=dt(name), device=dev)
        return t.mul_(scale)

    def dense(name, lead, d_in, d_out):
        return rand(name, (*lead, d_in, d_out), 1.0 / math.sqrt(d_in))

    def const(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    d, f = dims.d, dims.d_ff
    p: Dict = {"embed": rand("embed", (dims.vocab, d), 0.02), "blocks": {}}
    for s in range(per):
        blk: Dict = {"norm1": {"scale": const((g, d), 1.0)}}
        if dims.kinds[s] == "attn":
            h, kv, hd = dims.heads, dims.kv_heads, dims.hd
            blk["attn"] = {"wq": dense("wq", (g,), d, h * hd),
                           "wk": dense("wk", (g,), d, kv * hd),
                           "wv": dense("wv", (g,), d, kv * hd),
                           "wo": dense("wo", (g,), h * hd, d)}
        else:
            di, n, r, k = dims.di, dims.d_state, dims.dt_rank, dims.d_conv
            a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                           device=dev))
            blk["mamba"] = {
                "in_proj": dense("in_proj", (g,), d, 2 * di),
                "conv_w": rand("conv_w", (g, di, k), 0.1),
                "conv_b": const((g, di), 0.0),
                "x_proj": dense("x_proj", (g,), di, r + 2 * n),
                "dt_proj": dense("dt_proj", (g,), r, di),
                "dt_bias": const((g, di), 0.0),
                "A_log": a_log.repeat(g, di, 1),
                "D_skip": const((g, di), 1.0),
                "out_proj": dense("out_proj", (g,), di, d)}
        if f > 0:
            blk["norm2"] = {"scale": const((g, d), 1.0)}
            if dims.moe[s]:
                e = dims.experts
                blk["moe"] = {
                    "router": dense("router", (g,), d, e),
                    "experts": {"w_gate": dense("w_gate", (g, e), d, f),
                                "w_up": dense("w_up", (g, e), d, f),
                                "w_down": dense("w_down", (g, e), f, d)}}
            else:
                blk["mlp"] = {"w_gate": dense("w_gate", (g,), d, f),
                              "w_up": dense("w_up", (g,), d, f),
                              "w_down": dense("w_down", (g,), f, d)}
        p["blocks"][f"slot{s}"] = blk
    p["final_norm"] = {"scale": const((d,), 1.0)}
    if not dims.tie:
        p["lm_head"] = dense("lm_head", (), d, dims.vocab)
    return p


def layer(params: Dict, dims: Dims, i: int) -> Dict:
    """Layer ``i``'s leaves (views) from the stacked tree."""
    g, s = divmod(i, dims.period)

    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[g]
    return pick(params["blocks"][f"slot{s}"])


def head(params: Dict, dims: Dims) -> torch.Tensor:
    """The LM head [d, V]: the embedding's transpose where tied."""
    return params["embed"].T if dims.tie else params["lm_head"]


def leaves(tree, prefix: str = ""):
    """(path, tensor) of every leaf, in a fixed order."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaves(v, path)
        else:
            yield path, v

