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
    """The whole tree on ``device``."""
    p: Dict = {}
    for path, t in made(dims, seed, device, purpose):
        put(p, path, t)
    return p


def put(tree: Dict, path, leaf) -> None:
    """``leaf`` at ``path`` (a tuple of keys) in the nested ``tree``."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def made(dims: Dims, seed: int, device, purpose: str = "serve"):
    """(path tuple, tensor) of every leaf in the order the generator
    draws them (the tree's own order), each made as it is asked for: a
    caller that keeps a piece of each leaf and drops the rest never holds
    more than one whole leaf."""
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
    yield ("embed",), rand("embed", (dims.vocab, d), 0.02)
    for s in range(per):
        at = ("blocks", f"slot{s}")
        yield at + ("norm1", "scale"), const((g, d), 1.0)
        if dims.kinds[s] == "attn":
            h, kv, hd = dims.heads, dims.kv_heads, dims.hd
            for name, d_in, d_out in (("wq", d, h * hd), ("wk", d, kv * hd),
                                      ("wv", d, kv * hd), ("wo", h * hd, d)):
                yield at + ("attn", name), dense(name, (g,), d_in, d_out)
        else:
            di, n, r, k = dims.di, dims.d_state, dims.dt_rank, dims.d_conv
            m = at + ("mamba",)
            yield m + ("in_proj",), dense("in_proj", (g,), d, 2 * di)
            yield m + ("conv_w",), rand("conv_w", (g, di, k), 0.1)
            yield m + ("conv_b",), const((g, di), 0.0)
            yield m + ("x_proj",), dense("x_proj", (g,), di, r + 2 * n)
            yield m + ("dt_proj",), dense("dt_proj", (g,), r, di)
            yield m + ("dt_bias",), const((g, di), 0.0)
            yield m + ("A_log",), torch.log(torch.arange(
                1, n + 1, dtype=torch.float32, device=dev)).repeat(g, di, 1)
            yield m + ("D_skip",), const((g, di), 1.0)
            yield m + ("out_proj",), dense("out_proj", (g,), di, d)
        if f > 0:
            yield at + ("norm2", "scale"), const((g, d), 1.0)
            if dims.moe[s]:
                e = dims.experts
                yield at + ("moe", "router"), dense("router", (g,), d, e)
                ex = at + ("moe", "experts")
            else:
                e, ex = None, at + ("mlp",)
            lead = (g,) if e is None else (g, e)
            for name, d_in, d_out in (("w_gate", d, f), ("w_up", d, f),
                                      ("w_down", f, d)):
                yield ex + (name,), dense(name, lead, d_in, d_out)
    yield ("final_norm", "scale"), const((d,), 1.0)
    if not dims.tie:
        yield ("lm_head",), dense("lm_head", (), d, dims.vocab)


def stage(dims: Dims, seed: int, device, layers: range, *,
          embed: bool = False, head: bool = False) -> Dict:
    """The served tree's ``layers`` (whole groups of the stacked tree),
    with the embedding and the final norm and head where asked: the same
    numbers as :func:`make`'s, drawn by the same sequence a leaf at a
    time, each whole leaf freed once its groups are copied.  The groups
    start at index 0, so that :func:`layer` takes a held layer's index
    less ``layers.start``."""
    g0, g1 = layers.start // dims.period, layers.stop // dims.period
    out: Dict = {}
    for path, t in made(dims, seed, device, "serve"):
        if path[0] == "blocks":
            keep = t[g0:g1].clone()
        elif embed if path[0] == "embed" else head:
            keep = t
        else:
            continue
        del t
        put(out, path, keep)
    return out


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

