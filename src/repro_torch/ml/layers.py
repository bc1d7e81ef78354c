"""Shared neural layers (plain PyTorch on parameter dictionaries).

The port of ``repro/ml/layers.py``.  Parameters are nested dicts of
tensors with the reference's keys and layouts ([d_in, d_out] dense
weights), so the JAX package's parameters carry over one to one
(``ml.params``).  Initializers draw from a ``torch.Generator`` on the
generator's device; they do not reproduce ``jax.random``'s numbers.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["rms_norm", "layer_norm", "dense_init", "rope", "mrope",
           "mlp_init", "mlp_apply", "norm_init", "embed_init", "gelu",
           "silu"]


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return _normal(gen, (d_in, d_out)) * scale


def embed_init(gen: torch.Generator, vocab: int, d: int) -> torch.Tensor:
    return _normal(gen, (vocab, d)) * 0.02


def norm_init(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rms_norm(x, p, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * p["scale"].float()).to(dt)


def layer_norm(x, p, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps) * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(dt)


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


# ------------------------------------------------------------------ RoPE

def _freqs(dim: int, theta: float, device) -> torch.Tensor:
    half = dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def _rotate(x, cos, sin):
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding. x [B, H, S, D], positions [B, S] (absolute)."""
    ang = positions[..., None].float() * _freqs(x.shape[-1], theta,
                                                x.device)   # [B, S, D/2]
    return _rotate(x, torch.cos(ang)[:, None], torch.sin(ang)[:, None])


def mrope(x, positions3, theta: float = 10000.0,
          sections: Tuple[int, int, int] = (2, 1, 1)):
    """Multimodal RoPE (Qwen2-VL §3.1): head_dim split into temporal/
    height/width sections with separate position streams.

    x [B, H, S, D]; positions3 [3, B, S] (equal streams ⇒ plain RoPE on
    text).  ``sections`` are relative weights over D/2 frequency slots.
    """
    half = x.shape[-1] // 2
    total = sum(sections)
    sizes = [half * w // total for w in sections]
    sizes[-1] = half - sum(sizes[:-1])
    sel = torch.cat([torch.full((sz,), i, dtype=torch.long)
                     for i, sz in enumerate(sizes)]).to(x.device)
    p_sel = positions3[sel]                                # [half, B, S]
    ang = torch.movedim(p_sel, 0, -1).float() * _freqs(x.shape[-1], theta,
                                                       x.device)
    return _rotate(x, torch.cos(ang)[:, None], torch.sin(ang)[:, None])


# ------------------------------------------------------------------- MLP

def mlp_init(gen: torch.Generator, d: int, f: int, *, gated: bool = True):
    if gated:
        return {"w_gate": dense_init(gen, d, f),
                "w_up": dense_init(gen, d, f),
                "w_down": dense_init(gen, f, d)}
    return {"w_up": dense_init(gen, d, f), "w_down": dense_init(gen, f, d)}


def mlp_apply(x, p, act: str = "silu"):
    a = {"silu": silu, "gelu": gelu}[act]
    wg = p.get("w_gate")
    wu = p["w_up"].to(x.dtype)
    wd = p["w_down"].to(x.dtype)
    if wg is not None:
        h = a(x @ wg.to(x.dtype)) * (x @ wu)
    else:
        h = a(x @ wu)
    return h @ wd
