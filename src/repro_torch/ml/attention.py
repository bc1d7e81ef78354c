"""Attention blocks: GQA with RoPE/M-RoPE, SWA, local:global, softcap.

The port of ``repro/ml/attention.py``.  Three execution paths share one
semantic definition:

  * ``kernels.ops.flash_attention`` — full-sequence attention through the
    hand-written CUDA kernel for CUDA tensors, its plain version for CPU
    tensors (``impl="kernel"``: prefill and serving);
  * :func:`chunked_attention` — the reference's flash-structured plain
    path (a loop over KV blocks, online softmax, each block under
    ``torch.utils.checkpoint``), which is differentiable: it is the path
    the reference trains through (``impl="reference"``), and the port's
    train step takes it too, since the CUDA kernel has no backward;
  * :func:`decode_attention` — single-token attention against a KV cache
    (optionally a rolling window cache), plain PyTorch as the reference's
    is plain jnp.

On a mesh (DTensor inputs, ``ml.sharding``'s active mesh),
:func:`chunked_attention` pins the grouped queries and the online-softmax
state as the reference does: heads over ``model`` when the KV head count
divides it, else the query sequence, batch over the batch axes.  Without a
mesh the pins return their inputs.

KV caches: dict(k, v [B, Hkv, Smax, hd], len int).  Rolling caches
(SWA / local layers) store only ``window`` positions and are written
modulo-window; absolute positions are reconstructed for masking.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import ops as kops
from .layers import dense_init, mrope, rope
from .sharding import active_mesh, constrain, is_dtensor, mesh_sizes

__all__ = ["attn_init", "attn_apply", "chunked_attention",
           "decode_attention", "cache_update", "init_cache", "AttnSpec"]


# --------------------------------------------------------------------------
# Plain chunked flash attention (memory ∝ S·block, differentiable)
# --------------------------------------------------------------------------

def _kv_block(qg, kc, vc, m, l, acc, k0: int, skv: int, q_pos, *,
              causal, window, softcap, scale):
    """One KV block of the online softmax: (m, l, acc) → updated.  Under
    a checkpoint, backward recomputes the block's probabilities instead
    of saving them."""
    bk = kc.shape[2]
    # operands rounded to the cache dtype, products summed in float32
    # (the reference's dot_general with preferred_element_type=float32)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(kc.dtype).float(),
                          kc.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    k_pos = k0 + torch.arange(bk, device=qg.device)
    mask = k_pos[None, :] < skv
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    # amax spreads a tie's gradient evenly, as jnp.max does
    m_new = torch.maximum(m, torch.amax(logits, dim=-1, keepdim=True))
    p = torch.exp(logits - m_new)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(vc.dtype).float(),
                      vc.float())
    return m_new, l_new, acc * corr + pv


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      scale: Optional[float] = None,
                      block_k: int = 1024):
    """q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D] → [B,Hq,Sq,D], online softmax.

    The reference's ``chunked_attention``: grouped GQA layout [B, Hkv, g,
    Sq, D] (no repeated K/V), KV blocks of ``block_k`` visited in order,
    masks causal with the ``Skv − Sq`` offset, window and softcap, masked
    logits at −1e30.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    bk = min(block_k, skv)
    nblk = (skv + bk - 1) // bk
    pad = nblk * bk - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    qg = q.reshape(b, hkv, group, sq, d)
    # pin q and the online-softmax carry (the reference's): heads over
    # model when they divide it, otherwise the query sequence
    mesh = active_mesh()
    n_model = mesh_sizes(mesh).get("model", 1) if mesh is not None else 1
    if hkv % n_model == 0 and hkv >= n_model:
        pin = ("batch", "model", None, None, None)
    elif sq % n_model == 0 and sq >= n_model:
        pin = ("batch", None, None, "model", None)
    else:
        pin = ("batch", None, None, None, None)
    qg = constrain(qg, pin)
    q_pos = torch.arange(sq, device=q.device) + (skv - sq)
    m = torch.full((b, hkv, group, sq, 1), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, group, sq, 1), dtype=torch.float32,
                    device=q.device)
    acc = torch.zeros((b, hkv, group, sq, d), dtype=torch.float32,
                      device=q.device)
    for i in range(nblk):
        k0 = i * bk
        m, l, acc = (constrain(t, pin) for t in checkpoint(
            _kv_block, qg, k[:, :, k0:k0 + bk], v[:, :, k0:k0 + bk], m, l,
            acc, k0, skv, q_pos, causal=causal, window=window,
            softcap=softcap, scale=scale, use_reentrant=False))
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def _whole_heads(q, k, v) -> bool:
    """Whether q, k, v [B, H, S, D] are DTensors laid out alike and cut
    only along batch and heads, evenly: each rank's pieces are then whole
    rows and whole heads (its q heads grouped with its own KV heads)."""
    if not all(is_dtensor(t) for t in (q, k, v)) \
            or not q.placements == k.placements == v.placements \
            or not q.device_mesh == k.device_mesh == v.device_mesh:
        return False
    cuts = {0: 1, 1: 1}
    for i, p in enumerate(q.placements):
        if p.is_shard():
            if p.dim not in cuts:
                return False
            cuts[p.dim] *= q.device_mesh.size(i)
        elif not p.is_replicate():          # a partial sum
            return False
    return all(t.shape[d] % n == 0 for t in (q, k, v)
               for d, n in cuts.items())


def _attention(q, k, v, *, causal, window, softcap, scale,
               impl: str = "kernel"):
    """Full-sequence attention: ``"kernel"`` through
    ``kops.flash_attention`` (the CUDA kernel on the card, no backward),
    ``"reference"`` through :func:`chunked_attention`."""
    if impl == "reference":
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        if _whole_heads(q, k, v):
            # each rank holds whole batch rows and whole heads: attention
            # needs no collective, so each runs it on its own pieces (on
            # the DTensors, the einsums would flatten two sharded dims,
            # which DTensor's propagation refuses)
            from torch.distributed.tensor.experimental import local_map
            at = list(q.placements)     # a list: one output
            return local_map(partial(chunked_attention, **kw),
                             out_placements=at, in_placements=(at, at, at),
                             device_mesh=q.device_mesh)(q, k, v)
        return chunked_attention(q, k, v, **kw)
    if impl != "kernel":
        raise ValueError(f"impl {impl!r}: expected 'kernel' or 'reference'")
    return kops.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal,
                                window=window, softcap=softcap, scale=scale)


# --------------------------------------------------------------------------
# Decode against KV cache
# --------------------------------------------------------------------------

def init_cache(batch: int, num_kv_heads: int, max_len: int, head_dim: int,
               dtype=torch.bfloat16, device="cuda"):
    return {"k": torch.zeros((batch, num_kv_heads, max_len, head_dim),
                             dtype=dtype, device=device),
            "v": torch.zeros((batch, num_kv_heads, max_len, head_dim),
                             dtype=dtype, device=device),
            "len": 0}


def decode_attention(q, cache, *, window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     rolling: bool = False):
    """q [B,Hq,1,D] vs cache (already containing the current token).

    GQA without repeating K/V: q reshapes to [B, Hkv, group, D] and
    contracts the cache.  As the reference's ``dot_general`` with
    ``preferred_element_type=float32``: q is rounded to the cache's dtype
    and the products of cache-dtype values are summed in float32 (exact
    products in float32, then float32 sums), and the probabilities are
    rounded to the cache's dtype before the value product.  On a mesh
    whose ranks hold whole batch rows and heads of q and the cache, each
    rank attends with its own pieces (as :func:`_attention`).
    """
    k, v = cache["k"], cache["v"]
    fn = partial(_decode, n=cache["len"], window=window, softcap=softcap,
                 rolling=rolling)
    if _whole_heads(q, k, v):
        from torch.distributed.tensor.experimental import local_map
        at = list(q.placements)
        return local_map(fn, out_placements=at, in_placements=(at, at, at),
                         device_mesh=q.device_mesh)(q, k, v)
    return fn(q, k, v)


def _decode(q, k, v, *, n, window, softcap, rolling):
    b, hq, _, d = q.shape
    _, hkv, smax, _ = k.shape
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q[:, :, 0, :].reshape(b, hkv, group, d).to(k.dtype).float()
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    kpos = torch.arange(smax, device=q.device)
    if rolling:
        valid = kpos < min(n, smax)
    else:
        valid = kpos < n
        if window is not None:
            valid = valid & (kpos >= n - window)
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)


def cache_update(cache, k_new, v_new, *, rolling: bool = False):
    """Write one position (k/v [B,Hkv,1,hd]) at cache['len'] (mod window
    when rolling), in place; returns the cache with ``len`` advanced."""
    smax = cache["k"].shape[2]
    pos = cache["len"] % smax if rolling else cache["len"]
    cache["k"][:, :, pos] = k_new[:, :, 0].to(cache["k"].dtype)
    cache["v"][:, :, pos] = v_new[:, :, 0].to(cache["v"].dtype)
    return {"k": cache["k"], "v": cache["v"], "len": cache["len"] + 1}


# --------------------------------------------------------------------------
# Full GQA block
# --------------------------------------------------------------------------

class AttnSpec:
    """Static attention configuration for one layer."""

    def __init__(self, d_model: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, *, qkv_bias=False, window=None,
                 softcap=None, rope_theta=10000.0, mrope=False,
                 causal=True, query_scale: Optional[float] = None):
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.qkv_bias = qkv_bias
        self.window = window
        self.softcap = softcap
        self.rope_theta = rope_theta
        self.mrope = mrope
        self.causal = causal
        self.query_scale = query_scale


def attn_init(gen: torch.Generator, spec: AttnSpec):
    d, h, hkv, hd = (spec.d_model, spec.num_heads, spec.num_kv_heads,
                     spec.head_dim)
    p = {"wq": dense_init(gen, d, h * hd),
         "wk": dense_init(gen, d, hkv * hd),
         "wv": dense_init(gen, d, hkv * hd),
         "wo": dense_init(gen, h * hd, d)}
    if spec.qkv_bias:
        for name, n in (("wq_bias", h), ("wk_bias", hkv), ("wv_bias", hkv)):
            p[name] = torch.zeros((n * hd,), dtype=torch.float32,
                                  device=gen.device)
    return p


def _project_qkv(x, p, spec: AttnSpec, positions):
    b, s, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if spec.qkv_bias:
        q = q + p["wq_bias"].to(x.dtype)
        k = k + p["wk_bias"].to(x.dtype)
        v = v + p["wv_bias"].to(x.dtype)
    q = q.reshape(b, s, spec.num_heads, spec.head_dim).transpose(1, 2)
    k = k.reshape(b, s, spec.num_kv_heads, spec.head_dim).transpose(1, 2)
    v = v.reshape(b, s, spec.num_kv_heads, spec.head_dim).transpose(1, 2)
    if positions is not None:
        fn = mrope if spec.mrope else rope
        q = fn(q, positions, spec.rope_theta)
        k = fn(k, positions, spec.rope_theta)
    return q, k, v


def attn_apply(x, p, spec: AttnSpec, positions, *,
               kv: Optional[Tuple] = None,
               cache: Optional[dict] = None, rolling: bool = False,
               impl: str = "kernel"):
    """Returns (out [B,S,D], updated cache or None).

    Training/prefill: cache None → full attention over x (or ``kv`` for
    cross-attention).  Decode: S==1 with a cache → append + attend.
    """
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, spec, positions)
    if kv is not None:                       # cross-attention (enc-dec)
        k, v = kv
    if cache is not None:
        cache = cache_update(cache, k, v, rolling=rolling)
        out = decode_attention(q, cache, window=spec.window,
                               softcap=spec.softcap, rolling=rolling)
    else:
        out = _attention(q, k, v, causal=spec.causal, window=spec.window,
                         softcap=spec.softcap, scale=spec.query_scale,
                         impl=impl)
    out = out.transpose(1, 2).reshape(b, s, -1)
    dt = torch.promote_types(out.dtype, p["wo"].dtype)   # as jnp promotes
    return out.to(dt) @ p["wo"].to(dt), cache
