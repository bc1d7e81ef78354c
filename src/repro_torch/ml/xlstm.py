"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The port of ``repro/ml/xlstm.py`` (arXiv 2405.04517), plain PyTorch as
the reference is plain jnp: no kernel of the port runs here.

mLSTM (§2.3) is a linear-attention-style cell with exponential input
gates and a matrix memory C ∈ ℝ^{dh×dh} per head.  Training and prefill
use the *chunked* parallel form: intra-chunk decayed attention (quadratic
within a chunk of ``chunk`` positions) plus an inter-chunk carry (C, n),
the chunks threaded in order.  Gates are sigmoid forget and clipped-exp
input, the stabiliser folded into the chunk's log-space cumulative sums.
Where grad is on, each chunk runs under ``torch.utils.checkpoint``, as the
reference's ``jax.checkpoint``: backward recomputes the chunk's decay
matrices instead of keeping them.  Decode is the O(1) recurrence.

sLSTM (§2.2) has a scalar memory with recurrent block-diagonal per-head
connections, so it is sequential: a loop over time, each step under
``torch.utils.checkpoint`` where grad is on (the reference scans a
checkpointed step).  The four input projections are one product each over
the whole sequence, in float32.  A gated pf=4/3 MLP follows.

The reference's ``REPRO_SSM_CHUNK`` is ``mlstm_apply``'s ``chunk``
argument here (256 by default), as in ``ml/mamba.py``.  On a mesh the
mLSTM carry (C, n) is pinned after each chunk, as the reference pins it
(``ml.sharding.constrain``: batch over the batch axes, the value dim over
``model``).
"""
from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import dense_init, silu
from .sharding import constrain

__all__ = ["mlstm_init", "mlstm_apply", "mlstm_decode", "mlstm_cache_init",
           "slstm_init", "slstm_apply", "slstm_decode", "slstm_cache_init"]

_I_CLIP = 5.0


def _maybe_checkpoint(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` where grad is on."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _headwise(gen: torch.Generator, num_heads: int, dh: int):
    """Per-head block-diagonal projection [H, dh, dh]."""
    return torch.randn((num_heads, dh, dh), generator=gen,
                       device=gen.device) / math.sqrt(dh)


def _inv_sqrt(dh: int) -> float:
    """1/√dh rounded as the reference rounds it (a float32 square root,
    then a float32 quotient); a float32 value, so a float32 tensor times
    it is exact to the reference's product."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


# ===========================================================================
# mLSTM
# ===========================================================================

def mlstm_init(gen: torch.Generator, d: int, num_heads: int, *,
               pf: int = 2):
    di = pf * d
    dh = di // num_heads
    return {
        "w_upA": dense_init(gen, d, di),        # cell input path
        "w_upB": dense_init(gen, d, di),        # output gate path
        "wq": _headwise(gen, num_heads, dh),
        "wk": _headwise(gen, num_heads, dh),
        "wv": _headwise(gen, num_heads, dh),
        "wi": dense_init(gen, di, num_heads),
        "wf": dense_init(gen, di, num_heads),
        "out_proj": dense_init(gen, di, d),
    }


def _headwise_proj(u, w, num_heads: int):
    """u [B, S, dI] × w [H, dh, dh] → [B, H, S, dh]."""
    b, s, di = u.shape
    uh = u.reshape(b, s, num_heads, di // num_heads)
    return torch.einsum("bshd,hde->bhse", uh, w.to(u.dtype))


def _mlstm_gates(u, p):
    """u [B, S, dI] → log_f, log_i [B, S, H] (stabilised), in float32."""
    f_raw = u.float() @ p["wf"].float()
    i_raw = u.float() @ p["wi"].float()
    return F.logsigmoid(f_raw), torch.clamp(i_raw, -_I_CLIP, _I_CLIP)


def _mlstm_qkv(u, p, num_heads: int):
    """Float32 q (scaled), k, v [B, H, S, dh] and gates [B, H, S]."""
    dh = u.shape[-1] // num_heads
    q = _headwise_proj(u, p["wq"], num_heads).float() \
        * _inv_sqrt(dh)
    k = _headwise_proj(u, p["wk"], num_heads).float()
    v = _headwise_proj(u, p["wv"], num_heads).float()
    log_f, log_i = _mlstm_gates(u, p)
    return q, k, v, log_f.transpose(1, 2), log_i.transpose(1, 2)


def _mlstm_chunk(C, n, qq, kk, vv, lf, li):
    """One chunk of c positions: carry (C [B,H,dh,dh], n [B,H,dh]) and
    q/k/v [B,H,c,dh], log gates [B,H,c] → (C', n', h [B,H,c,dh])."""
    c = lf.shape[-1]
    Lf = torch.cumsum(lf, dim=-1)                     # [B,H,c] inclusive
    # intra-chunk decay matrix (log space, lower triangular)
    dmat = Lf[..., :, None] - Lf[..., None, :] + li[..., None, :]
    tri = torch.ones((c, c), dtype=torch.bool, device=lf.device).tril()
    w = torch.exp(torch.where(tri, dmat, torch.full_like(dmat,
                                                         -math.inf)))
    scores = torch.einsum("bhtd,bhsd->bhts", qq, kk) * w
    intra = torch.einsum("bhts,bhsd->bhtd", scores, vv)
    n_intra = torch.einsum("bhts,bhsd->bhtd", w, kk)
    # inter-chunk contribution
    decay_t = torch.exp(Lf)[..., None]                # [B,H,c,1]
    inter = torch.einsum("bhtd,bhde->bhte", qq * decay_t, C)
    n_tot = n_intra + decay_t * n[:, :, None, :]
    denom = torch.clamp(torch.abs(torch.einsum("bhtd,bhtd->bht", qq,
                                               n_tot))[..., None], min=1.0)
    h = (intra + inter) / denom
    # carry update
    decay_end = torch.exp(Lf[..., -1:] - Lf)          # [B,H,c]
    ki = kk * torch.exp(li)[..., None] * decay_end[..., None]
    f_end = torch.exp(Lf[..., -1])
    C_new = f_end[..., None, None] * C + torch.einsum("bhsd,bhse->bhde",
                                                      ki, vv)
    n_new = f_end[..., None] * n + ki.sum(dim=2)
    # pin the carry: batch over the batch axes, the value dim over model
    C_new = constrain(C_new, ("batch", None, None, "model"))
    n_new = constrain(n_new, ("batch", None, "model"))
    return C_new, n_new, h


def mlstm_apply(x, p, num_heads: int, *, chunk: int = 256,
                return_state: bool = False):
    """x [B, S, D] → [B, S, D] via chunked decayed linear attention.

    ``return_state`` also returns the decode cache {C, n} after position
    S: padded positions have log_f = 0 (no decay), log_i = −5 and k = v =
    0 (no contribution), so the state is exact.
    """
    b, s, _ = x.shape
    u = silu(x @ p["w_upA"].to(x.dtype))
    og = silu(x @ p["w_upB"].to(x.dtype))
    di = u.shape[-1]
    dh = di // num_heads
    q, k, v, log_f, log_i = _mlstm_qkv(u, p, num_heads)
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        log_f = F.pad(log_f, (0, pad))
        log_i = F.pad(log_i, (0, pad), value=-_I_CLIP)
    C = torch.zeros((b, num_heads, dh, dh), dtype=torch.float32,
                    device=x.device)
    n = torch.zeros((b, num_heads, dh), dtype=torch.float32,
                    device=x.device)
    hs = []
    for c0 in range(0, s + pad, c):
        cs = slice(c0, c0 + c)
        C, n, h = _maybe_checkpoint(_mlstm_chunk, C, n, q[:, :, cs],
                                    k[:, :, cs], v[:, :, cs],
                                    log_f[:, :, cs], log_i[:, :, cs])
        hs.append(h)
    h = torch.cat(hs, dim=2)[:, :, :s]
    h = h.transpose(1, 2).reshape(b, s, di).to(x.dtype)
    out = (h * og) @ p["out_proj"].to(h.dtype)
    if return_state:
        return out, {"C": C, "n": n}
    return out


def mlstm_cache_init(batch: int, d: int, num_heads: int, pf: int = 2,
                     device="cuda"):
    di = pf * d
    dh = di // num_heads
    return {"C": torch.zeros((batch, num_heads, dh, dh), device=device),
            "n": torch.zeros((batch, num_heads, dh), device=device)}


def mlstm_decode(x, p, num_heads: int, cache):
    """x [B, 1, D] → (y [B, 1, D], new cache) — the O(1) recurrence."""
    b = x.shape[0]
    u = silu(x[:, 0] @ p["w_upA"].to(x.dtype))
    og = silu(x[:, 0] @ p["w_upB"].to(x.dtype))
    di = u.shape[-1]
    q, k, v, log_f, log_i = _mlstm_qkv(u[:, None], p, num_heads)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]      # [B, H, dh]
    f = torch.exp(log_f[..., 0])[..., None]           # [B, H, 1]
    i = torch.exp(log_i[..., 0])[..., None]
    C = f[..., None] * cache["C"] + i[..., None] * torch.einsum(
        "bhd,bhe->bhde", k, v)
    n = f * cache["n"] + i * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    denom = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", q, n))[
        ..., None], min=1.0)
    h = (num / denom).reshape(b, di).to(x.dtype)
    return ((h * og) @ p["out_proj"].to(h.dtype))[:, None], {"C": C, "n": n}


# ===========================================================================
# sLSTM
# ===========================================================================

_GATES = ("i", "f", "z", "o")


def slstm_init(gen: torch.Generator, d: int, num_heads: int):
    dh = d // num_heads
    f = d * 4 // 3
    p = {"out_proj": dense_init(gen, d, d),
         "mlp": {"w_gate": dense_init(gen, d, f),
                 "w_up": dense_init(gen, d, f),
                 "w_down": dense_init(gen, f, d)}}
    for g in _GATES:
        p[f"w{g}"] = dense_init(gen, d, d)
        p[f"r{g}"] = _headwise(gen, num_heads, dh)
        p[f"b{g}"] = torch.zeros((d,), device=gen.device)
    return p


def _slstm_step(p, num_heads: int, c, n, h, m, xi, xf, xz, xo):
    """One time step: state (c, n, h, m) and the step's input projections
    (xi, xf, xz, xo), each [B, D] float32 → (c', n', h', m')."""
    b, d = xi.shape
    hh = h.reshape(b, num_heads, d // num_heads)

    def rec(r):
        return torch.einsum("bhd,hde->bhe", hh, r.float()).reshape(b, d)

    hi = xi + rec(p["ri"]) + p["bi"]
    hf = xf + rec(p["rf"]) + p["bf"]
    hz = xz + rec(p["rz"]) + p["bz"]
    ho = xo + rec(p["ro"]) + p["bo"]
    # stabilised exponential gating (paper eq. 15–17)
    m_new = torch.maximum(hf + m, hi)
    i_g = torch.exp(hi - m_new)
    f_g = torch.exp(hf + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(hz)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(ho) * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, h_new, m_new


def _slstm_inputs(x, p):
    """The four gates' input projections over the whole sequence, each
    [B, S, D] in float32."""
    xf32 = x.float()
    return [xf32 @ p[f"w{g}"].float() for g in _GATES]


def _slstm_out(h, p):
    """The output projection and the gated pf=4/3 MLP on it."""
    out = h @ p["out_proj"].to(h.dtype)
    mlp = p["mlp"]
    dt = out.dtype
    return out + (silu(out @ mlp["w_gate"].to(dt))
                  * (out @ mlp["w_up"].to(dt))) @ mlp["w_down"].to(dt)


def _state(st):
    return dict(zip(("c", "n", "h", "m"), st))


def slstm_apply(x, p, num_heads: int, *, return_state: bool = False):
    """x [B, S, D] → [B, S, D] (sequential over time)."""
    b, s, d = x.shape
    xw = _slstm_inputs(x, p)
    z0 = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    st = (z0, z0, z0, z0)
    hs = []
    for t in range(s):
        st = _maybe_checkpoint(partial(_slstm_step, p, num_heads), *st,
                               *(w[:, t] for w in xw))
        hs.append(st[2])
    out = _slstm_out(torch.stack(hs, dim=1).to(x.dtype), p)
    if return_state:
        return out, _state(st)
    return out


def slstm_cache_init(batch: int, d: int, device="cuda"):
    return {k: torch.zeros((batch, d), device=device)
            for k in ("c", "n", "h", "m")}


def slstm_decode(x, p, num_heads: int, cache):
    """x [B, 1, D] → (y [B, 1, D], new cache)."""
    xw = [t[:, 0] for t in _slstm_inputs(x, p)]
    st = _slstm_step(p, num_heads, cache["c"], cache["n"], cache["h"],
                     cache["m"], *xw)
    return _slstm_out(st[2].to(x.dtype), p)[:, None], _state(st)
