"""The plain reference of the served models: a decoder of attention and
Mamba layers with gated-MLP or top-k MoE feed-forwards, in float32.

Plain ``torch`` operations on the benchmark's weights (``harness.
weights``, widened to float32 by :func:`widen`), no kernel and nothing
of the port.  It keeps caches of its own (K and V of every
position, the Mamba state and conv tail) so that it can follow a served
batch through its prefill and each decode step with the same tokens.

What each layer computes, as the served model defines it:

* RMSNorm: x / sqrt(mean(x^2) + eps) * scale.
* Attention: GQA (query head h reads KV head h // (H / Hkv)), causal,
  scale 1/sqrt(hd), RoPE (rotate-half, theta^(-i/(hd/2))) at the row's
  absolute positions where the model has it, none for Jamba.
* Mamba (Mamba-1, Gu and Dao, arXiv:2312.00752): in_proj → x, z; x
  through a causal depthwise conv (K taps, bias) and SiLU; dt, B, C from
  x_proj, dt = softplus(dt_proj(dt) + bias); h_t = exp(dt_t A) h_{t-1} +
  dt_t x_t B_t, y_t = C_t . h_t + D x_t, computed one position at a time;
  y * SiLU(z) through out_proj.  Departure from Jamba-v0.1: no RMSNorm on
  dt, B and C inside the mixer (the served model has none).
* MoE: softmax router, top-k by repeated argmax (first maximum), GShard
  capacity max(k, f * S_g * k / E) a dispatch group, groups of S_g
  consecutive tokens of the batch flattened row by row (the prefill's
  [B, S], a decode step's B rows), the k-th choices queued after all
  (k-1)-th ones, a token past its expert's capacity dropped; each kept
  token's expert output weighted by its gate (not renormalised).
  Departure from Jamba-v0.1, which routes without drops: the served
  model's GShard capacity 1.25 and its drops.
* Gated MLP: down(SiLU(gate(x)) * up(x)).

``precision="fp8"`` is the control: every matrix product's two operands
rounded to float8 e4m3 with a scale a tensor (amax / 448), the products
summed in float32.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from ..harness.model import Dims, moe_groups
from ..harness.weights import head as head_of, layer as layer_of

FP8_MAX = 448.0


def exact_float32() -> None:
    """Float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor) -> torch.Tensor:
    t = t.float()
    s = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def widen(params: Dict) -> Dict:
    """Every leaf in float32, in place, one leaf at a time (the bf16 copy
    of a leaf freed as its float32 one is made): products then read
    float32 weights once, where widening at each use would write and
    read them again every step."""
    for k, v in params.items():
        params[k] = widen(v) if isinstance(v, dict) else v.float()
    return params


class Model:
    """The model, or with ``layers`` (a range) the stage that holds those
    layers alone: ``params`` then holds their groups (the first at group
    index 0, as ``harness.weights.stage`` makes them) and, where the
    stage has them, the embedding or the final norm and head."""

    def __init__(self, dims: Dims, params: Dict, precision: str = "fp32",
                 layers: range = None):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.dims = dims
        self.p = params
        self.span = range(dims.layers) if layers is None else layers
        self.layers = [layer_of(params, dims, i - self.span.start)
                       for i in self.span]
        self.fp8 = precision == "fp8"

    # ------------------------------------------------------------ pieces
    def lin(self, x, w):
        if self.fp8:
            return _fp8(x) @ _fp8(w)
        return x.float() @ w.float()

    def norm(self, x, scale):
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.dims.eps) * scale.float()

    def rope(self, x, pos):
        """x [B, H, S, hd], pos [S] absolute positions."""
        half = x.shape[-1] // 2
        freqs = self.dims.rope_theta ** (
            -torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = pos.float()[:, None] * freqs
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def mlp(self, x, p):
        return self.lin(F.silu(self.lin(x, p["w_gate"]))
                        * self.lin(x, p["w_up"]), p["w_down"])

    def moe(self, x, p):
        """x [..., d]: the tokens in row order form the dispatch groups."""
        d = self.dims
        shape = x.shape
        tok = x.reshape(-1, shape[-1])
        t = tok.shape[0]
        sg, cap = moe_groups(t, d.group_size, d.experts, d.top_k,
                             d.capacity_factor)
        g = t // sg
        gates = torch.softmax(self.lin(tok, p["router"]), dim=-1)
        gk = gates.view(g, sg, -1).clone()
        used = torch.zeros((g, d.experts), device=x.device)
        picks = []                     # (expert, gate, kept) a choice
        for _ in range(d.top_k):
            idx = torch.argmax(gk, dim=-1)                      # [G, Sg]
            gval = torch.gather(gk, -1, idx[..., None])[..., 0]
            onehot = F.one_hot(idx, d.experts).float()
            pos = ((torch.cumsum(onehot, dim=1) - onehot + used[:, None])
                   * onehot).sum(-1)
            keep = pos < cap
            used = used + (onehot * keep[..., None]).sum(dim=1)
            gk = gk * (1.0 - onehot)
            picks.append((idx.reshape(-1), gval.reshape(-1),
                          keep.reshape(-1)))
        idx = torch.cat([i for i, _, _ in picks])
        gval = torch.cat([v for _, v, _ in picks])
        keep = torch.cat([k for _, _, k in picks])
        row = torch.arange(t, device=x.device).repeat(d.top_k)
        sel = torch.nonzero(keep)[:, 0]
        sel = sel[torch.argsort(idx[sel], stable=True)]
        counts = torch.bincount(idx[sel], minlength=d.experts).tolist()
        out = torch.zeros_like(tok)
        at = 0
        for e, n in enumerate(counts):
            if n == 0:
                continue
            part = sel[at:at + n]
            at += n
            ex = {k: w[e] for k, w in p["experts"].items()}
            y = self.mlp(tok[row[part]], ex)
            out.index_add_(0, row[part], y * gval[part, None])
        return out.view(shape)

    def ffn(self, x, lp):
        if "moe" in lp:
            return self.moe(x, lp["moe"])
        return self.mlp(x, lp["mlp"])

    # --------------------------------------------------------- attention
    def _qkv(self, x, p, pos):
        d = self.dims
        b, s, _ = x.shape
        q = self.lin(x, p["wq"]).view(b, s, d.heads, d.hd).transpose(1, 2)
        k = self.lin(x, p["wk"]).view(b, s, d.kv_heads, d.hd).transpose(1, 2)
        v = self.lin(x, p["wv"]).view(b, s, d.kv_heads, d.hd).transpose(1, 2)
        if d.pos == "rope":
            q, k = self.rope(q, pos), self.rope(k, pos)
        return q, k, v

    def _attend(self, q, k, v, q0: int):
        """q [B, H, Sq, hd] at key positions q0.., k/v [B, Hkv, Skv, hd];
        one row at a time."""
        d = self.dims
        grp = d.heads // d.kv_heads
        sq, skv = q.shape[2], k.shape[2]
        qpos = q0 + torch.arange(sq, device=q.device)
        mask = torch.arange(skv, device=q.device)[None, :] <= qpos[:, None]
        outs = []
        for r in range(q.shape[0]):
            kr = k[r].repeat_interleave(grp, dim=0)
            vr = v[r].repeat_interleave(grp, dim=0)
            sc = (q[r] @ kr.transpose(1, 2)) / math.sqrt(d.hd)
            sc = sc.masked_fill(~mask, float("-inf"))
            outs.append(torch.softmax(sc, dim=-1) @ vr)
        return torch.stack(outs)

    def _attn_out(self, o, p):
        b, h, s, hd = o.shape
        return self.lin(o.transpose(1, 2).reshape(b, s, h * hd), p["wo"])

    # ------------------------------------------------------------- mamba
    def _ssm_inputs(self, x1, p):
        d = self.dims
        r, n = d.dt_rank, d.d_state
        dbl = self.lin(x1, p["x_proj"])
        dt, bm, cm = torch.split(dbl, [r, n, n], dim=-1)
        delta = F.softplus(self.lin(dt, p["dt_proj"]) + p["dt_bias"].float())
        return delta, bm, cm

    def _mamba_seq(self, x, p, state):
        d = self.dims
        b, s, _ = x.shape
        x1r, z = torch.chunk(self.lin(x, p["in_proj"]), 2, dim=-1)
        k = d.d_conv
        pad = torch.cat([torch.zeros_like(x1r[:, :1]).expand(-1, k - 1, -1),
                         x1r], dim=1)
        w = p["conv_w"].float()
        x1 = p["conv_b"].float() + sum(pad[:, i:i + s] * w[:, i]
                                       for i in range(k))
        x1 = F.silu(x1)
        delta, bm, cm = self._ssm_inputs(x1, p)
        a = -torch.exp(p["A_log"].float())                  # [dI, N]
        h = torch.zeros((b, d.di, d.d_state), device=x.device)
        y = torch.empty_like(x1)
        blk = 32
        for t0 in range(0, s, blk):
            dl = delta[:, t0:t0 + blk]
            da = torch.exp(dl[..., None] * a)               # [B, T, dI, N]
            dbx = (dl * x1[:, t0:t0 + blk])[..., None] \
                * bm[:, t0:t0 + blk, None, :]
            for j in range(dl.shape[1]):
                h = da[:, j] * h + dbx[:, j]
                y[:, t0 + j] = (h * cm[:, t0 + j, None, :]).sum(-1)
        y = (y + p["D_skip"].float() * x1) * F.silu(z)
        state["h"] = h
        state["conv"] = pad[:, -(k - 1):] if k > 1 else pad[:, :0]
        return self.lin(y, p["out_proj"])

    def _mamba_step(self, x, p, state):
        """x [B, d] one position."""
        d = self.dims
        x1r, z = torch.chunk(self.lin(x, p["in_proj"]), 2, dim=-1)
        buf = torch.cat([state["conv"], x1r[:, None]], dim=1)
        w = p["conv_w"].float()
        x1 = F.silu(p["conv_b"].float()
                    + torch.einsum("bkd,dk->bd", buf, w))
        delta, bm, cm = self._ssm_inputs(x1, p)
        a = -torch.exp(p["A_log"].float())
        h = torch.exp(delta[..., None] * a) * state["h"] \
            + (delta * x1)[..., None] * bm[:, None, :]
        y = (h * cm[:, None, :]).sum(-1) + p["D_skip"].float() * x1
        state["h"], state["conv"] = h, buf[:, 1:]
        return self.lin(y * F.silu(z), p["out_proj"])

    # ------------------------------------------------------------- model
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.p["embed"][tokens.long()].float()

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., d] → logits [..., V]."""
        x = self.norm(x, self.p["final_norm"]["scale"])
        return self.lin(x, head_of(self.p, self.dims))

    @torch.no_grad()
    def prefill_layers(self, x: torch.Tensor, state: List[Dict]):
        """The held layers over x [B, S, d] from position 0; each layer's
        state appended to ``state``."""
        d = self.dims
        pos = torch.arange(x.shape[1], device=x.device)
        for i, lp in zip(self.span, self.layers):
            h = self.norm(x, lp["norm1"]["scale"])
            st: Dict = {}
            if d.kinds[i] == "attn":
                q, k, v = self._qkv(h, lp["attn"], pos)
                x = x + self._attn_out(self._attend(q, k, v, 0), lp["attn"])
                st["k"], st["v"] = k, v
            else:
                x = x + self._mamba_seq(h, lp["mamba"], st)
            if d.d_ff > 0:
                x = x + self.ffn(self.norm(x, lp["norm2"]["scale"]), lp)
            state.append(st)
        return x

    @torch.no_grad()
    def decode_layers(self, x: torch.Tensor, state: List[Dict], pos: int):
        """The held layers over x [B, d] at position ``pos``; ``state``
        advances in place."""
        d = self.dims
        at = torch.tensor([pos], device=x.device)
        for i, lp, st in zip(self.span, self.layers, state):
            h = self.norm(x, lp["norm1"]["scale"])
            if d.kinds[i] == "attn":
                q, k, v = self._qkv(h[:, None], lp["attn"], at)
                st["k"] = torch.cat([st["k"], k], dim=2)
                st["v"] = torch.cat([st["v"], v], dim=2)
                o = self._attend(q, st["k"], st["v"], pos)
                x = x + self._attn_out(o, lp["attn"])[:, 0]
            else:
                x = x + self._mamba_step(h, lp["mamba"], st)
            if d.d_ff > 0:
                x = x + self.ffn(self.norm(x, lp["norm2"]["scale"]), lp)
        return x

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor):
        """tokens [B, S] → (logits at the last position [B, V], state)."""
        state: List[Dict] = []
        x = self.prefill_layers(self.embed(tokens), state)
        return self.logits(x[:, -1]), state

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, state, pos: int):
        """tokens [B] at position ``pos`` → logits [B, V]; ``state``
        advances in place."""
        return self.logits(self.decode_layers(self.embed(tokens), state,
                                              pos))


def follow(model: Model, toks, served, s: int):
    """The model's logits [B, V] at every served position: the prefill's
    last, then each decode step fed every row's served token."""
    logits, st = model.prefill(toks)
    yield logits
    for t in range(1, served.shape[1]):
        yield model.decode(served[:, t - 1], st, s + t - 1)
