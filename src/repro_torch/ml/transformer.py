"""Unified LM: dense / MoE / SSM-hybrid from one ArchConfig.

The port of ``repro/ml/transformer.py``.  Layers form *pattern groups*: a
group is one cycle of ``block_pattern`` × ``attention_pattern`` (e.g.
Gemma-3's 5 local + 1 global, Jamba's 7 mamba + 1 attn).  Parameters and
caches keep the reference's layout, a leading [G] dim per cycle slot, so
the JAX package's parameters carry over one to one (``ml.params``); the
reference's ``lax.scan`` over groups becomes a Python loop.

Entry points:
  * ``hidden`` / ``apply`` — training forward → final hidden states or
                      logits [B, S, V] (float32), and aux losses
  * ``prefill``     — forward over a prompt, returns last-token logits +
                      filled caches (KV for attn, state for SSM)
  * ``decode_step`` — one token against caches, updated in place

``impl`` picks the full-sequence paths, as the reference's ``LM(impl=)``
does: ``"kernel"`` (the default, what ``launch.serve`` runs) sends
attention to ``kops.flash_attention`` and the Mamba chunks to
``kops.ssm_scan`` — the CUDA kernels on the card, which have no backward
and raise under grad there; ``"reference"`` runs the plain, differentiable
``attention.chunked_attention`` and the associative Mamba scan, the path
``ml.model.ModelBundle`` trains through.  The kernel wrappers still pick
kernel or plain version by the device of their inputs.

``remat`` ("none" | "dots" | "full") wraps each block in
``torch.utils.checkpoint``: "full" saves only the block's input and
recomputes the rest in backward; "dots" also saves every matrix product's
output (selective checkpointing of ``aten.mm``/``bmm``, the reference's
``dots_saveable``).  The reference also checkpoints each layer group
around its blocks; the port checkpoints the blocks only.  Gradients do
not change with ``remat``.

Not ported yet (ROADMAP A11): the xLSTM blocks (``mlstm``/``slstm``) and
the Whisper encoder; an ``LM`` of such a config raises.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from . import attention as A
from . import mamba as Mb
from .layers import (dense_init, embed_init, layer_norm, mlp_apply,
                     mlp_init, norm_init, rms_norm)
from .moe import moe_apply, moe_init
from .params import act_dtype, cast_params, tree_map

__all__ = ["LM", "cycle_len"]

IMPLS = ("kernel", "reference")
REMATS = ("none", "dots", "full")

#: the matrix products "dots" keeps through a block's checkpoint
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def cycle_len(cfg: ArchConfig) -> int:
    a, b = len(cfg.block_pattern), len(cfg.attention_pattern)
    return a * b // math.gcd(a, b)


def _norm(cfg):
    return rms_norm if cfg.norm == "rmsnorm" else layer_norm


def _slot_info(cfg: ArchConfig, slot: int, *, decoder: bool = True):
    kind = cfg.block_pattern[slot % len(cfg.block_pattern)]
    attn_kind = cfg.attention_pattern[slot % len(cfg.attention_pattern)]
    window = cfg.window if attn_kind == "local" else None
    spec = A.AttnSpec(cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                      qkv_bias=cfg.qkv_bias, window=window,
                      softcap=cfg.logit_softcap,
                      rope_theta=cfg.rope_theta, mrope=cfg.mrope,
                      causal=decoder)
    is_moe = cfg.layer_is_moe(slot)
    return kind, spec, is_moe, window


def _index(tree, g: int):
    """Group ``g``'s slice (views) of a [G, ...]-stacked tree."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ---------------------------------------------------------------- init

def _block_init(gen: torch.Generator, cfg: ArchConfig, slot: int,
                dtype: Optional[torch.dtype] = None):
    kind, spec, is_moe, _ = _slot_info(cfg, slot)
    dev = gen.device
    p: Dict[str, Any] = {"norm1": norm_init(cfg.d_model, dev)}
    if cfg.norm == "layernorm":
        p["norm1"]["bias"] = torch.zeros((cfg.d_model,), device=dev)
    if kind == "attn":
        p["attn"] = A.attn_init(gen, spec)
    elif kind == "mamba":
        p["mamba"] = Mb.mamba_init(gen, cfg.d_model, expand=cfg.ssm_expand,
                                   state=cfg.ssm_state, conv=cfg.ssm_conv)
    else:
        raise ValueError(kind)
    if cfg.d_ff > 0:
        p["norm2"] = norm_init(cfg.d_model, dev)
        if cfg.norm == "layernorm":
            p["norm2"]["bias"] = torch.zeros((cfg.d_model,), device=dev)
        if is_moe:
            p["moe"] = moe_init(gen, cfg.d_model, cfg.d_ff, cfg.moe_experts)
        else:
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff,
                                gated=(cfg.act == "silu"))
    return _cast(cfg, p, dtype)


def _cast(cfg: ArchConfig, tree, dtype: Optional[torch.dtype]):
    """Every leaf to its storage dtype (``dtype=None``), or to ``dtype``."""
    if dtype is None:
        return cast_params(cfg, tree)
    return tree_map(lambda t, _: t.to(dtype), tree)


# ---------------------------------------------------------------- apply

def _positions_for(cfg: ArchConfig, b: int, s: int, offset: int = 0,
                   device=None):
    pos = torch.arange(s, dtype=torch.int32, device=device)[None, :] \
        + offset
    pos = pos.expand(b, s)
    if cfg.mrope:
        return pos[None].expand(3, b, s)
    return pos


def _mlp_tail(cfg: ArchConfig, x, p):
    if "mlp" not in p and "moe" not in p:
        return x, None
    h2 = _norm(cfg)(x, p["norm2"], cfg.norm_eps)
    if "moe" in p:
        mo, aux = moe_apply(h2, p["moe"], top_k=cfg.moe_top_k,
                            capacity_factor=cfg.moe_capacity_factor,
                            act=cfg.act, group_size=cfg.moe_group_size)
        return x + mo, aux
    return x + mlp_apply(h2, p["mlp"], cfg.act), None


def _block_apply(cfg: ArchConfig, slot: int, x, p, positions, *,
                 impl: str = "kernel", return_state: bool = False):
    """Full-sequence forward for one layer.

    Returns (x, aux, extras): extras is {k, v} for attn layers or the
    final recurrent state for Mamba layers (when ``return_state``),
    feeding prefill cache construction.
    """
    kind, spec, _, _ = _slot_info(cfg, slot)
    in_dtype = x.dtype
    h = _norm(cfg)(x, p["norm1"], cfg.norm_eps)
    extras = None
    if kind == "attn":
        rope_pos = positions if cfg.pos == "rope" else None
        q, k, v = A._project_qkv(h, p["attn"], spec, rope_pos)
        out = A._attention(q, k, v, causal=spec.causal, window=spec.window,
                           softcap=spec.softcap, scale=None, impl=impl)
        b_, s_ = h.shape[0], h.shape[1]
        out = out.transpose(1, 2).reshape(b_, s_, -1)
        x = x + out @ p["attn"]["wo"].to(out.dtype)
        extras = {"k": k, "v": v}
    else:
        if return_state:
            y, extras = Mb.mamba_apply(h, p["mamba"], return_state=True,
                                       impl=impl)
        else:
            y = Mb.mamba_apply(h, p["mamba"], impl=impl)
        x = x + y
    x, aux = _mlp_tail(cfg, x, p)
    if aux is None:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = {"load_balance": zero, "router_z": zero}
    return x.to(in_dtype), aux, extras


def _block_decode(cfg: ArchConfig, slot: int, x, p, cache, pos: int):
    """Single-token step; writes the new position or state into ``cache``
    (views of the stacked caches) in place and returns x."""
    kind, spec, _, window = _slot_info(cfg, slot)
    in_dtype = x.dtype
    h = _norm(cfg)(x, p["norm1"], cfg.norm_eps)
    if kind == "attn":
        b = x.shape[0]
        rolling = window is not None
        positions = None
        if cfg.pos == "rope":
            positions = _positions_for(cfg, b, 1, pos, x.device)
        q, k, v = A._project_qkv(h, p["attn"], spec, positions)
        smax = cache["k"].shape[2]
        slot_pos = pos % smax if rolling else pos
        cache["k"][:, :, slot_pos] = k[:, :, 0].to(cache["k"].dtype)
        cache["v"][:, :, slot_pos] = v[:, :, 0].to(cache["v"].dtype)
        out = A.decode_attention(
            q, {"k": cache["k"], "v": cache["v"], "len": pos + 1},
            window=window, softcap=spec.softcap, rolling=rolling)
        out = out.transpose(1, 2).reshape(b, 1, -1)
        x = x + out @ p["attn"]["wo"].to(out.dtype)
    else:
        y, new = Mb.mamba_decode(h, p["mamba"], cache)
        cache["h"].copy_(new["h"])
        cache["conv"].copy_(new["conv"])
        x = x + y
    x, _ = _mlp_tail(cfg, x, p)
    return x.to(in_dtype)


# ---------------------------------------------------------------- model

class LM:
    def __init__(self, cfg: ArchConfig, *, impl: str = "kernel",
                 remat: str = "none"):
        kinds = set(cfg.block_pattern)
        if kinds & {"mlstm", "slstm"}:
            raise NotImplementedError(
                f"{cfg.name}: the xLSTM blocks (mlstm/slstm) are not "
                "ported yet (ROADMAP A11)")
        if cfg.encoder_layers > 0 or cfg.pos == "learned":
            raise NotImplementedError(
                f"{cfg.name}: the Whisper encoder and learned positions "
                "are not ported yet (ROADMAP A11)")
        if not kinds <= {"attn", "mamba"}:
            raise ValueError(f"{cfg.name}: unknown block kinds {kinds}")
        if impl not in IMPLS:
            raise ValueError(f"impl {impl!r}: expected one of {IMPLS}")
        if remat not in REMATS:
            raise ValueError(f"remat {remat!r}: expected one of {REMATS}")
        self.cfg = cfg
        self.impl = impl
        self.remat = remat
        self.cyc = cycle_len(cfg)
        if cfg.num_layers % self.cyc:
            raise ValueError(f"{cfg.name}: layers {cfg.num_layers} not "
                             f"divisible by pattern cycle {self.cyc}")
        self.groups = cfg.num_layers // self.cyc

    # ------------------------------------------------------------- init
    def init(self, seed: int = 0, device="cuda",
             dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """Seeded random parameters on ``device``, each weight in its
        storage dtype (``ml.params``) — or every leaf in ``dtype``
        (``torch.float32`` for training)."""
        cfg = self.cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        p: Dict[str, Any] = {"embed": embed_init(gen, cfg.vocab_size,
                                                 cfg.d_model)}
        p["blocks"] = {f"slot{s}": _stack([_block_init(gen, cfg, s, dtype)
                                           for _ in range(self.groups)])
                       for s in range(self.cyc)}
        p["final_norm"] = norm_init(cfg.d_model, gen.device)
        if cfg.norm == "layernorm":
            p["final_norm"]["bias"] = torch.zeros((cfg.d_model,),
                                                  device=gen.device)
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size)
        return _cast(cfg, p, dtype)

    # --------------------------------------------------------- helpers
    def _embed(self, p, tokens):
        return p["embed"][tokens.long()].to(act_dtype(self.cfg))

    def head(self, p):
        return p["embed"].T if self.cfg.tie_embeddings else p["lm_head"]

    def _logits(self, p, x):
        """Float32 logits of x against the head rounded to x's dtype (the
        reference's ``dot_general`` with float32 accumulation)."""
        return x.float() @ self.head(p).to(x.dtype).float()

    # ------------------------------------------------------------ apply
    def _block(self, sl: int, x, gp, positions):
        """One block of the training forward, under ``remat``'s
        checkpoint → (x, load-balance loss, router z-loss)."""
        def one(x):
            y, aux, _ = _block_apply(self.cfg, sl, x, gp, positions,
                                     impl=self.impl)
            return y, aux["load_balance"], aux["router_z"]

        if self.remat == "none":
            return one(x)
        kw = {}
        if self.remat == "dots":
            kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                       _save_dots)
        return checkpoint(one, x, use_reentrant=False, **kw)

    def hidden(self, p, tokens, positions=None):
        """Forward up to the final norm → (hidden, aux dict)."""
        cfg = self.cfg
        b, s = tokens.shape
        if positions is None:
            positions = _positions_for(cfg, b, s, device=tokens.device)
        x = self._embed(p, tokens)
        lb = torch.zeros((), dtype=torch.float32, device=x.device)
        rz = torch.zeros((), dtype=torch.float32, device=x.device)
        for g in range(self.groups):
            grp = _index(p["blocks"], g)
            for sl in range(self.cyc):
                x, lb_, rz_ = self._block(sl, x, grp[f"slot{sl}"],
                                          positions)
                lb = lb + lb_
                rz = rz + rz_
        x = _norm(cfg)(x, p["final_norm"], cfg.norm_eps)
        return x, {"load_balance": lb, "router_z": rz}

    def apply(self, p, tokens, positions=None):
        """Forward → (logits [B,S,V] float32, aux dict)."""
        x, aux = self.hidden(p, tokens, positions)
        return self._logits(p, x), aux

    # ---------------------------------------------------------- serving
    def init_caches(self, batch: int, max_len: int, device="cuda"):
        """Stacked per-slot caches [G, ...] on ``device`` (the card unless
        the caller asks for the CPU, as :meth:`init`)."""
        cfg = self.cfg
        g = self.groups
        caches = {}
        for s in range(self.cyc):
            kind, _, _, window = _slot_info(cfg, s)
            if kind == "attn":
                size = min(window, max_len) if window else max_len
                shape = (g, batch, cfg.num_kv_heads, size, cfg.hd)
                c = {"k": torch.zeros(shape, dtype=torch.bfloat16,
                                      device=device),
                     "v": torch.zeros(shape, dtype=torch.bfloat16,
                                      device=device)}
            else:
                di = cfg.ssm_expand * cfg.d_model
                c = {"h": torch.zeros((g, batch, di, cfg.ssm_state),
                                      device=device),
                     "conv": torch.zeros((g, batch, cfg.ssm_conv - 1, di),
                                         device=device)}
            caches[f"slot{s}"] = c
        return caches

    def decode_step(self, p, tokens, caches, pos: int):
        """tokens [B, 1], caches (stacked), pos int → (logits [B, 1, V],
        caches).  The caches are updated in place and returned."""
        cfg = self.cfg
        x = self._embed(p, tokens)
        for g in range(self.groups):
            grp = _index(p["blocks"], g)
            for sl in range(self.cyc):
                key = f"slot{sl}"
                x = _block_decode(cfg, sl, x, grp[key],
                                  _index(caches[key], g), pos)
        x = _norm(cfg)(x, p["final_norm"], cfg.norm_eps)
        return self._logits(p, x[:, -1:, :]), caches

    def prefill(self, p, tokens):
        """Prompt forward → (last-token logits [B, 1, V], filled
        caches)."""
        cfg = self.cfg
        b, s = tokens.shape
        positions = _positions_for(cfg, b, s, device=tokens.device)
        x = self._embed(p, tokens)
        extras = {f"slot{sl}": [] for sl in range(self.cyc)}
        for g in range(self.groups):
            grp = _index(p["blocks"], g)
            for sl in range(self.cyc):
                x, _, ex = _block_apply(cfg, sl, x, grp[f"slot{sl}"],
                                        positions, impl=self.impl,
                                        return_state=True)
                extras[f"slot{sl}"].append(ex)
        x = _norm(cfg)(x, p["final_norm"], cfg.norm_eps)
        logits = self._logits(p, x[:, -1:, :])
        return logits, self._caches_from_prefill(extras, s, b, x.device)

    def _caches_from_prefill(self, extras, s: int, b: int, device,
                             decode_budget: int = 1024):
        """Per-group extras → decode caches for ``decode_budget`` more
        tokens.

        Rolling (windowed) caches are laid out so that slot == abs_pos %
        window, matching the modulo writes of ``decode_step``.
        """
        cfg = self.cfg
        caches = self.init_caches(b, s + decode_budget, device)
        for sl in range(self.cyc):
            key = f"slot{sl}"
            kind, _, _, window = _slot_info(cfg, sl)
            for g, ex in enumerate(extras[key]):
                if kind == "attn":
                    k, v = ex["k"], ex["v"]          # [B, Hkv, S, hd]
                    if window and s >= window:
                        shift = s % window
                        k = torch.roll(k[:, :, s - window:s], shift, dims=2)
                        v = torch.roll(v[:, :, s - window:s], shift, dims=2)
                    n = k.shape[2]
                    caches[key]["k"][g, :, :, :n] = k.to(torch.bfloat16)
                    caches[key]["v"][g, :, :, :n] = v.to(torch.bfloat16)
                else:
                    caches[key]["h"][g] = ex["h"]
                    caches[key]["conv"][g] = ex["conv"]
        return caches
