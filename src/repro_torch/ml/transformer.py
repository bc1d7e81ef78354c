"""Unified LM: dense / MoE / SSM / hybrid / enc-dec from one ArchConfig.

The port of ``repro/ml/transformer.py``.  Layers form *pattern groups*: a
group is one cycle of ``block_pattern`` × ``attention_pattern`` (e.g.
Gemma-3's 5 local + 1 global, Jamba's 7 mamba + 1 attn).  Parameters and
caches keep the reference's layout, a leading [G] dim per cycle slot, so
the JAX package's parameters carry over one to one (``ml.params``); the
reference's ``lax.scan`` over groups becomes a Python loop.

Entry points:
  * ``hidden`` / ``apply`` — training forward → final hidden states or
                      logits [B, S, V] (float32), and aux losses
  * ``encode``      — the Whisper encoder over frame embeddings [B, Se, D]
  * ``prefill``     — forward over a prompt, returns last-token logits +
                      filled caches (KV for attn, cross KV for enc-dec,
                      state for Mamba and xLSTM)
  * ``decode_step`` — one token against caches, updated in place

Block kinds: ``attn``, ``mamba``, and xLSTM's ``mlstm`` / ``slstm``
(``ml/xlstm.py``, plain PyTorch on every path, as the reference's are
plain jnp).  An encoder-decoder config (``encoder_layers > 0``, Whisper)
runs ``encode`` first; its decoder's attention blocks cross-attend to the
encoder's output (non-causal, through ``kops.flash_attention`` on the
kernel path) and its cross K/V go into the decode caches.  The conv front
end is a stub in the reference too: ``frames`` are embeddings.

``impl`` picks the full-sequence paths, as the reference's ``LM(impl=)``
does: ``"kernel"`` (the default, what ``launch.serve`` runs) sends
attention to ``kops.flash_attention`` and each Mamba layer's scan to
``kops.selective_scan`` — the CUDA kernels on the card, which have no
backward and raise under grad there; ``"reference"`` runs the plain,
differentiable ``attention.chunked_attention`` and the associative Mamba
scan, the path ``ml.model.ModelBundle`` trains through.  The kernel
wrappers still pick kernel or plain version by the device of their
inputs.

``remat`` ("none" | "dots" | "full") wraps each block in
``torch.utils.checkpoint``: "full" saves only the block's input and
recomputes the rest in backward; "dots" also saves every matrix product's
output (selective checkpointing of ``aten.mm``/``bmm``, the reference's
``dots_saveable``).  The reference also checkpoints each layer group
around its blocks; the port checkpoints the blocks only.  Gradients do
not change with ``remat``.

``mesh`` (a ``DeviceMesh`` with ``data``/``model`` dims, as
``ml.model.ModelBundle`` passes it) runs the same code on DTensor
parameters and batches: with ``seq_parallel`` the activations between
block groups shard [batch → (pod, data), seq → model] (the reference's
``_seq_constraint``; whole again at each block's entry and before the
head), and ``gather``, when the bundle sets it (FSDP),
brings each block's parameters to their model-axis placements inside
the block's checkpoint — the per-layer gather.  With ``impl="kernel"``
the prefill reaches the kernels on each rank's pieces (``attention``,
``mamba``); the caches are filled and written in their own placements.

While tracing is active (``repro_torch.tracing``) ``prefill`` and
``decode_step`` record a span each, and every block two inside it: its
mixer half (norm, mixer, residual) named by its kind, and its tail
(norm, MLP or MoE, residual) named ``mlp`` or ``moe``.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import tracing
from ..configs.base import ArchConfig
from . import attention as A
from . import mamba as Mb
from . import xlstm as X
from .layers import (dense_init, embed_init, layer_norm, mlp_apply,
                     mlp_init, norm_init, rms_norm)
from .moe import moe_apply, moe_init
from .params import act_dtype, cast_params, tree_map
from .sharding import constrain, is_dtensor, mesh_sizes, place_caches

__all__ = ["LM", "cycle_len"]

IMPLS = ("kernel", "reference")
KINDS = ("attn", "mamba", "mlstm", "slstm")
#: rows of the learned position table (``pos="learned"``)
MAX_LEARNED_POS = 32768
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


def _rows(table, ids):
    """``table[ids]``.  A DTensor table is gathered whole along its rows
    (the vocab's model-axis cut) and looked up with ``F.embedding``: the
    backward of an index into a DTensor (``index_put``) and the
    vocab-parallel lookup's masked partial sum have no sharding rules
    that hold in every torch version."""
    if not is_dtensor(table):
        return table[ids.long()]
    from torch.distributed.tensor import Replicate
    whole = table.redistribute(table.device_mesh, [
        Replicate() if p.is_shard(0) else p for p in table.placements])
    return torch.nn.functional.embedding(ids.long(), whole)


def _pad_seq(t, cache):
    """``t`` [B, H, n, hd] in the cache's dtype, zero-padded along the
    sequence to the cache's length: a whole group of the cache (a slice
    write along a sequence cut over the mesh would land on each rank's
    own piece; the padding is a cat, as in ``mamba._causal_conv``)."""
    t = t.to(cache.dtype)
    pad = cache.shape[3] - t.shape[2]
    if pad == 0:
        return t
    return torch.cat([t, torch.zeros_like(t[:, :, :1]).expand(
        -1, -1, pad, -1)], dim=2)


def _copy_into(dst, src):
    """``dst.copy_(src)``, a DTensor ``src`` first brought to ``dst``'s
    placements: some torch versions copy the local pieces of unlike
    placements as they are."""
    if is_dtensor(dst) and is_dtensor(src) \
            and src.placements != dst.placements:
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


def _write_pos(cache, t, pos: int):
    """``cache[:, :, pos] = t[:, :, 0]`` in place (cache [B, H, S, hd]).
    A DTensor cache whose sequence is cut over the mesh is written by a
    masked blend: an index write along the cut would land on each rank's
    own piece."""
    new = t.to(cache.dtype)
    if is_dtensor(cache) and any(p.is_shard(2) for p in cache.placements):
        hit = torch.arange(cache.shape[2], device=new.device)[:, None] == pos
        _copy_into(cache, torch.where(hit, new, cache))
    else:
        cache[:, :, pos] = new[:, :, 0]


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ---------------------------------------------------------------- init

def _block_init(gen: torch.Generator, cfg: ArchConfig, slot: int,
                dtype: Optional[torch.dtype] = None, *, cross: bool = False,
                decoder: bool = True):
    kind, spec, is_moe, _ = _slot_info(cfg, slot, decoder=decoder)
    dev = gen.device
    p: Dict[str, Any] = {"norm1": norm_init(cfg.d_model, dev)}
    if cfg.norm == "layernorm":
        p["norm1"]["bias"] = torch.zeros((cfg.d_model,), device=dev)
    if kind == "attn":
        p["attn"] = A.attn_init(gen, spec)
    elif kind == "mamba":
        p["mamba"] = Mb.mamba_init(gen, cfg.d_model, expand=cfg.ssm_expand,
                                   state=cfg.ssm_state, conv=cfg.ssm_conv)
    elif kind == "mlstm":
        p["cell"] = X.mlstm_init(gen, cfg.d_model, cfg.num_heads)
    elif kind == "slstm":
        p["cell"] = X.slstm_init(gen, cfg.d_model, cfg.num_heads)
    else:
        raise ValueError(kind)
    if cross and kind == "attn":
        # no bias on the cross-attention norm, as in the reference
        p["normx"] = norm_init(cfg.d_model, dev)
        p["xattn"] = A.attn_init(gen, spec)
    if cfg.d_ff > 0 and kind in ("attn", "mamba"):
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


def _whole_seq(h):
    """A block's normed input with its sequence whole on every rank (the
    batch over the batch axes): DTensor may sum a partial residual into a
    sequence cut over ``model``, and a product over [B, S] flattened with
    S cut is a strided cut that its propagation cannot always follow.
    Megatron's all-gather before the column-parallel products; a plain
    tensor as it is."""
    return constrain(h, ("batch", None, None))


def _mlp_tail(cfg: ArchConfig, x, p):
    """A block's tail (norm, MLP or MoE, residual), in a span of its
    kind."""
    if "mlp" not in p and "moe" not in p:
        return x, None
    with tracing.span("moe" if "moe" in p else "mlp", x.device):
        h2 = _whole_seq(_norm(cfg)(x, p["norm2"], cfg.norm_eps))
        if "moe" in p:
            mo, aux = moe_apply(h2, p["moe"], top_k=cfg.moe_top_k,
                                capacity_factor=cfg.moe_capacity_factor,
                                act=cfg.act, group_size=cfg.moe_group_size)
            return x + mo, aux
        return x + mlp_apply(h2, p["mlp"], cfg.act), None


def _project_cross_kv(enc_out, p_attn, spec):
    """Project encoder states with a block's wk/wv → [B, Hkv, Se, hd]
    (views; ``_attention`` makes them contiguous for the kernel)."""
    return tuple(A.split_heads(enc_out @ p_attn[w].to(enc_out.dtype),
                               spec.num_kv_heads, spec.head_dim)
                 for w in ("wk", "wv"))


def _block_apply(cfg: ArchConfig, slot: int, x, p, positions, *,
                 enc_out=None, impl: str = "kernel", decoder: bool = True,
                 return_state: bool = False):
    """Full-sequence forward for one layer (an encoder layer when not
    ``decoder``: non-causal).

    Returns (x, aux, extras): extras is {k, v[, cross_k, cross_v]} for
    attn layers or the final recurrent state for Mamba and xLSTM layers
    (when ``return_state``), feeding prefill cache construction.
    """
    kind, spec, _, _ = _slot_info(cfg, slot, decoder=decoder)
    in_dtype = x.dtype
    with tracing.span(kind, x.device):
        x, extras = _mixer_apply(cfg, kind, spec, x, p, positions, enc_out,
                                 impl, return_state)
    x, aux = _mlp_tail(cfg, x, p)
    if aux is None:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = {"load_balance": zero, "router_z": zero}
    return x.to(in_dtype), aux, extras


def _mixer_apply(cfg: ArchConfig, kind: str, spec, x, p, positions,
                 enc_out, impl: str, return_state: bool):
    """A block's mixer half over the full sequence (norm, mixer,
    residual) → (x, extras)."""
    nrm = _norm(cfg)
    h = _whole_seq(nrm(x, p["norm1"], cfg.norm_eps))
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
        if enc_out is not None and "xattn" in p:
            hx = _whole_seq(nrm(x, p["normx"], cfg.norm_eps))
            qx, _, _ = A._project_qkv(hx, p["xattn"], spec, None)
            kx, vx = _project_cross_kv(enc_out, p["xattn"], spec)
            xo = A._attention(qx, kx, vx, causal=False, window=None,
                              softcap=None, scale=None, impl=impl)
            xo = xo.transpose(1, 2).reshape(b_, s_, -1)
            x = x + xo @ p["xattn"]["wo"].to(xo.dtype)
            extras["cross_k"], extras["cross_v"] = kx, vx
    elif kind == "mamba":
        if return_state:
            y, extras = Mb.mamba_apply(h, p["mamba"], chunk=cfg.ssm_chunk,
                                       return_state=True, impl=impl)
        else:
            y = Mb.mamba_apply(h, p["mamba"], chunk=cfg.ssm_chunk, impl=impl)
        x = x + y
    else:
        cell = partial(X.mlstm_apply, chunk=cfg.ssm_chunk) \
            if kind == "mlstm" else X.slstm_apply
        if return_state:
            y, extras = cell(h, p["cell"], cfg.num_heads, return_state=True)
        else:
            y = cell(h, p["cell"], cfg.num_heads)
        x = x + y
    return x, extras


def _block_decode(cfg: ArchConfig, slot: int, x, p, cache, pos: int):
    """Single-token step; writes the new position or state into ``cache``
    (views of the stacked caches) in place and returns x."""
    kind, spec, _, window = _slot_info(cfg, slot)
    in_dtype = x.dtype
    with tracing.span(kind, x.device):
        x = _mixer_decode(cfg, kind, spec, window, x, p, cache, pos)
    x, _ = _mlp_tail(cfg, x, p)
    return x.to(in_dtype)


def _mixer_decode(cfg: ArchConfig, kind: str, spec, window, x, p, cache,
                  pos: int):
    """A block's mixer half for one token (norm, mixer, residual),
    writing the cache in place → x."""
    nrm = _norm(cfg)
    h = nrm(x, p["norm1"], cfg.norm_eps)
    if kind == "attn":
        b = x.shape[0]
        rolling = window is not None
        positions = None
        if cfg.pos == "rope":
            positions = _positions_for(cfg, b, 1, pos, x.device)
        q, k, v = A._project_qkv(h, p["attn"], spec, positions)
        smax = cache["k"].shape[2]
        slot_pos = pos % smax if rolling else pos
        _write_pos(cache["k"], k, slot_pos)
        _write_pos(cache["v"], v, slot_pos)
        out = A.decode_attention(
            q, {"k": cache["k"], "v": cache["v"], "len": pos + 1},
            window=window, softcap=spec.softcap, rolling=rolling)
        out = out.transpose(1, 2).reshape(b, 1, -1)
        x = x + out @ p["attn"]["wo"].to(out.dtype)
        if "cross_k" in cache and "xattn" in p:
            hx = nrm(x, p["normx"], cfg.norm_eps)
            qx, _, _ = A._project_qkv(hx, p["xattn"], spec, None)
            xo = A.decode_attention(
                qx, {"k": cache["cross_k"], "v": cache["cross_v"],
                     "len": cache["cross_k"].shape[2]})
            xo = xo.transpose(1, 2).reshape(b, 1, -1)
            x = x + xo @ p["xattn"]["wo"].to(xo.dtype)
    else:
        if kind == "mamba":
            y, new = Mb.mamba_decode(h, p["mamba"], cache)
        else:
            cell = X.mlstm_decode if kind == "mlstm" else X.slstm_decode
            y, new = cell(h, p["cell"], cfg.num_heads, cache)
        for name, t in new.items():
            _copy_into(cache[name], t)
        x = x + y
    return x


# ---------------------------------------------------------------- model

class LM:
    def __init__(self, cfg: ArchConfig, *, impl: str = "kernel",
                 remat: str = "none", mesh=None, seq_parallel: bool = True):
        kinds = set(cfg.block_pattern)
        if not kinds <= set(KINDS):
            raise ValueError(f"{cfg.name}: unknown block kinds "
                             f"{sorted(kinds - set(KINDS))}")
        if impl not in IMPLS:
            raise ValueError(f"impl {impl!r}: expected one of {IMPLS}")
        if remat not in REMATS:
            raise ValueError(f"remat {remat!r}: expected one of {REMATS}")
        self.cfg = cfg
        self.impl = impl
        self.remat = remat
        self.mesh = mesh            # enables the sequence-parallel pin
        self.seq_parallel = seq_parallel
        #: ``gather(path, tree)`` → the tree at its use placements (FSDP's
        #: per-layer gather); None leaves parameters as stored
        self.gather = None
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
        dev = gen.device
        p: Dict[str, Any] = {"embed": embed_init(gen, cfg.vocab_size,
                                                 cfg.d_model)}
        if cfg.pos == "learned":
            p["pos_embed"] = torch.randn((MAX_LEARNED_POS, cfg.d_model),
                                         generator=gen, device=dev) * 0.02
        cross = cfg.encoder_layers > 0
        p["blocks"] = {f"slot{s}": _stack([_block_init(gen, cfg, s, dtype,
                                                       cross=cross)
                                           for _ in range(self.groups)])
                       for s in range(self.cyc)}
        if cross:
            p["enc_blocks"] = _stack([_block_init(gen, cfg, 0, dtype,
                                                  decoder=False)
                                      for _ in range(cfg.encoder_layers)])
            p["enc_norm"] = norm_init(cfg.d_model, dev)
            p["enc_in"] = dense_init(gen, cfg.d_model, cfg.d_model)
        p["final_norm"] = norm_init(cfg.d_model, dev)
        if cfg.norm == "layernorm":
            p["final_norm"]["bias"] = torch.zeros((cfg.d_model,), device=dev)
            if cross:
                p["enc_norm"]["bias"] = torch.zeros((cfg.d_model,),
                                                    device=dev)
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size)
        return _cast(cfg, p, dtype)

    # --------------------------------------------------------- helpers
    def _use(self, path, tree):
        """A parameter (sub)tree where it is used: gathered by
        :attr:`gather` when the bundle set one (FSDP), else as stored."""
        return tree if self.gather is None else self.gather(path, tree)

    def _embed(self, p, tokens, positions):
        cfg = self.cfg
        adt = act_dtype(cfg)
        x = _rows(self._use(("embed",), p["embed"]), tokens).to(adt)
        if cfg.pos == "learned":
            pos = positions if positions.dim() == 2 else positions[0]
            x = x + _rows(self._use(("pos_embed",), p["pos_embed"]),
                          pos).to(adt)
        return x

    def head(self, p):
        if self.cfg.tie_embeddings:
            return self._use(("embed",), p["embed"]).T
        return self._use(("lm_head",), p["lm_head"])

    def _seq_on(self) -> bool:
        return self.mesh is not None and self.seq_parallel \
            and "model" in mesh_sizes(self.mesh)

    def _seq_constraint(self, x):
        """Sequence-parallel activation pin between block groups: [batch →
        (pod, data), seq → model], each axis only where it divides."""
        return constrain(x, ("batch", "model", None)) if self._seq_on() \
            else x

    def _seq_gather(self, x):
        """Activations with their sequence whole again (the all-gather
        GSPMD puts before a product, Megatron's sequence parallelism): at
        a block's entry inside its checkpoint, so that what the checkpoint
        saves stays cut over ``model``, and before the LM head."""
        return constrain(x, ("batch", None, None)) if self._seq_on() else x

    def _logits(self, p, x):
        """Float32 logits of x against the head rounded to x's dtype (the
        reference's ``dot_general`` with float32 accumulation)."""
        return x.float() @ self.head(p).to(x.dtype).float()

    def _enc_out(self, p, frames):
        """The encoder's output for an encoder-decoder config, else
        None."""
        if self.cfg.encoder_layers == 0:
            return None
        if frames is None:
            raise ValueError(f"{self.cfg.name} needs frame embeddings")
        return self.encode(p, frames)

    # ------------------------------------------------------------ apply
    def _block(self, sl: int, x, gp, positions, enc_out):
        """One block of the training forward, under ``remat``'s
        checkpoint → (x, load-balance loss, router z-loss)."""
        def one(x):
            y, aux, _ = _block_apply(self.cfg, sl, self._seq_gather(x),
                                     self._use(("blocks", f"slot{sl}"), gp),
                                     positions, enc_out=enc_out,
                                     impl=self.impl)
            return y, aux["load_balance"], aux["router_z"]

        if self.remat == "none":
            return one(x)
        kw = {}
        if self.remat == "dots":
            kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                       _save_dots)
        return checkpoint(one, x, use_reentrant=False, **kw)

    def hidden(self, p, tokens, positions=None, frames=None):
        """Forward up to the final norm → (hidden, aux dict).  An
        encoder-decoder config needs ``frames`` [B, Se, D]."""
        cfg = self.cfg
        b, s = tokens.shape
        if positions is None:
            positions = _positions_for(cfg, b, s, device=tokens.device)
        x = self._embed(p, tokens, positions)
        enc_out = self._enc_out(p, frames)
        lb = torch.zeros((), dtype=torch.float32, device=x.device)
        rz = torch.zeros((), dtype=torch.float32, device=x.device)
        for g in range(self.groups):
            grp = _index(p["blocks"], g)
            for sl in range(self.cyc):
                x, lb_, rz_ = self._block(sl, x, grp[f"slot{sl}"],
                                          positions, enc_out)
                lb = lb + lb_
                rz = rz + rz_
            x = self._seq_constraint(x)
        x = _norm(cfg)(x, self._use(("final_norm",), p["final_norm"]),
                       cfg.norm_eps)
        # the head's product takes whole sequences, as each block's does
        # (with or without sequence parallelism: a residual's partial sum
        # may have been scattered along them)
        return _whole_seq(x), {"load_balance": lb, "router_z": rz}

    def apply(self, p, tokens, positions=None, frames=None):
        """Forward → (logits [B,S,V] float32, aux dict)."""
        x, aux = self.hidden(p, tokens, positions, frames)
        return self._logits(p, x), aux

    def encode(self, p, frames):
        """The Whisper encoder over precomputed frame embeddings [B, Se,
        D] → [B, Se, D]: ``enc_in``, the learned positions added in bf16
        whatever the activation dtype (as the reference adds them), the
        encoder layers (non-causal), ``enc_norm``."""
        cfg = self.cfg
        adt = act_dtype(cfg)
        x = frames.to(adt) @ self._use(("enc_in",), p["enc_in"]).to(adt)
        b, s, _ = x.shape
        positions = _positions_for(cfg, b, s, device=x.device)
        if cfg.pos == "learned":
            x = x + self._use(("pos_embed",),
                              p["pos_embed"])[:s].to(torch.bfloat16)
        for e in range(cfg.encoder_layers):
            blk = self._use(("enc_blocks",), _index(p["enc_blocks"], e))
            x, _, _ = _block_apply(cfg, 0, x, blk, positions,
                                   impl=self.impl, decoder=False)
        return _whole_seq(_norm(cfg)(x, self._use(("enc_norm",),
                                                  p["enc_norm"]),
                                     cfg.norm_eps))

    # ---------------------------------------------------------- serving
    def init_caches(self, batch: int, max_len: int, device="cuda",
                    enc_len: Optional[int] = None):
        """Stacked per-slot caches [G, ...] on ``device`` (the card unless
        the caller asks for the CPU, as :meth:`init`); an encoder-decoder
        config's attention slots also hold cross K/V for ``enc_len``
        encoder positions (``max_len`` if not given).  On a mesh they are
        DTensors laid out by ``ml.sharding.cache_spec_leaf``."""
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
                if cfg.encoder_layers > 0:
                    xshape = (g, batch, cfg.num_kv_heads, enc_len or max_len,
                              cfg.hd)
                    for name in ("cross_k", "cross_v"):
                        c[name] = torch.zeros(xshape, dtype=torch.bfloat16,
                                              device=device)
            elif kind == "mamba":
                di = cfg.ssm_expand * cfg.d_model
                c = {"h": torch.zeros((g, batch, di, cfg.ssm_state),
                                      device=device),
                     "conv": torch.zeros((g, batch, cfg.ssm_conv - 1, di),
                                         device=device)}
            elif kind == "mlstm":     # mlstm_init's projection factor, 2
                dh = 2 * cfg.d_model // cfg.num_heads
                lead = (g, batch, cfg.num_heads)
                c = {"C": torch.zeros((*lead, dh, dh), device=device),
                     "n": torch.zeros((*lead, dh), device=device)}
            else:
                c = {k: torch.zeros((g, batch, cfg.d_model), device=device)
                     for k in ("c", "n", "h", "m")}
            caches[f"slot{s}"] = c
        if self.mesh is not None:
            return place_caches(caches, self.mesh)
        return caches

    def decode_step(self, p, tokens, caches, pos: int):
        """tokens [B, 1], caches (stacked), pos int → (logits [B, 1, V],
        caches).  The caches are updated in place and returned."""
        with tracing.span("decode", tokens.device, rows=tokens.shape[0],
                          pos=pos):
            cfg = self.cfg
            positions = _positions_for(cfg, tokens.shape[0], 1, pos,
                                       tokens.device)
            x = self._embed(p, tokens, positions)
            for g in range(self.groups):
                grp = _index(p["blocks"], g)
                for sl in range(self.cyc):
                    key = f"slot{sl}"
                    x = _block_decode(cfg, sl, x, grp[key],
                                      _index(caches[key], g), pos)
            x = _norm(cfg)(x, p["final_norm"], cfg.norm_eps)
            return self._logits(p, x[:, -1:, :]), caches

    def prefill(self, p, tokens, frames=None):
        """Prompt forward → (last-token logits [B, 1, V], filled
        caches).  An encoder-decoder config needs ``frames``."""
        b, s = tokens.shape
        with tracing.span("prefill", tokens.device, batch=b, seq=s):
            cfg = self.cfg
            positions = _positions_for(cfg, b, s, device=tokens.device)
            x = self._embed(p, tokens, positions)
            enc_out = self._enc_out(p, frames)
            extras = {f"slot{sl}": [] for sl in range(self.cyc)}
            for g in range(self.groups):
                grp = _index(p["blocks"], g)
                for sl in range(self.cyc):
                    x, _, ex = _block_apply(cfg, sl, x, grp[f"slot{sl}"],
                                            positions, enc_out=enc_out,
                                            impl=self.impl,
                                            return_state=True)
                    extras[f"slot{sl}"].append(ex)
            x = _norm(cfg)(x, p["final_norm"], cfg.norm_eps)
            logits = self._logits(p, x[:, -1:, :])
            enc_len = None if enc_out is None else enc_out.shape[1]
            return logits, self._caches_from_prefill(extras, s, b, x.device,
                                                     enc_len)

    def _caches_from_prefill(self, extras, s: int, b: int, device,
                             enc_len: Optional[int] = None,
                             decode_budget: int = 1024):
        """Per-group extras → decode caches for ``decode_budget`` more
        tokens.

        Rolling (windowed) caches are laid out so that slot == abs_pos %
        window, matching the modulo writes of ``decode_step``.  Cross K/V
        are stored in bf16, as the reference stores them.
        """
        cfg = self.cfg
        caches = self.init_caches(b, s + decode_budget, device, enc_len)
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
                    _copy_into(caches[key]["k"][g],
                               _pad_seq(k, caches[key]["k"]))
                    _copy_into(caches[key]["v"][g],
                               _pad_seq(v, caches[key]["v"]))
                    for name in ("cross_k", "cross_v"):
                        if name in ex:
                            _copy_into(caches[key][name][g],
                                       ex[name].to(torch.bfloat16))
                else:                   # Mamba's or xLSTM's final state
                    for name, t in ex.items():
                        _copy_into(caches[key][name][g], t)
        return caches
