"""Model bundle: arch config → train / prefill / decode step functions.

The port of ``repro/ml/model.py`` on one device, without a mesh.  This is
the layer ``launch.train`` drives: it owns the parameters' dtypes, the
optimizer state and the training step (chunked CE loss, MoE aux losses,
clipping, cosine schedule, AdamW, optional int8 error-feedback grad
compression), and the serving steps.

The LM trains through ``impl="reference"`` (the plain, differentiable
chunked attention and associative Mamba scan), as the reference's bundle
does; the CUDA kernels have no backward.  Left for the ML meshes (ROADMAP
A12): the reference's shardings (ZeRO-1, FSDP, sequence parallelism),
``input_specs`` and the ``lower_*`` methods of the dry-run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..configs.base import ArchConfig
from .losses import chunked_lm_loss
from .optim import (adamw_init, adamw_update, clip_by_global_norm,
                    compress_ef, cosine_schedule, ef_init, tree_leaves,
                    tree_map)
from .transformer import LM

__all__ = ["ModelBundle", "TrainConfig"]


@dataclass
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0
    weight_decay: float = 0.1
    loss_chunk: Optional[int] = 2048
    moe_lb_weight: float = 0.01
    moe_z_weight: float = 1e-3
    param_dtype: str = "float32"    # bfloat16 = mixed precision (f32 moments)
    compress_grads: bool = False
    remat: str = "dots"             # none | dots | full


class ModelBundle:
    """``cfg`` + ``train_cfg`` → parameters on ``device`` (the card unless
    the caller asks for the CPU) and the step functions."""

    def __init__(self, cfg: ArchConfig, *,
                 train_cfg: Optional[TrainConfig] = None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.train_cfg = train_cfg or TrainConfig()
        self.lm = LM(cfg, impl="reference", remat=self.train_cfg.remat)

    # ------------------------------------------------------------ shapes
    def init_params(self, seed: int = 0):
        """Seeded random float32 parameters, cast as ``param_dtype``
        says."""
        return self._cast_params(self.lm.init(seed, self.device,
                                              dtype=torch.float32))

    def _cast_params(self, params):
        if self.train_cfg.param_dtype == "float32":
            return params
        dt = getattr(torch, self.train_cfg.param_dtype)

        def cast(x):
            # matrices → bf16 (matmul sites cast activations to match);
            # vectors (norms, biases, A_log, …) stay f32 for stability
            return x.to(dt) if x.dim() >= 2 and x.dtype == torch.float32 \
                else x

        return tree_map(cast, params)

    def init_opt_state(self, params):
        opt = {"adam": adamw_init(params)}
        if self.train_cfg.compress_grads:
            opt["ef"] = ef_init(params)
        return opt

    # ------------------------------------------------------------- train
    def loss_and_grads(self, params, batch):
        """The training objective and its gradients → (total, loss, aux,
        grads): ``loss`` the chunked LM cross-entropy, ``total`` plus the
        MoE load-balance and router-z terms, ``grads`` of ``total`` in
        the params' tree (zeros for a leaf it does not reach)."""
        tc, lm = self.train_cfg, self.lm
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            hid, aux = lm.hidden(live, batch["tokens"],
                                 batch.get("positions"),
                                 batch.get("frames"))
            loss = chunked_lm_loss(hid, lm.head(live), batch["labels"],
                                   chunk=tc.loss_chunk)
            total = loss + tc.moe_lb_weight * aux["load_balance"] \
                + tc.moe_z_weight * aux["router_z"]
            flat = torch.autograd.grad(total, leaves, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, flat)])
        grads = tree_map(lambda _: next(it), live)
        aux = {k: v.detach() for k, v in aux.items()}
        return total.detach(), loss.detach(), aux, grads

    def make_train_step(self):
        """→ ``train_step(params, opt_state, batch)`` → (new params, new
        opt state, metrics).  ``batch`` holds ``tokens`` and ``labels``
        [B, S] (and M-RoPE ``positions`` [3, B, S], an encoder-decoder
        config's ``frames`` [B, Se, D]) on the params' device.
        The inputs are not modified."""
        tc = self.train_cfg
        lr_fn = cosine_schedule(tc.lr, tc.warmup, tc.total_steps)

        def train_step(params, opt_state, batch):
            total, loss, aux, grads = self.loss_and_grads(params, batch)
            params = tree_map(lambda t: t.detach(), params)
            new_opt = {}
            with torch.no_grad():
                if tc.compress_grads:
                    grads, new_opt["ef"] = compress_ef(grads,
                                                       opt_state["ef"])
                grads, gnorm = clip_by_global_norm(grads, tc.clip_norm)
                lr = lr_fn(opt_state["adam"]["step"] + 1)  # 1-indexed
                new_params, new_opt["adam"] = adamw_update(
                    params, grads, opt_state["adam"], lr,
                    weight_decay=tc.weight_decay)
            metrics = {"loss": loss, "total_loss": total,
                       "grad_norm": gnorm, "lr": lr,
                       "moe_lb": aux["load_balance"]}
            return new_params, new_opt, metrics

        return train_step

    # ------------------------------------------------------------- serve
    def make_prefill(self):
        lm = self.lm

        def prefill(params, batch):
            return lm.prefill(params, batch["tokens"],
                              frames=batch.get("frames"))

        return prefill

    def make_decode_step(self):
        lm = self.lm

        def serve_step(params, caches, tokens, pos):
            logits, caches = lm.decode_step(params, tokens, caches, pos)
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
            return next_tok, caches

        return serve_step
