"""The system under test, reached through its own entry points.

This is the only module of the benchmark that imports the port
(``repro_torch``): its ``ArchConfig``, ``launch.serve.Server`` and
``ml.model.ModelBundle``.  The benchmark hands them its own weights, made
from the seed (``harness.weights``), in the port's parameter layout.
"""
from __future__ import annotations

import gc

import torch

from . import weights
from .model import Dims


def arch_config(dims: Dims, act_dtype: str = "bfloat16"):
    from repro_torch.configs.base import ArchConfig
    per = dims.period
    moe_every = 1
    if dims.experts:
        moe_every = next(p for p in range(1, dims.layers + 1)
                         if all(dims.moe[i] == (i % p == p - 1)
                                for i in range(dims.layers)))
    if any(k == "mamba" for k in dims.kinds) \
            and dims.dt_rank != max(1, dims.d // 16):
        raise ValueError(f"{dims.name}: the port's Mamba takes dt_rank "
                         f"d // 16, not {dims.dt_rank}")
    family = "hybrid" if "mamba" in dims.kinds else \
        ("moe" if dims.experts else "dense")
    return ArchConfig(
        name=dims.name, family=family, num_layers=dims.layers,
        d_model=dims.d, num_heads=dims.heads, num_kv_heads=dims.kv_heads,
        d_ff=dims.d_ff, vocab_size=dims.vocab, head_dim=dims.hd,
        block_pattern=tuple(dims.kinds[:per]),
        moe_experts=dims.experts, moe_top_k=dims.top_k, moe_every=moe_every,
        moe_capacity_factor=dims.capacity_factor,
        moe_group_size=dims.group_size, ssm_state=dims.d_state,
        ssm_conv=dims.d_conv, ssm_expand=dims.expand,
        ssm_chunk=dims.ssm_chunk, pos=dims.pos, rope_theta=dims.rope_theta,
        norm_eps=dims.eps, tie_embeddings=dims.tie, act="silu",
        act_dtype=act_dtype)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def server(dims: Dims, max_batch: int, seed: int, device: torch.device):
    """A ``Server`` at full size, serving the benchmark's weights.
    ``Server.__init__`` makes weights of its own, which are dropped
    before the benchmark's are made."""
    from repro_torch.launch.serve import Server
    srv = Server(arch_config(dims), reduced=False, max_batch=max_batch,
                 max_len=dims.context, seed=int(seed) % 2 ** 63,
                 device=device)
    srv.params = None
    free(device)
    srv.params = weights.make(dims, seed, device, "serve")
    return srv


def bundle(dims: Dims, train_cfg: dict, device: torch.device):
    """A ``ModelBundle`` for the train step (``impl`` and the
    ``TrainConfig`` fields from the traffic mix)."""
    from repro_torch.ml.model import ModelBundle, TrainConfig
    cfg = dict(train_cfg)
    impl = cfg.pop("impl", "reference")
    return ModelBundle(arch_config(dims), impl=impl,
                       train_cfg=TrainConfig(**cfg), device=device)

