"""Jamba-v0.1 52B [arXiv:2403.19887] — Mamba+attention 1:7, MoE 16e top-2.

Jamba block: 8 layers with one attention layer (index 4), MoE MLP every
second layer; only 4/32 layers carry KV caches ⇒ long_500k runs.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    block_pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba",
                   "mamba", "mamba"),
    moe_experts=16, moe_top_k=2, moe_every=2,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    pos="none",   # Jamba uses no positional encoding (Mamba provides order)
    sub_quadratic=True, source="arXiv:2403.19887")
