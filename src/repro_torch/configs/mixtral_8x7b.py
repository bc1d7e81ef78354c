"""Mixtral 8x7B [arXiv:2401.04088] — MoE 8 experts top-2, SWA(4096).

Sliding-window attention on every layer ⇒ rolling caches, sub-quadratic ⇒
long_500k runs.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    attention_pattern=("local",), window=4096,
    moe_experts=8, moe_top_k=2, moe_every=1, rope_theta=1e6,
    sub_quadratic=True, source="arXiv:2401.04088")
