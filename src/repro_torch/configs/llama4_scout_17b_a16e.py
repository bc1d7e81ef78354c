"""Llama-4-Scout 17B-A16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

MoE 16 experts top-1 on every layer (public config unverified; the
chunked-attention variant is NOT assumed ⇒ treated as full attention,
long_500k skipped — see DESIGN.md).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    moe_experts=16, moe_top_k=1, moe_every=1, rope_theta=5e5,
    sub_quadratic=False, source="hf:meta-llama/Llama-4-Scout-17B-16E")
