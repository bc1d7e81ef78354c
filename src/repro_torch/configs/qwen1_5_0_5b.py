"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B] — dense, GQA kv=16 (MHA), QKV bias."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=2816, vocab_size=151936, qkv_bias=True, rope_theta=1e6,
    sub_quadratic=False, source="hf:Qwen/Qwen1.5-0.5B")
