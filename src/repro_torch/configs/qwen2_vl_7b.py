"""Qwen2-VL-7B backbone [arXiv:2409.12191] — M-RoPE, dynamic resolution.

Vision frontend is a STUB: input_specs() provides token ids plus M-RoPE
position ids [3, B, S] (temporal/height/width streams; equal streams for
text).  QKV bias per the Qwen2 family.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, qkv_bias=True, mrope=True,
    frontend="vision_stub", rope_theta=1e6,
    sub_quadratic=False, source="arXiv:2409.12191")
