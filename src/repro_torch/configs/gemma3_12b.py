"""Gemma-3-12B [hf:google/gemma-3; unverified] — 5:1 local:global, 128k.

head_dim=256 (public config), sliding window 1024 on local layers, tanh
logit soft-capping.  5/6 of layers hold only a 1024-window cache ⇒ eligible
for long_500k (sub-quadratic in practice; the periodic global layer holds
the full cache — see DESIGN.md).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
    d_ff=15360, vocab_size=262144, head_dim=256,
    attention_pattern=("local", "local", "local", "local", "local",
                       "global"),
    window=1024, logit_softcap=50.0, rope_theta=1e6, act="gelu",
    tie_embeddings=True, sub_quadratic=True,
    source="hf:google/gemma-3-1b-pt (scaled per assignment)")
