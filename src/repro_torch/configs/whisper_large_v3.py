"""Whisper large-v3 backbone [arXiv:2212.04356; unverified] — enc-dec.

Conv frontend is a STUB: input_specs() provides precomputed frame
embeddings [B, S, D] for the encoder; the decoder is a standard
cross-attending transformer.  MHA (kv=20), GELU MLPs, LayerNorm, learned
positions (per the paper's architecture).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866, encoder_layers=32,
    frontend="audio_stub", pos="learned", act="gelu", norm="layernorm",
    sub_quadratic=False, source="arXiv:2212.04356")
