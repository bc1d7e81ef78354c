"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01; unverified] — GQA, no bias."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256000, rope_theta=8e6, tie_embeddings=True,
    sub_quadratic=False, source="hf:CohereForAI/c4ai-command-r-v01")
