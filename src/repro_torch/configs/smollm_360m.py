"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M] — llama-style small dense."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    d_ff=2560, vocab_size=49152, tie_embeddings=True,
    sub_quadratic=False, source="hf:HuggingFaceTB/SmolLM-360M")
