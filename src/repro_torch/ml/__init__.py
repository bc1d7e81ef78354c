"""ML stack (the LM serving path): layers, attention, Mamba, MoE, the
unified LM and the carry-over of the JAX package's parameters."""
from .params import from_jax_params
from .transformer import LM, cycle_len

__all__ = ["LM", "cycle_len", "from_jax_params"]
