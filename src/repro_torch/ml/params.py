"""Parameter trees: the storage dtype of each weight, and the carry-over
of the JAX package's parameters.

The port keeps the reference's tree (``repro/ml/transformer.py``
``LM.init``): nested dicts with the same keys, layer slots stacked with a
leading [G] group dim.  A weight that every use casts to the activation
dtype before its product (attention projections and biases, MLP and
expert weights, the router, Mamba's in/out projections, the embedding
and LM head) is *stored* in the activation dtype: the rounding happens
once at load instead of at every use, with the same result.  Everything
else stays float32, because its uses compute in float32 (Mamba's conv,
x/dt projections, A_log and skip, all norm scales).  With bf16
activations this halves the weight memory (Jamba's 8-layer cut: about
27 GB instead of 53).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ArchConfig

__all__ = ["ACT_DTYPE_KEYS", "act_dtype", "storage_dtype", "cast_params",
           "from_jax_params", "tree_map"]

#: leaf names whose every use casts them to the activation dtype
ACT_DTYPE_KEYS = frozenset({
    "embed", "lm_head", "wq", "wk", "wv", "wo", "wq_bias", "wk_bias",
    "wv_bias", "w_gate", "w_up", "w_down", "router", "in_proj",
    "out_proj"})


def act_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.act_dtype)


def storage_dtype(cfg: ArchConfig, name: str) -> torch.dtype:
    """The dtype leaf ``name`` is kept in."""
    return act_dtype(cfg) if name in ACT_DTYPE_KEYS else torch.float32


def tree_map(fn, tree, name: str = ""):
    """Apply ``fn(leaf, leaf_name)`` over a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, k) for k, v in tree.items()}
    return fn(tree, name)


def cast_params(cfg: ArchConfig, tree):
    """Cast every leaf to its storage dtype."""
    return tree_map(lambda t, name: t.to(storage_dtype(cfg, name)), tree)


def from_jax_params(cfg: ArchConfig, tree: Dict[str, Any],
                    device="cuda", dtype=None) -> Dict[str, Any]:
    """The reference's ``LM.init`` tree, as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, params)``), → the port's
    parameters on ``device``, each leaf in its storage dtype — or every
    leaf in ``dtype`` (``torch.float32`` for training, which keeps the
    reference's float32 leaves as they are)."""
    def leaf(a, name):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=device,
                    dtype=dtype or storage_dtype(cfg, name))
    return tree_map(leaf, tree)
