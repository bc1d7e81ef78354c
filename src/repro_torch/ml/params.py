"""Parameter trees: the storage dtype of each weight, and the carry-over
of the JAX package's parameters.

The port keeps the reference's tree (``repro/ml/transformer.py``
``LM.init``): nested dicts with the same keys, layer slots stacked with a
leading [G] group dim.  A weight that every use casts to the activation
dtype before its product (attention projections and biases, MLP and
expert weights, the router, Mamba's in/out projections, mLSTM's up and
head-wise projections, the encoder's input projection, the embedding and
LM head) is *stored* in the activation dtype: the rounding happens once
at load instead of at every use, with the same result.  Everything else
stays float32, because its uses compute in float32 (Mamba's conv, x/dt
projections, A_log and skip, the xLSTM gates and recurrences, all norm
scales) or because the reference adds it in another dtype than the
activations' (Whisper's ``pos_embed``: the encoder adds it in bf16
whatever the activation dtype).  With bf16 activations this halves the
weight memory (Jamba's 8-layer cut: about 27 GB instead of 53).

The rule looks at the leaf's parent as well as its name: the sLSTM cell's
input weights ``wi``, ``wf``, ``wz`` and ``wo`` are always used in
float32 (the reference's ``_slstm_inputs``), where an attention block's
``wo`` is cast to the activations.  Only sLSTM cells hold a ``wo`` under a
``cell`` (mLSTM's has ``out_proj``), so a leaf's parent tells them apart.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ArchConfig

__all__ = ["ACT_DTYPE_KEYS", "CELL_F32_KEYS", "act_dtype", "storage_dtype",
           "cast_params", "from_jax_params", "tree_map"]

#: leaf names whose every use casts them to the activation dtype
ACT_DTYPE_KEYS = frozenset({
    "embed", "lm_head", "wq", "wk", "wv", "wo", "wq_bias", "wk_bias",
    "wv_bias", "w_gate", "w_up", "w_down", "router", "in_proj",
    "out_proj", "w_upA", "w_upB", "enc_in"})

#: leaves of an xLSTM ``cell`` kept in float32 whatever their name says
#: (the sLSTM gates' input weights)
CELL_F32_KEYS = frozenset({"wi", "wf", "wz", "wo"})


def act_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.act_dtype)


def storage_dtype(cfg: ArchConfig, name: str,
                  parent: str = "") -> torch.dtype:
    """The dtype leaf ``name`` (a child of ``parent``) is kept in."""
    if parent == "cell" and name in CELL_F32_KEYS:
        return torch.float32
    return act_dtype(cfg) if name in ACT_DTYPE_KEYS else torch.float32


def tree_map(fn, tree, name: str = ""):
    """Apply ``fn(leaf, leaf_name)`` over a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, k) for k, v in tree.items()}
    return fn(tree, name)


def _map_stored(cfg: ArchConfig, fn, tree, parent: str = ""):
    """``fn(leaf, storage dtype)`` over a nested dict of tensors."""
    return {k: (_map_stored(cfg, fn, v, k) if isinstance(v, dict)
                else fn(v, storage_dtype(cfg, k, parent)))
            for k, v in tree.items()}


def cast_params(cfg: ArchConfig, tree):
    """Cast every leaf to its storage dtype."""
    return _map_stored(cfg, lambda t, dt: t.to(dt), tree)


def from_jax_params(cfg: ArchConfig, tree: Dict[str, Any],
                    device="cuda", dtype=None) -> Dict[str, Any]:
    """The reference's ``LM.init`` tree, as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, params)``), → the port's
    parameters on ``device``, each leaf in its storage dtype — or every
    leaf in ``dtype`` (``torch.float32`` for training, which keeps the
    reference's float32 leaves as they are)."""
    def leaf(a, stored):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=device, dtype=dtype or stored)
    return _map_stored(cfg, leaf, tree)
