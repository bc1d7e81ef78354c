"""Losses: cross-entropy with optional sequence-chunked logits.

The port of ``repro/ml/losses.py``.  For large-vocab models the [B, S, V]
logits tensor dominates activation memory.  The chunked path never keeps
it: a loop over sequence chunks computes ``hidden_chunk @ head`` →
softmax-CE → scalar, each chunk under ``torch.utils.checkpoint`` so that
backward recomputes the chunk's [B, chunk, V] logits instead of saving
them (the reference's ``jax.checkpoint`` a chunk).

Products follow the reference's ``dot_general`` with float32 accumulation:
the head is rounded to the hidden states' dtype, and the products of two
such values are summed in float32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .sharding import is_dtensor

__all__ = ["cross_entropy", "chunked_lm_loss"]


def _gold(logits, labels):
    """``logits[..., labels]``.  Where the vocab dim is sharded over a
    mesh (a DTensor's ``Shard(-1)``, the LM head's model-axis split), a
    gather cannot pick across the shards — DTensor fails to reduce the
    masked partial it makes — so each shard sums its own hits
    (Megatron's vocab-parallel pick) and the shards' sum is the same
    value: one term is the logit, the others are zeros."""
    last = logits.dim() - 1
    if is_dtensor(logits) and any(
            p.is_shard(last) for p in logits.placements):
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        hit = labels.long()[..., None] == vocab
        return torch.where(hit, logits, torch.zeros_like(logits)).sum(-1)
    return torch.gather(logits, -1, labels.long()[..., None])[..., 0]


def cross_entropy(logits, labels, mask=None):
    """logits [..., V] float32, labels [...] int — mean NLL over mask."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = _gold(logits, labels)
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _logits(hidden, headc):
    return hidden.float() @ headc.float()


def _chunk_nll(h, headc, labels, mask):
    """Σ masked NLL of one chunk (recomputed in backward)."""
    logits = _logits(h, headc)
    logz = torch.logsumexp(logits, dim=-1)
    gold = _gold(logits, labels)
    return ((logz - gold) * mask.float()).sum()


def chunked_lm_loss(hidden, head, labels, mask=None,
                    chunk: Optional[int] = None):
    """hidden [B, S, D] (any dtype), head [D, V] → mean NLL.

    ``chunk=None`` materializes full logits (small models); otherwise a
    loop over ⌈S/chunk⌉ chunks bounds live logits memory.  The last chunk
    is padded (label 0, mask 0), and the mean divides by the mask's sum.
    """
    b, s, _ = hidden.shape
    headc = head.to(hidden.dtype)
    if chunk is None or chunk >= s:
        return cross_entropy(_logits(hidden, headc), labels, mask)
    c = chunk
    pad = (-s) % c
    m = mask if mask is not None else torch.ones(
        (b, s), dtype=torch.float32, device=hidden.device)
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        m = F.pad(m, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s + pad, c):
        mm = m[:, c0:c0 + c]
        tot = tot + checkpoint(_chunk_nll, hidden[:, c0:c0 + c], headc,
                               labels[:, c0:c0 + c], mm,
                               use_reentrant=False)
        cnt = cnt + mm.sum()
    return tot / torch.clamp(cnt, min=1.0)
