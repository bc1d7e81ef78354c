"""Losses: cross-entropy with optional sequence-chunked logits.

The port of ``repro/ml/losses.py``.  For large-vocab models the [B, S, V]
logits tensor dominates activation memory.  The chunked path never keeps
it: a loop over sequence chunks computes ``hidden_chunk @ head`` →
softmax-CE → scalar, each chunk under ``torch.utils.checkpoint`` so that
backward recomputes the chunk's [B, chunk, V] logits instead of saving
them (the reference's ``jax.checkpoint`` a chunk).

Products follow the reference's ``dot_general`` with float32 accumulation:
the head is rounded to the hidden states' dtype, and the products of two
such values are summed in float32.  On a mesh whose head cuts the vocab,
the NLL is Megatron's vocab-parallel one, on each rank's vocab slice.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .sharding import is_dtensor, on_pieces

__all__ = ["cross_entropy", "chunked_lm_loss"]


def _nll(logits, labels):
    """logsumexp(logits) − logits[..., labels] over the last dim.  Where
    the vocab dim is sharded over a mesh (a DTensor's ``Shard(-1)``, the
    LM head's model-axis split), Megatron's vocab-parallel cross-entropy
    (:func:`_nll_on_shards`): DTensor's own rules gather the whole logits
    for the log-sum-exp — the batch's cut too — and cannot reduce the
    masked partial a gather across the shards makes."""
    last = logits.dim() - 1
    if is_dtensor(logits) and any(
            p.is_shard(last) for p in logits.placements):
        return _nll_on_shards(logits, labels)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def _sumexp_pick(logits, m, labels, *, first: int):
    """On a vocab slice starting at ``first``: Σ exp(logits − m) and each
    label's logit (0 where the label lies outside the slice)."""
    vocab = first + torch.arange(logits.shape[-1], device=logits.device)
    hit = labels.long()[..., None] == vocab
    gold = torch.where(hit, logits, torch.zeros_like(logits)).sum(-1)
    return torch.exp(logits - m[..., None]).sum(-1), gold


def _nll_on_shards(logits, labels):
    """The vocab-parallel NLL: each rank's max over its own vocab slice,
    the max over the slices (an all-reduce of [..]); then each rank's sum
    of exponentials and its hits, summed over the slices (``on_pieces``:
    no [.., V] tensor beyond a rank's slice)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = logits.device_mesh
    last = logits.dim() - 1
    lp = list(logits.placements)
    (cut,) = [i for i, p in enumerate(lp) if p.is_shard(last)]
    first = mesh.get_local_rank(cut) * -(-logits.shape[-1]
                                         // mesh.size(cut))
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in lp]

    def over_slices(op):
        return [Partial(op) if i == cut else p for i, p in enumerate(rows)]

    m = on_pieces(lambda x: x.detach().amax(dim=-1), mesh, (lp,),
                  over_slices("max"))(logits).redistribute(mesh, rows)
    se, gold = on_pieces(partial(_sumexp_pick, first=first), mesh,
                         (lp, rows, rows),
                         (over_slices("sum"), over_slices("sum")))(
        logits, m, labels)
    se, gold = (t.redistribute(mesh, rows) for t in (se, gold))
    return m + torch.log(se) - gold


def cross_entropy(logits, labels, mask=None):
    """logits [..., V] float32, labels [...] int — mean NLL over mask."""
    nll = _nll(logits, labels)
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _logits(hidden, headc):
    """Float32 logits; on a mesh whole sums (a head cut along D, as a tied
    embedding whose vocab does not divide the model axis is, makes a
    partial sum, which neither the log-sum-exp nor the pick can take)."""
    out = hidden.float() @ headc.float()
    if is_dtensor(out) and any(p.is_partial() for p in out.placements):
        from torch.distributed.tensor import Replicate
        out = out.redistribute(out.device_mesh, [
            Replicate() if p.is_partial() else p for p in out.placements])
    return out


def _chunk_nll(h, headc, labels, mask):
    """Σ masked NLL of one chunk (recomputed in backward)."""
    return (_nll(_logits(h, headc), labels) * mask.float()).sum()


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
