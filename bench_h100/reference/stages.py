"""The plain reference over several cards: a pipeline of stages, one a
rank, for a model that no card holds whole in float32.

Rank r holds its share of the layers (``harness.weights.stage``: the
groups ``r * G / world`` to ``(r + 1) * G / world - 1`` of the stacked
tree, made from the seed by the same sequence as the whole tree), rank 0
the embedding and the last rank the final norm and head, and each runs
its layers as :class:`~.lm.Model` does.  The hidden state [B, S, d] of a
prefill, then [B, d] of each decode step, passes from rank r to rank
r + 1 by point-to-point ``send`` / ``recv`` in float32: the numbers are
those of the whole model in one process, step for step.  Plain ``torch``
and ``torch.distributed``; nothing of the port.
"""
from __future__ import annotations

from typing import Iterator, Optional

import torch
import torch.distributed as dist

from .lm import Model


def layers_of(n_layers: int, period: int, rank: int, world: int) -> range:
    """The layers stage ``rank`` of ``world`` holds: whole groups of
    ``period`` layers, as many to each stage."""
    groups = n_layers // period
    if groups % world:
        raise ValueError(f"{groups} groups of {period} layers do not "
                         f"divide over {world} stages")
    per = groups // world * period
    return range(rank * per, (rank + 1) * per)


class Pipe:
    """This rank's place in the pipeline: it receives from ``rank - 1``
    and sends to ``rank + 1``; the last rank gives the logits."""

    def __init__(self, rank: int, world: int, device: torch.device):
        self.rank, self.world, self.device = rank, world, device
        self.first, self.last = rank == 0, rank == world - 1

    def _recv(self, shape) -> torch.Tensor:
        x = torch.empty(shape, dtype=torch.float32, device=self.device)
        dist.recv(x, self.rank - 1)
        return x

    def _out(self, model: Model, x: torch.Tensor) -> Optional[torch.Tensor]:
        """x [B, d] at the position judged: the logits on the last rank,
        else sent on."""
        if self.last:
            return model.logits(x)
        dist.send(x.contiguous(), self.rank + 1)
        return None

    @torch.no_grad()
    def follow(self, model: Model, toks: torch.Tensor, served: torch.Tensor,
               s: int) -> Iterator[Optional[torch.Tensor]]:
        """``lm``'s follow over the pipeline: at each served position (the
        prefill's last, then each decode step fed every row's served
        token) the last rank yields the logits [B, V], the others None
        once they have passed their hidden state on."""
        b, d = toks.shape[0], model.dims.d
        state = []
        x = model.embed(toks) if self.first else self._recv((b, s, d))
        x = model.prefill_layers(x, state)
        if not self.last:
            dist.send(x.contiguous(), self.rank + 1)
            yield None
        else:
            yield model.logits(x[:, -1])
        del x
        for t in range(1, served.shape[1]):
            x = model.embed(served[:, t - 1]) if self.first \
                else self._recv((b, d))
            yield self._out(model, model.decode_layers(x, state, s + t - 1))
