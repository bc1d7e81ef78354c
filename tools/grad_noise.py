#!/usr/bin/env python3
"""How far float32 rounding alone moves a reduced model's gradients.

    PYTHONPATH=src python3 tools/grad_noise.py [arch ...]

For each architecture (default: SmolLM-360M, xLSTM-1.3B, Whisper
large-v3) at ``cfg.reduced()`` with float32 activations, on the CPU:
the gradients of one batch (``ModelBundle.loss_and_grads``, the batch of
``tests/test_torch_cuda.py::test_whisper_and_xlstm_on_card_match_cpu``)
at the params from seed 0, and again with every float32 param multiplied
by (1 + 2^-24 · N(0, 1)), about one ulp of noise.  Prints, per
architecture, the leaves whose gradient moved most, each as max |Δg| over
the leaf's largest |g|: the scale below which a card-against-CPU check of
the gradients would measure rounding, not the backward.
"""
from __future__ import annotations

import json
import sys
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.ml.model import ModelBundle, TrainConfig
from repro_torch.ml.params import tree_map
from repro_torch.ml.transformer import LM

ARCHS = ("smollm_360m", "xlstm_1_3b", "whisper_large_v3")


def _pairs(a, b, prefix=""):
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], (a, b)


def shift(arch: str, top: int = 3):
    """[(max |Δg| / max |g|, leaf), ...] for the ``top`` leaves that
    moved most under one ulp of noise on every float32 param."""
    cfg = replace(get_config(arch).reduced(), act_dtype="float32")
    p0 = LM(cfg).init(0, "cpu")
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24))
                           .astype(np.int32))
    batch = {"tokens": tok, "labels": tok.roll(-1, 1)}
    if cfg.encoder_layers:
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(2, 150, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    tc = TrainConfig(warmup=2, total_steps=10, loss_chunk=16, remat="full")
    mb = ModelBundle(cfg, train_cfg=tc, device="cpu")
    gen = torch.Generator().manual_seed(1)
    p1 = tree_map(lambda t, *_: t * (1 + 2.0 ** -24 * torch.randn(
        t.shape, generator=gen)) if t.dtype == torch.float32 else t, p0)
    g0, g1 = (mb.loss_and_grads(p, batch)[3] for p in (p0, p1))
    moved = [(float((a - b).abs().max() / (b.abs().max() + 1e-30)), k)
             for k, (a, b) in _pairs(g1, g0)]
    return sorted(moved, reverse=True)[:top]


def main(argv):
    for arch in argv or ARCHS:
        print(json.dumps({"arch": arch, "worst_leaves": shift(arch)}))


if __name__ == "__main__":
    main(sys.argv[1:])
