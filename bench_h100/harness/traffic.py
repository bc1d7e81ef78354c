"""The one traffic generator: requests and training batches from a mix's
parameters (``traffic/<name>.json``) and the run's seed.

Lengths.  A length spec is ``{"dist": "fixed", "value": v}`` or
``{"dist": "lognormal", "median": m, "sigma": s, "min": lo, "max": hi}``.
A call of ``n`` requests (one static batch) draws its ``n`` lengths from
the distribution with the seed, one from each of ``n`` strata of equal
probability (the quantile at (i + u_i)/n, u_i uniform), clamped, in an
order the seed shuffles.  Every call of every seed thus holds other
sizes, and so pads to another length, while the work a window holds
stays steady from seed to seed.  Prompts are clamped to the model's
context less the call's longest output.

Tokens are uniform over ``[1, vocab)``; the server left-pads with 0.

Training batches are a frozen copy of ``repro_torch.data.pipeline.
TokenPipeline._make`` (structured: runs of 4 repeated tokens, 15% noise;
labels the tokens rolled by one), keyed by (seed, step).
"""
from __future__ import annotations

from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np

#: stream keys of the seed's generators
WINDOW, WARMUP = 0, 1


def draw(spec: dict, n: int, rng: np.random.Generator,
         cap: int = None) -> np.ndarray:
    """``n`` whole lengths of a length spec, one from each of ``n``
    strata of equal probability, clamped to [min, max] and to ``cap``,
    in ``rng``'s order."""
    if spec["dist"] == "fixed":
        out = np.full(n, int(spec["value"]))
    elif spec["dist"] == "lognormal":
        u = (np.arange(n) + rng.random(n)) / n
        u = np.clip(u, 1e-12, 1 - 1e-12)
        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        out = np.rint(spec["median"] * np.exp(spec["sigma"] * z)).astype(int)
        out = np.clip(out, int(spec["min"]), int(spec["max"]))
    else:
        raise ValueError(f"length distribution {spec['dist']!r}")
    if cap is not None:
        out = np.minimum(out, cap)
    return out[rng.permutation(n)].astype(np.int64)


def _rng(seed: int, stream: int, index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 63, stream, index])


def requests(traffic: dict, vocab: int, context: int, seed: int,
             index: int, stream: int = WINDOW
             ) -> List[Tuple[np.ndarray, int]]:
    """Call ``index``'s requests: [(prompt int32 [L], new tokens)]."""
    n = int(traffic["max_batch"])
    rng = _rng(seed, stream, index)
    new = draw(traffic["new_tokens"], n, rng)
    plen = draw(traffic["prompt_tokens"], n, rng,
                cap=context - int(new.max()))
    return [(rng.integers(1, vocab, int(L), dtype=np.int64).astype(np.int32),
             int(m)) for L, m in zip(plen, new)]


def longest_call(traffic: dict, vocab: int, context: int, seed: int
                 ) -> List[Tuple[np.ndarray, int]]:
    """A call at the largest shapes the mix can draw, for the warm-up:
    ``max_batch`` prompts at the longest length, at most three new tokens
    each (a decode step's shapes do not change with its position)."""
    n = int(traffic["max_batch"])
    nt, pt = traffic["new_tokens"], traffic["prompt_tokens"]
    most_new = int(nt["value"] if nt["dist"] == "fixed" else nt["max"])
    top = min(int(pt["value"] if pt["dist"] == "fixed" else pt["max"]),
              context - most_new)
    rng = _rng(seed, WARMUP, 0)
    return [(rng.integers(1, vocab, top, dtype=np.int64).astype(np.int32),
             min(3, most_new)) for _ in range(n)]


def train_batch(vocab: int, batch: int, seq_len: int, seed: int,
                step: int) -> Dict[str, np.ndarray]:
    """TokenPipeline's structured batch for (seed, step)."""
    rng = np.random.default_rng(((int(seed) % 2 ** 63) << 32) ^ step)
    base = rng.integers(0, vocab, (batch, seq_len // 4 + 1))
    tok = np.repeat(base, 4, axis=1)[:, :seq_len]
    noise = rng.integers(0, vocab, tok.shape)
    keep = rng.random(tok.shape) < 0.85
    tok = np.where(keep, tok, noise)
    labels = np.roll(tok, -1, axis=1)
    return {"tokens": tok.astype(np.int32), "labels": labels.astype(np.int32)}
