"""Deterministic, checkpointable LM token pipeline (a copy of the JAX
package's ``data/pipeline.py``, numpy only).

The training driver's input side: synthetic token streams generated from a
counter-based PRNG, so the pipeline's *entire* state is (seed, step) —
restartable exactly at any step with no log replay (the data half of the
fault-tolerance story: checkpoint saves (seed, step) alongside params).

Host-side prefetch runs one batch ahead on a thread.  The WFL-fed variant
(:class:`WflBatcher`) draws batches from a WarpFlow query result, which is
how §5 "time-to-trained-model" is served: data selection happens in the
query engine, batching here.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["TokenPipeline", "TrainingDataset", "WflBatcher"]


class TokenPipeline:
    """Synthetic token batches with skip-ahead restore."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int, *,
                 seed: int = 0, start_step: int = 0,
                 prefetch: int = 2, structured: bool = True):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.step = start_step
        self.structured = structured
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # -- deterministic batch: a counter-based stream keyed by (seed, step)
    def _make(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 32) ^ step)
        if self.structured:
            # learnable structure: markov-ish repetition so loss can fall
            base = rng.integers(0, self.vocab_size,
                                (self.batch, self.seq_len // 4 + 1))
            tok = np.repeat(base, 4, axis=1)[:, :self.seq_len]
            noise = rng.integers(0, self.vocab_size, tok.shape)
            keep = rng.random(tok.shape) < 0.85
            tok = np.where(keep, tok, noise)
        else:
            tok = rng.integers(0, self.vocab_size,
                               (self.batch, self.seq_len))
        labels = np.roll(tok, -1, axis=1)
        return {"tokens": tok.astype(np.int32),
                "labels": labels.astype(np.int32)}

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def close(self):
        self._stop.set()

    @staticmethod
    def restore(state: dict, vocab_size: int, batch: int, seq_len: int,
                **kw) -> "TokenPipeline":
        return TokenPipeline(vocab_size, batch, seq_len,
                             seed=state["seed"],
                             start_step=state["step"], **kw)


class TrainingDataset:
    """Feature matrix + target vector selected by a WFL query (§5).

    The materialized end of ``Flow.to_dataset(features=..., target=...)``:
    data selection happens in the query engine (indices, refine, fused
    waves), and this object is the hand-off into training — minibatch
    iteration via :meth:`batches`, a train/test :meth:`split`, and
    :meth:`fit`, which closes the paper's time-to-trained-model loop by
    training an :class:`repro_torch.ml.integration.MLPRegressor` on the
    rows the query selected.
    """

    def __init__(self, features: np.ndarray, targets: np.ndarray,
                 feature_names):
        self.features = np.asarray(features, np.float32)
        self.targets = np.asarray(targets, np.float32)
        self.feature_names = list(feature_names)

    @classmethod
    def from_table(cls, table, feature_paths, target_path
                   ) -> "TrainingDataset":
        feats = np.stack([np.asarray(table.batch[p].values, np.float32)
                          for p in feature_paths], axis=-1)
        targets = np.asarray(table.batch[target_path].values, np.float32)
        return cls(feats, targets, feature_paths)

    def __len__(self) -> int:
        return int(self.features.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.features.shape[1])

    def split(self, frac: float = 0.8, seed: int = 0):
        """Shuffled (train, test) split."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self))
        k = int(len(self) * frac)
        return (TrainingDataset(self.features[order[:k]],
                                self.targets[order[:k]],
                                self.feature_names),
                TrainingDataset(self.features[order[k:]],
                                self.targets[order[k:]],
                                self.feature_names))

    def batches(self, batch: int, seed: int = 0):
        """Endless shuffled minibatch stream of (features, targets)."""
        rng = np.random.default_rng(seed)
        while True:
            idx = rng.integers(0, len(self), batch)
            yield self.features[idx], self.targets[idx]

    def fit(self, *, hidden: int = 64, depth: int = 2, seed: int = 0,
            device="cuda", **train_kw):
        """Train an MLP head on this dataset → (model, losses), on the
        card unless the caller asks for ``device="cpu"``."""
        from ..ml.integration import MLPRegressor
        model = MLPRegressor(self.num_features, hidden=hidden, depth=depth,
                             seed=seed, device=device)
        losses = model.train(self.features, self.targets, **train_kw)
        return model, losses


class WflBatcher:
    """Batches features/targets out of a WarpFlow query result (§5)."""

    def __init__(self, table, feature_paths, target_path, batch: int,
                 seed: int = 0):
        self.features = np.stack(
            [np.asarray(table.batch[p].values, np.float32)
             for p in feature_paths], axis=-1)
        self.targets = np.asarray(table.batch[target_path].values,
                                  np.float32)
        self.batch = batch
        self.rng = np.random.default_rng(seed)

    def __next__(self):
        idx = self.rng.integers(0, self.features.shape[0], self.batch)
        return self.features[idx], self.targets[idx]

    def __iter__(self):
        return self
