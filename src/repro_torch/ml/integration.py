"""WFL ↔ PyTorch model integration (paper §5).

The port of ``repro/ml/integration.py``.  The paper exposes model
loading/application as WFL operators so pipelines can "run large-scale
inference and annotate datasets".  Any PyTorch callable becomes a flow
operator via :class:`ColumnModel`, which adapts ``{column name: np array}``
batches to the model and is what ``Flow.model_apply`` and expression-level
``ModelApply`` call.

``SavedModel``-style persistence: ``save``/``load`` round-trip params +
feature spec through the reference's exact files (``params.npz`` with keys
``x_mu x_sd y_mu y_sd w{i} b{i}``, and ``model.json``), so each package
loads the other's models.

Randomness differs from the reference (``torch.Generator`` against
``jax.random``): the initial weights and the minibatch indices are drawn
on the CPU from the seed and then moved, so the same seed gives the same
model and index stream on the CPU and on the card.  :func:`params_from_numpy`
carries the reference's parameters over, and :meth:`MLPRegressor.sgd_step`
takes the minibatch rows themselves, so a caller can replay the
reference's run step by step.
"""
from __future__ import annotations

import json
import math
import os
from typing import Callable, Dict, List

import numpy as np
import torch

__all__ = ["ColumnModel", "MLPRegressor", "params_from_numpy",
           "params_to_numpy"]

_STATS = ("x_mu", "x_sd", "y_mu", "y_sd")


def params_from_numpy(tree, device="cuda"):
    """The reference's MLP params (``jax.tree_util.tree_map(np.asarray,
    params)``, or the arrays of a ``params.npz``) → the port's: float32
    tensors on ``device`` in the same tree."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
    return {"layers": [{"w": t(layer["w"]), "b": t(layer["b"])}
                       for layer in tree["layers"]],
            **{k: t(tree[k]) for k in _STATS}}


def params_to_numpy(params) -> dict:
    """The port's MLP params → float32 numpy arrays in the same tree."""
    def a(x):
        return x.detach().cpu().numpy().astype(np.float32)
    return {"layers": [{"w": a(layer["w"]), "b": a(layer["b"])}
                       for layer in params["layers"]],
            **{k: a(params[k]) for k in _STATS}}


def _device_of(params):
    for layer in params["layers"]:
        return layer["w"].device
    return params["x_mu"].device


class ColumnModel:
    """Adapter: named numpy columns → PyTorch model → numpy column.

    Rows go through ``apply_fn(params, x)`` in chunks of ``batch_size``
    on the params' device under ``torch.inference_mode()``; the result is
    float32 numpy."""

    def __init__(self, apply_fn: Callable, params, feature_order: List[str],
                 batch_size: int = 8192):
        self.apply_fn = apply_fn
        self.params = params
        self.feature_order = feature_order
        self.batch_size = batch_size

    def apply_columns(self, cols: Dict[str, np.ndarray]) -> np.ndarray:
        feats = np.stack([np.asarray(cols[f], dtype=np.float32)
                          for f in self.feature_order], axis=-1)
        device = _device_of(self.params)
        outs = []
        with torch.inference_mode():
            for i in range(0, feats.shape[0], self.batch_size):
                chunk = torch.from_numpy(feats[i:i + self.batch_size])
                out = self.apply_fn(self.params, chunk.to(device))
                outs.append(out.float().cpu().numpy())
        return np.concatenate(outs) if outs else np.zeros((0,), np.float32)


class MLPRegressor:
    """Small MLP head — the paper's road-speed model stand-in (§6).

    Trained on features extracted by a WFL query; applied at scale back
    through WFL ``model_apply``.  Lives on ``device`` (the card unless the
    caller asks for the CPU).
    """

    def __init__(self, num_features: int, hidden: int = 64, depth: int = 2,
                 seed: int = 0, device="cuda"):
        self.num_features = num_features
        self.device = torch.device(device)
        gen = torch.Generator().manual_seed(seed)
        dims = [num_features] + [hidden] * depth + [1]
        layers = []
        for a, b in zip(dims[:-1], dims[1:]):
            w = torch.randn((a, b), generator=gen) / math.sqrt(a)
            layers.append({"w": w.to(self.device),
                           "b": torch.zeros((b,), device=self.device)})
        # feature/target standardization lives IN the params so the model
        # is self-contained through save/load and WFL application
        self.params = {"layers": layers,
                       "x_mu": torch.zeros((num_features,),
                                           device=self.device),
                       "x_sd": torch.ones((num_features,),
                                          device=self.device),
                       "y_mu": torch.zeros((), device=self.device),
                       "y_sd": torch.ones((), device=self.device)}

    @staticmethod
    def apply(params, x):
        h = (x - params["x_mu"]) / params["x_sd"]
        layers = params["layers"]
        for i, layer in enumerate(layers):
            h = h @ layer["w"] + layer["b"]
            if i < len(layers) - 1:
                h = torch.relu(h)
        return h[..., 0] * params["y_sd"] + params["y_mu"]

    @staticmethod
    def standardize(params, x, y):
        """Set the four standardization leaves from the training data:
        means, and population standard deviations (``correction=0``, as
        ``jnp.std``) plus 1e-6."""
        return {**params, "x_mu": x.mean(dim=0),
                "x_sd": x.std(dim=0, correction=0) + 1e-6,
                "y_mu": y.mean(), "y_sd": y.std(correction=0) + 1e-6}

    @staticmethod
    def sgd_step(params, xb, yb, lr: float):
        """One plain SGD step ``p - lr·g`` on the normalized-space MSE of
        the rows ``xb``, ``yb`` → (new params, loss).  The standardization
        leaves are left as they are (the reference restores them after
        its update)."""
        layers = [{k: v.detach().requires_grad_(True) for k, v in
                   layer.items()} for layer in params["layers"]]
        p = {**params, "layers": layers}
        with torch.enable_grad():
            # normalized-space loss: keeps gradient scale O(1) regardless
            # of target units (raw-space loss diverges: grads ∝ y_sd²)
            pred_n = (MLPRegressor.apply(p, xb) - p["y_mu"]) / p["y_sd"]
            yn = (yb - p["y_mu"]) / p["y_sd"]
            loss = torch.mean((pred_n - yn) ** 2)
            leaves = [v for layer in layers for v in layer.values()]
            grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        new_layers = [{k: (v - lr * next(it)).detach() for k, v in
                       layer.items()} for layer in layers]
        return {**params, "layers": new_layers}, loss.detach()

    @staticmethod
    def index_stream(n: int, steps: int, batch: int, seed: int = 0):
        """The minibatch row indices of :meth:`train`: [steps, min(batch,
        n)] int64, uniform over [0, n), drawn on the CPU from ``seed``."""
        gen = torch.Generator().manual_seed(seed)
        return torch.randint(0, n, (steps, min(batch, n)), generator=gen)

    def train(self, feats: np.ndarray, targets: np.ndarray, *,
              steps: int = 500, lr: float = 1e-2, batch: int = 1024,
              seed: int = 0):
        """Standardize on the data, then ``steps`` SGD steps on uniform
        minibatches → the loss of each step (floats; one device sync at
        the end)."""
        x = torch.from_numpy(np.asarray(feats, np.float32)).to(self.device)
        y = torch.from_numpy(np.asarray(targets, np.float32)).to(
            self.device)
        p = self.standardize(self.params, x, y)
        idx = self.index_stream(x.shape[0], steps, batch, seed).to(
            self.device)
        losses = []
        for i in range(steps):
            p, loss = self.sgd_step(p, x[idx[i]], y[idx[i]], lr)
            losses.append(loss)
        self.params = p
        return torch.stack(losses).tolist() if losses else []

    def as_column_model(self, feature_order: List[str]) -> ColumnModel:
        return ColumnModel(MLPRegressor.apply, self.params, feature_order)

    # SavedModel-style persistence (§5)
    def save(self, directory: str, feature_order: List[str]) -> None:
        os.makedirs(directory, exist_ok=True)
        host = params_to_numpy(self.params)
        arrays = {k: host[k] for k in _STATS}
        for i, layer in enumerate(host["layers"]):
            arrays[f"w{i}"] = layer["w"]
            arrays[f"b{i}"] = layer["b"]
        np.savez(os.path.join(directory, "params.npz"), **arrays)
        with open(os.path.join(directory, "model.json"), "w") as fh:
            json.dump({"features": feature_order,
                       "num_features": self.num_features}, fh)

    @staticmethod
    def load(directory: str, device="cuda") -> ColumnModel:
        with open(os.path.join(directory, "model.json")) as fh:
            meta = json.load(fh)
        with np.load(os.path.join(directory, "params.npz")) as z:
            n = 0
            while f"w{n}" in z:
                n += 1
            tree = {"layers": [{"w": z[f"w{i}"], "b": z[f"b{i}"]}
                               for i in range(n)],
                    **{k: z[k] for k in _STATS}}
        return ColumnModel(MLPRegressor.apply,
                           params_from_numpy(tree, device),
                           meta["features"])
