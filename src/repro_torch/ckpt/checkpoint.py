"""Async, atomic checkpointing with keep-last-k retention.

The port of ``repro/ckpt/checkpoint.py`` for one process:

  * **one shard** — a step is ``step-XXXXXXXX/shard-00000.npz``, keyed by
    the leaves' paths joined with ``__`` (``params__blocks__slot0__…``),
    plus ``MANIFEST.json`` (step; each leaf's shape and dtype) — the
    reference's layout, so each package restores the other's checkpoints;
  * **async** — ``save`` snapshots every leaf to host memory (a copy, so
    later in-place updates cannot reach it) before the writer thread
    starts; training continues immediately;
  * **atomic** — writes go to ``step-XXXXXXXX.tmp/`` and are committed
    with one ``os.replace``; a crashed save is never mistaken for a
    valid checkpoint (restore picks the newest *committed* step);
  * **retention** — keep-last-k GC over committed steps; it never joins
    a writer, so a non-blocking save does not wait for its write
    (``CheckpointManager.wait`` joins them, then prunes).

Restore takes a target ``device`` where the reference takes shardings:
tensor leaves of the template come back as tensors there, other leaves
as numpy arrays.

bfloat16: numpy has no bfloat16 and the port does not need ``ml_dtypes``.
The reference's npz stores a bf16 leaf as 2-byte void records (``|V2``)
with ``"bfloat16"`` in the manifest; the port writes and reads such a
leaf as its 16-bit words, viewed as ``torch.bfloat16``.

The data pipeline checkpoints alongside (deterministic PRNG state), so a
restart replays no batch twice — see repro_torch.data.pipeline.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]


def _items(tree, prefix=()):
    """(path, leaf) pairs of nested dicts/lists/tuples, paths as tuples of
    dict keys and list indices."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _rebuild(template, flat: Dict[str, Any], fn, prefix=()):
    if isinstance(template, dict):
        return {k: _rebuild(v, flat, fn, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, flat, fn, prefix + (str(i),))
                              for i, v in enumerate(template))
    key = "/".join(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    return fn(template, flat[key])


def _to_host(leaf) -> tuple:
    """A leaf → (numpy array to write, manifest dtype name), copied."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _from_host(template, arr: np.ndarray, device):
    """A stored array → the template leaf's kind: a tensor (on ``device``,
    or the template's own) for a tensor leaf, else the numpy array."""
    if not isinstance(template, torch.Tensor):
        return arr
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        # np.asarray, not np.ascontiguousarray: that one makes a 0-d leaf
        # (AdamW's step) 1-d
        t = torch.from_numpy(np.asarray(arr, order="C"))
    return t.to(device if device is not None else template.device)


def save_checkpoint(directory: str, step: int, tree, *,
                    blocking: bool = True) -> threading.Thread:
    """Write one step. Returns the writer thread (joined if blocking)."""
    tmp = os.path.join(directory, f"step-{step:08d}.tmp")
    final = os.path.join(directory, f"step-{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    # Snapshot to host memory NOW (async-safe under in-place updates).
    host: Dict[str, np.ndarray] = {}
    meta = {}
    for path, leaf in _items(tree):
        arr, dtype = _to_host(leaf)
        host["__".join(path)] = arr
        meta["/".join(path)] = {"shape": list(arr.shape), "dtype": dtype}

    def write():
        np.savez(os.path.join(tmp, "shard-00000.npz"), **host)
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as fh:
            json.dump({"step": step, "leaves": meta}, fh)
        os.replace(tmp, final)          # atomic commit

    # not a daemon: the interpreter waits for a pending write at exit
    t = threading.Thread(target=write)
    t.start()
    if blocking:
        t.join()
    return t


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.fullmatch(r"step-(\d+)", f))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, template, *, step: Optional[int] = None,
                       device=None):
    """Restore into ``template``'s structure → (tree, step).  Tensor leaves
    land on ``device`` (or, when None, on their template leaf's device);
    the saving device and dtype layout are irrelevant."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoints in {directory}")
    d = os.path.join(directory, f"step-{step:08d}")
    with np.load(os.path.join(d, "shard-00000.npz")) as z:
        flat = {k.replace("__", "/"): z[k] for k in z.files}
    tree = _rebuild(template, flat,
                    lambda leaf, arr: _from_host(leaf, arr, device))
    return tree, step


class CheckpointManager:
    """Async save + keep-last-k retention + restore-or-init.

    ``save(blocking=False)`` returns once the leaves are on the host; the
    writer runs on.  Retention prunes committed steps only, so it never
    waits for a writer: while writes are pending, up to ``keep`` committed
    steps stay beside them.  ``wait()`` joins the pending writers and then
    prunes, so ``keep`` holds after it; a restore calls it, and the
    interpreter joins the writers at exit (they are not daemon threads).
    (The JAX package's ``save`` joins the writer it has just started, in
    its retention pass.)"""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pending: List[threading.Thread] = []
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree, blocking: bool = False):
        t = save_checkpoint(self.directory, step, tree, blocking=blocking)
        with self._lock:
            self._pending.append(t)
        self._gc()
        return t

    def wait(self):
        """Join every pending writer, then prune to ``keep``."""
        with self._lock:
            pending, self._pending = self._pending, []
        for t in pending:
            t.join()
        self._gc()

    def restore_or_none(self, template, device=None):
        self.wait()
        if latest_step(self.directory) is None:
            return None, None
        return restore_checkpoint(self.directory, template, device=device)

    def _gc(self):
        """Remove all but the newest ``keep`` committed steps (a step
        being written is not committed: its directory ends in ``.tmp``)."""
        steps = sorted(
            int(m.group(1)) for f in os.listdir(self.directory)
            if (m := re.fullmatch(r"step-(\d+)", f)))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step-{s:08d}"),
                          ignore_errors=True)
