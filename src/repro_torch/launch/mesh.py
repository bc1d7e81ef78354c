"""Device-count default for partitioned query execution.

Only the execution side is here: :func:`default_exec_partitions`, the
counterpart of the JAX package's ``launch/mesh.default_exec_partitions``.
A function, not a module-level constant, so importing this module never
touches CUDA.  The production and local ML meshes
(``make_production_mesh``, ``make_local_mesh``) come with the training
path (ROADMAP A11/A12); the JAX package's ``make_exec_mesh`` has no
counterpart, because one card's merge needs no mesh
(``kernels/merge.py``).
"""
from __future__ import annotations

import torch

__all__ = ["default_exec_partitions"]


def default_exec_partitions(backend=None) -> int:
    """Default for ``core.planner.num_partitions``: one partition per
    CUDA device when ``backend`` runs on CUDA, else 1 (a backend on the
    CPU, or none)."""
    device = getattr(backend, "device", None)
    if device is None or torch.device(device).type != "cuda":
        return 1
    return max(1, torch.cuda.device_count())
