"""The execution mesh for partitioned query execution.

The counterpart of the JAX package's ``launch/mesh`` execution side:
:func:`make_exec_mesh`, the ordered cards of the ``"part"`` axis that
``TorchBackend.partition_context`` pins partition p of P to (card p mod
D), and :func:`default_exec_partitions`, one partition per card.  The
axis is a plain list of ``torch.device``: the port's merge brings every
partition's states to the axis's first card and combines them there in
states order (``kernels/merge.py``), so no collective runs over it.
Functions, not module-level constants, so importing this module never
touches CUDA.  The production and local ML meshes
(``make_production_mesh``, ``make_local_mesh``) come with the ML meshes
(ROADMAP A12).
"""
from __future__ import annotations

from typing import List

import torch

__all__ = ["make_exec_mesh", "default_exec_partitions"]


def _on_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def make_exec_mesh(partitions: int = 0, device="cuda") -> List[torch.device]:
    """The ``"part"`` axis for ``partitions`` partitions: cards
    ``cuda:0 … cuda:n-1`` with ``n = min(partitions, device_count)``, all
    of them for ``partitions=0`` (the JAX package's size rule).  For a
    ``device`` on the CPU it is ``[cpu]``, the one-device axis a P > 1
    query is emulated on."""
    if not _on_cuda(device):
        return [torch.device("cpu")]
    n = max(1, torch.cuda.device_count())
    size = min(max(1, int(partitions)), n) if partitions else n
    return [torch.device("cuda", i) for i in range(size)]


def default_exec_partitions(backend=None) -> int:
    """Default for ``core.planner.num_partitions``: one partition per
    CUDA device when ``backend`` runs on CUDA, else 1 (a backend on the
    CPU, or none)."""
    if not _on_cuda(getattr(backend, "device", None)):
        return 1
    return max(1, torch.cuda.device_count())
