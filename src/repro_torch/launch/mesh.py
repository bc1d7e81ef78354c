"""Meshes: the ML device meshes, and the execution mesh for partitioned
query execution.

The ML meshes are ``torch.distributed`` ``DeviceMesh``es over the ranks
of the process group (one process per card, as ``torch.distributed.run``
starts them): :func:`make_local_mesh` (``("data", "model")``, clamped to
the ranks there are, as the reference clamps to its devices) and
:func:`make_production_mesh` (16×16, or 2×16×16 with a ``"pod"`` axis in
front); :func:`production_mesh_shape` gives the production shapes as a
``MeshShape`` for the sharding rules without 256 ranks.

The execution side: :func:`make_exec_mesh`, the ordered cards of the
``"part"`` axis that
``TorchBackend.partition_context`` pins partition p of P to (card p mod
D), and :func:`default_exec_partitions`, one partition per card.  The
axis is a plain list of ``torch.device``: the port's merge brings every
partition's states to the axis's first card and combines them there in
states order (``kernels/merge.py``), so no collective runs over it.
Functions, not module-level constants, so importing this module never
touches CUDA or the process group.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, List, Tuple

import torch

if TYPE_CHECKING:
    from ..ml.sharding import MeshShape

__all__ = ["make_production_mesh", "make_local_mesh", "local_mesh_shape",
           "production_mesh_shape", "make_exec_mesh",
           "default_exec_partitions"]


def _world_size() -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError(
            "an ML mesh spans the ranks of a process group: start the "
            "processes with python -m torch.distributed.run (or call "
            "torch.distributed.init_process_group) first")
    return dist.get_world_size()


def _mesh(device: str, shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over ranks 0 … prod(shape)-1."""
    from torch.distributed.device_mesh import DeviceMesh
    kind = torch.device(device).type
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(kind, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def production_mesh_shape(multi_pod: bool = False) -> MeshShape:
    """16×16 = 256 chips/pod; multi-pod adds a leading 2-pod axis."""
    from ..ml.sharding import MeshShape
    return MeshShape((2, 16, 16) if multi_pod else (16, 16))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh over the process group's ranks, which must
    number 256 (512 multi-pod)."""
    shape = production_mesh_shape(multi_pod)
    sizes = tuple(shape.shape.values())
    need = 1
    for s in sizes:
        need *= s
    world = _world_size()
    if world != need:
        raise ValueError(f"the production mesh {shape.shape} needs {need} "
                         f"ranks; this process group has {world}")
    return _mesh(device, sizes, shape.axis_names)


def local_mesh_shape(data: int, model: int, n: int) -> Tuple[int, int]:
    """The reference's clamp: ``data`` to the ``n`` devices there are,
    then ``model`` to what is left."""
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return data, model


def make_local_mesh(data: int = 1, model: int = 1, device="cuda"):
    """Small ``("data", "model")`` mesh over the process group's first
    data × model ranks (tests, training on a few cards), clamped as
    :func:`local_mesh_shape` says to the group's size."""
    shape = local_mesh_shape(data, model, _world_size())
    return _mesh(device, shape, ("data", "model"))


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
