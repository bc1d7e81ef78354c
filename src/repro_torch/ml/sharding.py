"""Sharding rules: logical parameter/activation axes → mesh axes.

The port of ``repro/ml/sharding.py`` on ``torch.distributed`` device
meshes.  Mesh: ``(data, model)`` single-pod (16×16) or ``(pod, data,
model)`` multi-pod (2×16×16).  Batch shards over (pod, data);
tensor-parallel dims shard over model:

  * attention QKV out-dim and O in-dim → model (Megatron col/row split)
  * MLP hidden dim → model
  * vocab dim of embedding & lm_head → model
  * MoE expert dim → model (expert parallelism)
  * KV caches: batch → data, kv-heads → model

Rules are *path-based*: ``param_specs`` walks the params tree and matches
leaf path names (``blocks.slot0.attn.wq``), so every architecture (dense
/ MoE / SSM / hybrid) gets specs without per-arch plumbing.  ``zero1``
additionally shards optimizer state over the data axis (ZeRO-1).

A spec is a value, the reference's ``PartitionSpec`` as a tuple: one
entry per tensor dim (trailing dims may be left out), each None, an axis
name or a tuple of axis names.  :func:`placements` turns a spec into the
DTensor placements of a ``DeviceMesh`` (one ``Shard(d)`` or
``Replicate()`` per mesh dim), which is how ``ModelBundle`` stores
parameters, optimizer state and batches.  The rules read a mesh only
through its axis names and sizes, so they take a ``DeviceMesh`` or a
:class:`MeshShape` (names and sizes, no ranks — the counterpart of
``AbstractMesh``, for the production meshes' rules without 256 ranks).

:func:`constrain` is the reference's ``with_sharding_constraint``: on the
active mesh it ``redistribute``s a DTensor to the placements its dims
give; without a mesh, or for a plain tensor, it returns its input.
"""
from __future__ import annotations

import contextlib
import math
import re
import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["MeshShape", "mesh_sizes", "batch_axes", "batch_spec",
           "param_specs",
           "act_spec", "cache_specs", "NONE_SPEC", "zero1_specs",
           "extend_specs", "constrain", "active_mesh", "set_active_mesh",
           "using_mesh", "placements", "leaf_items", "map_with_path",
           "spec_divisor", "cache_spec_leaf", "place_caches", "is_dtensor",
           "unflatten_heads", "merge_heads", "batch_cut_only", "canonical",
           "on_pieces"]

NONE_SPEC: Tuple = ()

# Ambient mesh for activation-sharding constraints inside model code.
# Set by ModelBundle's step functions; None otherwise (constraints no-op).
_ACTIVE_MESH: list = [None]


class MeshShape:
    """A mesh's axis names and sizes without devices: ``MeshShape((16,
    16))`` is ``("data", "model")``, ``MeshShape((2, 16, 16))`` adds a
    leading ``"pod"``."""

    def __init__(self, shape: Sequence[int],
                 axis_names: Optional[Sequence[str]] = None):
        shape = tuple(int(s) for s in shape)
        if axis_names is None:
            axis_names = ("pod", "data", "model")[-len(shape):]
        if len(axis_names) != len(shape):
            raise ValueError(f"{len(shape)} sizes for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))

    def __repr__(self):
        return f"MeshShape({self.shape})"


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name → size, in mesh order, of a ``MeshShape`` or a
    ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return dict(mesh.shape)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the rules need a mesh with named dims")
    return dict(zip(names, tuple(mesh.shape)))


def set_active_mesh(mesh):
    _ACTIVE_MESH[0] = mesh


def active_mesh():
    return _ACTIVE_MESH[0]


@contextlib.contextmanager
def using_mesh(mesh):
    """``mesh`` active inside the block, the previous one after it."""
    prev = _ACTIVE_MESH[0]
    _ACTIVE_MESH[0] = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH[0] = prev


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes the global batch shards over."""
    names = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def batch_spec(mesh, size: int):
    """The spec entry of a batch dim of ``size``: the batch axes where
    their product divides it, else None (replicated)."""
    sizes = mesh_sizes(mesh)
    ax = batch_axes(mesh)
    n = math.prod(sizes[a] for a in ax) if ax else 1
    return ax if ax and size % n == 0 else None


def spec_divisor(spec, mesh) -> int:
    """How many pieces ``spec`` cuts a tensor into on ``mesh``."""
    sizes = mesh_sizes(mesh)
    n = 1
    for ax in spec or ():
        for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
            n *= sizes[a]
    return n


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor — without importing DTensor's module
    (a second on first import): no DTensor exists before it is."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def placements(spec, mesh):
    """A spec → one DTensor placement per dim of ``mesh``: ``Shard(d)``
    for the mesh dim a tensor dim ``d`` names, else ``Replicate()``.  A
    tensor dim split over several mesh dims (the batch over ``("pod",
    "data")``) is cut row-major over them, the first named outermost —
    DTensor's order when those mesh dims come in that order, which the
    rules' specs always do.  A mesh dim of size 1 cuts nothing and is
    ``Replicate()`` whatever the spec names (the same layout; DTensor's
    propagation treats a ``Shard`` there as a cut and refuses views across
    it)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_sizes(mesh)
    names = list(sizes)
    out = [Replicate() for _ in names]
    for d, ax in enumerate(spec or ()):
        axes = ax if isinstance(ax, tuple) else (ax,) if ax else ()
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} is split over {axes}, "
                             f"against the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: axis {names[i]!r} twice")
            out[i] = Shard(d)
    return tuple(p if sizes[names[i]] > 1 else Replicate()
                 for i, p in enumerate(out))


def constrain(x, dims):
    """Pin an intermediate's sharding: ``dims`` per-axis ∈ {None, "batch",
    "model"}.  No-op without an active mesh or for a plain tensor; axes
    that don't divide are dropped.  This is how recurrent carries
    (mLSTM C, Mamba h) and attention's online-softmax state stay sharded
    instead of replicated."""
    mesh = _ACTIVE_MESH[0]
    if mesh is None or not is_dtensor(x):
        return x
    sizes = mesh_sizes(mesh)
    spec = []
    for size, d in zip(x.shape, dims):
        if d == "batch":
            ax = batch_axes(mesh)
            n = math.prod(sizes[a] for a in ax) if ax else 1
            spec.append(ax if n > 1 and size % n == 0 else None)
        elif d == "model" and "model" in sizes:
            n = sizes["model"]
            spec.append("model" if size % n == 0 and size >= n else None)
        else:
            spec.append(None)
    return x.redistribute(x.device_mesh, placements(tuple(spec), mesh))


# Leaf-name patterns → (sharded_dim_from_end, description).
# Dims are indexed from the end so stacked params with a leading group
# dim match the same rules.
_RULES = [
    (r"\bembed\b",        2, "vocab"),          # [V, D] → V on model
    (r"\blm_head\b",      1, "vocab"),          # [D, V] → V on model
    # NOTE: ordered — the experts rule must precede w_gate/w_up/w_down,
    # or expert FFN weights match the dense-FFN rules and EP never engages
    (r"\bexperts?\.",     3, "experts"),        # [E, ., .] → E on model
    (r"\bw(q|k|v)\b",     1, "heads"),          # [D, H*hd] → out on model
    (r"\bw(q|k|v)_bias\b", 1, "heads"),
    (r"\bwo\b",           2, "heads"),          # [H*hd, D] → in on model
    (r"\bw_gate\b",       1, "ffn"),            # [D, F]
    (r"\bw_up\b",         1, "ffn"),
    (r"\bw_down\b",       2, "ffn"),            # [F, D]
    (r"\brouter\b",       1, "experts"),        # [D, E]
    (r"\bin_proj\b",      1, "ssm_inner"),      # [D, 2*dI]
    (r"\bout_proj\b",     2, "ssm_inner"),      # [dI, D]
    (r"\bx_proj\b",       2, "ssm_inner"),      # [dI, R]
    (r"\bdt_proj\b",      1, "ssm_inner"),      # [R, dI] → dI on model
    (r"\bconv_w\b",       2, "ssm_inner"),      # [dI, K]
    (r"\bA_log\b",        2, "ssm_inner"),      # [dI, N]
    (r"\bD_skip\b",       1, "ssm_inner"),      # [dI]
    (r"\b(wi|wf|wo_gate)\b", 1, "heads"),       # xlstm gate projections
    (r"\bw_upA\b",        1, "ffn"),
    (r"\bw_upB\b",        1, "ffn"),
]


def leaf_items(tree, prefix=()):
    """(path tuple, leaf) of nested dicts, in order (a spec, a tuple, is
    a leaf)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_items(v, prefix + (str(k),))
    else:
        yield prefix, tree


def map_with_path(fn, tree, *rest, prefix=()):
    """``fn(path tuple, leaf, *rest leaves)`` over nested dicts (a spec,
    a tuple, is a leaf)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 prefix=prefix + (str(k),))
                for k, v in tree.items()}
    return fn(prefix, tree, *rest)


def _spec_for(path: str, ndim: int, shape, model_size: int,
              model_axis: str = "model") -> Tuple:
    for pat, dim_from_end, _ in _RULES:
        if re.search(pat, path):
            if ndim >= dim_from_end:
                d = ndim - dim_from_end
                if shape[d] % model_size == 0:
                    axes: list = [None] * ndim
                    axes[d] = model_axis
                    return tuple(axes)
                # primary dim not divisible (e.g. 8 kv heads on a 16-way
                # axis): fall back to the largest divisible dim, else
                # replicate — the reference's pjit rejects uneven shards.
                order = sorted(range(ndim), key=lambda i: -shape[i])
                for d2 in order:
                    if shape[d2] % model_size == 0 and shape[d2] >= \
                            model_size:
                        axes = [None] * ndim
                        axes[d2] = model_axis
                        return tuple(axes)
                return ()
    return ()   # replicated (norms, small biases, scalars)


def param_specs(params_shape, mesh):
    """Params (tensors, or meta tensors of their shapes) → the matching
    tree of specs."""
    sizes = mesh_sizes(mesh)
    model_size = sizes.get("model", 1)

    def fn(path, leaf):
        if "model" not in sizes:
            return ()
        return _spec_for(".".join(path), len(leaf.shape), leaf.shape,
                         model_size)

    return map_with_path(fn, params_shape)


def cache_spec_leaf(path, leaf, mesh) -> Tuple:
    """Per-leaf cache specs: batch → (pod,data); heads/channels → model.

    When the batch is too small for the data axes (B=1), KV caches switch
    to a *sequence-parallel* layout: the cache length shards over (pod,
    data) — context parallelism.  ``path`` is the leaf's key path.
    """
    name = path[-1]
    sizes = mesh_sizes(mesh)
    batch = batch_axes(mesh)
    n_batch = math.prod(sizes[a] for a in batch) if batch else 1
    n_model = sizes.get("model", 1)
    shape = tuple(leaf.shape)
    nd = len(shape)
    b = shape[1] if nd >= 2 else 1
    seq_parallel = b < n_batch

    def div(i):
        return shape[i] % n_model == 0 and shape[i] >= n_model

    if name in ("k", "v", "cross_k", "cross_v"):    # [G,B,H,S,hd]
        # heads over model when the count divides; otherwise the cache
        # length over model (flash-decode style context parallelism)
        head_ax = "model" if div(2) else None
        seq_model = None if head_ax else "model"
        if seq_parallel:
            seq = tuple(a for a in batch if a) + \
                ((seq_model,) if seq_model else ())
            return (None, None, head_ax, seq, None)
        return (None, batch, head_ax,
                seq_model if seq_model and div(3) else None, None)
    bspec = None if seq_parallel else batch
    if name == "h" and nd == 4:                     # mamba [G,B,dI,N]
        return (None, bspec, "model" if div(2) else None, None)
    if name == "conv":                              # [G,B,K-1,dI]
        return (None, bspec, None, "model" if div(3) else None)
    if name == "C":                                 # mlstm [G,B,H,dk,dv]
        return (None, bspec, "model" if div(2) else None,
                "model" if not div(2) and div(3) else None, None)
    if name == "n" and nd == 4:
        return (None, bspec, "model" if div(2) else None,
                "model" if not div(2) and div(3) else None)
    if nd >= 2:                                     # slstm scalars [G,B,D]
        return (None, bspec)
    return ()


def unflatten_heads(t, heads: int):
    """``t`` [..., H·hd] → [..., H, hd].  A DTensor whose last dim is cut
    into pieces that are not whole heads (15 heads over 4 ranks, 4 over
    16) is gathered over the mesh dims that cut it first: DTensor refuses
    the uneven view, where the reference's GSPMD gathers on its own."""
    *lead, last = t.shape
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate
        d = t.dim() - 1
        n = math.prod(t.device_mesh.size(i) for i, p in
                      enumerate(t.placements) if p.is_shard(d))
        if heads % n:
            t = t.redistribute(t.device_mesh, [
                Replicate() if p.is_shard(d) else p for p in t.placements])
    return t.reshape(*lead, heads, last // heads)


def batch_cut_only(t):
    """A DTensor with every cut but its batch dim's (dim 0) gathered and
    partial sums summed; a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [
        p if p.is_shard(0) else Replicate() for p in t.placements])


def canonical(t):
    """``t`` contiguous with the strides ``torch.empty`` gives its shape.
    A rank's piece handed to DTensor (``local_map``'s outputs and input
    gradients) sets the DTensor's global strides, and DTensor views by
    those later: a piece with other strides (a permuted product, a
    contiguous tensor's size-1 dim) makes such a view fail."""
    want, acc = [], 1
    for n in reversed(t.shape):
        want.append(acc)
        acc *= max(n, 1)
    want = tuple(reversed(want))
    if t.stride() == want:
        return t
    if t.is_contiguous():
        return t.as_strided(t.shape, want, t.storage_offset())
    return t.clone(memory_format=torch.contiguous_format)


class _CanonicalGrad(torch.autograd.Function):
    """The identity, whose gradient is made :func:`canonical`."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return canonical(g)


def on_pieces(fn, mesh, in_placements, out_placements,
              in_grad_placements=None):
    """``fn`` run by each rank on its own pieces (``local_map``): the
    DTensor arguments brought to ``in_placements`` first (one list a
    argument), the outputs at ``out_placements`` (a list for one output,
    a tuple of lists for several), the arguments' gradients at
    ``in_grad_placements`` (default: ``in_placements``) — what the pieces'
    gradients are, e.g. a partial sum over the mesh dims whose ranks saw
    only some of the rows that touched a whole weight.  The outputs and
    the arguments' gradients are made :func:`canonical`."""
    from torch.distributed.tensor.experimental import local_map

    def run(*pieces):
        out = fn(*(_CanonicalGrad.apply(t) if t.requires_grad else t
                   for t in pieces))
        if isinstance(out, tuple):
            return tuple(canonical(t) for t in out)
        return canonical(out)

    mapped = local_map(run, out_placements=out_placements,
                       in_placements=tuple(in_placements),
                       in_grad_placements=tuple(in_grad_placements
                                                or in_placements),
                       device_mesh=mesh)
    return lambda *args: mapped(*(
        a.redistribute(mesh, list(p)) if is_dtensor(a) else a
        for a, p in zip(args, in_placements)))


def merge_heads(t):
    """``t`` [..., H, hd] → [..., H·hd], the inverse of
    :func:`unflatten_heads` both ways: the gradient, which a row-parallel
    product hands back cut along H·hd, is split into heads by
    :func:`unflatten_heads` (gathered where its pieces are not whole
    heads)."""
    if not is_dtensor(t):
        return t.reshape(*t.shape[:-2], -1)
    return _MergeHeads.apply(t)


class _MergeHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.heads = x.shape[-2]
        return x.reshape(*x.shape[:-2], -1)

    @staticmethod
    def backward(ctx, g):
        return unflatten_heads(g, ctx.heads)


def place_caches(caches, mesh):
    """Fresh (zero) caches, the same on every rank, → DTensors laid out
    by :func:`cache_spec_leaf` on ``mesh`` (each rank keeps its piece)."""
    from torch.distributed.tensor import distribute_tensor
    return map_with_path(
        lambda path, t: distribute_tensor(
            t, mesh, placements(cache_spec_leaf(path, t, mesh), mesh),
            src_data_rank=None), caches)


def act_spec(mesh, *more_axes) -> Tuple:
    """Activation spec: batch over (pod, data), then given axes."""
    return (batch_axes(mesh), *more_axes)


def cache_specs(mesh) -> Tuple:
    """KV cache spec: [B, Hkv, S, hd] → batch on (pod,data), heads on
    model."""
    return (batch_axes(mesh), "model", None, None)


def extend_specs(specs, mesh, params_shape, axis: str = "data"):
    """Shard each leaf's largest unsharded divisible dim over ``axis``.

    Applied to optimizer moments this is **ZeRO-1**; applied to the
    parameters themselves it is **FSDP** (weights gathered per layer
    inside the step, stored 1/data-fraction per device).
    """
    size = mesh_sizes(mesh).get(axis, 1)

    def fn(_, spec, leaf):
        shape = tuple(leaf.shape)
        if size <= 1 or len(shape) == 0:
            return spec
        cur = list(spec) + [None] * (len(shape) - len(spec))
        # the largest dim not already sharded & divisible by axis; among
        # equal dims numpy's default (unstable) argsort picks, as in the
        # reference
        order = np.argsort([-s for s in shape])
        for d in order:
            if cur[d] is None and shape[d] % size == 0 and shape[d] >= size:
                cur[d] = axis
                return tuple(cur)
        return spec

    return map_with_path(fn, specs, params_shape)


def zero1_specs(specs, mesh, params_shape):
    return extend_specs(specs, mesh, params_shape, "data")
