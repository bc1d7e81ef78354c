"""Model bundle: arch config → train / prefill / decode step functions,
on one device or on a ``torch.distributed`` device mesh.

The port of ``repro/ml/model.py``.  This is the layer ``launch.train``
drives: it owns the parameters' dtypes and shardings, the optimizer state
and the training step (chunked CE loss, MoE aux losses, clipping, cosine
schedule, AdamW, optional ZeRO-1 / FSDP / int8 error-feedback grad
compression), and the serving steps.

On a mesh (a ``DeviceMesh`` with ``data``/``model`` dims, ``pod`` in
front for the multi-pod shape) parameters, optimizer state, caches and
batches are DTensors placed by ``ml.sharding``'s rules:
``param_shardings``, ``opt_shardings``, ``cache_shardings`` and
``_data_sharding`` give (mesh, placements) pairs, and ``shard_params`` /
``shard_opt_state`` / ``shard_batch`` place trees by them (the
reference's ``jax.jit(in_shardings=…)``; the LM makes its caches on the
mesh by the same cache rule).  The steps run the
one-device code on DTensors (plain constants count as replicated).
Gradients come back from autograd partial over the batch axes; the step
brings them to the moments' placements — a reduce-scatter under
``zero1`` — updates there and brings the new parameters back to theirs.
``fsdp`` also stores the parameters over ``data``, and the LM gathers
each block's weights to their model-axis placements at use.
``seq_parallel`` pins the activations' sequence over ``model`` between
block groups.  A mesh step differs from the one-device step by the order
of float32 sums only.

The LM trains through ``impl="reference"`` (the plain, differentiable
chunked attention and associative Mamba scan), as the reference's bundle
does.  With ``impl="kernel"`` the serving steps reach the hand-written
kernels, on a mesh on each rank's pieces (``attention._attention``,
``mamba.mamba_apply``); the kernels have no backward, so on a mesh the
train step of a model that reaches them raises their no-backward error
(on one device the wrappers raise it for CUDA tensors under grad).

The dry-run (``launch.dryrun``): :func:`input_specs` gives every model
input of an (arch × shape) cell as a meta tensor, and ``lower_train`` /
``lower_prefill`` / ``lower_decode`` run the bundle's own step once on
fake tensors, placed by the bundle's shardings, under the dry-run's
counter → a :class:`Lowered` record (the reference's
``.lower().compile()`` and its memory and cost analyses).
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from .. import tracing
from ..configs.base import ArchConfig, ShapeConfig
from ..kernels import _build
from . import sharding as sh
from .losses import chunked_lm_loss
from .optim import (adamw_init, adamw_update, clip_by_global_norm,
                    compress_ef, cosine_schedule, ef_init, tree_leaves,
                    tree_map)
from .sharding import cache_spec_leaf as _cache_spec_leaf
from .transformer import LM

__all__ = ["ModelBundle", "TrainConfig", "Lowered", "input_specs"]


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Meta tensors (shapes and dtypes, no data) for every model input of
    this cell, with the reference's keys: ``tokens`` (and ``labels`` to
    train) [B, S] int32, ``tokens`` [B, 1] to decode, an encoder-decoder
    config's ``frames`` [B, S, D] bf16 unless decoding, M-RoPE
    ``positions`` [3, B, S] int32 to train."""
    b, s = shape.global_batch, shape.seq_len

    def meta(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    out: Dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        out["tokens"] = meta(b, s)
        out["labels"] = meta(b, s)
    elif shape.kind == "prefill":
        out["tokens"] = meta(b, s)
    else:  # decode
        out["tokens"] = meta(b, 1)
    if cfg.frontend == "audio_stub" and shape.kind != "decode":
        out["frames"] = meta(b, s, cfg.d_model, dtype=torch.bfloat16)
    if cfg.mrope and shape.kind == "train":
        out["positions"] = meta(3, b, s)
    return out


@dataclass
class Lowered:
    """One step of a cell as the dry-run counted it, on one rank (the
    counterpart of the reference's compiled program and its analyses).

    ``memory``: ``argument_bytes`` (the rank's local parameters,
    optimizer state, caches and inputs), ``output_bytes`` (the new trees
    the step returns), ``temp_bytes`` (the peak of live local bytes during
    the step above the arguments) and ``peak_bytes`` = argument + temp.
    The reference donates its parameters and optimizer state (or its
    caches); the port's train step returns new trees and leaves its
    inputs alone, so the peak is what the port's real step holds: the
    arguments the caller keeps until the step returns, beside the new
    trees and every temporary.  (The decode step writes its caches in
    place, as the reference's donated ones.)
    ``cost``: ``flops_per_device`` (matrix products) and
    ``bytes_per_device``.  ``collectives``: ``per_kind`` {kind: count,
    operand bytes} and ``total_bytes``.  ``analyzed``: the same numbers in
    ``hlo_analysis.analyze_hlo``'s keys, with ``warnings``.  ``seconds``:
    the host time of the fake step."""
    kind: str
    memory: Dict
    cost: Dict
    collectives: Dict
    analyzed: Dict
    seconds: float = 0.0
    counts: Dict = field(default_factory=dict)

    @property
    def record(self) -> Dict:
        """The record's ``memory``, ``cost``, ``analyzed`` and
        ``collectives`` entries."""
        return {"memory": self.memory, "cost": self.cost,
                "analyzed": self.analyzed, "collectives": self.collectives}


@dataclass
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0
    weight_decay: float = 0.1
    loss_chunk: Optional[int] = 2048
    moe_lb_weight: float = 0.01
    moe_z_weight: float = 1e-3
    zero1: bool = False
    fsdp: bool = False              # shard weights over data (gather/layer)
    param_dtype: str = "float32"    # bfloat16 = mixed precision (f32 moments)
    seq_parallel: bool = True       # shard activations' seq dim over model
    compress_grads: bool = False
    remat: str = "dots"             # none | dots | full


def _full(x):
    """A DTensor's whole value on every rank (a collective); a plain
    tensor as it is."""
    return x.full_tensor() if sh.is_dtensor(x) else x


def _to_placement(t, like):
    """DTensor ``t`` redistributed to ``like``'s placements."""
    return t.redistribute(like.device_mesh, like.placements)


def _device_of(mesh, device) -> torch.device:
    """The device this process computes on: its card for a CUDA
    ``DeviceMesh`` (one process per card), the CPU for a CPU mesh,
    ``device`` without a mesh or for a :class:`~.sharding.MeshShape`."""
    kind = getattr(mesh, "device_type", None)
    if kind == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    if kind is not None:
        return torch.device(kind)
    return torch.device(device)


class ModelBundle:
    """``cfg`` + ``train_cfg`` → parameters (on ``device`` — the card unless
    the caller asks for the CPU — or, with a ``mesh``, on this process's
    device of the mesh) and the step functions.  ``mesh`` may also be a
    :class:`~.sharding.MeshShape`, for the specs alone."""

    def __init__(self, cfg: ArchConfig, mesh=None, *,
                 impl: str = "reference",
                 train_cfg: Optional[TrainConfig] = None, device="cuda"):
        self.cfg = cfg
        self.mesh = mesh
        self.device = _device_of(mesh, device)
        self.train_cfg = train_cfg or TrainConfig()
        self.lm = LM(cfg, impl=impl, remat=self.train_cfg.remat, mesh=mesh,
                     seq_parallel=self.train_cfg.seq_parallel)
        self._use_placements = None
        if mesh is not None and self.train_cfg.fsdp:
            self.lm.gather = self._gather
        #: the port's spans and counters (``repro_torch.tracing``)
        self.tracing = tracing

    # ------------------------------------------------------------ shapes
    def init_params(self, seed: int = 0):
        """Seeded random float32 parameters, cast as ``param_dtype``
        says — plain tensors, the same numbers on every rank and on one
        device; ``shard_params`` places them on the mesh."""
        return self._cast_params(self.lm.init(seed, self.device,
                                              dtype=torch.float32))

    def _cast_params(self, params):
        if self.train_cfg.param_dtype == "float32":
            return params
        dt = getattr(torch, self.train_cfg.param_dtype)

        def cast(x):
            # matrices → bf16 (matmul sites cast activations to match);
            # vectors (norms, biases, A_log, …) stay f32 for stability
            return x.to(dt) if x.dim() >= 2 and x.dtype == torch.float32 \
                else x

        return tree_map(cast, params)

    def params_shape(self):
        """The parameters as meta tensors (shapes and dtypes, no data):
        ``init_params`` traced without allocating."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            fake = self._cast_params(self.lm.init(0, "cpu",
                                                  dtype=torch.float32))
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), fake)

    def init_opt_state(self, params):
        opt = {"adam": adamw_init(params)}
        if self.train_cfg.compress_grads:
            opt["ef"] = ef_init(params)
        return opt

    # --------------------------------------------------------- shardings
    def param_specs(self, params_shape=None):
        """The parameters' specs: the model-axis rules, plus the data
        axis under ``fsdp``."""
        shape = params_shape if params_shape is not None \
            else self.params_shape()
        specs = sh.param_specs(shape, self.mesh)
        if self.train_cfg.fsdp:
            specs = sh.extend_specs(specs, self.mesh, shape, "data")
        return specs

    def opt_specs(self, params_shape=None):
        """The moments' specs: the parameters', with the data axis under
        ``fsdp`` or ``zero1``."""
        shape = params_shape if params_shape is not None \
            else self.params_shape()
        specs = self.param_specs(shape)
        if self.train_cfg.zero1 and not self.train_cfg.fsdp:
            specs = sh.zero1_specs(specs, self.mesh, shape)
        return specs

    def _placed(self, specs):
        return sh.map_with_path(
            lambda _, s: (self.mesh, sh.placements(s, self.mesh)), specs)

    def param_shardings(self):
        return self._placed(self.param_specs())

    def opt_shardings(self, params_shape=None):
        m = self._placed(self.opt_specs(params_shape))
        return {"m": m, "v": m,
                "step": (self.mesh, sh.placements((), self.mesh))}

    def opt_state_shardings(self, params_shape=None):
        """Shardings of ``init_opt_state``'s whole tree."""
        adam = self.opt_shardings(params_shape)
        out = {"adam": adam}
        if self.train_cfg.compress_grads:
            out["ef"] = adam["m"]
        return out

    def cache_shardings(self, caches_shape):
        return sh.map_with_path(
            lambda path, leaf: (self.mesh, sh.placements(
                _cache_spec_leaf(path, leaf, self.mesh), self.mesh)),
            caches_shape)

    def _data_sharding(self, ndim: int, batch_dim: int = 0,
                       batch_size: Optional[int] = None):
        axes: list = [None] * ndim
        baxes = sh.batch_axes(self.mesh)
        sizes = sh.mesh_sizes(self.mesh)
        n_batch = math.prod(sizes[a] for a in baxes) if baxes else 1
        if batch_size is None or batch_size % n_batch == 0:
            axes[batch_dim] = baxes
        # else: replicate (tiny-batch decode; cache is seq-parallel instead)
        return self.mesh, sh.placements(tuple(axes), self.mesh)

    @staticmethod
    def _place(tree, shardings, src_data_rank: Optional[int] = 0):
        """Each leaf of ``tree`` at its (mesh, placements): a plain tensor
        distributed (from rank ``src_data_rank``; None: each rank cuts its
        own piece of its own copy, no collective), a DTensor
        redistributed; a None sharding leaves the leaf as it is."""
        from torch.distributed.tensor import distribute_tensor

        def one(_, t, s):
            if s is None:
                return t
            if sh.is_dtensor(t):
                return t.redistribute(*s)
            return distribute_tensor(t, *s, src_data_rank=src_data_rank)

        return sh.map_with_path(one, tree, shardings)

    def shard_params(self, params, src_data_rank: Optional[int] = 0):
        return self._place(params, self.param_shardings(), src_data_rank)

    def shard_opt_state(self, opt_state, src_data_rank: Optional[int] = 0):
        return self._place(opt_state, self.opt_state_shardings(),
                           src_data_rank)

    def shard_batch(self, batch, src_data_rank: Optional[int] = 0):
        """A batch of plain tensors (the same on every rank) → DTensors,
        the batch dim over the batch axes (dim 1 of M-RoPE
        ``positions``)."""
        return {k: self._place(v, self._data_sharding(
            v.dim(), 1 if k == "positions" else 0,
            batch_size=v.shape[1 if k == "positions" else 0]), src_data_rank)
            for k, v in batch.items()}

    def _gather(self, path, tree):
        """FSDP's gather at use: ``tree`` (a leaf, or a block's slice
        [G] → [...] of the stacked tree at ``path``) to its model-axis
        placements."""
        if self._use_placements is None:
            use = {}
            for p, spec in sh.leaf_items(sh.param_specs(self.params_shape(),
                                                        self.mesh)):
                sliced = p[0] in ("blocks", "enc_blocks")
                use[p] = sh.placements(spec[1:] if sliced else spec,
                                       self.mesh)
            self._use_placements = use
        return sh.map_with_path(
            lambda sub, t: t.redistribute(
                self.mesh, self._use_placements[path + sub]), tree)

    @contextlib.contextmanager
    def _on_mesh(self):
        """The mesh active for the model's pins, and plain tensors (masks,
        positions, constants) taken as replicated beside DTensors."""
        if self.mesh is None:
            yield
            return
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with sh.using_mesh(self.mesh), implicit_replication():
            yield

    # ------------------------------------------------------------- train
    def _refuse_kernel_backward(self):
        """On a mesh with ``impl="kernel"``, raise the kernels'
        no-backward error when the model reaches a kernel."""
        kinds = set(self.cfg.block_pattern)
        names = [k for k, kind in (("flash_attention", "attn"),
                                   ("selective_scan", "mamba"))
                 if kind in kinds]
        if self.mesh is not None and self.lm.impl == "kernel" and names:
            raise _build.no_backward(" and ".join(names))

    def loss_and_grads(self, params, batch):
        """The training objective and its gradients → (total, loss, aux,
        grads): ``loss`` the chunked LM cross-entropy, ``total`` plus the
        MoE load-balance and router-z terms, ``grads`` of ``total`` in
        the params' tree (zeros for a leaf it does not reach).  On a mesh
        the gradients are DTensors as autograd leaves them (partial over
        the batch axes): ``full_tensor()`` gives a whole one."""
        self._refuse_kernel_backward()
        tc, lm = self.train_cfg, self.lm
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        with torch.enable_grad(), self._on_mesh():
            hid, aux = lm.hidden(live, batch["tokens"],
                                 batch.get("positions"),
                                 batch.get("frames"))
            loss = chunked_lm_loss(hid, lm.head(live), batch["labels"],
                                   chunk=tc.loss_chunk)
            total = loss + tc.moe_lb_weight * aux["load_balance"] \
                + tc.moe_z_weight * aux["router_z"]
            flat = torch.autograd.grad(total, leaves, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, flat)])
        grads = tree_map(lambda _: next(it), live)
        aux = {k: v.detach() for k, v in aux.items()}
        return total.detach(), loss.detach(), aux, grads

    def make_train_step(self):
        """→ ``train_step(params, opt_state, batch)`` → (new params, new
        opt state, metrics).  ``batch`` holds ``tokens`` and ``labels``
        [B, S] (and M-RoPE ``positions`` [3, B, S], an encoder-decoder
        config's ``frames`` [B, Se, D]) on the params' device.
        The inputs are not modified."""
        self._refuse_kernel_backward()
        tc = self.train_cfg
        lr_fn = cosine_schedule(tc.lr, tc.warmup, tc.total_steps)

        def step(params, opt_state, batch):
            total, loss, aux, grads = self.loss_and_grads(params, batch)
            params = tree_map(lambda t: t.detach(), params)
            new_opt = {}
            with torch.no_grad(), self._on_mesh():
                if self.mesh is not None:
                    # the update runs where the moments live: gradients
                    # reduced (scattered under zero1 / fsdp) and
                    # parameters sliced to the moments' placements
                    at_m = opt_state["adam"]["m"]
                    grads = tree_map(_to_placement, grads, at_m)
                    stored, params = params, tree_map(_to_placement,
                                                      params, at_m)
                if tc.compress_grads:
                    grads, new_opt["ef"] = compress_ef(grads,
                                                       opt_state["ef"])
                grads, gnorm = clip_by_global_norm(grads, tc.clip_norm)
                lr = lr_fn(opt_state["adam"]["step"] + 1)  # 1-indexed
                new_params, new_opt["adam"] = adamw_update(
                    params, grads, opt_state["adam"], lr,
                    weight_decay=tc.weight_decay)
                if self.mesh is not None:
                    # back to the parameters' own placements (an
                    # all-gather over data under zero1)
                    new_params = tree_map(_to_placement, new_params, stored)
            metrics = {"loss": loss, "total_loss": total,
                       "grad_norm": gnorm, "lr": lr,
                       "moe_lb": aux["load_balance"]}
            if self.mesh is not None:
                metrics = {k: _full(v) for k, v in metrics.items()}
            return new_params, new_opt, metrics

        def train_step(params, opt_state, batch):
            with tracing.span("train.step", self.device):
                return step(params, opt_state, batch)

        return train_step

    # ------------------------------------------------------------- serve
    def make_prefill(self):
        lm = self.lm

        def prefill(params, batch):
            with self._on_mesh():
                return lm.prefill(params, batch["tokens"],
                                  frames=batch.get("frames"))

        return prefill

    def make_decode_step(self):
        lm = self.lm

        def serve_step(params, caches, tokens, pos):
            with self._on_mesh():
                logits, caches = lm.decode_step(params, tokens, caches, pos)
                # the vocab whole on each rank: DTensor's argmax over a
                # cut dim reads a value on the host
                next_tok = torch.argmax(sh.batch_cut_only(logits),
                                        dim=-1).to(torch.int32)
            return next_tok, caches

        return serve_step

    # ----------------------------------------------------------- dry-run
    def lower_train(self, shape: ShapeConfig, **kw) -> Lowered:
        """One ``make_train_step`` step of the ``shape`` cell on fake
        tensors (parameters, ``init_opt_state``, ``input_specs``' batch,
        placed by the bundle's shardings) under the dry-run's counter."""
        return self._lower("train", shape, **kw)

    def lower_prefill(self, shape: ShapeConfig, **kw) -> Lowered:
        """One ``make_prefill`` call of the ``shape`` cell on fake
        tensors."""
        return self._lower("prefill", shape, **kw)

    def lower_decode(self, shape: ShapeConfig, **kw) -> Lowered:
        """One ``make_decode_step`` token against ``init_caches(B,
        seq_len)`` (cross K/V for ``seq_len`` encoder positions), at the
        cache's last position, on fake tensors."""
        return self._lower("decode", shape, **kw)

    def fake_args(self, kind: str, shape: ShapeConfig, seed: int = 0):
        """The step's arguments for a ``shape`` cell (fake tensors under
        a ``FakeTensorMode``), placed as a real step's are: ``(params,
        opt_state, batch)``, ``(params, batch)`` or ``(params, caches,
        tokens, pos)``.  The train step's parameters are
        ``init_params``' (float32, cast as ``param_dtype`` says), the
        serving steps' the LM's storage dtypes (``LM.init``: what
        ``launch.serve.Server`` and a mesh serve; the reference casts
        both as ``param_dtype`` says).  Without a mesh they lie on the
        CPU (the dry-run touches no card); on a mesh on its device type.
        Each rank cuts its own pieces (no collective)."""
        dev = "cpu" if self.mesh is None else self.device
        params = self._cast_params(self.lm.init(
            seed, dev, dtype=torch.float32)) if kind == "train" \
            else self.lm.init(seed, dev)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                 for k, v in input_specs(self.cfg, shape).items()}
        mesh = self.mesh is not None
        if kind == "train":
            opt = self.init_opt_state(params)
            if mesh:
                params = self.shard_params(params, None)
                opt = self.shard_opt_state(opt, None)
                batch = self.shard_batch(batch, None)
            return params, opt, batch
        if mesh:
            params = self.shard_params(params, None)
            batch = self.shard_batch(batch, None)
        if kind == "prefill":
            return params, batch
        enc_len = shape.seq_len if self.cfg.encoder_layers > 0 else None
        caches = self.lm.init_caches(shape.global_batch, shape.seq_len,
                                     dev, enc_len=enc_len)
        return params, caches, batch["tokens"], shape.seq_len - 1

    def _lower(self, kind: str, shape: ShapeConfig, *, seed: int = 0,
               alltoall_as_nccl: bool = True) -> Lowered:
        from torch._subclasses.fake_tensor import FakeTensorMode

        from ..launch.dryrun import StepCounter
        if kind != shape.kind:
            raise ValueError(f"lower_{kind} of a {shape.kind} shape "
                             f"({shape.name})")
        fn = {"train": self.make_train_step, "prefill": self.make_prefill,
              "decode": self.make_decode_step}[kind]()
        with FakeTensorMode():
            args = self.fake_args(kind, shape, seed)
            counter = StepCounter(alltoall_as_nccl=alltoall_as_nccl)
            t0 = time.perf_counter()
            with counter:
                counter.hold(args)
                out = fn(*args)
                counter.finish(out)
            seconds = time.perf_counter() - t0
        rec = counter.record()
        return Lowered(kind=kind, seconds=seconds, counts=counter.counts(),
                       **rec)
