"""The system under test, reached through its own entry points.

This is the only module of the benchmark that imports the port
(``repro_torch``): its ``ArchConfig``, ``launch.serve.Server``,
``ml.model.ModelBundle``, ``ml.transformer.LM``, ``ml.sharding`` and
``launch.mesh``.  The benchmark hands them its own weights, made from the
seed (``harness.weights``), in the port's parameter layout.

On a mesh (a cell on several cards, one process a card) ``Server`` takes
no mesh and no parameters of its own yet, so :func:`mesh_server` builds
it at the port's reduced size on the host and gives it, in place of what
it made, the model on the mesh (``LM(cfg, mesh=mesh)``) and the
benchmark's weights placed by the port's parameter rules
(``ml.sharding.param_specs``, a leaf at a time).  Its ``generate_batch``
and ``serve`` run as they are; each prefill and decode step runs on the
mesh as ``ModelBundle``'s serving steps run it (the mesh active,
tokens placed by the batch rule) and hands the server its logits whole.
"""
from __future__ import annotations

import gc

import torch

from . import weights
from .model import Dims, mesh_shape


def arch_config(dims: Dims, act_dtype: str = "bfloat16"):
    from repro_torch.configs.base import ArchConfig
    per = dims.period
    moe_every = 1
    if dims.experts:
        moe_every = next(p for p in range(1, dims.layers + 1)
                         if all(dims.moe[i] == (i % p == p - 1)
                                for i in range(dims.layers)))
    if any(k == "mamba" for k in dims.kinds) \
            and dims.dt_rank != max(1, dims.d // 16):
        raise ValueError(f"{dims.name}: the port's Mamba takes dt_rank "
                         f"d // 16, not {dims.dt_rank}")
    family = "hybrid" if "mamba" in dims.kinds else \
        ("moe" if dims.experts else "dense")
    return ArchConfig(
        name=dims.name, family=family, num_layers=dims.layers,
        d_model=dims.d, num_heads=dims.heads, num_kv_heads=dims.kv_heads,
        d_ff=dims.d_ff, vocab_size=dims.vocab, head_dim=dims.hd,
        block_pattern=tuple(dims.kinds[:per]),
        moe_experts=dims.experts, moe_top_k=dims.top_k, moe_every=moe_every,
        moe_capacity_factor=dims.capacity_factor,
        moe_group_size=dims.group_size, ssm_state=dims.d_state,
        ssm_conv=dims.d_conv, ssm_expand=dims.expand,
        ssm_chunk=dims.ssm_chunk, pos=dims.pos, rope_theta=dims.rope_theta,
        norm_eps=dims.eps, tie_embeddings=dims.tie, act="silu",
        act_dtype=act_dtype)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def server(dims: Dims, max_batch: int, seed: int, device: torch.device):
    """A ``Server`` at full size, serving the benchmark's weights.
    ``Server.__init__`` makes weights of its own, which are dropped
    before the benchmark's are made."""
    from repro_torch.launch.serve import Server
    srv = Server(arch_config(dims), reduced=False, max_batch=max_batch,
                 max_len=dims.context, seed=int(seed) % 2 ** 63,
                 device=device)
    srv.params = None
    free(device)
    srv.params = weights.make(dims, seed, device, "serve")
    return srv


def mesh_of(config: dict, device: torch.device):
    """The ``("data", "model")`` mesh that the configuration's
    ``deployment`` states, over the process group's ranks, or None for a
    configuration served on one card."""
    data, model = mesh_shape(config)
    if data * model == 1:
        return None
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh(data, model, device=device.type)


def mesh_params(dims: Dims, seed: int, mesh, device: torch.device,
                purpose: str = "serve"):
    """The benchmark's weights on ``mesh``: each leaf made whole (the one-
    device sequence, :func:`weights.made`), this rank's piece of it cut
    by the port's parameter rules and kept, the whole leaf freed before
    the next is made.  Inference tensors, as ``Server.generate_batch``
    runs under ``torch.inference_mode``."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.ml import sharding as sh
    out: dict = {}
    with torch.inference_mode():
        for path, t in weights.made(dims, seed, device, purpose):
            nest: dict = {}
            weights.put(nest, path, t)
            spec = sh.param_specs(nest, mesh)
            for k in path:
                spec = spec[k]
            pl = sh.placements(spec, mesh)
            piece = distribute_tensor(t, mesh, pl,
                                      src_data_rank=None).to_local()
            if any(p.is_shard() for p in pl):
                piece = piece.clone()     # not a view of the whole leaf
            del t
            weights.put(out, path, DTensor.from_local(piece, mesh, pl,
                                                      run_check=False))
    return out


def _steps_on_mesh(lm, mesh) -> None:
    """``lm``'s prefill and decode step run with ``mesh`` active (plain
    tensors taken as replicated beside the DTensors), the tokens placed
    by the batch rule (``ml.sharding.batch_spec``: rows over the batch
    axes where they divide), the logits handed back whole."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.ml import sharding as sh
    prefill, decode = lm.prefill, lm.decode_step

    def rows(tokens):
        spec = (sh.batch_spec(mesh, tokens.shape[0]),)
        return distribute_tensor(tokens, mesh, sh.placements(spec, mesh),
                                 src_data_rank=None)

    def on_mesh_prefill(p, tokens, frames=None):
        with sh.using_mesh(mesh), implicit_replication():
            logits, caches = prefill(p, rows(tokens), frames)
            return logits.full_tensor(), caches

    def on_mesh_decode(p, tokens, caches, pos):
        with sh.using_mesh(mesh), implicit_replication():
            logits, caches = decode(p, rows(tokens), caches, pos)
            return logits.full_tensor(), caches

    lm.prefill, lm.decode_step = on_mesh_prefill, on_mesh_decode


def mesh_server(dims: Dims, max_batch: int, seed: int, mesh,
                device: torch.device):
    """A ``Server`` at full size on ``mesh``, serving the benchmark's
    weights (module docstring)."""
    params = mesh_params(dims, seed, mesh, device)
    return server_on_mesh(arch_config(dims), params, max_batch,
                          dims.context, seed, mesh, device)


def server_on_mesh(cfg, params, max_batch: int, max_len: int, seed: int,
                   mesh, device: torch.device):
    """A ``Server`` of ``cfg`` on ``mesh`` serving ``params`` (placed on
    the mesh)."""
    from repro_torch.launch.serve import Server
    from repro_torch.ml.transformer import LM
    srv = Server(cfg, reduced=True, max_batch=max_batch, max_len=max_len,
                 seed=int(seed) % 2 ** 63, device="cpu")
    srv.device, srv.cfg, srv.params = device, cfg, params
    srv.lm = LM(cfg, mesh=mesh)
    _steps_on_mesh(srv.lm, mesh)
    return srv


def bundle(dims: Dims, train_cfg: dict, device: torch.device):
    """A ``ModelBundle`` for the train step (``impl`` and the
    ``TrainConfig`` fields from the traffic mix)."""
    from repro_torch.ml.model import ModelBundle, TrainConfig
    cfg = dict(train_cfg)
    impl = cfg.pop("impl", "reference")
    return ModelBundle(arch_config(dims), impl=impl,
                       train_cfg=TrainConfig(**cfg), device=device)

