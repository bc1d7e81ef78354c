"""Training launcher: checkpointed, restartable, elastic.

The port of ``repro/launch/train.py``, at two scales from the same code
path:
  * tests: ``--arch <id> --reduced --device cpu`` trains the reduced
    config for a few steps;
  * the card: the same code at full width, ``remat="full"``; on several
    cards, one process each, ``--mesh DxM`` trains on a ``data`` × ``model``
    device mesh (``ModelBundle``'s DTensor step).  Every rank draws the
    same ``TokenPipeline`` batch and ``shard_batch`` places it.

Fault-tolerance contract:
  * checkpoint every ``--ckpt_every`` steps (async, atomic, keep-last-k)
    including the data-pipeline state (seed, step) — restart replays
    nothing and loses at most one interval; on a mesh every rank gathers
    and rank 0 writes;
  * ``--resume`` restores the newest committed step onto the device, or
    *resharding* onto the current mesh (elastic: a job saved on one mesh
    restarts on another);
  * preemption-safe: SIGTERM finishes the in-flight step, saves, exits.
Rank 0 alone prints.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
      --steps 6 --batch 8 --seq 512 --ckpt_dir runs/ckpt
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --arch qwen1_5_0_5b \\
      --mesh 2x2 --steps 4 --batch 8 --seq 512
"""
from __future__ import annotations

import argparse
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..ckpt.checkpoint import CheckpointManager
from ..configs.base import ArchConfig, get_config
from ..data.pipeline import TokenPipeline
from ..ml.model import ModelBundle, TrainConfig

__all__ = ["train_loop", "main"]


def train_loop(arch, *, reduced: bool = True, steps: int = 200,
               batch: int = 8, seq: int = 128, lr: float = 1e-3,
               ckpt_dir: str | None = None, ckpt_every: int = 50,
               resume: bool = False, mesh=None, log_every: int = 10,
               seed: int = 0, loss_chunk: int | None = None, device="cuda",
               print_fn=print,
               on_step: Optional[Callable[[int, dict], None]] = None):
    """Train ``arch`` (a name, or an ``ArchConfig``) for ``steps`` steps
    → (params, opt state, [(step, loss)] at the logged steps).

    ``mesh`` (a ``DeviceMesh`` of every rank, e.g. from
    ``launch.mesh.make_local_mesh``) trains on it, params and optimizer
    state as DTensors; without one the job runs on ``device``.
    ``on_step(step, metrics)``, when given, is called after every step
    with the step's metrics (tensors on the device)."""
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    tc = TrainConfig(lr=lr, warmup=min(20, steps // 10 + 1),
                     total_steps=steps, loss_chunk=loss_chunk,
                     remat="none" if reduced else "full")
    mb = ModelBundle(cfg, mesh, train_cfg=tc, device=device)
    lead = _rank() == 0
    if not lead:
        print_fn = _silent

    params = mb.init_params(seed)
    opt = mb.init_opt_state(params)
    if mesh is not None:
        params, opt = mb.shard_params(params), mb.shard_opt_state(opt)
    pipe_state = {"seed": seed, "step": 0}
    start_step = 0

    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    if mgr is not None and resume:
        template = {"params": params, "opt": opt,
                    "data": {"seed": np.int64(seed), "step": np.int64(0)},
                    "step": np.int64(0)}
        shardings = None if mesh is None else {
            "params": mb.param_shardings(),
            "opt": mb.opt_state_shardings(), "data": None, "step": None}
        restored, _ = mgr.restore_or_none(template, shardings=shardings,
                                          device=mb.device)
        if restored is not None:
            params, opt = restored["params"], restored["opt"]
            pipe_state = {"seed": int(restored["data"]["seed"]),
                          "step": int(restored["data"]["step"])}
            start_step = int(restored["step"])
            print_fn(f"resumed from step {start_step}")

    pipe = TokenPipeline.restore(pipe_state, cfg.vocab_size, batch, seq)
    step_fn = mb.make_train_step()

    stop = {"now": False}
    old = signal.signal(signal.SIGTERM,
                        lambda *_: stop.__setitem__("now", True))

    losses = []
    t0 = time.perf_counter()
    try:
        for step in range(start_step, steps):
            data = next(pipe)
            batch_dev = {k: torch.from_numpy(v).to(mb.device)
                         for k, v in data.items()}
            if mesh is not None:
                batch_dev = mb.shard_batch(batch_dev)
            params, opt, metrics = step_fn(params, opt, batch_dev)
            if on_step is not None:
                on_step(step, metrics)
            if mesh is not None:    # every rank stops at the same step
                stop["now"] = _any_rank(stop["now"], mb.device)
            if step % log_every == 0 or step == steps - 1:
                loss = float(metrics["loss"])
                losses.append((step, loss))
                dt = time.perf_counter() - t0
                print_fn(f"step {step:5d} loss {loss:8.4f} "
                         f"gnorm {float(metrics['grad_norm']):7.3f} "
                         f"lr {float(metrics['lr']):.2e} [{dt:6.1f}s]")
            if mgr is not None and ((step + 1) % ckpt_every == 0
                                    or stop["now"]):
                mgr.save(step + 1, {
                    "params": params, "opt": opt,
                    "data": {"seed": np.int64(pipe.seed),
                             "step": np.int64(pipe.step)},
                    "step": np.int64(step + 1)})
            if stop["now"]:
                print_fn(f"SIGTERM: checkpointed at {step + 1}, exiting")
                break
    finally:
        pipe.close()
        if mgr is not None:
            mgr.wait()
        signal.signal(signal.SIGTERM, old)
    if mesh is not None and mgr is not None:
        # rank 0's writes are committed before any rank returns
        import torch.distributed as dist
        dist.barrier()
    return params, opt, losses


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _silent(*_, **__):
    pass


def _any_rank(flag: bool, device) -> bool:
    """``flag`` or-ed over the ranks of the process group."""
    import torch.distributed as dist
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _init_from_env(device: str):
    """The process group from ``torch.distributed.run``'s environment:
    NCCL over this process's card (``LOCAL_RANK``), gloo on the CPU."""
    import os
    import torch.distributed as dist
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--ckpt_every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="train on a data x model mesh of the ranks that "
                    "torch.distributed.run started")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        from .mesh import make_local_mesh
        data, model = (int(x) for x in args.mesh.lower().split("x"))
        _init_from_env(args.device)
        mesh = make_local_mesh(data, model, device=args.device)
    try:
        train_loop(args.arch, reduced=args.reduced, steps=args.steps,
                   batch=args.batch, seq=args.seq, lr=args.lr,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                   resume=args.resume, mesh=mesh, seed=args.seed,
                   device=args.device)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
