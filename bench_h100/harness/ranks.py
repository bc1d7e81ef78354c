"""One process a card, for a cell on several cards.

:func:`launch` starts ``world`` processes (``torch.multiprocessing``,
spawned), joins them in one process group (NCCL on the cards, gloo on the
CPU for the tests) at a free port of this host, runs ``fn(rank, world,
*args)`` in each and returns what rank 0's returned.  Each rank computes
on its own card (``cuda:<rank>``).  If any rank fails, or the ranks are
still running at the deadline, every rank is stopped and
:class:`RanksFailed` is raised: a run never hangs on a rank that died
inside a collective.  The caller prints; no rank does.
"""
from __future__ import annotations

import socket
import sys
import time
from datetime import timedelta

import torch


class RanksFailed(RuntimeError):
    pass


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def device_of(rank: int, backend: str) -> torch.device:
    return torch.device("cuda", rank) if backend == "nccl" \
        else torch.device("cpu")


def _rank(rank, world, port, backend, limit_s, box, fn, args):
    import torch.distributed as dist
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=limit_s))
    out = fn(rank, world, *args)
    if rank == 0:
        box.put(out)
    dist.barrier()
    dist.destroy_process_group()


def launch(fn, args, world: int, *, backend: str, deadline: float):
    """``fn(rank, world, *args)`` on ``world`` ranks → rank 0's value.
    ``deadline`` is on ``time.perf_counter``'s clock."""
    import torch.multiprocessing as mp
    box = mp.get_context("spawn").SimpleQueue()
    limit = max(1.0, deadline - time.perf_counter())
    ctx = mp.start_processes(
        _rank, args=(world, free_port(), backend, limit, box, fn, args),
        nprocs=world, join=False, start_method="spawn")
    got = []
    try:
        while True:
            left = deadline - time.perf_counter()
            if left <= 0:
                raise RanksFailed(f"the {world} ranks were still running "
                                  f"at the run's time limit")
            try:
                done = ctx.join(timeout=min(left, 2.0), grace_period=5.0)
            except Exception as e:       # a rank raised or was killed
                raise RanksFailed(f"a rank failed: {e}") from None
            while not box.empty():
                got.append(box.get())
            if done:
                break
    finally:
        _stop(ctx)
    if not got:
        raise RanksFailed("rank 0 returned nothing")
    return got[-1]


def _stop(ctx) -> None:
    """Every rank still alive: SIGTERM, then SIGKILL; each joined."""
    alive = [p for p in ctx.processes if p.is_alive()]
    for p in alive:
        p.terminate()
    t0 = time.perf_counter()
    for p in alive:
        p.join(max(0.0, 5.0 - (time.perf_counter() - t0)))
    for p in alive:
        if p.is_alive():
            p.kill()
        p.join()
    if alive:
        print(f"bench_h100: stopped {len(alive)} rank(s)", file=sys.stderr)
