"""One run of one cell: set-up, the measured window, the trace, the
check, the metrics.

``run_cell`` takes the device as an argument so that the CPU tests can
drive every step of a run at a tiny size; ``run.py`` gives it the card
and nothing else.  A cell on several cards runs ``run_cell`` in one
process a card (:func:`run_ranks`, started by ``harness.ranks``) on the
mesh its configuration states: every rank makes the same weights'
pieces, the same calls and the same check; rank 0 alone traces, and its
result stands for the run, with the peak of the fullest card and the
modules loaded on any rank.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist

from . import spec
from .serve import ServeRun
from .trace import Trace, breakdown, reduce
from .train import TrainRun

#: a mix's ``kind`` → the loop that drives the entry point
KINDS = {"serve": ServeRun, "train": TrainRun}

#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """What the metric readers see."""
    cell: spec.Cell
    driver: object
    setup_s: float
    window_s: float
    trace: Optional[Trace] = None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, traced: bool, *,
             device="cuda", started: float = None, control: bool = False,
             cell: spec.Cell = None, mesh=None) -> Dict:
    """→ {"correct", "attempted", "failed", "metrics", "device",
    ["breakdown"], "readings", "checks"}.  With ``control`` the driver's
    check puts the control in the program's place, so that ``correct``
    is the control's verdict under the cell's limits.  With ``mesh`` this
    is one rank's part of a run on several cards (module docstring); the
    result is rank 0's."""
    started = time.perf_counter() if started is None else started
    dev = torch.device(device)
    c = cell or spec.cell(name)
    kw = {} if mesh is None else {"mesh": mesh}
    driver = KINDS[c.traffic["kind"]](c, seed, dev, traced, **kw)
    driver.setup()
    if mesh is not None:
        dist.barrier()              # set-up ends when every rank's has
    setup_s = time.perf_counter() - started
    traces = []
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)

        def stop_trace():
            prof.stop()
            traces.append(reduce(prof))
        driver.rec.stop_trace = stop_trace
        prof.start()
    driver.window(seconds)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    tr = traces[0] if traces else None
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    count = 1
    if mesh is not None:
        peak, count = _fullest(peak, dev), dist.get_world_size()
    run = Run(cell=c, driver=driver, setup_s=setup_s,
              window_s=driver.window_s, trace=tr)
    wanted = c.per_layer if traced else c.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted, failed = driver_counts(driver)
    numbers = driver.check(control=control)
    loaded = None
    if mesh is not None:
        every = [None] * count
        dist.all_gather_object(every, forbidden_modules())
        loaded = sorted(set().union(*every))
        if dist.get_rank() != 0:
            return None
    checks = {}
    for key, limit in sorted(c.limits.items()):
        checks[key] = {"value": numbers[key], "limit": limit}
    correct = bool(checks) and all(v["value"] <= v["limit"]
                                   for v in checks.values())
    if dev.type == "cuda":
        kind, platform = torch.cuda.get_device_name(dev), "gpu"
    else:
        kind, platform = "cpu", "cpu"
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": platform, "kind": kind, "count": count,
                      "memory_peak_bytes": int(peak)}}
    if tr is not None:
        out["device"]["busy_s"] = tr.busy_s()
        out["device"]["window_s"] = tr.window_s
        out["breakdown"] = breakdown(tr)
    if loaded is not None:
        out["forbidden"] = loaded    # on any rank; run.py refuses them
    out["readings"] = {k: v for k, v in numbers.items() if k not in checks}
    out["checks"] = checks
    return out


def _fullest(peak: int, dev: torch.device) -> int:
    """The largest of every rank's ``peak``."""
    t = torch.tensor([peak], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def run_ranks(rank: int, world: int, jobs, backend: str):
    """One rank of a cell on ``world`` cards (``harness.ranks.launch``):
    ``run_cell(**job)`` for each of ``jobs`` in turn, on this rank's card
    and the mesh the cell's configuration states, traced on rank 0 alone
    → rank 0's results (None on the other ranks)."""
    from . import port
    from .ranks import device_of
    dev = device_of(rank, backend)
    outs = []
    for job in jobs:
        c = job.get("cell") or spec.cell(job["name"])
        mesh = port.mesh_of(c.config, dev)
        if mesh is None:
            raise ValueError(f"{c.name}: {world} ranks, but its "
                             f"configuration states no mesh")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        job = dict(job, cell=c, traced=job["traced"] and rank == 0)
        outs.append(run_cell(device=dev, mesh=mesh, **job))
        del mesh
        port.free(dev)
    return outs if rank == 0 else None


def driver_counts(driver):
    """(attempted, failed): requests, or training steps, of the window."""
    if driver.kind == "serve":
        reqs = driver.requests
        return len(reqs), sum(not r["done"] or r["out"] != r["max_new"]
                              for r in reqs)
    return driver.window_steps, 0
