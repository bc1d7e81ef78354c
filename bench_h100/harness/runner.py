"""One run of one cell: set-up, the measured window, the trace, the
check, the metrics.

``run_cell`` takes the device as an argument so that the CPU tests can
drive every step of a run at a tiny size; ``run.py`` gives it the card
and nothing else.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

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
             cell: spec.Cell = None) -> Dict:
    """→ {"correct", "attempted", "failed", "metrics", "device",
    ["breakdown"], "readings", "checks"}.  With ``control`` the driver's
    check puts the control in the program's place, so that ``correct``
    is the control's verdict under the cell's limits."""
    started = time.perf_counter() if started is None else started
    dev = torch.device(device)
    c = cell or spec.cell(name)
    driver = KINDS[c.traffic["kind"]](c, seed, dev, traced)
    driver.setup()
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
    checks = {}
    for key, limit in sorted(c.limits.items()):
        checks[key] = {"value": numbers[key], "limit": limit}
    correct = bool(checks) and all(v["value"] <= v["limit"]
                                   for v in checks.values())
    if dev.type == "cuda":
        kind, count = torch.cuda.get_device_name(dev), 1
        platform = "gpu"
    else:
        kind, count, platform = "cpu", 1, "cpu"
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": platform, "kind": kind, "count": count,
                      "memory_peak_bytes": int(peak)}}
    if tr is not None:
        out["device"]["busy_s"] = tr.busy_s()
        out["device"]["window_s"] = tr.window_s
        out["breakdown"] = breakdown(tr)
    out["readings"] = {k: v for k, v in numbers.items() if k not in checks}
    out["checks"] = checks
    return out


def driver_counts(driver):
    """(attempted, failed): requests, or training steps, of the window."""
    if driver.kind == "serve":
        reqs = driver.requests
        return len(reqs), sum(not r["done"] or r["out"] != r["max_new"]
                              for r in reqs)
    return driver.window_steps, 0
