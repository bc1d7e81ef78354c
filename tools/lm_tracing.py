#!/usr/bin/env python3
"""What the port's own spans (``repro_torch.tracing``) read and cost in a
serving cell of the benchmark, on one CUDA card.

    python3 tools/lm_tracing.py --cell jamba_v0_1_8of32.column \\
        --seed 5 [--seconds 20] [--steps 50] [--out FILE]

From the root of a checkout.  Three parts, one JSON line each (and all
of them in ``--out``):

* ``spans``: the recorder's host ns a span, off, on for CPU work and on
  with a pair of CUDA events;
* ``trace``: one traced window of the cell as ``bench_h100/run.py
  --trace 1`` runs it (its first half under the profiler).  The
  benchmark's seven readers of the program's spans and counters and
  ``device_idle.serve``; the device time of the program's ``prefill``
  spans against the union of the trace's device intervals inside the
  harness's ``bench.prefill`` ranges; the window's device-idle time while
  the host was in a decode step, split by the block half it was in
  (``attn``, ``mamba``, ``moe``, ``mlp``, the rest of the step); the
  prefill's device time outside the block halves (embedding, head, cache
  build); any device record of the spans' CUDA events; the window's
  kernel launches against the server's prefills, and the Mamba scan
  kernels' device records (``selective_scan_kernel``, ``ssm_scan_kernel``);
* ``cost``: ``LM.prefill`` at the cell's largest call and ``LM.decode_step``
  on its caches, with tracing off and after ``tracing.on()``, in turns,
  without the profiler: host clock around a synchronised call, medians
  of ``--steps`` calls each.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KINDS = ("attn", "mamba", "mlstm", "slstm", "moe", "mlp")


def _span_ns(tracing, torch, n: int, device=None) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with tracing.span("x", device, rows=1):
            pass
    return (time.perf_counter_ns() - t0) / n


def spans_part(torch, tracing) -> dict:
    out = {}
    tracing.off()
    out["off_ns"] = _span_ns(tracing, torch, 200_000)
    tracing.on()
    for name, dev in (("on_cpu_ns", None),
                      ("on_cuda_ns", torch.device("cuda"))):
        _span_ns(tracing, torch, 1000, dev)
        tracing.clear()
        out[name] = _span_ns(tracing, torch, 20_000, dev)
        tracing.records()
        tracing.clear()
    tracing.off()
    return out


def trace_part(torch, c, seed, seconds, dev):
    """A traced window of cell ``c`` on ``dev`` → (its driver, what it
    read)."""
    from torch.profiler import ProfilerActivity, profile

    from bench_h100.harness import runner, spec
    from bench_h100.harness.program import (merged, minus, overlap_ns,
                                            records)
    from bench_h100.harness.trace import gaps, union_ns
    from repro_torch import tracing
    from repro_torch.kernels import _build, ops

    driver = runner.KINDS[c.traffic["kind"]](c, seed, dev, True)
    driver.setup()
    tracing.clear()
    prefills = driver.srv.stats["prefills"]
    ops.reset_launch_counts()
    if dev.type == "cuda":
        _build.reset_kernel_launches()
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    traces = []

    def stop():
        prof.stop()
        traces.append(runner.reduce(prof))
    driver.rec.stop_trace = stop
    prof.start()
    driver.window(seconds)
    _sync(torch, dev)
    tr = traces[0]
    run = runner.Run(cell=c, driver=driver, setup_s=0.0,
                     window_s=driver.window_s, trace=tr)
    out = {"cell": c.name, "window_s": tr.window_s, "busy_s": tr.busy_s()}
    for m in ("prefill_attn_share", "prefill_mlp_share",
              "prefill_mamba_share", "prefill_moe_share", "moe_slot_use",
              "decode_idle", "batch_idle", "device_idle.serve"):
        out[m] = spec.metric_reader(m)(run)
    recs = records(run) or []
    out["records"] = len(recs)
    out["dropped"] = tracing.dropped()
    out["counters"] = tracing.counters()

    # the program's prefill device time against the trace's, prefill by
    # prefill in order
    lo, hi = tr.window
    prog = sorted((r.t0, r.device_ns) for r in recs if r.name == "prefill")
    theirs = sorted((a, b) for name, a, b in tr.spans if name == "prefill")
    dev_iv = [(a, b) for _, a, b, _ in tr.device]
    harness = [union_ns(dev_iv, s) for s in theirs]
    out["prefills"] = [len(prog), len(theirs)]
    out["prefill_program_s"] = sum(d for _, d in prog) / 1e9
    out["prefill_trace_s"] = sum(harness) / 1e9
    if out["prefill_trace_s"]:
        out["prefill_ratio"] = out["prefill_program_s"] \
            / out["prefill_trace_s"]
        out["prefill_ratio_each"] = [d / h for (_, d), h in
                                     zip(prog, harness) if h]

    # the window's device-idle time while the host was in a decode step,
    # by the block half it was in
    idle = gaps(dev_iv, tr.window)
    win = hi - lo
    dec = {r.index for r in recs if r.name == "decode"}
    split = {}
    inner = []
    for k in KINDS:
        iv = merged((r.t0, r.t1) for r in recs
                    if r.name == k and r.parent in dec)
        if iv:
            split[k] = 100.0 * overlap_ns(iv, idle) / win
            inner += iv
    rest = minus(merged((r.t0, r.t1) for r in recs if r.index in dec),
                 merged(inner))
    split["rest"] = 100.0 * overlap_ns(rest, idle) / win
    out["decode_idle_by_kind"] = split

    # the prefill's device time outside the block halves
    pre = {r.index: r for r in recs if r.name == "prefill"}
    kinds = [r for r in recs if r.name in KINDS and r.parent in pre]
    pre_ns = sum(r.device_ns for r in pre.values())
    if pre_ns:
        out["prefill_by_kind"] = {
            k: 100.0 * sum(r.device_ns for r in kinds if r.name == k)
            / pre_ns for k in KINDS if any(r.name == k for r in kinds)}
        out["prefill_rest"] = 100.0 - sum(out["prefill_by_kind"].values())
    out["decode_steps"] = len(dec)
    out["event_records"] = sum("event" in n.lower() for n, *_ in tr.device)
    out["device_records"] = len(tr.device)

    # the window's launches a prefill, and the Mamba scan kernels' records
    out["server_prefills"] = driver.srv.stats["prefills"] - prefills
    out["launches"] = ops.launch_counts()
    if dev.type == "cuda":
        out["kernel_launches"] = _build.kernel_launches()
    for k in ("selective_scan_kernel", "ssm_scan_kernel"):
        ns = [b - a for n, a, b, _ in tr.device if k in n]
        out[k] = {"records": len(ns), "device_s": sum(ns) / 1e9}
    return driver, out


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cost_part(torch, driver, steps: int) -> dict:
    """The prefill at the cell's largest call, then a decode step on its
    caches, tracing off and on in turns (off, on, on, off, ...)."""
    from bench_h100.harness import traffic as T
    from repro_torch import tracing
    from repro_torch.ml.transformer import LM

    srv, dims, dev = driver.srv, driver.dims, driver.device
    lm, params = srv.lm, srv.params
    reqs = T.longest_call(driver.traffic, dims.vocab, dims.context,
                          driver.seed)
    prompts = [p for p, _ in reqs]
    s = max(len(p) for p in prompts)
    toks = torch.zeros((len(prompts), s), dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[i, s - len(p):] = torch.as_tensor(p)
    toks = toks.to(dev)

    def timed(fn):
        _sync(torch, dev)
        t0 = time.perf_counter()
        fn()
        _sync(torch, dev)
        return time.perf_counter() - t0

    def turns(fn):
        times = {"off": [], "on": []}
        for _ in range(2):                               # warm
            timed(fn)
        for i in range(2 * steps):
            mode = ("off", "on")[(i + i // 2) % 2]
            if mode == "on":
                tracing.on()
            times[mode].append(timed(fn))
            tracing.off()
            tracing.clear()
        out = {m: statistics.median(v) * 1e3 for m, v in times.items()}
        out["on_over_off"] = out["on"] / out["off"]
        return out

    res = {"batch": len(prompts), "seq": s}
    with torch.inference_mode():
        # the prefill's output is dropped at once: its caches and a
        # second prefill's would not fit the card together
        res["prefill"] = turns(lambda: LM.prefill(lm, params, toks))
        logits, caches = LM.prefill(lm, params, toks)
        cur = torch.argmax(logits, dim=-1).to(torch.int32)
        del logits
        res["decode"] = turns(lambda: LM.decode_step(lm, params, cur,
                                                     caches, s))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench_h100 import run as bench_run
    bench_run.prepare()
    import torch
    if not torch.cuda.is_available():
        sys.exit("lm_tracing: needs a CUDA card")
    from bench_h100.harness import spec
    from repro_torch import tracing
    card = torch.cuda.get_device_name(0)
    lines = [{"part": "spans", "card": card, **spans_part(torch, tracing)}]
    print(json.dumps(lines[-1]), flush=True)
    driver, tr = trace_part(torch, spec.cell(args.cell), args.seed,
                            args.seconds, torch.device("cuda"))
    lines.append({"part": "trace", "card": card, **tr})
    print(json.dumps(lines[-1]), flush=True)
    lines.append({"part": "cost", "card": card, "cell": args.cell,
                  **cost_part(torch, driver, args.steps)})
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
