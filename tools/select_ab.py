#!/usr/bin/env python3
"""A/B of the selection kernels' one-launch designs on one CUDA card.

    python3 tools/select_ab.py

Builds the rejected designs kept under ``tools/`` with the port's
``nvcc`` flags into the port's gitignored build directory and times each
against the port's kernel on the same inputs:

- ``intersect``: ``intersect_cluster.cu`` (a thread-block cluster a shard,
  the blocks' sums added over distributed shared memory, no atomic)
  against ``bitset.cu``'s blocks closing on an arrival word, at the
  engines' shapes of
  ``bitmap_intersect_batched`` (wave [8, 5, 625], serve [128, 4, 625],
  large [8, 5, 28125]) and ``bitmap_intersect`` ([5, 625], [5, 28125]);
  random words, made from a seed;
- ``scan``: ``scan_coop.cu`` (one cooperative launch, each block's tile
  flags in registers across one ``grid.sync()``) against ``compact.cu``'s
  decoupled look-back, at ``compact_batched``'s wave [8, 20000], serve
  [128, 20000] and large [8, 900000] and the single mask's [20000] and
  [900000]; masks random at a 5% density.

Both outputs are held to the plain version byte for byte.  The device
time a call is each kernel's mean recorded time under ``torch.profiler``
(one kernel a call), taken in turns (alternative, port, port,
alternative) and reported per turn.  Prints the card's name and power
limit, then one JSON line.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
INTERSECT_SHAPES = {"wave": (8, 5, 625), "serve": (128, 4, 625),
                    "large": (8, 5, 28_125), "single wave": (1, 5, 625),
                    "single large": (1, 5, 28_125)}
SCAN_SHAPES = {"wave": (8, 20_000), "serve": (128, 20_000),
               "large": (8, 900_000), "single wave": (1, 20_000),
               "single large": (1, 900_000)}
DENSITY = 0.05
CALLS = 200


def build(_build, name, entry, kinds):
    """Compile ``tools/<name>.cu`` into the port's build directory; its
    ctypes entry (``kinds``: ``p`` pointer or stream, ``i`` int)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"ab-{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build._HERE / "csrc"), "-o", str(out),
                    str(ROOT / "tools" / f"{name}.cu")], check=True)
    fn = getattr(ctypes.CDLL(str(out)), entry)
    fn.argtypes = [ctypes.c_void_p if k == "p" else ctypes.c_int
                   for k in kinds]
    fn.restype = ctypes.c_int
    return fn


def device_ms(torch, fn, name):
    """Mean recorded device time (ms) of kernel ``name`` over CALLS
    calls of ``fn``, after a warm-up the profiler's schedule drops."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=3,
                                             active=CALLS,
                                             repeat=1)) as prof:
        for i in range(3 + CALLS):
            fn()
            if i == 2 + CALLS:
                torch.cuda.synchronize()
            prof.step()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    if not rows:
        return "not measured"
    return sum(e.self_device_time_total for e in rows) / 1e3 / sum(
        e.count for e in rows)


def compare_runs(torch, label, runs, want, alternative, port):
    """Hold both designs (``runs``: design -> (call, kernel name)) to
    ``want``, then time them in turns."""
    for run, _ in runs.values():
        got = run()
        got = tuple(g.reshape(w.shape) for g, w in zip(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"select_ab: {label} differs from the plain "
                             "version")
    turns = {alternative: [], port: []}
    for design in (alternative, port, port, alternative):
        fn, kernel = runs[design]
        turns[design].append(device_ms(torch, fn, kernel))
    print(f"{label}: {turns}", file=sys.stderr)
    return turns


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("select_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, bitset, compact, ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cluster = build(_build, "intersect_cluster", "ab_cluster_intersect",
                    "pppiiip")
    coop = build(_build, "scan_coop", "ab_coop_scan", "ppppiiip")
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    out = {"intersect": {}, "scan": {}}

    for label, (s, k, w) in INTERSECT_SHAPES.items():
        stack = torch.from_numpy(
            rng.integers(0, 1 << 32, (s, k, w), dtype=np.uint64)
            .astype(np.uint32).view(np.int32)).cuda()
        words = torch.empty((s, w), dtype=torch.int32, device="cuda")
        cnt = torch.empty((s,), dtype=torch.int32, device="cuda")

        def run_cluster():
            err = cluster(stack.data_ptr(), words.data_ptr(),
                          cnt.data_ptr(), s, k, w, stream)
            if err:
                raise RuntimeError(f"ab_cluster_intersect: error {err}")
            return words, cnt

        if s == 1:
            def run_port():
                return bitset.bitmap_intersect(stack[0])
        else:
            def run_port():
                return bitset.bitmap_intersect_batched(stack)
        runs = {"cluster": (run_cluster, "intersect_kernel"),
                "arrival": (run_port, "intersect_kernel")}
        out["intersect"][label] = {
            "shape": [s, k, w],
            "device_ms": compare_runs(torch, f"intersect {label}", runs,
                                      ref.bitmap_intersect_batched_ref(stack),
                                      "cluster", "arrival")}

    for label, (s, n) in SCAN_SHAPES.items():
        masks = torch.from_numpy(rng.random((s, n)) < DENSITY).cuda()
        tiles = torch.empty((s * -(-n // compact.SCAN_TILE),),
                            dtype=torch.int32, device="cuda")
        idx = torch.empty((s, n), dtype=torch.int32, device="cuda")
        cnt = torch.empty((s,), dtype=torch.int32, device="cuda")

        def run_coop():
            err = coop(masks.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
                       tiles.data_ptr(), s, n, 1, stream)
            if err:
                raise RuntimeError(f"ab_coop_scan: CUDA error {err}")
            return idx, cnt

        if s == 1:
            def run_port():
                return compact.compact(masks[0])
        else:
            def run_port():
                return compact.compact_batched(masks)
        runs = {"cooperative": (run_coop, "coop_scan_kernel"),
                "look_back": (run_port, "mask_scan_kernel")}
        out["scan"][label] = {
            "shape": [s, n], "density": DENSITY,
            "device_ms": compare_runs(torch, f"scan {label}", runs,
                                      ref.compact_batched_ref(masks),
                                      "cooperative", "look_back")}
    print(json.dumps({"select_ab": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
