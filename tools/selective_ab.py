#!/usr/bin/env python3
"""The fused selective scan against the unfused chain, and its lane split,
on one CUDA card.

    python3 tools/selective_ab.py [--quick]

At each shape [B, L, dI, N] (dt, x, B, C in bf16 made from a seed, A
about its initial -1..-N, a zero start):

- ``chain``: the Mamba layer's scan before the fused kernel (256 steps
  at a time: exp(dt·A) and (dt·x)·B over [B, 256, dI, N] in float32, row
  10's ``ssm_scan``, y = h·C), ``chip_smoke._unfused_chain``;
- ``fused[lanes]``: ``csrc/selective_scan.cu`` with 1, 2 and 4 lanes a
  channel (``_build.launch`` with the lanes given; the wrapper picks them
  by ``selective_scan.lanes_for``, named ``picked``).

Each fused run is held to the chain within ``SELECTIVE_REL`` of max |y|
and of max |h_final|.  Times are CUDA events over a run of calls, in two
rounds of the chain then each lane count; the bound is the larger of the
bytes at 3.35 TB/s and the exps at the SFU rate.  Prints the card's name
and power limit, ptxas's report for the kernel, then one JSON line a
shape.  ``--quick`` runs the first shape only.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = {"jamba column prefill": (16, 2048, 8192, 16),
          "smoke prefill": (4, 512, 8192, 16),
          "1x4 rank, column prefill": (16, 2048, 2048, 16),
          "1x4 rank, short prefill": (16, 300, 2048, 16)}
LANES = (1, 2, 4)


def main(argv) -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as sel

    if not torch.cuda.is_available():
        print("selective_ab: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _build.library("selective_scan")
    log = _build.BUILD_LOGS.get("selective_scan", "(built before)")
    print("\n".join(line for line in log.splitlines()
                    if "selective_scan" in line or "registers" in line
                    or "spill" in line))
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def events_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    shapes = list(SHAPES.items())[:1] if "--quick" in argv else SHAPES.items()
    for label, (b, s, di, n) in shapes:
        g = torch.Generator(device=dev).manual_seed(b * s + di)

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev)
        dt = torch.nn.functional.softplus(randn(b, s, di) - 1.0) \
            .to(torch.bfloat16)
        x, bm, cm = (randn(*sh).to(torch.bfloat16)
                     for sh in ((b, s, di), (b, s, n), (b, s, n)))
        A = -torch.exp(torch.log(torch.arange(1, n + 1, device=dev).float())
                       + 0.1 * randn(di, n))
        y = torch.empty((b, s, di), device=dev)
        hT = torch.empty((b, di, n), device=dev)

        def fused(lanes):
            def call():
                _build.launch("selective_scan", "repro_selective_scan", dev,
                              dt, x, bm, cm, A, None, y, hT, b, s, di, n,
                              lanes, 1)
                return y, hT
            return call

        with torch.inference_mode():
            want = cs._unfused_chain(torch, dt, x, bm, cm, A)
            errs = {}
            for lanes in LANES:
                got = fused(lanes)()
                errs[lanes] = [float((a - w).abs().max() / w.abs().max())
                               for a, w in zip(got, want)]
                if max(errs[lanes]) > cs.SELECTIVE_REL:
                    print(f"selective_ab {label}: {lanes} lanes differ "
                          f"from the chain by {errs[lanes]}",
                          file=sys.stderr)
                    return 1
            del want
            chain_ms, fused_ms = [], {lanes: [] for lanes in LANES}
            for turn in range(2):
                chain_ms.append(events_ms(
                    lambda: cs._unfused_chain(torch, dt, x, bm, cm, A), 2))
                for lanes in LANES:
                    fused_ms[lanes].append(events_ms(fused(lanes), 5))
        nbytes = 2 * (2 * b * s * di + 2 * b * s * n) \
            + 4 * (di * n + b * s * di + b * di * n)
        bound_ms = 1e3 * max(nbytes / cs.HBM_BYTES_PER_S,
                             b * s * di * n / cs.SFU_OPS_PER_S)
        print(json.dumps({
            "shape": label, "b_l_di_n": [b, s, di, n], "sms": sms,
            "picked": sel.lanes_for(b * di, n, sms), "chain_ms": chain_ms,
            "fused_ms": {str(k): v for k, v in fused_ms.items()},
            "bound_ms": bound_ms, "max_rel_err": errs}))
        del dt, x, bm, cm, A, y, hT
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
