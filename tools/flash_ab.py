#!/usr/bin/env python3
"""Row 9's designs at head dim 256 on one CUDA card.

    python3 tools/flash_ab.py [--quick]

Builds ``tools/flash_ab.cu`` (the port's ``csrc/flash_attention.cu`` and
one more entry) with the port's ``nvcc`` flags into the port's gitignored
build directory, prints what ``ptxas -v`` says of every tensor-core
instantiation (registers, spill bytes, stack, whether it serialises its
wgmmas: C7512), and at each of Gemma 3 12B's shapes (16 query / 8 KV
heads, causal, softcap 50; its lm prefill [4, 16, 445, 256] and a local
layer at 4,096 positions with window 1024, a global layer at 1,780
without) times, in turns, the port's 128-row kernel (``wide``) against
``flash_tc_kernel<256>`` (``tc``: the 64-row design of head dims 64 and
128 instantiated at 256) and the SIMT kernel (``simt``), which the port
ran there before.

Inputs are seeded normal bf16; each output is held to the plain version
within ``ref.flash_tolerance`` (a design the port does not run may fail:
its error is reported).  The device time a call is the kernel's mean
recorded time under ``torch.profiler``, per turn (alternative, port,
port, alternative); SDPA's time stands beside (causal only where Sq =
Skv, and without window or softcap).  Prints the card's name and power
limit, then one JSON line.  ``--quick``: the first shape only, one turn
each (a build-and-check call).
"""
from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: name: (q shape, KV heads, KV length, options)
SHAPES = {
    "gemma3_12b prefill": ((4, 16, 445, 256), 8, 445,
                           {"window": 1024, "softcap": 50.0}),
    "gemma3_12b local": ((4, 16, 4096, 256), 8, 4096,
                         {"window": 1024, "softcap": 50.0}),
    "gemma3_12b global": ((4, 16, 1780, 256), 8, 1780, {"softcap": 50.0}),
}
BF16_OPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
ITERS = 20
KERNELS = {"tc": "flash_tc_kernel", "wide": "flash_wide_kernel",
           "simt": "flash_simt_kernel"}


def build(_build):
    """Compile ``tools/flash_ab.cu``; (its ctypes entry, ptxas's report
    per tensor-core instantiation)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "ab-flash_ab.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                          str(_build._HERE / "csrc"), "-o", str(out),
                          str(ROOT / "tools" / "flash_ab.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"flash_ab: nvcc failed:\n{res.stdout}\n"
                         f"{res.stderr}")
    report, name = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"(flash_(?:tc|wide)_kernel)(?:ILi(\d+)E)?", line)
        key = m and (f"{m.group(1)}<{m.group(2)}>" if m.group(2)
                     else m.group(1))
        if m and "C7512" in line:        # wgmma serialised
            report.setdefault(key, {})["wgmma_serialized"] = True
        if "Compiling entry function" in line:
            name = key
        elif name and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            report.setdefault(name, {}).update(
                stack_bytes=nums[0], spill_store_bytes=nums[1],
                spill_load_bytes=nums[2])
        elif name and "Used" in line and "registers" in line:
            report.setdefault(name, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    print(json.dumps({"ptxas": report}), file=sys.stderr)
    fn = ctypes.CDLL(str(out)).ab_flash_attention_tc256
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
        [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, report


def device_ms(torch, fn, name, iters=ITERS):
    """Mean recorded device time (ms) of kernel ``name`` over ``iters``
    calls of ``fn``, after a warm-up the profiler's schedule drops."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=3, active=iters,
                                             repeat=1)) as prof:
        for i in range(3 + iters):
            fn()
            if i == 2 + iters:
                torch.cuda.synchronize()
            prof.step()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    if not rows:
        return "not measured"
    return sum(e.self_device_time_total for e in rows) / 1e3 / sum(
        e.count for e in rows)


def cuda_ms(torch, fn, iters=ITERS):
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


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.nn.functional import scaled_dot_product_attention
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa
    quick = "--quick" in argv
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    ab, report = build(_build)
    stream = torch.cuda.current_stream().cuda_stream
    out = {"ptxas": report, "shapes": {}}
    failed = []
    for label, (qs, hkv, skv, kw) in SHAPES.items():
        b, hq, sq, d = qs
        causal = kw.get("causal", True)
        g = torch.Generator(device="cuda").manual_seed(sum(qs) + skv)
        q = torch.randn(qs, generator=g, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b, hkv, skv, d), generator=g, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        o = torch.empty_like(q)
        scale = 1.0 / math.sqrt(d)
        window, softcap = kw.get("window") or 0, kw.get("softcap") or 0.0

        def entry(design):
            def run():
                if design == "simt":
                    _build.launch("flash_attention",
                                  "repro_flash_attention_simt", q.device,
                                  q, k, v, o, b, hq, hkv, sq, skv, d,
                                  int(causal), window, 1, scale, softcap)
                else:
                    err = ab(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             o.data_ptr(), b, hq, hkv, sq, skv,
                             int(causal), window, scale, softcap, stream)
                    if err:
                        raise RuntimeError(f"ab_flash_attention_tc256: "
                                           f"CUDA error {err}")
                return o
            return run

        port = fa.kernel_for(q.dtype, d)
        port_design = "wide"
        others = ["tc", "simt"]
        runs = {port_design: lambda: fa.flash_attention(q, k, v, **kw)}
        runs.update({x: entry(x) for x in others})
        want = ref.flash_attention_ref(q, k, v, **kw)
        atol, rtol = ref.flash_tolerance(want)       # bf16's bound
        want = want.float()
        qpos = torch.arange(sq, device="cuda")[:, None] + (skv - sq)
        kpos = torch.arange(skv, device="cuda")[None, :]
        keep = kpos <= qpos if causal else (kpos >= 0) & (qpos >= 0)
        if window:
            keep &= kpos > qpos - window
        ops = 4 * b * hq * d * int(keep.sum())
        nbytes = 2 * (2 * q.numel() + 2 * k.numel())
        row = {"q": list(qs), "kv": [b, hkv, skv, d], **kw,
               "port_kernel": port, "port_design": port_design,
               "bound_ms": max(ops / BF16_OPS_PER_S,
                               nbytes / HBM_BYTES_PER_S) * 1e3,
               "bound_by": ("operations" if ops / BF16_OPS_PER_S
                            >= nbytes / HBM_BYTES_PER_S else "bytes"),
               "designs": {}}
        for design, run in runs.items():
            got = run().float()
            d_ = (got - want).abs()
            ok = not bool((d_ > atol + rtol * want.abs()).any())
            row["designs"][design] = {"max_abs_err": float(d_.max()),
                                      "within_tolerance": ok,
                                      "device_ms": [], "ms": []}
            if not ok and design == port_design:
                failed.append(label)
        turns = [port_design] if quick else []
        for x in others:
            turns += [x] if quick else [x, port_design, port_design, x]
        for design in turns:
            cell = row["designs"][design]
            cell["device_ms"].append(device_ms(torch, runs[design],
                                               KERNELS[design]))
            cell["ms"].append(cuda_ms(torch, runs[design]))
        if sq == skv or not causal:
            key = "sdpa_ms" if not window and not softcap \
                else "sdpa_ms_without_window_softcap"
            row[key] = cuda_ms(torch, lambda: scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True))
        row.update(atol=atol, rtol=rtol)
        out["shapes"][label] = row
        print(f"{label}: " + json.dumps(row), file=sys.stderr)
        del q, k, v, o, want
        torch.cuda.empty_cache()
        if quick:
            break
    print(json.dumps({"flash_ab": out}))
    if failed:
        print(f"flash_ab: the port's kernel differs from the plain version "
              f"at {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
