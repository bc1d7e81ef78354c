#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA device (it exits non-zero without one) and the repository
around it: it imports nothing of the JAX package.  Phases:

1. versions, and the card's name and power limit from ``nvidia-smi``;
2. build every hand-written kernel from ``src/repro_torch/kernels/csrc``
   (``nvcc``, one process per source, all at once);
3. end to end: the synthetic world at scale 20 through ``Session`` on the
   card — Q7-agg (the Tesseract Q7 legs + a day group-by with count, avg
   and std_dev), Q9-agg (the same, ordered), Q11 (the dwell query) and Q1
   (traffic variability) — each held against the port's numpy oracle on
   the same FDb, with the fused launch contract (⌈shards/8⌉
   ``run_wave_fused`` per query) and every kernel's launch counter
   checked; the kernels' inputs are recorded in one more, untimed run;
4. kernels: each kernel against its plain PyTorch version on the card, at
   the wave shapes the main path gave it (every refine output mode, both
   segment_agg branches) and at one larger shape, timed with CUDA events
   beside the plain version and a library call;
5. profile: per warm query, the fused stages' times, the host functions
   (``cProfile``) and the device's busy share (``torch.profiler``).

It prints one ``{"kernels": [...]}`` line and, last, the device line.
Any mismatch or exception ends it with a non-zero exit code.

Tolerances: selections, ids, counts and integer tables are exact.  A
kernel's float64 sums may differ from the plain version's only by
summation order (≤ 1e-12 of the group's sum of |values|).  End to end,
the card stages aggregated values as float32 (relative perturbation
2^-24 per value), so sums and averages agree with the numpy oracle to a
relative 1e-6, and standard deviations — which subtract two terms of
size E[x²] — are held through the variance: |Δ(sd²)| ≤ 1e-6·(avg² + sd²).
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
SCALAR_OPS_PER_S = 67e12       # H100 SXM non-tensor 32-bit rate (data sheet)
WAVE = 8
WARM_RUNS = 5                  # warm wall time: the median of these
SCALE = 20.0
LARGE_POINTS = 1 << 21         # track points per shard at the larger shape
#: segment_agg.cu accumulates in shared memory up to this many groups
#: (kSharedMaxGroups) and with global atomics above it
SEG_SHARED_MAX_GROUPS = 2048
SEG_BRANCHES = ("global", "shared")
#: source files of the port, for the host profile (cProfile keys by name)
PORT_FILES = {p.name for p in (Path(__file__).resolve().parent / "src"
                               / "repro_torch").rglob("*.py")}

KERNELS = {
    "bitmap_intersect_batched": ("src/repro_torch/kernels/csrc/bitset.cu",
                                 "src/repro/kernels/bitset.py:148"),
    "compact_batched": ("src/repro_torch/kernels/csrc/compact.cu",
                        "src/repro/kernels/compact.py:129"),
    "segment_agg": ("src/repro_torch/kernels/csrc/segment_agg.cu",
                    "src/repro/kernels/segment_agg.py:74"),
    "refine_tracks_batched": ("src/repro_torch/kernels/csrc/refine.cu",
                              "src/repro/kernels/refine.py:243"),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def seg_branch(groups: int) -> str:
    """The segment_agg kernel that ``groups`` groups launch."""
    return "shared" if groups <= SEG_SHARED_MAX_GROUPS else "global"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    from repro_torch.core import BETWEEN, IN, P, Session, fdb, group, proto
    from repro_torch.data.synthetic import BAY_AREA, city_region, \
        generate_world
    from repro_torch.exec import Catalog, NumpyBackend, TorchBackend
    from repro_torch.fdb import build_fdb
    from repro_torch.kernels import _build, bitset, compact, ops, ref, \
        refine, segment_agg
    from repro_torch.tess import Tesseract

    # ---------------------------------------------------------- 1. device
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    _build.build_all()
    _build.library("bitset")
    print(f"build: {time.perf_counter() - t0:.1f} s ({len(_build.SOURCES)} "
          f"libraries, nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, log in sorted(_build.BUILD_LOGS.items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")

    # ----------------------------------------------------- 3. end to end
    t0 = time.perf_counter()
    world = generate_world(scale=SCALE, seed=0)
    cat = Catalog(server_slots=64)
    cat.register(build_fdb("SpeedObservations", world["observations_schema"],
                           world["observations"], num_shards=20))
    cat.register(build_fdb("Trips", world["trips_schema"], world["trips"],
                           num_shards=10))
    trips, obs = cat.get("Trips"), cat.get("SpeedObservations")
    print(f"world: scale {SCALE:g} in {time.perf_counter() - t0:.1f} s — "
          f"Trips {trips.num_docs} docs / "
          f"{sum(sh.batch['track.lat'].values.size for sh in trips.shards)} "
          f"points in {trips.num_shards} shards, SpeedObservations "
          f"{obs.num_docs} docs in {obs.num_shards} shards")

    day = 2

    def win(h0, h1):
        return day * 86400.0 + h0 * 3600.0, day * 86400.0 + h1 * 3600.0

    def q7_tess(ordered):
        a = Tesseract(city_region(*BAY_AREA), *win(6, 12))
        la = city_region("LA")
        return a.then(la, *win(6, 18)) if ordered else a.also(la,
                                                             *win(6, 18))

    trip_agg = (group(P.day).count("n").avg(d=P.duration_s)
                .std_dev(sd=P.duration_s))
    queries = {
        "Q7-agg": (lambda: fdb("Trips").tesseract(q7_tess(False))
                   .aggregate(trip_agg), True, True),
        "Q9-agg": (lambda: fdb("Trips").tesseract(q7_tess(True))
                   .aggregate(trip_agg), True, True),
        "Q11": (lambda: fdb("Trips").tesseract(
            Tesseract(city_region("SF"), *win(6, 12), label="sf")
            .dwell(600.0).also(city_region("Berkeley"), *win(6, 14),
                               label="berkeley"))
            .map(lambda p: proto(id=p.id)), True, False),
        "Q1": (lambda: fdb("SpeedObservations")
               .find(IN(P.loc, city_region("SF")) & BETWEEN(P.hour, 8, 9)
                     & BETWEEN(P.dow, 0, 4) & BETWEEN(P.month, 1, 1))
               .aggregate(group(P.road_id).avg(mean_speed=P.speed)
                          .std_dev(std_speed=P.speed).count("n"))
               .map(lambda p: proto(road_id=p.road_id, n=p.n,
                                    cov=p.std_speed / p.mean_speed)),
               False, True),
    }

    # Record each kernel's largest input on the main path (refine per
    # output mode, segment_agg per branch), calling straight through —
    # nothing extra launches.  Inputs are copied only in one more run after
    # the timed ones, so no timed run carries the copies; segment_agg's
    # launches per branch are counted in every run.
    captured = {}
    seg_branch_launches = {branch: 0 for branch in SEG_BRANCHES}
    wrappers = [(bitset, "bitmap_intersect_batched"),
                (compact, "compact_batched"),
                (segment_agg, "segment_agg"),
                (refine, "refine_tracks_batched")]
    originals = {name: getattr(mod, name) for mod, name in wrappers}

    recording = [False]
    capture_lock = threading.Lock()        # waves run on worker threads

    def recorder(name, fn):
        def call(*args, **kw):
            key = name
            if name == "refine_tracks_batched":
                key = (name, 2 if kw.get("with_analytics")
                       else int(bool(kw.get("with_first_hits"))))
            elif name == "segment_agg":
                branch = seg_branch(args[2])
                key = (name, branch)
                if args[0].numel() and args[2]:   # the wrapper launches
                    with capture_lock:
                        seg_branch_launches[branch] += 1
            if not recording[0]:
                return fn(*args, **kw)
            size = args[0].numel()
            with capture_lock:
                if key not in captured or captured[key][0] < size:
                    captured[key] = (size, tuple(
                        a.clone() if isinstance(a, torch.Tensor) else a
                        for a in args), dict(kw))
            return fn(*args, **kw)
        return call

    for mod, name in wrappers:
        setattr(mod, name, recorder(name, originals[name]))

    def check_close(qname, got, want):
        if len(got) != len(want):
            fail(f"{qname}: {len(got)} rows vs {len(want)} from the oracle")
        # order by the exact (integer) fields only
        key = [k for k in sorted(want[0] if want else {})
               if isinstance(want[0][k], (int, np.integer))]
        got = sorted(got, key=lambda r: tuple(r[k] for k in key))
        want = sorted(want, key=lambda r: tuple(r[k] for k in key))
        for g, w in zip(got, want):
            if set(g) != set(w):
                fail(f"{qname}: fields {sorted(g)} vs {sorted(w)}")
            for k, wv in w.items():
                gv = g[k]
                if isinstance(wv, (int, np.integer)):
                    ok = gv == wv
                elif k == "sd":
                    ok = abs(gv * gv - wv * wv) <= 1e-6 * (w["d"] ** 2
                                                           + wv * wv)
                elif k == "cov":
                    ok = abs(gv * gv - wv * wv) <= 1e-6 * (1.0 + wv * wv)
                else:
                    ok = abs(gv - wv) <= 1e-6 * abs(wv) + 1e-12
                if not ok:
                    fail(f"{qname}: {k} = {gv!r} vs oracle {wv!r} in {w}")

    oracle = Session(catalog=cat, backend=NumpyBackend())
    totals = {k: 0 for k in KERNELS}
    sessions = {}
    for qname, (make, has_refine, has_agg) in queries.items():
        flow = make()             # built (area covers included) off the clock
        t0 = time.perf_counter()
        want = oracle.run(flow).to_records()
        row = {"query": qname, "numpy_ms": (time.perf_counter() - t0) * 1e3}
        # a fresh backend per query: the cold run primes its device buffers
        sess = sessions[qname] = Session(catalog=cat, backend=TorchBackend())
        warm = []
        for run in ["cold"] + ["warm"] * WARM_RUNS + ["capture"]:
            recording[0] = run == "capture"
            ops.reset_launch_counts()
            _build.reset_kernel_launches()
            t0 = time.perf_counter()
            res = sess.run(flow)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if run == "cold":
                row["cold_ms"] = ms
            elif run == "warm":
                warm.append(ms)
            lc = ops.launch_counts()
            kc = _build.kernel_launches()
            shards = len(res.plan.shard_ids)
            waves = math.ceil(shards / WAVE)
            if lc != {"run_wave_fused": waves}:
                fail(f"{qname} {run}: dispatches {lc}, expected "
                     f"{{'run_wave_fused': {waves}}} for {shards} shards")
            need = {"bitmap_intersect_batched": waves,
                    "compact_batched": waves}
            if has_refine:
                need["refine_tracks_batched"] = waves
            for k, n in need.items():
                if kc.get(k, 0) != n:
                    fail(f"{qname} {run}: {k} launched {kc.get(k, 0)} "
                         f"times, expected {n}")
            if has_agg and kc.get("segment_agg", 0) < 1:
                fail(f"{qname} {run}: segment_agg never launched")
            for k in KERNELS:
                totals[k] += kc.get(k, 0)
            check_close(qname, res.to_records(), want)
            row.update(shards=shards, waves=waves, kernels=kc)
        row.update(warm_ms=sorted(warm)[len(warm) // 2], warm_min_ms=min(warm),
                   rows=len(want), match=True)
        print("e2e " + json.dumps(row))
    recording[0] = False
    for mod, name in wrappers:
        setattr(mod, name, originals[name])
    for k, n in totals.items():
        if n == 0:
            fail(f"kernel {k} was never launched on the main path")
    if sum(seg_branch_launches.values()) != totals["segment_agg"]:
        fail(f"segment_agg branch launches {seg_branch_launches} do not add "
             f"up to its {totals['segment_agg']} launches")
    for branch, n in seg_branch_launches.items():
        if n == 0 or ("segment_agg", branch) not in captured:
            fail(f"segment_agg's {branch} branch never ran on the main path")

    # --------------------------------------------------------- 4. kernels
    def cuda_ms(fn, iters):
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

    def bound(nbytes, nops):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, nops / SCALAR_OPS_PER_S
        return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else
                                     "operations")

    def exact(name, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for i, (g, w) in enumerate(zip(got, want)):
            if g.shape != w.shape or not torch.equal(g, w):
                fail(f"{name}: output {i} differs from the plain version")
        return 0.0

    def tile(t, reps, dim):
        return torch.cat([t] * reps, dim=dim).contiguous()

    p_wave = captured[("refine_tracks_batched", 0)][1][0].shape[2]
    reps = max(1, round(LARGE_POINTS / p_wave))

    def measure(name, run_kernel, run_plain, run_library, compare,
                nbytes, nops, iters, plain_iters):
        err = compare(run_kernel(), run_plain())
        b_ms, b_by = bound(nbytes, nops)
        return {"max_abs_err": err, "ms": cuda_ms(run_kernel, iters),
                "plain_ms": cuda_ms(run_plain, plain_iters),
                "library_ms": (cuda_ms(run_library, iters)
                               if run_library else None),
                "bound_ms": b_ms, "bound_by": b_by}

    def bitset_case(stack):
        s, k, w = stack.shape
        return (lambda: bitset.bitmap_intersect_batched(stack),
                lambda: ref.bitmap_intersect_batched_ref(stack), None,
                lambda g, w_: exact("bitset", g, w_),
                4 * s * k * w + 4 * s * w + 4 * s, s * w * (k + 1))

    def compact_case(masks):
        s, n = masks.shape
        return (lambda: compact.compact_batched(masks),
                lambda: ref.compact_batched_ref(masks),
                lambda: torch.nonzero(masks),
                lambda g, w_: exact("compact", g, w_),
                s * n + 4 * s * n + 4 * s, s * n)

    def segment_case(gid, vals, groups):
        """The case tuple for :func:`measure`, and the selected share.  The
        bound counts every group id, the values of selected rows only (the
        kernel loads no value of a masked row, and the function needs
        none) and the three [G] outputs; operations are a compare per row
        and a convert, a multiply and three adds per selected row."""
        n = gid.numel()
        # the library yardstick sums the selected rows only, as the kernel
        # does (masked rows folded into one slot would serialise on it)
        keep = gid >= 0
        selected = int(keep.sum())
        lib_idx = gid[keep].to(torch.int64)
        lib_vals = vals[keep].to(torch.float64)
        # per-group Σ|v| and Σv²: the scale of a reordered sum's error
        scales = ref.segment_agg_ref(gid, vals.abs(), groups)[1:]

        def compare(g, w):
            if not torch.equal(g[0], w[0]):
                fail("segment_agg: counts differ from the plain version")
            err = 0.0
            for a, b, scale in zip(g[1:], w[1:], scales):
                d = (a - b).abs()
                if bool((d > 1e-12 * scale).any()):
                    fail("segment_agg: sums differ beyond summation order")
                err = max(err, float(d.max()) if d.numel() else 0.0)
            return err

        return (lambda: segment_agg.segment_agg(gid, vals, groups),
                lambda: ref.segment_agg_ref(gid, vals, groups),
                lambda: torch.zeros(groups, dtype=torch.float64,
                                    device=gid.device).index_add_(
                                        0, lib_idx, lib_vals),
                compare, 4 * n + 4 * selected + 20 * groups,
                n + 5 * selected), selected / max(n, 1)

    def refine_case(args, kw):
        pts, rows, cov, docs = args
        mode = 2 if kw.get("with_analytics") else int(
            bool(kw.get("with_first_hits")))
        s, _, p = pts.shape
        c, _, r = cov.shape
        valid = int((rows >= 0).sum())
        out_b = 4 * s * docs + s * c * docs * (0, 8, 20)[mode]
        return (lambda: refine.refine_tracks_batched(*args, **kw),
                lambda: ref.refine_tracks_batched_ref(*args, **kw), None,
                lambda g, w_: exact("refine", g, w_),
                20 * s * p + 32 * c * r + out_b,
                valid * c * (3 + math.ceil(math.log2(max(r, 2)))))

    def large_refine(args, kw):
        pts, rows, cov, docs = args
        pts = tile(pts, reps, 2)
        rows = torch.cat([torch.where(rows >= 0, rows + i * docs, rows)
                          for i in range(reps)], dim=1).contiguous()
        return (pts, rows, cov, docs * reps), kw

    results = []
    for name, (src, replaces) in KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": totals[name]}
        if name == "refine_tracks_batched":
            modes = sorted(k[1] for k in captured
                           if isinstance(k, tuple) and k[0] == name)
            for mode in modes:            # every output mode, exact
                _, args, kw = captured[(name, mode)]
                case = refine_case(args, kw)
                case[3](case[0](), case[1]())
                largs, lkw = large_refine(args, kw)
                lcase = refine_case(largs, lkw)
                lcase[3](lcase[0](), lcase[1]())
            _, args, kw = captured[(name, 0)]
            wave = measure(name, *refine_case(args, kw), 50, 3)
            largs, lkw = large_refine(args, kw)
            large = measure(name, *refine_case(largs, lkw), 10, 1)
            shape, lshape = list(args[0].shape), list(largs[0].shape)
            entry["modes_checked"] = modes
        elif name == "bitmap_intersect_batched":
            stack = captured[name][1][0]
            wave = measure(name, *bitset_case(stack), 200, 20)
            big = tile(stack, reps, 2)
            large = measure(name, *bitset_case(big), 50, 5)
            shape, lshape = list(stack.shape), list(big.shape)
        elif name == "compact_batched":
            masks = captured[name][1][0]
            wave = measure(name, *compact_case(masks), 200, 20)
            big = tile(masks, reps, 1)
            large = measure(name, *compact_case(big), 50, 5)
            shape, lshape = list(masks.shape), list(big.shape)
        else:
            # each branch at its largest main-path input; the top-level
            # numbers are the global branch's (Q1's wave, the largest)
            branches = {}
            for branch in SEG_BRANCHES:
                gid, vals, groups = captured[(name, branch)][1]
                case, share = segment_case(gid, vals, groups)
                wave = measure(name, *case, 200, 20)
                if branch == "global":    # offset groups: the space grows
                    big_gid = torch.cat([torch.where(gid >= 0,
                                                     gid + i * groups, gid)
                                         for i in range(reps)]).contiguous()
                    big_groups = groups * reps
                else:                     # same groups: the branch holds
                    big_gid, big_groups = tile(gid, reps, 0), groups
                if seg_branch(big_groups) != branch:
                    fail(f"segment_agg: the larger shape left the {branch} "
                         "branch")
                big_vals = tile(vals, reps, 0)
                lcase, lshare = segment_case(big_gid, big_vals, big_groups)
                large = measure(name, *lcase, 50, 5)
                branches[branch] = {
                    "launches": seg_branch_launches[branch],
                    "shape": [gid.numel(), groups], "selected_share": share,
                    **wave, "large": {"shape": [big_gid.numel(), big_groups],
                                      "selected_share": lshare, **large}}
                print(f"kernel segment_agg[{branch}]: wave "
                      f"{[gid.numel(), groups]} selected {share:.4f} "
                      f"{wave['ms']:.4f} ms (bound {wave['bound_ms']:.6f}, "
                      f"plain {wave['plain_ms']:.3f}, index_add_ "
                      f"{wave['library_ms']:.4f}); large "
                      f"{[big_gid.numel(), big_groups]} {large['ms']:.4f} ms "
                      f"(bound {large['bound_ms']:.6f}, plain "
                      f"{large['plain_ms']:.3f}, index_add_ "
                      f"{large['library_ms']:.4f})")
            top = branches["global"]
            wave = {k: top[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "library_ms", "bound_ms",
                                        "bound_by")}
            large = {k: v for k, v in top["large"].items() if k != "shape"}
            shape, lshape = top["shape"], top["large"]["shape"]
            entry.update(selected_share=top["selected_share"],
                         branches=branches)
        entry.update(wave)
        entry.update(match=True, kernel_ms=wave["ms"], shape=shape,
                     large={"shape": lshape, **large})
        results.append(entry)
        print(f"kernel {name}: wave {shape} {wave['ms']:.4f} ms "
              f"(bound {wave['bound_ms']:.4f}, plain {wave['plain_ms']:.3f}"
              f"); large {lshape} {large['ms']:.4f} ms (bound "
              f"{large['bound_ms']:.4f}, plain {large['plain_ms']:.3f})")

    profile_queries(torch, queries, sessions)
    print(smi)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def profile_queries(torch, queries, sessions) -> None:
    """Phase 5: where a warm query's wall time goes.

    - With waves run one after another (``num_servers=1``): one run with
      the backend's per-stage sync + timer (``ExecConfig(profile=True)``:
      upload, probe, refine, compact, agg), and one under ``cProfile``
      for the host functions (cumulative ms of the port's own functions,
      self ms of any).
    - As the smoke run drives it (waves on a thread pool): one run under
      ``torch.profiler`` for the device's busy time (the sum of its
      kernels' and copies' self time) and the top device entries."""
    import cProfile
    import pstats
    from torch.autograd import DeviceType
    from repro_torch.core import Session
    from repro_torch.exec import AdHocEngine, ExecConfig
    from repro_torch.kernels import fused

    def timed(sess, flow):
        t0 = time.perf_counter()
        sess.run(flow)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for qname, (make, _, _) in queries.items():
        flow = make()
        warm = sessions[qname]
        backend = warm.engine.backend

        def sequential(profile):
            return Session(engine=AdHocEngine(
                catalog=warm.catalog, num_servers=1,
                config=ExecConfig(backend=backend, profile=profile)))

        staged = sequential(True)
        staged.run(flow)
        fused.reset_stage_times()
        staged_ms = timed(staged, flow)
        stages = fused.stage_times()
        seq = sequential(False)
        seq.run(flow)
        host = cProfile.Profile()
        host.enable()
        host_ms = timed(seq, flow)
        host.disable()
        rows = [(ct * 1e3, tt * 1e3, f"{Path(f).name}:{fn}")
                for (f, _line, fn), (_cc, _nc, tt, ct, _) in
                pstats.Stats(host).stats.items()]
        own = sorted((r for r in rows if "repro_torch" in r[2]
                      or r[2].split(":")[0] in PORT_FILES),
                     key=lambda r: -r[0])[:12]
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            wall_ms = timed(warm, flow)
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
        print("profile " + json.dumps({
            "query": qname, "sequential_staged_wall_ms": staged_ms,
            "stages_ms": stages, "sequential_cprofile_wall_ms": host_ms,
            "host_cum_ms": {name: round(ct, 3) for ct, _, name in own},
            "host_self_ms": {name: round(tt, 3) for _, tt, name in
                             sorted(rows, key=lambda r: -r[1])[:8]},
            "profiled_wall_ms": wall_ms,
            "device_busy_ms": busy_ms if dev else "not measured",
            "device_idle_share": (1 - busy_ms / wall_ms) if dev
            else "not measured",
            "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3
                              for e in top}}))


if __name__ == "__main__":
    sys.exit(main())
