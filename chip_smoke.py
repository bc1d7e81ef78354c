#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card
(phases 3h, 3i and 3j on every visible card, with two or more).

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
3b. serve: ``QueryServer(backend=TorchBackend(), cache=False)`` drains
   four batches of 16 queries with ``run_pending()`` — three Trips
   batches of Tesseract queries over varied city pairs and windows
   (``also``, ``then``, dwell / ``at_least``: refine modes 0, 1, 2) and
   one of SpeedObservations index probes with a per-road aggregate —
   each query held against the numpy oracle run alone, one coalesced
   batch a group, ⌈shards/8⌉ ``run_wave_fused_multi`` a batch and one
   multi-query refine launch a Trips wave; the batch's wall time beside
   16 single queries on the same backend; a repeat with the result cache
   on launches nothing;
3c. filter: the paper's Q2 in its ``geo_index`` and ``full_scan`` modes
   (``.filter()`` after the read, the single-mask ``compact`` per shard)
   against the oracle;
3d. retry: Q7-agg and Q1 with two shards failing once (``FaultPlan``),
   retried through the single-shard seam (``bitmap_intersect``,
   ``compact``, the S=1 ``refine_tracks``), against the oracle;
3e. lm: the LM serving path (``launch.serve.Server``) at full width —
   SmolLM-360M at full depth (32 layers), Jamba-v0.1 cut to one block
   cycle (8 of 32 layers: 7 Mamba + 1 attention, MoE on odd layers; the
   full 52B does not fit one card) and xLSTM-1.3B at full depth (48
   layers, 6 × (7 mLSTM + 1 sLSTM), plain PyTorch cells) — with seeded
   random bf16 weights, answering 8 requests (prompts of 64-512 random
   tokens, 16 new tokens each): flash_attention launches = attention
   layers × prefills and selective_scan launches = Mamba layers ×
   prefills (0 and 0 for xLSTM), no other kernel; then prefill
   and decode times, peak memory and the device's idle share of one warm
   ``generate_batch`` (xLSTM: of its 15 decode steps; the profiler takes
   ~90 s to process the sLSTM loop of a prefill); then, in float32 with
   dropless MoE, the decode logits at position S-1 after a prefill of S-1
   tokens against the prefill's logits over S tokens (the kernel path
   against the plain decode path).  Then Whisper large-v3 at full width
   and depth (32 encoder + 32 decoder layers; ``Server`` takes no frames,
   as the reference's): seeded frame embeddings [4, 1500, 1280] bf16, 4
   decoder prompts of 4-224 tokens left-padded, ``LM.prefill(frames=)``
   and 15 greedy ``decode_step``s, 96 flash_attention launches a prefill
   (32 non-causal encoder, 32 non-causal cross, 32 causal decoder calls),
   the same timings and the same float32 check.  Last Gemma 3 12B at
   full width and depth (48 layers: 40 local with window 1024 and 8
   global, 16 / 8 heads at hd 256, softcap 50; 8.93B params, 17.87 GB in
   bf16: ``params_count()``'s 11.77B counts a gated MLP that the config's
   GELU block does not have) through ``Server`` on the same traffic: one
   flash_attention launch a layer a prefill (the hd-256 tensor-core
   kernel), decode through the local layers' rolling window caches, the
   float32 check
   after the bf16 model is freed (42.6 GB peak on an H100 80GB HBM3 at
   700 W);
3f. engines: on the same world, each check against the numpy oracle —
   flume: Q7-agg and Q1 through ``FlumeEngine`` (checkpoints in a
   temporary directory), ⌈shards/8⌉ ``run_wave_fused`` a job, a second
   ``collect`` of the same job running no task and launching nothing,
   beside ``AdHocEngine`` on the same backend; partitions: Q7-agg, Q1
   and Q11 at P = 2 and 4 on the one card, byte-identical to P = 1 there,
   Σ_p ⌈shards_p/8⌉ ``run_wave_fused`` plus ``merge_combines()``
   ``merge_partials``, then Q7-agg at P = 4 with partition 1 failing once
   (rerouted, counted on ``profile.retries``); hll: per-hour
   ``approx_distinct`` of road ids over all SpeedObservations (24 groups
   × 4,096 registers) and Trips ``distinct_approx`` at P = 1/2/4, the
   registers byte-equal to the oracle's, one ``segment_hll`` a finalize;
   each sub-phase's warm wall time, launches and busy share on an
   ``engines`` line;
3g. train (``train`` lines, no kernel of the port launched in a train
   step): time-to-trained-model as ``examples/ml_workflow.py`` runs it on
   the same world with ``Roads`` registered — ``to_dataset`` over
   SpeedObservations months 1–4 (hour, dow and the road's speed limit
   through a ``Roads`` lookup → speed) through ``AdHocEngine`` on the
   card, byte-equal to the numpy oracle's selection; ``fit(hidden=64,
   depth=2, steps=400, lr=2e-3, batch=1024)`` on the card, its loss curve
   within 1e-4 of the same fit on the CPU (the same initial params and
   index stream, TF32 off) and its idle share under the profiler;
   ``model_apply`` over months 5–6 with an MSE aggregate (RMSE must beat
   the targets' standard deviation); an annotation ``save`` and a model
   ``save``/``load`` predicting the same values.  Then ``launch.train.
   train_loop`` on SmolLM-360M at full width and depth (float32 params,
   ``remat="full"``, batch 8 × 512 tokens from ``TokenPipeline``, 6 steps,
   checkpoints every 3), a resume from step 3 repeating steps 3–5 and the
   final params and optimizer state bit for bit, no kernel
   launched; three reduced Jamba steps (float32 activations) on
   the card against the CPU from the same params; ``geo.denoise.snap_path`` for 1,000 waypoints × 2,000 segments
   on the card equal to the CPU's path;
3h. cards (with two CUDA devices or more; with one it prints a line
   saying it did not run): each partition's waves on its own card, card
   p mod D of the exec mesh — Q7-agg, Q1 and Q11 at P = 2, 4 and the
   default P (which must be the card count), and Q1 on SpeedObservations
   rebuilt at 128 shards (4 waves a partition at P = 4), each byte-identical to
   P = 1 on card 0 and close to the oracle, Σ_p ⌈shards_p/8⌉
   ``run_wave_fused`` plus one ``merge_partials`` for an aggregate, each
   partition's kernel launches counted on its card; Q7-agg at P = 4 with
   partition 1 failing once; a ``FlumeEngine`` Q7-agg job at P = 4; the
   trips-also serve batch at P = 4 against P = 1; a streaming source
   appended to and primed again at P = 4 (only the new buffers copied,
   on each card; a warm repeat copies nothing); warm medians, cold
   times, each card's idle share and where a P = 4 run's host time goes
   on ``cards`` lines.  While it runs no partition count is set, and
   phases 3-3g, 4 and 5 run at P = 1 on card 0 whatever the card count;
3i. mesh (with two CUDA devices or more; with one it prints a line saying
   it did not run): the ML meshes, one worker process a card started with
   ``python -m torch.distributed.run --standalone`` (this script with
   ``--mesh-worker``, NCCL, ``PYTHONPATH=src``); any worker's failure
   fails the phase.  Qwen1.5-0.5B at full width and depth (24 layers, d
   1024, 16/16 heads, d_ff 2816, vocab 151936, untied), float32 params and
   activations, TF32 off, ``remat="full"``, batch 8 × 512 from
   ``TokenPipeline``, two ``ModelBundle`` train steps on each mesh — on
   four cards data 4 (plain, ``zero1``, ``fsdp``) and data 2 × model 2
   (``seq_parallel`` on and off, ``compress_grads``), on two cards data 2
   and model 2 — each held against the one-device step on card 0 from the
   same seed with phase 3g's bounds (loss, grad norm, first-step
   gradients leaf by leaf, the STEP_SIGNAL rule for the first update, the
   last params within 2·Σ lr); each rank's local bytes of params and
   optimizer state equal to the specs' per-device bytes
   (``reshard_plan``); ``compressed_psum`` over the data axis against the
   numpy mean of the dequantized int8 payloads; ``train_loop(mesh=)``
   saving at step 2 on 2 × 2 (model 2 on two cards), the checkpoint
   restored onto data 4 (data 2) bit for bit and placed as that mesh's
   specs say, and a resume there running steps 2–3; no kernel launched on
   any card.  ``mesh`` lines: each mesh's warm step ms and tokens/s beside
   the one-device step, peak bytes a card, each card's busy share and the
   share of its device time in NCCL kernels (``torch.profiler``, one more
   step), and the seconds the phase took;
3j. mesh serve (with two CUDA devices or more; with one it prints a line
   saying it did not run): serving through the kernels on a mesh,
   ``ModelBundle(cfg, mesh, impl="kernel")``'s ``make_prefill`` and
   ``make_decode_step``, one worker process a card as in 3i (this script
   with ``--mesh-serve-worker``).  Rows on four cards, bf16 at full width:
   SmolLM-360M on 1 × 4 (15/5 heads: every card gathers the heads and
   runs row 9 over all of them), Whisper large-v3 on 1 × 4 (5 heads a
   card; row 9 non-causal over the 1,500 encoder positions and as cross
   attention), Jamba-v0.1 cut to 8 of 32 layers on 1 × 4 and 2 × 2 (8 q
   and 2 KV heads, 4 experts and 2,048 Mamba channels a card at 1 × 4),
   and Jamba-v0.1 at full depth (32 layers, 52B params, ~26 GB a card) on
   1 × 4; on two cards the first three on 1 × 2.  Each row serves phase
   3e's traffic (8 requests of 64-512 tokens in two left-padded batches
   of 4, [4, 445] and [4, 202]; Whisper: frames [4, 1500, 1280] and 4
   prompts [4, 191]): a prefill and 15 greedy decode steps a batch, every
   card's row 9 / row 10 launches equal to the layers' count
   (``_build.kernel_launches(device=)``), the caches placed as
   ``cache_shardings`` says, each card's local parameter bytes equal to
   the specs' (``launch.elastic.per_device_bytes``).  Card 0 first runs
   the one-card prefills of the rows it holds alone and frees them; each
   such row is held to them: the bf16 prefill of the first batch within
   LM_CHECK_REL of the largest |logit| (or twice card 0's own bf16 noise,
   MESH_F32_REL's comment), the float32 one (dropless MoE, LM_CHECK_SHAPE,
   the bf16 weights cast) within MESH_F32_REL and argmax equal.  The full-depth
   Jamba is built without any rank holding it (4 one-cycle inits, seeds
   0-3, cut locally by the 32-layer tree's specs and stacked along the
   group dim) and held by the prefill↔decode consistency of phase 3e on
   the mesh in float32 (the served bf16 weights cast on the cards, ~52 GB
   a card).
   ``mesh_serve`` lines: cold and warm prefill ms, decode ms a step,
   tokens/s, peak and parameter bytes a card, launches a card, busy, idle
   and NCCL share a card over a prefill and 3 decode steps, the checks'
   errors and bounds, the card line;
3k. dryrun: ``launch.dryrun`` held to real steps.  In a process of its
   own (this script with ``--dryrun-worker``): phase 3g's SmolLM-360M
   train step (float32 params and moments, bf16 activations, batch 8 ×
   512, remat full, the full logits) dry-run on fake tensors, then run on
   the card from seeded params — one warm step, then one under the same
   ``StepCounter`` on real tensors with the allocator's peak reset just
   before it: the predicted peak within DRYRUN_PEAK_REL of
   ``max_memory_allocated()`` or DRYRUN_PEAK_ABS, whichever is larger, the
   FLOPs equal to the card's count, no kernel launched.  Then
   ``qwen1_5_0_5b × train_4k × 16x16`` through the CLI (``python -m
   repro_torch.launch.dryrun``, this host's torch) and its seconds.  With
   four cards or more: each of 3i's four-card meshes dry-run on a fake
   4-rank group (``--dryrun-mesh-worker``, on the host while 3i runs) and
   held to rank 0's real NCCL step (one more step in 3i under
   ``CommDebugMode``): the collectives a kind equal, the argument bytes
   equal to the local parameter, optimizer and batch bytes, every card's
   peak of that step within the bound; 3j's full-depth Jamba on 1 × 4:
   the predicted parameter bytes a card equal to every card's.  With
   fewer cards it prints that the four-card part did not run.  ``dryrun``
   lines: predicted and measured bytes by category, FLOPs, seconds;
4. kernels: each kernel against its plain PyTorch version on the card, at
   the largest shape the main path gave it (both segment_agg branches —
   the shared one must give the same bits from two calls, and the library
   call is one ``index_add_`` of (1, v, v²) into [G, 3]; each refine
   wrapper in every output mode it ran in, at both shapes, two calls equal
   bit for bit; compact_batched at the wave's and the
   serve phase's stacks; flash_attention at each LM configuration's bf16
   prefill — Whisper's encoder self-attention and cross-attention too,
   non-causal, against SDPA with ``is_causal=False`` — naming the kernel
   its dispatch ran, the tensor-core one at head dims 64, 128 and 256
   (Gemma 3 12B's, window 1024, softcap 50, against ``flex_attention``
   with the softcap and the window, SDPA's causal time without them
   beside, and two larger Gemma calls from its
   recorded prefill tiled along the sequence: a local layer at 4,096
   positions, where the window skips tiles, and a global one at 1,780);
   its larger shape is the largest causal prefill call at hd 64 or 128
   tiled 4× along the sequence) and at one larger shape, timed with CUDA
   events beside the plain version and a library call, and its wrapper's
   device
   time and device operations per call from ``torch.profiler``
   (``device_ms``, ``device_ops``, ``device_records``); then the two
   plain PyTorch ops of phase 3f (``segment_hll``, ``merge_partials``) at
   their phase-3f inputs, against the same function on the CPU bit for
   bit, timed the same way (an ``engine_ops`` line: they are not kernels);
4b. launch_path: µs a call of each step of a kernel launch through the
   entry table, of the ``bitset_binary`` and ``segment_agg`` wrappers and
   of ``torch.bitwise_and``, 10,000 calls a step, the median of 5 turns;
   each wrapper's launch counter must grow by its calls;
5. profile: per warm query, the fused stages' times, the host functions
   (``cProfile``) and the device's busy share (``torch.profiler``); per
   serve batch, the host functions and the device's busy share of one
   warm ``run_pending()``.  Here and in phase 3e the port's kernels count
   against their launches in the window (the profiler loses records),
   PyTorch's own device operations as recorded.

Every main-path run sets the launch counters to 0 just before it and
reads them just after; a kernel's ``launches`` is the sum over phases
3-3g.  Each phase prints its seconds.
``bitset_binary`` (row 8) is on no path of the engines (only
``ops.bitmap_binary`` reaches it), so it reports 0 launches and is held
and timed in phase 4 only.

It prints one ``{"kernels": [...]}`` line and, last, the device line.
Any mismatch or exception ends it with a non-zero exit code.

    python3 chip_smoke.py --require-cards N

fails unless N or more CUDA devices are visible (a run on four cards
cannot then take the one-card route), and otherwise runs as above.

    python3 chip_smoke.py --launch-path ROOT

runs phases 2 and 4b alone for the port under ``ROOT/src`` (two trees'
launch paths compared in one call, one process each).

    python3 chip_smoke.py --mesh-only

runs phase 1's card line and phases 3i, 3j and 3k alone (two cards or
more).

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
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
SCALAR_OPS_PER_S = 67e12       # H100 SXM non-tensor 32-bit rate (data sheet)
BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor rate (data sheet)
# H100 SXM exps (MUFU.EX2): 16 a clock an SM against 256 FP32 operations
SFU_OPS_PER_S = SCALAR_OPS_PER_S / 16
WAVE = 8
WARM_RUNS = 5                  # warm wall time: the median of these
SCALE = 20.0
LARGE_POINTS = 1 << 21         # track points per shard at the larger shape
SEG_BRANCHES = ("global", "shared")
#: launch_path: calls a step, and its inputs — bitset_binary's words (a
#: shard bitmap of the retry phase) and segment_agg's wave shapes (rows,
#: groups, selected share) on each branch
LAUNCH_PATH_CALLS = 10_000
LAUNCH_PATH_REPEATS = 5
LAUNCH_PATH_WORDS = 625
LAUNCH_PATH_SEG = {"shared": (19_200, 56, 0.0075),
                   "global": (160_000, 77_888, 0.0049)}
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
    "refine_tracks_multi": ("src/repro_torch/kernels/csrc/refine.cu",
                            "src/repro/kernels/refine.py:402"),
    "bitmap_intersect": ("src/repro_torch/kernels/csrc/bitset.cu",
                         "src/repro/kernels/bitset.py:97"),
    "compact": ("src/repro_torch/kernels/csrc/compact.cu",
                "src/repro/kernels/compact.py:59"),
    "bitset_binary": ("src/repro_torch/kernels/csrc/bitset.cu",
                      "src/repro/kernels/bitset.py:53"),
    # row 4's kernel at S=1 (the retry path's single-shard refine)
    "refine_tracks": ("src/repro_torch/kernels/csrc/refine.cu",
                      "src/repro/kernels/refine.py:431"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:137"),
    "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:63"),
    # no TPU kernel of its own: the chunk passes of the reference's Mamba
    # layer (exp, (dt·x)·B, y = h·C) fused with row 10's scan
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/ml/mamba.py:102"),
}
#: the port's device kernels, by their function names in csrc/*.cu, under
#: the launch counters of the wrappers that run them: each counted launch
#: runs one of its family's kernels outside FOLLOWERS, and each follower
#: runs once after one of them (segment_agg's shared branch: partials,
#: then combine)
KERNEL_FAMILIES = {
    ("bitmap_intersect_batched", "bitmap_intersect"): ("intersect_kernel",),
    ("bitset_binary",): ("binary_kernel",),
    ("compact_batched", "compact", "mask_prefix_sum"): ("mask_scan_kernel",),
    ("segment_agg",): ("seg_partials_kernel", "seg_combine_kernel",
                       "seg_global_kernel"),
    ("refine_tracks_batched", "refine_tracks_multi", "refine_tracks"):
        ("refine_kernel",),
    ("flash_attention",): ("flash_simt_kernel", "flash_tc_kernel",
                           "flash_wide_kernel"),
    ("ssm_scan",): ("ssm_scan_kernel",),
    ("selective_scan",): ("selective_scan_kernel",),
}
FOLLOWERS = {"seg_combine_kernel"}
#: kernels no main path launches (held and timed in phase 4 only): row 8,
#: and row 10, whose Mamba layer launches the fused selective_scan
OFF_PATH = {"bitset_binary", "ssm_scan"}
#: refine wrappers whose recorded inputs are kept per output mode
REFINES = ("refine_tracks_batched", "refine_tracks_multi", "refine_tracks")
SERVE_BATCH = 16
#: shards that fail once in the retry phase
FAILING_SHARDS = (1, 3)
#: the lm phase: requests of random tokens with prompt lengths drawn from
#: [64, 512] by numpy.random.default_rng(0), 16 new tokens each, through
#: Server(cfg, reduced=False, max_batch=4)
LM_REQUESTS = 8
LM_MAX_BATCH = 4
LM_MAX_NEW = 16
LM_PROMPT_LENS = (64, 512)
#: Mamba chunk length (mamba_apply's default): the unfused chain's chunk
#: that phase 4 times the fused kernel against, and row 10's call there
LM_SSM_CHUNK = 256
#: phase 4's larger selective_scan call: the benchmark's Jamba prefill
#: [batch, positions] (the recorded call tiled)
SELECTIVE_LARGE = (16, 2048)
#: prefill↔decode consistency: batch and prompt length
LM_CHECK_SHAPE = (2, 300)
#: and its bound: relative to max |logit|, as tests/test_models.py holds
#: the JAX package (the decode caches are bf16 in both packages)
LM_CHECK_REL = 0.02
#: Whisper: frame embeddings [batch, encoder positions] (30 s of audio at
#: the encoder's 50 positions a second) and decoder prompt lengths drawn
#: from this range (its decoder context is 448)
#: phase 4's larger Gemma 3 12B calls, its recorded prefill tiled along
#: the sequence (the serve traffic never reaches the window): name →
#: (positions, options)
GEMMA_LARGE_CALLS = {
    "local": (4096, {"causal": True, "window": 1024, "softcap": 50.0}),
    "global": (1780, {"causal": True, "softcap": 50.0})}
WHISPER_FRAMES = (4, 1500)
WHISPER_PROMPT_LENS = (4, 224)
#: kernel vs plain version: flash_attention within ``ref.flash_tolerance``
#: of the output compared (an ulp of the element and of the largest element
#: in bf16); ssm_scan 3e-4, as the JAX package holds its kernels;
#: selective_scan against the unfused chain within 1e-5 of max |y| (and
#: of max |h_final|): the same float32 operations but y's N-term sum
SSM_TOL = 3e-4
SELECTIVE_REL = 1e-5
#: the flash kernels' key tile (kBK in flash_attention.cu): a non-causal
#: call with a partial last tile also checks that the bound rejects a
#: result without that tile
FLASH_KEY_TILE = 64


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def seg_branch(groups: int) -> str:
    """The segment_agg kernel that ``groups`` groups launch."""
    from repro_torch.kernels import segment_agg
    return "shared" if groups <= segment_agg.SHARED_MAX_GROUPS else "global"


def main(require_cards: int = 1) -> int:
    import os
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    n_cards = torch.cuda.device_count()
    if n_cards < require_cards:
        print(f"chip_smoke: {n_cards} CUDA device(s) visible, "
              f"--require-cards {require_cards}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    from repro_torch.core.planner import PARTITIONS_ENV
    if n_cards > 1:
        # phases 3-3g, 4 and 5 hold their one-card contracts (P = 1 on
        # card 0) whatever the card count; phase 3h lifts this, so that P
        # defaults to the card count there
        os.environ[PARTITIONS_ENV] = "1"
    from repro_torch.core import BETWEEN, IN, P, Session, fdb, group, proto
    from repro_torch.core import exprs
    from repro_torch.data.synthetic import BAY_AREA, NEIGHBORS, \
        city_region, generate_world
    from repro_torch.exec import Catalog, FaultPlan, NumpyBackend, \
        TorchBackend
    from repro_torch.serve import QueryServer
    from repro_torch.fdb import build_fdb
    from repro_torch.kernels import _build, bitset, compact, fused, merge, \
        ops, ref, refine, segment_agg
    from repro_torch.kernels import flash_attention as fa_kernel
    from repro_torch.tess import Tesseract

    phase_t0 = [time.perf_counter()]

    def phase_done(name):
        """Print the seconds since the last phase ended."""
        now = time.perf_counter()
        print(f"phase {name}: {now - phase_t0[0]:.1f} s")
        phase_t0[0] = now

    # ---------------------------------------------------------- 1. device
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    smi = card_line()
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
    phase_done("1-2 device and build")

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

    def q1_flow(source):
        return (fdb(source)
                .find(IN(P.loc, city_region("SF")) & BETWEEN(P.hour, 8, 9)
                      & BETWEEN(P.dow, 0, 4) & BETWEEN(P.month, 1, 1))
                .aggregate(group(P.road_id).avg(mean_speed=P.speed)
                           .std_dev(std_speed=P.speed).count("n"))
                .map(lambda p: proto(road_id=p.road_id, n=p.n,
                                     cov=p.std_speed / p.mean_speed)))
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
        "Q1": (lambda: q1_flow("SpeedObservations"), False, True),
    }

    # Record each kernel's largest input on the main path (refine per
    # output mode, segment_agg per branch), calling straight through —
    # nothing extra launches.  Inputs are copied only in one more run after
    # the timed ones, so no timed run carries the copies; segment_agg's
    # launches per branch are counted in every run.  Each phase records
    # the kernels it brings in (rows 1-4 at their phase-3 shapes as in
    # earlier runs; the serve phase's folded [Q·S, ...] probe and compact
    # stacks under their own key).
    captured = {}
    seg_branch_launches = {branch: 0 for branch in SEG_BRANCHES}
    wrappers = [(bitset, "bitmap_intersect_batched"),
                (compact, "compact_batched"),
                (segment_agg, "segment_agg"),
                (refine, "refine_tracks_batched"),
                (refine, "refine_tracks_multi"),
                (bitset, "bitmap_intersect"),
                (compact, "compact"),
                (refine, "refine_tracks")]
    originals = {name: getattr(mod, name) for mod, name in wrappers}

    phase_kernels = {
        "e2e": {"bitmap_intersect_batched", "compact_batched", "segment_agg",
                "refine_tracks_batched"},
        "serve": {"refine_tracks_multi", "bitmap_intersect_batched",
                  "compact_batched"},
        "filter": {"compact"},
        "retry": {"bitmap_intersect", "compact", "refine_tracks"}}
    recording = [None]                     # the phase being recorded
    capture_lock = threading.Lock()        # waves run on worker threads

    def recorder(name, fn):
        def call(*args, **kw):
            key = name
            if name in REFINES:
                key = (name, 2 if kw.get("with_analytics")
                       else int(bool(kw.get("with_first_hits"))))
            elif name == "segment_agg":
                branch = seg_branch(args[2])
                key = (name, branch)
                if args[0].numel() and args[2]:   # the wrapper launches
                    with capture_lock:
                        seg_branch_launches[branch] += 1
            phase = recording[0]
            if phase is None or name not in phase_kernels[phase]:
                return fn(*args, **kw)
            if phase == "serve" and name in phase_kernels["e2e"]:
                key = (name, "serve")
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
            recording[0] = "e2e" if run == "capture" else None
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

    def counted(run, fn, phase=None):
        """Drive one main-path run with every launch count set to 0 just
        before and read just after (``phase``'s kernel inputs recorded on
        ``capture`` runs); returns (result, dispatches, kernel launches,
        wall ms)."""
        recording[0] = phase if run == "capture" else None
        ops.reset_launch_counts()
        _build.reset_kernel_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        lc, kc = ops.launch_counts(), _build.kernel_launches()
        recording[0] = None
        for k in KERNELS:
            totals[k] += kc.get(k, 0)
        return out, lc, kc, ms

    def need_launches(where, kc, need):
        for k, n in need.items():
            if kc.get(k, 0) != n:
                fail(f"{where}: {k} launched {kc.get(k, 0)} times, expected "
                     f"{n}")

    phase_done("3 e2e")

    # ------------------------------------------------------------ 3b. serve
    pairs = [(a, b) for a, bs in NEIGHBORS.items() for b in bs][:SERVE_BATCH]

    def trips_batch(kind):
        flows = []
        for i, (a, b) in enumerate(pairs):
            h = 5 + i % 4
            t = Tesseract(city_region(a), *win(h, h + 6))
            if kind == "dwell":
                t = t.dwell(600.0) if i % 2 == 0 else t.at_least(2)
            leg = (city_region(b), *win(h + 1, h + 13))
            t = t.then(*leg) if kind == "then" else t.also(*leg)
            flows.append(fdb("Trips").tesseract(t)
                         .map(lambda p: proto(id=p.id, day=p.day)))
        return flows

    obs_cities = [c for c in BAY_AREA]
    obs_flows = [fdb("SpeedObservations")
                 .find(IN(P.loc, city_region(obs_cities[i % 4]))
                       & BETWEEN(P.hour, 6 + i // 4, 7 + i // 4)
                       & BETWEEN(P.dow, 0, 4))
                 .aggregate(group(P.road_id).count("n").avg(d=P.speed))
                 for i in range(SERVE_BATCH)]
    batches = {"trips-also": ("Trips", trips_batch("also"), 0),
               "trips-then": ("Trips", trips_batch("then"), 1),
               "trips-dwell": ("Trips", trips_batch("dwell"), 2),
               "obs-index": ("SpeedObservations", obs_flows, None)}
    serve_backend = TorchBackend()
    singles = Session(catalog=cat, backend=serve_backend)
    refine_waves = 0
    for bname, (source, flows, mode) in batches.items():
        t0 = time.perf_counter()
        want = [oracle.run(f).to_records() for f in flows]
        row = {"batch": bname, "queries": len(flows), "refine_mode": mode,
               "numpy_singly_ms": (time.perf_counter() - t0) * 1e3,
               "rows": sum(len(w) for w in want)}
        waves = math.ceil(cat.get(source).num_shards / WAVE)
        srv = QueryServer(backend=serve_backend, catalog=cat, cache=False,
                          start=False)
        for run in ("cold", "warm", "capture"):
            futs = [srv.submit(f) for f in flows]
            before = srv.stats()["coalesced_batches"]
            _, lc, kc, ms = counted(run, srv.run_pending, "serve")
            where = f"serve {bname} {run}"
            if srv.stats()["coalesced_batches"] - before != 1:
                fail(f"{where}: {srv.stats()} — expected one coalesced "
                     "batch")
            if lc.get("run_wave_fused_multi", 0) != waves \
                    or "run_wave_fused" in lc:
                fail(f"{where}: dispatches {lc}, expected "
                     f"{{'run_wave_fused_multi': {waves}}}")
            need = {"bitmap_intersect_batched": waves,
                    "compact_batched": waves,
                    "refine_tracks_multi": waves if mode is not None else 0}
            need_launches(where, kc, need)
            refine_waves += kc.get("refine_tracks_multi", 0)
            for i, (fut, w) in enumerate(zip(futs, want)):
                check_close(f"{where} q{i}", fut.result(600).to_records(), w)
            row[f"{run}_ms"] = ms
            row[f"{run}_kernels"] = kc
        # the same 16 queries one by one on the same (warm) backend
        counted("singles", lambda: [singles.run(f) for f in flows])
        _, _, _, row["singles_warm_ms"] = counted(
            "singles", lambda: [singles.run(f) for f in flows])
        # with the result cache on, a repeat launches nothing
        cached = QueryServer(backend=serve_backend, catalog=cat,
                             start=False)
        futs = [cached.submit(f) for f in flows]
        counted("fill", cached.run_pending)
        futs = [cached.submit(f) for f in flows]
        _, lc, kc, row["cached_ms"] = counted("cached", cached.run_pending)
        if lc or kc or cached.stats()["cache_hits"] != len(flows):
            fail(f"serve {bname} cached: dispatches {lc}, kernels {kc}, "
                 f"stats {cached.stats()}")
        for i, (fut, w) in enumerate(zip(futs, want)):
            check_close(f"serve {bname} cached q{i}",
                        fut.result(600).to_records(), w)
        row.update(shards=cat.get(source).num_shards, waves=waves,
                   match=True)
        print("serve " + json.dumps(row))
    if refine_waves != 3 * 3 * math.ceil(trips.num_shards / WAVE):
        fail(f"refine_tracks_multi launched {refine_waves} times over the "
             "Trips batches' runs, expected one a wave")

    phase_done("3b serve")

    # ----------------------------------------------------------- 3c. filter
    sf = city_region("SF")
    q2_agg = group(P.road_id).avg(d=P.speed).std_dev(sd=P.speed).count("n")
    filters = {
        "Q2-geo_index": fdb("SpeedObservations").find(IN(P.loc, sf))
        .filter(BETWEEN(P.hour, 8, 9) & BETWEEN(P.dow, 0, 4)
                & BETWEEN(P.month, 1, 1)).aggregate(q2_agg),
        "Q2-full_scan": fdb("SpeedObservations")
        .filter(((P.hour + 0) >= 8) & ((P.hour + 0) <= 9)
                & ((P.dow + 0) <= 4) & ((P.month + 0) <= 1))
        .filter(exprs.ExprProxy(exprs.InRegion(exprs.FieldRef("loc"), sf)))
        .aggregate(q2_agg),
    }
    for qname, flow in filters.items():
        t0 = time.perf_counter()
        want = oracle.run(flow).to_records()
        row = {"query": qname, "numpy_ms": (time.perf_counter() - t0) * 1e3,
               "rows": len(want)}
        sess = Session(catalog=cat, backend=TorchBackend())
        for run in ("cold", "warm", "capture"):
            res, lc, kc, ms = counted(run, lambda: sess.run(flow), "filter")
            shards = len(res.plan.shard_ids)
            if lc.get("run_wave_fused") != math.ceil(shards / WAVE) \
                    or not 0 < kc.get("compact", 0) <= 2 * shards:
                fail(f"{qname} {run}: dispatches {lc}, kernels {kc}")
            check_close(f"{qname} {run}", res.to_records(), want)
            row[f"{run}_ms"] = ms
            row[f"{run}_kernels"] = kc
        print("filter " + json.dumps({**row, "match": True}))
    phase_done("3c filter")

    # ------------------------------------------------------------ 3d. retry
    for qname in ("Q7-agg", "Q1"):
        make, has_refine, _ = queries[qname]
        flow = make()
        want = oracle.run(flow).to_records()
        sess = sessions[qname]              # primed by phase 3
        row = {"query": qname, "failing_shards": list(FAILING_SHARDS)}
        for run in ("warm", "capture"):
            plan = FaultPlan(fail_once={("server", s) for s in
                                        FAILING_SHARDS})
            res, lc, kc, ms = counted(
                run, lambda: sess.run(flow, fault_plan=plan), "retry")
            n = len(FAILING_SHARDS)
            if res.profile.retries != n or res.profile.dropped_shards:
                fail(f"retry {qname} {run}: retries {res.profile.retries}, "
                     f"dropped {res.profile.dropped_shards}")
            need = {"bitmap_intersect": n, "compact": n}
            if has_refine:
                need["refine_tracks"] = n
            need_launches(f"retry {qname} {run}", kc, need)
            check_close(f"retry {qname} {run}", res.to_records(), want)
            row[f"{run}_ms"] = ms
            row[f"{run}_kernels"] = kc
            row[f"{run}_dispatches"] = lc
        print("retry " + json.dumps({**row, "match": True}))

    recording[0] = None
    phase_done("3d retry")

    # --------------------------------------------------------------- 3e. lm
    lm_inputs = lm_phase(torch, np, totals)
    phase_done("3e lm")

    # ---------------------------------------------------------- 3f. engines
    engine_inputs = engines_phase(torch, np, cat, queries, oracle, counted,
                                  check_close, need_launches)
    phase_done("3f engines")

    # ------------------------------------------------------------ 3g. train
    train_phase(torch, np, world, cat, counted)
    phase_done("3g train")

    # ------------------------------------------------------------ 3h. cards
    if n_cards > 1:
        os.environ.pop(PARTITIONS_ENV)
        try:
            cards_phase(torch, np, world, cat, queries, oracle, counted,
                        check_close, batches["trips-also"][1],
                        lambda source: fdb(source).tesseract(
                            q7_tess(False)).aggregate(trip_agg), q1_flow)
        finally:
            os.environ[PARTITIONS_ENV] = "1"
    else:
        print("cards: phase 3h did not run: one CUDA device is visible, "
              "and partitions on their own cards need two or more "
              "(python3 chip_smoke.py --require-cards 4 on a host with "
              "four)")
    phase_done("3h cards")

    # ------------------------------------------------------------- 3i. mesh
    # phase 3k's four-card dry-runs run on the host meanwhile
    mesh_dry = start_dryrun_mesh() if n_cards >= 4 else None
    mesh_res = serve_res = None
    if n_cards > 1:
        mesh_res = mesh_phase(torch, n_cards)
    else:
        print("mesh: phase 3i did not run: one CUDA device is visible, and "
              "a device mesh needs two or more (python3 chip_smoke.py "
              "--require-cards 4 on a host with four)")
    phase_done("3i mesh")

    # ------------------------------------------------------- 3j. mesh serve
    if n_cards > 1:
        serve_res = mesh_serve_phase(torch, n_cards)
    else:
        print("mesh_serve: phase 3j did not run: one CUDA device is "
              "visible, and serving on a device mesh needs two or more "
              "(python3 chip_smoke.py --require-cards 4 on a host with "
              "four)")
    phase_done("3j mesh serve")

    # ----------------------------------------------------------- 3k. dryrun
    dryrun_phase(torch, n_cards, mesh_dry, mesh_res, serve_res)
    phase_done("3k dryrun")
    for mod, name in wrappers:
        setattr(mod, name, originals[name])

    for k, n in totals.items():
        if n == 0 and k not in OFF_PATH:
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

    def device_ms(fn, iters=20, warmup=3):
        """Device time of one wrapper call (its kernels, memsets and small
        tensor ops) from ``torch.profiler``, and the device operations a
        call; the CUDA-event time above also counts the host's enqueue
        when the host is the slower side.  The profiler loses some device
        records (17 of 20 one-kernel calls were recorded when all 20 were
        traced from its start, up to 3 in 20 after a warm-up), so
        ``warmup`` traced calls are dropped by its schedule, and each
        device operation counts at its mean recorded time times the
        times a call runs it (its records over ``iters``, rounded, at
        least once).  Returns that time, the device operations a call so
        counted (``device_ops``) and the records a call, losses included
        (``device_records``)."""
        from torch.autograd import DeviceType
        fn()
        torch.cuda.synchronize()
        # now and then a window comes back with no device record at all:
        # it is then taken again, up to three times
        for _ in range(3):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA],
                    schedule=torch.profiler.schedule(
                        wait=0, warmup=warmup, active=iters,
                        repeat=1)) as prof:
                for i in range(warmup + iters):
                    fn()
                    if i == warmup + iters - 1:
                        torch.cuda.synchronize()
                    prof.step()
            dev = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
            if dev:
                break
        else:
            return ("not measured",) * 3
        runs = [max(1, round(e.count / iters)) for e in dev]
        per_call = sum(e.self_device_time_total / e.count * n
                       for e, n in zip(dev, runs))
        return (per_call / 1e3, sum(runs),
                sum(e.count for e in dev) / iters)

    def bound(nbytes, nops, ops_per_s=SCALAR_OPS_PER_S):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, nops / ops_per_s
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
                nbytes, nops, iters, plain_iters,
                ops_per_s=SCALAR_OPS_PER_S):
        err, checked = compare(run_kernel(), run_plain()), {}
        if isinstance(err, tuple):           # (max |err|, how it was held)
            err, checked = err
        b_ms, b_by = bound(nbytes, nops, ops_per_s)
        dev_ms, dev_ops, dev_records = device_ms(run_kernel)
        return {"max_abs_err": err, **checked,
                "ms": cuda_ms(run_kernel, iters),
                "device_ms": dev_ms, "device_ops": dev_ops,
                "device_records": dev_records,
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
        """The case tuple for :func:`measure` and the selected share.  The
        bound counts every group id, the values of selected rows only (the
        kernel loads no value of a masked row, and the function needs none)
        and the three [G] outputs; operations are a compare per row and a
        convert, a multiply and three adds per selected row.  The library
        call computes the same function: one ``index_add_`` of the
        selected rows' (1, v, v²) into [G, 3]."""
        n = gid.numel()
        # the yardstick adds the selected rows only, as the kernel does
        # (masked rows folded into one slot would serialise on it)
        keep = (gid >= 0) & (gid < groups)
        selected = int(keep.sum())
        lib_idx = gid[keep].to(torch.int64)
        lib_vals = vals[keep].to(torch.float64)
        lib_cols = torch.stack([torch.ones_like(lib_vals), lib_vals,
                                lib_vals * lib_vals], dim=1).contiguous()
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

        return ((lambda: segment_agg.segment_agg(gid, vals, groups),
                 lambda: ref.segment_agg_ref(gid, vals, groups),
                 lambda: torch.zeros((groups, 3), dtype=torch.float64,
                                     device=gid.device).index_add_(
                                         0, lib_idx, lib_cols),
                 compare, 4 * n + 4 * selected + 20 * groups,
                 n + 5 * selected), selected / max(n, 1))

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

    def large_refine(args, kw, n=reps):
        """The refine inputs with each shard's points tiled ``n`` times
        (the copies' rows offset into new docs)."""
        pts, rows, cov, docs = args
        pts = tile(pts, n, -1)
        rows = torch.cat([torch.where(rows >= 0, rows + i * docs, rows)
                          for i in range(n)], dim=-1).contiguous()
        return (pts, rows, cov, docs * n), kw

    def refine_mode(kw):
        return 2 if kw.get("with_analytics") else int(
            bool(kw.get("with_first_hits")))

    def refine_multi_case(args, kw):
        """Q queries' tables against one wave: the tracks are read once
        for all queries, each query's table once, each output once."""
        pts, rows, cov, docs = args
        s, _, p = pts.shape
        q, c, _, r = cov.shape
        valid = int((rows >= 0).sum())
        out_b = 4 * q * s * docs + q * s * c * docs * (0, 8, 20)[
            refine_mode(kw)]
        return (lambda: refine.refine_tracks_multi(*args, **kw),
                lambda: ref.refine_tracks_multi_ref(*args, **kw), None,
                lambda g, w_: exact("refine_tracks_multi", g, w_),
                20 * s * p + 32 * q * c * r + out_b,
                valid * q * c * (3 + math.ceil(math.log2(max(r, 2)))))

    def refine_one_case(args, kw):
        """One shard (pts [4, P], rows [P]): the S=1 refine."""
        pts, rows, cov, docs = args
        p = pts.shape[1]
        c, _, r = cov.shape
        valid = int((rows >= 0).sum())

        def plain():
            out = ref.refine_tracks_batched_ref(pts[None], rows[None], cov,
                                                docs, **kw)
            return tuple(o[0] for o in out) if isinstance(out, tuple) \
                else out[0]

        return (lambda: refine.refine_tracks(*args, **kw), plain, None,
                lambda g, w_: exact("refine_tracks", g, w_),
                20 * p + 32 * c * r + 4 * docs
                + c * docs * (0, 8, 20)[refine_mode(kw)],
                valid * c * (3 + math.ceil(math.log2(max(r, 2)))))

    def intersect_case(stack):
        k, w = stack.shape
        return (lambda: bitset.bitmap_intersect(stack),
                lambda: ref.bitmap_intersect_ref(stack), None,
                lambda g, w_: exact("bitmap_intersect", g, w_),
                4 * k * w + 4 * w + 4, w * (k + 1))

    def mask_case(mask, fn, plain, library):
        """Single mask: N bytes read, N int32 written, plus the count."""
        n = mask.numel()
        return (lambda: fn(mask), lambda: plain(mask), library,
                lambda g, w_: exact(fn.__name__, g, w_), 5 * n + 4, n)

    def binary_case(a, b, op="and"):
        w = a.numel()
        return (lambda: bitset.bitset_binary(a, b, op),
                lambda: ref.bitset_binary_ref(a, b, op),
                (lambda: torch.bitwise_and(a, b)) if op == "and" else None,
                lambda g, w_: exact("bitset_binary", g, w_), 12 * w, w)

    refine_cases = {"refine_tracks_batched": refine_case,
                    "refine_tracks_multi": refine_multi_case,
                    "refine_tracks": refine_one_case}

    def refine_entry(name):
        """Every output mode a refine wrapper ran in on the main path, at
        its largest main-path input (``wave``) and with each shard's points
        tiled to ~LARGE_POINTS (``large``): exact against the plain
        version, two calls equal bit for bit, timed.  Returns {mode: {size:
        measure row with its shape}}."""
        make = refine_cases[name]
        per_mode = {}
        for mode in sorted(k[1] for k in captured
                           if isinstance(k, tuple) and k[0] == name):
            _, args, kw = captured[(name, mode)]
            if name == "refine_tracks_multi":
                q, p_m = args[2].shape[0], args[0].shape[2]
                n, iters = max(1, round(LARGE_POINTS / (p_m * q))), \
                    ((20, 1), (5, 1))
            else:
                n, iters = reps, ((50, 3), (10, 1))
            row = {}
            for size, (a_, k_), it in (("wave", (args, kw), iters[0]),
                                       ("large", large_refine(args, kw, n),
                                        iters[1])):
                case = make(a_, k_)
                exact(f"{name} mode {mode} {size}, two calls", case[0](),
                      case[0]())
                row[size] = {"shape": ([list(a_[0].shape), list(a_[2].shape)]
                                       if name == "refine_tracks_multi"
                                       else list(a_[0].shape)),
                             **measure(name, *case, *it)}
            per_mode[mode] = row
            print(f"kernel {name}[mode {mode}]: " + "; ".join(
                f"{size} {m['shape']} {m['ms']:.4f} ms, device "
                f"{m['device_ms']} ({m['device_ops']} ops a call; bound "
                f"{m['bound_ms']:.5f}, plain {m['plain_ms']:.3f})"
                for size, m in row.items()))
        return per_mode

    results = []
    for name, (src, replaces) in KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": totals[name]}
        if name in REFINES:
            per_mode = refine_entry(name)
            top = per_mode[min(per_mode)]
            wave, large = dict(top["wave"]), dict(top["large"])
            shape, lshape = wave.pop("shape"), large.pop("shape")
            entry.update(modes_checked=sorted(per_mode), bit_identical=True,
                         modes={str(m): r for m, r in per_mode.items()})
        elif name == "bitmap_intersect_batched":
            stack = captured[name][1][0]
            wave = measure(name, *bitset_case(stack), 200, 20)
            big = tile(stack, reps, 2)
            large = measure(name, *bitset_case(big), 50, 5)
            shape, lshape = list(stack.shape), list(big.shape)
            served = captured[(name, "serve")][1][0]   # [Q·S, K, W]
            entry["serve"] = {"shape": list(served.shape),
                              **measure(name, *bitset_case(served), 200, 20)}
        elif name == "compact_batched":
            masks = captured[name][1][0]
            wave = measure(name, *compact_case(masks), 200, 20)
            big = tile(masks, reps, 1)
            large = measure(name, *compact_case(big), 50, 5)
            shape, lshape = list(masks.shape), list(big.shape)
            served = captured[(name, "serve")][1][0]   # [Q·S, N]
            entry["serve"] = {"shape": list(served.shape),
                              **measure(name, *compact_case(served), 200,
                                        20)}
        elif name == "bitmap_intersect":
            stack = captured[name][1][0]
            wave = measure(name, *intersect_case(stack), 200, 20)
            big = tile(stack, reps, 1)
            large = measure(name, *intersect_case(big), 50, 5)
            shape, lshape = list(stack.shape), list(big.shape)
        elif name == "compact":
            mask = captured[name][1][0]
            big = tile(mask, reps, 0)
            wave = measure(name, *mask_case(mask, compact.compact,
                                            ref.compact_ref,
                                            lambda: torch.nonzero(mask)),
                           200, 20)
            large = measure(name, *mask_case(big, compact.compact,
                                             ref.compact_ref,
                                             lambda: torch.nonzero(big)),
                            50, 5)
            # the same kernel's prefix-sum output (mask_prefix_sum)
            entry["mask_prefix_sum"] = {
                "wave": measure("mask_prefix_sum", *mask_case(
                    mask, compact.mask_prefix_sum, ref.mask_prefix_sum_ref,
                    None), 200, 20),
                "large": measure("mask_prefix_sum", *mask_case(
                    big, compact.mask_prefix_sum, ref.mask_prefix_sum_ref,
                    None), 50, 5)}
            shape, lshape = list(mask.shape), list(big.shape)
        elif name == "flash_attention":
            per_config = {}
            for cname, (args, kw) in lm_inputs["flash_attention"].items():
                per_config[cname] = {
                    "shape": list(args[0].shape),
                    "kv_shape": list(args[1].shape),
                    "causal": kw.get("causal", True),
                    "kernel": fa_kernel.kernel_for(args[0].dtype,
                                                   args[0].shape[-1]),
                    **measure(name, *flash_case(torch, *args, **kw), 20, 3,
                              BF16_TENSOR_OPS_PER_S)}
            # Gemma 3 12B: the library call is flex_attention (SDPA has
            # neither window nor softcap); SDPA's causal time on the same
            # inputs stands beside each row.  The serve traffic never
            # reaches the window: two larger calls from the recorded prefill
            from torch.nn.functional import scaled_dot_product_attention
            g_args, g_kw = lm_inputs["flash_attention"]["gemma3_12b"]

            def sdpa_causal(q, k, v):
                return cuda_ms(lambda: scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), 10)

            per_config["gemma3_12b"].update(
                window=g_kw.get("window"), softcap=g_kw.get("softcap"),
                sdpa_causal_ms_without_window_softcap=sdpa_causal(*g_args))
            gemma = {}
            for label, (n, gkw) in GEMMA_LARGE_CALLS.items():
                big = tuple(tile(t, -(-n // t.shape[2]), 2)[:, :, :n]
                            .contiguous() for t in g_args)
                row = gemma[label] = {
                    "shape": list(big[0].shape),
                    "kv_shape": list(big[1].shape), **gkw,
                    "kernel": fa_kernel.kernel_for(big[0].dtype,
                                                   big[0].shape[-1]),
                    **measure(name, *flash_case(torch, *big, **gkw), 10, 1,
                              BF16_TENSOR_OPS_PER_S),
                    "sdpa_causal_ms_without_window_softcap":
                        sdpa_causal(*big)}
                if row["kernel"] != "tensor_core":
                    fail(f"flash_attention gemma3_12b {label}: the "
                         f"{row['kernel']} kernel ran")
                print(f"kernel flash_attention[gemma3_12b {label}]: "
                      f"{row['kernel']} {row['shape']} x {row['kv_shape']} "
                      f"device {row['device_ms']} ms, {row['ms']} ms "
                      f"(bound {row['bound_ms']:.5f}; flex_attention "
                      f"{row['library_ms']}; SDPA causal, without "
                      "window and softcap, "
                      f"{row['sdpa_causal_ms_without_window_softcap']}); "
                      f"max |err| {row['max_abs_err']}")
                del big
            entry["gemma3_larger_calls"] = gemma
            # the largest causal prefill call at hd 64 or 128 scales to
            # the larger shape (not an encoder's or a cross call; hd 256
            # has its larger calls above)
            top = max(((k, v) for k, v in
                       lm_inputs["flash_attention"].items()
                       if v[1].get("causal", True)
                       and v[0][0].shape[-1] <= 128),
                      key=lambda kv: kv[1][0][0].numel())
            args, kw = top[1]
            wave = per_config[top[0]]
            wave = {k: v for k, v in wave.items() if k != "shape"}
            largs = tuple(tile(t, 4, 2) for t in args)
            large = measure(name, *flash_case(torch, *largs, **kw), 10, 1,
                            BF16_TENSOR_OPS_PER_S)
            large["kernel"] = fa_kernel.kernel_for(largs[0].dtype,
                                                   largs[0].shape[-1])
            shape, lshape = list(args[0].shape), list(largs[0].shape)
            entry.update(configs=per_config, dtype=str(args[0].dtype))
            for cname, row in per_config.items():
                if row["kernel"] != "tensor_core":   # bf16 at hd 64 / 128
                    fail(f"flash_attention {cname}: the {row['kernel']} "
                         "kernel ran, not the tensor-core one")
                print(f"kernel flash_attention[{cname}]: {row['kernel']} "
                      f"{row['shape']} x {row['kv_shape']} device "
                      f"{row['device_ms']} ms "
                      f"(library {row['library_ms']}, bound "
                      f"{row['bound_ms']:.5f}); max |err| "
                      f"{row['max_abs_err']} (atol {row['atol']:.6f}, "
                      f"mean |plain| {row['mean_abs_plain']:.6f}; without "
                      "the last key tile: "
                      f"{row.get('tail_tile_dropped_rejected_share')} "
                      "outside, max shift "
                      f"{row.get('tail_tile_dropped_max_shift')})")
        elif name == "ssm_scan":
            # off the main path: the first chunk of the recorded Mamba
            # layer's chain, [B, LM_SSM_CHUNK, dI·N]
            dt, x, bm, _, A = lm_inputs["selective_scan"]
            b_, di_, n_ = dt.shape[0], dt.shape[2], A.shape[1]
            dc = dt[:, :LM_SSM_CHUNK].float()
            a = torch.exp(dc[..., None] * A).reshape(b_, -1, di_ * n_)
            bx = ((dc * x[:, :LM_SSM_CHUNK].float())[..., None]
                  * bm[:, :LM_SSM_CHUNK].float()[:, :, None, :]).reshape(
                      b_, -1, di_ * n_)
            del dc
            wave = measure(name, *ssm_case(torch, a, bx, None), 20, 2)
            la, lbx = tile(a, 4, 1), tile(bx, 4, 1)
            large = measure(name, *ssm_case(torch, la, lbx, None), 10, 1)
            shape, lshape = list(a.shape), list(la.shape)
            del a, bx, la, lbx
            entry.update(on_main_path=False)
        elif name == "selective_scan":
            args = lm_inputs["selective_scan"]
            wave = measure(name, *selective_case(torch, *args), 20, 2,
                           SFU_OPS_PER_S)
            lb, ls = SELECTIVE_LARGE
            reps_b = -(-lb // args[0].shape[0])
            reps_s = -(-ls // args[0].shape[1])
            largs = tuple(tile(tile(t, reps_b, 0), reps_s, 1)[:lb, :ls]
                          .contiguous() for t in args[:4]) + (args[4],)
            large = measure(name, *selective_case(torch, *largs), 10, 1,
                            SFU_OPS_PER_S)
            shape, lshape = list(args[0].shape) + [args[4].shape[1]], \
                list(largs[0].shape) + [args[4].shape[1]]
            del largs
        elif name == "bitset_binary":
            # on no engine path: two shard bitmaps of the retry phase
            stack = captured["bitmap_intersect"][1][0]
            a, b = stack[0].contiguous(), stack[-1].contiguous()
            big_a, big_b = tile(a, reps, 0), tile(b, reps, 0)
            for op in ("or", "andnot"):
                for x, y in ((a, b), (big_a, big_b)):
                    case = binary_case(x, y, op)
                    case[3](case[0](), case[1]())
            wave = measure(name, *binary_case(a, b), 200, 20)
            large = measure(name, *binary_case(big_a, big_b), 50, 5)
            shape, lshape = list(a.shape), list(big_a.shape)
            entry.update(on_main_path=False, ops_checked=["and", "or",
                                                          "andnot"])
        else:
            entry.update(segment_entry(torch, captured, reps, measure,
                                       segment_case, seg_branch_launches))
            wave, large = entry.pop("wave"), entry.pop("large")
            shape, lshape = entry.pop("shape"), large.pop("shape")
        entry.update(wave)
        entry.update(match=True, kernel_ms=wave["ms"], shape=shape,
                     large={"shape": lshape, **large})
        results.append(entry)
        print(f"kernel {name}: wave {shape} {wave['ms']:.4f} ms "
              f"(bound {wave['bound_ms']:.4f}, plain {wave['plain_ms']:.3f}"
              f"); large {lshape} {large['ms']:.4f} ms (bound "
              f"{large['bound_ms']:.4f}, plain {large['plain_ms']:.3f})")

    # phase 3f's plain PyTorch ops (not kernels: the JAX package lowers
    # both to plain jnp)
    engine_fns = {"segment_hll": fused.segment_hll,
                  "merge_partials": merge.merge_partials}
    for name, (args, nbytes, nops) in engine_inputs.items():
        fn = engine_fns[name]
        on_cpu = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                       for a in args)
        exact(name, tuple(o.cpu() for o in _as_tuple(fn(*args))),
              _as_tuple(fn(*on_cpu)))
        b_ms, b_by = bound(nbytes, nops)
        dev_ms, dev_ops, dev_records = device_ms(lambda: fn(*args))
        row = {"name": name, "shape": [list(a.shape) for a in args
                                       if isinstance(a, torch.Tensor)],
               "max_abs_err": 0.0, "ms": cuda_ms(lambda: fn(*args), 20),
               "device_ms": dev_ms, "device_ops": dev_ops,
               "device_records": dev_records,
               "cpu_ms": _host_ms(lambda: fn(*on_cpu), 3),
               "bound_ms": b_ms, "bound_by": b_by}
        print("engine_ops " + json.dumps(row))

    phase_done("4 kernels")
    print("launch_path " + json.dumps(launch_path(torch, np)))
    phase_done("4b launch_path")
    profile_queries(torch, queries, sessions)
    profile_serve(torch, batches, serve_backend, cat)
    phase_done("5 profile")
    print(smi)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _host_ms(fn, iters):
    """Host wall ms a call of ``fn`` (CPU tensors), over ``iters`` calls."""
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _identical(where, got, base):
    """Fail unless result ``got`` has ``base``'s (P = 1's) columns, rows
    and bytes."""
    if got.batch.paths() != base.batch.paths() or got.batch.n != \
            base.batch.n:
        fail(f"{where}: columns {got.batch.paths()} / {got.batch.n} rows "
             f"vs {base.batch.paths()} / {base.batch.n} at P = 1")
    for p in base.batch.paths():
        a, b = got.batch[p].values, base.batch[p].values
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            fail(f"{where}: column {p} differs from P = 1")


#: phase 3f: partition counts on the one card, and the partition that
#: fails once in its reroute check
ENGINE_PARTITIONS = (2, 4)
FAILING_PARTITION = 1


def engines_phase(torch, np, cat, queries, oracle, counted, check_close,
                  need_launches):
    """Phase 3f: Warp:Flume, the partition layer and grouped
    ``approx_distinct`` on the card (see the module docstring).  Prints
    one ``engines`` line a sub-phase and query; returns the largest
    inputs ``segment_hll`` and ``merge_partials`` were given, with the
    bytes and operations of their bound, for phase 4."""
    import cProfile
    import pstats
    import shutil
    import tempfile
    from repro_torch.core import P, fdb, group
    from repro_torch.core.planner import PartitionPlan, partition_shards
    from repro_torch.core.sketches import HyperLogLog, hash_values, \
        hll_register_rows
    from repro_torch.exec import AdHocEngine, FaultPlan, FlumeEngine, \
        NumpyBackend, TorchBackend
    from repro_torch.kernels import fused, merge
    from repro_torch.launch.elastic import reroute_partitions

    inputs = {}
    capturing = [False]

    def capture(name, fn):
        def call(*args):
            if capturing[0]:
                size = args[0].numel()
                if name not in inputs or inputs[name][0] < size:
                    inputs[name] = (size, tuple(
                        a.clone() if isinstance(a, torch.Tensor) else a
                        for a in args))
            return fn(*args)
        return call

    originals = (merge.merge_partials, fused.segment_hll)
    merge.merge_partials = capture("merge_partials", originals[0])
    fused.segment_hll = capture("segment_hll", originals[1])

    median, identical = _median, _identical

    def wave_kernels(where, kc, waves, has_refine):
        need = {"bitmap_intersect_batched": waves, "compact_batched": waves}
        if has_refine:
            need["refine_tracks_batched"] = waves
        need_launches(where, kc, need)

    def busy(fn):
        """The device's busy ms and idle share over one more warm run of
        ``fn`` under ``torch.profiler``, counted like any other run."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            _, _, kc, ms = counted("busy", fn)
        b = _device_busy(torch, prof, ms, kc)
        return {k: b[k] for k in ("device_busy_ms", "device_idle_share")}

    # ------------------------------------------------------------ flume
    tmp = tempfile.mkdtemp(prefix="chip_smoke_flume_")
    try:
        be = TorchBackend()
        adhoc = AdHocEngine(cat, backend=be)
        fl = FlumeEngine(cat, backend=be, ckpt_dir=tmp)
        for qname in ("Q7-agg", "Q1"):
            make, has_refine, _ = queries[qname]
            flow = make()
            want = oracle.run(flow).to_records()
            row = {"sub": "flume", "query": qname}
            times = {"flume": [], "adhoc": []}
            jobs = [f"{qname}-{i}" for i in range(WARM_RUNS + 2)]
            for i, job in enumerate(jobs[:-1]):
                run = "cold" if i == 0 else "warm"
                ran = fl.stats["tasks_run"]
                res, lc, kc, ms = counted(
                    run, lambda: fl.collect(flow, job_id=job))
                shards = len(res.plan.shard_ids)
                waves = math.ceil(shards / WAVE)
                where = f"flume {qname} {run}"
                if lc != {"run_wave_fused": waves}:
                    fail(f"{where}: dispatches {lc}, expected "
                         f"{{'run_wave_fused': {waves}}}")
                wave_kernels(where, kc, waves, has_refine)
                if fl.stats["tasks_run"] - ran != shards:
                    fail(f"{where}: {fl.stats['tasks_run'] - ran} tasks ran "
                         f"for {shards} shards")
                check_close(where, res.to_records(), want)
                if run == "cold":
                    row.update(cold_ms=ms, shards=shards, waves=waves,
                               kernels=kc)
                    continue
                times["flume"].append(ms)
                res, lc, _, ms = counted(run, lambda: adhoc.collect(flow))
                if lc != {"run_wave_fused": waves}:
                    fail(f"adhoc {qname} {run}: dispatches {lc}")
                check_close(f"adhoc {qname}", res.to_records(), want)
                times["adhoc"].append(ms)
            last = jobs[-2]
            ckpt_bytes = sum(f.stat().st_size
                             for f in Path(tmp, last).rglob("*.pkl"))
            first = counted("repeat", lambda: fl.collect(
                flow, job_id=last))[0].to_records()
            ran = fl.stats["tasks_run"]
            res, lc, kc, ms = counted("repeat",
                                      lambda: fl.collect(flow, job_id=last))
            if lc or kc or fl.stats["tasks_run"] != ran \
                    or res.to_records() != first:
                fail(f"flume {qname} repeat: dispatches {lc}, kernels {kc}, "
                     f"tasks {fl.stats['tasks_run'] - ran}")
            row.update(
                warm_ms=median(times["flume"]),
                adhoc_warm_ms=median(times["adhoc"]),
                checkpoint_cost=(median(times["flume"])
                                 / median(times["adhoc"]) - 1),
                checkpoint_bytes=ckpt_bytes, repeat_ms=ms, repeat_launches=0,
                **busy(lambda: fl.collect(flow, job_id=jobs[-1])),
                match=True)
            print("engines " + json.dumps(row))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ------------------------------------------------------- partitions
    for qname in ("Q7-agg", "Q1", "Q11"):
        make, has_refine, has_agg = queries[qname]
        flow = make()
        want = oracle.run(flow).to_records()
        be = TorchBackend()
        one = AdHocEngine(cat, backend=be, partitions=1)
        counted("cold", lambda: one.collect(flow))
        base, _, _, _ = counted("warm", lambda: one.collect(flow))
        check_close(f"partitions {qname} P=1", base.to_records(), want)
        row = {"sub": "partitions", "query": qname,
               "P1_warm_ms": median([counted("warm", lambda: one.collect(
                   flow))[3] for _ in range(WARM_RUNS)])}
        for parts in ENGINE_PARTITIONS:
            eng = AdHocEngine(cat, backend=be, partitions=parts)
            times = []
            for run in ["cold"] + ["warm"] * WARM_RUNS + ["capture"]:
                capturing[0] = run == "capture"
                res, lc, kc, ms = counted(run, lambda: eng.collect(flow))
                capturing[0] = False
                pp = partition_shards(res.plan.shard_ids, parts)
                waves = pp.wave_dispatches(WAVE)
                need = {"run_wave_fused": waves}
                if has_agg and pp.merge_combines():
                    need["merge_partials"] = pp.merge_combines()
                where = f"partitions {qname} P={parts} {run}"
                if lc != need:
                    fail(f"{where}: dispatches {lc}, expected {need}")
                wave_kernels(where, kc, waves, has_refine)
                identical(where, res, base)
                check_close(where, res.to_records(), want)
                if run == "warm":
                    times.append(ms)
                elif run == "cold":
                    row[f"P{parts}_cold_ms"] = ms
            row[f"P{parts}_warm_ms"] = median(times)
            row[f"P{parts}_dispatches"] = lc
            row[f"P{parts}_busy"] = busy(lambda: eng.collect(flow))
        # where P = 4's extra time goes on the host: one more warm run
        host = cProfile.Profile()
        host.enable()
        counted("warm", lambda: eng.collect(flow))
        host.disable()
        row["host_cum_ms"], row["host_self_ms"] = _own_and_self(
            _host_rows(pstats.Stats(host).stats))
        print("engines " + json.dumps({**row, "match": True}))

    make, has_refine, _ = queries["Q7-agg"]
    flow = make()
    parts = max(ENGINE_PARTITIONS)
    eng = AdHocEngine(cat, backend=TorchBackend(), partitions=parts)
    base = counted("cold", lambda: eng.collect(flow))[0]
    row = {"sub": "partition_fault", "query": "Q7-agg", "partitions": parts,
           "failing_partition": FAILING_PARTITION}
    for run in ("warm", "warm2"):
        fp = FaultPlan(fail_once={("partition", FAILING_PARTITION)})
        res, lc, kc, ms = counted(run, lambda: eng.collect(flow,
                                                           fault_plan=fp))
        rerouted = PartitionPlan(reroute_partitions(
            partition_shards(res.plan.shard_ids, parts).parts,
            [FAILING_PARTITION]))
        need = {"run_wave_fused": rerouted.wave_dispatches(WAVE),
                "merge_partials": 1}
        where = f"partition_fault {run}"
        if lc != need or res.profile.retries != 1 or res.coverage != 1.0:
            fail(f"{where}: dispatches {lc} (expected {need}), retries "
                 f"{res.profile.retries}, coverage {res.coverage}")
        wave_kernels(where, kc, need["run_wave_fused"], has_refine)
        identical(where, res, base)
        row[f"{run}_ms"] = ms
        row["dispatches"] = lc
    print("engines " + json.dumps({**row, "match": True}))

    # -------------------------------------------------------------- hll
    obs, trips = cat.get("SpeedObservations"), cat.get("Trips")
    hll_flows = {"obs-hour": (fdb("SpeedObservations").aggregate(
        group(P.hour).approx_distinct("n_roads", expr=P.road_id)), obs,
        (1,))}
    hll_flows["trips-ids"] = (fdb("Trips").distinct_approx(P.id), trips,
                              (1,) + ENGINE_PARTITIONS)
    for fname, (flow, db, part_list) in hll_flows.items():
        want = oracle.run(flow).to_records()
        be = TorchBackend()
        row = {"sub": "hll", "flow": fname, "groups": len(want)}
        for parts in part_list:
            eng = AdHocEngine(cat, backend=be, partitions=parts)
            times = []
            for run in ["cold"] + ["warm"] * WARM_RUNS + ["capture"]:
                capturing[0] = run == "capture"
                res, lc, kc, ms = counted(run, lambda: eng.collect(flow))
                capturing[0] = False
                finalizes = sum(1 for sid in res.plan.shard_ids
                                if db.shards[sid].n)
                where = f"hll {fname} P={parts} {run}"
                if lc.get("segment_hll") != finalizes:
                    fail(f"{where}: segment_hll launched "
                         f"{lc.get('segment_hll')} times, expected one a "
                         f"finalize ({finalizes})")
                if res.to_records() != want:
                    fail(f"{where}: estimates differ from the oracle's")
                if run == "warm":
                    times.append(ms)
            row[f"P{parts}_warm_ms"] = median(times)
            row[f"P{parts}_dispatches"] = lc
        row.update(busy(lambda: eng.collect(flow)))
        print("engines " + json.dumps({**row, "match": True}))

    # the registers themselves: one call over all 400,000 rows of the
    # per-hour sketch against the numpy oracle's
    p = HyperLogLog().p
    codes = np.concatenate([sh.batch["hour"].values for sh in obs.shards])
    roads = np.concatenate([sh.batch["road_id"].values for sh in obs.shards])
    idx, rank = hll_register_rows(hash_values(roads), p)
    capturing[0] = True
    got = TorchBackend().segment_hll(codes, idx, rank, 24, 1 << p)
    capturing[0] = False
    if got.tobytes() != NumpyBackend().segment_hll(codes, idx, rank, 24,
                                                   1 << p).tobytes():
        fail("hll: registers over all SpeedObservations differ from the "
             "oracle's")
    print("engines " + json.dumps({
        "sub": "hll_registers", "rows": int(codes.size), "groups": 24,
        "registers": 1 << p, "match": True}))

    merge.merge_partials, fused.segment_hll = originals
    out = {}
    if "segment_hll" in inputs:
        ids, regs, groups = inputs["segment_hll"][1]
        n, m = regs.shape
        out["segment_hll"] = (inputs["segment_hll"][1],
                              8 * n + n * m + groups * m, n * m)
    if "merge_partials" in inputs:
        args = inputs["merge_partials"][1]
        s, k, g = args[0].shape
        out["merge_partials"] = (args, 40 * s * k * g + s * g
                                 + 40 * k * g + g, 5 * s * k * g + s * g)
    return out


#: phase 3h: partition counts across the cards (and the default, which
#: must resolve to the card count), the shards of the rebuilt
#: SpeedObservations FDb, and the records of the streaming source's
#: first generation
CARD_PARTITIONS = (2, 4)
CARD_OBS_SHARDS = 128
CARD_STREAM_FIRST = 12_000
CARD_STREAM_FLUSH = 2_400


def _union_ns(intervals) -> int:
    """Length of the union of (start, end) ``intervals``: device records
    that overlap (streams at work at once) count once."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a >= end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _event_ns(e, what: str) -> int:
    get = getattr(e, f"{what}_ns", None)
    if get is not None:
        return int(get())
    return int(getattr(e, f"{what}_us")() * 1000)


def _device_ms(prof):
    """Each card's busy ms over a ``torch.profiler`` window: the union of
    its device records (kernels, copies, sets; not the device-side copies
    of profiler ranges), so that work on several streams at once counts
    once and no card is busier than the window."""
    from torch.autograd import DeviceType
    per = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        a = _event_ns(e, "start")
        per.setdefault(int(e.device_index()), []).append(
            (a, a + _event_ns(e, "duration")))
    return {d: _union_ns(v) / 1e6 for d, v in per.items()}


def _card_busy(torch, prof, wall_ms, n_cards):
    """Each card's busy ms (the union of its device records) and idle
    share over a ``torch.profiler`` window of ``wall_ms``."""
    per = _device_ms(prof)
    if not per:
        return "not measured"
    busy = [per.get(i, 0.0) for i in range(n_cards)]
    return [{"card": i, "busy_ms": b, "idle_share": 1 - b / wall_ms}
            for i, b in enumerate(busy)]


def cards_phase(torch, np, world, cat, queries, oracle, counted,
                check_close, serve_flows, q7_flow, q1_flow):
    """Phase 3h: each partition's waves on its own card, through the
    engines a user calls — ``AdHocEngine`` (Q7-agg, Q1, Q11 at P = 2, 4
    and the default P, which must be the card count; Q1 also on
    SpeedObservations rebuilt at 128 shards; Q7-agg with a partition
    failing once), ``FlumeEngine`` (a Q7-agg job at P = 4),
    ``QueryServer`` (the trips-also batch at P = 4) and a streaming
    source appended to and primed again at P = 4.  Each result is held
    byte for byte to P = 1 on card 0 and to the numpy oracle; each
    query's dispatches to Σ_p ⌈shards_p/8⌉ (plus one ``merge_partials``
    for an aggregate) and each partition's kernel launches to its card
    p mod D.  Prints one ``cards`` line a sub-phase and query: warm
    medians, cold times (the first P > 1 run on a fresh backend: its
    cards join, and the first one in the process creates their CUDA
    contexts), each card's idle share over one profiled warm run and
    where the host time of a P = 4 run goes."""
    import cProfile
    import pstats
    import shutil
    import tempfile
    from repro_torch.core import fdb
    from repro_torch.core.planner import PartitionPlan, partition_shards
    from repro_torch.exec import AdHocEngine, FaultPlan, FlumeEngine, \
        TorchBackend
    from repro_torch.fdb import build_fdb
    from repro_torch.fdb.streaming import StreamingFDb
    from repro_torch.kernels import _build
    from repro_torch.launch.elastic import reroute_partitions
    from repro_torch.launch.mesh import make_exec_mesh
    from repro_torch.serve import QueryServer

    n_cards = torch.cuda.device_count()
    cards = make_exec_mesh(0)
    print(f"cards: {n_cards} visible: " + ", ".join(
        torch.cuda.get_device_name(i) for i in range(n_cards)))

    median, identical = _median, _identical

    def on_cards(where, parts, kernels, agg=False):
        """Each card's launches of ``kernels``: the waves of the
        partitions mapped to it (p mod D); segment_agg on each card that
        ran a wave of an aggregate.  Returns the waves a card."""
        d = min(len(parts), n_cards)
        waves = [0] * n_cards
        for p, part in enumerate(parts):
            waves[p % d] += math.ceil(len(part) / WAVE)
        for card, n in zip(cards, waves):
            kc = _build.kernel_launches(card)
            for k in kernels:
                if kc.get(k, 0) != n:
                    fail(f"{where}: {k} launched {kc.get(k, 0)} times on "
                         f"{card}, expected {n} (waves of its partitions)")
            if agg and n and not kc.get("segment_agg"):
                fail(f"{where}: segment_agg never launched on {card}")
        return waves

    def card_busy(fn):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            _, _, _, ms = counted("busy", fn)
        return _card_busy(torch, prof, ms, n_cards)

    def host_rows(fn):
        host = cProfile.Profile()
        host.enable()
        counted("warm", fn)
        host.disable()
        return _own_and_self(_host_rows(pstats.Stats(host).stats))

    wave_kernels = ("bitmap_intersect_batched", "compact_batched")

    # ------------------------------------------------- queries on cards
    obs128 = build_fdb("Obs128", world["observations_schema"],
                       world["observations"], num_shards=CARD_OBS_SHARDS)
    cat.register(obs128)
    runs = dict(queries)
    runs["Q1-128"] = (lambda: q1_flow("Obs128"), False, True)
    for qname in ("Q7-agg", "Q1", "Q11", "Q1-128"):
        make, has_refine, has_agg = runs[qname]
        flow = make()
        want = oracle.run(flow).to_records()
        be = TorchBackend()
        one = AdHocEngine(cat, backend=be, partitions=1)
        counted("cold", lambda: one.collect(flow))
        base = counted("warm", lambda: one.collect(flow))[0]
        check_close(f"cards {qname} P=1", base.to_records(), want)
        row = {"sub": "partitions", "query": qname,
               "P1_warm_ms": median([counted("warm", lambda: one.collect(
                   flow))[3] for _ in range(WARM_RUNS)])}
        kernels = wave_kernels + (("refine_tracks_batched",)
                                  if has_refine else ())
        plist = CARD_PARTITIONS if qname != "Q1-128" else (4,)
        for parts in plist + (None,):
            eng = AdHocEngine(cat, backend=be, partitions=parts)
            label = f"P{parts}" if parts else "Pdefault"
            times = []
            for run in ["cold"] + ["warm"] * WARM_RUNS:
                res, lc, _, ms = counted(run, lambda: eng.collect(flow))
                pp = partition_shards(res.plan.shard_ids,
                                      parts or n_cards)
                where = f"cards {qname} {label} {run}"
                if parts is None and pp.num_partitions != n_cards:
                    fail(f"{where}: the default P is "
                         f"{pp.num_partitions}, not the card count")
                need = {"run_wave_fused": pp.wave_dispatches(WAVE)}
                if has_agg:
                    need["merge_partials"] = 1
                if lc != need:
                    fail(f"{where}: dispatches {lc}, expected {need}")
                waves = on_cards(where, pp.parts, kernels, has_agg)
                identical(where, res, base)
                check_close(where, res.to_records(), want)
                if run == "cold":
                    row[f"{label}_cold_ms"] = ms
                else:
                    times.append(ms)
            row[f"{label}_warm_ms"] = median(times)
            row[f"{label}_waves_by_card"] = waves
            if parts == max(CARD_PARTITIONS):
                row["P4_cards_busy"] = card_busy(lambda: eng.collect(flow))
                row["P4_host_cum_ms"], row["P4_host_self_ms"] = host_rows(
                    lambda: eng.collect(flow))
        row["shards"] = len(base.plan.shard_ids)
        print("cards " + json.dumps({**row, "match": True}))

    # ------------------------------------------------ a failing partition
    make, _, _ = queries["Q7-agg"]
    flow = make()
    parts = max(CARD_PARTITIONS)
    be = TorchBackend()
    base = counted("warm", lambda: AdHocEngine(
        cat, backend=be, partitions=1).collect(flow))[0]
    eng = AdHocEngine(cat, backend=be, partitions=parts)
    row = {"sub": "partition_fault", "query": "Q7-agg", "partitions": parts,
           "failing_partition": FAILING_PARTITION}
    for run in ("cold", "warm"):
        fp = FaultPlan(fail_once={("partition", FAILING_PARTITION)})
        res, lc, _, ms = counted(run, lambda: eng.collect(flow,
                                                           fault_plan=fp))
        rerouted = PartitionPlan(reroute_partitions(
            partition_shards(res.plan.shard_ids, parts).parts,
            [FAILING_PARTITION]))
        need = {"run_wave_fused": rerouted.wave_dispatches(WAVE),
                "merge_partials": 1}
        where = f"cards partition_fault {run}"
        if lc != need or res.profile.retries != 1 or res.coverage != 1.0:
            fail(f"{where}: dispatches {lc} (expected {need}), retries "
                 f"{res.profile.retries}, coverage {res.coverage}")
        row["waves_by_card"] = on_cards(
            where, rerouted.parts,
            wave_kernels + ("refine_tracks_batched",), True)
        identical(where, res, base)
        row[f"{run}_ms"] = ms
    print("cards " + json.dumps({**row, "match": True}))

    # -------------------------------------------------------------- flume
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cards_")
    try:
        fl = FlumeEngine(cat, backend=be, ckpt_dir=tmp, partitions=parts)
        row = {"sub": "flume", "query": "Q7-agg", "partitions": parts}
        for i, run in enumerate(("cold", "warm")):
            res, lc, _, ms = counted(
                run, lambda: fl.collect(flow, job_id=f"cards-{i}"))
            pp = partition_shards(res.plan.shard_ids, parts)
            need = {"run_wave_fused": pp.wave_dispatches(WAVE),
                    "merge_partials": 1}
            where = f"cards flume {run}"
            if lc != need:
                fail(f"{where}: dispatches {lc}, expected {need}")
            row["waves_by_card"] = on_cards(
                where, pp.parts, wave_kernels + ("refine_tracks_batched",),
                True)
            identical(where, res, base)
            row[f"{run}_ms"] = ms
        print("cards " + json.dumps({**row, "match": True}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ------------------------------------------------------- query server
    want = [oracle.run(f).to_records() for f in serve_flows]
    row = {"sub": "serve", "batch": "trips-also",
           "queries": len(serve_flows), "partitions": parts}
    results = {}
    for p in (1, parts):
        srv = QueryServer(AdHocEngine(cat, backend=be, partitions=p),
                          cache=False, start=False)
        for run in ("cold", "warm"):
            futs = [srv.submit(f) for f in serve_flows]
            _, lc, _, ms = counted(run, srv.run_pending)
            got = [f.result(120) for f in futs]
            pp = partition_shards(got[0].plan.shard_ids, p)
            where = f"cards serve P={p} {run}"
            need = {"run_wave_fused_multi": pp.wave_dispatches(WAVE)}
            if lc != need or srv.stats()["coalesced_batches"] < 1:
                fail(f"{where}: dispatches {lc}, expected {need}")
            if p > 1:
                row["waves_by_card"] = on_cards(
                    where, pp.parts, wave_kernels + ("refine_tracks_multi",))
            for g, w in zip(got, want):
                check_close(where, g.to_records(), w)
            results[p] = got
            row[f"P{p}_{run}_ms"] = ms
    for qi, (g, b) in enumerate(zip(results[parts], results[1])):
        identical(f"cards serve query {qi}", g, b)
    print("cards " + json.dumps({**row, "match": True}))

    # ------------------------------------------------ streaming, re-primed
    trips = world["trips"]
    live = StreamingFDb("TripsLive", world["trips_schema"],
                        flush_threshold=CARD_STREAM_FLUSH,
                        compact_threshold=0)
    live.extend(trips[:CARD_STREAM_FIRST])
    cat.register(live)
    flow = q7_flow("TripsLive")
    be = TorchBackend()
    eng = AdHocEngine(cat, backend=be, partitions=parts)
    row = {"sub": "streaming", "query": "Q7-agg", "partitions": parts}
    for gen in ("first", "appended"):
        if gen == "appended":
            live.extend(trips[CARD_STREAM_FIRST:])
        snap = cat.get("TripsLive")
        before = {c: c_.stats() for c, c_ in be.device_caches().items()}
        new = be.prime_fdb(snap)
        want = oracle.run(flow).to_records()
        base = counted("warm", lambda: AdHocEngine(
            cat, backend=be, partitions=1).collect(flow))[0]
        for run in ("cold", "warm"):
            stats = {c: c_.stats() for c, c_ in be.device_caches().items()}
            res, lc, _, ms = counted(run, lambda: eng.collect(flow))
            where = f"cards streaming {gen} {run}"
            pp = partition_shards(res.plan.shard_ids, parts)
            need = {"run_wave_fused": pp.wave_dispatches(WAVE),
                    "merge_partials": 1}
            if lc != need:
                fail(f"{where}: dispatches {lc}, expected {need}")
            on_cards(where, pp.parts,
                     wave_kernels + ("refine_tracks_batched",), True)
            identical(where, res, base)
            check_close(where, res.to_records(), want)
            if run == "warm":
                for c, cache in be.device_caches().items():
                    now = cache.stats()
                    if any(now[k] != stats[c][k]
                           for k in ("buffers", "keyed", "misses")):
                        fail(f"{where}: the repeat changed {c}'s cache: "
                             f"{stats[c]} -> {now}")
            row[f"{gen}_{run}_ms"] = ms
        caches = be.device_caches()
        if gen == "appended":
            copied = {str(c): caches[c].stats()["buffers"]
                      - before[c]["buffers"]
                      + caches[c].stats()["retired_buffers"]
                      - before[c]["retired_buffers"] for c in before}
            total = caches[cards[0]].stats()["buffers"]
            if len(before) != n_cards or \
                    set(copied.values()) != {new} or not 0 < new < total:
                fail(f"cards streaming: the append copied {copied} buffers "
                     f"(prime_fdb said {new} of {total}); expected the new "
                     "ones only, on each card")
            row.update(new_buffers=new, copied_by_card=copied,
                       buffers=total)
        row[f"{gen}_shards"] = snap.num_shards
    print("cards " + json.dumps({**row, "match": True}))


def segment_entry(torch, captured, reps, measure, segment_case,
                  branch_launches):
    """Phase 4 for segment_agg: each branch at its largest main-path input
    and at a larger shape (the global branch's group space grows with its
    rows, the shared branch's stays), held to the plain version and timed
    beside the library call.  The shared
    branch must give the same bits from two calls.  Returns the
    kernels-line entry's keys: the top-level numbers are the global
    branch's (Q1's wave, the largest)."""
    branches = {}
    for branch in SEG_BRANCHES:
        gid, vals, groups = captured[("segment_agg", branch)][1]
        if branch == "global":          # offset groups: the space grows
            big_gid = torch.cat([torch.where(gid >= 0, gid + i * groups, gid)
                                 for i in range(reps)]).contiguous()
            big_groups = groups * reps
        else:                           # same groups: the branch holds
            big_gid, big_groups = torch.cat([gid] * reps).contiguous(), groups
        if seg_branch(big_groups) != branch:
            fail(f"segment_agg: the larger shape left the {branch} branch")
        big_vals = torch.cat([vals] * reps).contiguous()
        row = {"launches": branch_launches[branch]}
        for size, args, iters in (("wave", (gid, vals, groups), (200, 20)),
                                  ("large", (big_gid, big_vals, big_groups),
                                   (50, 5))):
            case, share = segment_case(*args)
            m = measure("segment_agg", *case, *iters)
            m.update(shape=[args[0].numel(), args[2]], selected_share=share)
            if branch == "shared":
                first, second = case[0](), case[0]()
                if not all(torch.equal(x, y) for x, y in zip(first, second)):
                    fail(f"segment_agg shared {size}: two calls gave "
                         "different bits")
                m["bit_identical"] = True
            row[size] = m
        branches[branch] = row
        print(f"kernel segment_agg[{branch}]: " + "; ".join(
            f"{size} {m['shape']} selected {m['selected_share']:.4f} "
            f"{m['ms']:.4f} ms, device {m['device_ms']} (bound "
            f"{m['bound_ms']:.6f}, plain {m['plain_ms']:.3f}, index_add_ "
            f"[G,3] {m['library_ms']:.4f})"
            for size, m in row.items() if size != "launches"))
    top = branches["global"]
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")
    return {"wave": {k: top["wave"][k] for k in keys},
            "large": {k: top["large"][k] for k in (*keys, "shape")},
            "shape": top["wave"]["shape"],
            "selected_share": top["wave"]["selected_share"],
            "library": "index_add_ of the selected rows' (1, v, v*v) into "
                       "[G, 3] float64",
            "branches": branches}


def launch_path(torch, np, calls=LAUNCH_PATH_CALLS,
                repeats=LAUNCH_PATH_REPEATS):
    """µs a call of each step a kernel launch takes through
    ``kernels._build`` and of the ``bitset_binary`` and ``segment_agg``
    wrappers beside ``torch.bitwise_and``: each step ``calls`` times in a
    row, after 100 untimed calls, on ``time.perf_counter_ns`` with one sync at the end;
    all steps in turn ``repeats`` times, reporting each step's median
    (``us``) and least (``us_min``).  Fails unless each wrapper's launch
    counter grew by its calls."""
    from collections import Counter
    from repro_torch.kernels import _build, bitset, ops, segment_agg
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    w = LAUNCH_PATH_WORDS

    def words():
        return torch.from_numpy(rng.integers(0, 1 << 32, w, dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)).to(dev)

    a, b = words(), words()
    out = torch.empty_like(a)
    entry = _build.library("bitset").repro_bitset_binary
    stream = torch.cuda.current_stream(dev).cuda_stream
    pa, pb, po = a.data_ptr(), b.data_ptr(), out.data_ptr()
    seg = {}
    for branch, (n, g, share) in LAUNCH_PATH_SEG.items():
        gid = np.where(rng.random(n) < share, rng.integers(0, g, n), -1)
        seg[branch] = (torch.from_numpy(gid.astype(np.int32)).to(dev),
                       torch.from_numpy(rng.uniform(0.0, 130.0, n)
                                        .astype(np.float32)).to(dev), g)
    lock, counter = threading.Lock(), Counter()
    g = LAUNCH_PATH_SEG["shared"][1]
    slabs = 1 + segment_agg.shared_blocks(LAUNCH_PATH_SEG["shared"][0], g)

    def count():
        with lock:
            counter["bitset_binary"] += 1

    steps = {
        "require": lambda: _build.require(a, "a", torch.int32, 1),
        "empty_like_out": lambda: torch.empty_like(a),
        "alloc_outputs_wave": lambda: segment_agg.alloc_outputs(
            g, dev, slabs=slabs),
        "data_ptr": a.data_ptr,
        "current_device": torch.cuda.current_device,
        "current_stream_by_index": lambda: torch.cuda.current_stream(
            dev.index).cuda_stream,
        "ctypes_call_no_launch": lambda: entry(pa, pb, po, 0, 0, stream),
        "ctypes_call_launch": lambda: entry(pa, pb, po, w, 0, stream),
        "count": count,
        "ops_record_launch": lambda: ops.record_launch("launch_path"),
        "launch": lambda: _build.launch("launch_path", "repro_bitset_binary",
                                        dev, a, b, out, w, 0),
        "bitset_binary": lambda: bitset.bitset_binary(a, b),
        "bitwise_and": lambda: torch.bitwise_and(a, b),
        "segment_agg_shared_wave": lambda: segment_agg.segment_agg(
            *seg["shared"]),
        "segment_agg_global_wave": lambda: segment_agg.segment_agg(
            *seg["global"]),
    }
    before = _build.kernel_launches()
    runs = {name: [] for name in steps}
    for _ in range(repeats):              # the host's spread: steps in turn
        for name, fn in steps.items():
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            runs[name].append((time.perf_counter_ns() - t0) / calls / 1e3)
    grew = {k: n - before.get(k, 0)
            for k, n in _build.kernel_launches().items()
            if n != before.get(k, 0)}
    per = repeats * (calls + 100)
    need = {"launch_path": per, "bitset_binary": per, "segment_agg": 2 * per}
    if grew != need:
        fail(f"launch_path: launch counters grew by {grew}, expected {need}")
    us = {k: sorted(v)[len(v) // 2] for k, v in runs.items()}
    return {"calls": calls, "repeats": repeats, "us": us,
            "us_min": {k: min(v) for k, v in runs.items()}, "launches": grew,
            "words": w, "segment_agg": {k: list(v) for k, v in
                                        LAUNCH_PATH_SEG.items()}}


def flash_case(torch, q, k, v, **kw):
    """The flash_attention case for ``measure``: kernel, plain version,
    the library call (SDPA for causal self-attention with Sq = Skv, or
    non-causal attention of any Sq, Skv, without window or softcap; else
    ``flex_attention``: :func:`flex_library`), the check, bytes and
    operations.  Bound: 4·D flops (two products) per unmasked (query,
    key) pair and head at the bf16 tensor rate, or q, k, v and o once."""
    from torch.nn.functional import scaled_dot_product_attention
    from repro_torch.kernels import flash_attention as fa_kernel
    from repro_torch.kernels import ref
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    causal = kw.get("causal", True)
    keep = kpos <= qpos if causal else (kpos >= 0) & (qpos >= 0)
    if kw.get("window"):
        keep &= kpos > qpos - kw["window"]
    pairs = int(keep.sum())

    def compare(g, w):
        atol, rtol = ref.flash_tolerance(w)
        wf = w.float()
        d_ = (g.float() - wf).abs()
        if bool((d_ > atol + rtol * wf.abs()).any()):
            fail(f"flash_attention {list(q.shape)}: differs from the "
                 f"plain version by {float(d_.max())} (atol {atol}, rtol "
                 f"{rtol})")
        checked = {"atol": atol, "rtol": rtol,
                   "mean_abs_plain": float(wf.abs().mean())}
        if not causal and skv % FLASH_KEY_TILE and skv > FLASH_KEY_TILE:
            # the plain output without the partial last key tile: the share
            # of elements the bound rejects, and how far the tile moves them
            cut = skv - skv % FLASH_KEY_TILE
            short = ref.flash_attention_ref(q, k[:, :, :cut], v[:, :, :cut],
                                            **kw).float()
            shift = (short - wf).abs()
            share = float((shift > atol + rtol * wf.abs()).float().mean())
            checked.update(tail_tile_dropped_rejected_share=share,
                           tail_tile_dropped_max_shift=float(shift.max()))
            # self-attention's keys are its queries' own spread positions,
            # so the bound must see the tile; a cross call's keys (the last
            # encoder layer's output under random weights) can lie so close
            # together that no key tile moves the output
            if sq == skv and share == 0:
                fail(f"flash_attention {list(q.shape)}: the bound does not "
                     "reject a result without the last key tile")
        return float(d_.max()), checked

    library = None
    if (sq == skv or not causal) and not kw.get("window") \
            and not kw.get("softcap"):
        def library():
            return scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)
    else:
        library = flex_library(torch, q, k, v, **kw)
    return (lambda: fa_kernel.flash_attention(q, k, v, **kw),
            lambda: ref.flash_attention_ref(q, k, v, **kw), library,
            compare, q.element_size() * (2 * q.numel() + 2 * k.numel()),
            4 * b * hq * d * pairs)


_FLEX = []


def flex_library(torch, q, k, v, *, causal=True, window=None, softcap=None,
                 scale=None):
    """One PyTorch call that computes flash_attention where SDPA cannot (a
    window, a softcap, a causal mask at the Skv − Sq offset):
    ``flex_attention``, compiled once (Inductor's Triton kernel, built
    here before any timed call), the softcap its ``score_mod`` and the
    causal and window mask its block mask, GQA through ``enable_gqa``.
    Held to the plain version within ``ref.flash_tolerance``."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    from repro_torch.kernels import _build, ref
    if not _FLEX:
        # Inductor's and Triton's caches in the kernels' build directory
        for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                         ("TRITON_CACHE_DIR", "triton")):
            os.environ.setdefault(var, str(_build.BUILD_DIR / sub))
        _FLEX.append(torch.compile(flex_attention, dynamic=False))
    off = k.shape[2] - q.shape[2]

    def mask_mod(b, h, qi, ki):
        keep = ki <= qi + off if causal else ki >= 0
        if window:
            keep = keep & (ki > qi + off - window)
        return keep

    def score_mod(x, b, h, qi, ki):
        return softcap * torch.tanh(x / softcap)

    block_mask = create_block_mask(mask_mod, None, None, q.shape[2],
                                   k.shape[2], device=q.device)

    def library():
        return _FLEX[0](q, k, v, score_mod=score_mod if softcap else None,
                        block_mask=block_mask, scale=scale,
                        enable_gqa=True)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    atol, rtol = ref.flash_tolerance(want)          # in q's dtype
    want = want.float()
    d_ = (library().float() - want).abs()
    if bool((d_ > atol + rtol * want.abs()).any()):
        fail(f"flash_attention {list(q.shape)}: flex_attention, the library "
             f"call, differs from the plain version by {float(d_.max())}")
    return library


def ssm_case(torch, a, bx, h0):
    """The ssm_scan case for ``measure`` (no library call computes the
    recurrence).  Bytes: a, bx (and h0) read once, h (and h_final)
    written once."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ssm_kernel

    def compare(g, w):
        err = 0.0
        for x, y in zip(g, w):
            d_ = (x - y).abs()
            if bool((d_ > SSM_TOL + SSM_TOL * y.abs()).any()):
                fail(f"ssm_scan {list(a.shape)}: differs from the plain "
                     f"version by {float(d_.max())}")
            err = max(err, float(d_.max()))
        return err

    nbytes = 4 * (3 * a.numel() + 2 * a.shape[0] * a.shape[2])
    return (lambda: ssm_kernel.ssm_scan(a, bx, h0),
            lambda: ref.ssm_scan_ref(a, bx, h0), None, compare, nbytes,
            2 * a.numel())


def _unfused_chain(torch, dt, x, bm, cm, A):
    """The Mamba layer's selective scan as it ran before the fused kernel:
    a chunk of LM_SSM_CHUNK steps at a time, exp(dt·A) and (dt·x)·B over
    [B, c, dI, N] in float32, row 10 (``ssm_scan``) from the last chunk's
    state, y = Σ_n h·C → (y, h_final)."""
    from repro_torch.kernels import ssm_scan as ssm_kernel
    b, s, di = dt.shape
    n = A.shape[1]
    h, ys = torch.zeros((b, di * n), device=dt.device), []
    for c0 in range(0, s, LM_SSM_CHUNK):
        cut = slice(c0, c0 + LM_SSM_CHUNK)
        dc = dt[:, cut].float()
        cl = dc.shape[1]
        a = torch.exp(dc[..., None] * A)
        bx = (dc * x[:, cut].float())[..., None] \
            * bm[:, cut].float()[:, :, None, :]
        hs, h = ssm_kernel.ssm_scan(a.reshape(b, cl, di * n),
                                    bx.reshape(b, cl, di * n), h)
        del a, bx
        ys.append(torch.einsum("bcdn,bcn->bcd", hs.view(b, cl, di, n),
                               cm[:, cut].float()))
    return torch.cat(ys, dim=1), h.view(b, di, n)


def selective_case(torch, dt, x, bm, cm, A):
    """The selective_scan case for ``measure``, against the unfused chain
    (:func:`_unfused_chain`, timed as its plain version; no library call
    computes the scan).  Bound: dt, x, B, C read once, y and h_final
    written once, A read once; against B·L·dI·N exps at the card's SFU
    rate (the multiply-adds, 4 a state element and step, take less at
    the FP32 rate)."""
    from repro_torch.kernels import selective_scan as sel_kernel

    def compare(g, w):
        err = 0.0
        for name, a, b in zip(("y", "h_final"), g, w):
            d_ = float((a - b).abs().max())
            scale = float(b.abs().max())
            if not d_ <= SELECTIVE_REL * scale:
                fail(f"selective_scan {list(dt.shape)}: {name} differs "
                     f"from the unfused chain by {d_} (max |{name}| "
                     f"{scale})")
            err = max(err, d_)
        return err

    b, s, di = dt.shape
    n = A.shape[1]
    nbytes = (dt.element_size() * (2 * b * s * di + 2 * b * s * n)
              + 4 * (di * n + b * s * di + b * di * n))
    return (lambda: sel_kernel.selective_scan(dt, x, bm, cm, A),
            lambda: _unfused_chain(torch, dt, x, bm, cm, A), None, compare,
            nbytes, b * s * di * n)


def _pad_left(np, prompts):
    """Prompts left-padded with token 0 to a common length, as
    ``Server.generate_batch`` pads them → [B, S] int32."""
    s = max(p.shape[0] for p in prompts)
    toks = np.zeros((len(prompts), s), np.int32)
    for i, p in enumerate(prompts):
        toks[i, s - p.shape[0]:] = p
    return toks


def _flash_key(cname, args, kw):
    """The recorded flash_attention call's name: the config for causal
    self-attention, "<config> encoder" for the non-causal Sq = Skv one,
    "<config> cross" for the non-causal Sq ≠ Skv one."""
    if kw.get("causal", True):
        return cname
    self_attn = args[0].shape[2] == args[1].shape[2]
    return f"{cname} {'encoder' if self_attn else 'cross'}"


def _record_inputs(torch, inputs, cname, run):
    """``run()`` with the kernels' wrappers recording their inputs: per
    flash_attention mode (``_flash_key``) the largest q, and the largest
    selective_scan call (dt, x, B, C, A)."""
    from repro_torch.kernels import flash_attention as fa_kernel
    from repro_torch.kernels import selective_scan as sel_kernel

    def recorder(key, fn):
        def call(*args, **kw):
            if key == "flash_attention":
                name = _flash_key(cname, args, kw)
                best = inputs[key].get(name)
                if best is None or best[0][0].numel() < args[0].numel():
                    inputs[key][name] = (tuple(a.clone() for a in args),
                                         dict(kw))
            else:
                best = inputs[key]
                if best is None or best[0].numel() <= args[0].numel():
                    inputs[key] = tuple(a.clone() for a in args[:5])
            return fn(*args, **kw)
        return call

    orig = (fa_kernel.flash_attention, sel_kernel.selective_scan)
    fa_kernel.flash_attention = recorder("flash_attention", orig[0])
    sel_kernel.selective_scan = recorder("selective_scan", orig[1])
    try:
        with torch.inference_mode():
            run()
    finally:
        fa_kernel.flash_attention, sel_kernel.selective_scan = orig


def _lm_consistency(torch, np, cname, cfg, rng, frames=None):
    """Prefill (kernels) vs decode (plain) in float32 with dropless MoE:
    the decode logits at position S-1 after a prefill of S-1 tokens
    against the prefill's over S, on a fresh float32 model."""
    from repro_torch.ml.transformer import LM
    cfg32 = _f32_cfg(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg32)
    params = lm.init(seed=0, device="cuda")
    b, n = LM_CHECK_SHAPE
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, n))
                            .astype(np.int32)).cuda()
    kw = {} if frames is None else {"frames": frames[:b]}
    with torch.inference_mode():
        want, _ = lm.prefill(params, toks, **kw)
        _, caches = lm.prefill(params, toks[:, :-1], **kw)
        got, _ = lm.decode_step(params, toks[:, -1:], caches, n - 1)
    err = float((got - want).abs().max() / want.abs().max())
    same = bool((got.argmax(-1) == want.argmax(-1)).all())
    out = {"shape": [b, n], "layers": cfg.num_layers, "rel_err": err,
           "bound": LM_CHECK_REL, "argmax_equal": same,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    if not (math.isfinite(err) and err < LM_CHECK_REL and same):
        fail(f"lm {cname}: decode after prefill differs from the "
             f"prefill's logits: {out}")
    del lm, params, caches, got, want
    torch.cuda.empty_cache()
    return out


def _lm_row(cname, cfg):
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    return {"config": cname, "layers": cfg.num_layers,
            "attention_layers": kinds.count("attn"),
            "mamba_layers": kinds.count("mamba"),
            "blocks": {k: kinds.count(k) for k in sorted(set(kinds))},
            "d_model": cfg.d_model, "act_dtype": cfg.act_dtype}


def _check_launches(cname, kc, need, totals):
    """The kernels a counted run launched must be ``need``'s, no other;
    they add to ``totals``."""
    for k, n in need.items():
        if kc.get(k, 0) != n:
            fail(f"lm {cname}: {k} launched {kc.get(k, 0)} times, "
                 f"expected {n}")
    other = {k: n for k, n in kc.items() if n and k not in need}
    if other:
        fail(f"lm {cname}: unexpected kernel launches {other}")
    for k, n in kc.items():
        totals[k] += n


def lm_phase(torch, np, totals):
    """Phase 3e: the LM serving path on the card (module docstring).

    Adds each kernel's launches in the counted runs to ``totals`` and
    returns the inputs the kernels got there (the largest flash_attention
    call per configuration and mode, the largest selective_scan call),
    recorded in one more prefill after the timed runs."""
    from dataclasses import replace
    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jamba = get_config("jamba_v0_1_52b")
    configs = {"smollm_360m": (get_config("smollm_360m"), _served),
               # one block cycle: 52B params (~104 GB in bf16) do not fit
               "jamba_v0_1_52b[8 of 32 layers]": (
                   replace(jamba, num_layers=8), _served),
               "xlstm_1_3b": (get_config("xlstm_1_3b"), _served),
               "whisper_large_v3": (get_config("whisper_large_v3"),
                                    _transcribed),
               # full width and depth: 8.93B params, 17.87 GB in bf16
               "gemma3_12b": (get_config("gemma3_12b"), _served)}
    inputs = {"flash_attention": {}, "selective_scan": None}
    expected = set()
    for cname, (cfg, start) in configs.items():
        expected |= _lm_config(torch, np, cname, cfg, start, totals, inputs)
    if inputs["selective_scan"] is None \
            or set(inputs["flash_attention"]) \
            != expected:
        fail(f"lm: the kernels' inputs were not recorded: "
             f"{sorted(inputs['flash_attention'])} for {sorted(expected)}")
    return inputs


def _served(torch, np, cfg):
    """A decoder-only configuration of phase 3e, through ``Server``: the
    model (:func:`_lm_config`'s ``start``) and its plan — 8 requests of
    64-512 random tokens, 16 new tokens each, ``max_batch`` 4; the warm
    window one ``generate_batch`` of the first 4 prompts."""
    from repro_torch.launch.serve import Request, Server
    srv = Server(cfg, reduced=False, max_batch=LM_MAX_BATCH)

    def plan(rng):
        kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
        lens = rng.integers(LM_PROMPT_LENS[0], LM_PROMPT_LENS[1] + 1,
                            LM_REQUESTS)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, n
                                        ).astype(np.int32),
                        max_new=LM_MAX_NEW) for i, n in enumerate(lens)]
        # serve() prefills max_batch newly admitted prompts at a time
        batches = [lens[i:i + LM_MAX_BATCH]
                   for i in range(0, LM_REQUESTS, LM_MAX_BATCH)]
        need = {"flash_attention": kinds.count("attn") * len(batches),
                "selective_scan": kinds.count("mamba") * len(batches)}

        def run():
            srv.serve(reqs)
            for r in reqs:
                if not (r.done and len(r.out) == LM_MAX_NEW
                        and all(0 <= t < cfg.vocab_size for t in r.out)):
                    fail(f"lm {cfg.name}: request {r.rid} gave {r.out}")
            return {"requests": LM_REQUESTS,
                    "prompt_lens": [int(n) for n in lens],
                    "tokens_out": sum(len(r.out) for r in reqs),
                    "stats": dict(srv.stats)}

        prompts = [r.prompt for r in reqs[:LM_MAX_BATCH]]
        big = max(batches, key=lambda b: int(max(b)))
        return {"run": run, "need": need,
                "toks": torch.from_numpy(_pad_left(np, prompts)).cuda(),
                "kw": {},
                "generate": lambda: srv.generate_batch(prompts,
                                                       max_new=LM_MAX_NEW),
                # the largest prefill of the run, at random tokens
                "record": torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (len(big), int(max(big))))
                    .astype(np.int32)).cuda()}

    return srv.lm, srv.params, plan


def _transcribed(torch, np, cfg):
    """Phase 3e's encoder-decoder, Whisper large-v3 (``Server`` takes no
    frames, as the reference's takes none): seeded frame embeddings [4,
    1500, 1280] bf16 and 4 decoder prompts of 4-224 tokens left-padded,
    through ``LM.prefill(frames=)`` and 15 greedy ``decode_step``s; 96
    flash_attention launches a prefill (the encoder's self, the decoder's
    causal self and cross attention, a layer each)."""
    from repro_torch.ml.transformer import LM
    lm = LM(cfg)
    params = lm.init(seed=0, device="cuda")

    def plan(rng):
        b, se = WHISPER_FRAMES
        gen = torch.Generator(device="cuda").manual_seed(0)
        frames = torch.randn((b, se, cfg.d_model), generator=gen,
                             device="cuda").to(torch.bfloat16)
        lens = rng.integers(WHISPER_PROMPT_LENS[0],
                            WHISPER_PROMPT_LENS[1] + 1, b)
        toks = torch.from_numpy(_pad_left(np, [
            rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens])).cuda()
        s = toks.shape[1]

        def generate():
            """Prefill and greedy decode → [B, LM_MAX_NEW] tokens."""
            with torch.inference_mode():
                logits, caches = lm.prefill(params, toks, frames=frames)
                cur = torch.argmax(logits, dim=-1).to(torch.int32)
                out = [cur]
                for t in range(LM_MAX_NEW - 1):
                    logits, caches = lm.decode_step(params, cur, caches,
                                                    s + t)
                    cur = torch.argmax(logits, dim=-1).to(torch.int32)
                    out.append(cur)
            return torch.cat(out, dim=1)

        def run():
            got = generate().cpu()
            if got.shape != (b, LM_MAX_NEW) or not bool(
                    ((got >= 0) & (got < cfg.vocab_size)).all()):
                fail(f"lm {cfg.name}: generated {got.tolist()}")
            return {"encoder_layers": cfg.encoder_layers,
                    "frames": [b, se, cfg.d_model],
                    "prompt_lens": [int(n) for n in lens],
                    "tokens_out": int(got.numel())}

        return {"run": run, "generate": generate, "toks": toks, "record": toks,
                "kw": {"frames": frames},
                "need": {"flash_attention": cfg.encoder_layers
                         + 2 * cfg.num_layers, "selective_scan": 0}}

    return lm, params, plan


def _lm_config(torch, np, cname, cfg, start, totals, inputs):
    """One configuration of phase 3e, the same steps for each.

    ``start(torch, np, cfg)`` builds the model on the card (timed as
    init) → (lm, params, plan); ``plan(rng)`` → ``run``, the counted run
    (it checks its own output and returns its fields of the row,
    ``tokens_out`` among them), ``need``, the kernel launches that run
    must make, ``toks``, the warm batch's left-padded prompts, ``kw``,
    the prefill's other arguments (Whisper's frames), ``generate``, the
    warm window, and ``record``, the tokens of the prefill whose kernel
    inputs are recorded.  Then the warm batch's prefill and decode steps
    are timed, the warm window profiled (with an sLSTM block its decode
    steps alone: the profiler takes ~90 s to process a prefill's 2,670
    sLSTM steps), the kernels' inputs recorded, and the float32
    consistency checked.  Prints the ``lm`` line; returns the
    flash_attention modes it recorded."""
    from repro_torch.kernels import _build, ops

    def sync_ms(t0):
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    t_row = time.perf_counter()
    row = _lm_row(cname, cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm, params, plan = start(torch, np, cfg)
    row["init_ms"] = sync_ms(t0)
    row["param_bytes"] = sum(t.numel() * t.element_size()
                             for t in _leaves(params))
    row["param_count"] = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(0)
    p = plan(rng)
    toks, kw = p["toks"], p["kw"]
    ops.reset_launch_counts()
    _build.reset_kernel_launches()
    t0 = time.perf_counter()
    fields = p["run"]()
    row["serve_ms"] = sync_ms(t0)
    kc = _build.kernel_launches()
    _check_launches(cname, kc, p["need"], totals)
    row.update(fields, serve_kernels=kc, serve_dispatches=ops.launch_counts(),
               serve_peak_bytes=torch.cuda.max_memory_allocated())
    row["serve_tokens_per_s"] = row["tokens_out"] / row["serve_ms"] * 1e3

    # warm: the batch's prefill and decode steps, timed in parts
    b, s = toks.shape
    with torch.inference_mode():
        if "frames" in kw:
            t0 = time.perf_counter()
            lm.encode(params, kw["frames"])
            row["encode_ms"] = sync_ms(t0)
        lm.prefill(params, toks, **kw)                   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = lm.prefill(params, toks, **kw)
        row["prefill_ms"] = sync_ms(t0)
        first = torch.argmax(logits, dim=-1).to(torch.int32)

        def decode_steps():
            t0, cur, c = time.perf_counter(), first, caches
            with torch.inference_mode():
                for t in range(LM_MAX_NEW - 1):
                    out, c = lm.decode_step(params, cur, c, s + t)
                    cur = torch.argmax(out, dim=-1).to(torch.int32)
            return sync_ms(t0)

        row["decode_ms_per_step"] = decode_steps() / (LM_MAX_NEW - 1)
    row["warm_batch"] = [b, s]
    row["warm_tokens_per_s"] = b * LM_MAX_NEW / (
        row["prefill_ms"] + (LM_MAX_NEW - 1) * row["decode_ms_per_step"]
    ) * 1e3

    if "slstm" in cfg.block_pattern:
        row["profile_window"] = f"{LM_MAX_NEW - 1} decode steps"
        with torch.inference_mode():
            _, caches = lm.prefill(params, toks, **kw)
            window = decode_steps
    else:
        row["profile_window"] = "generate"
        p["generate"]()                                  # warm

        def window():
            t0 = time.perf_counter()
            p["generate"]()
            return sync_ms(t0)

    t_prof = time.perf_counter()
    wall, busy = _profiled(torch, window)
    row.update(profiled_wall_ms=wall, profile_s=time.perf_counter() - t_prof,
               **busy)
    del caches, logits
    _record_inputs(torch, inputs, cname,
                   lambda: lm.prefill(params, p["record"], **kw))
    del lm, params, plan, p          # the float32 check needs the room
    torch.cuda.empty_cache()
    row["consistency"] = _lm_consistency(
        torch, np, cname, cfg, rng, frames=kw.get("frames"))
    row["seconds"] = time.perf_counter() - t_row
    print("lm " + json.dumps(row))
    modes = {cname} if row["attention_layers"] else set()
    if cfg.encoder_layers:
        modes |= {f"{cname} encoder", f"{cname} cross"}
    return modes


#: phase 3g: the §5 loop (examples/ml_workflow.py) and the LM train step
TTM_FIT = {"hidden": 64, "depth": 2, "steps": 400, "lr": 2e-3, "batch": 1024}
#: card against the CPU, TF32 off: float32 sums in another order
TTM_LOSS_RTOL = 1e-4
LM_TRAIN = {"steps": 6, "batch": 8, "seq": 512, "ckpt_every": 3}
#: three reduced Jamba steps, card against CPU from the same float32
#: params (float32 activations): each step's loss and grad norm, so a wrong
#: update shows in the next step's loss; the first step's gradients, each
#: leaf within 2^-8 of its largest |element|, because the Mamba path stages
#: its scan inputs in bf16 on both devices and a float32 ulp upstream can
#: flip one bf16 rounding.  AdamW's first update is g / (|g| + eps) ≈ ±1
#: whatever |g|: an element whose gradient is above STEP_SIGNAL (4 × the
#: gradient bound of its leaf, and 100 × eps after clipping) has its sign
#: fixed by the gradient check and must move as on the CPU, within
#: STEP_PARAM_ATOL; one whose gradient is float32 noise may move by ±lr
#: either way, so the rest are held within 2·Σ lr
STEP_LOSS_RTOL, STEP_GNORM_RTOL, STEP_GRAD_REL = 1e-4, 1e-3, 2.0 ** -8
STEP_SIGNAL, STEP_PARAM_ATOL, STEP_COUNT = 4 * STEP_GRAD_REL, 1e-5, 3
SNAP_SHAPE = (1000, 2000)          # waypoints × road segments


def train_phase(torch, np, world, cat, counted):
    """Phase 3g: the training paths on the card (module docstring).  Every
    run is counted (launch counts 0 just before, read just after); the
    train steps and the geo Viterbi launch none of the port's kernels."""
    import shutil
    import tempfile
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.core import BETWEEN, P, fdb, group, proto
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.exec import AdHocEngine, NumpyBackend, TorchBackend
    from repro_torch.fdb import build_fdb
    from repro_torch.geo.denoise import snap_path
    from repro_torch.kernels import _build
    from repro_torch.launch.train import train_loop
    from repro_torch.ml.integration import MLPRegressor
    from repro_torch.ml.model import ModelBundle, TrainConfig
    from repro_torch.ml.optim import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def no_launches(where, kc):
        if any(kc.values()):
            fail(f"train {where}: kernels launched {kc}, expected none")

    # ------------------------------------------- time to trained model
    t_sub = time.perf_counter()
    cat.register(build_fdb("Roads", world["roads_schema"], world["roads"],
                           num_shards=5))
    engine = AdHocEngine(cat, backend=TorchBackend(device="cuda"))
    oracle = AdHocEngine(cat, backend=NumpyBackend())
    feats = ["hour", "dow", "sl"]

    def roads(eng):
        return (fdb("Roads").map(lambda p: proto(rid=p.id, sl=p.speed_limit))
                .collect(eng).to_dict("rid"))

    def select(eng, roads_tbl):
        return (fdb("SpeedObservations").find(BETWEEN(P.month, 1, 4))
                .to_dataset(features={"hour": P.hour * 1.0,
                                      "dow": P.dow * 1.0,
                                      "sl": roads_tbl[P.road_id].sl},
                            target=P.speed, engine=eng))

    row = {"sub": "time_to_trained_model", "fit": TTM_FIT}
    roads_tbl, _, kc, row["roads_ms"] = counted("roads", lambda: roads(engine))
    ds, _, kc, row["time_to_training_data_ms"] = counted(
        "cold", lambda: select(engine, roads_tbl))
    row["selection_kernels"] = kc
    for k in ("bitmap_intersect_batched", "compact_batched"):
        if kc.get(k, 0) < 1:
            fail(f"train selection: {k} never launched ({kc})")
    _, _, _, row["time_to_training_data_warm_ms"] = counted(
        "warm", lambda: select(engine, roads_tbl))
    want = select(oracle, roads(oracle))
    if ds.features.tobytes() != want.features.tobytes() or \
            ds.targets.tobytes() != want.targets.tobytes():
        fail("train: the card's training data differ from the numpy "
             "oracle's")
    row.update(rows_selected=len(ds), features=ds.feature_names,
               oracle_byte_equal=True)
    (model, losses), _, kc, row["fit_ms"] = counted(
        "fit", lambda: ds.fit(device="cuda", **TTM_FIT))
    no_launches("fit", kc)
    row["time_to_trained_model_ms"] = (row["time_to_training_data_ms"]
                                       + row["fit_ms"])
    row["loss_first_last"] = [losses[0], losses[-1]]
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        fail(f"train: the fit did not learn: {row['loss_first_last']}")
    cpu = MLPRegressor(ds.num_features, hidden=TTM_FIT["hidden"],
                       depth=TTM_FIT["depth"], device="cpu")
    cpu_losses = cpu.train(ds.features, ds.targets,
                           **{k: TTM_FIT[k] for k in ("steps", "lr",
                                                      "batch")})
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    row["cpu_loss_max_rel"] = rel
    row["cpu_loss_rtol"] = TTM_LOSS_RTOL
    if not rel <= TTM_LOSS_RTOL:
        fail(f"train: the card's loss curve is {rel:.3g} from the CPU's "
             f"(bound {TTM_LOSS_RTOL})")
    _build.reset_kernel_launches()       # _profiled reads the window
    _, busy = _profiled(torch, lambda: counted("busy", lambda: ds.fit(
        device="cuda", **TTM_FIT))[3])
    row["fit_device_busy_ms"] = busy["device_busy_ms"]
    row["fit_device_idle_share"] = busy["device_idle_share"]

    col_model = model.as_column_model(feats)
    eval_q = (fdb("SpeedObservations").find(BETWEEN(P.month, 5, 6))
              .map(lambda p: proto(hour=p.hour * 1.0, dow=p.dow * 1.0,
                                   sl=roads_tbl[p.road_id].sl,
                                   speed=p.speed))
              .model_apply(col_model, output="pred",
                           hour=P.hour, dow=P.dow, sl=P.sl)
              .map(lambda p: proto(err=(p.pred - p.speed)
                                   * (p.pred - p.speed)))
              .aggregate(group().avg(mse=P.err).count("n")))
    res, _, kc, row["model_apply_ms"] = counted("eval",
                                                lambda: engine.collect(eval_q))
    row["eval_kernels"] = kc
    rec = res.to_records()[0]
    row.update(eval_rows=rec["n"], rmse=rec["mse"] ** 0.5,
               target_sd=float(np.std(ds.targets)))
    if not row["rmse"] < row["target_sd"]:
        fail(f"train: RMSE {row['rmse']:.3f} does not beat the targets' "
             f"standard deviation {row['target_sd']:.3f}")

    annot_q = (fdb("Roads")
               .map(lambda p: proto(rid=p.id, sl=p.speed_limit,
                                    hour=p.speed_limit * 0.0 + 8.0,
                                    dow=p.speed_limit * 0.0 + 2.0))
               .model_apply(col_model, output="pred_speed",
                            hour=P.hour, dow=P.dow, sl=P.sl))
    db, _, kc, row["annotate_ms"] = counted(
        "annotate", lambda: engine.save(annot_q, "RoadSpeedPredictions",
                                        num_shards=4))
    check, _, _, _ = counted("annotated", lambda: engine.collect(
        fdb("RoadSpeedPredictions").aggregate(
            group().avg(mean_pred=P.pred_speed).count("n"))))
    check = check.to_records()[0]
    if check["n"] != db.num_docs or not math.isfinite(check["mean_pred"]):
        fail(f"train: annotated FDb {check} of {db.num_docs} roads")
    row["annotated"] = {"roads": db.num_docs,
                        "mean_pred": check["mean_pred"]}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_model_")
    try:
        model.save(tmp, feats)
        probe = {"hour": np.arange(24.0), "dow": np.full(24, 2.0),
                 "sl": np.full(24, 50.0)}
        a = col_model.apply_columns(probe)
        b = MLPRegressor.load(tmp, device="cuda").apply_columns(probe)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not np.array_equal(a, b):
        fail("train: the reloaded model predicts differently")
    row["save_load_equal"] = True
    row["seconds"] = time.perf_counter() - t_sub
    print("train " + json.dumps(row))

    # ------------------------------------------------- LM train step
    t_sub = time.perf_counter()
    cfg = get_config("smollm_360m")
    row = {"sub": "lm_train", "config": "smollm_360m",
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "param_count": cfg.params_count(), "param_dtype": "float32",
           "remat": "full", **LM_TRAIN}
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        steps, marks = [], [None]

        def on_step(step, m):
            torch.cuda.synchronize()
            now = time.perf_counter()
            steps.append({"step": step, "ms": (now - marks[0]) * 1e3,
                          "loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "lr": float(m["lr"])})
            marks[0] = time.perf_counter()

        def run(resume):
            steps.clear()
            marks[0] = time.perf_counter()
            return train_loop(cfg, reduced=False, steps=LM_TRAIN["steps"],
                              batch=LM_TRAIN["batch"], seq=LM_TRAIN["seq"],
                              ckpt_dir=ckpt,
                              ckpt_every=LM_TRAIN["ckpt_every"],
                              resume=resume, log_every=LM_TRAIN["steps"],
                              device="cuda", print_fn=lambda *_: None,
                              on_step=on_step)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (full_params, full_opt, _), _, kc, row["run_ms"] = counted(
            "lm", lambda: run(False))
        no_launches("lm", kc)
        first = [dict(s) for s in steps]
        row["peak_bytes"] = torch.cuda.max_memory_allocated()
        row["param_bytes"] = sum(t.numel() * t.element_size()
                                 for t in tree_leaves(full_params))
        warm = sorted(s["ms"] for s in first[1:])
        row["cold_step_ms"] = first[0]["ms"]
        row["warm_step_ms"] = warm[len(warm) // 2]
        row["tokens_per_s"] = (LM_TRAIN["batch"] * LM_TRAIN["seq"]
                               / row["warm_step_ms"] * 1e3)
        row["per_step"] = first
        if not all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
                   for s in first):
            fail(f"train lm: non-finite losses {first}")
        # the run "crashed" after its step-3 checkpoint
        shutil.rmtree(Path(ckpt) / f"step-{LM_TRAIN['steps']:08d}")
        (params, opt, _), _, kc, row["resume_run_ms"] = counted(
            "lm", lambda: run(True))
        no_launches("lm resume", kc)
        again = steps[:]
        k = LM_TRAIN["ckpt_every"]
        # bit for bit: the step counter, every param and AdamW moment, and
        # each resumed step's loss, grad norm and lr
        same_state = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(params) + tree_leaves(opt),
            tree_leaves(full_params) + tree_leaves(full_opt)))
        del full_params, full_opt
        row["resume"] = {"steps": [s["step"] for s in again],
                         "losses": [s["loss"] for s in again],
                         "adam_step": int(opt["adam"]["step"]),
                         "state_equal": same_state}
        def seen(rows):
            return [(s["step"], s["loss"], s["grad_norm"], s["lr"])
                    for s in rows]

        if [s["step"] for s in again] != list(range(k, LM_TRAIN["steps"])) \
                or seen(again) != seen(first[k:]) \
                or row["resume"]["adam_step"] != LM_TRAIN["steps"] \
                or not same_state:
            fail(f"train lm: the resumed run does not repeat steps "
                 f"{k}-{LM_TRAIN['steps'] - 1}: {row['resume']}")
        row["flash_attention_launches"] = 0
        row["ssm_scan_launches"] = 0
        # one more step from the resumed state under the profiler: the
        # device's busy share and its top operations
        mb = ModelBundle(cfg, train_cfg=TrainConfig(
            lr=1e-3, warmup=1, total_steps=LM_TRAIN["steps"],
            loss_chunk=None, remat="full"), device="cuda")
        step_fn = mb.make_train_step()
        pipe = TokenPipeline(cfg.vocab_size, LM_TRAIN["batch"],
                             LM_TRAIN["seq"], start_step=LM_TRAIN["steps"])
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in next(pipe).items()}
        pipe.close()
        prof_kc = []

        def one():
            t0 = time.perf_counter()
            step_fn(params, opt, batch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        def profiled_step():
            ms, _, kc, _ = counted("lm profile", one)
            prof_kc.append(kc)
            return ms

        _build.reset_kernel_launches()   # _profiled reads the window
        wall, busy = _profiled(torch, profiled_step)
        no_launches("lm profile", prof_kc[-1])
        row["profiled_step"] = {"wall_ms": wall, **busy}
        del params, opt
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t_sub
    print("train " + json.dumps(row))

    # ------------------------------- three reduced Jamba steps, card vs CPU
    t_sub = time.perf_counter()
    jcfg = replace(get_config("jamba_v0_1_52b").reduced(),
                   act_dtype="float32")
    tc = TrainConfig(warmup=1, total_steps=STEP_COUNT + 1, loss_chunk=16,
                     remat="full")
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
            for _ in range(STEP_COUNT)]
    p0, out = None, {}
    for dev in ("cuda", "cpu"):
        mb = ModelBundle(jcfg, train_cfg=tc, device=dev)
        if p0 is None:
            p0 = mb.init_params(0)
        batches = [{"tokens": torch.from_numpy(t).to(dev),
                    "labels": torch.from_numpy(np.roll(t, -1, 1)).to(dev)}
                   for t in toks]

        def run_steps(mb=mb, batches=batches, dev=dev):
            step = mb.make_train_step()
            p = tree_map(lambda t: t.to(dev), p0)
            opt, kept, metrics = mb.init_opt_state(p), [], []
            for b in batches:
                p, opt, m = step(p, opt, b)
                kept.append(p)
                metrics.append({k: float(v) for k, v in m.items()})
            return kept[0], kept[-1], metrics

        (p1, pn, metrics), _, kc, ms = counted("jamba", run_steps)
        no_launches(f"jamba steps {dev}", kc)
        grads = mb.loss_and_grads(tree_map(lambda t: t.to(dev), p0),
                                  batches[0])[3]
        out[dev] = ([t.cpu() for t in tree_leaves(p1)],
                    [t.cpu() for t in tree_leaves(pn)],
                    [t.cpu() for t in tree_leaves(grads)], metrics, ms)
    (g1, gn, gg, mg, ms_g), (c1, cn, gc, mc, ms_c) = out["cuda"], out["cpu"]
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(mg, mc))
    gnorm_rel = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                    for a, b in zip(mg, mc))
    g_rel = max(float((a - b).abs().max() / (b.abs().max() + 1e-30))
                for a, b in zip(gg, gc))
    # the first step: tight where the CPU's clipped gradient is signal
    clip = min(1.0, tc.clip_norm / mc[0]["grad_norm"])
    signal_n, signal_err = 0, 0.0
    for a, b, g in zip(g1, c1, gc):
        mag = g.abs()
        sig = (mag >= STEP_SIGNAL * mag.max()) & (mag * clip >= 100 * 1e-8)
        if bool(sig.any()):
            signal_n += int(sig.sum())
            signal_err = max(signal_err, float((a - b).abs()[sig].max()))
    dp = max(float((a - b).abs().max()) for a, b in zip(gn, cn))
    reach = 2 * sum(m["lr"] for m in mc)
    row = {"sub": "jamba_steps_card_vs_cpu", "config": "jamba_v0_1_52b "
           "reduced, float32 activations", "steps": STEP_COUNT,
           "card": mg, "cpu": mc, "card_ms": ms_g, "cpu_ms": ms_c,
           "loss_max_rel": loss_rel, "grad_norm_max_rel": gnorm_rel,
           "grad_max_rel": g_rel, "param_count": sum(b.numel() for b in c1),
           "first_step_signal_params": signal_n,
           "first_step_signal_max_abs": signal_err,
           "last_step_param_max_abs": dp,
           "bounds": {"loss_rtol": STEP_LOSS_RTOL,
                      "grad_norm_rtol": STEP_GNORM_RTOL,
                      "grad_rel": STEP_GRAD_REL,
                      "signal_param_atol": STEP_PARAM_ATOL,
                      "param_atol": reach}}
    if not (loss_rel <= STEP_LOSS_RTOL and gnorm_rel <= STEP_GNORM_RTOL
            and all(abs(a["lr"] - b["lr"]) <= 1e-6 * b["lr"]
                    for a, b in zip(mg, mc))
            and g_rel <= STEP_GRAD_REL and signal_n > 0
            and signal_err <= STEP_PARAM_ATOL and dp <= reach):
        fail(f"train jamba: card and CPU steps differ: {row}")
    row["seconds"] = time.perf_counter() - t_sub
    print("train " + json.dumps(row))

    # ----------------------------------------------------- geo snap_path
    t_sub = time.perf_counter()
    t_n, s_n = SNAP_SHAPE
    rng = np.random.default_rng(1)
    ax, ay = rng.uniform(0, 400_000, s_n), rng.uniform(0, 400_000, s_n)
    ang = rng.uniform(0, 2 * np.pi, s_n)
    bx, by = ax + 4000 * np.cos(ang), ay + 4000 * np.sin(ang)
    pop = rng.integers(0, 100, s_n).astype(np.float64)
    walk = np.cumsum(rng.normal(0, 800, (t_n, 2)), axis=0) + 200_000
    args = (walk[:, 0], walk[:, 1], ax, ay, bx, by, pop, 0.05)
    runs = []
    for _ in range(3):
        got, _, kc, ms = counted("snap", lambda: snap_path(*args,
                                                           device="cuda"))
        no_launches("snap_path", kc)
        runs.append(ms)
    t0 = time.perf_counter()
    want = snap_path(*args, device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(got, want):
        fail(f"train snap_path: the card's path differs from the CPU's at "
             f"{int((got != want).sum())} of {t_n} waypoints")
    print("train " + json.dumps({
        "sub": "snap_path", "waypoints": t_n, "segments": s_n,
        "transition_bytes": s_n * s_n * 4, "cold_ms": runs[0],
        "warm_ms": min(runs[1:]), "cpu_ms": cpu_ms, "equal": True,
        "seconds": time.perf_counter() - t_sub}))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _host_rows(stats):
    """(cumulative ms, self ms, "file:function") per function profiled."""
    return [(ct * 1e3, tt * 1e3, f"{Path(f).name}:{fn}")
            for (f, _line, fn), (_cc, _nc, tt, ct, _) in stats.items()]


def _own_and_self(rows, n_own=12, n_self=8):
    """The port's own functions by cumulative ms, and any by self ms."""
    own = sorted((r for r in rows if "repro_torch" in r[2]
                  or r[2].split(":")[0] in PORT_FILES),
                 key=lambda r: -r[0])[:n_own]
    return ({name: round(ct, 3) for ct, _, name in own},
            {name: round(tt, 3) for _, tt, name in
             sorted(rows, key=lambda r: -r[1])[:n_self]})


def _kernel_name(key: str):
    """The function name of a kernel in a profiler key such as
    ``void (anonymous namespace)::scan<true>(...)``, else None."""
    found = re.search(r"::(\w+)\s*[<(]", key)
    return found.group(1) if found else None


def _device_busy(torch, prof, wall_ms, launches, top=6):
    """Busy ms, idle share and top entries of a ``torch.profiler`` window,
    or "not measured" when it saw no device time.

    Busy time is the union of the device records (:func:`_device_ms`).
    The profiler loses some device records (C5), so the port's kernels
    add what their lost records would have taken (``busy_ms_lost``): a
    family's recorded time scaled by its launches in the window
    (``launches``, the wrappers' counters over the window) over the
    records of the family's kernels that begin a launch, less the time
    recorded.  ``kernel_records`` holds each family's [records,
    launches]; ``device_busy_ms_raw`` the plain sum of every record."""
    from torch.autograd import DeviceType
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    if not dev:
        return {"device_busy_ms": "not measured",
                "device_idle_share": "not measured", "top_device_ms": {}}
    family_of = {k: fam for fam, names in KERNEL_FAMILIES.items()
                 for k in names}
    fam_ms, fam_records = {}, {}
    for e in dev:
        name = _kernel_name(e.key)
        fam = family_of.get(name)
        if fam is None:
            continue
        fam_ms[fam] = fam_ms.get(fam, 0.0) + e.self_device_time_total / 1e3
        if name not in FOLLOWERS:
            fam_records[fam] = fam_records.get(fam, 0) + e.count
    lost, records = 0.0, {}
    for fam, ms in fam_ms.items():
        n = sum(launches.get(c, 0) for c in fam)
        r = fam_records.get(fam, 0)
        if r and n > r:
            lost += ms * (n / r - 1.0)
        records["/".join(fam)] = [r, n]
    for fam in KERNEL_FAMILIES:        # launched, but every record lost
        n = sum(launches.get(c, 0) for c in fam)
        if n and fam not in fam_ms:
            records["/".join(fam)] = [0, n]
    busy_ms = sum(_device_ms(prof).values()) + lost
    entries = sorted(dev, key=lambda e: -e.self_device_time_total)[:top]
    return {"device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "busy_ms_lost": lost,
            "device_busy_ms_raw": sum(e.self_device_time_total
                                      for e in dev) / 1e3,
            "kernel_records": records,
            "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3
                              for e in entries}}


def _profiled(torch, run):
    """``run()`` (which returns its wall ms) under ``torch.profiler`` with
    CPU and CUDA activities: (wall ms, :func:`_device_busy` of the
    window).  A window that comes back with no device record at all is
    taken again, up to three times."""
    from repro_torch.kernels import _build
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        before = _build.kernel_launches()
        with torch.profiler.profile(activities=acts) as prof:
            wall_ms = run()
        launches = {k: n - before.get(k, 0)
                    for k, n in _build.kernel_launches().items()
                    if n != before.get(k, 0)}
        busy = _device_busy(torch, prof, wall_ms, launches)
        if busy["device_busy_ms"] != "not measured":
            break
    return wall_ms, busy


def profile_serve(torch, batches, backend, cat) -> None:
    """Phase 5, serve: where a warm coalesced batch's wall time goes — one
    ``run_pending()`` of 16 queries under ``cProfile`` (host functions)
    and one under ``torch.profiler`` (device busy share)."""
    import cProfile
    import pstats
    from repro_torch.serve import QueryServer
    for bname, (_source, flows, _mode) in batches.items():
        srv = QueryServer(backend=backend, catalog=cat, cache=False,
                          start=False)

        def drain():
            for f in flows:
                srv.submit(f)
            t0 = time.perf_counter()
            srv.run_pending()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        drain()                                  # warm
        host = cProfile.Profile()
        host.enable()
        host_ms = drain()
        host.disable()
        own, self_ms = _own_and_self(_host_rows(pstats.Stats(host).stats))
        wall_ms, busy = _profiled(torch, drain)
        print("profile " + json.dumps({
            "serve_batch": bname, "cprofile_wall_ms": host_ms,
            "host_cum_ms": own, "host_self_ms": self_ms,
            "profiled_wall_ms": wall_ms, **busy}))


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
        own, self_ms = _own_and_self(_host_rows(pstats.Stats(host).stats))
        wall_ms, busy = _profiled(torch, lambda: timed(warm, flow))
        print("profile " + json.dumps({
            "query": qname, "sequential_staged_wall_ms": staged_ms,
            "stages_ms": stages, "sequential_cprofile_wall_ms": host_ms,
            "host_cum_ms": own, "host_self_ms": self_ms,
            "profiled_wall_ms": wall_ms, **busy}))


MESH_ARCH = "qwen1_5_0_5b"
MESH_BATCH, MESH_SEQ, MESH_STEPS = 8, 512, 2
#: (name, mesh shape (data, model), TrainConfig fields) on four cards and
#: on two or three
MESHES_4 = [("data4", (4, 1), {}),
            ("data4_zero1", (4, 1), {"zero1": True}),
            ("data4_fsdp", (4, 1), {"fsdp": True}),
            ("2x2", (2, 2), {}),
            ("2x2_no_seq_parallel", (2, 2), {"seq_parallel": False}),
            ("2x2_compress_grads", (2, 2), {"compress_grads": True})]
MESHES_2 = [("data2", (2, 1), {}), ("model2", (1, 2), {})]
#: compressed_psum's payload a rank, and its bound against numpy: the
#: mean's order of sums
PSUM_N, PSUM_RTOL = 1 << 20, 1e-6
MESH_TIMEOUT_S = 750


def _mesh_tc(kw):
    from repro_torch.ml.model import TrainConfig
    return TrainConfig(lr=1e-3, warmup=1, total_steps=MESH_STEPS + 2,
                       loss_chunk=None, remat="full", **kw)


def _local_bytes(tree):
    from repro_torch.ml.optim import tree_leaves
    return sum(t.to_local().numel() * t.element_size()
               for t in tree_leaves(tree))


def _placed_as(tree, specs, mesh):
    from repro_torch.ml import sharding as sh
    from repro_torch.ml.optim import tree_leaves
    return all(t.placements == sh.placements(s, mesh) for t, s in
               zip(tree_leaves(tree), (s for _, s in sh.leaf_items(specs))))


def _nccl_busy(torch, prof, wall_ms):
    """This rank's card over a profiler window: busy ms (the union of its
    device records), idle share and the share of the summed device time
    in NCCL kernels."""
    from torch.autograd import DeviceType
    total = nccl = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        total += ms
        if "nccl" in e.key.lower():
            nccl += ms
    busy = sum(_device_ms(prof).values())
    if busy == 0.0 or total == 0.0:
        return {"busy_ms": "not measured", "idle_share": "not measured",
                "nccl_share": "not measured"}
    return {"busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "nccl_share": nccl / total}


def _one_device(torch, cfg, tc, batch):
    """The one-device step on this process's card (card 0): first-step
    gradients, params after each step (on the host), metrics, step ms,
    peak bytes."""
    from repro_torch.ml.model import ModelBundle
    from repro_torch.ml.optim import tree_leaves
    mb = ModelBundle(cfg, train_cfg=tc, device="cuda")
    params = mb.init_params(0)
    grads = [g.cpu() for g in tree_leaves(mb.loss_and_grads(params,
                                                            batch)[3])]
    opt, kept, metrics, ms = mb.init_opt_state(params), [], [], []
    step = mb.make_train_step()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        kept.append([t.cpu() for t in tree_leaves(params)])
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    del params, opt
    torch.cuda.empty_cache()
    return {"grads": grads, "p1": kept[0], "pn": kept[-1],
            "metrics": metrics, "ms": ms, "peak": peak}


def _mesh_run(torch, dist, cfg, mesh, name, kw, batch, ref):
    """One mesh layout: placement and bytes, the first step's gradients
    and two steps against the one-device run ``ref`` (rank 0 holds it),
    step times, peak bytes, and one profiled step."""
    from repro_torch.launch.elastic import per_device_bytes, reshard_plan
    from repro_torch.ml import sharding as sh
    from repro_torch.ml.model import ModelBundle
    from repro_torch.ml.optim import tree_leaves
    lead = dist.get_rank() == 0
    mb = ModelBundle(cfg, mesh, train_cfg=_mesh_tc(kw))
    p = mb.init_params(0)
    params = mb.shard_params(p)
    opt = mb.shard_opt_state(mb.init_opt_state(p))
    del p
    torch.cuda.empty_cache()
    shapes = mb.params_shape()
    pspec, ospec = mb.param_specs(shapes), mb.opt_specs(shapes)
    m_shapes = sh.map_with_path(lambda _, t: torch.empty(
        t.shape, dtype=torch.float32, device="meta"), shapes)
    n_moments = 3 if kw.get("compress_grads") else 2
    row = {"mesh": name, "shape": list(mesh.mesh.shape), **kw,
           "param_bytes": _local_bytes(params),
           "want_param_bytes": reshard_plan(mb, mb)[
               "param_bytes_per_device_before"],
           "opt_bytes": _local_bytes(opt),
           "want_opt_bytes": n_moments * per_device_bytes(m_shapes, ospec,
                                                          mesh) + 4,
           "params_placed": _placed_as(params, pspec, mesh),
           "moments_placed": _placed_as(opt["adam"]["m"], ospec, mesh)}
    sbatch = mb.shard_batch(batch)
    grads = tree_leaves(mb.loss_and_grads(params, sbatch)[3])
    g_rel = 0.0
    for i, g in enumerate(grads):
        full = g.full_tensor()
        if lead:
            want = ref["grads"][i]
            g_rel = max(g_rel, float((full.cpu() - want).abs().max()
                                     / (want.abs().max() + 1e-30)))
    del grads, full
    torch.cuda.empty_cache()
    step = mb.make_train_step()
    torch.cuda.reset_peak_memory_stats()
    ms, metrics, sig_n, sig_err, last = [], [], 0, 0.0, 0.0
    clip = min(1.0, 1.0 / ref["metrics"][0]["grad_norm"]) if lead else 1.0
    for i in range(MESH_STEPS):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, sbatch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        for j, t in enumerate(tree_leaves(params)):
            full = t.full_tensor()
            if not lead:
                continue
            got = full.cpu()
            if i == 0:      # the STEP_SIGNAL rule, as phase 3g
                g = ref["grads"][j].abs()
                sig = (g >= STEP_SIGNAL * g.max()) & (g * clip >= 1e-6)
                if bool(sig.any()):
                    sig_n += int(sig.sum())
                    sig_err = max(sig_err, float(
                        (got - ref["p1"][j]).abs()[sig].max()))
            else:
                last = max(last, float((got - ref["pn"][j]).abs().max()))
        del full
    peak = torch.cuda.max_memory_allocated()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    dist.barrier()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(params, opt, sbatch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # one more step for phase 3k: its collectives (rank 0) and its peak
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.dryrun import collective_kind
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    comm = CommDebugMode()
    with comm:
        stepped = step(params, opt, sbatch)
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated()
    del stepped
    counts = {}
    for op, n in comm.get_comm_counts().items():
        kind = collective_kind(op)
        if kind is not None and n:
            counts[kind] = counts.get(kind, 0) + n
    row.update(comm_counts=counts, batch_bytes=_local_bytes(sbatch))
    card = {"card": torch.cuda.current_device(), "peak_bytes": peak,
            "dryrun_peak_bytes": step_peak,
            "profiled_step_ms": wall, **_nccl_busy(torch, prof, wall)}
    del prof, params, opt, sbatch
    torch.cuda.empty_cache()
    row.update(step_ms=ms, metrics=metrics, grad_max_rel=g_rel,
               signal_params=sig_n, signal_max_abs=sig_err,
               last_param_max_abs=last, cards=card)
    return row


def _psum_check(torch, np, dist, mesh):
    """``compressed_psum`` over the mesh's data dim on NCCL against the
    numpy mean of the group's dequantized int8 payloads."""
    from repro_torch.ml.optim import compressed_psum
    x = np.random.default_rng(100 + dist.get_rank()).normal(
        size=PSUM_N).astype(np.float32)
    group = mesh["data"]
    got = compressed_psum(torch.from_numpy(x).cuda(), group).cpu().numpy()
    ranks = dist.get_process_group_ranks(group.get_group())
    xs = [None] * dist.get_world_size()
    dist.all_gather_object(xs, x)
    deq = []
    for r in ranks:
        scale = np.maximum(np.abs(xs[r]).max(), np.float32(1e-12)) \
            / np.float32(127.0)
        q = np.clip(np.round(xs[r] / scale), -127, 127).astype(np.int8)
        deq.append(q.astype(np.float32) * scale)
    want = np.mean(np.stack(deq), axis=0, dtype=np.float32)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    return {"ranks": ranks, "n": PSUM_N, "max_rel": err,
            "wire_bytes_int8": len(ranks) * (PSUM_N + 4),
            "wire_bytes_fp32_ring": 2 * PSUM_N * 4}


def _elastic_check(torch, dist, cfg, mesh_a, mesh_b, ckpt):
    """``train_loop(mesh=)`` on mesh A saves at step 2; the checkpoint
    restores onto mesh B bit for bit, placed as B's specs say; a resume
    on B runs steps 2–3."""
    import numpy as np
    from repro_torch.ckpt.checkpoint import restore_checkpoint
    from repro_torch.launch.train import train_loop
    from repro_torch.ml.model import ModelBundle, TrainConfig
    from repro_torch.ml.optim import tree_leaves
    lead = dist.get_rank() == 0
    kw = dict(reduced=False, batch=MESH_BATCH, seq=MESH_SEQ, ckpt_dir=ckpt,
              log_every=1, device="cuda")
    t0 = time.perf_counter()
    lines_a, lines_b = [], []
    params, opt, first = train_loop(cfg, steps=2, ckpt_every=2, mesh=mesh_a,
                                    print_fn=lines_a.append, **kw)
    saved = []
    for t in tree_leaves({"params": params, "opt": opt}):
        full = t.full_tensor()
        if lead:
            saved.append(full.cpu())
    del full
    seconds_a = time.perf_counter() - t0
    b = ModelBundle(cfg, mesh_b, train_cfg=TrainConfig(remat="full"))
    template = {"params": params, "opt": opt,
                "data": {"seed": np.int64(0), "step": np.int64(0)},
                "step": np.int64(0)}
    t0 = time.perf_counter()
    got, step = restore_checkpoint(ckpt, template, shardings={
        "params": b.param_shardings(), "opt": b.opt_state_shardings(),
        "data": None, "step": None})
    restore_s = time.perf_counter() - t0
    del params, opt
    shapes = b.params_shape()
    equal = True
    for i, t in enumerate(tree_leaves({"params": got["params"],
                                       "opt": got["opt"]})):
        full = t.full_tensor()
        if lead:
            equal = equal and torch.equal(full.cpu(), saved[i])
    placed = _placed_as(got["params"], b.param_specs(shapes), mesh_b) and \
        _placed_as(got["opt"]["adam"]["m"], b.opt_specs(shapes), mesh_b)
    del got, full, saved
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params, opt, again = train_loop(cfg, steps=4, ckpt_every=1000,
                                    mesh=mesh_b, resume=True,
                                    print_fn=lines_b.append, **kw)
    placed_b = _placed_as(params, b.param_specs(shapes), mesh_b)
    del params, opt
    torch.cuda.empty_cache()
    return {"from": list(mesh_a.mesh.shape), "to": list(mesh_b.mesh.shape),
            "saved_step": step, "bit_equal": equal, "placed": placed,
            "first": first, "again": again, "lines": lines_a + lines_b,
            "resumed_params_placed": placed_b, "run_a_s": seconds_a,
            "restore_s": restore_s,
            "resume_run_s": time.perf_counter() - t0}


def mesh_worker_main(out_dir: str) -> int:
    """``--mesh-worker OUT_DIR``: one rank of phase 3i, started by
    ``torch.distributed.run`` (one process a card, NCCL).  Rank 0 writes
    every rank's results to ``OUT_DIR/mesh.json``."""
    import os
    from dataclasses import replace
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    local = int(os.environ["LOCAL_RANK"])
    torch.cuda.set_device(local)
    dist.init_process_group("nccl")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_local_mesh
    t_phase = time.perf_counter()
    rank, world = dist.get_rank(), dist.get_world_size()
    _build.reset_kernel_launches()
    cfg = replace(get_config(MESH_ARCH), act_dtype="float32")
    pipe = TokenPipeline(cfg.vocab_size, MESH_BATCH, MESH_SEQ)
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(pipe).items()}
    pipe.close()
    layouts = MESHES_4 if world >= 4 else MESHES_2
    meshes, refs, rows = {}, {}, []
    for name, shape, kw in layouts:
        if shape not in meshes:
            meshes[shape] = make_local_mesh(*shape)
        key = bool(kw.get("compress_grads"))
        if key not in refs:
            refs[key] = _one_device(torch, cfg, _mesh_tc(
                {"compress_grads": key}), batch) if rank == 0 else None
            dist.barrier()
        rows.append(_mesh_run(torch, dist, cfg, meshes[shape], name, kw,
                              batch, refs[key]))
    cards = [None] * world
    dist.all_gather_object(cards, [r.pop("cards") for r in rows])
    for i, row in enumerate(rows):
        row["cards"] = [c[i] for c in cards]
    res = {"world": world, "rows": rows,
           "one_device": {str(k): {"ms": v["ms"], "metrics": v["metrics"],
                                   "peak": v["peak"]}
                          for k, v in refs.items() if v is not None}}

    def dump(**more):
        """Rank 0 writes what is known so far (a later failure still
        leaves the mesh rows)."""
        res.update(more, seconds=time.perf_counter() - t_phase)
        if rank == 0:
            with open(os.path.join(out_dir, "mesh.json"), "w") as fh:
                json.dump(res, fh)

    dump()
    shapes = [s for _, s, _ in layouts]
    dump(psum=_psum_check(torch, np, dist, max(
        meshes.values(), key=lambda m: m["data"].size())))
    dump(elastic=_elastic_check(torch, dist, cfg, meshes[shapes[-1]],
                                meshes[shapes[0]],
                                os.path.join(out_dir, "ckpt")))
    launches = [None] * world
    dist.all_gather_object(launches, sum(_build.kernel_launches().values()))
    dump(launches=launches)
    dist.destroy_process_group()
    return 0


def _run_mesh_workers(torch, n_cards: int, flag: str, result: str,
                      timeout: int, what: str):
    """Start one worker a card (four, else two) with
    ``torch.distributed.run`` running this script with ``flag``, and
    return what rank 0 wrote to ``result``; a worker that fails fails the
    phase (what rank 0 wrote so far is printed first)."""
    import os
    import shutil
    import tempfile
    torch.cuda.empty_cache()        # card 0 is also rank 0's
    nproc = 4 if n_cards >= 4 else 2
    out = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    here = Path(__file__).resolve()
    env = dict(os.environ, PYTHONPATH=str(here.parent / "src"),
               OMP_NUM_THREADS="1")
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={nproc}", str(here), flag, out],
            env=env, capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            if os.path.exists(os.path.join(out, result)):
                with open(os.path.join(out, result)) as fh:
                    print(f"{what.replace(' ', '_')} partial " + fh.read())
            fail(f"{what}: the workers exited {proc.returncode}:\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
        with open(os.path.join(out, result)) as fh:
            return json.load(fh)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def mesh_phase(torch, n_cards: int):
    """Phase 3i: the ML meshes (module docstring)."""
    t0 = time.perf_counter()
    res = _run_mesh_workers(torch, n_cards, "--mesh-worker", "mesh.json",
                            MESH_TIMEOUT_S, "mesh")
    mesh_report(res, t0)
    return res


def mesh_report(res, t0) -> None:
    """Phase 3i's checks and ``mesh`` lines over rank 0's results."""
    smi = card_line()
    if any(res["launches"]):
        fail(f"mesh: kernels launched on the cards: {res['launches']}")
    for row in res["rows"]:
        ref = res["one_device"][str(bool(row.get("compress_grads")))]
        checks = {
            "loss": all(abs(a["loss"] - b["loss"]) <= STEP_LOSS_RTOL
                        * abs(b["loss"]) for a, b in
                        zip(row["metrics"], ref["metrics"])),
            "grad_norm": all(abs(a["grad_norm"] - b["grad_norm"])
                             <= STEP_GNORM_RTOL * b["grad_norm"]
                             for a, b in zip(row["metrics"],
                                             ref["metrics"])),
            "grads": row["grad_max_rel"] <= STEP_GRAD_REL,
            "first_update": row["signal_params"] > 0
            and row["signal_max_abs"] <= STEP_PARAM_ATOL,
            "last_params": row["last_param_max_abs"]
            <= 2 * sum(m["lr"] for m in ref["metrics"]),
            "placed": row["params_placed"] and row["moments_placed"],
            "param_bytes": row["param_bytes"] == row["want_param_bytes"],
            "opt_bytes": row["opt_bytes"] == row["want_opt_bytes"]}
        warm = row["step_ms"][-1]
        tokens = MESH_BATCH * MESH_SEQ
        line = {"mesh": row["mesh"], "shape": row["shape"],
                "arch": MESH_ARCH, "batch": [MESH_BATCH, MESH_SEQ],
                "warm_step_ms": warm, "tokens_per_s": tokens / warm * 1e3,
                "cold_step_ms": row["step_ms"][0],
                "one_device_warm_ms": ref["ms"][-1],
                "one_device_tokens_per_s": tokens / ref["ms"][-1] * 1e3,
                "one_device_peak_bytes": ref["peak"],
                "peak_bytes_per_card": [c["peak_bytes"]
                                        for c in row["cards"]],
                "busy_share": [c["busy_ms"] if c["busy_ms"] ==
                               "not measured" else 1 - c["idle_share"]
                               for c in row["cards"]],
                "nccl_share": [c["nccl_share"] for c in row["cards"]],
                "profiled_step_ms": [c["profiled_step_ms"]
                                     for c in row["cards"]],
                "param_bytes_per_card": row["param_bytes"],
                "opt_bytes_per_card": row["opt_bytes"],
                "loss": [m["loss"] for m in row["metrics"]],
                "one_device_loss": [m["loss"] for m in ref["metrics"]],
                "grad_max_rel": row["grad_max_rel"],
                "signal_max_abs": row["signal_max_abs"],
                "last_param_max_abs": row["last_param_max_abs"],
                "checks": checks, "card": smi}
        print("mesh " + json.dumps(line))
        if not all(checks.values()):
            fail(f"mesh {row['mesh']}: {checks}")
    psum = res["psum"]
    print("mesh " + json.dumps({"sub": "compressed_psum", **psum,
                                "bound_rel": PSUM_RTOL}))
    if not psum["max_rel"] <= PSUM_RTOL:
        fail(f"mesh compressed_psum: {psum}")
    el = res["elastic"]
    print("mesh " + json.dumps({"sub": "elastic_resume", **el}))
    again = [s for s, _ in el["again"]]
    if not (el["saved_step"] == 2 and el["bit_equal"] and el["placed"]
            and el["resumed_params_placed"] and again == [2, 3]
            and "resumed from step 2" in el["lines"]
            and all(math.isfinite(l) for _, l in el["again"])):
        fail(f"mesh elastic: {el}")
    print("mesh " + json.dumps({"sub": "phase", "cards": res["world"],
                                "worker_seconds": res["seconds"],
                                "seconds": time.perf_counter() - t0,
                                "kernel_launches": res["launches"]}))


# ------------------------------------------------------- 3j. mesh serve
#: phase 3j: (row, arch, mesh shape (data, model), layers — None for the
#: config's own — and whether card 0 holds it alone, for the comparison)
MESH_SERVE_4 = [
    ("smollm_360m", "smollm_360m", (1, 4), None, True),
    ("whisper_large_v3", "whisper_large_v3", (1, 4), None, True),
    ("jamba_v0_1_52b[8 of 32 layers]", "jamba_v0_1_52b", (1, 4), 8, True),
    ("jamba_v0_1_52b[8 of 32 layers]", "jamba_v0_1_52b", (2, 2), 8, True),
    # the headline: 52B, ~104 GB in bf16, on no card alone
    ("jamba_v0_1_52b", "jamba_v0_1_52b", (1, 4), None, False)]
MESH_SERVE_2 = [(n, a, (1, 2), layers, one)
                for n, a, _, layers, one in MESH_SERVE_4[:3]]
#: a mesh row's float32 prefill (dropless MoE, LM_CHECK_SHAPE) against card
#: 0's, the same weights: max |Δ logit| over the largest |logit|.  Its bf16
#: prefill of the first batch is held at LM_CHECK_REL, or at twice card 0's
#: own bf16 noise where that is larger (its bf16 prefill against the same
#: weights in float32, as tests/test_torch_lm.py holds bf16 against the
#: reference): the mesh sums its row-parallel products in bf16 across the
#: cards, and a rounding can move a token to another expert
MESH_F32_REL = 1e-3
#: decode steps in the profiled window (after the prefill)
MESH_PROFILE_STEPS = 3
MESH_SERVE_TIMEOUT_S = 600


def _serve_card(torch):
    """The device of this rank's pieces: its card."""
    return torch.device("cuda", torch.cuda.current_device())


def _serve_cfg(arch, layers):
    from dataclasses import replace
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return replace(cfg, num_layers=layers) if layers else cfg


def _f32_cfg(cfg):
    """Float32 activations (and weights) with dropless MoE, as the
    consistency checks run."""
    from dataclasses import replace
    out = replace(cfg, act_dtype="float32")
    if cfg.moe_experts:
        out = replace(out, moe_capacity_factor=float(cfg.moe_experts))
    return out


def _serve_traffic(torch, np, cfg, dev):
    """Phase 3e's traffic for ``cfg`` on ``dev``: the left-padded token
    batches of 4 (8 requests of 64-512 tokens: [4, 445] and [4, 202]; or
    Whisper's 4 prompts of 4-224 tokens) and Whisper's frames (else
    None), from the seeds phase 3e uses; and the float32 check's tokens
    (LM_CHECK_SHAPE) and frames."""
    rng = np.random.default_rng(0)
    frames = None
    if cfg.encoder_layers:
        b, se = WHISPER_FRAMES
        gen = torch.Generator(device=dev).manual_seed(0)
        frames = torch.randn((b, se, cfg.d_model), generator=gen,
                             device=dev).to(torch.bfloat16)
        lens = rng.integers(WHISPER_PROMPT_LENS[0],
                            WHISPER_PROMPT_LENS[1] + 1, b)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in lens]
    else:
        lens = rng.integers(LM_PROMPT_LENS[0], LM_PROMPT_LENS[1] + 1,
                            LM_REQUESTS)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in lens]
    batches = [torch.from_numpy(_pad_left(np, prompts[i:i + LM_MAX_BATCH]))
               .to(dev) for i in range(0, len(prompts), LM_MAX_BATCH)]
    check = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, LM_CHECK_SHAPE).astype(np.int32)).to(dev)
    check_kw = {} if frames is None else \
        {"frames": frames[:LM_CHECK_SHAPE[0]]}
    return batches, frames, check, check_kw


def _to_dtype(tree, dtype):
    """Every leaf of ``tree`` cast to ``dtype`` in place, one at a time
    (each old leaf freed before the next is cast)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _to_dtype(v, dtype)
        else:
            tree[k] = v.to(dtype)
    return tree


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _serve_refs(torch, np, rows, dev):
    """Card 0's one-card prefills of each row's configuration that one
    card holds, logits on the host: the bf16 prefill of the first batch;
    then the same weights cast to float32 (as the mesh's float32 check
    casts them), through the dropless float32 configuration
    (:func:`_f32_cfg`) at LM_CHECK_SHAPE and through the served
    configuration in float32 activations on the first batch — the bf16
    prefill's own distance from the latter is its noise floor.  Every
    model is freed before the next."""
    from dataclasses import replace
    from repro_torch.ml.transformer import LM
    refs = {}
    for name, arch, _, layers, one_card in rows:
        if not one_card or name in refs:
            continue
        cfg = _serve_cfg(arch, layers)
        batches, frames, check, check_kw = _serve_traffic(torch, np, cfg,
                                                          dev)
        kw = {} if frames is None else {"frames": frames}
        torch.cuda.reset_peak_memory_stats()
        params = LM(cfg).init(0, dev)
        with torch.no_grad():
            bf16 = LM(cfg).prefill(params, batches[0], **kw)[0].float().cpu()
            _to_dtype(params, torch.float32)
            f32 = LM(_f32_cfg(cfg)).prefill(params, check,
                                            **check_kw)[0].cpu()
            same = LM(replace(cfg, act_dtype="float32")).prefill(
                params, batches[0], **kw)[0].cpu()
        del params
        torch.cuda.empty_cache()
        refs[name] = {"bf16": bf16, "f32": f32,
                      "bf16_noise": _rel(bf16, same),
                      "peak_bytes": torch.cuda.max_memory_allocated()}
    return refs


def _local_params(torch, mb, specs, dev, inits):
    """``mb``'s parameters without the whole tree on any rank at once:
    each ``(lm, seed)`` of ``inits`` initialised in turn, each leaf cut
    locally by ``specs`` (``mb.param_specs()``; no collective: every rank
    made the same numbers) and freed as it is cut; the inits' block
    pieces stacked along the group dim, which no rule cuts, into DTensors
    (``DTensor.from_local``).  The leaves outside the blocks (embedding,
    head, final norm) come from the first init."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.ml import sharding as sh
    mesh = mb.mesh
    specs = {path: sh.placements(spec, mesh)
             for path, spec in sh.leaf_items(specs)}
    pieces, tree = {}, {}

    def cut(path, t):
        """This rank's piece of ``t``, a copy (a piece may be a view that
        would keep the whole init alive)."""
        return distribute_tensor(t, mesh, specs[path],
                                 src_data_rank=None).to_local().clone()

    for i, (lm, seed) in enumerate(inits):
        init = lm.init(seed, dev)
        for path, _ in list(sh.leaf_items(init)):
            node = init
            for k in path[:-1]:
                node = node[k]
            t = node.pop(path[-1])
            if path[0] == "blocks":
                if any(p.is_shard(0) for p in specs[path]):
                    fail(f"mesh serve: {path} is cut along its group dim")
                pieces.setdefault(path, []).append(cut(path, t))
            elif i == 0:
                tree[path] = DTensor.from_local(cut(path, t), mesh,
                                                specs[path], run_check=False)
            del t
        del init
        torch.cuda.empty_cache()
    for path, parts in pieces.items():     # the rules cut evenly
        tree[path] = DTensor.from_local(torch.cat(parts, dim=0), mesh,
                                        specs[path], run_check=False)
        parts.clear()
    out: dict = {}
    for path in specs:          # the tree's own order
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = tree[path]
    return out


def _serve_params(torch, mb, cfg, dev, one_card, specs):
    """``mb``'s bf16 parameters on the mesh: for a row card 0 holds alone
    the whole init on each card, then ``shard_params``; for the full
    depth, which no card holds, one block cycle's init a group (seeds 0,
    1, …) cut locally (:func:`_local_params`)."""
    from dataclasses import replace
    from repro_torch.ml.transformer import LM, cycle_len
    if one_card:
        params = mb.shard_params(LM(cfg).init(0, dev))
        torch.cuda.empty_cache()
        return params
    cycle = LM(replace(cfg, num_layers=cycle_len(cfg)))
    return _local_params(torch, mb, specs, dev,
                         [(cycle, seed) for seed in range(mb.lm.groups)])


def _generate(torch, mb, params, toks, frames, steps=LM_MAX_NEW - 1):
    """One prefill of ``toks`` and ``steps`` greedy decode steps through
    ``mb``'s steps → (tokens [B, steps + 1] on the host, prefill ms,
    decode ms a step, the prefill's logits and its caches)."""
    from repro_torch.ml.model import _full
    batch = {"tokens": toks}
    if frames is not None:
        batch["frames"] = frames
    prefill, step = mb.make_prefill(), mb.make_decode_step()
    s = toks.shape[1]
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(params, mb.shard_batch(batch))
        cur = torch.argmax(_full(logits), dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = [cur.cpu()]
        first = caches
        for t in range(steps):
            nxt, caches = step(params, caches, mb.shard_batch(
                {"tokens": cur})["tokens"], s + t)
            cur = _full(nxt)
            out.append(cur.cpu())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return (torch.cat(out, dim=1), (t1 - t0) * 1e3,
            (t2 - t1) * 1e3 / max(steps, 1), logits, first)


def _mesh_serve_row(torch, np, dist, row, mesh, dev, ref):
    """One row of phase 3j on ``mesh``: the traffic through
    ``ModelBundle(cfg, mesh, impl="kernel")`` (counted launches on this
    card, cold and warm times, a profiled window), the caches' and
    parameters' placements and bytes, and the checks: against card 0's
    prefills (``ref``, rank 0) or, for a row no card holds alone,
    prefill↔decode consistency on the mesh in float32."""
    from repro_torch.kernels import _build
    from repro_torch.launch.elastic import per_device_bytes
    from repro_torch.ml import sharding as sh
    from repro_torch.ml.model import ModelBundle, _full
    from repro_torch.ml.optim import tree_leaves
    from torch.distributed.tensor.experimental import implicit_replication
    name, arch, shape, layers, one_card = row
    lead = dist.get_rank() == 0
    cfg = _serve_cfg(arch, layers)
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_row = time.perf_counter()
    mb = ModelBundle(cfg, mesh, impl="kernel")
    specs = mb.param_specs()
    dist.barrier()
    t0 = time.perf_counter()
    params = _serve_params(torch, mb, cfg, dev, one_card, specs)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = {"row": name, "mesh": list(shape), "layers": cfg.num_layers,
           "attention_layers": kinds.count("attn"),
           "mamba_layers": kinds.count("mamba"),
           "encoder_layers": cfg.encoder_layers,
           "one_card_reference": one_card, "init_s": init_s,
           "params_placed": _placed_as(params, specs, mesh),
           "want_param_bytes": per_device_bytes(params, specs, mesh)}
    card = {"card": dev.index, "param_bytes": _local_bytes(params)}
    batches, frames, check, check_kw = _serve_traffic(torch, np, cfg, dev)
    b = batches[0].shape[0]
    need = {"flash_attention": len(batches) * (
                kinds.count("attn") * (2 if cfg.encoder_layers else 1)
                + cfg.encoder_layers),
            "selective_scan": kinds.count("mamba") * len(batches)}
    # the counted run: every batch's prefill and 15 greedy decode steps
    _build.reset_kernel_launches()
    dist.barrier()
    t0 = time.perf_counter()
    prefill_ms, decode_ms, tokens_ok = [], [], True
    for i, toks in enumerate(batches):
        got, pms, dms, logits, caches = _generate(torch, mb, params, toks,
                                                  frames)
        prefill_ms.append(pms)
        decode_ms.append(dms)
        tokens_ok = tokens_ok and got.shape == (b, LM_MAX_NEW) and bool(
            ((got >= 0) & (got < cfg.vocab_size)).all())
        if i == 0:
            bf16 = _full(logits).float().cpu()
            want = mb.cache_shardings(caches)
            out["caches_placed"] = all(
                leaf.placements == w[1] for leaf, (_, w) in
                zip(tree_leaves(caches), sh.leaf_items(want)))
        del logits, caches
    serve_ms = (time.perf_counter() - t0) * 1e3
    card["launches"] = _build.kernel_launches(device=dev)
    out.update(need=need, tokens_ok=tokens_ok, serve_ms=serve_ms,
               serve_tokens_per_s=len(batches) * b * LM_MAX_NEW
               / serve_ms * 1e3, prefill_ms=prefill_ms,
               batches=[list(t.shape) for t in batches],
               decode_ms_per_step=decode_ms)
    # warm: the first batch again, then a profiled window
    dist.barrier()
    _, pms, dms, _, _ = _generate(torch, mb, params, batches[0], frames)
    out.update(warm_prefill_ms=pms, warm_decode_ms_per_step=dms,
               warm_tokens_per_s=b * LM_MAX_NEW
               / (pms + (LM_MAX_NEW - 1) * dms) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    dist.barrier()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _generate(torch, mb, params, batches[0], frames,
                  steps=MESH_PROFILE_STEPS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    card.update(profiled_ms=wall, **_nccl_busy(torch, prof, wall),
                peak_bytes=torch.cuda.max_memory_allocated())
    del prof
    torch.cuda.empty_cache()
    # the float32 check, on the same weights cast in place
    torch.cuda.reset_peak_memory_stats()
    _to_dtype(params, torch.float32)
    mb32 = ModelBundle(_f32_cfg(cfg), mesh, impl="kernel")
    prefill = mb32.make_prefill()
    batch = {"tokens": check, **check_kw}
    with torch.no_grad():
        f32 = _full(prefill(params, mb32.shard_batch(batch))[0]).cpu()
        if not one_card:    # decode at S-1 after a prefill of S-1 tokens
            n = check.shape[1]
            _, caches = prefill(params, mb32.shard_batch(
                {"tokens": check[:, :-1], **check_kw}))
            last = mb32.shard_batch({"tokens": check[:, -1:]})["tokens"]
            with sh.using_mesh(mesh), implicit_replication():
                got, _ = mb32.lm.decode_step(params, last, caches, n - 1)
            got = _full(got).cpu()
            del caches
    card["f32_peak_bytes"] = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    out["f32_weights"] = "the served bf16 weights cast to float32"
    if lead and one_card:
        out["bf16_vs_card0"] = {
            "rel_err": _rel(bf16, ref["bf16"]),
            "card0_bf16_noise": ref["bf16_noise"],
            "bound": max(LM_CHECK_REL, 2 * ref["bf16_noise"])}
        out["f32_vs_card0"] = {
            "shape": list(LM_CHECK_SHAPE), "rel_err": _rel(f32, ref["f32"]),
            "bound": MESH_F32_REL, "argmax_equal": bool(torch.equal(
                f32.argmax(-1), ref["f32"].argmax(-1))),
            "card0_peak_bytes": ref["peak_bytes"]}
    elif lead:
        out["consistency_f32"] = {
            "shape": list(LM_CHECK_SHAPE), "rel_err": _rel(got, f32),
            "bound": LM_CHECK_REL, "argmax_equal": bool(torch.equal(
                got.argmax(-1), f32.argmax(-1)))}
    cards = [None] * dist.get_world_size()
    dist.all_gather_object(cards, card)
    out["cards"] = cards
    out["seconds"] = time.perf_counter() - t_row
    return out


def mesh_serve_worker_main(out_dir: str) -> int:
    """``--mesh-serve-worker OUT_DIR``: one rank of phase 3j, started by
    ``torch.distributed.run`` (one process a card, NCCL).  Rank 0 runs
    card 0's one-card references first and frees them; then every row;
    rank 0 writes the rows to ``OUT_DIR/mesh_serve.json`` after each."""
    import os
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import make_local_mesh
    t_phase = time.perf_counter()
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = _serve_card(torch)
    rows = MESH_SERVE_4 if world >= 4 else MESH_SERVE_2
    t0 = time.perf_counter()
    refs = _serve_refs(torch, np, rows, dev) if rank == 0 else None
    res = {"world": world, "rows": [],
           "references_s": time.perf_counter() - t0}
    dist.barrier()
    meshes = {}
    for row in rows:
        if row[2] not in meshes:
            meshes[row[2]] = make_local_mesh(*row[2])
        res["rows"].append(_mesh_serve_row(
            torch, np, dist, row, meshes[row[2]], dev,
            refs.get(row[0]) if refs else None))
        res["seconds"] = time.perf_counter() - t_phase
        if rank == 0:
            with open(os.path.join(out_dir, "mesh_serve.json"), "w") as fh:
                json.dump(res, fh)
    dist.destroy_process_group()
    return 0


def mesh_serve_phase(torch, n_cards: int):
    """Phase 3j: serving through the kernels on a mesh (module
    docstring)."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()        # once, here, not in each worker
    res = _run_mesh_workers(torch, n_cards, "--mesh-serve-worker",
                            "mesh_serve.json", MESH_SERVE_TIMEOUT_S,
                            "mesh serve")
    mesh_serve_report(res, t0)
    return res


def mesh_serve_report(res, t0) -> None:
    """Phase 3j's checks and ``mesh_serve`` lines over rank 0's rows."""
    smi = card_line()
    for row in res["rows"]:
        cards = row["cards"]
        checks = {
            "tokens": row["tokens_ok"],
            "launches": all(c["launches"] == {k: n for k, n in
                                              row["need"].items() if n}
                            for c in cards),
            "caches_placed": row["caches_placed"],
            "params_placed": row["params_placed"],
            "param_bytes": all(c["param_bytes"] == row["want_param_bytes"]
                               for c in cards)}
        if row["one_card_reference"]:
            b, f = row["bf16_vs_card0"], row["f32_vs_card0"]
            checks["bf16_vs_card0"] = math.isfinite(b["rel_err"]) \
                and b["rel_err"] <= b["bound"]
            checks["f32_vs_card0"] = math.isfinite(f["rel_err"]) \
                and f["rel_err"] <= f["bound"] and f["argmax_equal"]
        else:
            c = row["consistency_f32"]
            checks["consistency_f32"] = math.isfinite(c["rel_err"]) \
                and c["rel_err"] < c["bound"] and c["argmax_equal"]
        line = {k: v for k, v in row.items() if k != "cards"}
        line.update(
            peak_bytes_per_card=[c["peak_bytes"] for c in cards],
            f32_peak_bytes_per_card=[c["f32_peak_bytes"] for c in cards],
            param_bytes_per_card=[c["param_bytes"] for c in cards],
            launches_per_card=[c["launches"] for c in cards],
            busy_share=[c["busy_ms"] if c["busy_ms"] == "not measured"
                        else 1 - c["idle_share"] for c in cards],
            idle_share=[c["idle_share"] for c in cards],
            nccl_share=[c["nccl_share"] for c in cards],
            profiled_window=f"prefill + {MESH_PROFILE_STEPS} decode steps",
            profiled_ms=[c["profiled_ms"] for c in cards],
            checks=checks, card=smi)
        print("mesh_serve " + json.dumps(line))
        if not all(checks.values()):
            fail(f"mesh serve {row['row']} on {row['mesh']}: {checks}")
    print("mesh_serve " + json.dumps({
        "sub": "phase", "cards": res["world"],
        "references_s": res["references_s"],
        "worker_seconds": res["seconds"],
        "seconds": time.perf_counter() - t0}))


# ----------------------------------------------------------- 3k. dryrun
#: phase 3k: phase 3g's SmolLM-360M train step (float32 params and moments,
#: bf16 activations, LM_TRAIN's batch, remat full, the full logits) dry-run
#: on one device and run on the card; the predicted peak is held within
#: DRYRUN_PEAK_REL of the measured one or DRYRUN_PEAK_ABS, whichever is
#: larger
DRYRUN_ARCH = "smollm_360m"
DRYRUN_PEAK_REL, DRYRUN_PEAK_ABS = 0.15, 1 << 30
#: a production cell through the CLI (torch 2.11 on the card's host)
DRYRUN_CELL = ("qwen1_5_0_5b", "train_4k", "false")
DRYRUN_TIMEOUT_S = 600
#: 3j's full-depth row, dry-run for its parameter bytes a card
DRYRUN_SERVE_ROW = ("jamba_v0_1_52b", (1, 4), (4, 445))


def _dryrun_tc():
    from repro_torch.ml.model import TrainConfig
    return TrainConfig(lr=1e-3, loss_chunk=None, remat="full")


def _run_json(argv, out_path, timeout, what):
    """Run ``argv`` (``PYTHONPATH=src``) and return the JSON it wrote to
    ``out_path``; a non-zero exit fails the phase."""
    import os
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    proc = subprocess.run(argv, env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        fail(f"{what}: exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-6000:]}")
    with open(out_path) as fh:
        return json.load(fh)


def dryrun_worker_main(out_path: str) -> int:
    """``--dryrun-worker OUT``: phase 3k's one-card part in a process of
    its own.  The dry-run of phase 3g's SmolLM-360M train step on fake
    tensors (no process group, no device touched), then the same step on
    the card from seeded params and tokens: one warm step, then one under
    the same counter on real tensors with the allocator's peak reset
    just before it."""
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import _build
    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.ml.model import ModelBundle
    cfg = get_config(DRYRUN_ARCH)
    b, s = LM_TRAIN["batch"], LM_TRAIN["seq"]
    mb = ModelBundle(cfg, train_cfg=_dryrun_tc(), device="cuda")
    low = mb.lower_train(ShapeConfig("lm_train", s, b, "train"))
    t0 = time.perf_counter()
    params = mb.init_params(0)
    opt = mb.init_opt_state(params)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32)).cuda()
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous()}
    step = mb.make_train_step()
    _build.reset_kernel_launches()
    params, opt, _ = step(params, opt, batch)           # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    counter = StepCounter()
    with counter:
        counter.hold((params, opt, batch))
        out = step(params, opt, batch)
        counter.finish(out)
    torch.cuda.synchronize()
    peak, after = torch.cuda.max_memory_allocated(), \
        torch.cuda.memory_allocated()
    with open(out_path, "w") as fh:
        json.dump({"predicted": low.memory, "flops": low.cost[
                       "flops_per_device"],
                   "bytes": low.cost["bytes_per_device"],
                   "dryrun_s": low.seconds,
                   "measured": {"argument_bytes": before,
                                "output_bytes": after - before,
                                "temp_bytes": peak - before,
                                "peak_bytes": peak},
                   "counted_real": counter.record()["memory"],
                   "flops_real": counter.flops,
                   "card_s": time.perf_counter() - t0,
                   "launches": sum(_build.kernel_launches().values())}, fh)
    return 0


def dryrun_mesh_worker_main(out_path: str) -> int:
    """``--dryrun-mesh-worker OUT``: phase 3k's four-card part on the host
    alone — each of phase 3i's four-card meshes dry-run on a fake 4-rank
    group (3i's config, train config and batch; an all-to-all counted as
    NCCL runs it), and 3j's full-depth Jamba prefill on 1 × 4 for its
    parameter bytes a card."""
    from dataclasses import replace
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.ml.model import ModelBundle
    from repro_torch.ml.optim import tree_leaves
    from torch._subclasses.fake_tensor import FakeTensorMode
    out = {"meshes": {}}
    cfg = replace(get_config(MESH_ARCH), act_dtype="float32")
    shape = ShapeConfig("mesh", MESH_SEQ, MESH_BATCH, "train")
    with fake_world(4):
        for name, mshape, kw in MESHES_4:
            mb = ModelBundle(cfg, make_local_mesh(*mshape, device="cpu"),
                             train_cfg=_mesh_tc(kw))
            low = mb.lower_train(shape)
            out["meshes"][name] = {"counts": low.counts,
                                   "memory": low.memory,
                                   "collectives": low.collectives,
                                   "seconds": low.seconds}
        arch, mshape, (b, s) = DRYRUN_SERVE_ROW
        mb = ModelBundle(_serve_cfg(arch, None),
                         make_local_mesh(*mshape, device="cpu"))
        serve = ShapeConfig("serve", s, b, "prefill")
        with FakeTensorMode():
            params, _ = mb.fake_args("prefill", serve)
            param_bytes = sum(t.to_local().numel() * t.element_size()
                              for t in tree_leaves(params))
        low = mb.lower_prefill(serve)
        out["serve"] = {"row": arch, "mesh": list(mshape),
                        "param_bytes": param_bytes, "memory": low.memory,
                        "counts": low.counts, "seconds": low.seconds}
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    return 0


def start_dryrun_mesh():
    """Start the four-card dry-runs on the host (they need no card) →
    (process, output path); :func:`dryrun_phase` collects them."""
    import os
    import tempfile
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"),
                       "mesh.json")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--dryrun-mesh-worker", out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, out


def _peak_ok(predicted, measured):
    return abs(predicted - measured) <= max(DRYRUN_PEAK_REL * measured,
                                            DRYRUN_PEAK_ABS)


def dryrun_phase(torch, n_cards: int, mesh_dry=None, mesh_res=None,
                 serve_res=None) -> None:
    """Phase 3k: the dry-run held to real steps (module docstring)."""
    import os
    import shutil
    import tempfile
    t0 = time.perf_counter()
    smi = card_line()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    try:
        here = str(Path(__file__).resolve())
        one = _run_json([sys.executable, here, "--dryrun-worker",
                         os.path.join(tmp, "one.json")],
                        os.path.join(tmp, "one.json"), DRYRUN_TIMEOUT_S,
                        "dryrun")
        pred, meas = one["predicted"], one["measured"]
        checks = {"flops": one["flops"] == one["flops_real"] > 0,
                  "peak": _peak_ok(pred["peak_bytes"], meas["peak_bytes"]),
                  "no_kernel": one["launches"] == 0}
        print("dryrun " + json.dumps({
            "sub": "one_card", "arch": DRYRUN_ARCH,
            "batch": [LM_TRAIN["batch"], LM_TRAIN["seq"]],
            "predicted": pred, "measured": meas,
            "counted_on_the_card": one["counted_real"],
            "flops": one["flops"], "flops_on_the_card": one["flops_real"],
            "bytes": one["bytes"], "dryrun_s": one["dryrun_s"],
            "card_s": one["card_s"],
            "peak_bound": {"rel": DRYRUN_PEAK_REL, "abs": DRYRUN_PEAK_ABS},
            "checks": checks, "card": smi}))
        if not all(checks.values()):
            fail(f"dryrun one card: {checks}")
        arch, shape, pod = DRYRUN_CELL
        out_dir = os.path.join(tmp, "cell")
        t1 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(Path(here).parent / "src"))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--multi_pod", pod, "--out_dir",
             out_dir], env=env, capture_output=True, text=True,
            timeout=DRYRUN_TIMEOUT_S)
        if proc.returncode != 0:
            fail(f"dryrun {arch} × {shape}: exited {proc.returncode}:\n"
                 f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        with open(os.path.join(out_dir, f"{arch}-{shape}-pod.json")) as fh:
            rec = json.load(fh)
        print("dryrun " + json.dumps({
            "sub": "cell", "arch": arch, "shape": shape, "mesh": rec["mesh"],
            "cli_s": time.perf_counter() - t1, "lower_s": rec["lower_s"],
            "memory": rec["memory"], "cost": rec["cost"],
            "collectives": rec["collectives"],
            "warnings": rec["analyzed"]["warnings"],
            "torch": torch.__version__}))
        if n_cards < 4 or mesh_dry is None:
            print("dryrun: phase 3k's four-card part did not run: it holds "
                  "the dry-run to phases 3i and 3j on four cards "
                  "(python3 chip_smoke.py --require-cards 4 on a host with "
                  "four)")
            return
        proc, path = mesh_dry
        _, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        if proc.returncode != 0:
            fail(f"dryrun meshes: exited {proc.returncode}:\n{err[-6000:]}")
        with open(path) as fh:
            dry = json.load(fh)
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
        _dryrun_mesh_report(dry, mesh_res, serve_res, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        print("dryrun " + json.dumps({"sub": "phase",
                                      "seconds": time.perf_counter() - t0}))


def _dryrun_mesh_report(dry, mesh_res, serve_res, smi) -> None:
    """Each 3i mesh's dry-run against rank 0's real NCCL step: the same
    collectives a kind, argument bytes = the local parameter, optimizer
    and batch bytes 3i holds, every card's peak within the bound; 3j's
    full-depth parameter bytes a card."""
    for row in mesh_res["rows"]:
        d = dry["meshes"][row["mesh"]]
        args = row["param_bytes"] + row["opt_bytes"] + row["batch_bytes"]
        peaks = [c["dryrun_peak_bytes"] for c in row["cards"]]
        checks = {
            "counts": d["counts"] == row["comm_counts"],
            "argument_bytes": d["memory"]["argument_bytes"] == args,
            "peaks": all(_peak_ok(d["memory"]["peak_bytes"], p)
                         for p in peaks)}
        print("dryrun " + json.dumps({
            "sub": "mesh", "mesh": row["mesh"], "shape": row["shape"],
            "counts": d["counts"], "counts_on_the_cards": row["comm_counts"],
            "argument_bytes": d["memory"]["argument_bytes"],
            "param_opt_batch_bytes": args,
            "predicted_peak_bytes": d["memory"]["peak_bytes"],
            "peak_bytes_per_card": peaks,
            "collective_bytes": d["collectives"]["total_bytes"],
            "dryrun_s": d["seconds"], "checks": checks, "card": smi}))
        if not all(checks.values()):
            fail(f"dryrun mesh {row['mesh']}: {checks}")
    srv = dry["serve"]
    row = next(r for r in serve_res["rows"]
               if r["row"] == srv["row"] and list(r["mesh"]) == srv["mesh"])
    measured = [c["param_bytes"] for c in row["cards"]]
    ok = all(m == srv["param_bytes"] for m in measured)
    print("dryrun " + json.dumps({
        "sub": "mesh_serve", "row": srv["row"], "mesh": srv["mesh"],
        "param_bytes": srv["param_bytes"],
        "param_bytes_per_card": measured,
        "predicted_peak_bytes": srv["memory"]["peak_bytes"],
        "peak_bytes_per_card": [c["peak_bytes"] for c in row["cards"]],
        "counts": srv["counts"], "dryrun_s": srv["seconds"],
        "checks": {"param_bytes": ok}, "card": smi}))
    if not ok:
        fail(f"dryrun mesh serve: {srv['param_bytes']} vs {measured}")


def launch_path_main(root: str) -> int:
    """``--launch-path ROOT``: build the kernels of the port under
    ``ROOT/src`` and print its ``launch_path`` line alone — run it once
    for each of two trees to compare their launch paths in one call."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import numpy as np
    from repro_torch.kernels import _build
    print(card_line())
    _build.build_all()
    print("launch_path " + json.dumps({"root": root,
                                       **launch_path(torch, np)}))
    return 0


def mesh_only_main() -> int:
    """``--mesh-only``: phase 1's card line and phases 3i, 3j and 3k alone
    (two cards or more)."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_smoke: --mesh-only needs two CUDA devices or more",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    print(card_line())
    n_cards = torch.cuda.device_count()
    mesh_dry = start_dryrun_mesh() if n_cards >= 4 else None
    mesh_res = mesh_phase(torch, n_cards)
    serve_res = mesh_serve_phase(torch, n_cards)
    dryrun_phase(torch, n_cards, mesh_dry, mesh_res, serve_res)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--launch-path"]:
        sys.exit(launch_path_main(sys.argv[2] if len(sys.argv) > 2 else "."))
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker_main(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-serve-worker"]:
        sys.exit(mesh_serve_worker_main(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-only"]:
        sys.exit(mesh_only_main())
    if sys.argv[1:2] == ["--dryrun-worker"]:
        sys.exit(dryrun_worker_main(sys.argv[2]))
    if sys.argv[1:2] == ["--dryrun-mesh-worker"]:
        sys.exit(dryrun_mesh_worker_main(sys.argv[2]))
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA "
                                 "port (see the module docstring).")
    ap.add_argument("--require-cards", type=int, default=1, metavar="N",
                    help="fail unless N or more CUDA devices are visible "
                    "(phase 3h runs with two or more)")
    sys.exit(main(ap.parse_args().require_cards))
