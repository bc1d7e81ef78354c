"""One rank of ``tests/test_torch_mesh.py``: the port's ML meshes on a
gloo process group of CPU processes.

    python tests/_torch_mesh_worker.py RANK WORLD INIT_FILE OUT_DIR [cuda]

Every rank runs the same checks in one process group (the collectives
need all of them); rank 0 writes their results to ``OUT_DIR/results.json``
and the test file asserts on them.  Nothing here imports jax or the JAX
package: the reference's numbers are computed by the test file.  With
``cuda`` (``tests/test_torch_cuda.py``, two cards or more) the ranks run
on NCCL, one card each, and only the train steps, ``compressed_psum`` and
the elastic restore run.
"""
import json
import os
import sys
import tempfile
import time
import traceback
from dataclasses import replace
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(SRC))

import torch                                          # noqa: E402
import torch.distributed as dist                      # noqa: E402

from repro_torch.configs import get_config            # noqa: E402
from repro_torch.launch import elastic                # noqa: E402
from repro_torch.launch.mesh import (local_mesh_shape,  # noqa: E402
                                     make_local_mesh, make_production_mesh)
from repro_torch.ml import sharding as sh             # noqa: E402
from repro_torch.ml import transformer as T           # noqa: E402
from repro_torch.ml.model import ModelBundle, TrainConfig  # noqa: E402
from repro_torch.ml.optim import compressed_psum, tree_leaves  # noqa: E402

#: local meshes asked for → the clamp on 4 ranks
LOCAL_ASKS = [(1, 1), (2, 2), (4, 1), (1, 4), (8, 1), (2, 8), (2, 1)]
#: (name, mesh, TrainConfig fields) of the train-step checks
STEPS = [("data4", (4, 1), {}),
         ("2x2", (2, 2), {}),
         ("zero1", (4, 1), {"zero1": True}),
         ("fsdp", (4, 1), {"fsdp": True}),
         ("fsdp_2x2", (2, 2), {"fsdp": True}),
         ("seq_parallel_off", (2, 2), {"seq_parallel": False}),
         ("compress_grads", (2, 2), {"compress_grads": True})]
BATCH, SEQ, STEP_COUNT = 8, 32, 2
PSUM_SHAPE = (8, 16)
#: where the ranks compute: "cpu" (gloo) or "cuda" (NCCL, one card each)
DEVICE = "cpu"
_MESHES = {}


def _mesh(data, model):
    """The (data, model) mesh of the ranks, made once."""
    if (data, model) not in _MESHES:
        _MESHES[data, model] = make_local_mesh(data, model, device=DEVICE)
    return _MESHES[data, model]


def _square():
    """2 × 2 on four ranks, 1 × 2 on two: the mesh with a model axis."""
    return (2, 2) if dist.get_world_size() >= 4 else (1, 2)


def _steps_for(world):
    if world >= 4:
        return STEPS
    return [("data2", (2, 1), {}), ("model2", (1, 2), {})]


def _cfg(arch, layers=None):
    cfg = replace(get_config(arch).reduced(), act_dtype="float32")
    return replace(cfg, num_layers=layers) if layers else cfg


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
                           .astype(np.int32))
    tok = tok.to(DEVICE)
    return {"tokens": tok, "labels": torch.roll(tok, -1, 1)}


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _local_bytes(tree):
    return sum(t.to_local().numel() * t.element_size()
               for t in tree_leaves(tree))


def _placed_as(tree, specs, mesh):
    """Every leaf of ``tree`` at the placements its spec gives."""
    return all(t.placements == sh.placements(s, mesh) for t, s in
               zip(tree_leaves(tree), (s for _, s in sh.leaf_items(specs))))


def _steps(mb, params, opt, batch, n):
    """``n`` train steps → (first step's params, last params, metrics)."""
    step = mb.make_train_step()
    kept, metrics = [], []
    for _ in range(n):
        params, opt, m = step(params, opt, batch)
        kept.append(params)
        metrics.append({k: float(v) for k, v in m.items()})
    return kept[0], kept[-1], metrics


def _step_record(one, mesh_run):
    """The mesh run against the one-device run: per-step metrics, the
    first step's gradients leaf by leaf (relative to each leaf's largest
    element) and the updated parameters, for the test file's bounds."""
    (p1, pn, m1, g1), (q1, qn, n1, h1) = one, mesh_run
    grad_rel = max(float((_full(a) - b).abs().max()
                         / (b.abs().max() + 1e-30))
                   for a, b in zip(h1, g1))
    # AdamW's first update is ±lr·(1 + ...) whatever |g|: elements whose
    # gradient is signal (≥ 4·2^-8 of the leaf's largest, 100·eps after
    # clipping) must move as on one device
    clip = min(1.0, 1.0 / m1[0]["grad_norm"])
    sig_n, sig_err = 0, 0.0
    for a, b, g in zip(q1, p1, g1):
        mag = g.abs()
        sig = (mag >= 4 * 2.0 ** -8 * mag.max()) & (mag * clip >= 1e-6)
        if bool(sig.any()):
            sig_n += int(sig.sum())
            sig_err = max(sig_err, float((_full(a) - b).abs()[sig].max()))
    last = max(float((_full(a) - b).abs().max()) for a, b in zip(qn, pn))
    return {"one": m1, "mesh": n1, "grad_max_rel": grad_rel,
            "signal_params": sig_n, "signal_max_abs": sig_err,
            "last_param_max_abs": last, "reach": 2 * sum(m["lr"] for m in m1)}


def check_local_meshes(res):
    got = {}
    for d, m in LOCAL_ASKS:
        mesh = make_local_mesh(d, m, device=DEVICE)
        got[f"{d}x{m}"] = [list(mesh.mesh.shape),
                           list(local_mesh_shape(d, m, 4)),
                           list(mesh.mesh_dim_names)]
    res["local_meshes"] = got
    try:
        make_production_mesh(device="cpu")
        res["production_raises"] = None
    except ValueError as e:
        res["production_raises"] = str(e)


def check_placements(res):
    """Placements and each rank's local bytes of a reduced Qwen and a
    reduced Jamba (EP experts, Mamba) under every layout."""
    out = {}
    for arch in ("qwen1_5_0_5b", "jamba_v0_1_52b"):
        cfg = _cfg(arch)
        for shape, kw in (((2, 2), {}), ((4, 1), {"zero1": True}),
                          ((2, 2), {"fsdp": True}),
                          ((2, 2), {"compress_grads": True})):
            mesh = _mesh(*shape)
            mb = ModelBundle(cfg, mesh, train_cfg=TrainConfig(**kw))
            p = mb.init_params(0)
            params = mb.shard_params(p)
            opt = mb.shard_opt_state(mb.init_opt_state(p))
            shapes = mb.params_shape()
            pspec, ospec = mb.param_specs(shapes), mb.opt_specs(shapes)
            want_p = elastic.per_device_bytes(shapes, pspec, mesh)
            want_m = elastic.per_device_bytes(
                tree_leaves_as_f32(shapes), ospec, mesh)
            n_moments = 3 if kw.get("compress_grads") else 2
            key = f"{arch}:{shape[0]}x{shape[1]}:{','.join(kw) or 'plain'}"
            row = {"params_placed": _placed_as(params, pspec, mesh),
                   "moments_placed": all(
                       _placed_as(opt["adam"][k], ospec, mesh)
                       for k in ("m", "v")),
                   "param_bytes": _local_bytes(params),
                   "want_param_bytes": want_p,
                   "opt_bytes": _local_bytes(opt),
                   "want_opt_bytes": n_moments * want_m + 4,
                   "plan_param_bytes": elastic.reshard_plan(mb, mb)[
                       "param_bytes_per_device_before"]}
            if arch == "jamba_v0_1_52b":
                moe = next(v["moe"] for v in params["blocks"].values()
                           if "moe" in v)
                row["experts_on_model"] = \
                    moe["experts"]["w_gate"].placements[1].is_shard(1)
                mamba = params["blocks"]["slot0"]["mamba"]
                row["mamba_inner_on_model"] = \
                    mamba["A_log"].placements[1].is_shard(1)
            gathered = [d for d in dist_all(row["param_bytes"])]
            row["every_rank_param_bytes"] = gathered
            out[key] = row
    res["placements"] = out


def tree_leaves_as_f32(shapes):
    """The moments' shapes: float32 whatever the parameter's dtype."""
    return sh.map_with_path(
        lambda _, t: torch.empty(t.shape, dtype=torch.float32,
                                 device="meta"), shapes)


def dist_all(x):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x)
    return out


def check_steps(res):
    """Two train steps on every mesh layout against the one-device step
    from the same parameters and batch; the sequence-parallel pins are
    counted."""
    cfg = _cfg("qwen1_5_0_5b")
    batch = _batch(cfg)
    pins = {"n": 0}
    real = T.constrain

    def counting(x, dims):
        if sh.active_mesh() is not None and hasattr(x, "placements"):
            pins["n"] += 1
        return real(x, dims)

    T.constrain = counting
    refs = {}
    out = {}
    try:
        for name, shape, kw in _steps_for(dist.get_world_size()):
            tc = TrainConfig(remat="none", loss_chunk=None, warmup=1,
                             total_steps=4, **kw)
            ref_key = bool(kw.get("compress_grads"))
            if ref_key not in refs:
                one = ModelBundle(cfg, train_cfg=tc, device=DEVICE)
                p0 = one.init_params(0)
                g1 = tree_leaves(one.loss_and_grads(p0, batch)[3])
                p1, pn, m1 = _steps(one, p0, one.init_opt_state(p0), batch,
                                    STEP_COUNT)
                refs[ref_key] = ([t for t in tree_leaves(p1)],
                                 [t for t in tree_leaves(pn)], m1, g1)
            mesh = _mesh(*shape)
            mb = ModelBundle(cfg, mesh, train_cfg=tc)
            p = mb.init_params(0)
            params = mb.shard_params(p)
            opt = mb.shard_opt_state(mb.init_opt_state(p))
            db = mb.shard_batch(batch)
            h1 = tree_leaves(mb.loss_and_grads(params, db)[3])
            pins["n"] = 0
            t0 = time.perf_counter()
            q1, qn, n1 = _steps(mb, params, opt, db, STEP_COUNT)
            row = _step_record(refs[ref_key],
                               (tree_leaves(q1), tree_leaves(qn), n1, h1))
            row["seconds"] = time.perf_counter() - t0
            row["seq_pins"] = pins["n"]
            shapes = mb.params_shape()
            row["params_placed"] = _placed_as(qn, mb.param_specs(shapes),
                                              mesh)
            out[name] = row
    finally:
        T.constrain = real
    res["steps"] = out


def check_jamba_step(res):
    """Loss and gradients of a reduced Jamba cut to one block cycle (7
    Mamba + 1 attention, MoE on odd layers, 4 experts: EP on 2×2) on the
    mesh against one device: as the model is, and with the Mamba chunk
    inputs staged in float32 (``mamba.STAGE_DTYPE``) instead of bf16."""
    from repro_torch.ml import mamba
    cfg = _cfg("jamba_v0_1_52b", layers=8)
    batch = _batch(cfg)
    tc = TrainConfig(remat="none", loss_chunk=None)
    one = ModelBundle(cfg, train_cfg=tc, device=DEVICE)
    p0 = one.init_params(0)
    mesh = _mesh(2, 2)
    mb = ModelBundle(cfg, mesh, train_cfg=tc)
    params, sbatch = mb.shard_params(p0), mb.shard_batch(batch)
    out = {}
    for stage in (torch.bfloat16, torch.float32):
        mamba.STAGE_DTYPE = stage
        try:
            _, l0, _, g0 = one.loss_and_grads(p0, batch)
            _, l1, _, g1 = mb.loss_and_grads(params, sbatch)
        finally:
            mamba.STAGE_DTYPE = torch.bfloat16
        pairs = [(_full(a), b) for a, b in zip(tree_leaves(g1),
                                               tree_leaves(g0))]
        out[str(stage).split(".")[-1]] = {
            "loss_one": float(l0), "loss_mesh": float(_full(l1)),
            "gnorm_one": float(torch.sqrt(sum((b * b).sum()
                                              for _, b in pairs))),
            "gnorm_mesh": float(torch.sqrt(sum((a * a).sum()
                                               for a, _ in pairs))),
            "grad_max_rel": max(float((a - b).abs().max()
                                      / (b.abs().max() + 1e-30))
                                for a, b in pairs)}
    res["jamba_step"] = out


def check_serving(res):
    """A prefill and one decode step on 2×2 with the caches laid out by
    ``cache_shardings``, against one device."""
    cfg = _cfg("qwen1_5_0_5b")
    tok = _batch(cfg, seed=3)["tokens"][:4, :12]
    one = ModelBundle(cfg, device=DEVICE)
    p = one.init_params(0)
    lg0, c0 = one.make_prefill()(p, {"tokens": tok})
    nt0 = torch.argmax(lg0, -1).to(torch.int32)
    t0, c0 = one.make_decode_step()(p, c0, nt0, tok.shape[1])
    mesh = _mesh(2, 2)
    mb = ModelBundle(cfg, mesh)
    dp = mb.shard_params(p)
    lg, c = mb.make_prefill()(dp, mb.shard_batch({"tokens": tok}))
    want = mb.cache_shardings(c)
    placed = all(leaf.placements == s[1] for leaf, (_, s) in
                 zip(tree_leaves(c), sh.leaf_items(want)))
    prefill_err = float((_full(lg) - lg0).abs().max())
    nt = mb.shard_batch({"tokens": torch.argmax(_full(lg), -1)
                         .to(torch.int32)})["tokens"]
    t1, c1 = mb.make_decode_step()(dp, c, nt, tok.shape[1])
    cache_err = max(float((_full(a).float() - b.float()).abs().max())
                    for a, b in zip(tree_leaves(c1), tree_leaves(c0)))
    res["serving"] = {"caches_placed": placed, "prefill_max_abs": prefill_err,
                      "same_tokens": bool(torch.equal(_full(t1), t0)),
                      "cache_max_abs": cache_err}


#: (case, arch, mesh, ArchConfig fields) of the kernel-serving checks on
#: four ranks: EP, Mamba and 4 whole heads; the encoder and the cross
#: attention; 6 q and 2 KV heads at hd 16, whose 96 columns cut into 4 × 24
#: (one and a half heads a rank)
KERNEL_SERVING = [("jamba_v0_1_52b:1x4", "jamba_v0_1_52b", (1, 4), {}),
                  ("jamba_v0_1_52b:2x2", "jamba_v0_1_52b", (2, 2), {}),
                  ("jamba_v0_1_52b:4x1", "jamba_v0_1_52b", (4, 1), {}),
                  ("whisper_large_v3:1x4", "whisper_large_v3", (1, 4), {}),
                  ("whisper_large_v3:2x2", "whisper_large_v3", (2, 2), {}),
                  ("smollm_360m_6_2:1x4", "smollm_360m", (1, 4),
                   {"num_heads": 6, "num_kv_heads": 2})]
KERNEL_SERVING_2 = [("jamba_v0_1_52b:1x2", "jamba_v0_1_52b", (1, 2), {}),
                    ("jamba_v0_1_52b:2x1", "jamba_v0_1_52b", (2, 1), {}),
                    ("whisper_large_v3:1x2", "whisper_large_v3", (1, 2), {}),
                    ("smollm_360m_6_2:1x2", "smollm_360m", (1, 2),
                     {"num_heads": 6, "num_kv_heads": 2})]
SERVE_SHAPE, SERVE_FRAMES = (4, 12), 20


def _kernel_batch(cfg):
    """The serving checks' batch: tokens [4, 12] (and Whisper's frame
    embeddings [4, 20, D]) from the seed."""
    b, s = SERVE_SHAPE
    batch = {"tokens": _batch(cfg, seed=3)["tokens"][:b, :s]}
    if cfg.encoder_layers:
        rng = np.random.default_rng(4)
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(b, SERVE_FRAMES, cfg.d_model)).astype(np.float32)) \
            .to(DEVICE)
    return batch


def _counting_wrappers():
    """Replace ``kernels.ops.flash_attention`` / ``selective_scan`` (what
    the LM calls) by wrappers that count their calls and the calls handed
    a DTensor; → (counts, restore)."""
    from repro_torch.kernels import ops as kops
    counts = {"flash_attention": 0, "selective_scan": 0, "dtensor_args": 0}
    orig = {k: getattr(kops, k)
            for k in ("flash_attention", "selective_scan")}

    def wrap(name):
        def call(*args, **kw):
            counts[name] += 1
            if any(sh.is_dtensor(a) for a in args):
                counts["dtensor_args"] += 1
            return orig[name](*args, **kw)
        return call

    for k in orig:
        setattr(kops, k, wrap(k))

    def restore():
        for k, f in orig.items():
            setattr(kops, k, f)

    return counts, restore


def _serve_case(cfg, shape, batch):
    """One kernel-serving case → its record (see
    :func:`check_kernel_serving`)."""
    from repro_torch.kernels import _build
    s = batch["tokens"].shape[1]
    one = ModelBundle(cfg, impl="kernel", device=DEVICE)
    p = one.init_params(0)
    with torch.no_grad():
        lg0, c0 = one.make_prefill()(p, batch)
        nt0 = torch.argmax(lg0, -1).to(torch.int32)
        t1_one, c0 = one.make_decode_step()(p, c0, nt0, s)
    mesh = _mesh(*shape)
    mb = ModelBundle(cfg, mesh, impl="kernel")
    dp = mb.shard_params(p)
    counts, restore = _counting_wrappers()
    if DEVICE == "cuda":
        _build.reset_kernel_launches()
    try:
        with torch.no_grad():
            lg, c = mb.make_prefill()(dp, mb.shard_batch(batch))
    finally:
        restore()
    launches = _build.kernel_launches(
        device=torch.cuda.current_device()) if DEVICE == "cuda" else {}
    want = mb.cache_shardings(c)
    placed = all(leaf.placements == w[1] for leaf, (_, w) in
                 zip(tree_leaves(c), sh.leaf_items(want)))
    prefill_err = float((_full(lg) - lg0).abs().max())
    with torch.no_grad():
        nt = mb.shard_batch({"tokens": torch.argmax(_full(lg), -1)
                             .to(torch.int32)})["tokens"]
        t1, c1 = mb.make_decode_step()(dp, c, nt, s)
    cache_err = max(float((_full(a).float() - b.float()).abs().max())
                    for a, b in zip(tree_leaves(c1), tree_leaves(c0)))
    try:
        mb.make_train_step()
        refused = None
    except RuntimeError as e:
        refused = str(e)
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    return {
        "caches_placed": placed, "prefill_max_abs": prefill_err,
        "logit_max": float(lg0.abs().max()),
        "same_tokens": bool(torch.equal(_full(t1), t1_one)),
        "cache_max_abs": cache_err,
        "calls_every_rank": dist_all(
            {k: counts[k] for k in ("flash_attention", "selective_scan")}),
        "dtensor_args_every_rank": dist_all(counts["dtensor_args"]),
        "launches_every_rank": dist_all(launches),
        "want_calls": {
            "flash_attention": kinds.count("attn")
            * (1 + bool(cfg.encoder_layers)) + cfg.encoder_layers,
            "selective_scan": kinds.count("mamba")},
        "train_step_refused": refused}


def check_kernel_serving(res):
    """``ModelBundle(cfg, mesh, impl="kernel")``: a prefill and one decode
    step on each case's mesh against the one-device kernel prefill and
    decode with the same weights (on the CPU both run the kernels' plain
    versions); every rank's wrapper calls (and on the card its kernel
    launches) during the mesh prefill; the mesh train step's refusal.  A
    model with Mamba layers runs as it is (the scan inputs staged in
    bf16) and again with the staging in float32 (``mamba.STAGE_DTYPE``),
    as :func:`check_jamba_step` does: a float32 ulp of the model axis'
    partial sums can flip one bf16 staging rounding."""
    from repro_torch.ml import mamba
    cases = KERNEL_SERVING if dist.get_world_size() >= 4 \
        else KERNEL_SERVING_2
    out = {}
    for key, arch, shape, fields in cases:
        cfg = replace(_cfg(arch, layers=8 if arch.startswith("jamba")
                           else None), **fields)
        batch = _kernel_batch(cfg)
        t0 = time.perf_counter()
        row = _serve_case(cfg, shape, batch)
        if "mamba" in cfg.block_pattern:
            mamba.STAGE_DTYPE = torch.float32
            try:
                row["float32_stage"] = _serve_case(cfg, shape, batch)
            finally:
                mamba.STAGE_DTYPE = torch.bfloat16
        row["seconds"] = time.perf_counter() - t0
        out[key] = row
    res["kernel_serving"] = out


#: (case, arch, mesh, ArchConfig fields) of the production mesh's uneven
#: cuts at a small size: q heads that divide the model axis over KV heads
#: that do not; xLSTM heads that do not divide it (one block cycle);
#: Whisper's encoder, decoder and cross attention; experts that do not
#: divide the model axis (TP experts), their groups cut over data
UNEVEN_HEADS = [("qwen1_5_0_5b_8_2:1x4", "qwen1_5_0_5b", (1, 4),
                 {"num_heads": 8, "num_kv_heads": 2}),
                ("xlstm_1_3b_2:1x4", "xlstm_1_3b", (1, 4),
                 {"num_heads": 2, "num_kv_heads": 2, "num_layers": 8}),
                ("whisper_large_v3:1x4", "whisper_large_v3", (1, 4), {}),
                ("mixtral_8x7b_3e:2x2", "mixtral_8x7b", (2, 2),
                 {"moe_experts": 3, "moe_group_size": 16})]
UNEVEN_SHAPE = (4, 16)


def check_uneven_heads(res):
    """Each case's loss and gradients, a prefill and a decode step on its
    mesh (``impl="reference"``, remat full) against one device, float32
    activations; a case that raises records its error."""
    out = {}
    for key, arch, shape, fields in UNEVEN_HEADS:
        cfg = replace(_cfg(arch), **fields)
        b, s = UNEVEN_SHAPE
        batch = {k: v[:b, :s] for k, v in _batch(cfg).items()}
        if cfg.encoder_layers:
            batch["frames"] = _kernel_batch(cfg)["frames"][:b]
        tc = TrainConfig(remat="full", loss_chunk=None)
        t0 = time.perf_counter()
        try:
            one = ModelBundle(cfg, train_cfg=tc, device=DEVICE)
            p0 = one.init_params(0)
            mb = ModelBundle(cfg, _mesh(*shape), train_cfg=tc)
            params, sbatch = mb.shard_params(p0), mb.shard_batch(batch)
            _, l0, _, g0 = one.loss_and_grads(p0, batch)
            _, l1, _, g1 = mb.loss_and_grads(params, sbatch)
            pairs = [(_full(a), b_) for a, b_ in zip(tree_leaves(g1),
                                                     tree_leaves(g0))]
            serve = {k: v for k, v in batch.items() if k != "labels"}
            with torch.no_grad():
                lg0, c0 = one.make_prefill()(p0, serve)
                lg1, c1 = mb.make_prefill()(params, mb.shard_batch(serve))
                nt0 = torch.argmax(lg0, -1).to(torch.int32)
                t1_one, _ = one.make_decode_step()(p0, c0, nt0, s)
                t1, _ = mb.make_decode_step()(
                    params, c1, mb.shard_batch({"tokens": nt0})["tokens"], s)
            out[key] = {
                "loss_one": float(l0), "loss_mesh": float(_full(l1)),
                "gnorm_one": float(torch.sqrt(sum((b_ * b_).sum()
                                                  for _, b_ in pairs))),
                "gnorm_mesh": float(torch.sqrt(sum((a * a).sum()
                                                   for a, _ in pairs))),
                "grad_max_rel": max(float((a - b_).abs().max()
                                          / (b_.abs().max() + 1e-30))
                                    for a, b_ in pairs),
                "prefill_max_abs": float((_full(lg1) - lg0).abs().max()),
                "same_tokens": bool(torch.equal(_full(t1), t1_one)),
                "error": None}
        except Exception as e:          # every rank raises alike
            out[key] = {"error": f"{type(e).__name__}: {e}"[:500]}
        out[key]["seconds"] = time.perf_counter() - t0
    res["uneven_heads"] = out


#: (name, mesh, TrainConfig fields) of the steps the dry-run is held to
DRYRUN_STEPS = [("zero1", (4, 1), {"zero1": True}),
                ("fsdp", (4, 1), {"fsdp": True}),
                ("2x2", (2, 2), {})]


def dryrun_train_config(**kw):
    """The train config of the steps the dry-run is held to."""
    return TrainConfig(remat="none", loss_chunk=None, warmup=1,
                       total_steps=4, **kw)


def comm_kinds(counts):
    """``CommDebugMode.get_comm_counts()`` → {kind: count} by the dry-run's
    kind names (the funcol ops and DTensor's all-to-all)."""
    from repro_torch.launch.dryrun import collective_kind
    out = {}
    for op, n in counts.items():
        kind = collective_kind(op)
        if kind is not None and n:
            out[kind] = out.get(kind, 0) + n
    return out


def _storage_bytes(tree):
    seen = {}
    for t in tree_leaves(tree):
        st = (t.to_local() if hasattr(t, "to_local") else t).untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def check_dryrun_steps(res):
    """A reduced Qwen's train step for real on each of DRYRUN_STEPS'
    meshes under ``CommDebugMode``: rank 0's collectives by kind and its
    local argument bytes (parameters, optimizer state, batch), which the
    test file holds to the dry-run of the same mesh on a fake group."""
    from torch.distributed.tensor.debug import CommDebugMode
    cfg = _cfg("qwen1_5_0_5b")
    out = {}
    for name, shape, kw in DRYRUN_STEPS:
        mb = ModelBundle(cfg, _mesh(*shape),
                         train_cfg=dryrun_train_config(**kw))
        p = mb.init_params(0)
        args = (mb.shard_params(p), mb.shard_opt_state(mb.init_opt_state(p)),
                mb.shard_batch(_batch(cfg)))
        comm = CommDebugMode()
        with comm:
            mb.make_train_step()(*args)
        out[name] = {"counts": comm_kinds(comm.get_comm_counts()),
                     "argument_bytes": _storage_bytes(args)}
    res["dryrun_steps"] = out


def check_psum(res):
    """``compressed_psum`` over the whole group and over the data dim of
    a 2×2 mesh: the result, the group's ranks (each rank's input is drawn
    from its rank as the seed)."""
    x = torch.from_numpy(np.random.default_rng(100 + dist.get_rank())
                         .normal(size=PSUM_SHAPE).astype(np.float32)) \
        .to(DEVICE)
    mesh = _mesh(2, 2) if dist.get_world_size() >= 4 else _mesh(2, 1)
    out = {}
    for name, group in (("world", dist.group.WORLD),
                        ("data", mesh["data"])):
        got = compressed_psum(x, group)
        pg = group.get_group() if hasattr(group, "get_group") else group
        out[name] = {"ranks": dist.get_process_group_ranks(pg),
                     "got": got.cpu().numpy().tolist()}
    res["psum"] = out


def check_reshard(res):
    cfg = get_config("smollm_360m").reduced()
    mb1 = ModelBundle(cfg, _mesh(1, 1))
    res["reshard_1x1"] = elastic.reshard_plan(mb1, mb1)
    mb22 = ModelBundle(cfg, _mesh(2, 2))
    res["reshard_1x1_to_2x2"] = elastic.reshard_plan(mb1, mb22)


def check_elastic_restore(res, tmp):
    """A train state saved on 2×2 (1 × 2 on two ranks) restores onto
    4×1 (2 × 1): every leaf bit-equal to what was saved, placed as the
    target's specs say."""
    from repro_torch.ckpt.checkpoint import (CheckpointManager,
                                             restore_checkpoint)
    cfg = _cfg("qwen1_5_0_5b")
    a = ModelBundle(cfg, _mesh(*_square()),
                    train_cfg=TrainConfig(zero1=True))
    b = ModelBundle(cfg, _mesh(dist.get_world_size(), 1),
                    train_cfg=TrainConfig(fsdp=True))
    p = a.init_params(0)
    params = a.shard_params(p)
    opt = a.shard_opt_state(a.init_opt_state(p))
    params, opt, _ = a.make_train_step()(params, opt,
                                         a.shard_batch(_batch(cfg)))
    d = os.path.join(tmp, "elastic")
    mgr = CheckpointManager(d)
    mgr.save(3, {"params": params, "opt": opt, "step": np.int64(3)})
    saved = [_full(t) for t in tree_leaves({"params": params, "opt": opt})]
    template = {"params": params, "opt": opt, "step": np.int64(0)}
    got, step = mgr.restore_or_none(template, shardings={
        "params": b.param_shardings(), "opt": b.opt_state_shardings(),
        "step": None})
    restored = tree_leaves({"params": got["params"], "opt": got["opt"]})
    shapes = b.params_shape()
    res["elastic"] = {
        "step": step, "step_leaf": int(got["step"]),
        "bit_equal": all(torch.equal(_full(r), s)
                         for r, s in zip(restored, saved)),
        "params_placed": _placed_as(got["params"], b.param_specs(shapes),
                                    b.mesh),
        "moments_placed": _placed_as(got["opt"]["adam"]["m"],
                                     b.opt_specs(shapes), b.mesh),
        "files": sorted(os.listdir(d)) if dist.get_rank() == 0 else None}
    # the same on the module function, no manager
    again, _ = restore_checkpoint(d, template, shardings={
        "params": b.param_shardings(), "opt": b.opt_state_shardings(),
        "step": None})
    res["elastic"]["function_bit_equal"] = all(
        torch.equal(_full(r), s) for r, s in zip(
            tree_leaves({"params": again["params"], "opt": again["opt"]}),
            saved))


def check_train_loop(res, tmp):
    """``train_loop(mesh=)``: 4 steps on 2×2 with checkpoints every 2;
    the step-4 checkpoint removed, a resume on 4×1 runs steps 2–3 again
    from step 2's state."""
    import shutil
    from repro_torch.launch.train import train_loop
    cfg = _cfg("qwen1_5_0_5b")
    d = os.path.join(tmp, "loop")
    kw = dict(reduced=False, steps=4, batch=BATCH, seq=SEQ, ckpt_dir=d,
              ckpt_every=2, log_every=1, device=DEVICE)
    lines_a, lines_b = [], []
    _, _, first = train_loop(cfg, mesh=_mesh(2, 2),
                             print_fn=lines_a.append, **kw)
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(os.path.join(d, "step-00000004"))
    dist.barrier()
    params, _, again = train_loop(cfg, mesh=_mesh(4, 1),
                                  resume=True, print_fn=lines_b.append, **kw)
    mb = ModelBundle(cfg, _mesh(4, 1))
    shapes = mb.params_shape()
    res["train_loop"] = {"first": first, "again": again,
                         "lines_rank": [lines_a, lines_b],
                         "params_placed": _placed_as(
                             params, mb.param_specs(shapes), mb.mesh)}
    res["train_loop"]["lines_every_rank"] = dist_all(
        [len(lines_a), len(lines_b)])


CHECKS = [check_local_meshes, check_placements, check_steps,
          check_jamba_step, check_serving, check_kernel_serving,
          check_uneven_heads, check_dryrun_steps, check_psum,
          check_reshard, check_elastic_restore, check_train_loop]
CUDA_CHECKS = [check_steps, check_kernel_serving, check_psum,
               check_elastic_restore]


def main(rank, world, init_file, out_dir, device="cpu"):
    global DEVICE
    DEVICE = device
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    res, seconds = {}, {}
    try:
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            tmp = dist_all(tmp)[0]      # rank 0's directory, shared
            for fn in CUDA_CHECKS if device == "cuda" else CHECKS:
                t0 = time.perf_counter()
                if fn in (check_elastic_restore, check_train_loop):
                    fn(res, tmp)
                else:
                    fn(res)
                seconds[fn.__name__] = time.perf_counter() - t0
                dist.barrier()
        res["seconds"] = seconds
        if rank == 0:
            with open(os.path.join(out_dir, "results.json"), "w") as fh:
                json.dump(res, fh)
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)             # the other ranks fail at their collective
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         *sys.argv[5:6])
