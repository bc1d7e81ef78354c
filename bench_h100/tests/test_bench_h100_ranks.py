"""A cell on several cards, rehearsed on the CPU: ranks of gloo processes
(``harness.ranks``) at a tiny size, on the four-card Jamba cell as a
benchmark would list it (its configuration and cell files are in place;
``BENCHMARK.json`` does not list it: on the cards its rate spreads too
widely from run to run for the bound it would share).  The launcher ends
with rank 0's result, and stops every rank when one fails or hangs; the
server on the mesh gives the one-device server's tokens and, in float32,
its logits to float32 reordering; the weights on the mesh are the
one-device weights' slices; the reference's pipeline of stages gives the
whole reference's logits; a whole run of the four-card cell (set-up,
window, check, control) on two ranks comes out as one run on one device
does; and each fault the cell can have comes out not correct."""
import time

import numpy as np
import pytest
import torch

from bench_h100_tiny import tiny_cell
from bench_h100.harness import ranks, runner, spec

CELL = "jamba_v0_1_52b.column"


def _listing() -> dict:
    """``BENCHMARK.json`` with the four-card cell listed: its configuration,
    the cell, every metric of the one-card Jamba column and
    ``collective_share``."""
    bench = spec.benchmark()
    bench["configs"].append({"name": "jamba_v0_1_52b",
                             "file": "bench_h100/configs/jamba_v0_1_52b.json"})
    bench["workloads"].append({"name": CELL, "config": "jamba_v0_1_52b",
                               "traffic": "column", "chips": 4})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "jamba_v0_1_8of32.column" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    bench["per_layer"].append({"name": "collective_share", "unit": "%",
                               "moves": "tokens_per_s", "workloads": [CELL]})
    return bench


def mesh_cell(**traffic):
    return tiny_cell(CELL, _listing(), **traffic)
#: the tiny cell's own limits (16 layers), from its readings on seeds 1-3,
#: 2**31 + 7 and 2**31 + 11, on one device and on two ranks: sound mean
#: gap at most 0.089, logits' mean distance at most 0.137; the float8
#: control at least 0.26 and 0.37
LIMITS = {"mean_logit_gap": 0.14, "logit_err_mean": 0.22}
SEED = 2 ** 31 + 11


def _launch(fn, args=(), world=2, limit=240.0):
    return ranks.launch(fn, args, world, backend="gloo",
                        deadline=time.perf_counter() + limit)


# ------------------------------------------------------------- launcher
def _raise_on_one(rank, world):
    import torch.distributed as dist
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()                   # rank 0 waits for a rank that died
    return "never"


def _hang_on_one(rank, world):
    import torch.distributed as dist
    if rank == 1:
        time.sleep(3600)
    dist.barrier()
    return "never"


def _rank_and_world(rank, world):
    return {"rank": rank, "world": world}


def test_the_launcher_returns_rank_0s_value():
    assert _launch(_rank_and_world, world=3) == {"rank": 0, "world": 3}


@pytest.mark.parametrize("fn", [_raise_on_one, _hang_on_one])
def test_a_failing_rank_ends_the_run(fn):
    t0 = time.perf_counter()
    with pytest.raises(ranks.RanksFailed):
        _launch(fn, limit=20.0)
    assert time.perf_counter() - t0 < 60


# --------------------------------------------------------- the mesh path
def _mesh_checks(rank, world):
    """On each rank: the weights' pieces, the server's tokens and logits
    on the mesh in float32 and in the served dtype, and the pipeline's
    logits → rank 0 gathers every rank's findings."""
    import torch.distributed as dist
    from repro_torch.launch.serve import Request, Server
    from bench_h100.harness import port, weights
    from bench_h100.harness.model import dims
    from bench_h100.reference.lm import Model, follow
    from bench_h100.reference.stages import Pipe, layers_of
    dev = torch.device("cpu")
    c = mesh_cell()
    dm = dims(c.config)
    mesh = port.mesh_of(c.config, dev)
    found = {}
    # the weights: each piece is the one-device leaf's slice
    whole = weights.make(dm, 5, dev)
    placed = port.mesh_params(dm, 5, mesh, dev)
    found["weights_equal"] = all(
        torch.equal(a.full_tensor(), b) for (_, a), (_, b) in
        zip(weights.leaves(placed), weights.leaves(whole)))
    found["some_cut"] = any(
        a.to_local().numel() < a.numel() for _, a in weights.leaves(placed))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, dm.vocab, n).astype(np.int32)
               for n in (20, 33, 12, 40)]
    # float32 throughout (weights made as for training), and as served
    for act, purpose in (("float32", "train"), ("bfloat16", "serve")):
        cfg = port.arch_config(dm, act)
        placed_now = port.mesh_params(dm, 5, mesh, dev, purpose)
        srv = port.server_on_mesh(cfg, placed_now, 4, dm.context, 5, mesh,
                                  dev)
        one = Server(cfg, reduced=False, max_batch=4, max_len=dm.context,
                     device="cpu")
        one.params = weights.make(dm, 5, dev, purpose)
        logs = {}
        for name, s in (("mesh", srv), ("one", one)):
            got, pre, dec = [], s.lm.prefill, s.lm.decode_step

            def prefill(*a, pre=pre, got=got):
                out = pre(*a)
                got.append(out[0])
                return out

            def decode(*a, dec=dec, got=got):
                out = dec(*a)
                got.append(out[0])
                return out
            s.lm.prefill, s.lm.decode_step = prefill, decode
            reqs = [Request(i, p, max_new=4) for i, p in enumerate(prompts)]
            s.serve(reqs)
            logs[name] = (got, [r.out for r in reqs], dict(s.stats))
        (lm, tm, sm), (lo, to, so) = logs["mesh"], logs["one"]
        found[f"tokens_{act}"] = tm == to and sm == so
        found[f"logits_{act}"] = max(
            float((a - b).abs().max() / b.abs().max())
            for a, b in zip(lm, lo))
        found[f"plain_{act}"] = all(type(t) is torch.Tensor for t in lm)
    # the reference's stages against the whole reference
    layers = layers_of(dm.layers, dm.period, rank, world)
    last = rank == world - 1
    held = Model(dm, weights.stage(dm, 5, dev, layers, embed=rank == 0,
                                   head=last), layers=layers)
    toks = torch.from_numpy(np.stack([rng.integers(0, dm.vocab, 24)
                                      for _ in range(3)])).long()
    served = torch.from_numpy(rng.integers(0, dm.vocab, (3, 4))).long()
    staged = list(Pipe(rank, world, dev).follow(held, toks, served, 24))
    if last:
        ref = list(follow(Model(dm, whole), toks, served, 24))
        found["stages_equal"] = all(torch.equal(a, b)
                                    for a, b in zip(staged, ref))
        found["stage_layers"] = [layers.start, layers.stop]
    else:
        found["stages_silent"] = all(x is None for x in staged)
    every = [None] * world
    dist.all_gather_object(every, found)
    return every


@pytest.fixture(scope="module")
def mesh_found():
    return _launch(_mesh_checks)


def test_mesh_weights_are_the_one_device_weights_slices(mesh_found):
    for f in mesh_found:
        assert f["weights_equal"] and f["some_cut"]


def test_mesh_server_gives_the_one_device_servers_tokens(mesh_found):
    for f in mesh_found:
        assert f["tokens_float32"] and f["tokens_bfloat16"]
        assert f["plain_float32"] and f["plain_bfloat16"]
        # float32: the same sums in another order, through 16 layers
        # (3.5e-5 here; the smoke holds its meshes' float32 at 1e-3)
        assert f["logits_float32"] < 1e-4


def test_the_stages_give_the_whole_references_logits(mesh_found):
    first, last = mesh_found
    assert first["stages_silent"] and last["stages_equal"]
    assert last["stage_layers"] == [8, 16]


# -------------------------------------------------------------- a run
def test_a_run_on_two_ranks_is_a_whole_run():
    c = mesh_cell()
    c.limits = dict(LIMITS)
    jobs = [dict(name=CELL, seed=SEED, seconds=0.4, traced=t, cell=c,
                 control=k) for t, k in ((False, False), (True, False),
                                         (False, True))]
    plain, traced, control = _launch(runner.run_ranks, (jobs, "gloo"))
    assert plain["correct"] and traced["correct"], plain["checks"]
    assert not control["correct"], control["checks"]
    for out in (plain, traced, control):
        assert out["device"]["count"] == 2 and out["forbidden"] == []
        assert out["attempted"] > 0 and out["failed"] == 0
        assert out["readings"]["checked_batches"] >= 1
        assert list(out)[-1] == "checks"
    assert set(plain["metrics"]) == {"tokens_per_s", "setup_s"}
    for name in ("pad_share", "prefill_mamba_share", "prefill_moe_share",
                 "moe_slot_use", "decode_idle", "batch_idle"):
        assert 0 <= traced["metrics"][name]["value"] <= 100, name
    # on the CPU no device record: no roofline, no collective share
    assert "collective_share" not in traced["metrics"]
    # the control's own reading against the program's
    for key, limit in LIMITS.items():
        assert control["readings"][f"program_{key}"] <= limit


# ------------------------------------------------- faults on the mesh
def _exchange_left_out():
    """Each rank keeps its own partial sums: no all-reduce, and no
    reduce-scatter (its own piece of its own sums)."""
    from torch.distributed.tensor.placement_types import Partial

    def own_piece(self, tensor, mesh, mesh_dim, shard_spec):
        return tensor.chunk(mesh.size(mesh_dim), dim=shard_spec.dim)[
            mesh.get_local_rank(mesh_dim)].contiguous()
    return [(Partial, "_reduce_value",
             lambda self, tensor, mesh, mesh_dim: tensor),
            (Partial, "_reduce_shard_value", own_piece)]


def _state_unchanged():
    import copy
    from repro_torch.ml.transformer import LM
    real = LM.decode_step

    def decode_step(self, p, tokens, caches, pos):
        logits, _ = real(self, p, tokens, copy.deepcopy(caches), pos)
        return logits, caches
    return [(LM, "decode_step", decode_step)]


def _alter_a_token():
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.ml.transformer import LM
    real = LM.decode_step

    def decode_step(self, p, tokens, caches, pos):
        logits, caches = real(self, p, tokens, caches, pos)
        whole = logits.full_tensor()
        whole[0] = torch.roll(whole[0], 1, dims=-1)
        return distribute_tensor(whole, logits.device_mesh,
                                 logits.placements,
                                 src_data_rank=None), caches
    return [(LM, "decode_step", decode_step)]


FAULTS = {"exchange_left_out": _exchange_left_out,
          "state_unchanged": _state_unchanged,
          "alter_a_token": _alter_a_token}


def _faulty_runs(rank, world, cell):
    """A run of the tiny cell without a fault, then with each fault
    planted on every rank → {fault: correct}."""
    out = {}
    for name, plant in {"none": list, **FAULTS}.items():
        patches = plant()
        real = [getattr(owner, attr) for owner, attr, _ in patches]
        for owner, attr, broken in patches:
            setattr(owner, attr, broken)
        try:
            (got,) = runner.run_ranks(rank, world, [dict(
                name=CELL, seed=1, seconds=0.4, traced=False, cell=cell)],
                "gloo") or [None]
        finally:
            for (owner, attr, _), was in zip(patches, real):
                setattr(owner, attr, was)
        if rank == 0:
            out[name] = got["correct"]
    return out


#: the tiny cell with up to 12 new tokens a request, so that a decode
#: state left unchanged has steps to show in; its logits' mean distance,
#: on two ranks on seeds 1-3 and 2**31 + 7: sound at most 0.171, the float8
#: control at least 0.429 (its mean gap does not separate: sound up to
#: 0.198, control from 0.259)
LONGER = {"new_tokens": {"dist": "lognormal", "median": 6, "sigma": 0.5,
                         "min": 2, "max": 12}, "check_batches": 4}
LONGER_LIMITS = {"logit_err_mean": 0.3}


def test_faults_on_the_mesh_are_not_correct():
    c = mesh_cell(**LONGER)
    c.limits = dict(LONGER_LIMITS)
    got = _launch(_faulty_runs, (c,), limit=400.0)
    assert got == {"none": True, **{name: False for name in FAULTS}}
