"""The port's dry-run (``repro_torch.launch.dryrun``, ``ModelBundle``'s
``input_specs`` and ``lower_*``) on the CPU.

  * ``input_specs`` against the JAX package's pure function for every
    architecture × ``shape_cells`` cell: the same keys, shapes and dtypes;
  * the counters against real tensors: a reduced SmolLM, Jamba and
    Whisper train step and prefill on one device counted on fake tensors
    and on real ones by the same ``StepCounter`` — equal FLOPs and equal
    memory (argument, output, temporary and peak bytes);
  * in one process of its own (the dry-run owns its process group): a
    DTensor product counted a rank, on its local shapes; the port of
    ``tests/test_dryrun_small.py``'s machinery check at 8 fake ranks;
    the production mesh's uneven cuts at a small size, one fake-rank
    train step each; one production cell through ``run_cell``, whose
    record has every key of the reference's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                               # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo     # noqa: E402
from repro.ml.model import input_specs as jinput_specs  # noqa: E402

from repro_torch.configs.base import (SHAPES, ShapeConfig,  # noqa: E402
                                      get_config, list_archs, shape_cells)
from repro_torch.launch.dryrun import StepCounter     # noqa: E402
from repro_torch.ml.model import (ModelBundle, TrainConfig,  # noqa: E402
                                  input_specs)

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s.name) for a in list_archs() for s in shape_cells(get_config(a))]
#: the reference's record keys (``repro/launch/dryrun.py`` ``run_cell``)
RECORD_KEYS = {"arch", "shape", "mesh", "axes", "chips", "kind", "lower_s",
               "compile_s", "memory", "cost", "analyzed", "collectives",
               "model_flops_dense", "model_flops_active", "params", "tag"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
COUNTED = [(a, k) for a in ("smollm_360m", "jamba_v0_1_52b",
                            "whisper_large_v3") for k in ("train", "prefill")]
#: point 0 of the production mesh at a small size: (case, arch, (data,
#: model), ArchConfig fields)
UNEVEN = [("qwen1_5_0_5b_16_2:1x8", "qwen1_5_0_5b", (1, 8),
           {"num_heads": 16, "num_kv_heads": 2}),
          ("xlstm_1_3b_2:1x4", "xlstm_1_3b", (1, 4),
           {"num_heads": 2, "num_kv_heads": 2, "num_layers": 8}),
          ("whisper_large_v3:1x4", "whisper_large_v3", (1, 4), {})]
TIMEOUT_S = 400

_SCRIPT = r"""
import json, os, sys, tempfile
from dataclasses import replace
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch.dryrun import StepCounter, fake_world, run_cell
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.ml.model import ModelBundle, TrainConfig
UNEVEN = json.loads(sys.argv[1])
out = {}

# a DTensor product [256, 4096] @ [4096, 4096] cut 16 ways along its
# columns, counted on rank 0
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
with fake_world(16):
    mesh = make_local_mesh(1, 16, device="cpu")
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(256, 4096), mesh,
                              [Replicate(), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(4096, 4096), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        c = StepCounter()
        with c:
            y = x @ w
    out["product_flops"] = c.flops
    out["product_local_shape"] = list(y.to_local().shape)

# tests/test_dryrun_small.py's machinery at 8 fake ranks
with fake_world(8):
    mesh = make_local_mesh(2, 4, device="cpu")
    cfg = get_config("qwen1_5_0_5b").reduced()
    mb = ModelBundle(cfg, mesh, impl="reference",
                     train_cfg=TrainConfig(remat="full", loss_chunk=32,
                                           zero1=True))
    low = mb.lower_train(ShapeConfig("tiny_train", 64, 8, "train"))
    dec = mb.lower_decode(ShapeConfig("tiny_decode", 64, 8, "decode"))
    out["machinery"] = {"flops": low.cost["flops_per_device"],
                        "coll": low.collectives["total_bytes"],
                        "temp_bytes": low.memory["temp_bytes"],
                        "decode_flops": dec.cost["flops_per_device"]}

# the production mesh's uneven cuts at a small size
out["uneven"] = {}
for key, arch, (d, m), fields in UNEVEN:
    with fake_world(d * m):
        mesh = make_local_mesh(d, m, device="cpu")
        cfg = replace(get_config(arch).reduced(), **fields)
        mb = ModelBundle(cfg, mesh, train_cfg=TrainConfig(
            remat="full", loss_chunk=16, zero1=True))
        try:
            low = mb.lower_train(ShapeConfig("t", 16, 8, "train"))
            out["uneven"][key] = {"error": None,
                                  "flops": low.cost["flops_per_device"]}
        except Exception as e:
            out["uneven"][key] = {"error": f"{type(e).__name__}: {e}"[:400]}

# one production cell through run_cell
with tempfile.TemporaryDirectory() as tmp:
    rec = run_cell("qwen1_5_0_5b", "decode_32k", False, tmp,
                   train_overrides={"remat": "full", "loss_chunk": 2048,
                                    "zero1": True, "param_dtype": "bfloat16"})
    out["cell"] = {"record": rec, "files": os.listdir(tmp)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _SCRIPT, json.dumps(UNEVEN)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# the repairs, in a process of their own: ``--ssm_chunk`` through the CLI
# (C13), and the sLSTM time loop counted once and scaled by its trip count
# against the step-by-step count on a small fake group (C12)
_REPAIRS = r"""
import json, os, sys, tempfile
from dataclasses import replace
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch.dryrun import fake_world, main
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.ml import xlstm
from repro_torch.ml.model import ModelBundle, TrainConfig
out = {"loops": {}}
with fake_world(4):
    mesh = make_local_mesh(2, 2, device="cpu")
    cfg = replace(get_config("xlstm_1_3b").reduced(), num_layers=8)
    mb = ModelBundle(cfg, mesh, train_cfg=TrainConfig(
        remat="full", loss_chunk=16, zero1=True))
    for kind in ("train", "prefill"):
        shape = ShapeConfig("t", 64, 4, kind)
        low = getattr(mb, f"lower_{kind}")(shape)     # counted once
        out["loops"][f"{kind}:True"] = {
            "cost": low.cost, "memory": low.memory,
            "collectives": low.collectives}
        # the same step with every sLSTM step run
        counts_once, xlstm._loop_counter = xlstm._loop_counter, lambda: None
        try:
            low = getattr(mb, f"lower_{kind}")(shape)
        finally:
            xlstm._loop_counter = counts_once
        out["loops"][f"{kind}:False"] = {
            "cost": low.cost, "memory": low.memory,
            "collectives": low.collectives}
with tempfile.TemporaryDirectory() as tmp:
    main(["--arch", "jamba_v0_1_52b", "--shape", "decode_32k",
          "--multi_pod", "false", "--ssm_chunk", "128", "--out_dir", tmp])
    out["chunk_cell"] = {
        "files": os.listdir(tmp),
        "record": json.load(open(os.path.join(
            tmp, "jamba_v0_1_52b-decode_32k-pod.json")))}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def repair_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _REPAIRS], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# ------------------------------------------------------------ input_specs

@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    want = jinput_specs(jget_config(arch), SHAPES[shape])
    got = input_specs(get_config(arch), SHAPES[shape])
    assert set(got) == set(want)
    for k, spec in want.items():
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert got[k].device.type == "meta"
        assert str(got[k].dtype).split(".")[-1] == jnp.dtype(
            spec.dtype).name, k


# ------------------------------------------------------ counters vs real

@pytest.mark.parametrize("arch,kind", COUNTED)
def test_counters_equal_a_real_step(arch, kind):
    """The dry-run's FLOPs and memory of a reduced model's step on one
    device equal the same counter's on the real CPU step."""
    cfg = get_config(arch).reduced()
    mb = ModelBundle(cfg, device="cpu", train_cfg=TrainConfig(
        remat="full", loss_chunk=16))
    shape = ShapeConfig("t", 16, 2, kind)
    low = getattr(mb, f"lower_{kind}")(shape)
    args = mb.fake_args(kind, shape)            # real tensors here
    fn = {"train": mb.make_train_step,
          "prefill": mb.make_prefill}[kind]()
    counter = StepCounter()
    with counter:
        counter.hold(args)
        counter.finish(fn(*args))
    real = counter.record()
    assert low.cost["flops_per_device"] == real["cost"]["flops_per_device"]
    assert low.cost["flops_per_device"] > 0
    assert low.memory == real["memory"]
    assert low.memory["temp_bytes"] > 0
    assert low.memory["peak_bytes"] == \
        low.memory["argument_bytes"] + low.memory["temp_bytes"]


def test_lower_refuses_another_kind():
    mb = ModelBundle(get_config("smollm_360m").reduced(), device="cpu")
    with pytest.raises(ValueError, match="decode"):
        mb.lower_train(ShapeConfig("t", 16, 2, "decode"))


# --------------------------------------------------------- on fake ranks

def test_dtensor_product_is_counted_a_rank(fake_runs):
    """[256, 4096] @ [4096, 4096 / 16] on each of 16 ranks: 2·256·4096·256
    FLOPs a rank, not the global product's (nor both)."""
    assert fake_runs["product_local_shape"] == [256, 256]
    assert fake_runs["product_flops"] == 2 * 256 * 4096 * 256


def test_dryrun_machinery_on_8_fake_ranks(fake_runs):
    """The port of ``tests/test_dryrun_small.py``: FLOPs counted, the
    model axis communicates, the decode step runs."""
    row = fake_runs["machinery"]
    assert row["flops"] > 0
    assert row["coll"] > 0
    assert row["temp_bytes"] > 0
    assert row["decode_flops"] > 0


@pytest.mark.parametrize("key", [u[0] for u in UNEVEN])
def test_uneven_head_cuts_run_on_fake_ranks(fake_runs, key):
    """Heads that divide the model axis over KV heads that do not (16 / 2
    over 8), xLSTM heads that do not (2 over 4) and Whisper's attention
    run one train step on fake ranks."""
    row = fake_runs["uneven"][key]
    assert row["error"] is None, row["error"]
    assert row["flops"] > 0


def test_run_cell_record_has_the_reference_keys(fake_runs):
    rec = fake_runs["cell"]["record"]
    assert set(rec) == RECORD_KEYS
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["cost"]) == {"flops_per_device", "bytes_per_device"}
    # ``analyzed`` has analyze_hlo's keys but its entry computation's name
    want = set(analyze_hlo("ENTRY %main () -> f32[] {\n}\n")) - {"entry"}
    assert set(rec["analyzed"]) == want
    assert set(rec["analyzed"]["per_kind"]) == \
        set(rec["collectives"]["per_kind"])
    assert rec["collectives"]["total_bytes"] == sum(
        v["bytes"] for v in rec["collectives"]["per_kind"].values()) > 0
    assert (rec["mesh"], rec["chips"], rec["axes"], rec["kind"]) == \
        ("16x16", 256, ["data", "model"], "decode")
    assert rec["compile_s"] == 0.0 and rec["lower_s"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["params"] == get_config("qwen1_5_0_5b").params_count()
    assert fake_runs["cell"]["files"] == \
        ["qwen1_5_0_5b-decode_32k-pod.json"]


# ---------------------------------------------------------------- repairs

def test_ssm_chunk_flag_records_a_cell(repair_runs):
    """``--ssm_chunk 128`` (the reference's ``REPRO_SSM_CHUNK``) maps onto
    ``ArchConfig.ssm_chunk``: a Jamba ``decode_32k`` cell runs through
    ``main`` and records."""
    row = repair_runs["chunk_cell"]
    assert row["files"] == ["jamba_v0_1_52b-decode_32k-pod.json"]
    rec = row["record"]
    assert set(rec) == RECORD_KEYS
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["memory"]["peak_bytes"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_slstm_loop_counted_once_equals_step_by_step(repair_runs, kind):
    """A reduced xLSTM (one cycle: 7 mLSTM + 1 sLSTM) at S = 64 on a 2 × 2
    fake group: the sLSTM time loop counted once and scaled by its trip
    count gives the step-by-step loop's FLOPs, bytes, collectives (count
    and bytes a kind) and memory (argument, output, temporary and peak
    bytes), exactly."""
    once = repair_runs["loops"][f"{kind}:True"]
    each = repair_runs["loops"][f"{kind}:False"]
    assert once["cost"] == each["cost"]
    assert once["collectives"] == each["collectives"]
    assert once["memory"] == each["memory"]
    assert once["cost"]["flops_per_device"] > 0
