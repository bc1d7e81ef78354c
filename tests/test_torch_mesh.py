"""The port's ML meshes on four CPU processes (gloo), held to the
one-device port and to the JAX package.

One module fixture starts ``tests/_torch_mesh_worker.py`` as four ranks
of a gloo process group (a ``file://`` rendezvous in the test's temporary
directory, never a fixed port) and reads the results rank 0 writes; each
test below asserts one part of them.  The worker runs, in one process
group:

  * ``make_local_mesh`` for several asks — the shape must be the
    reference's clamp rule with 4 devices — and ``make_production_mesh``,
    which must raise on 4 ranks;
  * a reduced Qwen and a reduced Jamba (expert parallelism, Mamba)
    distributed on 2×2 and 4×1 under plain, ZeRO-1, FSDP and int8 error
    feedback: every leaf placed as its spec says, and each rank's local
    bytes of parameters and optimizer state equal to the specs'
    per-device bytes (``launch.elastic.per_device_bytes``, which
    ``reshard_plan`` sums);
  * two train steps of the reduced Qwen (float32 activations) at data 4,
    2×2, ZeRO-1, FSDP (4×1 and 2×2), sequence parallelism off and
    ``compress_grads``, against the port's one-device step from the same
    parameters and batch (``tests/test_torch_train.py`` holds that step to
    the reference); loss and gradients of a reduced Jamba cut to one block
    cycle on 2×2;
  * a prefill and a decode step on 2×2 with ``cache_shardings``;
  * ``compressed_psum`` over the world and over the data dim of 2×2;
  * ``reshard_plan`` on 1×1 and 1×1 → 2×2;
  * a train state saved on 2×2 and restored on 4×1 (the reference's
    ``test_elastic_restore_with_shardings``), and ``train_loop(mesh=)``
    resumed on another mesh.

Bounds.  A mesh step sums partial products over ranks in another order,
so it differs from the one-device step by float32 rounding only; it is
held as ``chip_smoke.py`` phase 3g holds the card against the CPU: each
step's loss within rtol 1e-4 and grad norm within 1e-3, the first step's
gradients leaf by leaf within 2^-8 of each leaf's largest element, the
first update of every parameter whose gradient is signal (≥ 4·2^-8 of its
leaf's largest, and ≥ 1e-6 after clipping) within 1e-5 and the last
parameters within 2·Σ lr (AdamW moves a parameter whose gradient is
rounding noise by ±lr either way).  The reduced Jamba's Mamba layers
stage the scan inputs in bf16, as the reference does, and a float32 ulp
of the model axis' partial sums can flip one such rounding, which moves
single elements of a small gradient leaf (``A_log``, ``dt_proj``) by more
than 2^-8 of the leaf's largest: as the model is, its loss is held within
rtol 1e-4 and its gradient norm within 1e-3; with the staging in float32
(``mamba.STAGE_DTYPE``), every gradient leaf within 2^-8 of its largest
element as well.  ``compressed_psum`` must equal the
mean of the ranks' dequantized int8 payloads, each quantized with the
reference's ``_quant_int8``, within 1e-6 relative (the mean's order of
sums).  Placements, bytes, restored leaves and cache layouts are exact.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                            # noqa: E402
import jax.numpy as jnp                               # noqa: E402
from jax.sharding import AbstractMesh                 # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch import mesh as jmesh                # noqa: E402
from repro.ml import optim as JO                      # noqa: E402
from repro.ml import sharding as jsh                  # noqa: E402
from repro.ml.transformer import LM as JLM            # noqa: E402

from repro_torch.configs import get_config            # noqa: E402
from repro_torch.launch.elastic import reshard_plan   # noqa: E402
from repro_torch.ml.model import ModelBundle, TrainConfig  # noqa: E402
from repro_torch.ml.sharding import MeshShape         # noqa: E402

WORKER = Path(__file__).resolve().parent / "_torch_mesh_worker.py"
WORLD = 4
TIMEOUT_S = 400
STEP_LOSS_RTOL, STEP_GNORM_RTOL, STEP_GRAD_REL = 1e-4, 1e-3, 2.0 ** -8
STEP_PARAM_ATOL = 1e-5
PSUM_RTOL = 1e-6
STEP_NAMES = ["data4", "2x2", "zero1", "fsdp", "fsdp_2x2",
              "seq_parallel_off", "compress_grads"]
PLACEMENTS = [f"{a}:{m}:{k}" for a in ("qwen1_5_0_5b", "jamba_v0_1_52b")
              for m, k in (("2x2", "plain"), ("4x1", "zero1"),
                           ("2x2", "fsdp"), ("2x2", "compress_grads"))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the four ranks; → rank 0's results."""
    tmp = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(WORLD),
         str(tmp / "rendezvous"), str(tmp)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    codes = [p.returncode for p in procs]
    if any(codes):
        pytest.fail(f"mesh ranks exited {codes}:\n" + "\n".join(
            f"--- rank {r}\n{log[-3000:]}" for r, log in enumerate(logs)))
    with open(tmp / "results.json") as fh:
        return json.load(fh)


def _abstract(shape):
    names = ("pod", "data", "model")[-len(shape):]
    try:
        return AbstractMesh(tuple(shape), names)
    except TypeError:   # jax ≤ 0.4.x
        return AbstractMesh(tuple(zip(names, shape)))


def _ref_per_device(arch, shape, reduced=False, extend=False):
    """The reference's per-device parameter bytes under its specs on an
    abstract mesh (its ``reshard_plan``'s sum)."""
    cfg = jget_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    mesh = _abstract(shape)
    pshape = jax.eval_shape(JLM(cfg).init, jax.random.key(0))
    specs = jsh.param_specs(pshape, mesh)
    if extend:
        specs = jsh.extend_specs(specs, mesh, pshape, "data")
    total = 0.0
    for leaf, spec in zip(jax.tree_util.tree_leaves(pshape),
                          jax.tree_util.tree_leaves(
                              specs, is_leaf=lambda x: isinstance(
                                  x, jax.sharding.PartitionSpec))):
        n = 1
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                n *= mesh.shape[a]
        total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize / n
    return int(total)


# ------------------------------------------------------------------ meshes

def test_local_mesh_clamp_is_the_reference_rule(ranks, monkeypatch):
    """Each ask's mesh shape is what the reference's ``make_local_mesh``
    builds with 4 devices."""
    made = []
    monkeypatch.setattr(jmesh.jax, "devices", lambda: [None] * WORLD)
    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda shape, axes: made.append((shape, axes)))
    for key, (shape, rule, names) in ranks["local_meshes"].items():
        d, m = (int(x) for x in key.split("x"))
        jmesh.make_local_mesh(d, m)
        assert tuple(shape) == tuple(made[-1][0]) == tuple(rule), key
        assert tuple(names) == tuple(made[-1][1]) == ("data", "model")


def test_production_mesh_raises_on_four_ranks(ranks):
    msg = ranks["production_raises"]
    assert msg is not None and "256" in msg and "4" in msg


# --------------------------------------------------- placements and bytes

@pytest.mark.parametrize("key", PLACEMENTS)
def test_placements_and_local_bytes(ranks, key):
    row = ranks["placements"][key]
    assert row["params_placed"] and row["moments_placed"]
    assert row["param_bytes"] == row["want_param_bytes"] \
        == row["plan_param_bytes"]
    assert row["opt_bytes"] == row["want_opt_bytes"]
    # the model axis splits the ranks' bytes evenly: every rank holds as
    # much as rank 0
    assert set(row["every_rank_param_bytes"]) == {row["param_bytes"]}
    if key.startswith("jamba") and ":2x2:" in key:
        # a model axis of 2: the 4 experts and Mamba's dI split over it
        assert row["experts_on_model"] and row["mamba_inner_on_model"]


@pytest.mark.parametrize("key", [k for k in PLACEMENTS
                                 if k.startswith("qwen")])
def test_local_bytes_match_reference_specs(ranks, key):
    """A rank's parameter bytes are the reference's per-device bytes for
    the same reduced config and mesh."""
    arch, mesh, kind = key.split(":")
    shape = tuple(int(x) for x in mesh.split("x"))
    assert ranks["placements"][key]["param_bytes"] == _ref_per_device(
        arch, shape, reduced=True, extend=kind == "fsdp")


# ------------------------------------------------------------- train steps

@pytest.mark.parametrize("name", STEP_NAMES)
def test_mesh_step_matches_one_device(ranks, name):
    row = ranks["steps"][name]
    for a, b in zip(row["mesh"], row["one"]):
        assert abs(a["loss"] - b["loss"]) <= STEP_LOSS_RTOL * abs(b["loss"])
        assert abs(a["grad_norm"] - b["grad_norm"]) <= \
            STEP_GNORM_RTOL * b["grad_norm"]
        assert abs(a["lr"] - b["lr"]) <= 1e-6 * b["lr"]
    assert len(row["mesh"]) == len(row["one"]) == 2
    assert row["grad_max_rel"] <= STEP_GRAD_REL
    assert row["signal_params"] > 0
    assert row["signal_max_abs"] <= STEP_PARAM_ATOL
    assert row["last_param_max_abs"] <= row["reach"]
    assert row["params_placed"]


def test_sequence_parallel_pins_follow_the_flag(ranks):
    """With ``seq_parallel`` the activations are pinned between block
    groups on a mesh with a model axis; without it they are not."""
    steps = ranks["steps"]
    assert steps["2x2"]["seq_pins"] > steps["seq_parallel_off"]["seq_pins"]


def test_jamba_expert_parallel_step(ranks):
    for stage, row in ranks["jamba_step"].items():
        assert abs(row["loss_mesh"] - row["loss_one"]) <= \
            STEP_LOSS_RTOL * abs(row["loss_one"]), stage
        assert abs(row["gnorm_mesh"] - row["gnorm_one"]) <= \
            STEP_GNORM_RTOL * row["gnorm_one"], stage
    assert ranks["jamba_step"]["float32"]["grad_max_rel"] <= STEP_GRAD_REL


def test_prefill_and_decode_on_a_mesh(ranks):
    row = ranks["serving"]
    assert row["caches_placed"]
    assert row["prefill_max_abs"] <= 1e-4
    assert row["same_tokens"]
    # bf16 caches: one rounding of a float32 difference may flip an ulp
    assert row["cache_max_abs"] <= 2.0 ** -7 * 4


# ---------------------------------------------------------- collectives

@pytest.mark.parametrize("group", ["world", "data"])
def test_compressed_psum_against_numpy(ranks, group):
    row = ranks["psum"][group]
    want_ranks = list(range(WORLD)) if group == "world" else [0, 2]
    assert row["ranks"] == want_ranks
    deq = []
    for r in row["ranks"]:
        x = np.random.default_rng(100 + r).normal(size=(8, 16)) \
            .astype(np.float32)
        q, scale = JO._quant_int8(jnp.asarray(x))
        deq.append(np.asarray(q, np.float32) * np.float32(scale))
    want = np.mean(np.stack(deq), axis=0, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(row["got"], np.float32), want,
                               rtol=PSUM_RTOL, atol=PSUM_RTOL * np.abs(
                                   want).max())


def test_compressed_psum_tracks_the_fp32_mean(ranks):
    """As the reference's test: the int8 mean ≈ the float32 mean within
    the quantization error."""
    xs = [np.random.default_rng(100 + r).normal(size=(8, 16))
          .astype(np.float32) for r in range(WORLD)]
    np.testing.assert_allclose(np.asarray(ranks["psum"]["world"]["got"]),
                               np.mean(xs, axis=0), atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------- elastic

def test_reshard_plan_1x1_is_the_reference(ranks):
    from repro.launch.elastic import reshard_plan as jreshard
    from repro.ml.model import ModelBundle as JBundle
    cfg = jget_config("smollm_360m").reduced()
    m1 = jax.make_mesh((1, 1), ("data", "model"))
    want = jreshard(JBundle(cfg, m1), JBundle(cfg, m1))
    got = ranks["reshard_1x1"]
    assert got["ratio"] == pytest.approx(1.0)
    assert got["param_bytes_per_device_before"] > 0
    for k in ("param_bytes_per_device_before",
              "param_bytes_per_device_after", "ratio"):
        assert got[k] == want[k], k
    assert got["from_mesh"] == got["to_mesh"] == {"data": 1, "model": 1}


def test_reshard_plan_to_2x2(ranks):
    got = ranks["reshard_1x1_to_2x2"]
    assert got["param_bytes_per_device_after"] == _ref_per_device(
        "smollm_360m", (2, 2), reduced=True)
    assert got["ratio"] == got["param_bytes_per_device_after"] / \
        got["param_bytes_per_device_before"]


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "jamba_v0_1_52b"])
def test_reshard_plan_16x16_is_the_reference_specs(arch):
    """At full width on the production shapes (no ranks: ``MeshShape``
    bundles), per-device bytes as the reference's specs give them."""
    cfg = get_config(arch)
    small = ModelBundle(cfg, MeshShape((1, 1)), device="cpu")
    pod = ModelBundle(cfg, MeshShape((16, 16)), device="cpu")
    fsdp = ModelBundle(cfg, MeshShape((16, 16)), device="cpu",
                       train_cfg=TrainConfig(fsdp=True))
    plan = reshard_plan(small, pod)
    assert plan["param_bytes_per_device_before"] == _ref_per_device(
        arch, (1, 1))
    assert plan["param_bytes_per_device_after"] == _ref_per_device(
        arch, (16, 16))
    assert reshard_plan(pod, fsdp)["param_bytes_per_device_after"] == \
        _ref_per_device(arch, (16, 16), extend=True)
    assert plan["to_mesh"] == {"data": 16, "model": 16}


def test_elastic_restore_with_shardings(ranks):
    """Saved on 2×2 (ZeRO-1), restored on 4×1 (FSDP): bit-equal, placed
    as the target's specs say; one committed step on disk."""
    row = ranks["elastic"]
    assert row["step"] == 3 and row["step_leaf"] == 3
    assert row["bit_equal"] and row["function_bit_equal"]
    assert row["params_placed"] and row["moments_placed"]
    assert row["files"] == ["step-00000003"]


def test_train_loop_resumes_on_another_mesh(ranks):
    """Steps 2–3 resumed on 4×1 from the 2×2 job's step-2 checkpoint
    repeat that job's steps 2–3 within the mesh-step bounds; rank 0 alone
    prints."""
    row = ranks["train_loop"]
    first = dict((int(s), l) for s, l in row["first"])
    again = dict((int(s), l) for s, l in row["again"])
    assert sorted(first) == [0, 1, 2, 3] and sorted(again) == [2, 3]
    for s in (2, 3):
        assert abs(again[s] - first[s]) <= STEP_LOSS_RTOL * abs(first[s])
    lines_a, lines_b = row["lines_rank"]
    assert lines_b[0] == "resumed from step 2"
    assert len(lines_a) == 4 and len(lines_b) == 3
    assert row["lines_every_rank"][1:] == [[0, 0]] * (WORLD - 1)
    assert row["params_placed"]
