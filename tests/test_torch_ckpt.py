"""The port's checkpoints and train loop on the CPU.

- ``ckpt.checkpoint``: the tests of ``tests/test_checkpoint.py`` (round
  trip, atomic commit, keep-last-k, the async snapshot, restore onto a
  device where the reference restores onto shardings, a missing
  directory), then both directions against the JAX package: a reference
  checkpoint with float32, bfloat16 and integer leaves restored by the
  port bit for bit, and the port's checkpoint of the same tree written in
  the reference's layout (the same npz members, dtypes and bytes, the
  same manifest), which the reference restores.  The reference cannot
  restore a bf16 leaf at all, its own or the port's (numpy loads it as
  ``|V2`` records, which ``jnp.asarray`` refuses: ROADMAP C8), so that
  direction is held on the files.
- ``launch.train.train_loop`` on reduced SmolLM: the loss falls over 30
  steps, and a run resumed from its step-3 checkpoint repeats steps 3–5
  of the uninterrupted run exactly (the same float32 operations on the
  same restored bits, on one CPU), including the data pipeline's state.
"""
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                               # noqa: E402

from repro.ckpt import checkpoint as jckpt            # noqa: E402

from repro_torch.ckpt import (CheckpointManager,      # noqa: E402
                              latest_step, restore_checkpoint,
                              save_checkpoint)
from repro_torch.launch import train as ttrain        # noqa: E402
from repro_torch.ml.optim import tree_leaves          # noqa: E402


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(rng.normal(size=(16, 8))
                                             .astype(np.float32)),
                       "blocks": {"slot0": torch.from_numpy(
                           rng.normal(size=(4, 8)).astype(np.float32))}},
            "step": np.int64(7)}


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t)
    restored, step = restore_checkpoint(str(tmp_path), t)
    assert step == 7
    assert torch.equal(restored["params"]["w"], t["params"]["w"])
    assert int(restored["step"]) == 7


def test_atomic_commit_ignores_partial(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 5, t)
    # a crashed save leaves only a .tmp dir — must be invisible
    os.makedirs(tmp_path / "step-00000009.tmp")
    assert latest_step(str(tmp_path)) == 5
    _, step = restore_checkpoint(str(tmp_path), t)
    assert step == 5


def test_keep_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (10, 20, 30, 40):
        mgr.save(s, t, blocking=True)
    mgr.wait()
    mgr._gc()
    steps = sorted(int(f.split("-")[1]) for f in os.listdir(tmp_path)
                   if f.startswith("step-") and not f.endswith(".tmp"))
    assert steps == [30, 40]


def test_async_save_snapshot_semantics(tmp_path):
    """The snapshot is taken at call time: an in-place update of a CPU
    tensor (whose numpy view would share its memory) while the writer
    runs does not reach the file."""
    t = _tree()
    w_before = t["params"]["w"].clone()
    th = save_checkpoint(str(tmp_path), 1, t, blocking=False)
    t["params"]["w"].zero_()
    th.join()
    restored, _ = restore_checkpoint(str(tmp_path), _tree())
    assert torch.equal(restored["params"]["w"], w_before)


def test_restore_onto_a_device(tmp_path):
    """Restore places tensor leaves on the target device (the reference's
    target shardings), whatever device saved them; numpy leaves stay
    numpy."""
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t)
    restored, _ = restore_checkpoint(str(tmp_path), t, device="cpu")
    assert restored["params"]["w"].device == torch.device("cpu")
    assert isinstance(restored["step"], np.ndarray)
    assert torch.equal(restored["params"]["blocks"]["slot0"],
                       t["params"]["blocks"]["slot0"])
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(str(tmp_path), {**t, "extra": torch.zeros(2)})


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nope"), _tree())


def _mixed(seed=0):
    """One tree as the reference holds it and as the port does."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(6, 5)).astype(np.float32)
    e = rng.normal(size=(3, 4)).astype(np.float32)
    jt = {"params": {"w": jnp.asarray(w),
                     "e": jnp.asarray(e).astype(jnp.bfloat16)},
          "opt": {"adam": {"step": jnp.asarray(3, jnp.int32)}},
          "data": {"seed": np.int64(1), "step": np.int64(4)}}
    tt = {"params": {"w": torch.from_numpy(w),
                     "e": torch.from_numpy(e).to(torch.bfloat16)},
          "opt": {"adam": {"step": torch.tensor(3, dtype=torch.int32)}},
          "data": {"seed": np.int64(1), "step": np.int64(4)}}
    return jt, tt


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jt, tt = _mixed()
    jckpt.save_checkpoint(str(tmp_path), 12, jt)
    got, step = restore_checkpoint(str(tmp_path), tt, device="cpu")
    assert step == 12
    assert got["params"]["e"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["e"].view(torch.int16),
                       tt["params"]["e"].view(torch.int16))
    assert torch.equal(got["params"]["w"], tt["params"]["w"])
    assert got["opt"]["adam"]["step"].dtype == torch.int32
    assert torch.equal(got["opt"]["adam"]["step"], tt["opt"]["adam"]["step"])
    assert int(got["data"]["step"]) == 4


def test_port_checkpoint_in_the_reference_layout(tmp_path):
    jt, tt = _mixed()
    jckpt.save_checkpoint(str(tmp_path / "ref"), 12, jt)
    save_checkpoint(str(tmp_path / "port"), 12, tt)
    files = {}
    for side in ("ref", "port"):
        d = tmp_path / side / "step-00000012"
        assert sorted(os.listdir(d)) == ["MANIFEST.json", "shard-00000.npz"]
        with np.load(d / "shard-00000.npz") as z:
            files[side] = {k: (z[k].dtype.str, z[k].shape, z[k].tobytes())
                           for k in z.files}
        files[side + "_manifest"] = json.loads((d / "MANIFEST.json")
                                               .read_text())
    assert files["port"] == files["ref"]
    assert files["port_manifest"] == files["ref_manifest"]
    assert files["port"]["params__e"][0] == "|V2"
    assert files["port_manifest"]["leaves"]["params/e"]["dtype"] == \
        "bfloat16"
    # the reference restores the port's float32 and integer leaves
    jt32 = {k: v for k, v in jt.items() if k != "params"}
    jt32["params"] = {"w": jt["params"]["w"]}
    tt32 = {k: v for k, v in tt.items() if k != "params"}
    tt32["params"] = {"w": tt["params"]["w"]}
    save_checkpoint(str(tmp_path / "port32"), 2, tt32)
    back, step = jckpt.restore_checkpoint(str(tmp_path / "port32"), jt32)
    assert step == 2
    np.testing.assert_array_equal(np.asarray(back["params"]["w"]),
                                  tt["params"]["w"].numpy())
    assert int(back["opt"]["adam"]["step"]) == 3


# ------------------------------------------------------------- train loop

def _loop(tmp_path, **kw):
    return ttrain.train_loop("smollm_360m", device="cpu", print_fn=lambda
                             *_: None, **kw)


def test_train_loop_loss_falls(tmp_path):
    _, opt, losses = _loop(tmp_path, steps=30, batch=4, seq=64, lr=1e-2,
                           log_every=1)
    assert len(losses) == 30 and int(opt["adam"]["step"]) == 30
    first = np.mean([l for _, l in losses[:3]])
    last = np.mean([l for _, l in losses[-3:]])
    assert np.isfinite(last) and last < first - 0.1


def test_train_loop_resume_repeats_the_run(tmp_path):
    d = str(tmp_path / "ck")
    seen = []
    params, full_opt, full = _loop(tmp_path, steps=6, batch=2, seq=32, log_every=1,
                            ckpt_dir=d, ckpt_every=3,
                            on_step=lambda s, m: seen.append(s))
    assert seen == list(range(6))
    assert latest_step(d) == 6
    # the run "crashed" after its step-3 checkpoint
    shutil.rmtree(os.path.join(d, "step-00000006"))
    msgs = []
    resumed_params, opt, part = ttrain.train_loop(
        "smollm_360m", device="cpu", steps=6, batch=2, seq=32, log_every=1,
        ckpt_dir=d, ckpt_every=3, resume=True, print_fn=msgs.append)
    assert "resumed from step 3" in msgs
    assert [s for s, _ in part] == [3, 4, 5]
    assert part == full[3:]
    assert int(opt["adam"]["step"]) == 6
    # every param and AdamW leaf bit for bit, the step counter's shape too
    for a, b in zip(tree_leaves(resumed_params) + tree_leaves(opt),
                    tree_leaves(params) + tree_leaves(full_opt)):
        assert torch.equal(a, b)
    # the pipeline state went into the checkpoint beside the params
    tree, _ = restore_checkpoint(d, {"data": {"seed": np.int64(0),
                                              "step": np.int64(0)}})
    assert int(tree["data"]["step"]) == 6


def test_train_main_parses_its_flags(tmp_path, capsys):
    ttrain.main(["--arch", "smollm_360m", "--reduced", "--steps", "2",
                 "--batch", "2", "--seq", "16", "--device", "cpu",
                 "--ckpt_dir", str(tmp_path / "m"), "--ckpt_every", "1"])
    out = capsys.readouterr().out
    assert "step     0" in out and "step     1" in out
    assert latest_step(str(tmp_path / "m")) == 2


_ISOLATED = r"""
import json, sys, tempfile
import numpy as np
from repro_torch.launch.train import train_loop
from repro_torch.data.pipeline import TrainingDataset
from repro_torch.geo.denoise import snap_path
d = tempfile.mkdtemp()
train_loop("jamba_v0_1_52b", steps=2, batch=2, seq=16, ckpt_dir=d,
           ckpt_every=1, device="cpu", print_fn=lambda *_: None)
train_loop("jamba_v0_1_52b", steps=3, batch=2, seq=16, ckpt_dir=d,
           ckpt_every=1, resume=True, device="cpu", print_fn=lambda *_: None)
x = np.random.default_rng(0).normal(size=(50, 2))
model, _ = TrainingDataset(x, x.sum(1), ["a", "b"]).fit(
    hidden=4, depth=1, steps=3, batch=8, device="cpu")
model.as_column_model(["a", "b"]).apply_columns({"a": x[:, 0], "b": x[:, 1]})
snap_path(x[:, 0], x[:, 1], x[:3, 0], x[:3, 1], x[:3, 0] + 1, x[:3, 1],
          np.ones(3), 1.0, device="cpu")
print(json.dumps({"modules": sorted(sys.modules)}))
"""


def test_training_paths_import_neither_jax_nor_repro():
    """In a fresh interpreter the train loop with checkpoints and resume,
    the MLP fit and ``snap_path`` run without pulling in jax or any
    module of the JAX package."""
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", _ISOLATED], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    mods = json.loads(out.strip().splitlines()[-1])["modules"]
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    assert {"repro_torch.ckpt.checkpoint", "repro_torch.ml.model",
            "repro_torch.ml.integration", "repro_torch.geo.denoise",
            "repro_torch.data.pipeline"} <= set(mods)
