"""A whole run at a tiny size on the CPU (the look for a card skipped),
with the timed path broken underneath: ``correct`` comes out false for
each fault the cell can have, and true without one; and the control (the
reference in float8 for a served cell, put in the program's place; the
program's bf16-parameter path for a training cell) comes out not correct
on three seeds.

Each tiny cell compares the numbers its full-size cell compares: the
served tokens' gap (the largest for SmolLM; the mean for Jamba, whose
largest gap MoE routing flips swing) and the logits' mean distance from
the reference's, against limits of the tiny cell's own, set from its
readings on seeds 1-3 and 2**31 + 7 (sound: largest gap at most 0.0034,
mean gap at most 0.0099, logits' mean distance at most 0.011 for SmolLM
and 0.080 for Jamba; the float8 control: logits' mean distance at least
0.095 and 0.365)."""
import copy

import pytest
import torch

from bench_h100_tiny import tiny_cell
from bench_h100.harness import runner

SEEDS = (1, 2, 2 ** 31 + 7)
SERVE = {"smollm_360m.column": {"max_logit_gap": 0.02,
                                "logit_err_mean": 0.04},
         "jamba_v0_1_8of32.column": {"mean_logit_gap": 0.04,
                                     "logit_err_mean": 0.2}}
TRAIN_LIMITS = {"loss_gap": 0.01, "grad_norm_gap": 0.05,
                "change_norm_gap": 0.05}


#: a tiny mix with up to 12 new tokens a request, so that a decode
#: state left unchanged has steps to show in
LONGER = {"new_tokens": {"dist": "lognormal", "median": 6, "sigma": 0.5,
                         "min": 2, "max": 12}, "check_batches": 4}


def _run(name, seed, **kw):
    c = tiny_cell(name, **LONGER)
    c.limits = dict(TRAIN_LIMITS) if c.traffic["kind"] == "train" \
        else dict(SERVE[name])
    return runner.run_cell(name, seed, 0.3, False, device="cpu", cell=c,
                           **kw)


@pytest.mark.parametrize("name", sorted(SERVE))
def test_served_sound_and_control(name):
    for seed in SEEDS:
        out = _run(name, seed)
        assert out["correct"], out["checks"]
        out = _run(name, seed, control=True)
        assert not out["correct"], out["checks"]
        for key, limit in SERVE[name].items():
            assert out["readings"][f"program_{key}"] <= limit


def _alter_a_token(monkeypatch):
    from repro_torch.ml.transformer import LM
    real = LM.decode_step

    def decode_step(self, p, tokens, caches, pos):
        logits, caches = real(self, p, tokens, caches, pos)
        logits[0] = torch.roll(logits[0], 1, dims=-1)
        return logits, caches
    monkeypatch.setattr(LM, "decode_step", decode_step)


def _state_unchanged(monkeypatch):
    from repro_torch.ml.transformer import LM
    real = LM.decode_step

    def decode_step(self, p, tokens, caches, pos):
        logits, _ = real(self, p, tokens, copy.deepcopy(caches), pos)
        return logits, caches
    monkeypatch.setattr(LM, "decode_step", decode_step)


@pytest.mark.parametrize("fault", [_alter_a_token, _state_unchanged])
@pytest.mark.parametrize("name", sorted(SERVE))
def test_served_faults_are_not_correct(monkeypatch, fault, name):
    fault(monkeypatch)
    assert not _run(name, 1)["correct"]


def _train_fault(monkeypatch, kind):
    from repro_torch.ml.model import ModelBundle
    real = ModelBundle.make_train_step

    def make_train_step(self):
        step = real(self)

        def broken(params, opt, batch):
            if kind == "half":
                half = batch["tokens"].shape[0] // 2
                return step(params, opt, {k: v[:half]
                                          for k, v in batch.items()})
            _, _, metrics = step(params, opt, batch)
            return params, opt, metrics
        return broken
    monkeypatch.setattr(ModelBundle, "make_train_step", make_train_step)


def test_training_sound_and_control():
    for seed in SEEDS:
        assert _run("smollm_360m.train", seed)["correct"]
        c = tiny_cell("smollm_360m.train")
        c.traffic["train"] = dict(c.traffic["train"], param_dtype="bfloat16")
        c.limits = dict(TRAIN_LIMITS)
        out = runner.run_cell(c.name, seed, 0.3, False, device="cpu", cell=c)
        assert not out["correct"]


@pytest.mark.parametrize("kind", ["unchanged", "half"])
def test_training_faults_are_not_correct(monkeypatch, kind):
    _train_fault(monkeypatch, kind)
    assert not _run("smollm_360m.train", 1)["correct"]
