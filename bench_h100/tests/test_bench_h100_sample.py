"""The serving check's sample: drawn from the seed as the window runs,
with the batch that holds the longest prompt; only the sampled batches
keep the logits the port returned, and the check compares every served
position of them, logits and tokens."""
from bench_h100_tiny import tiny_cell
import numpy as np
import torch

from bench_h100.harness.serve import ServeRun


CELL = tiny_cell("jamba_v0_1_8of32.column")


def _window(seed):
    run = ServeRun(CELL, seed, torch.device("cpu"), False)
    run.setup()
    run.window(0.3)
    return run


def _drive(seed, lengths, k=3):
    """The driver's sample over batches of one prompt of each length."""
    c = tiny_cell("jamba_v0_1_8of32.column", check_batches=k)
    run = ServeRun(c, seed, torch.device("cpu"), False)
    for j, n in enumerate(lengths):
        run.rec.batches.append({"prompts": [np.zeros(n)], "logits": [j]})
        run._sample(j)
    return run


LENGTHS = [5, 9, 7, 12, 3, 12, 8, 6, 4, 10] * 3


def test_sample_is_the_seeds_and_holds_the_longest():
    a, b = _drive(5, LENGTHS), _drive(5, LENGTHS)
    assert a.sample == b.sample and len(a.sample) == 3
    assert a.longest == (12, 3)
    keep = set(a.sample) | {3}
    for j, x in enumerate(a.rec.batches):
        assert (x["logits"] is not None) == (j in keep)
    # a reservoir: every batch of the window as likely as any other
    counts = np.zeros(len(LENGTHS))
    for seed in range(300):
        counts[_drive(seed, LENGTHS).sample] += 1
    assert counts.min() >= 10 and counts.max() <= 55


def test_check_reads_logits_and_tokens():
    run = _window(6)
    out = run.check()
    picks = set(run.sample) | {run.longest[1]}
    want = sum(len(run.rec.batches[j]["prompts"]) * 4 for j in picks)
    assert out["checked_tokens"] == want
    assert out["checked_batches"] == len(picks)
    assert 0 < out["logit_err_mean"] <= out["logit_err_max"]
    assert out["logit_err_mean"] < 0.2
