"""The one traffic generator: the same seed gives the same traffic, other
seeds and other calls draw other sizes, the sizes follow the stated
distributions, and a window's work stays steady from seed to seed."""
import math
from statistics import median

import numpy as np

from bench_h100_tiny import ROOT  # noqa: F401  (paths)
from bench_h100.harness import spec, traffic as T

COLUMN = spec.cell("jamba_v0_1_8of32.column").traffic
#: the column mix with replies of lognormal length
REPLIES = dict(COLUMN, new_tokens={"dist": "lognormal", "median": 96,
                                   "sigma": 0.5, "min": 16, "max": 256})


def test_same_seed_same_requests():
    a = T.requests(REPLIES, 65536, 262144, 2 ** 31 + 5, 3)
    b = T.requests(REPLIES, 65536, 262144, 2 ** 31 + 5, 3)
    assert all((x == y).all() and m == n for (x, m), (y, n) in zip(a, b))


def test_seeds_and_calls_draw_other_sizes():
    def sizes(seed, call):
        return sorted(len(p) for p, _ in T.requests(
            REPLIES, 65536, 262144, seed, call))
    assert sizes(11, 0) != sizes(12, 0)
    assert sizes(11, 0) != sizes(11, 1)
    news = {tuple(sorted(m for _, m in T.requests(REPLIES, 65536, 262144,
                                                  seed, 0)))
            for seed in (11, 12)}
    assert len(news) == 2


def test_lengths_follow_the_lognormal():
    spec_ = {"dist": "lognormal", "median": 640, "sigma": 0.6,
             "min": 1, "max": 10 ** 9}
    q = T.draw(spec_, 1001, np.random.default_rng(3))
    assert abs(median(q) - 640) <= 3
    assert abs(np.std(np.log(q)) - 0.6) < 0.02
    rng = np.random.default_rng(4)
    clamped = T.draw(COLUMN["prompt_tokens"], 4096, rng)
    assert clamped.min() >= 128 and clamped.max() == 2048
    # the clamp holds the tail: P(L > 2048) at median 1500, sigma 0.6
    tail = 1 - 0.5 * (1 + math.erf(math.log(2048 / 1500) / 0.6 / 2 ** 0.5))
    assert abs((clamped == 2048).mean() - tail) < 0.02
    assert (T.draw(COLUMN["prompt_tokens"], 64, rng, cap=2044) <= 2044).all()


def test_strata_keep_a_windows_work_steady():
    """Useful tokens of 37 calls of 16 (a window of the Jamba column)
    spread by well under 1% from seed to seed; independent draws of the
    same lengths spread several times more."""
    def work(seed):
        return sum(len(p) for i in range(37)
                   for p, _ in T.requests(COLUMN, 65536, 262144, seed, i))
    sums = np.array([work(s) for s in range(12)])
    assert sums.std() / sums.mean() < 0.005
    rng = np.random.default_rng(0)
    pt = COLUMN["prompt_tokens"]
    iid = np.array([np.clip(np.rint(pt["median"] * np.exp(
        pt["sigma"] * rng.standard_normal(37 * 16))), 128, 2048).sum()
        for _ in range(12)])
    assert iid.std() / iid.mean() > 2 * sums.std() / sums.mean()


def test_prompts_clamped_to_the_context():
    reqs = T.requests(dict(COLUMN, max_batch=64), 49152, 2048, 1, 0)
    assert max(len(p) for p, _ in reqs) == 2044
    assert all(m == 4 for _, m in reqs)
    assert all(p.min() >= 1 and p.max() < 49152 for p, _ in reqs)
    warm = T.longest_call(dict(COLUMN, max_batch=64), 49152, 2048, 1)
    assert len(warm) == 64
    assert all(len(p) == 2044 and m == 3 for p, m in warm)


def test_train_batch_is_tokenpipeline():
    from repro_torch.data.pipeline import TokenPipeline
    pipe = TokenPipeline(49152, 4, 64, seed=2 ** 31 + 9, prefetch=1)
    try:
        want = pipe._make(3)
    finally:
        pipe.close()
    got = T.train_batch(49152, 4, 64, 2 ** 31 + 9, 3)
    assert all((got[k] == want[k]).all() for k in ("tokens", "labels"))
    assert math.isclose((got["labels"][:, :-1] == got["tokens"][:, 1:]).mean(),
                        1.0)
