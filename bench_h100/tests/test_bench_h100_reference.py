"""The plain references against the port at a tiny size on the CPU: the
served model's prefill and decode logits (the port in float32 activations
here, so that only its bf16 K/V cache and its bf16-staged scan inputs
differ), and the training step's readings."""
import pytest
import torch

from bench_h100_tiny import tiny_cell
from bench_h100.harness import port, runner, weights
from bench_h100.harness.model import dims
from bench_h100.reference.lm import Model


@pytest.mark.parametrize("cell", ["jamba_v0_1_8of32.column",
                                  "smollm_360m.column"])
def test_serving_reference_matches_the_port(cell):
    from repro_torch.ml.transformer import LM
    dm = dims(tiny_cell(cell).config)
    lm = LM(port.arch_config(dm, act_dtype="float32"))
    p = weights.make(dm, 5, "cpu", "train")          # every leaf float32
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(1, dm.vocab, (3, 37), generator=g)
    toks[0, :5] = 0                                   # a left-padded row
    ref = Model(dm, p)
    lg, caches = lm.prefill(p, toks)
    rl, st = ref.prefill(toks)
    scale = rl.abs().max()
    # bf16 K/V and scan inputs in the port: ~2^-8 of the logits' range
    assert (lg[:, 0] - rl).abs().max() <= 0.02 * scale
    cur = torch.argmax(lg, -1).to(torch.int32)
    for t in range(4):
        lg, caches = lm.decode_step(p, cur, caches, 37 + t)
        rl = ref.decode(cur[:, 0], st, 37 + t)
        assert (lg[:, 0] - rl).abs().max() <= 0.02 * scale
        cur = torch.argmax(lg, -1).to(torch.int32)


def test_moe_reference_routes_as_the_port():
    from repro_torch.ml.moe import moe_apply
    dm = dims(tiny_cell("jamba_v0_1_8of32.column").config)
    p = weights.make(dm, 3, "cpu", "train")
    lp = Model(dm, p).layers[1]
    x = torch.randn(4, 24, dm.d, generator=torch.Generator().manual_seed(1))
    want, _ = moe_apply(x, lp["moe"], top_k=dm.top_k, group_size=32)
    got = Model(dm, p).moe(x, lp["moe"])
    assert torch.allclose(got, want, atol=1e-5)


def test_training_reference_matches_the_port():
    c = tiny_cell("smollm_360m.train")
    c.limits = {"loss_gap": 0.01, "grad_norm_gap": 0.05,
                "change_norm_gap": 0.05}
    out = runner.run_cell(c.name, 2 ** 31 + 3, 0.5, False, device="cpu",
                          cell=c)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
