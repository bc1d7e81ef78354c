"""The benchmark's work formulas: hand counts at the published widths,
and the port's own counter (``launch.dryrun.StepCounter``) at a small
size, where the formula counts what the program computes."""
import pytest
import torch

from bench_h100_tiny import tiny_cell
from bench_h100.harness import flops as F, port, spec, weights
from bench_h100.harness.model import dims

JAMBA = dims(spec.cell("jamba_v0_1_8of32.column").config)
SMOL = dims(spec.cell("smollm_360m.column").config)


def test_hand_counts_at_published_widths():
    # SmolLM-360M: per layer attention 960*64*(15+2*5) + 15*64*960,
    # gated MLP 3*960*2560; 32 layers; the tied head 960*49152
    per = 960 * 64 * 25 + 15 * 64 * 960 + 3 * 960 * 2560
    assert F.matmul_params(SMOL) == 32 * per
    assert F.matmul_params(SMOL) + 960 * 49152 == pytest.approx(
        361.8e6, rel=2e-3)
    # Jamba one period: 7 Mamba, 1 attention, 4 dense MLPs, 4 MoE (top 2)
    mamba = 4096 * 16384 + 8192 * (256 + 32) + 256 * 8192 + 8192 * 4096
    attn = 4096 * 128 * 48 + 32 * 128 * 4096
    mlp = 3 * 4096 * 14336
    moe = 4096 * 16 + 2 * mlp
    assert F.matmul_params(JAMBA) == 7 * mamba + attn + 4 * mlp + 4 * moe
    # causal pairs, and attention FLOPs 4 * B * H * hd * pairs
    assert F.causal_pairs(4, 4) == 10 and F.causal_pairs(1, 5) == 5
    assert F.attention_flops(SMOL, 2, 3, 3) == 4 * 2 * 15 * 64 * 6
    assert F.prefill_flops(SMOL, 10) == (2 * F.matmul_params(SMOL) * 10
                                        + 32 * 4 * 15 * 64 * 55
                                        + 2 * 960 * 49152)
    assert F.train_flops(SMOL, 2, 8) == 3 * F.forward_flops(SMOL, 2, 8)


def test_rooflines():
    b, s = 16, 2000
    fl = 4 * b * 32 * 128 * (s * (s + 1) // 2)
    by = 2 * b * s * 128 * (2 * 32 + 2 * 8)
    assert F.flash_bound_s(JAMBA, b, s) == max(fl / 989e12, by / 3.35e12)
    # the fused selective scan: dt, x, B, C in bf16, y and the final state
    # in float32; exps B·L·dI·N at 4.19e12/s, which bound it at Jamba's
    # prefill [16, 2048, 8192, 16]: 1.026 ms against the bytes' 0.644
    b, s = 16, 2048
    by = 2 * b * s * (2 * 8192 + 2 * 16) + 4 * b * s * 8192 \
        + 4 * b * 8192 * 16
    ex = b * s * 8192 * 16
    assert F.selective_scan_bound_s(JAMBA, b, s) == pytest.approx(
        ex / 4.19e12)
    assert F.selective_scan_bound_s(JAMBA, b, s) * 1e3 == pytest.approx(
        1.026, abs=1e-3)
    assert by / 3.35e12 * 1e3 == pytest.approx(0.644, abs=1e-3)
    # one card's quarter of the channels on the 1 x 4 mesh: 0.256 ms
    assert F.selective_scan_bound_s(JAMBA, b, s, 2048) * 1e3 == \
        pytest.approx(0.256, abs=1e-3)
    # few positions: the bytes bound it
    by = 2 * 4 * 3 * (2 * 8192 + 32) + 4 * 4 * 3 * 8192 + 4 * 4 * 8192 * 16
    assert F.selective_scan_bound_s(JAMBA, 4, 3) == pytest.approx(
        by / 3.35e12)


@pytest.mark.parametrize("cell", ["smollm_360m.column",
                                  "jamba_v0_1_8of32.column"])
def test_formula_equals_the_ports_counter(cell):
    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.ml.transformer import LM
    c = tiny_cell(cell)
    dm = dims(c.config)
    if dm.experts:
        # the counter counts the MoE's dense dispatch; hold the attention
        # and Mamba layers alone
        c.config = dict(c.config, num_experts=0)
        dm = dims(c.config)
    p = weights.make(dm, 1, "cpu", "serve")
    tok = torch.randint(1, dm.vocab, (3, 24))
    if not F.mamba_layers(dm):     # (the training path pads Mamba chunks)
        with StepCounter() as cnt:
            LM(port.arch_config(dm), impl="reference").apply(p, tok)
        assert cnt.flops == F.forward_flops(dm, 3, 24, causal=False)
    with StepCounter() as cnt:
        LM(port.arch_config(dm)).prefill(p, tok)
    assert cnt.flops == F.forward_flops(dm, 3, 24, causal=False,
                                        head_positions=1)
