"""Tiny cells for the CPU tests: the benchmark's own cells with every
width cut, so that a whole run (set-up, window, check) takes seconds."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench_h100.harness import spec  # noqa: E402

TINY_WIDTHS = dict(hidden_size=64, num_attention_heads=4,
                   num_key_value_heads=2, intermediate_size=96,
                   vocab_size=256)


def tiny_cell(name: str, bench: dict = None, **traffic):
    c = spec.cell(name, bench)
    cfg = dict(c.config, **TINY_WIDTHS)
    if "mamba_d_state" in cfg:
        cfg.update(num_experts=4, mamba_dt_rank=4, mamba_d_state=4)
        cfg["assumed"] = dict(cfg["assumed"], ssm_chunk=16,
                              moe_group_size=32)
        if isinstance(cfg.get("deployment"), dict):   # two periods a mesh
            cfg["num_hidden_layers"] = 2 * cfg["attn_layer_period"]
    else:
        cfg.update(num_hidden_layers=2, max_position_embeddings=128)
    c.config = cfg
    t = dict(c.traffic)
    if t["kind"] == "serve":
        t.update(prompt_tokens={"dist": "lognormal", "median": 20,
                                "sigma": 0.6, "min": 8, "max": 40},
                 max_batch=4, check_batches=2)
        if t["new_tokens"]["dist"] != "fixed":
            t["new_tokens"] = {"dist": "lognormal", "median": 6,
                               "sigma": 0.5, "min": 2, "max": 12}
    else:
        t.update(batch=2, seq_len=32)
    t.update(traffic)
    c.traffic = t
    return c
