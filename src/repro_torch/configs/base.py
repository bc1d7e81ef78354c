"""Architecture configs (`--arch <id>`): schema + registry.

Each assigned architecture gets one module in this package defining
``CONFIG``; ``get_config(name)`` resolves it.  ``reduced()`` produces the
smoke-test configuration (same family/block pattern, tiny dims) exercised
on CPU; FULL configs are touched only by the dry-run via ShapeDtypeStructs.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field as dc_field, replace
from typing import Dict, Optional, Tuple

__all__ = ["ArchConfig", "ShapeConfig", "get_config", "list_archs",
           "SHAPES", "shape_cells"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | audio | ssm | hybrid | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention features
    attention_pattern: Tuple[str, ...] = ("global",)   # cycles over layers
    window: Optional[int] = None
    qkv_bias: bool = False
    logit_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    mrope: bool = False
    # block types (cycled over layers): attn | mamba | mlstm | slstm
    block_pattern: Tuple[str, ...] = ("attn",)
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1               # MoE MLP every k-th layer (else dense)
    # capacity factor: 1.25 = GShard default (tokens may drop); set to
    # num_experts for dropless routing (exact train↔decode consistency)
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 1024       # dispatch group (S·E·C ∝ f·k·S²)
    # SSM
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    # the Mamba and mLSTM chunk length (the reference's REPRO_SSM_CHUNK)
    ssm_chunk: int = 256
    # enc-dec (whisper)
    encoder_layers: int = 0
    frontend: Optional[str] = None   # audio_stub | vision_stub
    # misc
    pos: str = "rope"                # rope | learned | none
    act: str = "silu"
    act_dtype: str = "bfloat16"      # residual-stream dtype
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    sub_quadratic: bool = False      # eligible for long_500k
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def pattern_len(self) -> int:
        import math
        return max(len(self.block_pattern), len(self.attention_pattern)) \
            if len(self.block_pattern) % len(self.attention_pattern) == 0 \
            or len(self.attention_pattern) % len(self.block_pattern) == 0 \
            else len(self.block_pattern) * len(self.attention_pattern) // \
            math.gcd(len(self.block_pattern), len(self.attention_pattern))

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    def layer_attn_kind(self, i: int) -> str:
        return self.attention_pattern[i % len(self.attention_pattern)]

    def layer_is_moe(self, i: int) -> bool:
        return self.moe_experts > 0 and (i % self.moe_every
                                         == self.moe_every - 1)

    def params_count(self) -> int:
        """Approximate parameter count N (for 6·N·D roofline math)."""
        d, f, hd = self.d_model, self.d_ff, self.hd
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                n += d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                    + self.num_heads * hd * d
            elif kind == "mamba":
                di = self.ssm_expand * d
                r = max(1, d // 16)
                n += d * 2 * di + di * (r + 2 * self.ssm_state) \
                    + r * di + di * self.ssm_conv + di * d
            elif kind == "mlstm":
                di = 2 * d
                dh_m = di // max(self.num_heads, 1)
                n += 2 * d * di + 3 * di * dh_m + di * d
            elif kind == "slstm":
                n += 4 * d * d + 4 * (d // max(self.num_heads, 1)) * d \
                    + d * d + 3 * d * (d * 4 // 3)
            if kind == "attn" or self.family in ("moe", "hybrid"):
                if self.layer_is_moe(i):
                    n += d * self.moe_experts + \
                        3 * self.moe_experts * d * f
                elif f > 0:
                    n += 3 * d * f
        for _ in range(self.encoder_layers):
            n += d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                + self.num_heads * hd * d + 2 * d * f   # gelu mlp (no gate)
        return n

    def active_params_count(self) -> int:
        """MoE: params touched per token (top-k of experts)."""
        if self.moe_experts == 0:
            return self.params_count()
        dense = replace(self, moe_experts=0, moe_top_k=0).params_count()
        moe_layers = sum(1 for i in range(self.num_layers)
                         if self.layer_is_moe(i))
        extra = moe_layers * (3 * self.d_model * self.d_ff
                              * (self.moe_top_k - 1))
        return dense + extra

    def reduced(self) -> "ArchConfig":
        """Smoke-test configuration: same family & patterns, tiny dims."""
        pat = len(self.block_pattern)
        apat = len(self.attention_pattern)
        import math
        cyc = pat * apat // math.gcd(pat, apat)
        layers = max(2 * cyc, 2)
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        return replace(
            self, num_layers=layers, d_model=64,
            num_heads=heads, num_kv_heads=kv, head_dim=16,
            d_ff=128 if self.d_ff else 0, vocab_size=256,
            moe_experts=min(self.moe_experts, 4) if self.moe_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            window=min(self.window, 16) if self.window else None,
            encoder_layers=2 if self.encoder_layers else 0,
            ssm_state=4, ssm_conv=4,
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "qwen1_5_0_5b", "gemma3_12b", "smollm_360m", "command_r_35b",
    "mixtral_8x7b", "llama4_scout_17b_a16e", "whisper_large_v3",
    "xlstm_1_3b", "jamba_v0_1_52b", "qwen2_vl_7b",
]

_ALIASES = {
    "qwen1.5-0.5b": "qwen1_5_0_5b", "gemma3-12b": "gemma3_12b",
    "smollm-360m": "smollm_360m", "command-r-35b": "command_r_35b",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "whisper-large-v3": "whisper_large_v3", "xlstm-1.3b": "xlstm_1_3b",
    "jamba-v0.1-52b": "jamba_v0_1_52b", "qwen2-vl-7b": "qwen2_vl_7b",
}


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def list_archs():
    return list(ARCH_IDS)


def shape_cells(cfg: ArchConfig):
    """The (arch × shape) cells that apply (long_500k gating per DESIGN)."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue
        out.append(s)
    return out
