"""The benchmark's own work formulas and the card's peaks.

Operations count the multiply-adds of matrix products as 2 each (the
model's FLOPs: a causal attention counts the key positions at or before
each query, an MoE token its top-k experts).  Bytes count each input
read once and each output written once.  They follow the model's
definition, not the port's code, so a later change to the program moves
the time and never the yardstick.
"""
from __future__ import annotations

from .model import Dims

#: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12          # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
#: exponentials a second on the special-function units: 16 a clock an SM,
#: 132 SMs at 1.98 GHz
PEAK_SFU_EXPS = 4.19e12


def layer_matmul_params(dims: Dims, i: int) -> int:
    """Weights of layer ``i`` that one token multiplies (active experts
    only, the router included)."""
    d, f = dims.d, dims.d_ff
    if dims.kinds[i] == "attn":
        n = d * dims.hd * (dims.heads + 2 * dims.kv_heads) \
            + dims.heads * dims.hd * d
    else:
        di, r, s = dims.di, dims.dt_rank, dims.d_state
        n = d * 2 * di + di * (r + 2 * s) + r * di + di * d
    if f > 0:
        if dims.moe[i]:
            n += d * dims.experts + dims.top_k * 3 * d * f
        else:
            n += 3 * d * f
    return n


def matmul_params(dims: Dims) -> int:
    return sum(layer_matmul_params(dims, i) for i in range(dims.layers))


def attn_layers(dims: Dims) -> int:
    return sum(k == "attn" for k in dims.kinds)


def mamba_layers(dims: Dims) -> int:
    return sum(k == "mamba" for k in dims.kinds)


def causal_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs with the key at or before the query, query i at
    key position skv - sq + i."""
    off = skv - sq
    return sq * (off + 1) + sq * (sq - 1) // 2


def attention_flops(dims: Dims, batch: int, sq: int, skv: int,
                    causal: bool = True) -> int:
    """One attention layer's QK^T and PV products."""
    pairs = causal_pairs(sq, skv) if causal else sq * skv
    return 4 * batch * dims.heads * dims.hd * pairs


def prefill_flops(dims: Dims, length: int) -> int:
    """One request's prompt of ``length`` tokens, alone and unpadded,
    with the LM head at its last position."""
    return ((2 * matmul_params(dims) + ssm_flops(dims)) * length
            + attn_layers(dims) * attention_flops(dims, 1, length, length)
            + 2 * dims.d * dims.vocab)


def ssm_flops(dims: Dims) -> int:
    """A token's Mamba output contractions, y_t = C_t . h_t, over every
    Mamba layer (the state's update is elementwise and not counted)."""
    return 2 * dims.di * dims.d_state * mamba_layers(dims)


def forward_flops(dims: Dims, batch: int, seq: int, *, causal: bool = True,
                  head_positions: int = None) -> int:
    """A forward over [batch, seq] with the head at ``head_positions``
    positions a row (all by default)."""
    hp = seq if head_positions is None else head_positions
    return ((2 * matmul_params(dims) + ssm_flops(dims)) * batch * seq
            + attn_layers(dims) * attention_flops(dims, batch, seq, seq,
                                                  causal)
            + 2 * dims.d * dims.vocab * batch * hp)


def train_flops(dims: Dims, batch: int, seq: int) -> int:
    """One training step: forward and backward (3x the forward) over
    [batch, seq], the loss's head at every position; recomputation is not
    counted."""
    return 3 * forward_flops(dims, batch, seq)


# ------------------------------------------------------- kernel rooflines

def roofline_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)


def flash_bound_s(dims: Dims, batch: int, seq: int,
                  elem_bytes: int = 2) -> float:
    """Row 9 over one prefill's attention layer: q, k, v read once and o
    written once ([B, H, S, hd] and [B, Hkv, S, hd]), causal."""
    nbytes = elem_bytes * batch * seq * dims.hd * (2 * dims.heads
                                                   + 2 * dims.kv_heads)
    return roofline_s(attention_flops(dims, batch, seq, seq), nbytes,
                      PEAK_BF16_FLOPS)


def selective_scan_bound_s(dims: Dims, batch: int, seq: int,
                           channels: int = None) -> float:
    """The fused selective scan (``selective_scan_kernel``, one launch a
    Mamba layer's prefill) over ``channels`` of d_inner (all of them, or
    one card's share on a mesh): dt and x [B, L, C] and B and C [B, L, N]
    read in bf16, y [B, L, C] and the final state [B, C, N] written in
    float32; one exponential a state element a position, at the special-
    function units' rate.  The bound is the larger of the two times."""
    c = dims.di if channels is None else channels
    n = dims.d_state
    nbytes = 2 * batch * seq * (2 * c + 2 * n) + 4 * batch * seq * c \
        + 4 * batch * c * n
    return max(batch * seq * c * n / PEAK_SFU_EXPS, nbytes / PEAK_HBM_BYTES)
