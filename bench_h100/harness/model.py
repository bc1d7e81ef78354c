"""A configuration file's model, in plain numbers.

``configs/<config>.json`` holds the source's own keys (HuggingFace
``config.json`` names) as the model is run, plus ``assumed``: the sizes
and settings the source does not give and the port needs (the MoE's
capacity factor and dispatch group, the Mamba chunk, the serving dtype).
:class:`Dims` reads them once; the weights, the traffic's clamp, the
work formulas and the references read :class:`Dims`, and only
``harness.port`` turns it into the port's ``ArchConfig``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class Dims:
    name: str
    d: int
    layers: int
    heads: int
    kv_heads: int
    hd: int
    d_ff: int
    vocab: int
    tie: bool
    eps: float
    context: int
    rope_theta: float
    pos: str                     # rope | none
    kinds: Tuple[str, ...]       # one entry a layer: attn | mamba
    moe: Tuple[bool, ...]        # one entry a layer
    experts: int
    top_k: int
    capacity_factor: float
    group_size: int
    d_state: int
    d_conv: int
    expand: int
    dt_rank: int
    ssm_chunk: int

    @property
    def di(self) -> int:
        return self.expand * self.d

    @property
    def period(self) -> int:
        """Layers a group of the port's parameter layout holds: the
        pattern of layer kinds, which the MoE pattern divides."""
        n = self.layers
        for p in range(1, n + 1):
            if n % p == 0 and all(self.kinds[i] == self.kinds[i % p]
                                  and self.moe[i] == self.moe[i % p]
                                  for i in range(n)):
                return p
        return n

    @property
    def groups(self) -> int:
        return self.layers // self.period


def dims(config: dict) -> Dims:
    c = config
    a = c.get("assumed", {})
    n = int(c["num_hidden_layers"])
    if "attn_layer_period" in c:
        per, off = int(c["attn_layer_period"]), int(c["attn_layer_offset"])
        kinds = tuple("attn" if i % per == off else "mamba"
                      for i in range(n))
    else:
        kinds = ("attn",) * n
    experts = int(c.get("num_experts", 0) or 0)
    if experts > 1:
        per = int(c.get("expert_layer_period", 1))
        off = int(c.get("expert_layer_offset", 0))
        moe = tuple(i % per == off for i in range(n))
    else:
        experts, moe = 0, (False,) * n
    d = int(c["hidden_size"])
    heads = int(c["num_attention_heads"])
    return Dims(
        name=c["name"], d=d, layers=n, heads=heads,
        kv_heads=int(c.get("num_key_value_heads", heads)),
        hd=int(c.get("head_dim") or d // heads),
        d_ff=int(c["intermediate_size"]), vocab=int(c["vocab_size"]),
        tie=bool(c.get("tie_word_embeddings", False)),
        eps=float(c["rms_norm_eps"]),
        context=int(c["max_position_embeddings"]),
        rope_theta=float(c.get("rope_theta", 10000.0)),
        pos=a.get("position_encoding", "rope"),
        kinds=kinds, moe=moe, experts=experts,
        top_k=int(c.get("num_experts_per_tok", 0) or 0) if experts else 0,
        capacity_factor=float(a.get("moe_capacity_factor", 1.25)),
        group_size=int(a.get("moe_group_size", 1024)),
        d_state=int(c.get("mamba_d_state", 16)),
        d_conv=int(c.get("mamba_d_conv", 4)),
        expand=int(c.get("mamba_expand", 2)),
        dt_rank=int(c.get("mamba_dt_rank", max(1, d // 16))),
        ssm_chunk=int(a.get("ssm_chunk", 256)))


def moe_groups(tokens: int, group_size: int, experts: int, top_k: int,
               capacity_factor: float):
    """The MoE's dispatch groups over ``tokens`` flattened tokens → (group
    length, capacity): the group shrinks until it divides the tokens, as
    GShard's dispatch groups do in the served model."""
    sg = min(group_size, tokens)
    while tokens % sg:
        sg -= 1
    cap = int(max(top_k, capacity_factor * sg * top_k / experts))
    return sg, cap


def mesh_shape(config: dict) -> Tuple[int, int]:
    """(data, model): the ``("data", "model")`` mesh the configuration's
    ``deployment`` states, (1, 1) for one card."""
    dep = config.get("deployment")
    mesh = dep.get("mesh") if isinstance(dep, dict) else None
    if not mesh:
        return 1, 1
    return int(mesh["data"]), int(mesh["model"])


def on_card(dims: Dims, model: int) -> Dims:
    """What one card of a ``model``-way cut computes of each attention
    layer: its query and KV heads (the port's rules cut heads over the
    model axis)."""
    if model == 1:
        return dims
    return replace(dims, heads=dims.heads // model,
                   kv_heads=max(1, dims.kv_heads // model))


def rows_on_card(batch: int, data: int) -> int:
    """A batch's rows on one card: cut over the data axis where it
    divides, else whole (the port's batch rule)."""
    return batch // data if batch % data == 0 else batch
