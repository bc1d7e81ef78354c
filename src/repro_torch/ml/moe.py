"""Mixture-of-Experts layer (GShard-style dense dispatch).

The port of ``repro/ml/moe.py``: top-k routing with
capacity, [G, S, E, C] dispatch/combine tensors in the compute dtype
built from cumulative-position one-hots, and the expert FFNs as batched
einsums (left to PyTorch, as the reference leaves them to XLA).  The
routing is the reference's exactly, drops included: the group size
shrinks until it divides the token count, ``argmax`` takes the first
maximum, positions are cumulative sums in float32, ``combine`` is built
in the compute dtype, and a gate that rounds to 0 there is not
dispatched (``dispatch = combine > 0``).

On a mesh the expert-parallel layout is pinned as the reference pins it
(``ml.sharding.constrain``): experts over ``model`` when E divides it,
else the feature dim; dispatch and combine E-sharded under EP.

Capacity C = max(k, f·S·k/E) per group.  Aux losses: load-balance
(Switch) + router z-loss.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init, gelu, silu
from .sharding import active_mesh, constrain, mesh_sizes

__all__ = ["moe_init", "moe_apply"]


def moe_init(gen: torch.Generator, d: int, f: int, num_experts: int):
    def e_init(din, dout):
        return torch.stack([dense_init(gen, din, dout)
                            for _ in range(num_experts)])

    return {"router": dense_init(gen, d, num_experts),
            "experts": {"w_gate": e_init(d, f), "w_up": e_init(d, f),
                        "w_down": e_init(f, d)}}


def moe_apply(x, p, *, top_k: int, capacity_factor: float = 1.25,
              act: str = "silu", group_size: int = 1024
              ) -> Tuple[torch.Tensor, dict]:
    """x [B, S, D] → (out [B, S, D], aux losses)."""
    b, s, d = x.shape
    e = p["router"].shape[1]
    act_fn = {"silu": silu, "gelu": gelu}[act]
    cdt = x.dtype                                    # compute dtype

    tokens = x.reshape(b * s, d)
    t = tokens.shape[0]
    sg = min(group_size, t)
    while t % sg:
        sg -= 1
    g = t // sg
    cap = int(max(top_k, capacity_factor * sg * top_k / e))
    tok = tokens.reshape(g, sg, d)

    # router: compute-dtype operands, float32 sums (products of two
    # compute-dtype values are exact in float32)
    logits = tok.float() @ p["router"].to(cdt).float()   # [G, S, E]
    gates = torch.softmax(logits, dim=-1)

    combine = torch.zeros((g, sg, e, cap), dtype=cdt, device=x.device)
    used = torch.zeros((g, e), dtype=torch.float32, device=x.device)
    gk = gates
    for _ in range(top_k):
        idx = torch.argmax(gk, dim=-1)                          # [G, S]
        gval = torch.gather(gk, -1, idx[..., None])[..., 0]
        onehot = F.one_hot(idx, e).float()                      # [G, S, E]
        pos = torch.cumsum(onehot, dim=1) - onehot + used[:, None, :]
        in_cap = pos < cap
        posc = torch.clamp(pos, 0, cap - 1).long()
        disp = onehot * in_cap
        combine = combine + ((disp * gval[..., None]).to(cdt)[..., None]
                             * F.one_hot(posc, cap).to(cdt))
        used = used + disp.sum(dim=1)
        gk = gk * (1.0 - onehot)

    dispatch = (combine > 0).to(cdt)

    # pin expert parallelism: groups over data; experts over model when E
    # divides it (EP), else the feature dim shards (TP experts)
    mesh = active_mesh()
    n_model = mesh_sizes(mesh).get("model", 1) if mesh is not None else 1
    ep = e % n_model == 0 and e >= n_model

    def pin(t):                        # [G, E, C, D|F]
        return constrain(t, ("batch", "model", None, None) if ep
                         else ("batch", None, None, "model"))

    def pin_sc(t):                     # [G, S, E, C]
        return constrain(t, ("batch", None, "model", None) if ep
                         else ("batch", None, None, None))

    dispatch = pin_sc(dispatch)
    combine = pin_sc(combine)
    ex_in = pin(torch.einsum("gsec,gsd->gecd", dispatch, tok.to(cdt)))
    we = p["experts"]
    h = act_fn(torch.einsum("gecd,edf->gecf", ex_in, we["w_gate"].to(cdt)))
    h = pin(h * torch.einsum("gecd,edf->gecf", ex_in, we["w_up"].to(cdt)))
    ex_out = pin(torch.einsum("gecf,efd->gecd", h, we["w_down"].to(cdt)))
    # the combine contracts the experts: gathered first, so that the
    # product flattens no dim cut over model (DTensor refuses that view in
    # some torch versions)
    unpin = ("batch", None, None, None)
    out = torch.einsum("gsec,gecd->gsd", constrain(combine, unpin),
                       constrain(ex_out, unpin))

    me = gates.mean(dim=1)                                      # [G, E]
    ce = dispatch.float().sum(dim=(1, 3)) / sg                  # [G, E]
    lb = e * torch.sum(me * ce, dim=-1).mean() / top_k
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return out.reshape(b, s, d), {"load_balance": lb, "router_z": z}
