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

On a mesh the layout is the reference's pins: experts over ``model``
when E divides it (EP), else the hidden dim F (TP experts); dispatch and
combine E-sharded under EP.  The routing and the expert FFNs run on each
rank's own pieces through ``local_map`` (routing is per group; the
experts' products are each rank's experts, or its slice of F summed over
``model``), their weight gradients partial over the batch axes.

Capacity C = max(k, f·S·k/E) per group.  Aux losses: load-balance
(Switch) + router z-loss.  While tracing is active the routing counts
``moe.assigned``, ``moe.dispatched`` and ``moe.slots``
(``repro_torch.tracing``).
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import tracing
from .layers import dense_init, gelu, silu
from .sharding import (active_mesh, batch_cut_only, batch_spec, constrain,
                       is_dtensor, mesh_sizes, on_pieces, placements)

__all__ = ["moe_init", "moe_apply"]


def moe_init(gen: torch.Generator, d: int, f: int, num_experts: int):
    def e_init(din, dout):
        return torch.stack([dense_init(gen, din, dout)
                            for _ in range(num_experts)])

    return {"router": dense_init(gen, d, num_experts),
            "experts": {"w_gate": e_init(d, f), "w_up": e_init(d, f),
                        "w_down": e_init(f, d)}}


def _route(tok, router, *, top_k: int, cap: int):
    """Top-k routing with capacity over groups: tok [G, S, D] → (router
    logits and gates [G, S, E] float32, combine and dispatch [G, S, E, C]
    in tok's dtype)."""
    g, sg, _ = tok.shape
    e = router.shape[1]
    cdt = tok.dtype
    # router: compute-dtype operands, float32 sums (products of two
    # compute-dtype values are exact in float32)
    logits = tok.float() @ router.to(cdt).float()        # [G, S, E]
    gates = torch.softmax(logits, dim=-1)

    combine = torch.zeros((g, sg, e, cap), dtype=cdt, device=tok.device)
    used = torch.zeros((g, e), dtype=torch.float32, device=tok.device)
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

    dispatch = combine > 0
    if tracing.active():
        tracing.count("moe.assigned", g * sg * top_k)
        tracing.count("moe.dispatched", dispatch.sum())
        tracing.count("moe.slots", g * e * cap)
    return logits, gates, combine, dispatch.to(cdt)


def _route_on_ranks(tok, router, **kw):
    """:func:`_route`; on a mesh each rank routes its own groups
    (``on_pieces``): the groups cut only over the batch axes, the router
    whole.  Routing is per group, so no collective is needed, and on the
    DTensors DTensor would cut the intermediates' positions over
    ``model`` and flatten them into strided cuts."""
    if not is_dtensor(tok):
        return _route(tok, router, **kw)
    from torch.distributed.tensor import Replicate
    mesh = tok.device_mesh
    tok = batch_cut_only(tok)
    at = list(tok.placements)
    whole = [Replicate()] * mesh.ndim
    return on_pieces(partial(_route, **kw), mesh, (at, whole), (at,) * 4,
                     (at, _partial_where_cut(whole, at)))(tok, router)


def _partial_where_cut(at, x_at):
    """A weight's gradient placements (``at``) from each rank's own pieces
    of an input laid out as ``x_at``: a partial sum over every mesh dim
    that cuts the input's groups (dim 0)."""
    from torch.distributed.tensor import Partial
    return [Partial() if x.is_shard(0) else p for p, x in zip(at, x_at)]


def _experts(ex_in, w_gate, w_up, w_down, *, act_fn):
    """The gated expert FFNs: ex_in [G, E, C, D] → [G, E, C, D]."""
    cdt = ex_in.dtype
    h = act_fn(torch.einsum("gecd,edf->gecf", ex_in, w_gate.to(cdt)))
    h = h * torch.einsum("gecd,edf->gecf", ex_in, w_up.to(cdt))
    return torch.einsum("gecf,efd->gecd", h, w_down.to(cdt))


def _experts_on_ranks(ex_in, we, *, ep: bool, act_fn):
    """:func:`_experts`; on a mesh each rank runs its own pieces through
    ``on_pieces`` — under EP its groups and experts, else (TP experts)
    its groups against its slice of the hidden dim F, the output a
    partial sum over ``model`` — as the reference's pins lay them out
    (on the DTensors the einsums' views go by strides that DTensor does
    not keep in step with the pieces')."""
    ws = (we["w_gate"], we["w_up"], we["w_down"])
    if not is_dtensor(ex_in):
        return _experts(ex_in, *ws, act_fn=act_fn)
    from torch.distributed.tensor import Partial
    mesh = ex_in.device_mesh
    names = list(mesh_sizes(mesh))
    bspec = batch_spec(mesh, ex_in.shape[0])
    if ep:
        x_at = list(placements((bspec, "model"), mesh))
        w_at = [list(placements(("model",), mesh))] * 3
        out_at = x_at
    else:
        x_at = list(placements((bspec,), mesh))
        w_at = [list(placements((None, None, "model"), mesh))] * 2 \
            + [list(placements((None, "model"), mesh))]
        m = names.index("model") if "model" in names else -1
        out_at = [Partial() if i == m and w_at[0][i].is_shard() else p
                  for i, p in enumerate(x_at)]
    return on_pieces(partial(_experts, act_fn=act_fn), mesh, (x_at, *w_at),
                     out_at, (out_at, *(_partial_where_cut(a, x_at)
                                        for a in w_at)))(ex_in, *ws)


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

    logits, gates, combine, dispatch = _route_on_ranks(
        tok, p["router"], top_k=top_k, cap=cap)

    # pin expert parallelism: groups over data; experts over model when E
    # divides it (EP), else the feature dim shards (TP experts)
    mesh = active_mesh()
    n_model = mesh_sizes(mesh).get("model", 1) if mesh is not None else 1
    ep = e % n_model == 0 and e >= n_model

    def pin_sc(t):                     # [G, S, E, C]
        return constrain(t, ("batch", None, "model", None) if ep
                         else ("batch", None, None, None))

    dispatch = pin_sc(dispatch)
    combine = pin_sc(combine)
    ex_in = torch.einsum("gsec,gsd->gecd", dispatch, tok.to(cdt))
    ex_out = _experts_on_ranks(ex_in, p["experts"], ep=ep, act_fn=act_fn)
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
