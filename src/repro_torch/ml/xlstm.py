"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The port of ``repro/ml/xlstm.py`` (arXiv 2405.04517), plain PyTorch as
the reference is plain jnp: no kernel of the port runs here.

mLSTM (§2.3) is a linear-attention-style cell with exponential input
gates and a matrix memory C ∈ ℝ^{dh×dh} per head.  Training and prefill
use the *chunked* parallel form: intra-chunk decayed attention (quadratic
within a chunk of ``chunk`` positions) plus an inter-chunk carry (C, n),
the chunks threaded in order.  Gates are sigmoid forget and clipped-exp
input, the stabiliser folded into the chunk's log-space cumulative sums.
Where grad is on, each chunk runs under ``torch.utils.checkpoint``, as the
reference's ``jax.checkpoint``: backward recomputes the chunk's decay
matrices instead of keeping them.  Decode is the O(1) recurrence.

sLSTM (§2.2) has a scalar memory with recurrent block-diagonal per-head
connections, so it is sequential: a loop over time.  Where grad is on it
runs as one ``autograd.Function`` that keeps each step's state and
recomputes the step in backward (the reference scans a checkpointed
step).  Under the dry-run's counter the loop runs two steps and counts
the rest (``_time_loop``).  The four input projections are one product
each over the whole sequence, in float32.  A gated pf=4/3 MLP follows.

The reference's ``REPRO_SSM_CHUNK`` is ``mlstm_apply``'s ``chunk``
argument here (256 by default), as in ``ml/mamba.py``; the LM passes
``ArchConfig.ssm_chunk``.  On a mesh the
mLSTM chunks run on each rank's pieces through ``local_map`` (the batch
over the batch axes, the heads over ``model`` where they divide it, else
every head on every rank of it), and the sLSTM loop and its output MLP on
each rank's batch rows, whole along D.
"""
from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import dense_init, silu
from .sharding import (batch_cut_only, batch_spec, constrain, is_dtensor,
                       merge_heads, mesh_sizes, on_pieces, placements,
                       unflatten_heads)

__all__ = ["mlstm_init", "mlstm_apply", "mlstm_decode", "mlstm_cache_init",
           "slstm_init", "slstm_apply", "slstm_decode", "slstm_cache_init"]

_I_CLIP = 5.0


def _maybe_checkpoint(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` where grad is on."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _headwise(gen: torch.Generator, num_heads: int, dh: int):
    """Per-head block-diagonal projection [H, dh, dh]."""
    return torch.randn((num_heads, dh, dh), generator=gen,
                       device=gen.device) / math.sqrt(dh)


def _inv_sqrt(dh: int) -> float:
    """1/√dh rounded as the reference rounds it (a float32 square root,
    then a float32 quotient); a float32 value, so a float32 tensor times
    it is exact to the reference's product."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


# ===========================================================================
# mLSTM
# ===========================================================================

def mlstm_init(gen: torch.Generator, d: int, num_heads: int, *,
               pf: int = 2):
    di = pf * d
    dh = di // num_heads
    return {
        "w_upA": dense_init(gen, d, di),        # cell input path
        "w_upB": dense_init(gen, d, di),        # output gate path
        "wq": _headwise(gen, num_heads, dh),
        "wk": _headwise(gen, num_heads, dh),
        "wv": _headwise(gen, num_heads, dh),
        "wi": dense_init(gen, di, num_heads),
        "wf": dense_init(gen, di, num_heads),
        "out_proj": dense_init(gen, di, d),
    }


def _headwise_proj(u, w, num_heads: int):
    """u [B, S, dI] × w [H, dh, dh] → [B, H, S, dh].  A DTensor ``u``
    whose dI is cut into pieces that are not whole heads (4 heads over a
    model axis of 16) is gathered along dI (``unflatten_heads``); ``w``'s
    own cut (its output dh over ``model``) still splits the product."""
    uh = unflatten_heads(u, num_heads)
    return torch.einsum("bshd,hde->bhse", uh, w.to(u.dtype))


def _logsigmoid(x):
    """``F.logsigmoid``; on a DTensor (no partial sum) each rank on its
    own piece (DTensor has no sharding rule for it)."""
    if not is_dtensor(x):
        return F.logsigmoid(x)
    at = list(x.placements)
    return on_pieces(F.logsigmoid, x.device_mesh, (at,), at)(x)


def _mlstm_gates(u, p):
    """u [B, S, dI] → log_f, log_i [B, S, H] (stabilised), in float32.
    On a mesh the raw gates are summed whole over the batch's cut (a
    partial sum would be scattered along the sequence by the clamp)."""
    f_raw = batch_cut_only(u.float() @ p["wf"].float())
    i_raw = batch_cut_only(u.float() @ p["wi"].float())
    return _logsigmoid(f_raw), torch.clamp(i_raw, -_I_CLIP, _I_CLIP)


def _mlstm_qkv(u, p, num_heads: int):
    """Float32 q (scaled), k, v [B, H, S, dh] and gates [B, H, S]."""
    dh = u.shape[-1] // num_heads
    q = _headwise_proj(u, p["wq"], num_heads).float() \
        * _inv_sqrt(dh)
    k = _headwise_proj(u, p["wk"], num_heads).float()
    v = _headwise_proj(u, p["wv"], num_heads).float()
    log_f, log_i = _mlstm_gates(u, p)
    return q, k, v, log_f.transpose(1, 2), log_i.transpose(1, 2)


def _mlstm_chunk(C, n, qq, kk, vv, lf, li):
    """One chunk of c positions: carry (C [B,H,dh,dh], n [B,H,dh]) and
    q/k/v [B,H,c,dh], log gates [B,H,c] → (C', n', h [B,H,c,dh])."""
    c = lf.shape[-1]
    Lf = torch.cumsum(lf, dim=-1)                     # [B,H,c] inclusive
    # intra-chunk decay matrix (log space, lower triangular)
    dmat = Lf[..., :, None] - Lf[..., None, :] + li[..., None, :]
    tri = torch.ones((c, c), dtype=torch.bool, device=lf.device).tril()
    w = torch.exp(torch.where(tri, dmat, torch.full_like(dmat,
                                                         -math.inf)))
    scores = torch.einsum("bhtd,bhsd->bhts", qq, kk) * w
    intra = torch.einsum("bhts,bhsd->bhtd", scores, vv)
    n_intra = torch.einsum("bhts,bhsd->bhtd", w, kk)
    # inter-chunk contribution
    decay_t = torch.exp(Lf)[..., None]                # [B,H,c,1]
    inter = torch.einsum("bhtd,bhde->bhte", qq * decay_t, C)
    n_tot = n_intra + decay_t * n[:, :, None, :]
    denom = torch.clamp(torch.abs(torch.einsum("bhtd,bhtd->bht", qq,
                                               n_tot))[..., None], min=1.0)
    h = (intra + inter) / denom
    # carry update
    decay_end = torch.exp(Lf[..., -1:] - Lf)          # [B,H,c]
    ki = kk * torch.exp(li)[..., None] * decay_end[..., None]
    f_end = torch.exp(Lf[..., -1])
    C_new = f_end[..., None, None] * C + torch.einsum("bhsd,bhse->bhde",
                                                      ki, vv)
    n_new = f_end[..., None] * n + ki.sum(dim=2)
    return C_new, n_new, h


def _mlstm_scan(q, k, v, log_f, log_i, *, chunk: int):
    """The chunks in order from a zero carry: q, k, v [B, H, S, dh] and
    log gates [B, H, S] → (h [B, H, S, dh], C [B, H, dh, dh], n [B, H,
    dh]) after position S."""
    b, nh, s, dh = q.shape
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        log_f = F.pad(log_f, (0, pad))
        log_i = F.pad(log_i, (0, pad), value=-_I_CLIP)
    C = torch.zeros((b, nh, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, nh, dh), dtype=torch.float32, device=q.device)
    hs = []
    for c0 in range(0, s + pad, c):
        cs = slice(c0, c0 + c)
        C, n, h = _maybe_checkpoint(_mlstm_chunk, C, n, q[:, :, cs],
                                    k[:, :, cs], v[:, :, cs],
                                    log_f[:, :, cs], log_i[:, :, cs])
        hs.append(h)
    return torch.cat(hs, dim=2)[:, :, :s], C, n


def _mlstm_scan_on_ranks(q, k, v, log_f, log_i, *, chunk: int):
    """:func:`_mlstm_scan`; on a mesh each rank scans its own pieces
    (``on_pieces``): the batch over the batch axes, the heads over
    ``model`` where their count divides it, else every head on every rank
    of ``model`` (a chunk contracts whole heads' dh; on the DTensors its
    einsums flatten cut dims, which DTensor refuses or propagates as
    strided cuts)."""
    if not is_dtensor(q):
        return _mlstm_scan(q, k, v, log_f, log_i, chunk=chunk)
    mesh = q.device_mesh
    n_model = mesh_sizes(mesh).get("model", 1)
    heads = "model" if n_model > 1 and q.shape[1] % n_model == 0 else None
    at = list(placements((batch_spec(mesh, q.shape[0]), heads), mesh))
    return on_pieces(partial(_mlstm_scan, chunk=chunk), mesh, (at,) * 5,
                     (at,) * 3)(q, k, v, log_f, log_i)


def mlstm_apply(x, p, num_heads: int, *, chunk: int = 256,
                return_state: bool = False):
    """x [B, S, D] → [B, S, D] via chunked decayed linear attention.

    ``return_state`` also returns the decode cache {C, n} after position
    S: padded positions have log_f = 0 (no decay), log_i = −5 and k = v =
    0 (no contribution), so the state is exact.
    """
    b, s, _ = x.shape
    u = silu(x @ p["w_upA"].to(x.dtype))
    og = silu(x @ p["w_upB"].to(x.dtype))
    q, k, v, log_f, log_i = _mlstm_qkv(u, p, num_heads)
    h, C, n = _mlstm_scan_on_ranks(q, k, v, log_f, log_i, chunk=chunk)
    # on a mesh: dI over model as og's
    h = constrain(merge_heads(h.transpose(1, 2)).to(x.dtype),
                  ("batch", None, "model"))
    out = (h * og) @ p["out_proj"].to(h.dtype)
    if return_state:
        return out, {"C": C, "n": n}
    return out


def mlstm_cache_init(batch: int, d: int, num_heads: int, pf: int = 2,
                     device="cuda"):
    di = pf * d
    dh = di // num_heads
    return {"C": torch.zeros((batch, num_heads, dh, dh), device=device),
            "n": torch.zeros((batch, num_heads, dh), device=device)}


def mlstm_decode(x, p, num_heads: int, cache):
    """x [B, 1, D] → (y [B, 1, D], new cache) — the O(1) recurrence."""
    u = silu(x[:, 0] @ p["w_upA"].to(x.dtype))
    og = silu(x[:, 0] @ p["w_upB"].to(x.dtype))
    q, k, v, log_f, log_i = _mlstm_qkv(u[:, None], p, num_heads)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]      # [B, H, dh]
    f = torch.exp(log_f[..., 0])[..., None]           # [B, H, 1]
    i = torch.exp(log_i[..., 0])[..., None]
    C = f[..., None] * cache["C"] + i[..., None] * torch.einsum(
        "bhd,bhe->bhde", k, v)
    n = f * cache["n"] + i * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    denom = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", q, n))[
        ..., None], min=1.0)
    h = merge_heads(num / denom).to(x.dtype)
    return ((h * og) @ p["out_proj"].to(h.dtype))[:, None], {"C": C, "n": n}


# ===========================================================================
# sLSTM
# ===========================================================================

_GATES = ("i", "f", "z", "o")


def slstm_init(gen: torch.Generator, d: int, num_heads: int):
    dh = d // num_heads
    f = d * 4 // 3
    p = {"out_proj": dense_init(gen, d, d),
         "mlp": {"w_gate": dense_init(gen, d, f),
                 "w_up": dense_init(gen, d, f),
                 "w_down": dense_init(gen, f, d)}}
    for g in _GATES:
        p[f"w{g}"] = dense_init(gen, d, d)
        p[f"r{g}"] = _headwise(gen, num_heads, dh)
        p[f"b{g}"] = torch.zeros((d,), device=gen.device)
    return p


def _slstm_step(p, num_heads: int, c, n, h, m, xi, xf, xz, xo):
    """One time step: state (c, n, h, m) and the step's input projections
    (xi, xf, xz, xo), each [B, D] float32 → (c', n', h', m')."""
    hh = unflatten_heads(h, num_heads)

    def rec(r):
        return merge_heads(torch.einsum("bhd,hde->bhe", hh, r.float()))

    hi = xi + rec(p["ri"]) + p["bi"]
    hf = xf + rec(p["rf"]) + p["bf"]
    hz = xz + rec(p["rz"]) + p["bz"]
    ho = xo + rec(p["ro"]) + p["bo"]
    # stabilised exponential gating (paper eq. 15–17)
    m_new = torch.maximum(hf + m, hi)
    i_g = torch.exp(hi - m_new)
    f_g = torch.exp(hf + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(hz)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(ho) * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, h_new, m_new


def _slstm_inputs(x, p):
    """The four gates' input projections over the whole sequence, each
    [B, S, D] in float32."""
    xf32 = x.float()
    return [xf32 @ p[f"w{g}"].float() for g in _GATES]


def _slstm_out_local(h, out_proj, w_gate, w_up, w_down):
    out = h @ out_proj.to(h.dtype)
    dt = out.dtype
    return out + (silu(out @ w_gate.to(dt)) * (out @ w_up.to(dt))) \
        @ w_down.to(dt)


def _slstm_out(h, p):
    """The output projection and the gated pf=4/3 MLP on it.  On a mesh
    each rank runs it whole on its own batch rows (``on_pieces``, the
    weights gathered: the MLP's 4/3·D rarely divides the model axis, and
    a partial sum between its products would be scattered along the
    sequence), the weights' gradients partial over the batch axes that
    cut h."""
    ws = (p["out_proj"], p["mlp"]["w_gate"], p["mlp"]["w_up"],
          p["mlp"]["w_down"])
    if not is_dtensor(h):
        return _slstm_out_local(h, *ws)
    from torch.distributed.tensor import Partial, Replicate
    mesh = h.device_mesh
    h = batch_cut_only(h)
    at = list(h.placements)
    whole = [Replicate()] * mesh.ndim
    grad = [Partial() if x.is_shard(0) else Replicate() for x in at]
    return on_pieces(_slstm_out_local, mesh, (at, *[whole] * 4), at,
                     (at, *[grad] * 4))(h, *ws)


def _state(st):
    return dict(zip(("c", "n", "h", "m"), st))


def _loop_counter():
    """The active dispatch mode that counts one step of a time loop and
    repeats its count for the others (the dry-run's ``StepCounter`` on
    fake tensors), else None: only such a counter skips steps."""
    from torch.utils._python_dispatch import \
        _get_current_dispatch_mode_stack
    for mode in _get_current_dispatch_mode_stack():
        if getattr(mode, "loops_once", False):
            return mode
    return None


def _time_loop(step, carry, order):
    """``carry, kept = step(t, carry)`` for each t of ``order`` → (the
    last carry, each step's ``kept`` tuple in that order).

    Under a counter that counts loops once (``_loop_counter``), the first
    two steps run, the second is counted (``one_step``), and each later
    step is that count again with fresh tensors shaped as its ``kept``
    (``repeat``): FLOPs, bytes and collectives × the trip count, the kept
    bytes live as in the step-by-step loop and each step's transient peak
    above them, as the reference's HLO analysis counts a loop body times
    its trip count.  The carry stays the second step's.  Every step after
    the first must run the same ops on the same shapes."""
    counter = _loop_counter()
    kept = []
    if counter is None or len(order) < 3:
        for t in order:
            carry, k = step(t, carry)
            kept.append(k)
        return carry, kept
    carry, k = step(order[0], carry)
    kept.append(k)
    with counter.one_step() as one:
        carry, k = step(order[1], carry)
    kept.append(k)
    kept.extend(counter.repeat(one, k) for _ in order[2:])
    return carry, kept


#: the recurrent weights and biases one sLSTM step reads
_STEP_WEIGHTS = tuple(f"{w}{g}" for w in "rb" for g in _GATES)


class _SlstmLoop(torch.autograd.Function):
    """The sLSTM time loop where grad is on: forward keeps each step's
    state (c, n, h, m), as a checkpoint a step keeps its inputs; backward
    recomputes the steps from them in reverse, each under its own small
    graph, writes the inputs' gradients a step and sums the weights'.
    Inputs (num_heads, z0, xi, xf, xz, xo [B, S, D] float32, the
    ``_STEP_WEIGHTS``) → (h [B, S, D], the last c, n, m)."""

    @staticmethod
    def forward(ctx, num_heads, z0, *tensors):
        xw, ws = tensors[:4], tensors[4:]
        p = dict(zip(_STEP_WEIGHTS, ws))

        def step(t, st):
            st = _slstm_step(p, num_heads, *st, *(w[:, t] for w in xw))
            return st, st

        st, states = _time_loop(step, (z0,) * 4, range(xw[0].shape[1]))
        ctx.num_heads = num_heads
        ctx.save_for_backward(z0, *tensors, *(t for k in states for t in k))
        return torch.stack([k[2] for k in states], dim=1), st[0], st[1], \
            st[3]

    @staticmethod
    def backward(ctx, g_h, g_c, g_n, g_m):
        saved = ctx.saved_tensors
        z0, xw, ws = saved[0], saved[1:5], saved[5:5 + len(_STEP_WEIGHTS)]
        states = saved[5 + len(_STEP_WEIGHTS):]

        def step(t, carry):
            g_st, g_ws = carry          # the grads of step t's outputs
            prev = states[4 * t - 4:4 * t] if t else (z0,) * 4
            with torch.enable_grad():
                ins = [u.detach().requires_grad_() for u in
                       (*prev, *(w[:, t] for w in xw), *ws)]
                out = _slstm_step(dict(zip(_STEP_WEIGHTS, ins[8:])),
                                  ctx.num_heads, *ins[:8])
                grads = torch.autograd.grad(
                    out, ins, (g_st[0], g_st[1], g_st[2] + g_h[:, t],
                               g_st[3]))
            g_ws = grads[8:] if g_ws is None else tuple(
                a + g for a, g in zip(g_ws, grads[8:]))
            return (grads[:4], g_ws), grads[4:8]

        s = xw[0].shape[1]
        g_last = (g_c, g_n, torch.zeros_like(g_c), g_m)
        (_, g_ws), g_x = _time_loop(step, (g_last, None),
                                    range(s - 1, -1, -1))
        g_x = [torch.stack([k[i] for k in reversed(g_x)], dim=1)
               for i in range(4)]
        return (None, None, *g_x, *g_ws)


def slstm_apply(x, p, num_heads: int, *, return_state: bool = False):
    """x [B, S, D] → [B, S, D] (sequential over time)."""
    s = x.shape[1]
    # on a mesh the time loop's [B, D] state and inputs are whole along D
    # on every rank (only the batch cut): a step splits D into heads, and
    # a cut D's gradients would come back cut into pieces that are not
    # whole heads
    xw = [batch_cut_only(w) for w in _slstm_inputs(x, p)]
    # the zero state as a step's input is: on a mesh cut as the inputs
    # are, so that the first step runs the ops of every other step
    z0 = torch.zeros_like(xw[0][:, 0])
    ws = [p[k] for k in _STEP_WEIGHTS]
    if torch.is_grad_enabled() and any(t.requires_grad for t in xw + ws):
        h, c, n, m = _SlstmLoop.apply(num_heads, z0, *xw, *ws)
        st = (c, n, h[:, -1], m)
    else:
        def step(t, st):
            st = _slstm_step(p, num_heads, *st, *(w[:, t] for w in xw))
            return st, (st[2],)

        st, hs = _time_loop(step, (z0,) * 4, range(s))
        h = torch.stack([k[0] for k in hs], dim=1)
    out = _slstm_out(h.to(x.dtype), p)
    if return_state:
        return out, _state(st)
    return out


def slstm_cache_init(batch: int, d: int, device="cuda"):
    return {k: torch.zeros((batch, d), device=device)
            for k in ("c", "n", "h", "m")}


def slstm_decode(x, p, num_heads: int, cache):
    """x [B, 1, D] → (y [B, 1, D], new cache)."""
    xw = [t[:, 0] for t in _slstm_inputs(x, p)]
    st = _slstm_step(p, num_heads, cache["c"], cache["n"], cache["h"],
                     cache["m"], *xw)
    return _slstm_out(st[2].to(x.dtype), p)[:, None], _state(st)
