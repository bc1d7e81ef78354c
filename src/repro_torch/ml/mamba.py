"""Mamba (selective SSM) block — Jamba's recurrent layer.

The port of ``repro/ml/mamba.py``.  The selective scan solves the
diagonal recurrence h_t = a_t ⊙ h_{t-1} + bx_t, a_t = exp(dt_t·A),
bx_t = (dt_t·x_t)·B_t, and reads out y_t = Σ_n h_t·C_t, on one of two
paths:

  * ``impl="kernel"`` (prefill and serving): one
    ``kernels.ops.selective_scan`` over the whole sequence from a zero
    carry — on CUDA tensors one hand-written kernel a layer that keeps
    the [B, L, dI·N] a, bx and h in registers, in place of the
    reference's chunk loop of jnp passes around the inner scan (its
    Pallas ``ssm_scan`` on the TPU): the same float32 maths, and
    ``chunk`` does not change this path.  It has no backward.
  * ``impl="reference"`` (training): the reference's own *chunked* path,
    the chunks threaded sequentially through a [B, dI, N] carry (live
    memory O(B·chunk·dI·N), as in the reference), each an associative
    scan in the same pairing order as ``jax.lax.associative_scan`` over
    chunks padded to ``chunk`` (a = 1, bx = 0), under
    ``torch.utils.checkpoint`` as at the reference's ``jax.checkpoint``;
    it is differentiable.

On a mesh both paths run on each rank's own dI channels through
``local_map`` (the batch over the batch axes, dI over ``model``, as the
reference pins the carry; one launch a layer on every rank on the kernel
path; no collective).

Decode keeps O(1) state: {h: [B, dI, N], conv: [B, K-1, dI]}, one step in
plain PyTorch.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import ops as kops
from .layers import dense_init, silu
from .sharding import (batch_cut_only, batch_spec, is_dtensor, mesh_sizes,
                       on_pieces, placements)

#: the dtype the chunk inputs are staged in, the reference's
STAGE_DTYPE = torch.bfloat16

__all__ = ["mamba_init", "mamba_apply", "mamba_decode", "mamba_cache_init",
           "associative_scan"]


def mamba_init(gen: torch.Generator, d: int, *, expand: int = 2,
               state: int = 16, conv: int = 4,
               dt_rank: Optional[int] = None):
    di = expand * d
    r = dt_rank or max(1, d // 16)
    dev = gen.device
    return {
        "in_proj": dense_init(gen, d, 2 * di),
        "conv_w": torch.randn((di, conv), generator=gen, device=dev) * 0.1,
        "conv_b": torch.zeros((di,), device=dev),
        "x_proj": dense_init(gen, di, r + 2 * state),
        "dt_proj": dense_init(gen, r, di),
        "dt_bias": torch.zeros((di,), device=dev),
        "A_log": torch.log(torch.arange(1, state + 1, dtype=torch.float32,
                                        device=dev)).repeat(di, 1),
        "D_skip": torch.ones((di,), device=dev),
        "out_proj": dense_init(gen, di, d),
    }


def _left_pad(x, n: int):
    """x [B, S, dI] with ``n`` zero positions in front (a cat, not F.pad:
    on a DTensor cut over dI, F.pad fails or leaves pieces of the wrong
    size in some torch versions)."""
    return torch.cat([torch.zeros_like(x[:, :1]).expand(-1, n, -1), x],
                     dim=1)


def _causal_conv(x, w, b):
    """Depthwise causal conv: x [B, S, dI], w [dI, K].  A bf16 x against
    float32 weights promotes to float32, as in the reference."""
    k = w.shape[1]
    pad = _left_pad(x, k - 1)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + x.shape[1], :] * w[:, i]
    return out + b


def _ssm_params(x1, p):
    """x1 [B, S, dI] → (delta, B_ssm, C_ssm).  On a mesh the small
    projection's partial sum over dI is summed whole over the batch's cut
    (DTensor would scatter it along the sequence)."""
    r = p["dt_proj"].shape[0]
    n = (p["x_proj"].shape[1] - r) // 2
    x_dbl = batch_cut_only(x1 @ p["x_proj"].to(x1.dtype))
    dt_raw, b_ssm, c_ssm = torch.split(x_dbl, [r, n, n], dim=-1)
    delta = F.softplus(dt_raw @ p["dt_proj"].to(dt_raw.dtype)
                       + p["dt_bias"].to(dt_raw.dtype))
    return delta, b_ssm, c_ssm


def _combine(u, w):
    """The reference's scan operator: (a, b) pairs, ``u`` before ``w``."""
    return u[0] * w[0], w[1] + w[0] * u[1]


def _interleave(evens, odds):
    """evens[0], odds[0], evens[1], … along dim 1 (len(evens) is
    len(odds) or one more)."""
    n = odds.shape[1]
    out = torch.stack([evens[:, :n], odds], dim=2).flatten(1, 2)
    if evens.shape[1] > n:
        out = torch.cat([out, evens[:, n:]], dim=1)
    return out


def associative_scan(a, b):
    """Inclusive scan of (a, b) along dim 1 under :func:`_combine`, with
    ``jax.lax.associative_scan``'s pairing (odd/even recursion), so the
    float32 products group as the reference's do."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _scan_chunk(h, xc, dc, bc, cc, A):
    """One chunk of the reference path: bf16-staged inputs, float32
    recurrence → (carry after the chunk, y [B, c, dI])."""
    dc = dc.float()
    a = torch.exp(dc[..., None] * A)                        # [B, c, dI, N]
    bx = (dc * xc.float())[..., None] * bc.float()[:, :, None, :]
    a_sc, b_sc = associative_scan(a, bx)
    hs = b_sc + a_sc * h[:, None]
    y = torch.einsum("bcdn,bcn->bcd", hs, cc.float())
    return hs[:, -1], y


def _reference_scan(dh, x1h, bh, ch, A, *, chunk: int):
    """The reference path's chunk loop: the last chunk padded with a = 1,
    bx = 0 (the carry left as is), each chunk under a checkpoint → (y [B,
    S, dI], final state [B, dI, N])."""
    b, s, _ = dh.shape
    pad = (-s) % chunk
    if pad:
        x1h, dh, bh, ch = (F.pad(t, (0, 0, 0, pad))
                           for t in (x1h, dh, bh, ch))
    h = torch.zeros((b, *A.shape), dtype=torch.float32, device=dh.device)
    ys = []
    for c0 in range(0, s + pad, chunk):
        h, yc = checkpoint(_scan_chunk, h, x1h[:, c0:c0 + chunk],
                           dh[:, c0:c0 + chunk], bh[:, c0:c0 + chunk],
                           ch[:, c0:c0 + chunk], A, use_reentrant=False)
        ys.append(yc)
    return torch.cat(ys, dim=1)[:, :s], h


def _kernel_scan(dh, x1h, bh, ch, A):
    """The kernel path over plain tensors: dh, x1h [B, S, dI], bh, ch [B,
    S, N], A [dI, N] → (y [B, S, dI], final state [B, dI, N]), one
    ``kops.selective_scan`` over the whole sequence from a zero carry."""
    return kops.selective_scan(dh.contiguous(), x1h.contiguous(),
                               bh.contiguous(), ch.contiguous(),
                               A.contiguous())


def _scan_on_ranks(scan, dh, x1h, bh, ch, A):
    """``scan`` (:func:`_kernel_scan` or :func:`_reference_scan` with its
    chunk bound) on DTensors: each rank runs it on its own channels
    (``on_pieces``) — dh, x1h, A and the outputs cut over dI on
    ``model`` (replicated where dI does not divide it), bh and ch whole
    over dI, the batch over the batch axes where it divides.  The
    recurrence is per channel, so it needs no collective; the gradients of
    bh and ch are partial over ``model`` (each rank's channels), A's over
    the batch axes that cut the batch."""
    from torch.distributed.tensor import Partial
    mesh = dh.device_mesh
    n_model = mesh_sizes(mesh).get("model", 1)
    bat = batch_spec(mesh, dh.shape[0])
    di = dh.shape[2]
    chan = "model" if di % n_model == 0 and di >= n_model else None
    at_chan = list(placements((bat, None, chan), mesh))
    at_rows = list(placements((bat, None, None), mesh))
    at_a = list(placements((chan, None), mesh))
    at_h = list(placements((bat, chan, None), mesh))
    g_rows = [Partial() if c.is_shard() and not r.is_shard() else r
              for r, c in zip(at_rows, at_chan)]
    g_a = [Partial() if r.is_shard() else a for a, r in zip(at_a, at_rows)]
    return on_pieces(scan, mesh,
                     (at_chan, at_chan, at_rows, at_rows, at_a),
                     (at_chan, at_h),
                     (at_chan, at_chan, g_rows, g_rows, g_a))(
        dh, x1h, bh, ch, A)


def mamba_apply(x, p, *, chunk: int = 256, return_state: bool = False,
                impl: str = "kernel"):
    """x [B, S, D] → [B, S, D] (training / prefill).

    ``return_state`` additionally returns the decode cache
    {h: [B, dI, N], conv: [B, K-1, dI]} after the last position.
    ``chunk`` sets the reference path's chunks; where it does not divide S
    that path pads the last one with a = 1, bx = 0, which leaves the
    carry as is, as the reference does.  The kernel path scans the whole
    sequence in one call.
    """
    if impl not in ("kernel", "reference"):
        raise ValueError(f"impl {impl!r}: expected 'kernel' or 'reference'")
    b, s, _ = x.shape
    xz = x @ p["in_proj"].to(x.dtype)
    x1_raw, z = torch.chunk(xz, 2, dim=-1)
    x1 = silu(_causal_conv(x1_raw, p["conv_w"], p["conv_b"]))
    delta, b_ssm, c_ssm = _ssm_params(x1, p)
    A = -torch.exp(p["A_log"].float())                     # [dI, N]

    # chunk inputs staged in bf16 as the reference stores them; the
    # recurrence math upcasts to float32
    x1h = x1.to(STAGE_DTYPE)
    dh = delta.to(STAGE_DTYPE)
    bh = b_ssm.to(STAGE_DTYPE)
    ch = c_ssm.to(STAGE_DTYPE)
    scan = partial(_reference_scan, chunk=min(chunk, s)) \
        if impl == "reference" else _kernel_scan
    if is_dtensor(dh):
        y, h = _scan_on_ranks(scan, dh, x1h, bh, ch, A)
    else:
        y, h = scan(dh, x1h, bh, ch, A)
    y = y + p["D_skip"] * x1
    y = y.to(x.dtype) * silu(z)
    out = y @ p["out_proj"].to(y.dtype)
    if return_state:
        k = p["conv_w"].shape[1]
        pre = _left_pad(x1_raw, k - 1)[:, -(k - 1):]
        return out, {"h": h, "conv": pre.float()}
    return out


def mamba_cache_init(batch: int, p, device="cuda"):
    di, k = p["conv_w"].shape
    n = p["A_log"].shape[1]
    return {"h": torch.zeros((batch, di, n), device=device),
            "conv": torch.zeros((batch, k - 1, di), device=device)}


def mamba_decode(x, p, cache):
    """Single token: x [B, 1, D] → (y [B, 1, D], cache)."""
    xz = x[:, 0] @ p["in_proj"].to(x.dtype)
    x1, z = torch.chunk(xz, 2, dim=-1)                     # [B, dI]
    conv_buf = torch.cat([cache["conv"], x1[:, None].to(
        torch.promote_types(x1.dtype, cache["conv"].dtype))], dim=1)
    w = p["conv_w"]
    k = w.shape[1]
    x1c = torch.einsum("bkd,dk->bd", conv_buf[:, -k:], w) + p["conv_b"]
    x1c = silu(x1c)
    delta, b_ssm, c_ssm = _ssm_params(x1c[:, None], p)
    delta, b_ssm, c_ssm = delta[:, 0], b_ssm[:, 0], c_ssm[:, 0]
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(delta.float()[..., None] * A)            # [B, dI, N]
    bx = (delta * x1c).float()[..., None] * b_ssm.float()[:, None, :]
    h = a * cache["h"] + bx
    y = torch.einsum("bdn,bn->bd", h, c_ssm.float())
    y = y + p["D_skip"] * x1c
    y = y.to(x.dtype) * silu(z)
    out = (y @ p["out_proj"].to(y.dtype))[:, None]
    return out, {"h": h, "conv": conv_buf[:, 1:]}
