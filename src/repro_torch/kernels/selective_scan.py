"""Selective scan of one Mamba layer: discretisation, diagonal recurrence
and read-out in one pass.

dt, x [B, L, dI] and B, C [B, L, N] (of one dtype: bf16 as the Mamba
layer stages them, or float32), A [dI, N] float32 and an optional starting
state h0 [B, dI, N] (zeros) give, in float32,

    h_t = exp(dt_t · A) ⊙ h_{t−1} + (dt_t · x_t) · B_t,   y_t = Σ_n h_t · C_t,

→ (y [B, L, dI], the state after the last step h_final [B, dI, N]).

The wrapper of ``csrc/selective_scan.cu`` (``repro_selective_scan``): one
launch a call, the [B, L, dI·N] intermediates kept in registers.  It
computes what the Mamba layer's unfused chain computes — exp, the
(dt·x)·B product, row 10 (``ssm_scan``) and the y einsum — so CPU tensors
run that chain (``ref.selective_scan_ref``).  The kernel has no backward:
on CUDA tensors the wrapper raises when grad mode is on and an input
requires grad (the plain version differentiates).

The wrapper splits a channel's N states across 2 or 4 lanes (y summed
with warp shuffles) when B·dI channels alone would leave the card's SMs
under ``FILL_THREADS`` threads each (:func:`lanes_for`): a mesh rank's
dI/4 channels, a small prefill.

Tolerance: the kernel takes the chain's float32 operations in the
chain's order — exp(dt·A), (dt·x) then ·B, the state update as one fused
multiply-add as row 10 compiles it — but sums y's N terms in its own
order; the plain version rounds the state update's product before the
add.  On the card the kernel and the plain version agree within 1e-5 of
max |y| and of max |h_final|.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from . import _build
from . import ref as _ref

__all__ = ["selective_scan", "lanes_for", "KERNEL_STATES", "FILL_THREADS"]

#: state sizes N the CUDA kernel is built for: the configs' reduced 4 and
#: published 16
KERNEL_STATES = (4, 16)
#: threads an SM should hold (16 warps: four a scheduler) before a
#: channel's states are split across lanes
FILL_THREADS = 512


def lanes_for(channels: int, n: int, sms: int) -> int:
    """Lanes sharing one channel's ``n`` states: 1, doubled up to 4 (and
    at most ``n``) while ``channels`` × lanes threads leave ``sms`` SMs
    under :data:`FILL_THREADS` each."""
    lanes = 1
    while lanes < 4 and lanes < n and channels * lanes < sms * FILL_THREADS:
        lanes *= 2
    return lanes


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def selective_scan(dt, x, b, c, A, h0=None):
    """dt, x [B, L, dI], b, c [B, L, N], A [dI, N], h0 [B, dI, N] or None
    (zeros) → (y [B, L, dI], h_final [B, dI, N]), float32."""
    args = (dt, x, b, c, A)
    if not all(isinstance(t, torch.Tensor) for t in args) or dt.dim() != 3 \
            or x.shape != dt.shape:
        raise ValueError("dt and x: expected rank-3 tensors of one shape")
    bsz, length, di = dt.shape
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"A: expected shape ({di}, N), got "
                         f"{tuple(A.shape)}")
    n = A.shape[1]
    for name, t in (("b", b), ("c", c)):
        if tuple(t.shape) != (bsz, length, n):
            raise ValueError(f"{name}: expected shape {(bsz, length, n)}, "
                             f"got {tuple(t.shape)}")
    if h0 is not None and (not isinstance(h0, torch.Tensor)
                           or tuple(h0.shape) != (bsz, di, n)):
        raise ValueError(f"h0: expected shape {(bsz, di, n)}")
    if any(t.device != dt.device for t in args[1:]) or (
            h0 is not None and h0.device != dt.device):
        raise ValueError("dt, x, b, c, A and h0 lie on different devices")
    if dt.device.type == "cpu":
        return _ref.selective_scan_ref(dt, x, b, c, A, h0)
    _build.forbid_grad("selective_scan", dt, x, b, c, A, h0)
    if dt.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dt: expected bfloat16 or float32, got {dt.dtype}")
    for name, t in (("dt", dt), ("x", x), ("b", b), ("c", c)):
        _build.require(t, name, dt.dtype, 3)
    _build.require(A, "A", torch.float32, 2)
    if h0 is not None:
        _build.require(h0, "h0", torch.float32, 3)
    if n not in KERNEL_STATES:
        raise ValueError(f"the CUDA kernel takes N in {KERNEL_STATES}, "
                         f"got {n}")
    if b.data_ptr() % 4 or c.data_ptr() % 4:
        raise ValueError("b and c: the CUDA kernel copies them in 4-byte "
                         "words and needs them 4-byte aligned")
    y = torch.empty((bsz, length, di), dtype=torch.float32, device=dt.device)
    h_final = torch.empty((bsz, di, n), dtype=torch.float32,
                          device=dt.device)
    if bsz * di == 0:
        return y, h_final
    if length == 0:
        h_final.copy_(h0 if h0 is not None else torch.zeros_like(h_final))
        return y, h_final
    lanes = lanes_for(bsz * di, n, _sm_count(dt.device.index))
    _build.launch("selective_scan", "repro_selective_scan", dt.device, dt, x,
                  b, c, A, h0, y, h_final, bsz, length, di, n, lanes,
                  int(dt.dtype == torch.bfloat16))
    return y, h_final
