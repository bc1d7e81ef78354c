"""Diagonal linear recurrence h_t = a_t * h_{t-1} + bx_t (the Mamba inner
scan, state dim folded into the channels).

The wrapper of ``csrc/ssm_scan.cu`` (``repro_ssm_scan``), the port of the
TPU kernel ``repro/kernels/ssm_scan.py`` ``ssm_scan``, with the optional
starting state ``h0`` of ``repro/kernels/ref.py``'s ``ssm_scan_ref`` (the
Mamba layer carries its state across chunks through it).  CUDA tensors
launch the kernel (float32); CPU tensors run the plain version
(``ref.ssm_scan_ref``).  The kernel has no backward: on CUDA tensors the
wrapper raises when grad mode is on and an input requires grad (the plain
version differentiates).

Tolerance: kernel and plain version take the same steps in the same
order, so they differ only where the compiler fuses a multiply-add
(one float32 rounding a step); the JAX package's associative scan
regroups the products, which its tests hold at 3e-4.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["ssm_scan"]


def ssm_scan(a: torch.Tensor, bx: torch.Tensor, h0=None):
    """a, bx [B, L, D], h0 [B, D] or None (zeros) → (h [B, L, D],
    h_final [B, D])."""
    if not isinstance(a, torch.Tensor) or not isinstance(bx, torch.Tensor) \
            or a.dim() != 3 or a.shape != bx.shape:
        raise ValueError("a and bx: expected rank-3 tensors of one shape")
    bsz, length, d = a.shape
    if h0 is not None and (not isinstance(h0, torch.Tensor)
                           or tuple(h0.shape) != (bsz, d)):
        raise ValueError(f"h0: expected shape {(bsz, d)}")
    if a.device != bx.device or (h0 is not None and h0.device != a.device):
        raise ValueError("a, bx and h0 lie on different devices")
    if a.device.type == "cpu":
        return _ref.ssm_scan_ref(a, bx, h0)
    _build.forbid_grad("ssm_scan", a, bx, h0)
    _build.require(a, "a", torch.float32, 3)
    _build.require(bx, "bx", torch.float32, 3)
    if h0 is not None:
        _build.require(h0, "h0", torch.float32, 2)
    h = torch.empty_like(a)
    h_final = torch.empty((bsz, d), dtype=a.dtype, device=a.device)
    if bsz * d == 0:
        return h, h_final
    if length == 0:
        h_final.copy_(h0 if h0 is not None else torch.zeros_like(h_final))
        return h, h_final
    _build.launch("ssm_scan", "repro_ssm_scan", a.device, a, bx,
                  h0, h, h_final, bsz, length, d)
    return h, h_final
