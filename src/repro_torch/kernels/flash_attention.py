"""Forward flash attention (GQA, causal with a decode offset, sliding
window, tanh soft-capping).

The wrapper of ``csrc/flash_attention.cu``, the port of the TPU kernel
``repro/kernels/flash_attention.py`` ``flash_attention``.  CUDA tensors
launch one of two entries, picked by :func:`kernel_for` from the dtype and
the head dim alone: bfloat16 at head dims 64, 128 and 256 runs on the
tensor cores (``repro_flash_attention_tc``: wgmma products, TMA copies;
64-row blocks of one warpgroup at 64 and 128, 128-row blocks of two
warpgroups sharing each K/V tile at 256), float32 at every head dim and
bfloat16 at 16 and 32 on
the SIMT kernel (``repro_flash_attention_simt``: fp32 products).  Either
counts as one ``flash_attention`` launch.  CPU tensors run the plain version
(``ref.flash_attention_ref``).  All accumulate in float32 and return q's
dtype.  The kernels have no backward: on CUDA tensors the wrapper raises
when grad mode is on and an input requires grad (the plain version
differentiates).

Tolerance: the kernels sum in another order than the plain version and
take their exponentials per 64-key tile (online softmax), so outputs
agree to float32 rounding (3e-3 absolute on unit-normal inputs, as the JAX
package holds its Pallas kernel), and in bfloat16 to 3e-2: one bfloat16
rounding of the output, and on the tensor cores the probabilities' own
bfloat16 rounding before the value product (and the soft-cap's hardware
tanh, about 2^-11 of a logit).  A query row with every key
masked (only possible when Sq > Skv) comes out 0 from either kernel, as
from the TPU kernel, and as the mean of V from the plain version, as from
the JAX reference; the LM never makes one.
"""
from __future__ import annotations

import math

import torch

from . import _build
from . import ref as _ref

__all__ = ["flash_attention", "kernel_for", "HEAD_DIMS",
           "TENSOR_CORE_HEAD_DIMS"]

#: head dims the CUDA kernels are built for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: head dims of the tensor-core kernels (bfloat16 only)
TENSOR_CORE_HEAD_DIMS = (64, 128, 256)
_ENTRIES = {"tensor_core": "repro_flash_attention_tc",
            "simt": "repro_flash_attention_simt"}


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The CUDA kernel a call with q of ``dtype`` and ``head_dim`` runs:
    ``"tensor_core"`` for bfloat16 at head dims 64, 128 and 256, else
    ``"simt"`` (float32 keeps full float32 products: TF32 would break its
    3e-3 tolerance)."""
    if dtype == torch.bfloat16 and head_dim in TENSOR_CORE_HEAD_DIMS:
        return "tensor_core"
    return "simt"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, softcap=None,
                    scale=None) -> torch.Tensor:
    """q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] (Hq % Hkv == 0) →
    [B, Hq, Sq, D] in q's dtype; query i sits at key position
    ``Skv - Sq + i``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4 \
                or not t.is_floating_point():
            raise ValueError(f"{name}: expected a rank-4 float tensor")
    b, hq, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    hkv, skv = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {hq} and {hkv}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window, softcap=softcap,
                                        scale=scale)
    _build.forbid_grad("flash_attention", q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, q.dtype, 4)
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {HEAD_DIMS}, "
                         f"got {d}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale_v = float(scale if scale is not None else 1.0 / math.sqrt(d))
    opts = (int(causal), int(window or 0))
    kernel = kernel_for(q.dtype, d)
    if kernel == "simt":
        opts += (int(q.dtype == torch.bfloat16),)
    elif any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the tensor-core kernel's copies (TMA) need "
                         "16-byte aligned q, k and v")
    _build.launch("flash_attention", _ENTRIES[kernel],
                  q.device, q, k, v, out, b, hq, hkv, sq, skv, d, *opts,
                  scale_v, float(softcap or 0.0))
    return out
