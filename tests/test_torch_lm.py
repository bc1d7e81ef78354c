"""The port's LM serving path held against the JAX package.

On the CPU the port's kernel wrappers run their plain PyTorch versions.
These tests hold

- the plain ``flash_attention`` and ``ssm_scan`` to the Pallas kernels
  (``interpret=True``) and ``repro/kernels/ref.py``;
- each layer (RoPE, norms, attention, Mamba, MoE) to its JAX counterpart;
- ``LM.prefill`` / ``decode_step`` and ``Server.serve`` to the reference
  ``LM(impl="reference")`` and ``Server``, with the reference's own
  parameters carried over (``ml.params.from_jax_params``);

on the same inputs, made with numpy from a seed.  The CUDA kernels are
held to these plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.

Tolerances: float32 computations agree to float32 rounding (the kernels
1e-3 relative or 3e-3 absolute on unit-normal inputs, as the JAX
package's own kernel tests); the decode caches are bfloat16 in both
packages, so a float32 ulp in a key or query can flip one bf16 rounding
(relative 2^-8 on one element), which bounds decode logits at 2e-3 of
their max in float32.  In bfloat16 the two packages round at different
places (the flash kernel keeps probabilities in float32 where the
reference's chunked attention rounds them; products sum in another
order), so each is a bf16 run away from the float32 answer: the port's
bf16 logits are held within twice the reference's own bf16-to-float32
distance (at least 3e-2 of max |logit|).
"""
import os
import subprocess
import sys
from dataclasses import fields, replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                            # noqa: E402
import jax.numpy as jnp                               # noqa: E402

from repro.configs import get_config as jget_config   # noqa: E402
from repro.configs import list_archs                  # noqa: E402
from repro.kernels import flash_attention as jfa      # noqa: E402
from repro.kernels import ref as jref                 # noqa: E402
from repro.kernels import ssm_scan as jssm            # noqa: E402
from repro.launch.serve import Request as JRequest    # noqa: E402
from repro.launch.serve import Server as JServer      # noqa: E402
from repro.ml import attention as JA                  # noqa: E402
from repro.ml import layers as JLy                    # noqa: E402
from repro.ml import mamba as JMb                     # noqa: E402
from repro.ml import moe as JMoe                      # noqa: E402
from repro.ml.transformer import LM as JLM            # noqa: E402

from repro_torch.configs import get_config           # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops                   # noqa: E402
from repro_torch.kernels import ref as tref           # noqa: E402
from repro_torch.launch import serve as tserve        # noqa: E402
from repro_torch.ml import attention as TA            # noqa: E402
from repro_torch.ml import layers as TLy              # noqa: E402
from repro_torch.ml import mamba as TMb               # noqa: E402
from repro_torch.ml import moe as TMoe                # noqa: E402
from repro_torch.ml.params import (from_jax_params,   # noqa: E402
                                   storage_dtype, tree_map)
from repro_torch.ml.transformer import LM             # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"

#: every decoder-only config of attention, Mamba and MoE blocks (xLSTM
#: and Whisper are held in tests/test_torch_models.py)
PORTED = ["qwen1_5_0_5b", "gemma3_12b", "smollm_360m", "command_r_35b",
          "mixtral_8x7b", "llama4_scout_17b_a16e", "jamba_v0_1_52b",
          "qwen2_vl_7b"]


def _np(x):
    return np.asarray(x, np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _params(tree):
    """A JAX parameter tree as float32 CPU tensors."""
    return tree_map(lambda a, _: _t(np.asarray(a)),
                    jax.tree_util.tree_map(np.asarray, tree))


#: the port's config fields that stand for the reference's environment
#: knobs, with the knob's default (``REPRO_SSM_CHUNK``)
PORT_KNOBS = {"ssm_chunk": 256}


def _fields(cfg):
    """A config's fields, the port's knob fields left out."""
    return {f.name: getattr(cfg, f.name) for f in fields(cfg)
            if f.name not in PORT_KNOBS}


def _rel(got, want):
    return float(np.abs(_np(got) - _np(want)).max()
                 / (np.abs(_np(want)).max() + 1e-6))


# ------------------------------------------------------ flash attention

def _fa_inputs(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)), rng.normal(size=(b, hkv, skv, d)),
            rng.normal(size=(b, hkv, skv, d)))


FA_CASES = [
    ((2, 4, 2, 128, 128, 64), {}),       # GQA causal
    ((1, 2, 1, 256, 256, 64), {}),
    ((1, 8, 8, 64, 64, 128), {}),        # MHA
    ((1, 2, 1, 100, 200, 64), {}),       # ragged + decode offset
    ((1, 4, 2, 1, 384, 64), {}),         # single-token decode
    ((1, 2, 1, 256, 256, 64), {"window": 64}),
    ((1, 2, 2, 128, 128, 64), {"softcap": 30.0}),
    ((1, 2, 1, 192, 192, 64), {"window": 50, "softcap": 20.0}),
    # Whisper's modes: encoder self-attention (non-causal, Sq = Skv not a
    # multiple of the block) and cross-attention (Sq ≠ Skv, no mask)
    ((1, 4, 4, 150, 150, 64), {"causal": False}),
    ((2, 4, 4, 37, 150, 64), {"causal": False}),
    # Gemma 3's head dim 256 (the hd-256 tensor-core kernel's): GQA 4/2
    # heads, Sq ≠ Skv, window 100 with softcap 50, and no window
    ((1, 4, 2, 100, 300, 256), {"window": 100, "softcap": 50.0}),
    ((1, 4, 2, 130, 200, 256), {"softcap": 50.0}),
]


@pytest.mark.parametrize("shape,kw", FA_CASES)
def test_flash_attention_plain_vs_pallas(shape, kw):
    q, k, v = _fa_inputs(sum(shape), *shape)
    got = ops.flash_attention(_t(q), _t(k), _t(v), **kw)
    pallas = jfa.flash_attention(_j(q), _j(k), _j(v), interpret=True,
                                 block_q=64, block_k=128, **kw)
    want = jref.flash_attention_ref(_j(q), _j(k), _j(v), **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(_np(got), _np(want), rtol=3e-3, atol=3e-3)


def test_flash_attention_plain_vs_pallas_bf16():
    q, k, v = _fa_inputs(7, 1, 2, 1, 128, 128, 64)
    got = ops.flash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                              _t(v, torch.bfloat16))
    pallas = jfa.flash_attention(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                                 _j(v, jnp.bfloat16), interpret=True,
                                 block_q=64, block_k=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got.float()), _np(pallas), rtol=3e-2,
                               atol=3e-2)


class _Recorded(Exception):
    pass


def _whisper_encoder_qkv(monkeypatch):
    """q, k, v of the first encoder layer of Whisper large-v3 at full width
    (one encoder and one decoder layer) over frame embeddings [1, 1500,
    1280] from a seed: the call phase 3e of ``chip_smoke.py`` records."""
    cfg = replace(get_config("whisper_large_v3"), encoder_layers=1,
                  num_layers=1)
    lm = LM(cfg)
    params = lm.init(seed=0, device="cpu")
    frames = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 1500, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    seen = []

    def record(q, k, v, **kw):
        seen.append((q, k, v, kw))
        raise _Recorded

    monkeypatch.setattr(tfa, "flash_attention", record)
    with pytest.raises(_Recorded), torch.inference_mode():
        lm.encode(params, frames)
    q, k, v, kw = seen[0]
    assert not kw["causal"] and q.shape == (1, 20, 1500, 64)
    return q, k, v


@pytest.mark.parametrize("source", ["randn", "whisper_encoder"])
def test_flash_tolerance_rejects_a_dropped_key_tile(source, monkeypatch):
    """``ref.flash_tolerance``, the bound the card holds flash_attention
    to, at Whisper's encoder shape (1500 = 23 × 64 + 28 keys): the
    tensor-core kernel's arithmetic (P rounded to bf16 before P·V, the
    output rounded once) passes it; a kernel that skips the last, partial
    key tile fails it on over a third of the elements."""
    if source == "randn":
        rng = np.random.default_rng(20)
        q, k, v = (torch.from_numpy(rng.normal(size=(1, 20, 1500, 64))
                                    .astype(np.float32)).to(torch.bfloat16)
                   for _ in range(3))
    else:
        q, k, v = _whisper_encoder_qkv(monkeypatch)
    want = tref.flash_attention_ref(q, k, v, causal=False)
    atol, rtol = tref.flash_tolerance(want)
    w = want.float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / 8.0
    e = torch.exp(s - s.amax(-1, keepdim=True))
    like = (torch.einsum("bhqk,bhkd->bhqd", e.bfloat16().float(), v.float())
            / e.sum(-1, keepdim=True)).bfloat16()
    torch.testing.assert_close(like.float(), w, atol=atol, rtol=rtol)
    kept = 1500 // 64 * 64
    dropped = tref.flash_attention_ref(q, k[:, :, :kept], v[:, :, :kept],
                                       causal=False).float()
    outside = (dropped - w).abs() > atol + rtol * w.abs()
    assert float(outside.float().mean()) > 1 / 3


def test_flash_attention_fully_masked_row_is_mean_of_v():
    """Sq > Skv puts the first queries before every key: the plain
    version gives those rows the mean of V, as the JAX reference (the
    CUDA kernel gives 0, as the Pallas kernel — see test_torch_cuda)."""
    q, k, v = _fa_inputs(3, 1, 2, 1, 12, 8, 16)
    got = ops.flash_attention(_t(q), _t(k), _t(v))
    want = jref.flash_attention_ref(_j(q), _j(k), _j(v))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got)[0, :, 0], np.broadcast_to(
        v[0, 0].mean(0), (2, 16)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("head_dim", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_dispatch(dtype, head_dim):
    """The CUDA kernel a call runs is a function of (dtype, head dim)
    alone: bfloat16 at head dims 64, 128 and 256 on the tensor cores, the
    rest (float32 everywhere, bf16 at 16/32) on the SIMT kernel."""
    want = ("tensor_core" if dtype == torch.bfloat16
            and head_dim in (64, 128, 256) else "simt")
    assert tfa.kernel_for(dtype, head_dim) == want


def test_flash_attention_rejects_bad_inputs():
    q = torch.zeros(1, 3, 4, 16)
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 2, 4, 16),
                            torch.zeros(1, 2, 4, 16))      # 3 % 2 != 0
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 3, 4, 8),
                            torch.zeros(1, 3, 4, 8))       # head dims


# ------------------------------------------------------------- SSM scan

@pytest.mark.parametrize("b,l,d", [(2, 64, 32), (1, 500, 130),
                                   (3, 1024, 16), (1, 7, 260)])
def test_ssm_scan_plain_vs_pallas(b, l, d):
    rng = np.random.default_rng(l)
    a = rng.uniform(0.5, 1.0, (b, l, d))
    bx = rng.normal(size=(b, l, d))
    h0 = rng.normal(size=(b, d))
    hg, hTg = ops.ssm_scan(_t(a), _t(bx))
    hp, hTp = jssm.ssm_scan(_j(a), _j(bx), interpret=True, chunk=128)
    np.testing.assert_allclose(_np(hg), _np(hp), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(_np(hTg), _np(hTp), rtol=3e-4, atol=3e-4)
    # with a starting state: against the JAX reference's h0
    hg, hTg = ops.ssm_scan(_t(a), _t(bx), _t(h0))
    hr, hTr = jref.ssm_scan_ref(_j(a), _j(bx), _j(h0))
    np.testing.assert_allclose(_np(hg), _np(hr), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(_np(hTg), _np(hTr), rtol=3e-4, atol=3e-4)


def test_ssm_scan_chunks_carry_through_h0():
    """Two chunks with the first's final state as the second's h0 equal
    one scan over both."""
    rng = np.random.default_rng(5)
    a = _t(rng.uniform(0.2, 1.0, (2, 40, 9)))
    bx = _t(rng.normal(size=(2, 40, 9)))
    h, hT = ops.ssm_scan(a, bx)
    h1, c1 = ops.ssm_scan(a[:, :17].contiguous(), bx[:, :17].contiguous())
    h2, c2 = ops.ssm_scan(a[:, 17:].contiguous(), bx[:, 17:].contiguous(),
                          c1)
    torch.testing.assert_close(torch.cat([h1, h2], 1), h, rtol=0, atol=0)
    torch.testing.assert_close(c2, hT, rtol=0, atol=0)


# ------------------------------------------------------ selective scan

def _chain(dt, x, b, c, A, h0, chunk):
    """The Mamba layer's unfused chain in chunks of ``chunk``: exp(dt·A),
    (dt·x)·B, ``ssm_scan_ref`` from the carry, y = Σ_n h·C."""
    bsz, s, di = dt.shape
    n = A.shape[1]
    h, ys = h0.reshape(bsz, di * n), []
    for c0 in range(0, s, chunk):
        dc, xc = dt[:, c0:c0 + chunk].float(), x[:, c0:c0 + chunk].float()
        bc, cc = b[:, c0:c0 + chunk].float(), c[:, c0:c0 + chunk].float()
        cl = dc.shape[1]
        a = torch.exp(dc[..., None] * A)
        bx = (dc * xc)[..., None] * bc[:, :, None, :]
        hs, h = tref.ssm_scan_ref(a.reshape(bsz, cl, di * n),
                                  bx.reshape(bsz, cl, di * n), h)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs.view(bsz, cl, di, n),
                               cc))
    return torch.cat(ys, dim=1), h.view(bsz, di, n)


def _scan_inputs(seed, b, s, di, n):
    """bf16-staged dt (softplus-sized), x, B, C and A = -exp(A_log) as
    the Mamba layer hands them over."""
    rng = np.random.default_rng(seed)
    dt = _t(np.log1p(np.exp(rng.normal(-1.0, 1.0, (b, s, di)))),
            torch.bfloat16)
    x, bm, cm = (_t(rng.normal(size=shape), torch.bfloat16)
                 for shape in ((b, s, di), (b, s, n), (b, s, n)))
    A = -torch.exp(_t(np.log(np.arange(1, n + 1)) + rng.normal(
        0, 0.1, (di, n))))
    return dt, x, bm, cm, A


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("s", [1, 37, 300])
def test_selective_scan_plain_vs_chunked_chain(s, n):
    """The plain selective scan equals the unfused chain, in one pass and
    in chunks of 16 (neither the tile nor 256 divides 37 or 300), from a
    nonzero h0 and from zeros: y and h_final."""
    dt, x, bm, cm, A = _scan_inputs(s + n, 2, s, 24, n)
    h0 = _t(np.random.default_rng(n).normal(size=(2, 24, n)))
    for start in (h0, torch.zeros_like(h0)):
        y, hT = ops.selective_scan(dt, x, bm, cm, A,
                                   start if start.any() else None)
        for chunk in (s, 16):
            wy, whT = _chain(dt, x, bm, cm, A, start, chunk)
            torch.testing.assert_close(y, wy, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(hT, whT, rtol=1e-6, atol=1e-6)
    assert y.dtype == hT.dtype == torch.float32
    assert y.shape == (2, s, 24) and hT.shape == (2, 24, n)


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("s", [1, 37, 300])
def test_selective_scan_layer_vs_jax_mamba_apply(s, n):
    """Through the Mamba layer, whose kernel path is one selective_scan:
    the output and the final state against the JAX package's
    ``mamba_apply`` (chunks of 256, the last one padded)."""
    jp, tp = _mamba(state=n)
    x = np.random.default_rng(s).normal(size=(2, s, 32))
    want, jst = JMb.mamba_apply(_j(x), jp, chunk=256, return_state=True)
    ops.reset_launch_counts()
    got, tst = TMb.mamba_apply(_t(x), tp, chunk=256, return_state=True)
    assert ops.launch_counts() == {"selective_scan": 1}
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tst["h"]), _np(jst["h"]), rtol=1e-4,
                               atol=1e-4)


def test_selective_scan_checks_its_arguments():
    dt, x, bm, cm, A = _scan_inputs(0, 2, 5, 8, 4)
    with pytest.raises(ValueError, match="dt and x"):
        ops.selective_scan(dt, x[:, :4], bm, cm, A)
    with pytest.raises(ValueError, match="A"):
        ops.selective_scan(dt, x, bm, cm, A[:7])
    with pytest.raises(ValueError, match="c"):
        ops.selective_scan(dt, x, bm, cm[:, :, :3], A)
    with pytest.raises(ValueError, match="h0"):
        ops.selective_scan(dt, x, bm, cm, A, torch.zeros(2, 8, 3))
    y, hT = ops.selective_scan(dt[:, :0], x[:, :0], bm[:, :0], cm[:, :0], A)
    assert y.shape == (2, 0, 8) and not hT.any()


@pytest.mark.parametrize("channels,n,sms,lanes", [
    (16 * 8192, 16, 132, 1),     # Jamba's column prefill: one lane
    (16 * 2048, 16, 132, 4),     # a 1 x 4 mesh rank's dI / 4
    (4 * 8192, 16, 132, 4),      # a prefill of 4 rows
    (8 * 8192, 16, 132, 2),
    (2 * 64, 4, 132, 4),
    (2 * 64, 2, 132, 2),         # never more lanes than states
    (132 * 512, 16, 132, 1)])
def test_selective_scan_lanes_follow_the_shape(channels, n, sms, lanes):
    from repro_torch.kernels import selective_scan as sel
    assert sel.lanes_for(channels, n, sms) == lanes


# --------------------------------------------------------------- layers

def test_configs_match_the_reference():
    for arch in list_archs():
        want, got = jget_config(arch), get_config(arch)
        assert _fields(got) == _fields(want), arch
        assert _fields(got.reduced()) == _fields(want.reduced()), arch
        assert got.params_count() == want.params_count()
        for name, default in PORT_KNOBS.items():
            assert getattr(got, name) == default, (arch, name)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_and_mrope(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 9, 16))
    pos = np.stack([np.arange(9) + 5, np.arange(9) * 3]).astype(np.int32)
    got = TLy.rope(_t(x), torch.from_numpy(pos), theta)
    want = JLy.rope(_j(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    pos3 = np.stack([pos, pos + 1, pos * 2])
    got = TLy.mrope(_t(x), torch.from_numpy(pos3), theta)
    want = JLy.mrope(_j(x), jnp.asarray(pos3), theta)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_norms_and_activations():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 32)) * 3
    p = {"scale": rng.normal(size=32), "bias": rng.normal(size=32)}
    tp = {k: _t(v) for k, v in p.items()}
    jp = {k: _j(v) for k, v in p.items()}
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                         (torch.bfloat16, jnp.bfloat16, 1e-2)):
        got = TLy.rms_norm(_t(x, dt), tp)
        assert got.dtype == dt
        np.testing.assert_allclose(_np(got.float()),
                                   _np(JLy.rms_norm(_j(x, jdt), jp)),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(TLy.layer_norm(_t(x, dt), tp).float()),
                                   _np(JLy.layer_norm(_j(x, jdt), jp)),
                                   rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(TLy.gelu(_t(x))), _np(JLy.gelu(_j(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(TLy.silu(_t(x))), _np(JLy.silu(_j(x))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window,softcap,bias", [(None, None, True),
                                                 (6, 30.0, False)])
def test_attn_apply_prefill_and_decode(window, softcap, bias):
    spec_kw = dict(qkv_bias=bias, window=window, softcap=softcap)
    jspec = JA.AttnSpec(32, 4, 2, 8, **spec_kw)
    tspec = TA.AttnSpec(32, 4, 2, 8, **spec_kw)
    jp = JA.attn_init(jax.random.key(3), jspec)
    if bias:
        jp = {k: (v + 0.1 if k.endswith("bias") else v)
              for k, v in jp.items()}
    tp = _params(jp)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 11, 32))
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    want, _ = JA.attn_apply(_j(x), jp, jspec, jnp.asarray(pos))
    got, _ = TA.attn_apply(_t(x), tp, tspec, torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    # decode one token against a cache holding 10 positions (rolling when
    # windowed: the cache holds the window, written modulo)
    rolling = window is not None
    smax = window if rolling else 16
    kc = rng.normal(size=(2, 2, smax, 8))
    vc = rng.normal(size=(2, 2, smax, 8))
    xt = rng.normal(size=(2, 1, 32))
    pt = np.full((2, 1), 10, np.int32)
    jc = {"k": _j(kc, jnp.bfloat16), "v": _j(vc, jnp.bfloat16),
          "len": jnp.asarray(10, jnp.int32)}
    tc = {"k": _t(kc, torch.bfloat16), "v": _t(vc, torch.bfloat16),
          "len": 10}
    want, jc = JA.attn_apply(_j(xt), jp, jspec, jnp.asarray(pt), cache=jc,
                             rolling=rolling)
    got, tc = TA.attn_apply(_t(xt), tp, tspec, torch.from_numpy(pt),
                            cache=tc, rolling=rolling)
    assert tc["len"] == int(jc["len"]) == 11
    np.testing.assert_array_equal(_np(tc["k"].float()), _np(jc["k"]))
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-3, atol=2e-3)


def _mamba(d=32, state=4):
    jp = JMb.mamba_init(jax.random.key(5), d, state=state)
    jp = dict(jp, conv_b=jp["conv_b"] + 0.05, dt_bias=jp["dt_bias"] - 0.5)
    return jp, _params(jp)


@pytest.mark.parametrize("s,chunk", [(40, 16), (16, 256), (3, 2)])
def test_mamba_apply_and_state(s, chunk):
    jp, tp = _mamba()
    x = np.random.default_rng(s).normal(size=(2, s, 32))
    want, jst = JMb.mamba_apply(_j(x), jp, chunk=chunk, return_state=True)
    got, tst = TMb.mamba_apply(_t(x), tp, chunk=chunk, return_state=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    for key in ("h", "conv"):
        assert tst[key].shape == jst[key].shape
        np.testing.assert_allclose(_np(tst[key]), _np(jst[key]), rtol=1e-4,
                                   atol=1e-4)


def test_mamba_apply_launches_one_scan_a_chunk():
    """The kernel path scans the whole sequence in one selective_scan a
    layer whatever the chunk (row 10, ``ssm_scan``, is not called); the
    reference path launches nothing."""
    jp, tp = _mamba()
    for chunk in (8, 256):
        ops.reset_launch_counts()
        TMb.mamba_apply(_t(np.ones((1, 37, 32))), tp, chunk=chunk)
        assert ops.launch_counts() == {"selective_scan": 1}
    ops.reset_launch_counts()
    TMb.mamba_apply(_t(np.ones((1, 37, 32))), tp, chunk=8, impl="reference")
    assert ops.launch_counts() == {}


def test_mamba_decode_with_state():
    jp, tp = _mamba()
    x = np.random.default_rng(8).normal(size=(2, 9, 32))
    _, jst = JMb.mamba_apply(_j(x[:, :8]), jp, return_state=True)
    _, tst = TMb.mamba_apply(_t(x[:, :8]), tp, return_state=True)
    want, jnew = JMb.mamba_decode(_j(x[:, 8:]), jp, jst)
    got, tnew = TMb.mamba_decode(_t(x[:, 8:]), tp, tst)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    for key in ("h", "conv"):
        np.testing.assert_allclose(_np(tnew[key]), _np(jnew[key]),
                                   rtol=1e-4, atol=1e-4)
    # the step continues the sequence: equal to the full-sequence forward
    full, _ = TMb.mamba_apply(_t(x), tp, return_state=True)
    np.testing.assert_allclose(_np(got[:, 0]), _np(full[:, 8]), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_routing_with_drops(dtype):
    """Capacity 1.25 with 96 tokens sharing one direction (so that most
    pick the same expert) drops tokens; the port routes (and drops)
    exactly as the reference."""
    jp = JMoe.moe_init(jax.random.key(6), 32, 64, 4)
    tp = _params(jp)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 48, 32)) + 2.0 * rng.normal(size=32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want, jaux = JMoe.moe_apply(_j(x, jdt), jp, top_k=2, group_size=32)
    got, taux = TMoe.moe_apply(_t(x, tdt), tp, top_k=2, group_size=32)
    # drops happen: the dropless layer gives another output
    dropless, _ = JMoe.moe_apply(_j(x, jdt), jp, top_k=2, group_size=32,
                                 capacity_factor=4.0)
    assert not np.allclose(_np(dropless), _np(want), atol=1e-3)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)
    else:     # bf16 products summed in another order: one bf16 ulp of max
        assert _rel(got.float(), want) < 2e-2
    np.testing.assert_allclose(float(taux["load_balance"]),
                               float(jaux["load_balance"]), rtol=1e-5)
    np.testing.assert_allclose(float(taux["router_z"]),
                               float(jaux["router_z"]), rtol=1e-5)
    zero_rows = (np.abs(_np(want)).sum(-1) == 0).sum()
    assert (np.abs(_np(got.float())).sum(-1) == 0).sum() == zero_rows


# ------------------------------------------------------------------- LM

def _pair(arch, **over):
    jcfg = replace(jget_config(arch).reduced(), **over)
    tcfg = replace(get_config(arch).reduced(), **over)
    jlm = JLM(jcfg, impl="reference")
    jp = jlm.init(jax.random.key(0))
    tp = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jlm, jp, LM(tcfg), tp


def _run(jlm, jp, lm, tp, tokens, steps=3):
    """Prefill then ``steps`` decode steps, both fed the reference's
    greedy tokens; returns [(port logits, reference logits)] a step."""
    s = tokens.shape[1]
    jl, jc = jlm.prefill(jp, jnp.asarray(tokens))
    tl, tc = lm.prefill(tp, torch.from_numpy(tokens))
    out = [(tl, jl)]
    for t in range(steps):
        cur = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        jl, jc = jlm.decode_step(jp, jnp.asarray(cur), jc, s + t)
        tl, tc = lm.decode_step(tp, torch.from_numpy(cur), tc, s + t)
        out.append((tl, jl))
    return out


def _tokens(cfg, b=2, s=40, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", PORTED)
def test_lm_prefill_decode_float32(arch):
    jlm, jp, lm, tp = _pair(arch, act_dtype="float32")
    # 40 tokens: past Gemma-3's and Mixtral's reduced window (16), so the
    # rolling caches wrap
    steps = _run(jlm, jp, lm, tp, _tokens(lm.cfg))
    (tl, jl), decode = steps[0], steps[1:]
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    assert _rel(tl, jl) < 1e-4
    assert (_np(tl).argmax(-1) == _np(jl).argmax(-1)).all()
    for tl, jl in decode:
        assert _rel(tl, jl) < 2e-3


def test_lm_gemma3_at_head_dim_256():
    """Gemma 3 at narrow width with its own head dim, 256: one 5:1 cycle
    of 6 layers (5 local with window 16, 1 global), 4 query / 2 KV heads,
    d 64, float32 activations.  Prefill over 40 tokens (past the window:
    the rolling caches wrap) and one decode step against the JAX LM with
    the same parameters, at test_lm_prefill_decode_float32's bounds (1e-4
    and 2e-3 of max |logit|)."""
    jlm, jp, lm, tp = _pair("gemma3_12b", act_dtype="float32", num_layers=6,
                            head_dim=256, num_kv_heads=2)
    assert (lm.cfg.hd, lm.cfg.window) == (256, 16)
    (tl, jl), (dl, djl) = _run(jlm, jp, lm, tp, _tokens(lm.cfg), steps=1)
    assert _rel(tl, jl) < 1e-4
    assert (_np(tl).argmax(-1) == _np(jl).argmax(-1)).all()
    assert _rel(dl, djl) < 2e-3


def test_lm_apply_float32():
    jlm, jp, lm, tp = _pair("jamba_v0_1_52b", act_dtype="float32")
    toks = _tokens(lm.cfg, s=20)
    want, jaux = jlm.apply(jp, jnp.asarray(toks))
    got, taux = lm.apply(tp, torch.from_numpy(toks))
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-4
    np.testing.assert_allclose(float(taux["load_balance"]),
                               float(jaux["load_balance"]), rtol=1e-4)


@pytest.mark.parametrize("arch,over", [
    ("smollm_360m", {}),
    # top-k = all experts, dropless: routing without a discontinuity, so
    # that a bf16 ulp cannot move a token to another expert (with top-2 of
    # 4 the reference's own bf16 run moves up to 164% of max |logit| from
    # its float32 run on these seeds)
    ("jamba_v0_1_52b", {"moe_top_k": 4, "moe_capacity_factor": 4.0}),
])
def test_lm_prefill_decode_bf16(arch, over):
    jlm, jp, lm, tp = _pair(arch, act_dtype="bfloat16", **over)
    j32, jp32, _, _ = _pair(arch, act_dtype="float32", **over)
    toks = _tokens(lm.cfg)
    assert tp["blocks"]["slot0"]["norm1"]["scale"].dtype == torch.float32
    bf16 = _run(jlm, jp, lm, tp, toks)
    # the reference in float32 on the same tokens: its bf16 noise floor
    s = toks.shape[1]
    f32 = [j32.prefill(jp32, jnp.asarray(toks))]
    for t in range(3):
        cur = np.asarray(jnp.argmax(bf16[t][1], axis=-1), np.int32)
        f32.append(j32.decode_step(jp32, jnp.asarray(cur), f32[-1][1], s + t))
    for (tl, jl), (j32l, _) in zip(bf16, f32):
        scale = np.abs(_np(j32l)).max()
        noise = np.abs(_np(jl) - _np(j32l)).max() / scale
        err = np.abs(_np(tl) - _np(jl)).max() / scale
        assert err <= max(3e-2, 2 * noise), (err, noise)


def test_lm_storage_dtypes():
    cfg = get_config("jamba_v0_1_52b").reduced()
    p = LM(cfg).init(seed=1, device="cpu")
    slot0 = p["blocks"]["slot0"]
    assert p["embed"].dtype == torch.bfloat16
    assert slot0["mamba"]["in_proj"].dtype == torch.bfloat16
    assert slot0["mamba"]["x_proj"].dtype == torch.float32
    assert slot0["mamba"]["A_log"].dtype == torch.float32
    assert p["blocks"]["slot1"]["moe"]["experts"]["w_up"].shape == (
        cfg.num_layers // 8, 4, 64, 128)
    assert storage_dtype(replace(cfg, act_dtype="float32"),
                         "wq") == torch.float32


@pytest.mark.parametrize("arch", ["xlstm_1_3b", "whisper_large_v3"])
def test_unported_blocks_raise(arch):
    """A block kind that neither package has raises, naming it."""
    cfg = get_config(arch).reduced()
    odd = replace(cfg, block_pattern=cfg.block_pattern[:-1] + ("rwkv",))
    with pytest.raises(ValueError, match="rwkv"):
        LM(odd)


@pytest.mark.parametrize("arch", ["xlstm_1_3b", "whisper_large_v3"])
def test_xlstm_and_whisper_build(arch):
    """xLSTM and Whisper build, as an LM and behind ``Server``; their
    caches come stacked [G, ...] like every other slot's, a cell's
    [B, ...] as its ``*_cache_init`` makes it."""
    from repro_torch.ml import xlstm as TX
    cfg = get_config(arch).reduced()
    lm = LM(cfg)
    assert lm.groups * lm.cyc == cfg.num_layers
    srv = tserve.Server(get_config(arch), device="cpu")
    assert srv.params["embed"].device.type == "cpu"
    caches = lm.init_caches(2, 8, device="cpu", enc_len=5)
    cells = {"mlstm": TX.mlstm_cache_init(2, cfg.d_model, cfg.num_heads,
                                          device="cpu"),
             "slstm": TX.slstm_cache_init(2, cfg.d_model, device="cpu")}
    for s in range(lm.cyc):
        cell = cells.get(cfg.layer_kind(s), {})
        for name, t in caches[f"slot{s}"].items():
            assert t.shape[:2] == (lm.groups, 2), (s, name, t.shape)
            if cell:
                assert t.shape[1:] == cell[name].shape, (s, name, t.shape)
                assert not t.any()


# --------------------------------------------------------------- server

def _requests(cls, vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, vocab, rng.integers(4, 24)
                                ).astype(np.int32), max_new=6)
            for i in range(n)]


@pytest.mark.parametrize("arch", ["smollm_360m", "jamba_v0_1_52b"])
def test_server_serve_matches_reference_float32(arch):
    """The reference Server, re-typed to float32 activations (its params
    do not depend on the activation dtype), and the port's Server with
    the reference's params carried over give the same tokens."""
    ref = JServer(arch, max_batch=4)
    ref.cfg = replace(ref.cfg, act_dtype="float32")
    ref.lm = JLM(ref.cfg, impl="reference")
    ref._prefill = jax.jit(ref.lm.prefill)
    ref._decode = jax.jit(ref.lm.decode_step)
    srv = tserve.Server(replace(get_config(arch), act_dtype="float32"),
                        max_batch=4, device="cpu")
    assert _fields(srv.cfg) == _fields(ref.cfg)
    srv.params = from_jax_params(srv.cfg, jax.tree_util.tree_map(
        np.asarray, ref.params), device="cpu")
    want = ref.serve(_requests(JRequest, ref.cfg.vocab_size))
    got = srv.serve(_requests(tserve.Request, srv.cfg.vocab_size))
    assert all(r.done and len(r.out) == 6 for r in got)
    assert [r.out for r in got] == [r.out for r in want]
    # the reference counts prefill rows and every row's ``max_new``; the
    # port counts prefill calls (6 requests at 4 a batch: 2), the tokens
    # the requests keep (here every row's 6) and the prompts' own and
    # padded positions
    assert srv.stats["decode_steps"] == ref.stats["decode_steps"]
    assert srv.stats["prefills"] == 2 and ref.stats["prefills"] == 6
    assert srv.stats["tokens_out"] == ref.stats["tokens_out"] \
        == sum(len(r.out) for r in got)
    lens = [r.prompt.shape[0] for r in got]
    assert srv.stats["prompt_tokens"] == sum(lens)
    assert srv.stats["padded_positions"] == 4 * max(lens[:4]) \
        + max(lens[4:]) * 2 - sum(lens)


def test_server_launches_flash_per_attention_layer():
    srv = tserve.Server(get_config("jamba_v0_1_52b"), max_batch=4,
                        device="cpu")
    ops.reset_launch_counts()
    reqs = srv.serve(_requests(tserve.Request, srv.cfg.vocab_size, n=5))
    assert all(len(r.out) == 6 for r in reqs)
    # two prefills (4 + 1 prompts); 16 layers: 2 attention, 14 Mamba with
    # one selective_scan each
    assert ops.launch_counts() == {"flash_attention": 2 * 2,
                                   "selective_scan": 2 * 14}


def test_server_without_device_needs_a_gpu(monkeypatch):
    """``Server(...)`` means CUDA: without a GPU it raises and nothing
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.Server(get_config("smollm_360m"))
    srv = tserve.Server(get_config("smollm_360m"), device="cpu")
    assert srv.params["embed"].device.type == "cpu"


def _cache_leaves(caches):
    return [t for c in caches.values() for t in c.values()
            if isinstance(t, torch.Tensor)]


def test_cache_helpers_default_to_the_card():
    """``LM.init_caches``, ``init_cache`` and ``mamba_cache_init`` build
    on the card unless asked for the CPU, as ``LM.init``: without a GPU
    the default raises and nothing lands on the CPU."""
    lm = LM(get_config("jamba_v0_1_52b").reduced())
    mamba = {"conv_w": torch.zeros((32, 4)), "A_log": torch.zeros((32, 8))}
    calls = [lambda: lm.init_caches(2, 8),
             lambda: TA.init_cache(2, 2, 8, 16),
             lambda: TMb.mamba_cache_init(2, mamba)]
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            leaves = _cache_leaves(out) if "slot0" in out else [
                t for t in out.values() if isinstance(t, torch.Tensor)]
            assert all(t.is_cuda for t in leaves)
        else:
            with pytest.raises((AssertionError, RuntimeError),
                               match="CUDA"):
                call()


def test_init_caches_on_the_cpu_when_asked():
    lm = LM(get_config("jamba_v0_1_52b").reduced())
    caches = lm.init_caches(2, 8, device="cpu")
    kinds = {lm.cfg.layer_kind(s) for s in range(lm.cyc)}
    assert kinds == {"attn", "mamba"}
    leaves = _cache_leaves(caches)
    assert leaves and all(t.device.type == "cpu" for t in leaves)


def test_prefill_caches_follow_the_tokens_device():
    """``LM.prefill`` builds its caches where its tokens lie, whatever
    ``init_caches``' default."""
    lm = LM(get_config("jamba_v0_1_52b").reduced())
    p = lm.init(seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(lm.cfg, s=6))
    with torch.inference_mode():
        _, caches = lm.prefill(p, toks)
    leaves = _cache_leaves(caches)
    assert leaves and all(t.device.type == "cpu" for t in leaves)


def test_serve_main_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm_360m", "--requests", "3", "--max_new", "4", "--device",
         "cpu"], env=env, capture_output=True, text=True, timeout=300,
        check=True)
    assert "served 3/3 requests" in out.stdout
