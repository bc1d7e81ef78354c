"""The pieces of the port's LM training path held against the JAX
package on the CPU: the loss, the optimizer, and the two plain,
differentiable full-sequence paths that ``impl="reference"`` trains
through.

- ``ml.losses.chunked_lm_loss``: value and gradients against the
  reference's (``jax.value_and_grad``) with full logits, with chunks
  shorter than S (the last one padded) and with a mask; bf16 hidden
  states.
- ``ml.optim``: AdamW (float32 and bf16 params), clipping, the cosine
  schedule and int8 error feedback against the reference's functions on
  the same inputs, and the properties of ``tests/test_optim.py``.
- ``ml.attention.chunked_attention`` (causal with the Skv − Sq offset,
  window, softcap, GQA, several KV blocks) and ``ml.mamba``'s associative
  scan and reference path: values and gradients against the reference's.

Tolerances.  Functions of identical float32 inputs (the optimizer's, the
loss's, the EF quantizer's) agree to float32 rounding, 1e-5 relative (the
quantizer exactly); attention within 1e-5 (values) and 1e-4 (gradients,
sums over more terms in another order); the Mamba path stages its scan
inputs in bf16 in both packages, so a float32 ulp upstream can flip one
bf16 rounding: forward within 1e-4, gradients within 2^-8 of each leaf's
largest.  bf16 AdamW params may round the other way: three bf16 ulps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                            # noqa: E402
import jax.numpy as jnp                               # noqa: E402

from repro.ml import attention as JA                  # noqa: E402
from repro.ml import losses as JL                     # noqa: E402
from repro.ml import mamba as JMb                     # noqa: E402
from repro.ml import optim as JO                      # noqa: E402

from repro_torch.ml import attention as TA            # noqa: E402
from repro_torch.ml import losses as TL               # noqa: E402
from repro_torch.ml import mamba as TMb               # noqa: E402
from repro_torch.ml import optim as TO                # noqa: E402

FN_RTOL = 1e-5


def _t(a, dtype=torch.float32, grad=False):
    t = torch.from_numpy(np.array(a, np.float32)).to(dtype)
    return t.requires_grad_(grad)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _paths_jax(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path)] = _np(leaf)
    return out


def _paths_torch(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths_torch(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: _np(tree)}


# ----------------------------------------------------------------- losses

LOSS_CASES = [
    (None, False),      # full logits
    (8, False),         # chunk < S, S = 20: last chunk padded
    (8, True),          # with a mask
    (32, True),         # chunk ≥ S: full logits with a mask
]


@pytest.mark.parametrize("chunk,masked", LOSS_CASES)
def test_chunked_lm_loss_value_and_grads(chunk, masked):
    rng = np.random.default_rng(3 + (chunk or 0) + masked)
    b, s, d, v = 2, 20, 16, 50
    h = rng.normal(size=(b, s, d))
    head = rng.normal(size=(d, v)) * 0.3
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.7).astype(np.float32) if masked else None

    def jfn(hh, ww):
        return JL.chunked_lm_loss(hh, ww, jnp.asarray(labels),
                                  None if mask is None else jnp.asarray(mask),
                                  chunk=chunk)

    want, (wgh, wgw) = jax.value_and_grad(jfn, argnums=(0, 1))(_j(h),
                                                               _j(head))
    th, tw = _t(h, grad=True), _t(head, grad=True)
    got = TL.chunked_lm_loss(th, tw, torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask),
                             chunk=chunk)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=FN_RTOL)
    np.testing.assert_allclose(_np(th.grad), _np(wgh), rtol=FN_RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(_np(tw.grad), _np(wgw), rtol=FN_RTOL,
                               atol=1e-7)


def test_chunked_lm_loss_bf16_hidden():
    """bf16 hidden states: the head is rounded to bf16 and the products
    summed in float32 in both packages."""
    rng = np.random.default_rng(9)
    h = rng.normal(size=(2, 24, 32))
    head = rng.normal(size=(32, 40)) * 0.2
    labels = rng.integers(0, 40, (2, 24)).astype(np.int32)
    for chunk in (None, 10):
        want = JL.chunked_lm_loss(_j(h, jnp.bfloat16), _j(head),
                                  jnp.asarray(labels), chunk=chunk)
        got = TL.chunked_lm_loss(_t(h, torch.bfloat16), _t(head),
                                 torch.from_numpy(labels), chunk=chunk)
        np.testing.assert_allclose(float(got), float(want), rtol=FN_RTOL)


def test_cross_entropy_mask_count_floor():
    logits = torch.zeros((2, 3, 5))
    labels = torch.zeros((2, 3), dtype=torch.int32)
    # an all-zero mask divides by max(Σmask, 1), as the reference
    assert float(TL.cross_entropy(logits, labels, torch.zeros((2, 3)))) == 0.0
    np.testing.assert_allclose(float(TL.cross_entropy(logits, labels)),
                               np.log(5.0), rtol=1e-6)


# --------------------------------------------------------------- optimizer

def _opt_tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 4)).astype(dtype),
            "blocks": {"norm": rng.normal(size=(4,)).astype(dtype),
                       "stack": rng.normal(size=(2, 3, 5)).astype(dtype)}}


def _as_torch(tree, dtype=torch.float32):
    return TO.tree_map(lambda a: _t(a, dtype), tree)


def _as_jax(tree, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: _j(a, dtype), tree)


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_over_steps(pdtype):
    """Four steps with fresh grads each: params, moments and step count."""
    tp = _as_torch(_opt_tree(0), getattr(torch, pdtype))
    jp = _as_jax(_opt_tree(0), getattr(jnp, pdtype))
    ts, js = TO.adamw_init(tp), JO.adamw_init(jp)
    assert all(m.dtype == torch.float32 for m in TO.tree_leaves(ts["m"]))
    for k in range(4):
        g = _opt_tree(10 + k)
        lr = 1e-2 * (k + 1)
        tp, ts = TO.adamw_update(tp, _as_torch(g), ts, lr, weight_decay=0.1)
        jp, js = JO.adamw_update(jp, _as_jax(g), js, lr, weight_decay=0.1)
    assert int(ts["step"]) == int(js["step"]) == 4
    assert TO.tree_leaves(tp)[0].dtype == getattr(torch, pdtype)
    # bf16 params: one bf16 ulp where the float32 update rounds the other
    # way (2^-8 relative)
    atol = 1e-6 if pdtype == "float32" else 2.0 ** -8 * 3
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        gw, ww = _paths_torch(got), _paths_jax(want)
        assert gw.keys() == ww.keys()
        for k in gw:
            np.testing.assert_allclose(gw[k], ww[k], rtol=FN_RTOL, atol=atol)


def test_adamw_matches_reference_math():
    """``tests/test_optim.py``'s hand computation of step 1."""
    params = {"w": torch.tensor([[1.0, -2.0]]), "b": torch.tensor([0.5])}
    grads = {"w": torch.tensor([[0.1, 0.2]]), "b": torch.tensor([-0.3])}
    st = TO.adamw_init(params)
    lr, b1, b2, eps, wd = 0.1, 0.9, 0.95, 1e-8, 0.1
    new_p, new_st = TO.adamw_update(params, grads, st, lr, b1=b1, b2=b2,
                                    eps=eps, weight_decay=wd)
    for k in ("w", "b"):
        g = grads[k].double().numpy()
        m = (1 - b1) * g
        v = (1 - b2) * g * g
        upd = (m / (1 - b1)) / (np.sqrt(v / (1 - b2)) + eps)
        if params[k].dim() >= 2:
            upd = upd + wd * params[k].double().numpy()
        want = params[k].double().numpy() - lr * upd
        np.testing.assert_allclose(new_p[k].numpy(), want, rtol=1e-5)
    assert int(new_st["step"]) == 1


def test_clip_by_global_norm():
    grads = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, gn = TO.clip_by_global_norm(grads, 1.0)
    assert float(gn) == pytest.approx(10.0)
    total = np.sqrt(sum(float(torch.sum(g ** 2))
                        for g in TO.tree_leaves(clipped)))
    assert total == pytest.approx(1.0, rel=1e-5)
    for max_norm in (0.5, 100.0):
        g = _opt_tree(4)
        got, gn = TO.clip_by_global_norm(_as_torch(g), max_norm)
        want, wn = JO.clip_by_global_norm(_as_jax(g), max_norm)
        np.testing.assert_allclose(float(gn), float(wn), rtol=FN_RTOL)
        gw, ww = _paths_torch(got), _paths_jax(want)
        for k in gw:
            np.testing.assert_allclose(gw[k], ww[k], rtol=FN_RTOL)


def test_cosine_schedule_matches_reference():
    lr = TO.cosine_schedule(1e-3, warmup=10, total=100, min_ratio=0.1)
    jlr = JO.cosine_schedule(1e-3, warmup=10, total=100, min_ratio=0.1)
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(1e-3, rel=1e-5)
    assert float(lr(100)) == pytest.approx(1e-4, rel=1e-3)
    assert float(lr(55)) < float(lr(20))
    for step in (0, 1, 5, 9, 10, 11, 37, 99, 100, 250):
        np.testing.assert_allclose(float(lr(step)), float(jlr(step)),
                                   rtol=FN_RTOL)
        np.testing.assert_allclose(float(lr(torch.tensor(step,
                                                         dtype=torch.int32))),
                                   float(jlr(step)), rtol=FN_RTOL)


def test_ef_compression_matches_reference_and_feeds_back():
    """Quantization error is carried, not lost (EF21), and each step's
    dequantized grads and error equal the reference's exactly (the same
    float32 operations on the same inputs; round-half-to-even both)."""
    rng = np.random.default_rng(0)
    g0 = rng.normal(size=(64, 64)).astype(np.float32)
    err = TO.ef_init({"w": torch.from_numpy(g0)})
    jerr = JO.ef_init({"w": jnp.asarray(g0)})
    total_true = np.zeros((64, 64), np.float32)
    total_deq = np.zeros((64, 64), np.float32)
    for k in range(20):
        gk = g0 * np.float32(1.0 + 0.01 * k)
        deq, err = TO.compress_ef({"w": torch.from_numpy(gk)}, err)
        jdeq, jerr = JO.compress_ef({"w": jnp.asarray(gk)}, jerr)
        np.testing.assert_array_equal(deq["w"].numpy(), np.asarray(jdeq["w"]))
        np.testing.assert_array_equal(err["w"].numpy(), np.asarray(jerr["w"]))
        total_true += gk
        total_deq += deq["w"].numpy()
    resid = np.abs(total_true - total_deq).max()
    assert resid < 3 * np.abs(g0).max() / 127.0


def test_compressed_psum_names_its_queue_item(tmp_path):
    """``compressed_psum`` runs on a process group (the ML meshes, queue
    item A12a, once named by the error it raised): over one gloo rank it
    is the reference's ``shard_map`` result over a one-device axis, the
    dequantized int8 payload, bit for bit.  Four ranks are
    ``tests/test_torch_mesh.py``'s."""
    import torch.distributed as dist
    x = np.random.default_rng(0).normal(size=(8,)).astype(np.float32)
    q, scale = JO._quant_int8(jnp.asarray(x))
    want = np.asarray(q, np.float32) * np.float32(scale)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        got = TO.compressed_psum(torch.from_numpy(x), dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------- attention

ATTN_CASES = [
    ((2, 4, 2, 24, 24, 8), {}),                      # GQA causal
    ((1, 2, 1, 10, 30, 8), {}),                      # skv − sq offset
    ((1, 4, 4, 40, 40, 8), {"window": 7}),
    ((1, 2, 2, 16, 16, 8), {"softcap": 5.0}),
    ((1, 2, 1, 33, 33, 8), {"window": 5, "softcap": 3.0, "block_k": 8}),
    ((2, 2, 1, 12, 12, 8), {"causal": False, "block_k": 5}),
]


@pytest.mark.parametrize("shape,kw", ATTN_CASES)
def test_chunked_attention_value_and_grads(shape, kw):
    b, hq, hkv, sq, skv, d = shape
    rng = np.random.default_rng(sum(shape))
    q = rng.normal(size=(b, hq, sq, d))
    k = rng.normal(size=(b, hkv, skv, d))
    v = rng.normal(size=(b, hkv, skv, d))
    w = rng.normal(size=(b, hq, sq, d))     # a cotangent

    def jfn(q, k, v):
        return jnp.sum(JA.chunked_attention(q, k, v, **kw) * _j(w))

    want = JA.chunked_attention(_j(q), _j(k), _j(v), **kw)
    wg = jax.grad(jfn, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    got = TA.chunked_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)
    (got * _t(w)).sum().backward()
    for t, g in zip((tq, tk, tv), wg):
        np.testing.assert_allclose(_np(t.grad), _np(g), rtol=1e-4, atol=1e-5)


def test_chunked_attention_bf16_and_kernel_path_agree():
    """bf16 operands against the reference's chunked path (one bf16
    rounding of the output apart), and the port's kernel path (the plain
    flash_attention on the CPU) within float32 rounding of the chunked
    path."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(1, 4, 20, 16)),
               rng.normal(size=(1, 2, 20, 16)),
               rng.normal(size=(1, 2, 20, 16)))
    got = TA.chunked_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)),
                               window=6)
    want = JA.chunked_attention(*(_j(a, jnp.bfloat16) for a in (q, k, v)),
                                window=6)
    np.testing.assert_allclose(_np(got), _np(want), atol=2.0 ** -7)
    kern = TA._attention(*(_t(a) for a in (q, k, v)), causal=True, window=6,
                         softcap=None, scale=None, impl="kernel")
    ref = TA._attention(*(_t(a) for a in (q, k, v)), causal=True, window=6,
                        softcap=None, scale=None, impl="reference")
    np.testing.assert_allclose(_np(kern), _np(ref), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="impl"):
        TA._attention(*(_t(a) for a in (q, k, v)), causal=True, window=None,
                      softcap=None, scale=None, impl="pallas")


# ------------------------------------------------------------------ mamba

@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
def test_associative_scan_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3))
    bx = rng.normal(size=(2, n, 3))

    def comb(u, w):
        return u[0] * w[0], w[1] + w[0] * u[1]

    wa, wb = jax.lax.associative_scan(comb, (_j(a), _j(bx)), axis=1)
    ga, gb = TMb.associative_scan(_t(a), _t(bx))
    np.testing.assert_allclose(_np(ga), _np(wa), rtol=1e-6)
    np.testing.assert_allclose(_np(gb), _np(wb), rtol=1e-6, atol=1e-7)
    # the recurrence itself
    h, want = np.zeros((2, 3)), []
    for t in range(n):
        h = a[:, t] * h + bx[:, t]
        want.append(h)
    np.testing.assert_allclose(_np(gb), np.stack(want, 1), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("s,chunk", [(20, 8), (9, 256)])
def test_mamba_reference_path_value_state_and_grads(s, chunk):
    d = 16
    key = jax.random.key(s)
    jp = JMb.mamba_init(key, d, expand=2, state=4, conv=4)
    tp = {k: _t(np.asarray(v), grad=True) for k, v in jp.items()}
    x = np.random.default_rng(s).normal(size=(2, s, d))
    w = np.random.default_rng(s + 1).normal(size=(2, s, d))

    def jfn(p, xx):
        return jnp.sum(JMb.mamba_apply(xx, p, chunk=chunk) * _j(w))

    want, wstate = JMb.mamba_apply(_j(x), jp, chunk=chunk, return_state=True)
    wg = jax.grad(jfn)(jp, _j(x))
    got, state = TMb.mamba_apply(_t(x), tp, chunk=chunk, return_state=True,
                                 impl="reference")
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(state["h"]), _np(wstate["h"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(_np(state["conv"]), _np(wstate["conv"]),
                               rtol=1e-6)
    (TMb.mamba_apply(_t(x), tp, chunk=chunk, impl="reference")
     * _t(w)).sum().backward()
    # both packages stage the scan's inputs in bf16: a float32 ulp of
    # delta, x1, B or C can flip one bf16 rounding (2^-8 relative), and
    # the gradients computed at those values move by as much
    for k, g in wg.items():
        scale = float(np.abs(_np(g)).max()) + 1e-6
        np.testing.assert_allclose(_np(tp[k].grad) / scale,
                                   _np(g) / scale, atol=2.0 ** -8,
                                   err_msg=k)
    # the kernel path (plain ssm_scan on the CPU) gives the same forward
    kern = TMb.mamba_apply(_t(x), {k: v.detach() for k, v in tp.items()},
                           chunk=chunk, impl="kernel")
    np.testing.assert_allclose(_np(kern), _np(got), rtol=1e-4, atol=1e-5)
