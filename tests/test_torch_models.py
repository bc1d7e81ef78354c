"""Every architecture of the JAX package through the port's LM.

The port of ``tests/test_models.py``: over every ``list_archs()`` entry
at ``cfg.reduced()``, the port's ``LM`` (``src/repro_torch/ml``) is held
to the reference ``LM(impl="reference")`` on the CPU, with the
reference's parameters carried over (``ml.params.from_jax_params``) and
the same inputs, made with numpy from a seed (Whisper's frame embeddings
too).  The xLSTM cells (``ml/xlstm.py``) and the Whisper encoder are held
piece by piece as well.

Tolerances.  With float32 activations the two packages compute the same
float32 operations and differ in the order of sums only: logits within
1e-4 of max |reference logit|, cell outputs and states within 1e-5
relative, one train step's loss within 1e-4 relative and its gradients
within 1e-4 of each leaf's largest.  Prefill/decode consistency is the
reference's own bound (``tests/test_models.py``): decode after a prefill
of S−1 tokens within 0.02 of max |logit| of the full forward, argmax
equal.  Decode against the reference reads bf16 caches in both packages
(attention K/V, Whisper's cross K/V; xLSTM's states are float32), so a
float32 ulp can flip one bf16 rounding: 2e-3 of max |logit|, as
``tests/test_torch_lm.py`` holds the other configs.
"""
import zlib
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                            # noqa: E402
import jax.numpy as jnp                               # noqa: E402

from repro.configs import get_config as jget_config   # noqa: E402
from repro.configs import list_archs                  # noqa: E402
from repro.ml import losses as JL                     # noqa: E402
from repro.ml import xlstm as JX                      # noqa: E402
from repro.ml.transformer import LM as JLM            # noqa: E402

from repro_torch.configs import get_config            # noqa: E402
from repro_torch.ml import xlstm as TX                # noqa: E402
from repro_torch.ml.model import ModelBundle, TrainConfig  # noqa: E402
from repro_torch.ml.params import from_jax_params     # noqa: E402
from repro_torch.ml.transformer import LM             # noqa: E402

ARCHS = list_archs()
NEW = ["xlstm_1_3b", "whisper_large_v3"]
LOGIT_REL = 1e-4
CONSISTENCY_REL = 0.02
DECODE_REL = 2e-3
CELL_RTOL = 1e-5
GRAD_REL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _rel(got, want):
    return float(np.abs(_np(got) - _np(want)).max()
                 / (np.abs(_np(want)).max() + 1e-6))


def _reduced(get, arch, **over):
    cfg = get(arch).reduced()
    if cfg.moe_experts:          # dropless for exact decode consistency
        cfg = replace(cfg, moe_capacity_factor=float(cfg.moe_experts))
    return replace(cfg, **over)


def _pair(arch, **over):
    """The reference LM and its params, the port's LM and the same params
    carried over."""
    jcfg = _reduced(jget_config, arch, **over)
    tcfg = _reduced(get_config, arch, **over)
    jlm = JLM(jcfg, impl="reference")
    jp = jlm.init(jax.random.key(0))
    tp = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jlm, jp, LM(tcfg), tp


def _inputs(cfg, b, s, seed=0):
    """Tokens and (Whisper) frame embeddings, numpy, from a seed that
    depends on the config's name only."""
    rng = np.random.default_rng(zlib.crc32(cfg.name.encode()) ^ seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = None
    if cfg.frontend == "audio_stub":
        frames = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return tokens, frames


def _kw(frames, side):
    """``frames=`` for one package, rounded to bf16 in both."""
    if frames is None:
        return {}
    if side == "jax":
        return {"frames": _j(frames, jnp.bfloat16)}
    return {"frames": _t(frames, torch.bfloat16)}


# ------------------------------------------------------------ forward

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jlm, jp, lm, tp = _pair(arch, act_dtype="float32")
    b, s = 2, 32
    tokens, frames = _inputs(lm.cfg, b, s)
    want, jaux = jlm.apply(jp, jnp.asarray(tokens), **_kw(frames, "jax"))
    with torch.inference_mode():
        got, taux = lm.apply(tp, torch.from_numpy(tokens),
                             **_kw(frames, "torch"))
    assert got.shape == (b, s, lm.cfg.vocab_size)
    assert got.dtype == torch.float32
    assert np.isfinite(_np(got)).all()
    assert _rel(got, want) < LOGIT_REL
    np.testing.assert_allclose(float(taux["load_balance"]),
                               float(jaux["load_balance"]), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """Decode at position S−1 after a prefill of S−1 tokens against the
    full forward's last logits (float32 activations), in the port alone:
    the kernel path's plain versions on the CPU against the decode
    path."""
    lm = LM(_reduced(get_config, arch, act_dtype="float32"))
    params = lm.init(seed=0, device="cpu")
    b, s = 2, 24
    tokens, frames = _inputs(lm.cfg, b, s)
    tok = torch.from_numpy(tokens)
    kw = _kw(frames, "torch")
    with torch.inference_mode():
        full, _ = lm.apply(params, tok, **kw)
        _, caches = lm.prefill(params, tok[:, :s - 1], **kw)
        dec, _ = lm.decode_step(params, tok[:, s - 1:], caches, s - 1)
    want, got = _np(full[:, -1]), _np(dec[:, -1])
    assert _rel(got, want) < CONSISTENCY_REL, arch
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_decode_match_reference(arch):
    """Prefill and three decode steps, both fed the reference's greedy
    tokens, against the reference's (float32 activations)."""
    jlm, jp, lm, tp = _pair(arch, act_dtype="float32")
    s = 20
    tokens, frames = _inputs(lm.cfg, 2, s, seed=1)
    jl, jc = jlm.prefill(jp, jnp.asarray(tokens), **_kw(frames, "jax"))
    with torch.inference_mode():
        tl, tc = lm.prefill(tp, torch.from_numpy(tokens),
                            **_kw(frames, "torch"))
        assert _rel(tl, jl) < LOGIT_REL
        assert (_np(tl).argmax(-1) == _np(jl).argmax(-1)).all()
        for t in range(3):
            cur = np.array(jnp.argmax(jl, axis=-1), np.int32)
            jl, jc = jlm.decode_step(jp, jnp.asarray(cur), jc, s + t)
            tl, tc = lm.decode_step(tp, torch.from_numpy(cur), tc, s + t)
            assert _rel(tl, jl) < DECODE_REL, t
    # the caches hold the same keys and shapes as the reference's
    flat = {"/".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]}
    assert {f"{sl}/{k}": tuple(v.shape) for sl, c in tc.items()
            for k, v in c.items()} == flat


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "mixtral_8x7b",
                                  "xlstm_1_3b", "jamba_v0_1_52b"])
def test_multi_step_decode(arch):
    """Greedy decode runs several steps with stable caches (the
    configs' own bf16 activations)."""
    lm = LM(_reduced(get_config, arch))
    params = lm.init(seed=0, device="cpu")
    tokens, frames = _inputs(lm.cfg, 1, 8)
    with torch.inference_mode():
        logits, caches = lm.prefill(params, torch.from_numpy(tokens),
                                    **_kw(frames, "torch"))
        cur = torch.argmax(logits, dim=-1).to(torch.int32)
        for t in range(4):
            logits, caches = lm.decode_step(params, cur, caches, 8 + t)
            assert torch.isfinite(logits).all()
            cur = torch.argmax(logits, dim=-1).to(torch.int32)


def test_encoder_needs_frames():
    lm = LM(get_config("whisper_large_v3").reduced())
    params = lm.init(seed=0, device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.int32)
    for call in (lambda: lm.apply(params, tok),
                 lambda: lm.prefill(params, tok)):
        with pytest.raises(ValueError, match="frame embeddings"):
            call()


def test_encode_matches_reference():
    """The encoder alone, float32 activations: ``enc_in``, the learned
    positions rounded to bf16 before the add (the reference's quirk: at
    float32 its rounding moves the output by ~1e-4, ten times this
    bound), non-causal layers, ``enc_norm`` with its bias."""
    jlm, jp, lm, tp = _pair("whisper_large_v3", act_dtype="float32")
    _, frames = _inputs(lm.cfg, 2, 37)
    want = jlm.encode(jp, _j(frames, jnp.bfloat16))
    with torch.inference_mode():
        got = lm.encode(tp, _t(frames, torch.bfloat16))
    assert got.shape == (2, 37, lm.cfg.d_model)
    assert _rel(got, want) < CELL_RTOL


@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "xlstm_1_3b"])
def test_ssm_chunk_reaches_every_chunked_block(arch, monkeypatch):
    """``ArchConfig.ssm_chunk`` (the reference's ``REPRO_SSM_CHUNK``)
    reaches the mLSTM chunk loops of the LM and leaves Jamba's kernel path
    one selective_scan a Mamba layer: a 150-token prefill in chunks of 64
    (three, the last partial; xLSTM one mLSTM chunk each) gives the logits of
    the default 256 (one chunk), and the reference's under
    ``REPRO_SSM_CHUNK=64`` with the same parameters, within LOGIT_REL
    (float32 activations)."""
    from repro_torch.kernels import ops
    jlm, jp, lm, tp = _pair(arch, act_dtype="float32")
    assert lm.cfg.ssm_chunk == 256
    tokens, _ = _inputs(lm.cfg, 2, 150)
    tok = torch.from_numpy(tokens)
    chunks = []
    mlstm_chunk = TX._mlstm_chunk

    def counted(*args):
        chunks.append(args[2].shape[2])
        return mlstm_chunk(*args)

    monkeypatch.setattr(TX, "_mlstm_chunk", counted)
    kinds = [lm.cfg.layer_kind(i) for i in range(lm.cfg.num_layers)]
    got = {}
    for chunk in (256, 64):
        chunks.clear()
        ops.reset_launch_counts()
        with torch.inference_mode():
            got[chunk], _ = LM(replace(lm.cfg, ssm_chunk=chunk)).prefill(
                tp, tok)
        n = -(-150 // chunk)
        assert ops.launch_counts().get("selective_scan", 0) == \
            kinds.count("mamba")
        assert "ssm_scan" not in ops.launch_counts()
        assert len(chunks) == kinds.count("mlstm") * n
    monkeypatch.setenv("REPRO_SSM_CHUNK", "64")
    want, _ = jlm.prefill(jp, jnp.asarray(tokens))
    assert _rel(got[64], got[256]) < LOGIT_REL
    assert _rel(got[64], want) < LOGIT_REL
    assert (_np(got[64]).argmax(-1) == _np(want).argmax(-1)).all()


# -------------------------------------------------------------- train

def _loss_fn(jlm, tc, tokens, labels, frames):
    def fn(p):
        hid, aux = jlm.hidden(p, tokens, None, frames)
        loss = JL.chunked_lm_loss(hid, jlm.head(p), labels,
                                  chunk=tc.loss_chunk)
        return loss + tc.moe_lb_weight * aux["load_balance"] \
            + tc.moe_z_weight * aux["router_z"]
    return fn


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: _np(tree)}


@pytest.mark.parametrize("arch", NEW)
def test_train_step_loss_and_grads_match_reference(arch):
    """One step's loss and gradients (``ModelBundle.loss_and_grads``)
    against ``jax.value_and_grad`` of the reference's loss, mesh-free,
    float32 activations and params."""
    jlm, jp, lm, _ = _pair(arch, act_dtype="float32")
    tc = TrainConfig(loss_chunk=16, remat="none")
    mb = ModelBundle(lm.cfg, train_cfg=tc, device="cpu")
    tp = from_jax_params(mb.cfg, jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu", dtype=torch.float32)
    tokens, frames = _inputs(mb.cfg, 2, 16)
    labels = np.roll(tokens, -1, axis=1)
    want, wgrads = jax.value_and_grad(_loss_fn(
        jlm, tc, jnp.asarray(tokens), jnp.asarray(labels),
        _kw(frames, "jax").get("frames")))(jp)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels), **_kw(frames, "torch")}
    total, _, _, grads = mb.loss_and_grads(tp, batch)
    np.testing.assert_allclose(float(total), float(want), rtol=1e-4)
    got, want_g = _leaves(grads), _leaves(wgrads)
    assert got.keys() == want_g.keys()
    for k, g in want_g.items():
        scale = float(np.abs(g).max()) + 1e-12
        np.testing.assert_allclose(got[k] / scale, g / scale, atol=GRAD_REL,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step(arch):
    """One optimizer step runs and produces a finite loss and moved
    params (the port's ``make_train_step``; bf16 activations)."""
    cfg = _reduced(get_config, arch)
    mb = ModelBundle(cfg, train_cfg=TrainConfig(loss_chunk=16, remat="none"),
                     device="cpu")
    params = mb.init_params(0)
    opt = mb.init_opt_state(params)
    tokens, frames = _inputs(cfg, 2, 16)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(tokens), **_kw(frames, "torch")}
    new_params, new_opt, metrics = mb.make_train_step()(params, opt, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert int(new_opt["adam"]["step"]) == 1
    moved = sum(float(np.abs(a - b).sum()) for a, b in zip(
        _leaves(params).values(), _leaves(new_params).values()))
    assert moved > 0


@pytest.mark.parametrize("arch", NEW)
def test_remat_leaves_gradients_unchanged(arch):
    """``remat`` "full" and "dots" around blocks that checkpoint inside
    (the mLSTM chunks, the sLSTM steps, chunked attention) give the same
    gradients bit for bit."""
    cfg = _reduced(get_config, arch, act_dtype="float32")
    tokens, frames = _inputs(cfg, 2, 12)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(np.roll(tokens, -1, axis=1)),
             **_kw(frames, "torch")}
    params = ModelBundle(cfg, device="cpu").init_params(0)
    runs = {}
    for remat in ("none", "full", "dots"):
        mb = ModelBundle(cfg, train_cfg=TrainConfig(remat=remat),
                         device="cpu")
        total, _, _, grads = mb.loss_and_grads(params, batch)
        runs[remat] = (float(total), _leaves(grads))
    for remat in ("full", "dots"):
        assert runs[remat][0] == runs["none"][0]
        for k, g in runs["none"][1].items():
            np.testing.assert_array_equal(runs[remat][1][k], g,
                                          err_msg=f"{remat} {k}")


# ------------------------------------------------------ storage dtypes

@pytest.mark.parametrize("source", ["init", "carried"])
def test_storage_dtypes_of_the_new_leaves(source):
    """Under bf16 activations: the sLSTM cell's wi/wf/wz/wo, its r*/b*,
    mLSTM's gates and ``pos_embed`` stay float32; what every use casts
    to the activations is stored bf16."""
    bf, f32 = torch.bfloat16, torch.float32
    trees = {}
    for arch in NEW:
        if source == "init":
            lm = LM(get_config(arch).reduced())
            trees[arch] = lm.init(seed=0, device="cpu")
        else:
            trees[arch] = _pair(arch)[3]
    x = trees["xlstm_1_3b"]["blocks"]
    slstm, mlstm = x["slot7"]["cell"], x["slot0"]["cell"]
    for g in "ifzo":
        assert slstm[f"w{g}"].dtype == f32, g
        assert slstm[f"r{g}"].dtype == f32 and slstm[f"b{g}"].dtype == f32
    assert slstm["out_proj"].dtype == bf
    assert all(t.dtype == bf for t in slstm["mlp"].values())
    assert mlstm["wi"].dtype == f32 and mlstm["wf"].dtype == f32
    for k in ("wq", "wk", "wv", "w_upA", "w_upB", "out_proj"):
        assert mlstm[k].dtype == bf, k
    w = trees["whisper_large_v3"]
    assert w["pos_embed"].dtype == f32
    assert w["enc_in"].dtype == bf
    assert w["enc_norm"]["bias"].dtype == f32
    dec = w["blocks"]["slot0"]
    assert dec["xattn"]["wo"].dtype == bf and dec["attn"]["wo"].dtype == bf
    assert set(dec["normx"]) == {"scale"}          # no bias, as the reference
    assert set(w["enc_blocks"]) == {"norm1", "attn", "norm2", "mlp"}
    enc_layers = get_config("whisper_large_v3").reduced().encoder_layers
    assert w["enc_blocks"]["attn"]["wq"].shape[0] == enc_layers


# --------------------------------------------------------------- cells

def _mlstm(d=32, heads=4):
    jp = JX.mlstm_init(jax.random.key(3), d, heads)
    return jp, {k: _t(np.asarray(v)) for k, v in jp.items()}


def _slstm(d=32, heads=4):
    jp = JX.slstm_init(jax.random.key(4), d, heads)
    # non-zero biases: the gates' stabiliser m moves off zero
    for i, g in enumerate("ifzo"):
        jp[f"b{g}"] = jp[f"b{g}"] + (0.5 - 0.3 * i)
    return jp, {k: ({kk: _t(np.asarray(vv)) for kk, vv in v.items()}
                    if isinstance(v, dict) else _t(np.asarray(v)))
                for k, v in jp.items()}


@pytest.mark.parametrize("s,chunk", [(40, 16), (16, 256), (3, 2), (33, 8)])
def test_mlstm_apply_matches_reference(s, chunk):
    jp, tp = _mlstm()
    x = np.random.default_rng(s).normal(size=(2, s, 32))
    want, jst = JX.mlstm_apply(_j(x), jp, 4, chunk=chunk, return_state=True)
    got, tst = TX.mlstm_apply(_t(x), tp, 4, chunk=chunk, return_state=True)
    assert _rel(got, want) < CELL_RTOL
    for k in ("C", "n"):
        assert tst[k].shape == jst[k].shape
        assert _rel(tst[k], jst[k]) < CELL_RTOL, k


def test_slstm_apply_matches_reference():
    jp, tp = _slstm()
    x = np.random.default_rng(5).normal(size=(2, 13, 32))
    want, jst = JX.slstm_apply(_j(x), jp, 4, return_state=True)
    got, tst = TX.slstm_apply(_t(x), tp, 4, return_state=True)
    assert _rel(got, want) < CELL_RTOL
    for k in ("c", "n", "h", "m"):
        assert _rel(tst[k], jst[k]) < CELL_RTOL, k


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_cell_decode_state_equals_return_state(cell):
    """Decoding the sequence token by token from a zero cache gives each
    position's output and, at the end, the full pass's ``return_state``;
    one more step matches the reference's decode."""
    jp, tp = _mlstm() if cell == "mlstm" else _slstm()
    apply = getattr(TX, f"{cell}_apply")
    decode = getattr(TX, f"{cell}_decode")
    x = np.random.default_rng(6).normal(size=(2, 11, 32))
    full, state = apply(_t(x[:, :10]), tp, 4, return_state=True)
    cache = (TX.mlstm_cache_init(2, 32, 4, device="cpu") if cell == "mlstm"
             else TX.slstm_cache_init(2, 32, device="cpu"))
    for t in range(10):
        y, cache = decode(_t(x[:, t:t + 1]), tp, 4, cache)
        np.testing.assert_allclose(_np(y[:, 0]), _np(full[:, t]),
                                   rtol=1e-4, atol=1e-5)
    assert cache.keys() == state.keys()
    for k in state:
        np.testing.assert_allclose(_np(cache[k]), _np(state[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    japply = getattr(JX, f"{cell}_apply")
    _, jst = japply(_j(x[:, :10]), jp, 4, return_state=True)
    want, jnew = getattr(JX, f"{cell}_decode")(_j(x[:, 10:]), jp, 4, jst)
    got, new = decode(_t(x[:, 10:]), tp, 4, state)
    assert _rel(got, want) < CELL_RTOL
    for k in new:
        assert _rel(new[k], jnew[k]) < CELL_RTOL, k
