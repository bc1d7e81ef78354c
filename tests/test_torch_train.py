"""The port's LM train step held against the JAX package on the CPU.

``ml.model.ModelBundle.make_train_step``: three steps from the
reference's parameters (carried with ``from_jax_params(...,
dtype=torch.float32)``) for reduced SmolLM, Jamba (MoE with drops,
Mamba), Gemma 3 (local:global windows, softcap) and Qwen2-VL (M-RoPE with
three distinct position streams, qkv bias), against the reference's
mesh-free ``make_train_step`` under ``jax.jit``; then ``remat`` "full"
and "dots" against "none", ``impl`` "kernel" against "reference" in the
forward, and the bundle's bf16 parameters and int8 error feedback.

Tolerances.  With float32 activations the two packages compute the same
float32 operations and differ only in the order of sums (matmuls,
reductions, the associative scan's pairs): losses and the learning rate
within rtol 1e-4, the grad norm within rtol 1e-3 and the parameters after
three AdamW steps within atol 1e-5.  AdamW moves a parameter by
m/(√v + eps) ≈ ±lr whatever its gradient's size, so a parameter whose
gradient is rounding noise can move either way in either package: with
distinct M-RoPE streams the key bias is such a leaf (adding it shifts a
query's logits by an almost constant amount, to which softmax is blind),
and it is held within 2·Σ lr_t.  In bfloat16 the packages round at
different places (products sum in another order before the bf16
rounding), so the bf16 case holds the loss within rtol 1e-4, the grad
norm within 1e-2 and the parameters within 2·Σ lr_t.  ``remat`` must not
change a gradient bit.

The pieces (loss, optimizer, attention, Mamba scan) are in
``tests/test_torch_train_ops.py``; the loop and checkpoints in
``tests/test_torch_ckpt.py``.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                            # noqa: E402
import jax.numpy as jnp                               # noqa: E402

from repro.configs import get_config as jget_config   # noqa: E402
from repro.ml.model import ModelBundle as JBundle     # noqa: E402
from repro.ml.model import TrainConfig as JTrainConfig  # noqa: E402

from repro_torch.configs import get_config            # noqa: E402
from repro_torch.ml import losses as TL               # noqa: E402
from repro_torch.ml import optim as TO                # noqa: E402
from repro_torch.ml.model import ModelBundle, TrainConfig  # noqa: E402
from repro_torch.ml.params import from_jax_params     # noqa: E402
from repro_torch.ml.transformer import LM             # noqa: E402

LOSS_RTOL = 1e-4
GNORM_RTOL = 1e-3
PARAM_ATOL = 1e-5


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


# -------------------------------------------------------------- train step

def _configs(arch, act):
    over = {"act_dtype": act}
    return (replace(jget_config(arch).reduced(), **over),
            replace(get_config(arch).reduced(), **over))


def _batch(cfg, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    if cfg.mrope:
        # three distinct M-RoPE streams (temporal, height, width)
        pos = np.arange(s, dtype=np.int32)
        out["positions"] = np.stack([
            np.broadcast_to(pos, (b, s)),
            np.broadcast_to(pos // 4, (b, s)),
            np.broadcast_to(pos % 4, (b, s))]).astype(np.int32)
    return out


TRAIN_KW = dict(warmup=2, total_steps=10, loss_chunk=16, remat="none")
TRAIN_CASES = [
    ("smollm_360m", "float32"),
    ("jamba_v0_1_52b", "float32"),      # MoE with drops, Mamba
    ("gemma3_12b", "float32"),          # local:global windows, softcap
    ("qwen2_vl_7b", "float32"),         # M-RoPE positions, qkv bias
    ("smollm_360m", "bfloat16"),
]


@pytest.mark.parametrize("arch,act", TRAIN_CASES)
def test_train_steps_match_reference(arch, act):
    jcfg, tcfg = _configs(arch, act)
    jmb = JBundle(jcfg, None, train_cfg=JTrainConfig(**TRAIN_KW))
    tmb = ModelBundle(tcfg, train_cfg=TrainConfig(**TRAIN_KW), device="cpu")
    jp = jmb.init_params(jax.random.key(0))
    tp = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu", dtype=torch.float32)
    jo, to = jmb.init_opt_state(jp), tmb.init_opt_state(tp)
    jstep, tstep = jax.jit(jmb.make_train_step()), tmb.make_train_step()
    lrs = []
    for i in range(3):
        data = _batch(jcfg, seed=i)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in
                                    data.items()})
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v) for k, v in
                                    data.items()})
        lrs.append(float(jm["lr"]))
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=LOSS_RTOL)
        for k in ("loss", "total_loss", "moe_lb"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
        gn_rtol = GNORM_RTOL if act == "float32" else 1e-2
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=gn_rtol)
        assert int(to["adam"]["step"]) == i + 1
    noise = 2 * sum(lrs)            # AdamW's ±lr a step on a noise grad
    got, want = _paths_torch(tp), _paths_jax(jp)
    assert got.keys() == want.keys()
    for k in want:
        atol = PARAM_ATOL
        if act != "float32" or (tcfg.mrope and k.endswith("wk_bias")):
            atol = noise
        np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=k)
    if tcfg.moe_experts:
        assert float(tm["moe_lb"]) > 0


def _grads(cfg, remat, data, seed=0):
    tmb = ModelBundle(cfg, train_cfg=TrainConfig(remat=remat), device="cpu")
    params = tmb.init_params(seed)
    live = TO.tree_map(lambda t: t.requires_grad_(True), params)
    hid, aux = tmb.lm.hidden(live, torch.from_numpy(data["tokens"]))
    loss = TL.chunked_lm_loss(hid, tmb.lm.head(live),
                              torch.from_numpy(data["labels"]))
    loss = loss + 0.01 * aux["load_balance"]
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in
                         _flat_torch(live).items()}


def _flat_torch(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_torch(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", ["smollm_360m", "jamba_v0_1_52b"])
def test_remat_leaves_gradients_unchanged(arch):
    cfg = replace(get_config(arch).reduced(), act_dtype="float32")
    data = _batch(cfg, s=24)
    base_loss, base = _grads(cfg, "none", data)
    for remat in ("full", "dots"):
        loss, grads = _grads(cfg, remat, data)
        assert loss == base_loss
        for k, g in base.items():
            torch.testing.assert_close(grads[k], g, rtol=0, atol=0,
                                       msg=f"{remat} {k}")


def test_lm_impl_and_remat_are_checked():
    cfg = get_config("smollm_360m").reduced()
    with pytest.raises(ValueError, match="impl"):
        LM(cfg, impl="pallas")
    with pytest.raises(ValueError, match="remat"):
        LM(cfg, remat="some")
    assert LM(cfg).impl == "kernel" and LM(cfg).remat == "none"


@pytest.mark.parametrize("arch", ["smollm_360m", "jamba_v0_1_52b"])
def test_kernel_and_reference_impl_forward_agree(arch):
    """The two full-sequence paths compute one function: the plain
    flash_attention / ssm_scan (kernel path on the CPU) against the
    chunked attention / associative scan, float32."""
    cfg = replace(get_config(arch).reduced(), act_dtype="float32")
    params = LM(cfg).init(0, "cpu")
    tok = torch.from_numpy(_batch(cfg, s=24)["tokens"])
    a, _ = LM(cfg, impl="kernel").apply(params, tok)
    b, _ = LM(cfg, impl="reference").apply(params, tok)
    np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-4)


def test_bundle_params_dtypes_and_compressed_grads():
    cfg = replace(get_config("jamba_v0_1_52b").reduced(), act_dtype="float32")
    tc = TrainConfig(param_dtype="bfloat16", compress_grads=True,
                     remat="none", warmup=1, total_steps=4)
    mb = ModelBundle(cfg, train_cfg=tc, device="cpu")
    params = mb.init_params(0)
    for name, t in _flat_torch(params).items():
        want = torch.bfloat16 if t.dim() >= 2 else torch.float32
        assert t.dtype == want, name
    opt = mb.init_opt_state(params)
    assert set(opt) == {"adam", "ef"}
    data = {k: torch.from_numpy(v) for k, v in _batch(cfg, s=16).items()}
    new_p, new_opt, m = mb.make_train_step()(params, opt, data)
    assert np.isfinite(float(m["loss"])) and int(new_opt["adam"]["step"]) == 1
    assert any(float(e.abs().max()) > 0
               for e in TO.tree_leaves(new_opt["ef"]))
    for name, t in _flat_torch(new_p).items():
        assert t.dtype == _flat_torch(params)[name].dtype, name
    # the inputs are not modified
    assert int(opt["adam"]["step"]) == 0


def test_bundle_serving_steps():
    """``make_prefill`` and ``make_decode_step`` are the LM's prefill and
    greedy decode step: on the reference path here, the decode after a
    prefill of S−1 tokens picks the argmax of the prefill over S."""
    cfg = replace(get_config("jamba_v0_1_52b").reduced(), act_dtype="float32",
                  moe_capacity_factor=4.0)     # dropless: decode = prefill
    mb = ModelBundle(cfg, device="cpu")
    params = mb.init_params(0)
    tok = torch.from_numpy(_batch(cfg, s=12)["tokens"])
    logits, caches = mb.make_prefill()(params, {"tokens": tok[:, :-1]})
    want, _ = mb.lm.prefill(params, tok[:, :-1])
    assert torch.equal(logits, want)
    nxt, _ = mb.make_decode_step()(params, caches, tok[:, -1:], 11)
    full, _ = mb.lm.prefill(params, tok)
    assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
    assert torch.equal(nxt, torch.argmax(full, dim=-1).to(torch.int32))
