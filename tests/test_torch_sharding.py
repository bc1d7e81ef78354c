"""The port's sharding rules (``repro_torch.ml.sharding``) held to the JAX
package's, on the CPU without a process group.

The six rule tests of ``tests/test_sharding.py`` run on the port's rules
and ``MeshShape((16, 16))``.  Then, for every ``list_archs()``
configuration at full width and the meshes 16×16, 2×16×16, 2×2, 4×1 and
1×4, the port's spec trees — ``ModelBundle.param_specs`` from the port's
own parameter shapes, the FSDP and ZeRO-1 extensions (``extend_specs`` /
``zero1_specs``) and the KV/state cache specs (``_cache_spec_leaf``) —
must equal the reference's, computed on an ``AbstractMesh`` from
``jax.eval_shape`` shapes, leaf path by leaf path and entry by entry.
``placements`` is checked for every kind of spec entry, and ``constrain``
returns its input without a mesh.  Exact: specs are values.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax                                            # noqa: E402
from jax.sharding import AbstractMesh                 # noqa: E402

from repro.configs.base import get_config as jget_config, list_archs  # noqa
from repro.ml import sharding as jsh                  # noqa: E402
from repro.ml.model import _cache_spec_leaf as j_cache_spec  # noqa: E402
from repro.ml.transformer import LM as JLM            # noqa: E402

from repro_torch.configs import get_config            # noqa: E402
from repro_torch.launch.mesh import production_mesh_shape  # noqa: E402
from repro_torch.ml import sharding as sh             # noqa: E402
from repro_torch.ml.model import (ModelBundle, TrainConfig,  # noqa: E402
                                  _cache_spec_leaf)
from repro_torch.ml.transformer import LM             # noqa: E402

MESHES = [(16, 16), (2, 16, 16), (2, 2), (4, 1), (1, 4)]
#: cache batches: one that the batch axes divide, and B = 1 (the
#: sequence-parallel layout)
CACHE_BATCHES = (128, 1)
CACHE_LEN = 4096


def _abstract(shape):
    names = ("pod", "data", "model")[-len(shape):]
    try:
        return AbstractMesh(tuple(shape), names)
    except TypeError:   # jax ≤ 0.4.x: shape_tuple of (name, size) pairs
        return AbstractMesh(tuple(zip(names, shape)))


@pytest.fixture(scope="module")
def mesh16():
    return sh.MeshShape((16, 16))


def _meta(tree):
    """A jax shape tree → the port's tree of meta tensors."""
    return jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta"),
        tree)


def _entry(ax):
    """A spec entry in one spelling: an axis tuple of one name is that
    name and an empty one None (``PartitionSpec`` normalizes so)."""
    if isinstance(ax, tuple):
        return None if not ax else ax[0] if len(ax) == 1 else ax
    return ax


def _canon(spec):
    return tuple(_entry(ax) for ax in spec)


def _flat_jax(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        out[".".join(str(p.key) for p in path)] = _canon(tuple(leaf))
    return out


def _flat(tree):
    return {".".join(p): _canon(s) for p, s in sh.leaf_items(tree)}


@functools.lru_cache(maxsize=None)
def _jax_shape(arch, reduced=False):
    cfg = jget_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    return jax.eval_shape(JLM(cfg).init, jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _port_shape(arch):
    return ModelBundle(get_config(arch), sh.MeshShape((1, 1)),
                       device="cpu").params_shape()


def _specs_for(arch, mesh):
    shape = _meta(_jax_shape(arch, True))
    return sh.param_specs(shape, mesh), shape


# ------------------------------------------- tests/test_sharding.py, ported

def test_attention_tp_rules(mesh16):
    specs, _ = _specs_for("command_r_35b", mesh16)
    blk = specs["blocks"]["slot0"]
    # wq [G, D, H*hd] → out-dim on model; wo [G, H*hd, D] → in-dim
    assert blk["attn"]["wq"][-1] == "model"
    assert blk["attn"]["wo"][-2] == "model"
    assert blk["mlp"]["w_up"][-1] == "model"
    assert blk["mlp"]["w_down"][-2] == "model"
    # norms replicated
    assert specs["final_norm"]["scale"] == sh.NONE_SPEC


def test_divisibility_fallback(mesh16):
    """Dims that don't divide the axis fall back or replicate."""
    specs = sh.param_specs(_port_shape("mixtral_8x7b"), mesh16)
    w_gate = specs["blocks"]["slot0"]["moe"]["experts"]["w_gate"]
    # E=8 can't shard 16 ways → the FFN dim (14336) takes the axis
    assert "model" in tuple(w_gate)
    assert w_gate[1] != "model"           # E dim NOT sharded


def test_ep_when_divisible(mesh16):
    specs = sh.param_specs(_port_shape("jamba_v0_1_52b"), mesh16)
    for s in range(8):
        blk = specs["blocks"][f"slot{s}"]
        if "moe" in blk:
            assert blk["moe"]["experts"]["w_gate"][1] == "model"
            return
    raise AssertionError("no moe slot found")


def test_zero1_and_fsdp_extend(mesh16):
    specs, shape = _specs_for("qwen1_5_0_5b", mesh16)
    z = sh.extend_specs(specs, mesh16, shape, "data")
    w = z["blocks"]["slot0"]["attn"]["wq"]
    assert "data" in tuple(w) and "model" in tuple(w)


def test_cache_specs_head_vs_seq(mesh16):
    path = ("k",)
    # qwen kv=16 divides → heads on model
    leaf = torch.empty((24, 128, 16, 1024, 64), device="meta")
    assert _cache_spec_leaf(path, leaf, mesh16)[2] == "model"
    # command-r kv=8 does not divide 16 → cache length takes the axis
    leaf = torch.empty((40, 128, 8, 32768, 128), device="meta")
    spec = _cache_spec_leaf(path, leaf, mesh16)
    assert spec[2] is None and spec[3] == "model"
    # long-context B=1 → sequence-parallel over the batch axes too
    leaf = torch.empty((40, 1, 8, 524288, 128), device="meta")
    spec = _cache_spec_leaf(path, leaf, mesh16)
    assert spec[1] is None
    flat = []
    for ax in spec:
        if isinstance(ax, tuple):
            flat.extend(ax)
        elif ax:
            flat.append(ax)
    assert "data" in flat                 # context parallelism engaged


def test_constrain_noop_without_mesh():
    sh.set_active_mesh(None)
    x = torch.ones((4, 4))
    assert sh.constrain(x, ("batch", "model")) is x


# ------------------------------------ every architecture × every mesh shape

@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", list_archs())
def test_spec_trees_match_reference(arch, shape):
    """Param specs from the port's own shapes, the FSDP / ZeRO-1
    extensions, and the cache specs at two batch sizes: each tree equal
    to the reference's, path by path."""
    jmesh, mesh = _abstract(shape), sh.MeshShape(shape)
    jshape = _jax_shape(arch)
    mine = _port_shape(arch)
    # the port's parameter tree has the reference's paths and shapes
    assert {k: tuple(v.shape) for k, v in
            ((".".join(p), t) for p, t in sh.leaf_items(mine))} == \
        {".".join(str(p.key) for p in path): tuple(leaf.shape)
         for path, leaf in jax.tree_util.tree_flatten_with_path(jshape)[0]}
    jspecs = jsh.param_specs(jshape, jmesh)
    specs = ModelBundle(get_config(arch), mesh, device="cpu").param_specs(
        mine)
    assert _flat(specs) == _flat_jax(jspecs)
    assert _flat(sh.extend_specs(specs, mesh, mine, "data")) == \
        _flat_jax(jsh.extend_specs(jspecs, jmesh, jshape, "data"))
    assert _flat(sh.zero1_specs(specs, mesh, mine)) == \
        _flat_jax(jsh.zero1_specs(jspecs, jmesh, jshape))
    fsdp = ModelBundle(get_config(arch), mesh, device="cpu",
                       train_cfg=TrainConfig(fsdp=True))
    zero = ModelBundle(get_config(arch), mesh, device="cpu",
                       train_cfg=TrainConfig(zero1=True))
    assert _flat(fsdp.param_specs(mine)) == \
        _flat_jax(jsh.extend_specs(jspecs, jmesh, jshape, "data"))
    assert _flat(zero.opt_specs(mine)) == \
        _flat_jax(jsh.zero1_specs(jspecs, jmesh, jshape))
    jcfg, cfg = jget_config(arch), get_config(arch)
    enc = CACHE_LEN if cfg.encoder_layers else None
    for b in CACHE_BATCHES:
        jc = jax.eval_shape(lambda: JLM(jcfg).init_caches(b, CACHE_LEN,
                                                          enc_len=enc))
        jcs = jax.tree_util.tree_map_with_path(
            lambda p, l: j_cache_spec(p, l, jmesh), jc)
        caches = LM(cfg).init_caches(b, CACHE_LEN, device="meta",
                                     enc_len=enc)
        got = sh.map_with_path(
            lambda p, l: _cache_spec_leaf(p, l, mesh), caches)
        assert _flat(got) == _flat_jax(jcs), b


# ----------------------------------------------------------- placements

def test_production_mesh_shape():
    assert production_mesh_shape().shape == {"data": 16, "model": 16}
    assert production_mesh_shape(True).shape == \
        {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("spec,want", [
    ((), ("R", "R", "R")),
    ((None, "model"), ("R", "R", 1)),
    (("data", None, "model"), ("R", 0, 2)),
    ((("pod", "data"), "model"), (0, 0, 1)),
    ((None, ("pod", "data", "model")), (1, 1, 1)),
    ((("data", "model"),), ("R", 0, 0)),
    ((None, None, "pod"), (2, "R", "R")),
])
def test_placements_every_spec_kind(spec, want):
    """None, one axis name and a tuple of axis names (the batch over
    ("pod", "data")), on a 2×16×16 shape: one placement per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    got = sh.placements(spec, sh.MeshShape((2, 16, 16)))
    assert got == tuple(Replicate() if w == "R" else Shard(w)
                        for w in want)


@pytest.mark.parametrize("spec", [(("data", "pod"),), ("data", "data")])
def test_placements_refuse_what_dtensor_cannot_order(spec):
    """A dim split against the mesh's order, or an axis named twice,
    has no DTensor layout that means the same thing."""
    with pytest.raises(ValueError):
        sh.placements(spec, sh.MeshShape((2, 16, 16)))


def test_constrain_returns_plain_tensors_on_a_mesh():
    """A plain tensor under an active mesh is returned as it is."""
    x = torch.ones((4, 4))
    with sh.using_mesh(sh.MeshShape((2, 2))):
        assert sh.constrain(x, ("batch", "model")) is x
    assert sh.active_mesh() is None


def test_kernel_impl_on_a_mesh_builds_and_refuses_training():
    """``ModelBundle(cfg, mesh, impl="kernel")`` builds (its serving steps
    reach the kernels on each rank's pieces); its train step raises the
    kernels' own no-backward error, which the wrappers raise on one
    card."""
    mb = ModelBundle(get_config("qwen1_5_0_5b"), sh.MeshShape((2, 2)),
                     impl="kernel", device="cpu")
    assert mb.lm.impl == "kernel"
    assert callable(mb.make_prefill()) and callable(mb.make_decode_step())
    with pytest.raises(RuntimeError, match="flash_attention: the CUDA "
                       "kernel has no backward"):
        mb.make_train_step()
    with pytest.raises(RuntimeError, match="no backward"):
        mb.loss_and_grads({}, {})
    # on a mesh with impl="reference", and for a model that reaches no
    # kernel, the step is built
    ModelBundle(get_config("qwen1_5_0_5b"), sh.MeshShape((2, 2)),
                device="cpu").make_train_step()
    ModelBundle(get_config("xlstm_1_3b"), sh.MeshShape((2, 2)),
                impl="kernel", device="cpu").make_train_step()


def test_launch_refuses_a_dtensor(tmp_path):
    """A DTensor handed to ``_build.launch`` raises, naming the wrapper and
    ``local_map``, before any build or pointer is taken (a process group
    of one, gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels import _build
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        t = distribute_tensor(torch.ones((4, 8)), mesh, [Replicate()])
        before = _build.kernel_launches()
        with pytest.raises(TypeError, match="flash_attention: got a "
                           "DTensor.*local_map"):
            _build.launch("flash_attention", "repro_flash_attention_simt",
                          torch.device("cuda", 0), t, 4)
        assert _build.kernel_launches() == before
        assert not _build._ENTRIES        # nothing was built or loaded
    finally:
        dist.destroy_process_group()
