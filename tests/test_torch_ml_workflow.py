"""Time-to-trained-model on the port: ``Flow.to_dataset`` →
``TrainingDataset`` → ``MLPRegressor`` → ``model_apply``, held against the
JAX package.

- ``TokenPipeline``, ``TrainingDataset`` and ``WflBatcher`` (numpy copies)
  give batches byte-equal to the reference's for the same seeds.
- ``to_dataset`` on the ``Obs`` FDb of ``tests/test_analytics.py``
  (``test_to_dataset_trains_end_to_end``) selects the same features and
  targets byte for byte on the port's numpy and torch (CPU) backends, and
  ``fit`` learns the line.
- ``MLPRegressor``: from the reference's initial params (carried with
  ``params_from_numpy``) and fed the reference's minibatch rows (indices
  drawn here with ``jax.random`` as the reference's ``train`` draws them),
  the port's SGD step gives the reference's losses within rtol 1e-4 over
  50 steps and its predictions within atol 1e-4.  Both run float32 on
  the CPU; the sums of a 16-wide float32 matmul may group differently
  (a few ulps a step), which 50 steps of SGD at lr 5e-2 carry to ~1e-6
  relative, well inside the bounds.
- ``save``/``load`` in both directions: the same files, the same
  predictions (atol 1e-6: one float32 forward each side).
- A WFL ``model_apply`` flow with an aggregate on the port's numpy
  backend equals the reference's (counts exact, the float64 average of
  float32 predictions within 1e-6 relative).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                            # noqa: E402

import repro.core as jcore                            # noqa: E402
import repro.exec as jexec                            # noqa: E402
import repro.fdb as jfdb                              # noqa: E402
from repro.data import pipeline as jpipe              # noqa: E402
from repro.fdb import schema as jschema               # noqa: E402
from repro.ml.integration import MLPRegressor as JMLP  # noqa: E402

import repro_torch.core as core                       # noqa: E402
import repro_torch.fdb as pfdb                        # noqa: E402
from repro_torch.data import pipeline as pipe          # noqa: E402
from repro_torch.exec import (AdHocEngine, Catalog,   # noqa: E402
                              NumpyBackend, TorchBackend)
from repro_torch.fdb import schema as pschema         # noqa: E402
from repro_torch.ml.integration import (ColumnModel,  # noqa: E402
                                        MLPRegressor, params_from_numpy,
                                        params_to_numpy)

LOSS_RTOL = 1e-4
PRED_ATOL = 1e-4


def _obs_records():
    rng = np.random.default_rng(5)
    x = rng.uniform(-2.0, 2.0, 400)
    y = 3.0 * x + 1.0 + rng.normal(0.0, 0.05, x.size)
    return [{"id": int(i), "x": float(a), "y": float(b),
             "split": int(i % 4 != 0)}
            for i, (a, b) in enumerate(zip(x, y))]


def _obs_catalog(fdb_mod, schema_mod, catalog_cls):
    S = schema_mod
    schema = S.Schema("Obs", [
        S.Field("id", S.INT, indexes=("tag",)),
        S.Field("x", S.DOUBLE),
        S.Field("y", S.DOUBLE),
        S.Field("split", S.INT, indexes=("tag",)),
    ])
    cat = catalog_cls(server_slots=4)
    cat.register(fdb_mod.build_fdb("Obs", schema, _obs_records(),
                                   num_shards=5))
    return cat


@pytest.fixture(scope="module")
def obs():
    """(port catalog, reference catalog) over the same Obs records."""
    return (_obs_catalog(pfdb, pschema, Catalog),
            _obs_catalog(jfdb, jschema, jexec.Catalog))


def _backend(name):
    return TorchBackend(device="cpu") if name == "torch" else NumpyBackend()


# ------------------------------------------------------------- pipelines

@pytest.mark.parametrize("structured", [True, False])
def test_token_pipeline_batches_byte_equal(structured):
    a = pipe.TokenPipeline(97, 3, 37, seed=11, structured=structured)
    b = jpipe.TokenPipeline(97, 3, 37, seed=11, structured=structured)
    try:
        for _ in range(4):
            x, y = next(a), next(b)
            assert set(x) == set(y) == {"tokens", "labels"}
            for k in x:
                assert x[k].dtype == y[k].dtype
                assert x[k].tobytes() == y[k].tobytes()
        assert a.state() == b.state() == {"seed": 11, "step": 4}
    finally:
        a.close()
        b.close()
    # restore at (seed, step) replays the stream from there
    r = pipe.TokenPipeline.restore({"seed": 11, "step": 2}, 97, 3, 37,
                                   structured=structured)
    try:
        want = pipe.TokenPipeline(97, 3, 37, seed=11,
                                  structured=structured)._make(2)
        assert next(r)["tokens"].tobytes() == want["tokens"].tobytes()
    finally:
        r.close()


class _Table:
    """A query result's ``batch[path].values`` surface."""

    class _Col:
        def __init__(self, values):
            self.values = values

    def __init__(self, cols):
        self.batch = {k: self._Col(v) for k, v in cols.items()}


def test_training_dataset_and_wfl_batcher_byte_equal():
    rng = np.random.default_rng(3)
    table = _Table({"a": rng.normal(size=300), "b": rng.integers(0, 9, 300),
                    "t": rng.normal(size=300)})
    mine = pipe.TrainingDataset.from_table(table, ["a", "b"], "t")
    ref = jpipe.TrainingDataset.from_table(table, ["a", "b"], "t")
    assert mine.features.tobytes() == ref.features.tobytes()
    assert mine.targets.tobytes() == ref.targets.tobytes()
    (tr, te), (rtr, rte) = mine.split(0.7, seed=4), ref.split(0.7, seed=4)
    for a, b in ((tr, rtr), (te, rte)):
        assert a.features.tobytes() == b.features.tobytes()
        assert a.targets.tobytes() == b.targets.tobytes()
    ma, mb = mine.batches(17, seed=2), ref.batches(17, seed=2)
    for _ in range(3):
        (fa, ta), (fb, tb) = next(ma), next(mb)
        assert fa.tobytes() == fb.tobytes() and ta.tobytes() == tb.tobytes()
    wa = pipe.WflBatcher(table, ["a", "b"], "t", 13, seed=9)
    wb = jpipe.WflBatcher(table, ["a", "b"], "t", 13, seed=9)
    for _ in range(3):
        (fa, ta), (fb, tb) = next(wa), next(wb)
        assert fa.tobytes() == fb.tobytes() and ta.tobytes() == tb.tobytes()


# ------------------------------------------------ to_dataset → fit

@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_to_dataset_trains_end_to_end(obs, backend):
    """``tests/test_analytics.py::test_to_dataset_trains_end_to_end`` on
    the port, the selection byte-equal to the reference's."""
    pcat, jcat = obs
    P = core.P
    eng = AdHocEngine(pcat, backend=_backend(backend))
    ds = (core.fdb("Obs").find(P.split == 1)
          .to_dataset(features={"x": P.x}, target=P.y, engine=eng))
    recs = _obs_records()
    assert len(ds) == sum(1 for r in recs if r["split"] == 1)
    assert ds.feature_names == ["x"] and ds.num_features == 1
    jeng = jexec.AdHocEngine(jcat, backend="numpy")
    JP = jcore.P
    want = (jcore.fdb("Obs").find(JP.split == 1)
            .to_dataset(features={"x": JP.x}, target=JP.y, engine=jeng))
    assert ds.features.tobytes() == want.features.tobytes()
    assert ds.targets.tobytes() == want.targets.tobytes()

    tr, te = ds.split(frac=0.8, seed=0)
    assert len(tr) + len(te) == len(ds) and len(te) > 0
    fb, tb = next(iter(tr.batches(32)))
    assert fb.shape == (32, 1) and tb.shape == (32,)

    model, losses = ds.fit(hidden=16, depth=1, steps=200, lr=5e-2,
                           batch=128, device="cpu")
    assert len(losses) == 200
    assert losses[-1] < losses[0] * 0.5        # actually learned
    pred = model.as_column_model(["x"]).apply_columns(
        {"x": np.array([0.0, 1.0])})
    assert pred.dtype == np.float32
    assert pred[0] == pytest.approx(1.0, abs=0.5)
    assert pred[1] == pytest.approx(4.0, abs=0.5)

    # sequence-of-fields form infers names from the field refs
    ds2 = core.fdb("Obs").to_dataset(features=[P.x], target=P.y,
                                     engine=eng)
    assert ds2.feature_names == ["x"] and len(ds2) == len(recs)


# ------------------------------------------------------- MLPRegressor

def _ref_rows(n, steps, batch, seed=0):
    """The minibatch indices of the reference's ``MLPRegressor.train``."""
    key = jax.random.key(seed)
    out = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(k, (min(batch, n),), 0,
                                                 n)))
    return out


def _feats(n=600, f=3, seed=1):
    """``f`` (≤ 3) features of different scales and a noisy linear
    target."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 3)) * [1.0, 5.0, 0.2])[:, :f]
    y = x @ np.array([1.5, -0.3, 4.0])[:f] + 2.0 + 0.1 * rng.normal(size=n)
    return x.astype(np.float32), y.astype(np.float32)


def test_mlp_sgd_matches_reference_from_its_params():
    x, y = _feats()
    steps, lr, batch = 50, 5e-2, 128
    jm = JMLP(3, hidden=16, depth=2, seed=0)
    init = jax.tree_util.tree_map(np.asarray, jm.params)
    want = jm.train(x, y, steps=steps, lr=lr, batch=batch, seed=0)

    p = params_from_numpy(init, "cpu")
    p = p0 = MLPRegressor.standardize(p, torch.from_numpy(x),
                                      torch.from_numpy(y))
    for k in ("x_mu", "x_sd", "y_mu", "y_sd"):     # float32 sums' order
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jm.params[k]),
                                   rtol=1e-6, atol=1e-6)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = []
    for idx in _ref_rows(len(x), steps, batch):
        i = torch.from_numpy(idx.astype(np.int64))
        p, loss = MLPRegressor.sgd_step(p, xt[i], yt[i], lr)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    probe = np.random.default_rng(7).normal(size=(64, 3)).astype(np.float32)
    mine = ColumnModel(MLPRegressor.apply, p, ["a", "b", "c"])
    theirs = jm.as_column_model(["a", "b", "c"])
    cols = {"a": probe[:, 0], "b": probe[:, 1], "c": probe[:, 2]}
    np.testing.assert_allclose(mine.apply_columns(cols),
                               theirs.apply_columns(cols), atol=PRED_ATOL)
    # the standardization leaves never move
    for k in ("x_mu", "x_sd", "y_mu", "y_sd"):
        np.testing.assert_array_equal(params_to_numpy(p)[k],
                                      params_to_numpy(p0)[k])


def test_mlp_train_is_the_step_over_its_index_stream():
    """``train`` = standardize, then ``sgd_step`` over ``index_stream``:
    the same seed gives the same model on every run (and the same
    indices on every device: they are drawn on the CPU)."""
    x, y = _feats(n=200)
    a = MLPRegressor(3, hidden=8, depth=2, seed=4, device="cpu")
    b = MLPRegressor(3, hidden=8, depth=2, seed=4, device="cpu")
    la = a.train(x, y, steps=20, lr=1e-2, batch=64, seed=5)
    p = MLPRegressor.standardize(b.params, torch.from_numpy(x),
                                 torch.from_numpy(y))
    idx = MLPRegressor.index_stream(len(x), 20, 64, seed=5)
    assert idx.shape == (20, 64) and int(idx.max()) < len(x)
    lb = []
    for i in idx:
        p, loss = MLPRegressor.sgd_step(p, torch.from_numpy(x)[i],
                                        torch.from_numpy(y)[i], 1e-2)
        lb.append(float(loss))
    assert la == lb
    for u, v in zip(a.params["layers"], p["layers"]):
        assert torch.equal(u["w"], v["w"]) and torch.equal(u["b"], v["b"])


def test_apply_columns_chunks_and_empty_input():
    m = MLPRegressor(2, hidden=4, depth=1, seed=0, device="cpu")
    col = ColumnModel(MLPRegressor.apply, m.params, ["u", "v"],
                      batch_size=7)
    rng = np.random.default_rng(0)
    cols = {"u": rng.normal(size=30), "v": rng.normal(size=30)}
    whole = ColumnModel(MLPRegressor.apply, m.params, ["u", "v"])
    np.testing.assert_array_equal(col.apply_columns(cols),
                                  whole.apply_columns(cols))
    empty = col.apply_columns({"u": np.zeros(0), "v": np.zeros(0)})
    assert empty.dtype == np.float32 and empty.shape == (0,)


def test_mlp_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises((RuntimeError, AssertionError)):
        MLPRegressor(2)


def test_save_load_both_directions(tmp_path):
    x, y = _feats(n=200)
    mine = MLPRegressor(3, hidden=8, depth=2, seed=1, device="cpu")
    mine.train(x, y, steps=10, lr=1e-2, batch=64)
    ref = JMLP(3, hidden=8, depth=2, seed=1)
    ref.train(x, y, steps=10, lr=1e-2, batch=64)
    names = ["a", "b", "c"]
    cols = {"a": x[:50, 0], "b": x[:50, 1], "c": x[:50, 2]}

    mine.save(str(tmp_path / "port"), names)
    ref.save(str(tmp_path / "ref"), names)
    for d in ("port", "ref"):
        with np.load(tmp_path / d / "params.npz") as z:
            assert sorted(z.files) == sorted(
                ["x_mu", "x_sd", "y_mu", "y_sd", "w0", "b0", "w1", "b1",
                 "w2", "b2"])
            assert all(z[k].dtype == np.float32 for k in z.files)
        meta = json.loads((tmp_path / d / "model.json").read_text())
        assert meta == {"features": names, "num_features": 3}

    # port → reference, and back into the port
    want = mine.as_column_model(names).apply_columns(cols)
    np.testing.assert_allclose(JMLP.load(str(tmp_path / "port"))
                               .apply_columns(cols), want, atol=1e-6)
    np.testing.assert_array_equal(
        MLPRegressor.load(str(tmp_path / "port"), device="cpu")
        .apply_columns(cols), want)
    # reference → port
    np.testing.assert_allclose(
        MLPRegressor.load(str(tmp_path / "ref"), device="cpu")
        .apply_columns(cols),
        ref.as_column_model(names).apply_columns(cols), atol=1e-6)
    assert os.path.exists(tmp_path / "ref" / "model.json")


# ---------------------------------------------------------- model_apply

@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_model_apply_flow_matches_reference(obs, backend):
    pcat, jcat = obs
    x, y = _feats(n=200, f=1)
    ref = JMLP(1, hidden=8, depth=2, seed=2)
    ref.train(x, y, steps=20, lr=1e-2, batch=64)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      ref.params), "cpu")
    mine = ColumnModel(MLPRegressor.apply, params, ["x"])
    theirs = ref.as_column_model(["x"])

    def flow(c, model):
        P = c.P
        return (c.fdb("Obs").find(P.split == 1)
                .model_apply(model, output="pred", x=P.x)
                .map(lambda p: c.proto(id=p.id, split=p.split,
                                       pred=p.pred)))

    def agg(c, model):
        P = c.P
        return (c.fdb("Obs").model_apply(model, output="pred", x=P.x)
                .aggregate(c.group(P.split).avg(m=P.pred).count("n")))

    eng = AdHocEngine(pcat, backend=_backend(backend))
    jeng = jexec.AdHocEngine(jcat, backend="numpy")
    got = sorted(eng.collect(flow(core, mine)).to_records(),
                 key=lambda r: r["id"])
    want = sorted(jeng.collect(flow(jcore, theirs)).to_records(),
                  key=lambda r: r["id"])
    assert [r["id"] for r in got] == [r["id"] for r in want]
    np.testing.assert_allclose([r["pred"] for r in got],
                               [r["pred"] for r in want], atol=PRED_ATOL)
    ga = sorted(eng.collect(agg(core, mine)).to_records(),
                key=lambda r: r["split"])
    wa = sorted(jeng.collect(agg(jcore, theirs)).to_records(),
                key=lambda r: r["split"])
    assert [(r["split"], r["n"]) for r in ga] == \
        [(r["split"], r["n"]) for r in wa]
    np.testing.assert_allclose([r["m"] for r in ga], [r["m"] for r in wa],
                               rtol=1e-6)
