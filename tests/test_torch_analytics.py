"""Grouped ``approx_distinct`` (``segment_hll``) and the reduction
analytics on the port's torch backend.

``segment_hll`` — the plain PyTorch scatter-max of ``kernels/fused.py``
and ``TorchBackend.segment_hll`` on ``device="cpu"`` — is held byte for
byte to the JAX package's ``repro.kernels.fused.segment_hll`` (plain jnp,
which runs here) and to both ``NumpyBackend`` oracles on seeded inputs:
masked rows, empty groups, ids at G − 1 and past it, M = 4,096 registers.
Then the tests of ``tests/test_analytics.py`` for the HLL aggregate (its
oracle and its invariance across backends and P = 1/2/4), the count and
dwell reduction verdicts, the analytics tables, the reduction launch
contract, and Tesseract labels and ``before`` run on
``TorchBackend(device="cpu")``, against the port's numpy oracle and the
JAX package's.  Tolerance: none — registers, ids, tables and estimates
are compared exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                               # noqa: E402

import repro.core as jcore                            # noqa: E402
import repro.exec as jexec                            # noqa: E402
import repro.fdb as jfdb                              # noqa: E402
from repro.core.sketches import HyperLogLog as JHyperLogLog  # noqa: E402
from repro.exec.backend import NumpyBackend as JNumpyBackend  # noqa: E402
from repro.fdb import schema as jschema               # noqa: E402
from repro.kernels import fused as jfused             # noqa: E402

import repro_torch.core as core                       # noqa: E402
import repro_torch.fdb as pfdb                        # noqa: E402
from repro_torch.core import P, fdb, proto            # noqa: E402
from repro_torch.core.planner import partition_shards  # noqa: E402
from repro_torch.core.sketches import HyperLogLog     # noqa: E402
from repro_torch.exec import (AdHocEngine, Catalog, ExecConfig,  # noqa
                              NumpyBackend, TorchBackend)
from repro_torch.fdb import build_fdb                 # noqa: E402
from repro_torch.fdb import schema as pschema         # noqa: E402
from repro_torch.fdb.schema import (DOUBLE, INT, MESSAGE, Field,  # noqa
                                    Schema)
from repro_torch.geo import AreaTree, mercator as M   # noqa: E402
from repro_torch.kernels import fused, ops            # noqa: E402
from repro_torch.tess import Tesseract                # noqa: E402


def _backend(name):
    return TorchBackend(device="cpu") if name == "torch" else NumpyBackend()


# ------------------------------------------------------------ segment_hll

@pytest.mark.parametrize("n,g,m,masked", [
    (0, 3, 16, 0.0),          # no rows: every group an empty sketch
    (1, 1, 1, 0.0),
    (50, 7, 16, 0.3),         # masked rows
    (400, 40, 64, 0.1),       # more groups than rows land in: empty ones
    (3000, 24, 4096, 0.05),   # the aggregate's M = 4,096
    (200, 5, 32, 1.0),        # every row masked
])
def test_segment_hll_kernel_matches_jax(n, g, m, masked):
    """The plain scatter-max against ``repro.kernels.fused.segment_hll``
    byte for byte, ids ranging over [-1, G] (G − 1 included, G dropped
    as the JAX segment max drops it)."""
    rng = np.random.default_rng(n * 7 + g * 3 + m)
    ids = rng.integers(0, g, n).astype(np.int32)
    if n:
        ids[0] = g - 1
    ids[rng.random(n) < masked] = -1
    regs = rng.integers(0, 40, (n, m)).astype(np.uint8)
    got = fused.segment_hll(torch.from_numpy(ids), torch.from_numpy(regs), g)
    want = np.asarray(jfused.segment_hll(jnp.asarray(ids),
                                         jnp.asarray(regs), g))
    assert got.dtype == torch.uint8 and got.shape == (g, m)
    assert got.numpy().tobytes() == want.tobytes()
    # an id past the group space is dropped, not scattered
    past = np.where(ids >= 0, ids, g)
    assert np.array_equal(fused.segment_hll(
        torch.from_numpy(past), torch.from_numpy(regs), g).numpy(),
        np.asarray(jfused.segment_hll(jnp.asarray(past), jnp.asarray(regs),
                                      g)))


def test_segment_hll_no_groups():
    out = fused.segment_hll(torch.zeros(4, dtype=torch.int32),
                            torch.ones((4, 16), dtype=torch.uint8), 0)
    assert out.shape == (0, 16) and out.dtype == torch.uint8


@pytest.mark.parametrize("n,g,p", [(0, 4, 12), (37, 1, 4), (500, 24, 12),
                                   (2000, 130, 8)])
def test_backend_segment_hll_matches_oracles(n, g, p):
    """``TorchBackend.segment_hll``: composite (group, register) ids, one
    dispatch, registers byte-equal to both numpy oracles."""
    rng = np.random.default_rng(n + g + p)
    m = 1 << p
    codes = rng.integers(-1, g, n)
    idx = rng.integers(0, m, n)
    ranks = rng.integers(1, 30, n).astype(np.uint8)
    ops.reset_launch_counts()
    got = TorchBackend(device="cpu").segment_hll(codes, idx, ranks, g, m)
    assert ops.launch_counts() == {"segment_hll": 1}
    assert got.dtype == np.uint8 and got.shape == (g, m)
    for oracle in (NumpyBackend(), JNumpyBackend()):
        want = oracle.segment_hll(codes, idx, ranks, g, m)
        assert got.tobytes() == want.tobytes()


# --------------------------------------------------- distinct_approx (HLL)

def _events_records():
    rng = np.random.default_rng(41)
    cities = ["SF", "Berkeley", "Oakland", "Fremont", "LA"]
    return [{"id": int(i), "day": int(rng.integers(0, 3)),
             "city": cities[int(rng.integers(0, len(cities)))]}
            for i in range(600)]


def _events_db(fdb_mod, schema_mod):
    schema = schema_mod.Schema("Events", [
        schema_mod.Field("id", schema_mod.INT, indexes=("tag",)),
        schema_mod.Field("day", schema_mod.INT, indexes=("tag",)),
        schema_mod.Field("city", schema_mod.STRING, indexes=("tag",)),
    ])
    return fdb_mod.build_fdb("Events", schema, _events_records(),
                             num_shards=7)


@pytest.fixture(scope="module")
def events():
    """(records, the port's catalog, the JAX package's catalog)."""
    cat = Catalog(server_slots=4)
    cat.register(_events_db(pfdb, pschema))
    jcat = jexec.Catalog(server_slots=4)
    jcat.register(_events_db(jfdb, jschema))
    return _events_records(), cat, jcat


def _by_day(batch, name):
    return {int(d): float(v) for d, v in zip(batch["day"].values,
                                             batch[name].values)}


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_distinct_approx_matches_hll_oracle(events, parts):
    """Grouped approx_distinct through the torch backend's segment max
    equals a per-group HyperLogLog built from the raw values (the port's
    and the JAX package's sketch), at every P; one ``segment_hll`` a
    finalize that holds the aggregate."""
    recs, cat, _ = events
    flow = fdb("Events").aggregate(core.group(P.day).approx_distinct(
        "n_cities", expr=P.city))
    ops.reset_launch_counts()
    res = AdHocEngine(cat, backend=TorchBackend(device="cpu"), wave=3,
                      partitions=parts).collect(flow)
    got = _by_day(res.batch, "n_cities")
    assert ops.launch_counts()["segment_hll"] >= 1
    assert sorted(got) == [0, 1, 2]
    for day in sorted(got):
        strs = [r["city"] for r in recs if r["day"] == day]
        want = HyperLogLog().add(np.arange(len(strs)), vocab=strs)
        jwant = JHyperLogLog().add(np.arange(len(strs)), vocab=strs)
        assert got[day] == want.estimate() == jwant.estimate()


def test_distinct_approx_partition_and_backend_invariant(events):
    """Flow.distinct_approx: the same estimate at P = 1/2/4 on the torch
    backend and the port's numpy oracle, and the JAX package's numpy
    engine's (register max is commutative and idempotent)."""
    _, cat, jcat = events
    ests = set()
    for bname in ("torch", "numpy"):
        for parts in (1, 2, 4):
            res = AdHocEngine(cat, backend=_backend(bname), wave=3,
                              partitions=parts).collect(
                fdb("Events").distinct_approx(P.id, name="n_ids"))
            assert res.batch.n == 1
            ests.add(float(res.batch["n_ids"].values[0]))
    jres = jexec.AdHocEngine(jcat, backend="numpy", wave=3).collect(
        jcore.fdb("Events").distinct_approx(jcore.P.id, name="n_ids"))
    ests.add(float(jres.batch["n_ids"].values[0]))
    assert len(ests) == 1
    assert abs(ests.pop() - 600) / 600 < 0.1


def test_segment_hll_launches_follow_finalizes(events):
    """One ``segment_hll`` per aggregate finalize that holds an
    ``approx_distinct`` — a per-shard partial each, as
    ``exec/processors.py`` builds them — and none from the host oracle."""
    _, cat, _ = events
    flow = fdb("Events").aggregate(core.group(P.day).count("n")
                                   .approx_distinct("d", expr=P.id))
    ops.reset_launch_counts()
    AdHocEngine(cat, backend=TorchBackend(device="cpu"), wave=3).collect(flow)
    assert ops.launch_counts()["segment_hll"] == sum(
        1 for sh in cat.get("Events").shards if sh.n)
    ops.reset_launch_counts()
    AdHocEngine(cat, backend=NumpyBackend(), wave=3).collect(flow)
    assert "segment_hll" not in ops.launch_counts()


# ------------------------------------------------------------ handcrafted db

PA, PB = (37.40, -122.40), (37.60, -122.20)


def _pt_region(latlng, d=100_000):
    ix, iy = M.latlng_to_xy(*latlng)
    return AreaTree.from_box(int(ix) - d, int(iy) - d,
                             int(ix) + d, int(iy) + d, max_level=7)


def _track(*pts):
    return {"lat": [p[0][0] for p in pts], "lng": [p[0][1] for p in pts],
            "t": [float(p[1]) for p in pts]}


def _track_schema(name="Visits") -> Schema:
    return Schema(name, [
        Field("id", INT, indexes=("tag",)),
        Field("track", MESSAGE, fields=[
            Field("lat", DOUBLE, repeated=True),
            Field("lng", DOUBLE, repeated=True),
            Field("t", DOUBLE, repeated=True)],
            indexes=("spacetime",),
            index_params={"level": 6, "bucket_s": 900.0, "epoch": 0.0}),
    ])


#: every reduction edge case in one fixture: id → (track, A-hits, A-span)
_CASES = [
    _track(),                                             # 0: empty track
    _track((PA, 100.0)),                                  # 1: single A hit
    _track((PA, 100.0), (PA, 200.0), (PA, 300.0)),        # 2: 3 hits, span 200
    _track((PA, 100.0), (PA, 100.0), (PA, 100.0)),        # 3: tied ts, span 0
    _track((PA, 100.0), (PA, 400.0)),                     # 4: span exactly 300
    _track((PB, 100.0)),                                  # 5: B only
    _track((PA, 100.0), (PB, 200.0)),                     # 6: A and B
]


@pytest.fixture(scope="module")
def visits_db():
    recs = [{"id": i, "track": tr} for i, tr in enumerate(_CASES)]
    sizes = [4, 0, 3]                 # incl. an empty shard
    bounds = np.cumsum([0] + sizes)
    key = lambda r: int(np.searchsorted(bounds, r["id"], "right") - 1)
    db = build_fdb("Visits", _track_schema(), recs,
                   num_shards=len(sizes), shard_key=key)
    assert [s.n for s in db.shards] == sizes
    return db


def _select(db, tess, backend, fused_, wave=2, partitions=None):
    cat = Catalog(server_slots=4)
    cat.register(db)
    eng = AdHocEngine(cat, backend=backend, wave=wave,
                      partitions=partitions,
                      config=ExecConfig(fused=fused_))
    res = eng.collect(fdb(db.name).tesseract(tess).map(
        lambda p: proto(id=p.id)))
    return sorted(res.batch["id"].values.tolist())


#: (tesseract constructor, expected ids) — handcrafted reduction verdicts
_SCENARIOS = [
    (lambda A, B: Tesseract(A, 0.0, 1000.0).at_least(2), [2, 3, 4]),
    (lambda A, B: Tesseract(A, 0.0, 1000.0).at_least(4), []),
    (lambda A, B: Tesseract(A, 0.0, 1000.0).at_least(0),
     [0, 1, 2, 3, 4, 5, 6]),
    (lambda A, B: Tesseract(A, 0.0, 1000.0).at_least(0)
     .also(B, 0.0, 1000.0), [5, 6]),
    (lambda A, B: Tesseract(A, 0.0, 1000.0).dwell(300.0), [4]),
    (lambda A, B: Tesseract(A, 0.0, 1000.0).dwell(300.5), []),
    (lambda A, B: Tesseract(A, 0.0, 1000.0).dwell(0.0), [1, 2, 3, 4, 6]),
    (lambda A, B: Tesseract(A, 0.0, 1000.0).at_least(3).dwell(150.0), [2]),
]


@pytest.mark.parametrize("case", range(len(_SCENARIOS)))
@pytest.mark.parametrize("fused_", [True, False])
def test_reduction_semantics(visits_db, case, fused_):
    """Handcrafted count/dwell verdicts hold on the torch backend, fused
    and per-primitive paths alike, as on the numpy oracle."""
    build, want = _SCENARIOS[case]
    tess = build(_pt_region(PA), _pt_region(PB))
    assert _select(visits_db, tess, TorchBackend(device="cpu"),
                   fused_) == want
    assert _select(visits_db, tess, NumpyBackend(), fused_) == want


def test_reduction_partition_invariance(visits_db):
    """P = 2 and 4 split the shard axis; reduction verdicts are
    unchanged."""
    tess = Tesseract(_pt_region(PA), 0.0, 1000.0).at_least(2).also(
        _pt_region(PB), 0.0, 1000.0).dwell(0.0)
    base = _select(visits_db, tess, NumpyBackend(), True, partitions=1)
    for parts in (1, 2, 4):
        assert _select(visits_db, tess, TorchBackend(device="cpu"), True,
                       partitions=parts) == base


# ------------------------------------------- word-boundary analytics parity

def _walks(n, rng, empty_every=7):
    recs = []
    for i in range(n):
        ln = 0 if (empty_every and i % empty_every == 0) \
            else int(rng.integers(1, 14))
        lat = rng.uniform(37.2, 38.0, ln)
        lng = rng.uniform(-122.6, -121.8, ln)
        t = np.sort(rng.uniform(0.0, 3 * 86400.0, ln))
        recs.append({"id": i, "track": {"lat": lat.tolist(),
                                        "lng": lng.tolist(),
                                        "t": t.tolist()}})
    return recs


def _region(rng, d=2_000_000):
    ix, iy = M.latlng_to_xy(rng.uniform(37.2, 38.0),
                            rng.uniform(-122.6, -121.8))
    return AreaTree.from_box(int(ix) - d, int(iy) - d,
                             int(ix) + d, int(iy) + d, max_level=7)


@pytest.fixture(scope="module")
def walks_db():
    sizes = [32, 31, 64, 65, 1, 0, 33]    # 32-bit word boundaries + empty
    recs = _walks(sum(sizes), np.random.default_rng(29))
    bounds = np.cumsum([0] + sizes)
    key = lambda r: int(np.searchsorted(bounds, r["id"], "right") - 1)
    db = build_fdb("Walks", _track_schema("Walks"), recs,
                   num_shards=len(sizes), shard_key=key)
    assert [s.n for s in db.shards] == sizes
    return db


def test_analytics_tables_batched_parity(walks_db):
    """Wave-stacked analytics (mask + first/last/count tables) byte-equal
    between the torch backend and the numpy oracle at word-boundary
    shard sizes, with candidates."""
    rng = np.random.default_rng(3)
    cons = [(_region(rng), 0.0, 2 * 86400.0),
            (_region(rng), 43200.0, 3 * 86400.0)]
    batches = [s.batch for s in walks_db.shards]
    cands = [rng.random(b.n) < 0.8 for b in batches]
    outs = {}
    for bname in ("numpy", "torch"):
        be = _backend(bname)
        be.prime_fdb(walks_db)
        outs[bname] = be.refine_tracks_batched(
            batches, "track", cons, cands, min_counts=(2, 1),
            dwells=(None, 600.0), with_analytics=True)
    for part in range(4):                 # masks, firsts, lasts, counts
        for a, b in zip(outs["numpy"][part], outs["torch"][part]):
            assert a.dtype == b.dtype
            assert np.array_equal(a, b), part
    assert any(m.any() for m in outs["numpy"][0])   # non-vacuous


@pytest.mark.parametrize("parts", [1, 2])
def test_reduction_launch_contract(walks_db, parts):
    """Count/dwell reductions ride the fused wave dispatches — no extra
    launch against a plain trip query, Σ_p ⌈shards_p/wave⌉ in all."""
    cat = Catalog(server_slots=4)
    cat.register(walks_db)
    rng = np.random.default_rng(7)
    tess = Tesseract(_region(rng), 0.0, 2 * 86400.0).at_least(2).also(
        _region(rng), 43200.0, 3 * 86400.0).dwell(600.0)
    flow = fdb("Walks").tesseract(tess).map(lambda p: proto(id=p.id))
    wave = 3
    eng = AdHocEngine(cat, backend=TorchBackend(device="cpu"), wave=wave,
                      partitions=parts, config=ExecConfig(fused=True))
    eng.collect(flow)                     # warm
    ops.reset_launch_counts()
    got = eng.collect(flow)
    waves = partition_shards(range(walks_db.num_shards),
                             parts).wave_dispatches(wave)
    assert ops.launch_counts() == {"run_wave_fused": waves}
    want = AdHocEngine(cat, backend=NumpyBackend(), wave=wave).collect(flow)
    assert sorted(got.batch["id"].values.tolist()) == \
        sorted(want.batch["id"].values.tolist())


# ------------------------------------------------- Tesseract label plumbing

def test_labels_and_before():
    A, B = _pt_region(PA), _pt_region(PB)
    by_label = (Tesseract(A, 0.0, 1000.0, label="home")
                .also(B, 0.0, 1000.0, label="work").before("home", "work"))
    by_index = (Tesseract(A, 0.0, 1000.0)
                .also(B, 0.0, 1000.0).before(0, 1))
    assert by_label.order_edges == by_index.order_edges == ((0, 1),)
    t = (Tesseract(A, 0.0, 1000.0, label="home")
         .also(B, 0.0, 1000.0, label="work")
         .at_least(2, "home").dwell(60.0, 1))
    assert t.min_counts == (2, 1)
    assert t.dwells == (None, 60.0)
    with pytest.raises(ValueError):
        Tesseract(A, 0.0, 1000.0, label="home").before("home", "gym")
