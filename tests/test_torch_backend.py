"""``TorchBackend`` ops held against the numpy oracles, op by op.

``TorchBackend(device="cpu")`` runs every kernel wrapper's plain PyTorch
version; each wave op is compared with the port's copied ``NumpyBackend``
and with the JAX package's ``NumpyBackend`` on the same inputs (made with
numpy from a seed, or the same synthetic world built by both packages).
Selections, masks and reduction tables are equal; with float64 staging
on the CPU the aggregates are bit-equal too.
"""
import gc
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.exec.backend import NumpyBackend as JNumpyBackend  # noqa: E402
from repro.data.synthetic import generate_world as j_generate_world  # noqa
from repro.fdb import build_fdb as j_build_fdb        # noqa: E402
from repro.fdb.index import bitmap_from_ids           # noqa: E402

from repro_torch.data.synthetic import city_region, generate_world  # noqa
from repro_torch.exec import (ExecConfig, NumpyBackend,  # noqa: E402
                              TorchBackend, get_backend)
from repro_torch.fdb import build_fdb                 # noqa: E402
from repro_torch.kernels import ops                   # noqa: E402


@pytest.fixture(scope="module")
def trips():
    """The same Trips FDb built by the port and by the JAX package."""
    w = generate_world(scale=0.4, seed=3)
    jw = j_generate_world(scale=0.4, seed=3)
    return (build_fdb("Trips", w["trips_schema"], w["trips"], num_shards=5),
            j_build_fdb("Trips", jw["trips_schema"], jw["trips"],
                        num_shards=5))


@pytest.fixture
def cpu():
    return TorchBackend(device="cpu")


def _backends(cpu):
    return cpu, NumpyBackend(), JNumpyBackend()


def _assert_same(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        # values only: numpy's bincount gives a weighted sum over no rows
        # an int dtype
        assert a.shape == b.shape and np.array_equal(a, b)


def _ragged_bitmaps(rng, ns, k):
    fulls = [bitmap_from_ids(np.arange(n), n) for n in ns]
    probes = [[bitmap_from_ids(np.nonzero(rng.random(n) < .6)[0], n)
               for _ in range(int(rng.integers(0, k + 1)))] for n in ns]
    return fulls, probes


@pytest.mark.parametrize("ns", [[65, 0, 31, 32], [1], [0, 0]])
def test_probe_shards(cpu, ns):
    rng = np.random.default_rng(len(ns))
    fulls, probes = _ragged_bitmaps(rng, ns, 3)
    ops.reset_launch_counts()
    got = cpu.probe_shards(fulls, probes)
    launched = ops.launch_counts().get("bitmap_intersect_batched", 0)
    assert launched == (1 if max(ns) else 0)
    for oracle in _backends(cpu)[1:]:
        _assert_same(got, oracle.probe_shards(fulls, probes))


@pytest.mark.parametrize("ns", [[33, 0, 64, 65], [0], [4100, 7]])
def test_compact_masks(cpu, ns):
    rng = np.random.default_rng(sum(ns))
    masks = [rng.random(n) < .4 for n in ns]
    got = cpu.compact_masks(masks)
    assert all(g.dtype == np.int64 for g in got)
    for oracle in _backends(cpu)[1:]:
        _assert_same(got, oracle.compact_masks(masks))


def test_segment_aggregate_batched_bit_equal(cpu):
    rng = np.random.default_rng(9)
    groups = [7, 0, 130, 1]
    ns = [300, 12, 2000, 0]
    codes = [np.where(rng.random(n) < .1, -1, rng.integers(0, max(g, 1), n))
             if g else np.full(n, -1) for g, n in zip(groups, ns)]
    values = [rng.normal(48.0, 9.0, n) for n in ns]
    ops.reset_launch_counts()
    got = cpu.segment_aggregate_batched(codes, values, groups)
    assert ops.launch_counts() == {"segment_agg": 1}
    for oracle in _backends(cpu)[1:]:
        _assert_same(got, oracle.segment_aggregate_batched(codes, values,
                                                           groups))


def _refine_args(db):
    sf, bk = city_region("SF"), city_region("Berkeley")
    day = 2 * 86400.0
    return [(sf, day + 6 * 3600.0, day + 12 * 3600.0),
            (bk, day + 6 * 3600.0, day + 14 * 3600.0)]


REFINE_KW = [
    {},
    {"edges": ((0, 1),)},
    {"with_first_hits": True},
    {"min_counts": (2, 1)},
    {"min_counts": (0, 1), "with_analytics": True},
    {"dwells": (600.0, None), "edges": ((1, 0),)},
]


@pytest.mark.parametrize("kw", REFINE_KW)
def test_refine_tracks_batched(cpu, trips, kw):
    """Masks and first/last/count tables per shard, restricted by
    candidates, against both numpy oracles; one refine launch a wave."""
    db, jdb = trips
    rng = np.random.default_rng(2)
    cons = _refine_args(db)
    full = NumpyBackend().refine_tracks_batched(
        [sh.batch for sh in db.shards], "track", cons,
        **{k: v for k, v in kw.items() if k in ("edges", "min_counts",
                                                "dwells")})
    # candidates drop docs at random but keep every doc that passes, so
    # the restriction is exercised and the result still selects
    cands = [(rng.random(sh.n) < .7) | m for sh, m in zip(db.shards, full)]
    cands[1] = None
    ops.reset_launch_counts()
    got = cpu.refine_tracks_batched([sh.batch for sh in db.shards],
                                    "track", cons, cands, **kw)
    assert ops.launch_counts() == {"refine_tracks_batched": 1}
    want = NumpyBackend().refine_tracks_batched(
        [sh.batch for sh in db.shards], "track", cons, cands, **kw)
    jwant = JNumpyBackend().refine_tracks_batched(
        [sh.batch for sh in jdb.shards], "track", cons, cands, **kw)
    _assert_same(got, want)
    _assert_same(got, jwant)
    masks = got[0] if isinstance(got, tuple) else got
    assert any(m.any() for m in masks)       # the case discriminates


def test_refine_declines_to_host_oracle(cpu, trips):
    """0 or more than 30 constraints: the host oracle, no launch."""
    db, _ = trips
    cons = _refine_args(db) * 16                    # 32 constraints
    ops.reset_launch_counts()
    got = cpu.refine_tracks_batched([sh.batch for sh in db.shards],
                                    "track", cons)
    assert ops.launch_counts() == {}
    _assert_same(got, NumpyBackend().refine_tracks_batched(
        [sh.batch for sh in db.shards], "track", cons))


def test_prime_fdb_and_gather_columns(cpu, trips):
    """Priming copies each buffer once; gathers from resident buffers
    (dense and ragged) equal the host gather; a collected FDb's buffers
    are evicted."""
    db, _ = trips
    w = generate_world(scale=0.1, seed=4)
    tmp = build_fdb("Tmp", w["trips_schema"], w["trips"], num_shards=2)
    n = cpu.prime_fdb(tmp)
    assert n > 0 and cpu.prime_fdb(tmp) == 0
    assert len(cpu.device_cache) == n
    sh = tmp.shards[0]
    ids = np.array([0, 3, 2, sh.n - 1], dtype=np.int64)
    paths = ["id", "track.lat", "track.t", "duration_s"]
    got = cpu.gather_columns(sh.batch, paths, ids)
    want = NumpyBackend().gather_columns(sh.batch, paths, ids)
    assert cpu.device_cache.stats()["hits"] >= len(paths)
    for p in paths:
        assert np.array_equal(got[p].values, want[p].values)
        assert got[p].values.dtype == want[p].values.dtype
        if want[p].row_splits is not None:
            assert np.array_equal(got[p].row_splits, want[p].row_splits)
    del tmp, sh, got, want
    gc.collect()
    assert len(cpu.device_cache) == 0


@pytest.mark.parametrize("with_agg", [False, True])
def test_run_wave_fused_vs_oracles(cpu, trips, with_agg):
    """One fused dispatch a wave, equal to both loop-over-stages
    oracles: candidate counts, ids and (float64, bit-equal) partials."""
    from repro.core import P as JP, fdb as jfdb, group as jgroup
    from repro.core.planner import plan_flow as j_plan_flow
    from repro.exec import Catalog as JCatalog
    from repro.exec.batched import fused_agg_plan as j_fused_agg_plan
    from repro.tess import Tesseract as JTesseract
    from repro_torch.core import P, fdb, group
    from repro_torch.core.planner import plan_flow
    from repro_torch.exec import Catalog
    from repro_torch.exec.batched import fused_agg_plan
    from repro_torch.tess import Tesseract
    db, jdb = trips
    cons = _refine_args(db)

    def make(fdb_, group_, P_, T):
        t = T(*cons[0]).then(*cons[1])
        f = fdb_("Trips").tesseract(t)
        if with_agg:
            f = f.aggregate(group_(P_.day).count("n").avg(d=P_.duration_s)
                            .std_dev(sd=P_.duration_s))
        return f

    cat, jcat = Catalog(), JCatalog()
    cat.register(db)
    jcat.register(jdb)
    plan = plan_flow(make(fdb, group, P, Tesseract), cat)
    jplan = j_plan_flow(make(jfdb, jgroup, JP, JTesseract), jcat)
    shards = [db.shards[s] for s in plan.shard_ids]
    jshards = [jdb.shards[s] for s in jplan.shard_ids]
    probes = [[p.run(sh) for p in plan.probes] for sh in shards]
    jprobes = [[p.run(sh) for p in jplan.probes] for sh in jshards]
    agg = fused_agg_plan(plan, shards) if with_agg else None
    jagg = j_fused_agg_plan(jplan, jshards) if with_agg else None
    ops.reset_launch_counts()
    got = cpu.run_wave_fused(shards, probes, plan.refines[0], agg)
    assert ops.launch_counts() == {"run_wave_fused": 1}
    want = NumpyBackend().run_wave_fused(shards, probes, plan.refines[0],
                                         agg)
    jwant = JNumpyBackend().run_wave_fused(jshards, jprobes,
                                           jplan.refines[0], jagg)
    _assert_same(got[:2], want[:2])
    _assert_same(got[:2], jwant[:2])
    assert sum(len(i) for i in got[1]) > 0
    if with_agg:
        _assert_same(got[2], want[2])
        _assert_same(got[2], jwant[2])
    else:
        assert got[2] is None


def test_no_cpu_fallback(monkeypatch):
    """Without a CUDA device the CUDA default raises — through the class,
    the registry and ExecConfig's default — instead of carrying on.  The
    JAX package's backend variable does not move the port's default onto
    the host oracle."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("REPRO_EXEC_BACKEND", "numpy")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_backend("torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_backend()
    with pytest.raises(RuntimeError, match="CUDA"):
        ExecConfig().resolve_backend()
    assert TorchBackend(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("op,args", [
    ("intersect_bitmaps", (None, [])), ("select_ids", (None, 0)),
    ("compact_mask", (None,)), ("segment_aggregate", (None, None, 0)),
    ("merge_partials", ([],)), ("postings_bitmap", (None,) * 6),
    ("segment_hll", (None,) * 5), ("probe_shards_multi", ([], [])),
    ("refine_tracks_multi", ()), ("run_wave_fused_multi", ()),
])
def test_unported_ops_raise(cpu, op, args):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(cpu, op)(*args)


def test_partition_context(cpu):
    with cpu.partition_context(0, 1):
        pass
    with pytest.raises(NotImplementedError):
        cpu.partition_context(0, 2)


def test_wave_launch_contract_counts(cpu, trips):
    """ceil(shards/wave) logical dispatches for the batched ops too."""
    db, _ = trips
    assert math.ceil(db.num_shards / 8) == 1
    ops.reset_launch_counts()
    cpu.compact_masks([np.ones(sh.n, bool) for sh in db.shards])
    assert ops.launch_counts() == {"compact_batched": 1}


def _trip_flow(cons, agg=True):
    from repro_torch.core import P, fdb, group
    from repro_torch.tess import Tesseract
    t = Tesseract(*cons[0]).also(*cons[1])
    f = fdb("Trips").tesseract(t)
    if agg:
        f = f.aggregate(group(P.day).count("n").avg(d=P.duration_s))
    return f


def _engine(db, backend, **kw):
    from repro_torch.exec import AdHocEngine, Catalog
    cat = Catalog()
    cat.register(db)
    return AdHocEngine(cat, backend=backend, **kw)


def test_run_wave_fused_declines(cpu, trips):
    """The fused op returns None — the engine then takes the
    per-primitive path — past 30 constraints and on an all-empty-track
    wave; the engine still answers through the fallback."""
    from repro_torch.core.planner import plan_flow
    from repro_torch.tess import Tesseract
    from repro_torch.core import fdb
    db, _ = trips
    cons = _refine_args(db)
    many = Tesseract(*cons[0])
    for _ in range(30):
        many = many.also(*cons[1])
    eng = _engine(db, cpu)
    plan = plan_flow(fdb("Trips").tesseract(many), eng.catalog)
    assert len(plan.refines[0].constraints) == 31
    shards = [db.shards[s] for s in plan.shard_ids]
    probes = [[p.run(sh) for p in plan.probes] for sh in shards]
    assert cpu.run_wave_fused(shards, probes, plan.refines[0]) is None
    recs = [{"id": i, "vehicle": 0, "day": 2, "start_hour": 6,
             "track": {"lat": [], "lng": [], "t": []}, "duration_s": 1.0}
            for i in range(12)]
    empty = build_fdb("Trips", db.schema, recs, num_shards=3)
    eng = _engine(empty, cpu, wave=2)
    plan = plan_flow(_trip_flow(cons, agg=False), eng.catalog)
    shards = [empty.shards[s] for s in plan.shard_ids]
    probes = [[p.run(sh) for p in plan.probes] for sh in shards]
    if shards:
        assert cpu.run_wave_fused(shards, probes, plan.refines[0]) is None
    assert eng.collect(_trip_flow(cons, agg=False)).batch.n == 0


def test_prefetch_stages_next_wave_before_wave_done(cpu, trips):
    """Wave k+1's stacks are staged before wave k's outputs are read:
    a ("prefetch", n) marker lands right before each non-final wave's
    ("wave_done", ...) marker."""
    db, _ = trips
    eng = _engine(db, cpu, num_servers=1, wave=2)
    flow = _trip_flow(_refine_args(db))
    eng.collect(flow)                                   # warm
    cpu.trace_events = []
    res = eng.collect(flow)
    ev, cpu.trace_events = cpu.trace_events, None
    kinds = [e[0] for e in ev]
    waves = math.ceil(len(res.plan.shard_ids) / 2)
    assert waves > 1
    assert kinds.count("wave_done") == waves
    assert kinds.count("prefetch") == waves - 1
    for i, e in enumerate(ev):
        if e[0] == "prefetch":
            assert ev[i + 1][0] == "wave_done"


def test_keyed_cache_reused_then_evicted_with_fdb(cpu):
    """Stacked wave buffers are cached under keys of their primed
    sources: reused by the next query, outside the buffer census, and
    dropped with the FDb."""
    w = generate_world(scale=0.3, seed=5)
    db = build_fdb("Trips", w["trips_schema"], w["trips"], num_shards=4)
    n = cpu.prime_fdb(db)
    eng = _engine(db, cpu, wave=2)
    flow = _trip_flow(_refine_args(db))
    eng.collect(flow)
    stats = cpu.device_cache.stats()
    assert stats["keyed"] > 0 and stats["buffers"] == n
    before = stats["keyed_hits"]
    eng.collect(flow)
    assert cpu.device_cache.stats()["keyed_hits"] > before
    del eng, db, flow
    gc.collect()
    assert len(cpu.device_cache) == 0
    assert cpu.device_cache.stats()["keyed"] == 0


def _streaming(name, flush):
    from repro_torch.fdb import DOUBLE, INT, Schema, StreamingFDb
    from repro_torch.fdb.schema import Field
    return StreamingFDb(name, Schema(name, [
        Field("id", INT, indexes=("tag",)),
        Field("val", DOUBLE, indexes=("range",)),
    ]), flush_threshold=flush, compact_threshold=0)


def test_prime_copies_only_new_delta_buffers(cpu):
    """Streaming generations share their sealed shards: priming the next
    generation copies only the new shard's buffers."""
    s = _streaming("TorchLivePrime", 8)
    s.extend([{"id": i, "val": float(i)} for i in range(16)])
    snap1 = s.snapshot()
    n1 = cpu.prime_fdb(snap1)
    assert n1 > 0 and cpu.prime_fdb(snap1) == 0
    s.extend([{"id": i, "val": float(i)} for i in range(16, 24)])
    snap2 = s.snapshot()
    n2 = cpu.prime_fdb(snap2)
    assert 0 < n2 < n1
    assert cpu.device_cache.stats()["buffers"] == n1 + n2


def test_snapshot_turnover_retires_stale_buffers(cpu):
    """Priming a newer generation drops the replaced generation's
    exclusive buffers at once and counts them on ``retired_buffers``;
    re-priming the same snapshot retires nothing."""
    s = _streaming("TorchRetire", 4)
    s.extend([{"id": i, "val": float(i)} for i in range(10)])
    snap1 = s.snapshot()           # 2 delta shards + a memtable-tail shard
    cpu.prime_fdb(snap1)
    assert cpu.device_cache.stats()["retired_buffers"] == 0
    s.extend([{"id": i, "val": float(i)} for i in range(10, 18)])
    snap2 = s.snapshot()
    cpu.prime_fdb(snap2)
    retired = cpu.device_cache.stats()["retired_buffers"]
    assert retired > 0
    cpu.prime_fdb(snap2)
    assert cpu.device_cache.stats()["retired_buffers"] == retired
