"""``TorchBackend`` ops held against the numpy oracles, op by op.

``TorchBackend(device="cpu")`` runs every kernel wrapper's plain PyTorch
version; each op — the wave ops, the single-shard seam and the
multi-query (coalesced) ops — is compared with the port's copied
``NumpyBackend`` and with the JAX package's ``NumpyBackend`` on the same
inputs (made with numpy from a seed, or the same synthetic world built
by both packages), and its logical launches are counted.
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


def test_partition_context(cpu):
    """Entered around each partition's waves; on a backend on the CPU it
    places nothing, at any P (one device, one cache).  Placement on cards
    is ``tests/test_torch_multicard.py``'s."""
    with cpu.partition_context(0, 1):
        pass
    for p in (2, 4):
        for i in range(p):
            with cpu.partition_context(i, p):
                pass


# ----------------------------------------------------- single-shard seam

@pytest.mark.parametrize("n", [1, 31, 64, 1000, 9999])
@pytest.mark.parametrize("k", [0, 1, 4])
def test_intersect_and_select_parity(cpu, n, k):
    """One ``bitmap_intersect`` launch for K ≥ 1 probes (none for K = 0,
    as the JAX package returns the valid-doc bitmap itself), then one
    ``compact`` launch for the ids; equal to both numpy oracles."""
    rng = np.random.default_rng(n + k)
    full = bitmap_from_ids(np.arange(n), n)
    probes = [bitmap_from_ids(rng.choice(n, size=max(1, n // 2),
                                         replace=False), n)
              for _ in range(k)]
    ops.reset_launch_counts()
    got = cpu.intersect_bitmaps(full, probes)
    ids = cpu.select_ids(got, n)
    assert ops.launch_counts() == ({"bitmap_intersect": 1, "compact": 1}
                                   if k else {"compact": 1})
    assert got.dtype == np.uint32 and ids.dtype == np.int64
    for oracle in _backends(cpu)[1:]:
        want = oracle.intersect_bitmaps(full, probes)
        assert np.array_equal(got, want)
        assert np.array_equal(ids, oracle.select_ids(want, n))


@pytest.mark.parametrize("n,density", [(1, 0.0), (100, 0.5), (5000, 0.9),
                                       (0, 0.5)])
def test_compact_mask_parity(cpu, n, density):
    mask = np.random.default_rng(n).random(n) < density
    got = cpu.compact_mask(mask)
    for oracle in _backends(cpu)[1:]:
        want = oracle.compact_mask(mask)
        assert got.dtype == want.dtype == np.int64
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n,g", [(1, 1), (1000, 7), (20000, 300)])
def test_segment_aggregate_parity(cpu, n, g):
    """float64 staging on the CPU, row-order sums: bit-equal."""
    rng = np.random.default_rng(g)
    codes = np.where(rng.random(n) < .1, -1, rng.integers(0, g, n))
    vals = rng.normal(50.0, 9.0, n)
    ops.reset_launch_counts()
    got = cpu.segment_aggregate(codes, vals, g)
    assert ops.launch_counts() == {"segment_agg": 1}
    for oracle in _backends(cpu)[1:]:
        _assert_same(got, oracle.segment_aggregate(codes, vals, g))


@pytest.mark.parametrize("kw", REFINE_KW)
def test_refine_tracks_single_shard(cpu, trips, kw):
    """The single-shard refine: one ``refine_tracks`` launch, masks and
    tables restricted by candidates, equal to both numpy oracles."""
    db, jdb = trips
    rng = np.random.default_rng(8)
    cons = _refine_args(db)
    hits = 0
    for i in range(db.num_shards):
        sh, jsh = db.shards[i], jdb.shards[i]
        full = NumpyBackend().refine_tracks(
            sh.batch, "track", cons,
            **{k: v for k, v in kw.items() if k in ("edges", "min_counts",
                                                    "dwells")})
        full = full[0] if isinstance(full, tuple) else full
        for cand in (None, (rng.random(sh.n) < .6) | full):
            ops.reset_launch_counts()
            got = cpu.refine_tracks(sh.batch, "track", cons, cand, **kw)
            assert ops.launch_counts() == {"refine_tracks": 1}
            _assert_same(got, NumpyBackend().refine_tracks(
                sh.batch, "track", cons, cand, **kw))
            _assert_same(got, JNumpyBackend().refine_tracks(
                jsh.batch, "track", cons, cand, **kw))
        hits += int(full.sum())
    assert hits > 0                          # the case discriminates


def test_refine_tracks_single_shard_declines(cpu, trips):
    """0 or more than 30 constraints, or a path without a track: the
    host oracle, no launch."""
    db, _ = trips
    sh = db.shards[0]
    for path, cons in (("track", []), ("track", _refine_args(db) * 16),
                       ("nothere", _refine_args(db))):
        ops.reset_launch_counts()
        if path == "nothere":
            with pytest.raises(KeyError):
                cpu.refine_tracks(sh.batch, path, cons)
        else:
            _assert_same(cpu.refine_tracks(sh.batch, path, cons),
                         NumpyBackend().refine_tracks(sh.batch, path, cons))
        assert ops.launch_counts() == {}


def test_postings_bitmap_parity(cpu, trips):
    """The spacetime lookup through the seam (the retry path's probe)
    equals the host lookup, bit for bit."""
    db, _ = trips
    region, t0, t1 = _refine_args(db)[0]
    for sh in db.shards:
        idx = sh.index("track", "spacetime")
        ops.reset_launch_counts()
        got = idx.lookup(region, t0, t1, backend=cpu)
        assert ops.launch_counts() == {"postings_bitmap": 1}
        want = idx.lookup(region, t0, t1)
        assert got.dtype == np.uint32 and np.array_equal(got, want)


# ------------------------------------------------ multi-query (coalesced)

def _multi_setup(db, with_ordered=True):
    """Three queries' constraint lists (1–2 constraints, one ordered)
    and their probe bitmaps over every shard of ``db``."""
    sf, bk, la = (city_region(c) for c in ("SF", "Berkeley", "LA"))
    day = 2 * 86400.0
    cons_list = [[(sf, day, day + 18 * 3600.0)],
                 [(bk, day + 6 * 3600.0, day + 14 * 3600.0),
                  (sf, day, day + 20 * 3600.0)],
                 [(sf, day + 6 * 3600.0, day + 12 * 3600.0),
                  (la, day, day + 86400.0)]]
    edges_list = [(), (), ((0, 1),) if with_ordered else ()]
    probes_multi = [[[sh.index("track", "spacetime").lookup(*c)
                      for c in cons] for sh in db.shards]
                    for cons in cons_list]
    return cons_list, edges_list, probes_multi


def test_probe_shards_multi(cpu, trips):
    """Q queries' probes in one launch (query axis folded into shards),
    per query equal to the loop-over-queries oracles."""
    db, _ = trips
    _, _, probes_multi = _multi_setup(db)
    fulls = [sh.all_bitmap() for sh in db.shards]
    ops.reset_launch_counts()
    got = cpu.probe_shards_multi(fulls, probes_multi)
    assert ops.launch_counts() == {"bitmap_intersect_batched": 1}
    for oracle in _backends(cpu)[1:]:
        _assert_same(got, oracle.probe_shards_multi(fulls, probes_multi))
    assert cpu.probe_shards_multi(fulls, []) == []
    assert cpu.probe_shards_multi([], probes_multi) == [[], [], []]


@pytest.mark.parametrize("kw", [
    {}, {"with_first_hits": True},
    {"min_counts_list": [None, (2, 1), None]},
    {"dwells_list": [(600.0,), None, None], "with_first_hits": True},
])
def test_refine_tracks_multi(cpu, trips, kw):
    """One ``refine_tracks_multi`` launch for Q queries: masks (edges,
    candidates, reductions) and first-hit tables with the pad
    constraints cut off, equal to both loop-over-queries oracles."""
    db, jdb = trips
    cons_list, edges_list, _ = _multi_setup(db)
    rng = np.random.default_rng(12)
    cands = [[rng.random(sh.n) < .8 for sh in db.shards], None,
             [None] + [rng.random(sh.n) < .5 for sh in db.shards[1:]]]
    args = (cons_list, cands, edges_list)
    ops.reset_launch_counts()
    got = cpu.refine_tracks_multi([sh.batch for sh in db.shards], "track",
                                  *args, **kw)
    assert ops.launch_counts() == {"refine_tracks_multi": 1}
    _assert_same(got, NumpyBackend().refine_tracks_multi(
        [sh.batch for sh in db.shards], "track", *args, **kw))
    _assert_same(got, JNumpyBackend().refine_tracks_multi(
        [sh.batch for sh in jdb.shards], "track", *args, **kw))
    masks = [q[0] if isinstance(q, tuple) else q for q in got]
    assert all(any(m.any() for m in qm) for qm in masks)


def test_refine_tracks_multi_declines(cpu, trips):
    """A query with no constraint: the loop-over-queries oracle."""
    db, _ = trips
    cons_list, _, _ = _multi_setup(db)
    batches = [sh.batch for sh in db.shards]
    ops.reset_launch_counts()
    got = cpu.refine_tracks_multi(batches, "track", cons_list + [[]])
    assert "refine_tracks_multi" not in ops.launch_counts()
    _assert_same(got, NumpyBackend().refine_tracks_multi(
        batches, "track", cons_list + [[]]))


def _refine_specs(cons_list, edges_list, min_counts=None, dwells=None):
    from repro_torch.core.planner import RefineSpec
    return [RefineSpec("track", tuple(c), tuple(e),
                       min_counts=min_counts, dwells=dwells)
            for c, e in zip(cons_list, edges_list)]


@pytest.mark.parametrize("reduce", [False, True])
def test_run_wave_fused_multi(cpu, trips, reduce):
    """Q coalesced queries through one wave in one dispatch, per query
    equal to the loop-over-queries oracles and to the single-query fused
    path; the next wave is prefetched."""
    db, _ = trips
    cons_list, edges_list, probes_multi = _multi_setup(db)
    refines = _refine_specs(cons_list, edges_list)
    if reduce:
        from dataclasses import replace
        refines[1] = replace(refines[1], min_counts=(2, 1))
        refines[0] = replace(refines[0], dwells=(600.0,))
    shards = list(db.shards)
    cpu.trace_events = []
    ops.reset_launch_counts()
    got = cpu.run_wave_fused_multi(shards, probes_multi, refines,
                                   prefetch_shards=shards[:1])
    assert ops.launch_counts() == {"run_wave_fused_multi": 1}
    assert cpu.trace_events == [("prefetch", 1)]
    cpu.trace_events = None
    want = NumpyBackend().run_wave_fused_multi(shards, probes_multi,
                                               refines)
    _assert_same(got, want)
    for q in range(3):
        single = cpu.run_wave_fused(shards, probes_multi[q], refines[q])
        _assert_same(got[q], single[:2])
    assert all(sum(len(i) for i in ids) for _, ids in got)


def test_run_wave_fused_multi_declines(cpu, trips):
    """Mixed refine/no-refine groups, a query with only vacuous (k = 0)
    constraints, and >30 constraints decline; an all-empty wave still
    counts its one dispatch."""
    db, _ = trips
    cons_list, edges_list, probes_multi = _multi_setup(db)
    refines = _refine_specs(cons_list, edges_list)
    shards = list(db.shards)
    ops.reset_launch_counts()
    assert cpu.run_wave_fused_multi(shards, probes_multi,
                                    [None] + refines[1:]) is None
    vac = _refine_specs(cons_list[:1], [()], min_counts=(0,))
    assert cpu.run_wave_fused_multi(shards, probes_multi[:1], vac) is None
    wide = _refine_specs([cons_list[1] * 16], [()])
    assert cpu.run_wave_fused_multi(shards, probes_multi[1:2], wide) is None
    assert ops.launch_counts() == {}
    w = generate_world(scale=0.1, seed=4)
    empty = build_fdb("Empty", w["trips_schema"], [], num_shards=2)
    got = cpu.run_wave_fused_multi(list(empty.shards), [[[], []]] * 2,
                                   [None, None])
    assert ops.launch_counts() == {"run_wave_fused_multi": 1}
    assert len(got) == 2 and all(
        c == [0, 0] and all(i.size == 0 for i in ids) for c, ids in got)


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
