"""The port's query server: ``repro_torch.serve.QueryServer`` on
``TorchBackend(device="cpu")``.

The same FDbs are built by the port and by the JAX package from one set of
records (made with numpy from a seed).  Every served query's rows are held
to the port's numpy oracle and to the JAX package's numpy engine run on
the query alone; the multi-query seam ops are held to the base-class
loop-over-queries oracle.  Also: the coalesced launch contract (Q
compatible queries cost ⌈shards/wave⌉ ``run_wave_fused_multi`` dispatches
in all), aggregate and record-op tails, incompatible plans falling
through, admission, the result cache, ``Session.serve`` and the launch
counter under two threads.
"""
import gc
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore                            # noqa: E402
import repro.exec as jexec                            # noqa: E402
import repro.fdb as jfdb                              # noqa: E402
import repro.fdb.schema as jschema                    # noqa: E402
import repro.geo as jgeo                              # noqa: E402
import repro.tess as jtess                            # noqa: E402

import repro_torch.core as pcore                      # noqa: E402
from repro_torch.core import BETWEEN, P, Session, fdb, group  # noqa: E402
from repro_torch.core.planner import plan_flow        # noqa: E402
from repro_torch.exec import (AdHocEngine, Catalog, NumpyBackend,  # noqa
                              TorchBackend)
from repro_torch.exec.batched import FUSED_ENV        # noqa: E402
import repro_torch.fdb as pfdb                        # noqa: E402
import repro_torch.fdb.schema as pschema              # noqa: E402
import repro_torch.geo as pgeo                        # noqa: E402
from repro_torch.kernels import ops                   # noqa: E402
from repro_torch.serve import QueryServer, ResultCache, ServerBusy  # noqa
from repro_torch.tess import Tesseract                # noqa: E402

SIZES = [32, 31, 64, 65, 1, 0, 33]
WAVE = 3


# --------------------------------------------------------------- fixtures

def _dense_records():
    rng = np.random.default_rng(41)
    return [{"road": int(rng.integers(0, 12)),
             "hour": int(rng.integers(0, 24)),
             "city": ["SF", "OAK", "SJ"][int(rng.integers(0, 3))],
             "speed": float(rng.normal(48, 9)), "_i": i}
            for i in range(sum(SIZES))]


def _walk_records():
    rng = np.random.default_rng(17)
    recs = []
    for i in range(sum(SIZES)):
        ln = 0 if i % 7 == 0 else int(rng.integers(1, 14))
        recs.append({"id": i, "track": {
            "lat": rng.uniform(37.2, 38.0, ln).tolist(),
            "lng": rng.uniform(-122.6, -121.8, ln).tolist(),
            "t": np.sort(rng.uniform(0.0, 3 * 86400.0, ln)).tolist()}})
    return recs


def _shard_of(i):
    return int(np.searchsorted(np.cumsum([0] + SIZES), i, "right") - 1)


def _dense_db(fdb_mod, sch, name, recs):
    schema = sch.Schema(name, [
        sch.Field("road", sch.INT, indexes=("tag",)),
        sch.Field("hour", sch.INT, indexes=("range",)),
        sch.Field("city", sch.STRING, indexes=("tag",)),
        sch.Field("speed", sch.DOUBLE),
    ])
    return fdb_mod.build_fdb(name, schema, recs, num_shards=len(SIZES),
                             shard_key=lambda r: _shard_of(r["_i"]))


def _walks_db(fdb_mod, sch, name):
    schema = sch.Schema(name, [
        sch.Field("id", sch.INT, indexes=("tag",)),
        sch.Field("track", sch.MESSAGE, fields=[
            sch.Field("lat", sch.DOUBLE, repeated=True),
            sch.Field("lng", sch.DOUBLE, repeated=True),
            sch.Field("t", sch.DOUBLE, repeated=True)],
            indexes=("spacetime",),
            index_params={"level": 6, "bucket_s": 900.0, "epoch": 0.0}),
    ])
    return fdb_mod.build_fdb(name, schema, _walk_records(),
                             num_shards=len(SIZES),
                             shard_key=lambda r: _shard_of(r["id"]))


@pytest.fixture(scope="module")
def worlds():
    """(port catalog, JAX catalog) holding the same two FDbs."""
    dense = _dense_records()
    cat, jcat = Catalog(server_slots=16), jexec.Catalog(server_slots=16)
    cat.register(_walks_db(pfdb, pschema, "ServeWalks"))
    cat.register(_dense_db(pfdb, pschema, "ServeDense", dense))
    jcat.register(_walks_db(jfdb, jschema, "ServeWalks"))
    jcat.register(_dense_db(jfdb, jschema, "ServeDense", dense))
    return cat, jcat


@pytest.fixture(scope="module")
def catalog(worlds):
    return worlds[0]


def _region(geo, rng, d=2_000_000):
    ix, iy = geo.mercator.latlng_to_xy(rng.uniform(37.2, 38.0),
                                       rng.uniform(-122.6, -121.8))
    return geo.AreaTree.from_box(int(ix) - d, int(iy) - d,
                                 int(ix) + d, int(iy) + d, max_level=7)


def _tess_flows(n=5, seed=5, core=None, tess=None, geo=None):
    """``n`` Tesseract flows over ServeWalks (the last one ordered),
    built with one package's modules (the port's by default)."""
    c = core or pcore
    T = tess.Tesseract if tess else Tesseract
    g = geo or pgeo
    rng = np.random.default_rng(seed)
    flows = [c.fdb("ServeWalks").tesseract(
        T(_region(g, rng), 0.0, 2 * 86400.0)) for _ in range(n - 1)]
    flows.append(c.fdb("ServeWalks").tesseract(
        T(_region(g, rng), 0.0, 2 * 86400.0)
        .then(_region(g, rng), 0.0, 3 * 86400.0)))
    return flows


def _jax_tess_flows(n=5, seed=5):
    return _tess_flows(n, seed, jcore, jtess, jgeo)


def assert_identical(a, b):
    assert a.n == b.n
    assert a.paths() == b.paths()
    for p in a.paths():
        ca, cb = a[p], b[p]
        assert ca.values.dtype == cb.values.dtype, p
        assert np.array_equal(ca.values, cb.values), p
        assert ca.vocab == cb.vocab, p


def _oracles(worlds, flows, jflows=None):
    """Each flow run alone on the port's numpy engine and, when given,
    the JAX package's flows on its numpy engine."""
    cat, jcat = worlds
    np_eng = AdHocEngine(cat, num_servers=2, backend="numpy", wave=WAVE)
    port = [np_eng.collect(f) for f in flows]
    if jflows is not None:
        j_eng = jexec.AdHocEngine(jcat, num_servers=2, backend="numpy",
                                  wave=WAVE)
        for p, jf in zip(port, jflows):
            assert_identical(p.batch, j_eng.collect(jf).batch)
    return port


def _server(catalog, backend=None, **kw):
    srv = QueryServer(catalog=catalog,
                      backend=backend or TorchBackend(device="cpu"),
                      start=False, **kw)
    srv.engine.wave = WAVE
    return srv


# ------------------------------------------------- seam: multi-query ops

def test_seam_multi_ops_match_base_oracle(catalog):
    """probe_shards_multi / refine_tracks_multi / run_wave_fused_multi on
    the torch backend ≡ the base-class loop-over-queries oracle, per
    query, byte for byte (ordered and unordered constraint sets, varying
    probe and constraint counts); each is one launch."""
    walks_db = catalog.get("ServeWalks")
    rng = np.random.default_rng(3)
    tesses = [Tesseract(_region(pgeo, rng), 0.0, 2 * 86400.0)
              .also(_region(pgeo, rng), 43200.0, 3 * 86400.0),
              Tesseract(_region(pgeo, rng), 0.0, 86400.0),
              Tesseract(_region(pgeo, rng), 0.0, 2 * 86400.0)
              .then(_region(pgeo, rng), 0.0, 3 * 86400.0)]
    plans = [plan_flow(fdb("ServeWalks").tesseract(t), catalog)
             for t in tesses]
    shards = [walks_db.shards[s] for s in plans[0].shard_ids]
    probes_multi = [[[pr.run(sh) for pr in p.probes] for sh in shards]
                    for p in plans]
    refines = [p.refines[0] for p in plans]
    npb, tb = NumpyBackend(), TorchBackend(device="cpu")
    tb.prime_fdb(walks_db)

    fulls = [sh.all_bitmap() for sh in shards]
    ops.reset_launch_counts()
    got = tb.probe_shards_multi(fulls, probes_multi)
    assert ops.launch_counts() == {"bitmap_intersect_batched": 1}
    for wq, gq in zip(npb.probe_shards_multi(fulls, probes_multi), got):
        for w, g in zip(wq, gq):
            assert np.array_equal(w, g)

    batches = [sh.batch for sh in shards]
    cons_list = [list(r.constraints) for r in refines]
    edges_list = [list(r.edges) for r in refines]
    want = npb.refine_tracks_multi(batches, "track", cons_list,
                                   edges_list=edges_list)
    got = tb.refine_tracks_multi(batches, "track", cons_list,
                                 edges_list=edges_list)
    for wq, gq in zip(want, got):
        for w, g in zip(wq, gq):
            assert np.array_equal(w, g)
    # first-hit tables are part of the parity surface
    wantf = npb.refine_tracks_multi(batches, "track", cons_list,
                                    with_first_hits=True)
    gotf = tb.refine_tracks_multi(batches, "track", cons_list,
                                  with_first_hits=True)
    for (_, wt), (_, gt) in zip(wantf, gotf):
        for w, g in zip(wt, gt):
            assert np.array_equal(w, g)

    ops.reset_launch_counts()
    got = tb.run_wave_fused_multi(shards, probes_multi, refines)
    assert ops.launch_counts() == {"run_wave_fused_multi": 1}
    want = npb.run_wave_fused_multi(shards, probes_multi, refines)
    for q, (w, g) in enumerate(zip(want, got)):
        assert g[0] == w[0], q
        for wi, gi in zip(w[1], g[1]):
            assert gi.dtype == np.int64
            assert np.array_equal(gi, wi), q
    # per query it equals the single-query fused path too
    for q in range(3):
        single = tb.run_wave_fused(shards, probes_multi[q], refines[q],
                                   None)
        assert single[0] == got[q][0]
        for a, b in zip(single[1], got[q][1]):
            assert np.array_equal(a, b)


# ------------------------------------- coalesced launch contract + parity

def test_coalesced_launch_contract_and_parity(worlds, monkeypatch):
    """Q coalesced compatible queries cost ⌈shards/wave⌉ multi dispatches
    TOTAL — not Q×⌈shards/wave⌉ — and every query's rows are
    byte-identical to its single-query numpy result (port and JAX)."""
    monkeypatch.setenv(FUSED_ENV, "1")
    cat, _ = worlds
    flows = _tess_flows()
    oracle = _oracles(worlds, flows, _jax_tess_flows())
    srv = _server(cat, cache=False)
    futs = [srv.submit(f) for f in flows]
    srv.run_pending()                          # cold: primes the FDb
    for f, o in zip(futs, oracle):
        assert_identical(f.result(60).batch, o.batch)
    futs = [srv.submit(f) for f in flows]
    ops.reset_launch_counts()
    srv.run_pending()
    waves = math.ceil(cat.get("ServeWalks").num_shards / WAVE)
    assert ops.launch_counts() == {"run_wave_fused_multi": waves}
    for f, o in zip(futs, oracle):
        assert_identical(f.result(60).batch, o.batch)
    assert sum(o.batch.n for o in oracle) > 0
    st = srv.stats()
    assert st["coalesced_queries"] == 2 * len(flows)
    assert st["coalesced_batches"] == 2
    assert st["fallback_queries"] == 0


def _agg_flows(c):
    P_, B = c.P, c.BETWEEN
    return [c.fdb("ServeDense").find(B(P_.hour, 8, 17))
            .aggregate(c.group(P_.road).count("n").avg(m=P_.speed)),
            c.fdb("ServeDense").find(B(P_.hour, 0, 7))
            .aggregate(c.group(P_.road).max(mx=P_.speed)
                       .min(mn=P_.speed)),
            c.fdb("ServeDense").find(B(P_.hour, 8, 17))
            .aggregate(c.group(P_.city).count("n")),
            c.fdb("ServeDense").find(B(P_.hour, 8, 17))
            .filter(P_.speed > 40.0)
            .aggregate(c.group(P_.road).count("n")),
            c.fdb("ServeDense").find(B(P_.hour, 8, 17))
            .map(lambda p: c.proto(road=p.road, fast=p.speed > 50.0))
            .aggregate(c.group(P_.fast).count("n"))]


def test_coalesced_agg_tail_parity(worlds, monkeypatch):
    """Aggregating flows coalesce too — the selection rides the multi
    dispatch, the group-by runs in the per-query tail through the
    single-shard and batched seam ops (the ``filter`` through
    ``compact_mask``) — and match the numpy oracles bit for bit."""
    monkeypatch.setenv(FUSED_ENV, "1")
    cat, _ = worlds
    flows = _agg_flows(pcore)
    oracle = _oracles(worlds, flows, _agg_flows(jcore))
    srv = _server(cat, cache=False)
    futs = [srv.submit(f) for f in flows]
    ops.reset_launch_counts()
    srv.run_pending()
    for f, o in zip(futs, oracle):
        assert_identical(f.result(60).batch, o.batch)
    lc = ops.launch_counts()
    waves = math.ceil(cat.get("ServeDense").num_shards / WAVE)
    assert lc["run_wave_fused_multi"] == waves
    assert lc["compact"] > 0 and lc["segment_agg"] > 0
    assert srv.stats()["coalesced_queries"] == len(flows)


def test_incompatible_plans_fall_through(worlds, monkeypatch):
    """Plans outside the coalesced shape (a residual filter from an
    unindexed find() conjunct) are served through the single-query path —
    never an error — alongside coalesced peers."""
    monkeypatch.setenv(FUSED_ENV, "1")
    cat, _ = worlds
    flows = [fdb("ServeDense").find(BETWEEN(P.hour, 8, 17)
                                    & (P.speed > 40.0))
             .aggregate(group(P.road).count("n")),      # residual
             fdb("ServeDense").find(BETWEEN(P.hour, 8, 17))
             .aggregate(group(P.road).count("n")),      # coalesceable
             fdb("ServeDense").find(BETWEEN(P.hour, 8, 17))
             .sort_desc(P.speed).limit(10)]             # coalesceable
    oracle = _oracles(worlds, flows)
    srv = _server(cat, cache=False)
    futs = [srv.submit(f) for f in flows]
    srv.run_pending()
    for f, o in zip(futs, oracle):
        assert_identical(f.result(60).batch, o.batch)
    assert srv.stats()["fallback_queries"] >= 1


def test_numpy_backend_server_parity(worlds):
    """The server is backend-agnostic: a numpy-backed server coalesces
    through the base-class oracle ops and stays byte-identical."""
    cat, _ = worlds
    flows = _tess_flows(3, seed=9)
    oracle = _oracles(worlds, flows, _jax_tess_flows(3, seed=9))
    srv = _server(cat, backend=NumpyBackend(), cache=False)
    futs = [srv.submit(f) for f in flows]
    srv.run_pending()
    for f, o in zip(futs, oracle):
        assert_identical(f.result(60).batch, o.batch)


# ----------------------------------------------------- admission + server

def test_admission_bounds_and_recovery(catalog):
    srv = _server(catalog, cache=False, max_pending=2)
    f1 = srv.submit(fdb("ServeDense").find(BETWEEN(P.hour, 8, 17)))
    srv.submit(fdb("ServeDense").find(BETWEEN(P.hour, 0, 7)))
    with pytest.raises(ServerBusy):
        srv.submit(fdb("ServeDense").find(BETWEEN(P.hour, 9, 10)))
    assert srv.stats()["rejected"] == 1
    srv.run_pending()                          # queue drains
    assert f1.result(60).batch.n > 0
    f4 = srv.submit(fdb("ServeDense").find(BETWEEN(P.hour, 9, 10)))
    srv.run_pending()
    assert f4.result(60) is not None


def test_live_scheduler_threaded_submits(worlds):
    """Futures resolve through the running scheduler thread with many
    concurrent submitters; close() drains and joins."""
    cat, _ = worlds
    flows = _tess_flows(6, seed=13)
    oracle = _oracles(worlds, flows)
    with QueryServer(catalog=cat, backend=TorchBackend(device="cpu"),
                     cache=False, tick_s=0.005) as srv:
        srv.engine.wave = WAVE
        with ThreadPoolExecutor(max_workers=6) as pool:
            futs = list(pool.map(srv.submit, flows))
        for f, o in zip(futs, oracle):
            assert_identical(f.result(60).batch, o.batch)
        assert srv.stats()["served"] == len(flows)
    with pytest.raises(RuntimeError):
        srv.submit(flows[0])


def test_planning_error_delivered_via_future(catalog):
    srv = _server(catalog, cache=False)
    fut = srv.submit(fdb("NoSuchDb").find(BETWEEN(P.hour, 0, 1)))
    srv.run_pending()
    with pytest.raises(Exception):
        fut.result(10)


def test_session_serve_integration(worlds):
    """``Session.serve`` returns the port's server on the session's
    engine and backend."""
    cat, _ = worlds
    flow = fdb("ServeDense").find(BETWEEN(P.hour, 8, 17))
    sess = Session(catalog=cat, backend=TorchBackend(device="cpu"))
    srv = sess.serve(start=False, cache=False)
    try:
        assert isinstance(srv, QueryServer)
        assert srv.engine is sess.engine
        fut = srv.submit(sess.fdb("ServeDense").find(BETWEEN(P.hour, 8, 17)))
        ops.reset_launch_counts()
        srv.run_pending()
        assert ops.launch_counts() == {"run_wave_fused": 1}   # one query
        assert_identical(fut.result(60).batch, _oracles(worlds, [flow])[0]
                         .batch)
    finally:
        srv.close()


# ------------------------------------------------------------ result cache

def test_result_cache_hit_skips_recompute(catalog, monkeypatch):
    monkeypatch.setenv(FUSED_ENV, "1")
    flow = _tess_flows(2, seed=21)[0]
    srv = _server(catalog, cache=ResultCache())
    f1 = srv.submit(flow)
    srv.run_pending()
    r1 = f1.result(60)
    ops.reset_launch_counts()
    f2 = srv.submit(flow)
    srv.run_pending()
    assert f2.result(60) is r1                 # same object, no recompute
    assert ops.launch_counts() == {}
    assert srv.stats()["cache_hits"] == 1


def test_result_cache_ttl_and_injectable_clock(catalog):
    clock = [0.0]
    cache = ResultCache(ttl_s={"result": 10.0, "postings": 5.0},
                        clock=lambda: clock[0])
    srv = _server(catalog, cache=cache)
    flow = fdb("ServeDense").find(BETWEEN(P.hour, 8, 17))
    f1 = srv.submit(flow)
    srv.run_pending()
    r1 = f1.result(60)
    clock[0] = 9.0                             # still live
    f2 = srv.submit(flow)
    srv.run_pending()
    assert f2.result(60) is r1
    clock[0] = 20.0                            # expired
    f3 = srv.submit(flow)
    srv.run_pending()
    r3 = f3.result(60)
    assert r3 is not r1
    assert_identical(r3.batch, r1.batch)


def test_result_cache_lru_byte_budget():
    clock = [0.0]
    cache = ResultCache(max_bytes=3000, clock=lambda: clock[0])
    a1 = np.zeros(250, dtype=np.float64)       # 2000 bytes
    cache.put("result", b"k1", a1, nbytes=a1.nbytes)
    cache.put("result", b"k2", np.zeros(100), nbytes=800)
    assert cache.get("result", b"k1") is a1    # k1 now most-recent
    cache.put("result", b"k3", np.zeros(100), nbytes=800)   # evicts k2
    assert cache.get("result", b"k2") is None
    assert cache.get("result", b"k1") is a1
    assert cache.stats()["evictions"] == 1
    assert cache.stats()["nbytes"] <= 3000


def test_result_cache_key_isolation(catalog):
    """Different plans → different keys (the port's plan nodes are
    canonicalized); an uncanonicalizable plan is simply uncacheable
    (None key), never a false share."""
    dense_db = catalog.get("ServeDense")
    cache = ResultCache()
    p1 = plan_flow(fdb("ServeDense").find(BETWEEN(P.hour, 8, 17)), catalog)
    p2 = plan_flow(fdb("ServeDense").find(BETWEEN(P.hour, 8, 18)), catalog)
    k1 = cache.key_for(dense_db, p1)
    k2 = cache.key_for(dense_db, p2)
    assert k1 is not None and k2 is not None and k1 != k2
    assert cache.key_for(dense_db, p1) == k1   # deterministic
    p1b = plan_flow(fdb("ServeDense").find(BETWEEN(P.hour, 8, 17)),
                    catalog)
    p1b.mixer_ops = list(p1b.mixer_ops) + [lambda x: x]    # opaque
    assert cache.key_for(dense_db, p1b) is None


def test_broken_cache_never_fails_a_query(worlds, monkeypatch):
    """Fault injection: a cache whose every method raises degrades the
    server to recomputation — every query still answers correctly."""
    monkeypatch.setenv(FUSED_ENV, "1")
    cat, _ = worlds

    class BrokenCache:
        def key_for(self, *a, **k):
            raise RuntimeError("cache down")

        def get(self, *a, **k):
            raise RuntimeError("cache down")

        def put(self, *a, **k):
            raise RuntimeError("cache down")

        def stats(self):
            raise RuntimeError("cache down")

    flows = _tess_flows(3, seed=29)
    oracle = _oracles(worlds, flows)
    srv = _server(cat, cache=BrokenCache())
    futs = [srv.submit(f) for f in flows]
    srv.run_pending()
    for f, o in zip(futs, oracle):
        assert_identical(f.result(60).batch, o.batch)
    assert srv.stats()["cache_errors"] > 0


# --------------------------------------------- concurrency-safety satellites

def test_launch_counter_two_threads():
    """record_launch is concurrency-safe: the aggregate view sums both
    threads exactly."""
    ops.reset_launch_counts()
    n = 5000
    barrier = threading.Barrier(2)

    def worker():
        barrier.wait()
        for _ in range(n):
            ops.record_launch("probe_x")

    ts = [threading.Thread(target=worker) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert ops.launch_counts()["probe_x"] == 2 * n     # no lost updates
    ops.reset_launch_counts()
    assert ops.launch_counts() == {}


def test_device_cache_concurrent_prime_and_release():
    """Concurrent prime_fdb of the SAME FDb from many threads yields one
    consistent buffer census; concurrent open/close of distinct FDbs
    refcounts correctly, and everything evicts once dead."""
    dense = _dense_records()
    db = _dense_db(pfdb, pschema, "ServePrimeRace", dense)
    be = TorchBackend(device="cpu")
    counts = []

    def prime():
        counts.append(be.prime_fdb(db))

    ts = [threading.Thread(target=prime) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    expect = db.num_shards * 4                 # the 4 column buffers
    assert len(be.device_cache) == expect
    assert sum(1 for c in counts if c > 0) == 1    # exactly one real prime

    def churn(i):
        d = _dense_db(pfdb, pschema, f"ServeChurn{i}", dense)
        be.prime_fdb(d)
        assert be.device_cache.get(d.shards[0].batch["speed"].values) \
            is not None

    with ThreadPoolExecutor(max_workers=4) as pool:
        list(pool.map(churn, range(8)))
    gc.collect()
    time.sleep(0.05)
    gc.collect()
    assert len(be.device_cache) == expect      # only the live db remains
    del db
    gc.collect()
    assert len(be.device_cache) == 0
