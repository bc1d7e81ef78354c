"""The port's live path on the torch backend: time-partition shard pruning
(plan- and launch-visible, fused and per-primitive), all-pruned plans,
incremental device priming of delta buffers only, ingest-while-serving
snapshot isolation and the append → cache-invalidation → recompute chain.

The tests of ``tests/test_streaming_live.py`` that went through
``JaxBackend`` run here on ``TorchBackend(device="cpu")``; ids are held
to the port's numpy oracle and to the JAX package's numpy engine over the
same ingested records.  Tolerance: none — ids and launch counts are
compared exactly.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore                            # noqa: E402
import repro.exec as jexec                            # noqa: E402
import repro.fdb.streaming as jstreaming              # noqa: E402
import repro.geo as jgeo                              # noqa: E402
import repro.tess as jtess                            # noqa: E402
from repro.fdb import schema as jschema               # noqa: E402

import repro_torch.geo as pgeo                        # noqa: E402
import repro_torch.tess as ptess                      # noqa: E402
from repro_torch.core import BETWEEN, P, fdb          # noqa: E402
from repro_torch.core.planner import (num_partitions,  # noqa: E402
                                      partition_shards, plan_flow)
from repro_torch.exec import (AdHocEngine, Catalog, NumpyBackend,  # noqa
                              TorchBackend)
from repro_torch.exec.batched import FUSED_ENV        # noqa: E402
from repro_torch.fdb import schema as pschema         # noqa: E402
from repro_torch.fdb.streaming import StreamingFDb    # noqa: E402
from repro_torch.kernels import ops                   # noqa: E402
from repro_torch.serve import QueryServer, ResultCache  # noqa: E402

DAY = 86400.0


# --------------------------------------------------------------- fixtures

def _track_schema(sch, name):
    return sch.Schema(name, [
        sch.Field("id", sch.INT, indexes=("tag",)),
        sch.Field("track", sch.MESSAGE, fields=[
            sch.Field("lat", sch.DOUBLE, repeated=True),
            sch.Field("lng", sch.DOUBLE, repeated=True),
            sch.Field("t", sch.DOUBLE, repeated=True)],
            indexes=("spacetime",),
            index_params={"level": 6, "bucket_s": 900.0, "epoch": 0.0}),
    ])


def _track_rec(i, t0, rng, n=6):
    """One short track near SF starting at ``t0`` (spans ~25 min)."""
    return {"id": i, "track": {
        "lat": rng.uniform(37.6, 37.9, n).tolist(),
        "lng": rng.uniform(-122.5, -122.2, n).tolist(),
        "t": (t0 + np.arange(n) * 300.0).tolist()}}


def _time_sorted_stream(name, n=96, flush=16, ref=False):
    """Time-sorted ingestion ⇒ each delta shard covers a disjoint time
    band — the layout the pruner exploits.  ``ref`` builds the same
    stream in the JAX package."""
    sch, mod = (jschema, jstreaming) if ref else (pschema, None)
    cls = mod.StreamingFDb if ref else StreamingFDb
    rng = np.random.default_rng(7)
    s = cls(name, _track_schema(sch, name), flush_threshold=flush,
            compact_threshold=0)
    for i in range(n):
        s.append(_track_rec(i, t0=3 * DAY * i / n, rng=rng))
    s.flush()
    return s


def _bay_region(geo):
    ix, iy = geo.mercator.latlng_to_xy(37.75, -122.35)
    d = 4_000_000
    return geo.AreaTree.from_box(int(ix) - d, int(iy) - d,
                                 int(ix) + d, int(iy) + d, max_level=7)


def _ids(batch):
    return sorted(int(v) for v in batch["id"].values)


def _dense_schema(name):
    return pschema.Schema(name, [
        pschema.Field("id", pschema.INT, indexes=("tag",)),
        pschema.Field("hour", pschema.INT, indexes=("range",)),
        pschema.Field("speed", pschema.DOUBLE),
    ])


def _ref_ids(name, n, flush, t1, wave):
    """The JAX package's numpy engine over the same live stream."""
    cat = jexec.Catalog()
    cat.register(_time_sorted_stream(name, n=n, flush=flush, ref=True))
    flow = jcore.fdb(name).tesseract(
        jtess.Tesseract(_bay_region(jgeo), 0.0, t1))
    return _ids(jexec.AdHocEngine(cat, num_servers=2, backend="numpy",
                                  wave=wave).collect(flow).batch)


# ------------------------------------------------- pruning: plan + launch

@pytest.mark.parametrize("parts", [None, 2])
def test_pruning_shrinks_plan_and_fused_launches(monkeypatch, parts):
    monkeypatch.setenv(FUSED_ENV, "1")
    s = _time_sorted_stream("LivePrune", n=96, flush=16)
    cat = Catalog()
    cat.register(s)
    total = cat.get("LivePrune").num_shards
    flow = fdb("LivePrune").tesseract(
        ptess.Tesseract(_bay_region(pgeo), 0.0, 0.5 * DAY))
    plan = plan_flow(flow, cat)
    kept = len(plan.shard_ids)
    assert 0 < kept < total
    assert plan.stats.get("pruned_shards") == total - kept
    wave = 3
    eng = AdHocEngine(cat, num_servers=2, backend=TorchBackend(device="cpu"),
                      wave=wave, partitions=parts)
    eng.collect(flow)                              # warm
    ops.reset_launch_counts()
    res = eng.collect(flow)
    p = num_partitions(parts, eng.backend)
    # the PartitionPlan is built over the PRUNED shard list
    want = partition_shards(range(kept), p).wave_dispatches(wave)
    assert ops.launch_counts() == {"run_wave_fused": want}
    assert want <= partition_shards(range(total), p).wave_dispatches(wave)
    oracle = AdHocEngine(cat, num_servers=2, backend=NumpyBackend(),
                         wave=wave).collect(flow)
    assert _ids(res.batch) == _ids(oracle.batch) == \
        _ref_ids("LivePrune", 96, 16, 0.5 * DAY, wave)
    assert res.batch.n > 0


def test_pruning_launch_contract_unfused(monkeypatch):
    monkeypatch.setenv(FUSED_ENV, "0")
    s = _time_sorted_stream("LivePruneU", n=64, flush=16)
    cat = Catalog()
    cat.register(s)
    flow = fdb("LivePruneU").tesseract(
        ptess.Tesseract(_bay_region(pgeo), 0.0, 0.5 * DAY))
    kept = len(plan_flow(flow, cat).shard_ids)
    assert 0 < kept < cat.get("LivePruneU").num_shards
    wave = 2
    eng = AdHocEngine(cat, num_servers=2, backend=TorchBackend(device="cpu"),
                      wave=wave)
    eng.collect(flow)                              # warm
    ops.reset_launch_counts()
    res = eng.collect(flow)
    lc = ops.launch_counts()
    waves = partition_shards(range(kept), 1).wave_dispatches(wave)
    assert lc.get("refine_tracks_batched") == waves
    assert lc.get("bitmap_intersect_batched") == waves
    assert lc.get("refine_tracks", 0) == 0 and "run_wave_fused" not in lc
    assert _ids(res.batch) == _ref_ids("LivePruneU", 64, 16, 0.5 * DAY,
                                       wave)


def test_prune_all_shards_yields_empty_result():
    s = _time_sorted_stream("LiveNone", n=32, flush=8)
    cat = Catalog()
    cat.register(s)
    flow = fdb("LiveNone").tesseract(
        ptess.Tesseract(_bay_region(pgeo), 30 * DAY, 31 * DAY))
    assert plan_flow(flow, cat).shard_ids == []
    ops.reset_launch_counts()
    res = AdHocEngine(cat, num_servers=2,
                      backend=TorchBackend(device="cpu")).collect(flow)
    assert res.batch.n == 0
    assert ops.launch_counts() == {}


# ----------------------------------------------------- incremental prime

def test_prime_uploads_only_new_delta_buffers():
    rng = np.random.default_rng(11)
    s = StreamingFDb("LivePrime", _track_schema(pschema, "LivePrime"),
                     flush_threshold=8, compact_threshold=0)
    s.extend([_track_rec(i, t0=300.0 * i, rng=rng) for i in range(16)])
    be = TorchBackend(device="cpu")
    snap1 = s.snapshot()
    n1 = be.prime_fdb(snap1)
    assert n1 > 0
    assert be.prime_fdb(snap1) == 0                # idempotent per gen
    buffers1 = be.device_cache.stats()["buffers"]
    s.extend([_track_rec(16 + i, t0=300.0 * (16 + i), rng=rng)
              for i in range(8)])
    snap2 = s.snapshot()
    assert snap2 is not snap1
    n2 = be.prime_fdb(snap2)
    assert 0 < n2 < n1                             # delta only
    assert be.device_cache.stats()["buffers"] == buffers1 + n2


# ------------------------------------- serving: isolation + invalidation

def test_ingest_while_serving_never_tears():
    """Concurrent appends against a serving engine on the torch backend:
    every result is a contiguous prefix of the append order — never a
    torn mix of generations."""
    name = "LiveTorn"
    s = StreamingFDb(name, _dense_schema(name), flush_threshold=5)
    cat = Catalog()
    cat.register(s)
    eng = AdHocEngine(cat, num_servers=2, backend=TorchBackend(device="cpu"))
    flow = fdb(name).find(BETWEEN(P.hour, 0, 23))
    s.append({"id": 0, "hour": 1, "speed": 1.0})
    stop = threading.Event()
    err: list = []

    def writer():
        i = 1
        while not stop.is_set() and i < 400:
            s.append({"id": i, "hour": i % 24, "speed": float(i)})
            i += 1

    def reader():
        try:
            for _ in range(25):
                got = [int(v) for v in
                       eng.collect(flow).batch["id"].values]
                assert got == list(range(len(got))), got
        except Exception as e:                     # pragma: no cover
            err.append(e)

    w = threading.Thread(target=writer)
    readers = [threading.Thread(target=reader) for _ in range(3)]
    w.start()
    [r.start() for r in readers]
    [r.join() for r in readers]
    stop.set()
    w.join()
    assert not err


def test_append_invalidates_live_server_cache():
    """A live QueryServer on the torch backend never serves a pre-append
    cached result: the append invalidates the bound ResultCache and the
    next submit recomputes against the new snapshot."""
    name = "LiveInval"
    s = StreamingFDb(name, _dense_schema(name), flush_threshold=4)
    s.extend([{"id": i, "hour": 8, "speed": 1.0} for i in range(8)])
    cat = Catalog()
    cat.register(s)
    cache = ResultCache()
    srv = QueryServer(catalog=cat, backend=TorchBackend(device="cpu"),
                      cache=cache, start=False)
    try:
        flow = fdb(name).find(BETWEEN(P.hour, 0, 23))
        f1 = srv.submit(flow)
        srv.run_pending()
        r1 = f1.result(60)
        assert r1.batch.n == 8
        f2 = srv.submit(flow)
        srv.run_pending()
        assert f2.result(60) is r1                 # cached while unchanged
        assert srv.stats()["cache_hits"] == 1
        s.extend([{"id": 8, "hour": 9, "speed": 2.0}])
        assert cache.stats()["invalidations"] >= 1
        f3 = srv.submit(flow)
        srv.run_pending()
        r3 = f3.result(60)
        assert r3 is not r1                        # recomputed, not stale
        assert r3.batch.n == 9
        assert 8 in set(int(v) for v in r3.batch["id"].values)
    finally:
        srv.close()
