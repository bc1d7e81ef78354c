"""The port's partition layer held to the JAX package's.

``merge_partials`` (``repro_torch/kernels/merge.py`` behind
``TorchBackend.merge_partials``) is held bit for bit to the JAX
package's in-order combine (``repro.kernels.merge.merge_partials`` with
``mesh=None``, under x64) and to both ``NumpyBackend`` oracles — the
port's copy and the JAX package's — including all-empty states and the
min/max slots.  Then the tests of ``tests/test_partition.py`` run on
``TorchBackend(device="cpu")``: plan arithmetic, the resolution order of
``num_partitions`` (engine arg > ``REPRO_EXEC_PARTITIONS`` > the
backend's CUDA device count), ``reroute_partitions``, P = 1/2/4
invariance on both engines (selections byte-identical, aggregates
float64-identical, and equal to the JAX package's numpy engine on the
same records), the partitioned launch contract (Σ_p ⌈shards_p/wave⌉
``run_wave_fused`` + ``merge_combines()`` ``merge_partials``), pruned and
empty partitions, the ordered first-hit path, partition-fault reroute and
the coalescing server on the partition layer.  Tolerance: none — every
comparison here is exact (the CPU stages float64 and sums in row order).
"""
import math
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                               # noqa: E402

import repro.core as jcore                            # noqa: E402
import repro.exec as jexec                            # noqa: E402
import repro.fdb as jfdb                              # noqa: E402
from repro.exec.backend import NumpyBackend as JNumpyBackend  # noqa: E402
from repro.fdb import schema as jschema               # noqa: E402
from repro.kernels import merge as jmerge             # noqa: E402
from repro.launch.elastic import reroute_partitions as j_reroute  # noqa

import repro_torch.core as core                       # noqa: E402
import repro_torch.fdb as pfdb                        # noqa: E402
from repro_torch.core import BETWEEN, P, fdb, group   # noqa: E402
from repro_torch.core.planner import (PARTITIONS_ENV,  # noqa: E402
                                      PartitionPlan, num_partitions,
                                      partition_shards, plan_flow)
from repro_torch.exec import (AdHocEngine, Catalog, FaultPlan,  # noqa: E402
                              FlumeEngine, NumpyBackend, TorchBackend)
from repro_torch.exec.batched import FUSED_ENV        # noqa: E402
from repro_torch.fdb import DOUBLE, INT, Schema, build_fdb  # noqa: E402
from repro_torch.fdb import schema as pschema         # noqa: E402
from repro_torch.fdb.schema import Field, MESSAGE     # noqa: E402
from repro_torch.fdb.streaming import StreamingFDb    # noqa: E402
from repro_torch.geo import AreaTree, mercator as M   # noqa: E402
from repro_torch.kernels import merge, ops            # noqa: E402
from repro_torch.launch.elastic import reroute_partitions  # noqa: E402
from repro_torch.launch.mesh import default_exec_partitions  # noqa: E402
from repro_torch.serve import QueryServer             # noqa: E402
from repro_torch.tess import Tesseract                # noqa: E402

from test_torch_kernels import _x64                   # noqa: E402

SIZES = [16, 15, 32, 33, 1, 0, 9]          # ragged + an empty shard
DAY = 86400.0


# --------------------------------------------------------------- fixtures

def _dense_records():
    rng = np.random.default_rng(17)
    return [{"road": int(rng.integers(0, 8)),
             "hour": int(rng.integers(0, 24)),
             "speed": float(rng.normal(48, 9)), "_i": i}
            for i in range(sum(SIZES))]


def _dense_db(fdb_mod, schema_mod, name="PartDense"):
    """The same ragged FDb in either package (``fdb_mod``/``schema_mod``
    are one package's ``fdb`` and ``fdb.schema``)."""
    schema = schema_mod.Schema(name, [
        schema_mod.Field("road", schema_mod.INT, indexes=("tag",)),
        schema_mod.Field("hour", schema_mod.INT, indexes=("range",)),
        schema_mod.Field("speed", schema_mod.DOUBLE),
    ])
    bounds = np.cumsum([0] + SIZES)
    key = lambda r: int(np.searchsorted(bounds, r["_i"], "right") - 1)
    db = fdb_mod.build_fdb(name, schema, _dense_records(),
                           num_shards=len(SIZES), shard_key=key)
    assert [s.n for s in db.shards] == SIZES
    return db


def _track_schema(name):
    return Schema(name, [
        Field("id", INT, indexes=("tag",)),
        Field("track", MESSAGE, fields=[
            Field("lat", DOUBLE, repeated=True),
            Field("lng", DOUBLE, repeated=True),
            Field("t", DOUBLE, repeated=True)],
            indexes=("spacetime",),
            index_params={"level": 6, "bucket_s": 900.0, "epoch": 0.0}),
    ])


def _walks_db(name="PartWalks", sizes=(16, 15, 0, 33)):
    rng = np.random.default_rng(5)
    recs = []
    for i in range(sum(sizes)):
        ln = 0 if i % 9 == 0 else int(rng.integers(1, 12))
        recs.append({"id": i, "track": {
            "lat": rng.uniform(37.2, 38.0, ln).tolist(),
            "lng": rng.uniform(-122.6, -121.8, ln).tolist(),
            "t": np.sort(rng.uniform(0.0, 2 * DAY, ln)).tolist()}})
    bounds = np.cumsum([0] + list(sizes))
    key = lambda r: int(np.searchsorted(bounds, r["id"], "right") - 1)
    return build_fdb(name, _track_schema(name), recs,
                     num_shards=len(sizes), shard_key=key)


def _region(rng, d=2_500_000):
    ix, iy = M.latlng_to_xy(rng.uniform(37.3, 37.9),
                            rng.uniform(-122.5, -121.9))
    return AreaTree.from_box(int(ix) - d, int(iy) - d,
                             int(ix) + d, int(iy) + d, max_level=7)


@pytest.fixture(scope="module")
def dense_db():
    return _dense_db(pfdb, pschema)


@pytest.fixture(scope="module")
def dense_catalog(dense_db):
    cat = Catalog(server_slots=16)
    cat.register(dense_db)
    return cat


@pytest.fixture(scope="module")
def ref_catalog():
    """The JAX package's catalog over the same records."""
    cat = jexec.Catalog(server_slots=16)
    cat.register(_dense_db(jfdb, jschema))
    return cat


@pytest.fixture(scope="module")
def walks_catalog():
    cat = Catalog(server_slots=16)
    cat.register(_walks_db())
    return cat


@pytest.fixture
def cpu():
    return TorchBackend(device="cpu")


def _all_agg(c):
    """Every fused aggregate kind in one spec — the merge must carry
    (n, Σ, Σ²) and the min/max planes through the combine."""
    return (c.fdb("PartDense").find(c.BETWEEN(c.P.hour, 7, 18))
            .aggregate(c.group(c.P.road).count("n").sum(s=c.P.speed)
                       .avg(a=c.P.speed).std_dev(sd=c.P.speed)
                       .min(lo=c.P.speed).max(hi=c.P.speed)))


def _select(c):
    return c.fdb("PartDense").find(c.BETWEEN(c.P.hour, 7, 18))


ALL_AGG = _all_agg(core)
SELECT = _select(core)


def assert_identical(a, b):
    """Byte-identical ColumnBatches (either package's)."""
    assert a.n == b.n
    assert a.paths() == b.paths()
    for p in a.paths():
        ca, cb = a[p], b[p]
        assert ca.values.dtype == cb.values.dtype, p
        assert np.array_equal(ca.values, cb.values), p
        assert ca.vocab == cb.vocab, p


def _backend(name):
    return TorchBackend(device="cpu") if name == "torch" else NumpyBackend()


# ------------------------------------------------------ plan arithmetic

def test_partition_shards_contiguous_and_balanced():
    pp = partition_shards(range(7), 3)
    assert pp.parts == [[0, 1, 2], [3, 4], [5, 6]]   # contiguous, ±1
    assert [s for part in pp.parts for s in part] == list(range(7))
    assert pp.sizes() == [3, 2, 2]
    pp = partition_shards([4, 9], 4)
    assert pp.parts == [[4], [9], [], []]
    assert partition_shards([], 3).parts == [[], [], []]
    assert partition_shards(range(5), 1).parts == [list(range(5))]


def test_partition_plan_launch_helpers():
    pp = PartitionPlan([[0, 1, 2, 3], [4, 5, 6]])
    assert pp.wave_dispatches(3) == 2 + 1            # ⌈4/3⌉ + ⌈3/3⌉
    assert pp.wave_dispatches(1) == 7
    assert pp.merge_combines() == 1
    assert PartitionPlan([[0], [], []]).wave_dispatches(3) == 1
    assert PartitionPlan([[0], [], []]).merge_combines() == 0
    assert PartitionPlan([[], [], []]).wave_dispatches(3) == 0
    assert PartitionPlan([[], [], []]).merge_combines() == 0
    assert PartitionPlan([list(range(5))]).merge_combines() == 0


def test_num_partitions_resolution(monkeypatch, cpu):
    """Engine arg > ``REPRO_EXEC_PARTITIONS`` > the backend's CUDA device
    count; the numpy oracle and a backend on the CPU default to 1."""
    monkeypatch.delenv(PARTITIONS_ENV, raising=False)
    assert num_partitions(3) == 3                    # engine arg wins
    assert num_partitions() == 1
    assert num_partitions(backend=NumpyBackend()) == 1
    assert num_partitions(backend=cpu) == default_exec_partitions(cpu) == 1
    monkeypatch.setenv(PARTITIONS_ENV, "4")
    assert num_partitions() == 4                     # env beats devices
    assert num_partitions(backend=cpu) == 4
    assert num_partitions(2) == 2                    # … but not the arg


def test_default_partitions_follow_cuda_devices(monkeypatch, cpu):
    """A backend on CUDA defaults to one partition per CUDA device (the
    count is faked here: the CPU has none); a CPU backend stays at 1."""
    monkeypatch.delenv(PARTITIONS_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)

    class OnCuda:
        batched_dispatch = True
        device = torch.device("cuda", 0)

    assert default_exec_partitions(OnCuda()) == 4
    assert num_partitions(backend=OnCuda()) == 4
    assert default_exec_partitions(cpu) == 1
    assert default_exec_partitions(None) == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert num_partitions(backend=OnCuda()) == 1


@pytest.mark.parametrize("parts,failed", [
    ([[0, 1], [2, 3], [4]], [1]),
    ([[0, 1], [2, 3], [4]], [0, 1, 2]),
    ([[0, 1, 2], [3], [], [4, 5]], [0, 3]),
    ([[0], [1]], [5]),
])
def test_reroute_partitions_round_robin(parts, failed):
    out = reroute_partitions(parts, failed)
    assert out == j_reroute(parts, failed)           # the reference's
    assert sorted(s for p in out for s in p) == \
        sorted(s for p in parts for s in p)
    assert len(out) == len(parts)                    # slot count kept
    survivors = [i for i in range(len(parts)) if i not in set(failed)]
    if survivors:
        assert all(out[i] == [] for i in set(failed) if i < len(parts))
    else:
        assert out == parts                          # per-shard retries


def test_reroute_partitions_example():
    assert reroute_partitions([[0, 1], [2, 3], [4]], [1]) == \
        [[0, 1, 2], [], [4, 3]]                      # orphans round-robin


# -------------------------------------------- merge op: oracle vs device

def _state(keys, *slots):
    return (np.asarray(keys, np.int64),
            [tuple(np.asarray(a, np.float64) if i else
                   np.asarray(a, np.int64) for i, a in enumerate(slot))
             for slot in slots])


def _assert_merged(got, want):
    uniq, slots = got
    w_uniq, w_slots = want
    assert np.array_equal(uniq, w_uniq) and uniq.dtype == w_uniq.dtype
    assert len(slots) == len(w_slots)
    for gs, ws in zip(slots, w_slots):
        assert len(gs) == len(ws)
        for ga, wa in zip(gs, ws):
            ga, wa = np.asarray(ga), np.asarray(wa)
            assert ga.dtype == wa.dtype
            assert ga.tobytes() == wa.tobytes()      # bit for bit


def test_merge_partials_matches_hand_oracle(cpu):
    """Disjoint + overlapping key spaces, an empty state, two value slots
    (one with min/max planes): the port's merge equals the hand reduction
    and both numpy oracles bit for bit, in one ``merge_partials``."""
    a = _state([1, 3],
               ([2, 1], [4.0, 5.0], [10.0, 25.0]),
               ([2, 1], [1.0, 2.0], [0.5, 4.0], [0.25, 2.0], [0.75, 2.0]))
    b = _state([3, 7],
               ([1, 4], [3.0, 8.0], [9.0, 20.0]),
               ([1, 4], [5.0, 3.0], [25.0, 2.25], [5.0, 0.5], [5.0, 1.0]))
    states = [a, _state([]), b]
    ops.reset_launch_counts()
    got = cpu.merge_partials(states, minmax=(False, True), parts=[2, 1])
    assert ops.launch_counts() == {"merge_partials": 1}
    uniq, slots = got
    assert uniq.tolist() == [1, 3, 7]
    assert slots[0][0].tolist() == [2, 2, 4]
    assert slots[0][1].tolist() == [4.0, 8.0, 8.0]
    assert slots[0][2].tolist() == [10.0, 34.0, 20.0]
    assert len(slots[0]) == 3 and len(slots[1]) == 5
    assert slots[1][3].tolist() == [0.25, 2.0, 0.5]  # min plane
    assert slots[1][4].tolist() == [0.75, 5.0, 1.0]  # max plane
    for oracle in (NumpyBackend(), JNumpyBackend()):
        _assert_merged(got, oracle.merge_partials(
            states, minmax=(False, True), parts=[2, 1]))


def _random_states(rng, n_states, n_slots, key_space, with_minmax):
    states = []
    for _ in range(n_states):
        n = int(rng.integers(0, key_space + 1))
        keys = np.sort(rng.choice(key_space, size=n, replace=False))
        slots = []
        for k in range(n_slots if n else 0):
            cnt = rng.integers(0, 5, n)
            vals = rng.normal(40.0, 30.0, (3, n))
            slot = (cnt, vals[0] * cnt, vals[1] ** 2 * cnt)
            if with_minmax and k == 0:
                lo = np.where(cnt > 0, vals[2], np.inf)
                slot = (*slot, lo, np.where(cnt > 0, vals[2] + 1, -np.inf))
            slots.append(slot)
        states.append(_state(keys, *slots))
    return states


@pytest.mark.parametrize("n_states,n_slots,key_space,minmax", [
    (1, 1, 5, False), (3, 2, 40, True), (7, 1, 200, True),
    (20, 3, 1000, False), (4, 1, 1, True)])
def test_merge_partials_random_states(cpu, n_states, n_slots, key_space,
                                      minmax):
    """Seeded random states: bit-equal to both numpy oracles."""
    rng = np.random.default_rng(n_states * 100 + key_space)
    states = _random_states(rng, n_states, n_slots, key_space, minmax)
    mm = (True,) if minmax else ()
    got = cpu.merge_partials(states, minmax=mm)
    for oracle in (NumpyBackend(), JNumpyBackend()):
        _assert_merged(got, oracle.merge_partials(states, minmax=mm))


@pytest.mark.parametrize("s,k,g", [(1, 1, 1), (3, 2, 17), (8, 1, 300),
                                   (20, 2, 0), (5, 3, 1000)])
def test_merge_kernel_matches_jax_combine(s, k, g):
    """The plain combine against ``repro.kernels.merge.merge_partials``
    (``mesh=None``: its in-order ``fori_loop``) under x64, bit for bit —
    counts, sums, sums of squares, ±inf min/max identities and the
    presence OR."""
    rng = np.random.default_rng(1000 * s + 10 * k + g)
    cnt = rng.integers(0, 6, (s, k, g)).astype(np.int64)
    sm = rng.normal(0.0, 1e3, (s, k, g)) * (cnt > 0)
    s2 = rng.random((s, k, g)) * 1e6 * (cnt > 0)
    mn = np.where(cnt > 0, rng.normal(0, 50, (s, k, g)), np.inf)
    mx = np.where(cnt > 0, mn + rng.random((s, k, g)), -np.inf)
    msk = cnt[:, 0, :] > 0
    got = merge.merge_partials(*(torch.from_numpy(a) for a in
                                 (cnt, sm, s2, mn, mx, msk)))
    with _x64():
        want = [np.asarray(x) for x in jmerge.merge_partials(
            jnp.asarray(cnt), sm, s2, mn, mx, msk, mesh=None)]
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.numpy()
        assert a.shape == b.shape, i
        assert a.dtype == b.dtype, i
        assert a.tobytes() == b.tobytes(), i


def test_merge_partials_all_empty_states(cpu):
    """Nothing selected anywhere: an empty key space, and still one
    combine dispatch (the launch contract stays exact)."""
    states = [_state([]), _state([])]
    ops.reset_launch_counts()
    uniq, slots = cpu.merge_partials(states, minmax=(), parts=[1, 1])
    assert ops.launch_counts() == {"merge_partials": 1}
    assert uniq.size == 0 and uniq.dtype == np.int64 and slots == []
    for oracle in (NumpyBackend(), JNumpyBackend()):
        w_uniq, w_slots = oracle.merge_partials(states, minmax=(),
                                                parts=[1, 1])
        assert w_uniq.size == 0 and w_slots == []


# ------------------------------------- engine identity across P = 1/2/4

def _ref_batch(ref_catalog, make, wave=3):
    """The JAX package's numpy engine over the same records."""
    return jexec.AdHocEngine(ref_catalog, num_servers=2, backend="numpy",
                             wave=wave).collect(make(jcore)).batch


@pytest.mark.parametrize("bname", ["torch", "numpy"])
def test_adhoc_agg_identical_across_partitions(dense_catalog, ref_catalog,
                                               bname, monkeypatch):
    monkeypatch.setenv(FUSED_ENV, "1")
    ref = AdHocEngine(dense_catalog, num_servers=2, backend=_backend(bname),
                      wave=3, partitions=1).collect(ALL_AGG)
    assert_identical(ref.batch, _ref_batch(ref_catalog, _all_agg))
    for p in (2, 4):
        got = AdHocEngine(dense_catalog, num_servers=2,
                          backend=_backend(bname), wave=3,
                          partitions=p).collect(ALL_AGG)
        assert_identical(ref.batch, got.batch)
    assert ref.batch.n > 0


@pytest.mark.parametrize("bname", ["torch", "numpy"])
def test_adhoc_selection_identical_across_partitions(dense_catalog,
                                                     ref_catalog, bname):
    ref = AdHocEngine(dense_catalog, num_servers=2, backend=_backend(bname),
                      wave=3, partitions=1).collect(SELECT)
    assert_identical(ref.batch, _ref_batch(ref_catalog, _select))
    for p in (2, 4):
        got = AdHocEngine(dense_catalog, num_servers=2,
                          backend=_backend(bname), wave=3,
                          partitions=p).collect(SELECT)
        assert_identical(ref.batch, got.batch)       # byte-identical rows
    assert ref.batch.n > 0


@pytest.mark.parametrize("bname", ["torch", "numpy"])
def test_flume_identical_across_partitions(dense_catalog, bname,
                                           monkeypatch):
    monkeypatch.setenv(FUSED_ENV, "1")
    ref = AdHocEngine(dense_catalog, num_servers=2, backend=_backend(bname),
                      wave=3, partitions=1).collect(ALL_AGG)
    for p in (2, 4):
        fl = FlumeEngine(dense_catalog, ckpt_dir=tempfile.mkdtemp(),
                         max_workers=4, backend=_backend(bname), wave=3,
                         partitions=p)
        assert_identical(ref.batch, fl.collect(ALL_AGG).batch)


# ------------------------------------------------------- launch contract

def test_partitioned_launch_contract(dense_catalog, dense_db, monkeypatch):
    """⌈shards_p/wave⌉ fused dispatches per partition + exactly one merge
    combine per query at P>1; the P=1 path keeps the sequential host
    merge (no combine dispatch)."""
    monkeypatch.setenv(FUSED_ENV, "1")
    for p, want_waves in ((1, math.ceil(7 / 3)),      # [7] → 3
                          (2, 2 + 1),                 # [4, 3]
                          (4, 4)):                    # [2, 2, 2, 1]
        eng = AdHocEngine(dense_catalog, num_servers=2,
                          backend=TorchBackend(device="cpu"), wave=3,
                          partitions=p)
        eng.collect(ALL_AGG)                          # warm
        ops.reset_launch_counts()
        eng.collect(ALL_AGG)
        pp = partition_shards(range(dense_db.num_shards), p)
        assert pp.wave_dispatches(3) == want_waves
        want = {"run_wave_fused": want_waves}
        if p > 1:
            assert pp.merge_combines() == 1
            want["merge_partials"] = 1
        lc = ops.launch_counts()
        assert lc == want, p


def test_empty_partitions_more_partitions_than_shards(monkeypatch):
    """P > shard count: tail partitions are empty, dispatch nothing, and
    results stay identical."""
    monkeypatch.setenv(FUSED_ENV, "1")
    schema = Schema("PartTiny", [
        Field("road", INT, indexes=("tag",)),
        Field("hour", INT, indexes=("range",)),
        Field("speed", DOUBLE),
    ])
    recs = [{"road": int(i % 5), "hour": int(i % 24),
             "speed": float(i) * 0.5, "_i": i} for i in range(20)]
    tiny = build_fdb("PartTiny", schema, recs, num_shards=2,
                     shard_key=lambda r: 0 if r["_i"] < 11 else 1)
    cat = Catalog(server_slots=8)
    cat.register(tiny)
    flow = (fdb("PartTiny").find(BETWEEN(P.hour, 0, 23))
            .aggregate(group(P.road).count("n").sum(s=P.speed)))
    ref = AdHocEngine(cat, num_servers=2, backend=NumpyBackend(), wave=3,
                      partitions=1).collect(flow)
    eng = AdHocEngine(cat, num_servers=2, backend=TorchBackend(device="cpu"),
                      wave=3, partitions=4)
    eng.collect(flow)                                 # warm
    ops.reset_launch_counts()
    got = eng.collect(flow)
    assert_identical(ref.batch, got.batch)
    # [1], [1], [], [] → two dispatches, one combine
    assert ops.launch_counts() == {"run_wave_fused": 2,
                                   "merge_partials": 1}


# ------------------------------------------- pruning × partitions

def _banded_stream(name, n=48, flush=12):
    """Time-sorted ingestion ⇒ disjoint per-shard time bands (pruned)."""
    rng = np.random.default_rng(11)
    s = StreamingFDb(name, _track_schema(name), flush_threshold=flush,
                     compact_threshold=0)
    for i in range(n):
        t0 = 2 * DAY * i / n
        s.append({"id": i, "track": {
            "lat": rng.uniform(37.6, 37.9, 5).tolist(),
            "lng": rng.uniform(-122.5, -122.2, 5).tolist(),
            "t": (t0 + np.arange(5) * 60.0).tolist()}})
    s.flush()
    return s


def _bay_region():
    ix, iy = M.latlng_to_xy(37.75, -122.35)
    d = 4_000_000
    return AreaTree.from_box(int(ix) - d, int(iy) - d,
                             int(ix) + d, int(iy) + d, max_level=7)


def test_all_pruned_partitions(monkeypatch):
    """Pruning runs before partitioning: a window that misses every shard
    leaves every partition empty (no dispatch, empty result); a window
    keeping fewer shards than P leaves trailing partitions empty."""
    monkeypatch.setenv(FUSED_ENV, "1")
    s = _banded_stream("PartPrune")
    cat = Catalog()
    cat.register(s)
    none = fdb("PartPrune").tesseract(
        Tesseract(_bay_region(), 10 * DAY, 11 * DAY))
    assert plan_flow(none, cat).shard_ids == []
    for bname in ("torch", "numpy"):
        eng = AdHocEngine(cat, num_servers=2, backend=_backend(bname),
                          wave=3, partitions=4)
        ops.reset_launch_counts()
        assert eng.collect(none).batch.n == 0
        assert ops.launch_counts().get("run_wave_fused", 0) == 0
    some = fdb("PartPrune").tesseract(
        Tesseract(_bay_region(), 0.0, 0.4 * DAY))
    kept = len(plan_flow(some, cat).shard_ids)
    assert 0 < kept < cat.get("PartPrune").num_shards
    for bname in ("torch", "numpy"):
        ref = AdHocEngine(cat, num_servers=2, backend=_backend(bname),
                          wave=3, partitions=1).collect(some)
        got = AdHocEngine(cat, num_servers=2, backend=_backend(bname),
                          wave=3, partitions=max(4, kept + 1)).collect(some)
        assert_identical(ref.batch, got.batch)
        assert ref.batch.n > 0


def test_ordered_first_hit_identical_across_partitions(walks_catalog):
    """The ordered Tesseract path (first-hit tables + ordering edges) is a
    selection: byte-identical at any P, and equal to the numpy oracle."""
    rng = np.random.default_rng(3)
    tess = Tesseract(_region(rng), 0.0, 1.5 * DAY).then(
        _region(rng), 0.0, 2 * DAY)
    flow = fdb("PartWalks").tesseract(tess)
    want = AdHocEngine(walks_catalog, num_servers=2, backend=NumpyBackend(),
                       wave=3).collect(flow)
    for p in (1, 2, 4):
        got = AdHocEngine(walks_catalog, num_servers=2,
                          backend=TorchBackend(device="cpu"), wave=3,
                          partitions=p).collect(flow)
        assert_identical(want.batch, got.batch)


# ------------------------------------------- partition-axis fault path

@pytest.mark.parametrize("engine_kind", ["adhoc", "flume"])
@pytest.mark.parametrize("failed", [{1}, {0, 2}])
def test_partition_fault_reroutes_to_survivors(dense_catalog, engine_kind,
                                               failed, monkeypatch):
    """A dead partition drains before dispatch and its shards reroute to
    the survivors (``launch.elastic``): full coverage, the same result,
    ``profile.retries`` counting the reroute, and the launch contract of
    the rerouted plan."""
    monkeypatch.setenv(FUSED_ENV, "1")
    fp = FaultPlan(fail_always={("partition", i) for i in failed},
                   reroute_after=99)

    def make():
        be = TorchBackend(device="cpu")
        if engine_kind == "adhoc":
            return AdHocEngine(dense_catalog, num_servers=2, backend=be,
                               wave=3, partitions=3)
        return FlumeEngine(dense_catalog, ckpt_dir=tempfile.mkdtemp(),
                           max_workers=4, backend=be, wave=3, partitions=3)

    ref = make().collect(ALL_AGG)
    ops.reset_launch_counts()
    res = make().collect(ALL_AGG, fault_plan=fp)
    lc = ops.launch_counts()
    assert_identical(ref.batch, res.batch)
    assert res.profile.retries == len(failed)
    if engine_kind == "adhoc":
        assert res.coverage == 1.0
    pp = partition_shards(range(len(SIZES)), 3)
    rerouted = PartitionPlan(reroute_partitions(pp.parts, sorted(failed)))
    assert lc["run_wave_fused"] == rerouted.wave_dispatches(3)
    # the combine runs whenever P > 1, as in the JAX package — also when
    # the reroute leaves one live partition, which ``merge_combines()``
    # counts as 0
    assert lc["merge_partials"] == 1


# ------------------------------------------------- partitioned serve tier

def test_serve_coalesced_rides_partition_layer(walks_catalog, monkeypatch):
    """The coalesced multi-query path dispatches per partition but keeps
    its host-side per-query gather merge: parity with the numpy oracle
    and no merge combine."""
    monkeypatch.setenv(FUSED_ENV, "1")
    rng = np.random.default_rng(29)
    flows = [fdb("PartWalks").tesseract(
                 Tesseract(_region(rng), 0.0, 1.5 * DAY)),
             fdb("PartWalks").tesseract(
                 Tesseract(_region(rng), 0.3 * DAY, 2 * DAY))]
    np_eng = AdHocEngine(walks_catalog, num_servers=2,
                         backend=NumpyBackend(), wave=3)
    oracle = [np_eng.collect(f) for f in flows]
    srv = QueryServer(catalog=walks_catalog,
                      backend=TorchBackend(device="cpu"), start=False,
                      cache=False)
    srv.engine.wave = 3
    srv.engine.partitions = 2
    futs = [srv.submit(f) for f in flows]
    srv.run_pending()                                 # warm
    for f, o in zip(futs, oracle):
        assert_identical(f.result(60).batch, o.batch)
    futs = [srv.submit(f) for f in flows]
    ops.reset_launch_counts()
    srv.run_pending()
    pp = partition_shards(range(walks_catalog.get("PartWalks").num_shards),
                          2)
    lc = ops.launch_counts()
    assert lc.get("run_wave_fused_multi") == pp.wave_dispatches(3)
    assert "merge_partials" not in lc and "run_wave_fused" not in lc
    for f, o in zip(futs, oracle):
        assert_identical(f.result(60).batch, o.batch)


# ------------------------------- eager buffer retirement (streaming)

def test_snapshot_turnover_retires_stale_buffers(cpu):
    """Priming a newer streaming generation drops the replaced
    generation's exclusive device buffers (``retired_buffers``);
    re-priming the same snapshot retires nothing."""
    s = StreamingFDb("PartRetire", Schema("PartRetire", [
        Field("id", INT, indexes=("tag",)),
        Field("val", DOUBLE, indexes=("range",)),
    ]), flush_threshold=4, compact_threshold=0)
    s.extend([{"id": i, "val": float(i)} for i in range(10)])
    snap1 = s.snapshot()
    cpu.prime_fdb(snap1)
    assert len(cpu.device_cache) > 0
    assert cpu.device_cache.stats()["retired_buffers"] == 0
    s.extend([{"id": i, "val": float(i)} for i in range(10, 18)])
    snap2 = s.snapshot()
    cpu.prime_fdb(snap2)
    retired = cpu.device_cache.stats()["retired_buffers"]
    assert retired > 0
    cpu.prime_fdb(snap2)                              # idempotent
    assert cpu.device_cache.stats()["retired_buffers"] == retired
