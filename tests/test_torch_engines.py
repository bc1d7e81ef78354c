"""Warp:Flume on the port: ``repro_torch.exec.FlumeEngine`` on
``TorchBackend(device="cpu")``.

The tests of ``tests/test_engines.py`` (AdHoc ≡ Flume, checkpoint
recovery, resume after a failure, best-effort drops and transient
retries, a dead machine rerouted, a straggler with speculation on,
resource queueing, sampling, the profile log, ``save``) and the Flume
cases of ``tests/test_backends.py`` and ``tests/test_batched.py`` (the
wave path's checkpoints and recovery, a crashing wave that must not abort
its siblings) run on the torch backend, against the port's numpy oracle
and the JAX package's numpy engine on the same records (the ``catalog``
fixture of ``tests/conftest.py``).  A checkpoint holds host numpy only:
it unpickles with every ``torch`` global refused.  Tolerance: none —
records are compared exactly (the CPU stages float64 and sums in row
order).
"""
import os
import pickle
import tempfile
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.exec as jexec                            # noqa: E402
import repro.core as jcore                            # noqa: E402

import repro_torch.exec.flume as flume_mod            # noqa: E402
from repro_torch.core import BETWEEN, P, fdb, group, proto  # noqa: E402
from repro_torch.exec import (AdHocEngine, Catalog, FaultPlan,  # noqa
                              FlumeEngine, NumpyBackend, ResourceManager,
                              TorchBackend)
from repro_torch.fdb import (DOUBLE, INT, MESSAGE, STRING,  # noqa: E402
                             Schema, build_fdb)
from repro_torch.fdb.schema import Field              # noqa: E402
from repro_torch.kernels import ops                   # noqa: E402


# --------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def pcatalog(world):
    """The ``world`` fixture's records (``tests/conftest.py``) as the port's
    catalog: Roads and Obs, 5 shards each."""
    roads = Schema("Roads", [
        Field("id", INT, indexes=("tag",)),
        Field("city", STRING, indexes=("tag",)),
        Field("loc", MESSAGE, fields=[Field("lat", DOUBLE),
                                      Field("lng", DOUBLE)],
              indexes=("location",)),
        Field("polyline", MESSAGE, fields=[
            Field("lat", DOUBLE, repeated=True),
            Field("lng", DOUBLE, repeated=True)],
            indexes=("area",), index_params={"level": 6, "width_m": 30.0}),
        Field("speed_limit", DOUBLE, indexes=("range",)),
    ])
    obs = Schema("Obs", [
        Field("road_id", INT, indexes=("tag",)),
        Field("hour", INT, indexes=("range",)),
        Field("dow", INT, indexes=("range",)),
        Field("speed", DOUBLE),
    ])
    cat = Catalog(server_slots=16)
    cat.register(build_fdb("Roads", roads, world["roads"], num_shards=5))
    cat.register(build_fdb("Obs", obs, world["obs"], num_shards=5))
    return cat


def _q(c):
    return (c.fdb("Obs").find(c.BETWEEN(c.P.hour, 8, 9))
            .aggregate(c.group(c.P.road_id).count("n").avg(m=c.P.speed)))


@pytest.fixture()
def q():
    import repro_torch.core as core
    return _q(core)


@pytest.fixture(scope="module")
def want(catalog):
    """The JAX package's numpy engine on the same records."""
    return jexec.AdHocEngine(catalog, num_servers=5,
                             backend="numpy").collect(_q(jcore)).to_records()


def _cpu():
    return TorchBackend(device="cpu")


def _flume(cat, ckpt=None, **kw):
    kw.setdefault("max_workers", 5)
    return FlumeEngine(cat, ckpt_dir=ckpt or tempfile.mkdtemp(),
                       backend=_cpu(), **kw)


@pytest.fixture()
def adhoc(pcatalog):
    return AdHocEngine(pcatalog, num_servers=5, backend=_cpu())


def assert_identical(a, b):
    assert a.n == b.n
    assert a.paths() == b.paths()
    for p in a.paths():
        ca, cb = a[p], b[p]
        assert ca.values.dtype == cb.values.dtype, p
        assert np.array_equal(ca.values, cb.values), p
        assert ca.vocab == cb.vocab, p


# ------------------------------------------------------------ equivalence

def test_adhoc_flume_equivalence(adhoc, pcatalog, q, want):
    fl = _flume(pcatalog)
    a = adhoc.collect(q).to_records()
    b = fl.collect(q).to_records()
    assert a == b == want


def test_flume_default_backend_is_the_card(pcatalog, monkeypatch):
    """Left unset, Flume's backend is the port's ``torch`` on CUDA: it
    raises without a card instead of running elsewhere."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("REPRO_EXEC_BACKEND", "numpy")
    with pytest.raises(RuntimeError, match="CUDA"):
        FlumeEngine(pcatalog, ckpt_dir=tempfile.mkdtemp())


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_flume_fused_launch_contract(pcatalog, q, want, parts):
    """Flume's wave pre-pass: Σ_p ⌈shards_p/wave⌉ ``run_wave_fused`` and
    one ``merge_partials`` at P > 1; a second ``collect`` of the same job
    runs no task and dispatches nothing."""
    from repro_torch.core.planner import partition_shards
    fl = _flume(pcatalog, wave=2, partitions=parts)
    ops.reset_launch_counts()
    assert fl.collect(q).to_records() == want
    pp = partition_shards(range(5), parts)
    expect = {"run_wave_fused": pp.wave_dispatches(2)}
    if parts > 1:
        expect["merge_partials"] = 1
    assert ops.launch_counts() == expect
    ran = fl.stats["tasks_run"]
    assert ran == 5
    ops.reset_launch_counts()
    assert fl.collect(q).to_records() == want
    assert fl.stats["tasks_run"] == ran
    assert ops.launch_counts() == {}


# ------------------------------------------------------------- checkpoints

def test_flume_checkpoint_recovery(pcatalog, q, want):
    fl = _flume(pcatalog)
    first = fl.collect(q).to_records()
    ran = fl.stats["tasks_run"]
    again = fl.collect(q).to_records()
    assert again == first == want
    assert fl.stats["tasks_run"] == ran          # nothing recomputed
    assert fl.stats["tasks_skipped"] >= 5


class _NoTorch(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "torch":
            raise AssertionError(f"checkpoint refers to {module}.{name}")
        return super().find_class(module, name)


def _walk(obj, seen=None):
    """Every object reachable from ``obj`` (containers and attributes)."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    yield obj
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _walk(k, seen)
            yield from _walk(v, seen)
    elif isinstance(obj, (list, tuple, set, frozenset)):
        for v in obj:
            yield from _walk(v, seen)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        yield from _walk(vars(obj), seen)


@pytest.mark.parametrize("parts", [1, 2])
def test_checkpoint_holds_no_tensor(pcatalog, tmp_path, parts):
    """Every checkpoint file of a fused aggregate with an HLL sketch —
    per-shard ``ShardPartial`` (its raw ``seg`` state included) and the
    final batch — unpickles with ``torch`` refused and holds numpy
    only, so a checkpoint written on the card loads on a CPU-only host."""
    flow = (fdb("Obs").find(BETWEEN(P.hour, 7, 18))
            .aggregate(group(P.road_id).count("n").avg(m=P.speed)
                       .std_dev(sd=P.speed)))
    sketch = fdb("Obs").aggregate(group(P.dow).approx_distinct(
        "roads", expr=P.road_id))
    for i, f in enumerate((flow, sketch)):
        fl = FlumeEngine(pcatalog, ckpt_dir=str(tmp_path), max_workers=4,
                         backend=_cpu(), wave=2, partitions=parts)
        fl.collect(f, job_id=f"job{i}")
    files = [os.path.join(d, n) for d, _, ns in os.walk(tmp_path)
             for n in ns if n.endswith(".pkl")]
    assert len(files) == 2 * (5 + 1)
    segs = 0
    for path in files:
        with open(path, "rb") as fh:
            obj = _NoTorch(fh).load()
        for x in _walk(obj):
            assert not isinstance(x, torch.Tensor), path
        if getattr(obj, "seg", None) is not None:
            segs += 1
            uniq, slots = obj.seg
            assert isinstance(uniq, np.ndarray)
            assert all(isinstance(a, np.ndarray) for s in slots for a in s)
    assert segs == 5                               # the fused agg's states


def test_flume_resumes_after_partial_failure(pcatalog, q, want):
    """Crash mid-job → rerun completes from stage checkpoints."""
    ckpt = tempfile.mkdtemp()
    fl = _flume(pcatalog, ckpt, max_attempts=1)
    fp = FaultPlan(fail_always={("server", 3)}, reroute_after=99)
    with pytest.raises(Exception):
        fl.collect(q, fault_plan=fp, job_id="job1")
    fl2 = _flume(pcatalog, ckpt)
    res = fl2.collect(q, job_id="job1")
    assert res.to_records() == want
    assert fl2.stats["tasks_skipped"] >= 4       # recovered work reused


# ---------------------------------------------------- failures, stragglers

def test_adhoc_best_effort_drops_and_reports(adhoc, q):
    fp = FaultPlan(fail_always={("server", 2)}, reroute_after=99)
    res = adhoc.collect(q, fault_plan=fp)
    assert res.coverage == pytest.approx(4 / 5)
    assert res.profile.dropped_shards == [2]


def test_adhoc_transient_retry(adhoc, q, want):
    fp = FaultPlan(fail_once={("server", 0)})
    res = adhoc.collect(q, fault_plan=fp)
    assert res.coverage == 1.0
    assert res.profile.retries == 1
    assert res.to_records() == want


def test_flume_reroutes_dead_machine(pcatalog, q, want):
    fp = FaultPlan(fail_always={("server", 1)}, reroute_after=3)
    fl = _flume(pcatalog)
    res = fl.collect(q, fault_plan=fp)
    assert res.to_records() == want
    assert fl.stats["retries"] >= 2


def test_speculative_execution_beats_straggler(pcatalog, q, want):
    """A straggling shard gets a speculative backup on a second thread
    (the straggler sleeps on every attempt, so the backup cannot win
    here); results stay exact."""
    fp = FaultPlan(straggle={("server", 0): 0.6})
    fl = _flume(pcatalog, speculation=True, speculation_factor=3.0)
    res = fl.collect(q, fault_plan=fp)
    assert fl.stats["speculative_launched"] >= 1
    assert res.profile.shards_done == 5
    assert res.to_records() == want


def test_resource_queueing():
    rm = ResourceManager(total_slots=2)
    got = rm.acquire(2)
    order = []

    def waiter():
        n = rm.acquire(2)
        order.append("acquired")
        rm.release(n)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    assert order == []             # queued behind the running query
    rm.release(got)
    t.join(timeout=2)
    assert order == ["acquired"]
    assert rm.stats["waited"] >= 1


def test_sampling_uses_shard_subset(adhoc):
    full = adhoc.collect(fdb("Obs").aggregate(group().count("n")))
    samp = adhoc.collect(fdb("Obs").sample(0.4).aggregate(
        group().count("n")))
    assert samp.profile.shards_total == 2        # 40% of 5 shards
    n_full = full.to_records()[0]["n"]
    n_samp = samp.to_records()[0]["n"]
    assert 0.25 * n_full < n_samp < 0.55 * n_full


def test_profile_log_queryable_with_wfl(adhoc, q):
    """Query profiles land in a streaming FDb queryable by WarpFlow."""
    adhoc.collect(q)
    local = Catalog(server_slots=4)
    local.register(adhoc.profile_log.snapshot())
    res = AdHocEngine(local, num_servers=2, backend=_cpu()).collect(
        fdb("warpflow.query_log").map(
            lambda p: proto(src=p.source, rows=p.rows_scanned)))
    assert any(r["src"] == "Obs" and r["rows"] > 0
               for r in res.to_records())


def test_save_registers_new_fdb(world):
    cat = Catalog(server_slots=16)
    roads = Schema("Roads", [Field("id", INT, indexes=("tag",)),
                             Field("city", STRING, indexes=("tag",)),
                             Field("speed_limit", DOUBLE)])
    cat.register(build_fdb("Roads", roads, [
        {k: r[k] for k in ("id", "city", "speed_limit")}
        for r in world["roads"]], num_shards=5))
    eng = AdHocEngine(cat, num_servers=5, backend=_cpu())
    flow = (fdb("Roads").find(P.city == "SF")
            .map(lambda p: proto(rid=p.id, sl=p.speed_limit)))
    db = eng.save(flow, "SFRoads", num_shards=3)
    assert "SFRoads" in cat.names()
    res = eng.collect(fdb("SFRoads").aggregate(group().count("n")))
    n_sf = res.to_records()[0]["n"]
    assert n_sf == db.num_docs == sum(1 for r in world["roads"]
                                      if r["city"] == "SF") > 0
    fl = _flume(cat)
    assert fl.collect(fdb("SFRoads").aggregate(
        group().count("n"))).to_records()[0]["n"] == n_sf


def test_flume_torch_matches_adhoc_numpy(pcatalog, tmp_path):
    flow = (fdb("Obs").find(BETWEEN(P.hour, 8, 9))
            .aggregate(group(P.road_id).avg(m=P.speed).count("n")))
    ref = AdHocEngine(pcatalog, num_servers=4,
                      backend=NumpyBackend()).collect(flow)
    fl = FlumeEngine(pcatalog, ckpt_dir=str(tmp_path), max_workers=4,
                     backend=_cpu()).collect(flow)
    assert_identical(ref.batch, fl.batch)


# ------------------------------------------------ the wave path's recovery

def _ragged_db(num_shards=7, empty_shard=5, rows=900):
    """Skewed shard sizes (≈5:2:1…) with one completely empty shard."""
    rng = np.random.default_rng(11)
    schema = Schema("Ragged", [
        Field("road", INT, indexes=("tag",)),
        Field("hour", INT, indexes=("range",)),
        Field("city", STRING, indexes=("tag",)),
        Field("speed", DOUBLE),
    ])
    choices = [s for s in range(num_shards) if s != empty_shard]
    weights = np.linspace(5, 1, len(choices))
    weights /= weights.sum()
    recs = [{"road": int(rng.integers(0, 40)),
             "hour": int(rng.integers(0, 24)),
             "city": ["SF", "OAK", "SJ"][int(rng.integers(0, 3))],
             "speed": float(rng.normal(48, 9)),
             "_sh": int(rng.choice(choices, p=weights))}
            for _ in range(rows)]
    db = build_fdb("Ragged", schema, recs, num_shards=num_shards,
                   shard_key=lambda r: r["_sh"])
    sizes = [s.n for s in db.shards]
    assert sizes[empty_shard] == 0 and len(set(sizes)) > 2
    return db


@pytest.fixture(scope="module")
def ragged_catalog():
    cat = Catalog(server_slots=16)
    cat.register(_ragged_db())
    return cat


RAGGED_Q = (fdb("Ragged").find(BETWEEN(P.hour, 8, 17))
            .aggregate(group(P.road).count("n").avg(m=P.speed)
                       .std_dev(s=P.speed)))


def test_flume_wave_error_does_not_abort_siblings(ragged_catalog, tmp_path,
                                                  monkeypatch):
    """A wave that errors outright must not discard completed waves'
    checkpoints; its shards fall through to the per-shard machinery."""
    real = flume_mod.run_wave_task

    def flaky(db, plan, sids, *a, **kw):
        if 0 in list(sids):
            raise RuntimeError("injected wave crash")
        return real(db, plan, sids, *a, **kw)

    monkeypatch.setattr(flume_mod, "run_wave_task", flaky)
    fl = FlumeEngine(ragged_catalog, ckpt_dir=str(tmp_path), max_workers=4,
                     backend=_cpu(), wave=3)
    res = fl.collect(RAGGED_Q)
    ref = AdHocEngine(ragged_catalog, num_servers=4,
                      backend=NumpyBackend()).collect(RAGGED_Q)
    assert_identical(ref.batch, res.batch)
    # 4 shards via surviving waves + 3 via the per-shard fallback
    assert fl.stats["tasks_run"] == 7


def test_flume_wave_path_parity(ragged_catalog, tmp_path):
    ref = AdHocEngine(ragged_catalog, num_servers=4,
                      backend=NumpyBackend()).collect(RAGGED_Q)
    fl = FlumeEngine(ragged_catalog, ckpt_dir=str(tmp_path), max_workers=4,
                     backend=_cpu(), wave=3)
    res = fl.collect(RAGGED_Q)
    assert_identical(ref.batch, res.batch)
    assert fl.stats["tasks_run"] == 7          # one checkpoint per shard
    again = fl.collect(RAGGED_Q)               # recovery from wave ckpts
    assert_identical(ref.batch, again.batch)
    assert fl.stats["tasks_skipped"] >= 7


_ISOLATED = r"""
import json, sys, tempfile
import numpy as np
from repro_torch.core import BETWEEN, P, fdb, group
from repro_torch.exec import Catalog, FlumeEngine, TorchBackend
from repro_torch.fdb import DOUBLE, INT, Schema, build_fdb
from repro_torch.fdb.schema import Field
schema = Schema("T", [Field("k", INT, indexes=("tag",)),
                      Field("h", INT, indexes=("range",)),
                      Field("v", DOUBLE)])
recs = [{"k": i % 7, "h": i % 24, "v": float(i)} for i in range(300)]
cat = Catalog(server_slots=8)
cat.register(build_fdb("T", schema, recs, num_shards=6))
fl = FlumeEngine(cat, ckpt_dir=tempfile.mkdtemp(),
                 backend=TorchBackend(device="cpu"), wave=2, partitions=2)
fl.collect(fdb("T").find(BETWEEN(P.h, 3, 20))
           .aggregate(group(P.k).count("n").avg(a=P.v)))
fl.collect(fdb("T").aggregate(group(P.k).approx_distinct("d", expr=P.h)))
print(json.dumps({"modules": sorted(sys.modules)}))
"""


def test_engines_import_neither_jax_nor_repro():
    """In a fresh interpreter Flume at P = 2, the merge combine and the
    grouped sketch run without pulling in jax or the JAX package."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", _ISOLATED], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    mods = json.loads(out.strip().splitlines()[-1])["modules"]
    assert not [m for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert {"repro_torch.exec.flume", "repro_torch.kernels.merge"} <= \
        set(mods)
