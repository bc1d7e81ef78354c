"""The port end to end: the fused Tesseract query wave, the filter path
and the best-effort retry path.

The same synthetic world runs the slice's four queries — Q7-agg (the
Tesseract Q7 legs with a day group-by: count, avg, std_dev), Q9-agg (the
same legs ordered), Q11 (the dwell query) and Q1 (traffic variability) —
through ``repro_torch`` ``Session(backend=TorchBackend(device="cpu"))``
and through the JAX package's ``Session(backend="numpy")``.  Records must
be equal, float64 aggregates bit for bit (the port stages float64 values
on the CPU and its plain segment sums accumulate in row order, as numpy's
bincount does).  The fused launch contract is ⌈shards/wave⌉
``run_wave_fused`` dispatches per query.

The paper's Q2 in its ``geo_index`` and ``full_scan`` modes runs its
time predicates through ``.filter()`` (the single-mask ``compact`` per
shard), and Q7-agg / Q1 under a ``FaultPlan`` that fails two shards once
take the retry path (``run_shard_task``: the single-shard seam, the
spacetime ``postings_bitmap`` and the S=1 ``refine_tracks``); both must
give the reference's records.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore                            # noqa: E402
import repro.data.synthetic as jsyn                   # noqa: E402
import repro.exec as jexec                            # noqa: E402
import repro.fdb as jfdb                              # noqa: E402
import repro.tess as jtess                            # noqa: E402

import repro_torch.core as core                       # noqa: E402
import repro_torch.data.synthetic as syn              # noqa: E402
import repro_torch.exec as pexec                      # noqa: E402
import repro_torch.fdb as pfdb                        # noqa: E402
import repro_torch.tess as tess                       # noqa: E402
from repro_torch.kernels import ops                   # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def _queries(c, T, s):
    """Flow factories over one package's ``core`` / ``Tesseract`` /
    ``synthetic`` modules (the two packages build identical flows)."""
    P, day = c.P, 2 * 86400.0

    def win(h0, h1):
        return day + h0 * 3600.0, day + h1 * 3600.0

    def q7(ordered):
        a = T(s.city_region(*s.BAY_AREA), *win(6, 12))
        la = s.city_region("LA")
        return a.then(la, *win(6, 18)) if ordered else a.also(la,
                                                             *win(6, 18))

    def agg():
        return (c.group(P.day).count("n").avg(d=P.duration_s)
                .std_dev(sd=P.duration_s))

    return {
        "Q7-agg": lambda: c.fdb("Trips").tesseract(q7(False))
        .aggregate(agg()),
        "Q9-agg": lambda: c.fdb("Trips").tesseract(q7(True))
        .aggregate(agg()),
        "Q11": lambda: c.fdb("Trips").tesseract(
            T(s.city_region("SF"), *win(6, 12), label="sf").dwell(600.0)
            .also(s.city_region("Berkeley"), *win(6, 14), label="berkeley"))
        .map(lambda p: c.proto(id=p.id)),
        "Q1": lambda: c.fdb("SpeedObservations")
        .find(c.IN(P.loc, s.city_region("SF")) & c.BETWEEN(P.hour, 8, 9)
              & c.BETWEEN(P.dow, 0, 4) & c.BETWEEN(P.month, 1, 1))
        .aggregate(c.group(P.road_id).avg(mean_speed=P.speed)
                   .std_dev(std_speed=P.speed).count("n"))
        .map(lambda p: c.proto(road_id=p.road_id, n=p.n,
                               cov=p.std_speed / p.mean_speed)),
    }


QUERIES = ["Q7-agg", "Q9-agg", "Q11", "Q1"]


def _filter_queries(c, s, exprs):
    """Q2 (SF, January) in the paper's two modes that filter after the
    read: ``geo_index`` (area index only) and ``full_scan`` (no index;
    the predicates are obscured so the planner cannot use one)."""
    P, region = c.P, s.city_region("SF")
    agg = (c.group(P.road_id).avg(mean_speed=P.speed)
           .std_dev(std_speed=P.speed).count("n"))
    time_pred = (c.BETWEEN(P.hour, 8, 9) & c.BETWEEN(P.dow, 0, 4)
                 & c.BETWEEN(P.month, 1, 1))
    return {
        "Q2-geo_index": lambda: c.fdb("SpeedObservations")
        .find(c.IN(P.loc, region)).filter(time_pred).aggregate(agg),
        "Q2-full_scan": lambda: c.fdb("SpeedObservations")
        .filter(((P.hour + 0) >= 8) & ((P.hour + 0) <= 9)
                & ((P.dow + 0) <= 4) & ((P.month + 0) <= 1))
        .filter(exprs.ExprProxy(exprs.InRegion(exprs.FieldRef("loc"),
                                               region)))
        .aggregate(agg),
    }


def _catalog(syn_mod, fdb_mod, exec_mod, scale):
    w = syn_mod.generate_world(scale=scale, seed=0)
    cat = exec_mod.Catalog(server_slots=64)
    cat.register(fdb_mod.build_fdb("SpeedObservations",
                                   w["observations_schema"],
                                   w["observations"], num_shards=20))
    cat.register(fdb_mod.build_fdb("Trips", w["trips_schema"], w["trips"],
                                   num_shards=10))
    return cat


@pytest.fixture(scope="module", params=[0.5, 2.0], ids=["s0.5", "s2"])
def worlds(request):
    scale = request.param
    port = _catalog(syn, pfdb, pexec, scale)
    ref = _catalog(jsyn, jfdb, jexec, scale)
    import repro.core.exprs as jexprs
    flows = {**_queries(jcore, jtess.Tesseract, jsyn),
             **_filter_queries(jcore, jsyn, jexprs)}
    want = {name: jcore.Session(catalog=ref, backend="numpy").run(q())
            .to_records() for name, q in flows.items()}
    return scale, port, ref, want


def _run(cat, name, config, **kw):
    import repro_torch.core.exprs as exprs
    flows = {**_queries(core, tess.Tesseract, syn),
             **_filter_queries(core, syn, exprs)}
    sess = core.Session(catalog=cat, config=config)
    ops.reset_launch_counts()
    res = sess.run(flows[name](), **kw)
    return res, ops.launch_counts()


@pytest.mark.parametrize("name", QUERIES)
def test_slice_query_matches_reference(worlds, name):
    """Records equal to the JAX package's numpy oracle and to the port's
    own copy of it; one fused dispatch per wave of 8 shards."""
    _, port, _, want = worlds
    res, lc = _run(port, name,
                   pexec.ExecConfig(backend=pexec.TorchBackend(device="cpu")))
    assert res.to_records() == want[name]
    waves = math.ceil(len(res.plan.shard_ids) / 8)
    assert lc == {"run_wave_fused": waves}
    own, _ = _run(port, name, pexec.ExecConfig(backend=pexec.NumpyBackend()))
    assert own.to_records() == want[name]


def test_slice_selects_rows(worlds):
    """At scale 2 every query selects something, so the parity above is
    not vacuous."""
    scale, _, _, want = worlds
    if scale >= 2:
        assert all(want[name] for name in QUERIES)
    assert want["Q1"] and want["Q7-agg"]


@pytest.mark.parametrize("name", QUERIES)
def test_slice_declined_waves(worlds, name):
    """With fusion off, the per-primitive path launches the same kernels
    once per wave each, and gives the same records."""
    _, port, _, want = worlds
    res, lc = _run(port, name, pexec.ExecConfig(
        backend=pexec.TorchBackend(device="cpu"), fused=False))
    assert res.to_records() == want[name]
    waves = math.ceil(len(res.plan.shard_ids) / 8)
    assert "run_wave_fused" not in lc
    assert lc["bitmap_intersect_batched"] == waves
    assert lc["compact_batched"] == waves


@pytest.mark.parametrize("name", ["Q2-geo_index", "Q2-full_scan"])
def test_filter_query_matches_reference(worlds, name):
    """``.filter()`` runs per shard through the single-mask ``compact``
    (one launch per shard with rows) after the fused wave; records equal
    to the reference's."""
    _, port, _, want = worlds
    res, lc = _run(port, name,
                   pexec.ExecConfig(backend=pexec.TorchBackend(device="cpu")))
    assert res.to_records() == want[name]
    shards = len(res.plan.shard_ids)
    assert lc["run_wave_fused"] == math.ceil(shards / 8)
    assert 0 < lc["compact"] <= shards * (1 + name.endswith("full_scan"))
    assert want[name]


@pytest.mark.parametrize("name,stage", [("Q7-agg", "server"),
                                        ("Q1", "server")])
def test_retry_path_matches_reference(worlds, name, stage):
    """Two shards fail once; the best-effort retry re-runs each through
    ``run_shard_task`` on the single-shard seam — probe
    (``bitmap_intersect``, the spacetime ``postings_bitmap``), the S=1
    ``refine_tracks``, ``compact`` and ``segment_agg`` — and the records
    equal the reference's fault-free ones."""
    _, port, _, want = worlds
    plan = pexec.FaultPlan(fail_once={(stage, 1), (stage, 3)})
    res, lc = _run(port, name,
                   pexec.ExecConfig(backend=pexec.TorchBackend(device="cpu")),
                   fault_plan=plan)
    assert res.profile.retries == 2 and not res.profile.dropped_shards
    assert res.to_records() == want[name]
    assert lc["bitmap_intersect"] == 2 and lc["compact"] == 2
    if name == "Q7-agg":
        assert lc["refine_tracks"] == 2 and lc["postings_bitmap"] == 4
    else:                      # a retried shard with rows aggregates
        assert lc["segment_agg"] >= 2


def test_second_mixer_aggregate(worlds):
    """An aggregate over an aggregate runs in the mixer through the
    single-shard ``segment_aggregate``; bit-equal to the numpy oracle."""
    _, port, _, _ = worlds

    def flow():
        return (core.fdb("SpeedObservations")
                .find(core.BETWEEN(core.P.hour, 8, 9))
                .aggregate(core.group(core.P.road_id).count("n")
                           .avg(m=core.P.speed))
                .aggregate(core.group(core.P.n).count("k")
                           .avg(mm=core.P.m)))

    ops.reset_launch_counts()
    got = core.Session(catalog=port, backend=pexec.TorchBackend(
        device="cpu")).run(flow()).to_records()
    assert ops.launch_counts()["segment_agg"] >= 1
    want = core.Session(catalog=port, backend=pexec.NumpyBackend()).run(
        flow()).to_records()
    assert got == want and got


def test_fdb_saved_by_reference_loads_in_port(tmp_path):
    """``repro``'s ``FDb.save`` directory is the port's input format:
    the port's ``FDb.load`` rebuilds the indexes, and the slice's queries
    over it equal the reference's over the original."""
    ref = _catalog(jsyn, jfdb, jexec, 1.0)
    cat = pexec.Catalog(server_slots=64)
    for name in ("Trips", "SpeedObservations"):
        ref.get(name).save(str(tmp_path / name))
        loaded = pfdb.FDb.load(str(tmp_path / name))
        assert loaded.num_docs == ref.get(name).num_docs
        cat.register(loaded)
    jq = _queries(jcore, jtess.Tesseract, jsyn)
    for name in QUERIES:
        want = jcore.Session(catalog=ref, backend="numpy").run(
            jq[name]()).to_records()
        res, lc = _run(cat, name, pexec.ExecConfig(
            backend=pexec.TorchBackend(device="cpu")))
        assert res.to_records() == want, name
        assert set(lc) == {"run_wave_fused"}


_ISOLATED = r"""
import json, sys
from repro_torch.core import P, Session, fdb, group
from repro_torch.data.synthetic import BAY_AREA, city_region, generate_world
from repro_torch.exec import Catalog, ExecConfig, TorchBackend
from repro_torch.fdb import build_fdb
from repro_torch.tess import Tesseract
w = generate_world(scale=0.3, seed=0)
cat = Catalog()
cat.register(build_fdb("Trips", w["trips_schema"], w["trips"], num_shards=4))
day = 2 * 86400.0
t = Tesseract(city_region(*BAY_AREA), day + 6 * 3600, day + 12 * 3600) \
    .also(city_region("LA"), day + 6 * 3600, day + 18 * 3600)
sess = Session(catalog=cat,
               config=ExecConfig(backend=TorchBackend(device="cpu")))
res = sess.run(fdb("Trips").tesseract(t).aggregate(
    group(P.day).count("n").std_dev(sd=P.duration_s)))
import numpy as np
import repro_torch.configs, repro_torch.ml.attention, repro_torch.ml.layers
import repro_torch.ml.mamba, repro_torch.ml.moe, repro_torch.ml.params
import repro_torch.ml.transformer, repro_torch.ml.sharding
import repro_torch.ml.model, repro_torch.launch.train
import repro_torch.launch.mesh, repro_torch.launch.elastic
from repro_torch.configs import get_config
from repro_torch.launch.serve import Server
srv = Server(get_config("jamba_v0_1_52b"), device="cpu")
srv.generate_batch([np.arange(1, 6, dtype=np.int32)], max_new=2)
print(json.dumps({"rows": res.batch.n, "modules": sorted(sys.modules)}))
"""


def test_port_imports_neither_jax_nor_repro():
    """In a fresh interpreter the query slice and the LM serving path
    run without pulling in jax or any module of the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _ISOLATED], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    mods = json.loads(out.strip().splitlines()[-1])["modules"]
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    assert "repro_torch.kernels.fused" in mods
    assert {"repro_torch.launch.serve", "repro_torch.ml.mamba",
            "repro_torch.ml.moe", "repro_torch.configs.jamba_v0_1_52b",
            "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.ssm_scan",
            "repro_torch.kernels.selective_scan", "repro_torch.ml.sharding",
            "repro_torch.launch.train", "repro_torch.launch.elastic"} \
        <= set(mods)
