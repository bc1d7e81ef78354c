"""The port's first slice end to end: the fused Tesseract query wave.

The same synthetic world runs the slice's four queries — Q7-agg (the
Tesseract Q7 legs with a day group-by: count, avg, std_dev), Q9-agg (the
same legs ordered), Q11 (the dwell query) and Q1 (traffic variability) —
through ``repro_torch`` ``Session(backend=TorchBackend(device="cpu"))``
and through the JAX package's ``Session(backend="numpy")``.  Records must
be equal, float64 aggregates bit for bit (the port stages float64 values
on the CPU and its plain segment sums accumulate in row order, as numpy's
bincount does).  The fused launch contract is ⌈shards/wave⌉
``run_wave_fused`` dispatches per query.
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
    want = {name: jcore.Session(catalog=ref, backend="numpy").run(q())
            .to_records()
            for name, q in _queries(jcore, jtess.Tesseract, jsyn).items()}
    return scale, port, ref, want


def _run(cat, name, config):
    sess = core.Session(catalog=cat, config=config)
    ops.reset_launch_counts()
    res = sess.run(_queries(core, tess.Tesseract, syn)[name]())
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
print(json.dumps({"rows": res.batch.n, "modules": sorted(sys.modules)}))
"""


def test_port_imports_neither_jax_nor_repro():
    """In a fresh interpreter the slice runs without pulling in jax or
    any module of the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _ISOLATED], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    mods = json.loads(out.strip().splitlines()[-1])["modules"]
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    assert "repro_torch.kernels.fused" in mods
