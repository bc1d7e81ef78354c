"""The hand-written CUDA kernels on the card (marker ``cuda``).

Each kernel is held to its plain PyTorch version on the same CUDA inputs
(exact, except float64 sums, which may differ by summation order only),
and the fused wave runs end to end on the card against the port's numpy
oracle.  Without a GPU every test here skips.  This file imports nothing
of ``jax`` or ``repro``, so a GPU machine without jax runs it with

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.synthetic import city_region, generate_world  # noqa
from repro_torch.exec import (Catalog, ExecConfig, NumpyBackend,  # noqa
                              TorchBackend)
from repro_torch.exec.refine import pack_constraints, pack_track_points  # noqa
from repro_torch.fdb import build_fdb                 # noqa: E402
from repro_torch.geo import mercator as M             # noqa: E402
from repro_torch.geo.areatree import AreaTree         # noqa: E402
from repro_torch.kernels import (_build, bitset, compact, ops,  # noqa: E402
                                 ref, refine, segment_agg)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _words(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                            .view(np.int32)).to(dev)


def _refine_inputs(rng, shard_docs, dev):
    """Ragged shards of random tracks (negative and positive times) and
    two multi-range constraints around sampled track keys."""
    packs, keys = [], []
    for n in shard_docs:
        lens = rng.integers(0, 12, n)
        lens[::3] = 0
        splits = np.concatenate([[0], np.cumsum(lens)])
        p = int(splits[-1])
        lat, lng = rng.uniform(37.6, 37.9, p), rng.uniform(-122.6, -122.2, p)
        packs.append(pack_track_points(lat, lng, rng.uniform(-5e4, 1e5, p),
                                       splits))
        keys.append(M.latlng_to_morton(lat, lng))
    keys = np.concatenate(keys)
    cons = []
    for _ in range(2):
        pick = rng.choice(keys, 150)
        width = rng.integers(1 << 20, 1 << 34, 150).astype(np.uint64)
        cons.append((AreaTree.from_ranges(pick - width // np.uint64(2),
                                          pick + width),
                     float(rng.uniform(-5e4, 0)),
                     float(rng.uniform(3e4, 1e5))))
    p_max = max(p.shape[1] for p, _ in packs)
    pts = np.zeros((len(packs), 4, p_max), np.uint32)
    rows = np.full((len(packs), p_max), -1, np.int32)
    for i, (p, r) in enumerate(packs):
        pts[i, :, :p.shape[1]] = p
        rows[i, :r.size] = r
    return (_words(pts, dev), torch.from_numpy(rows).to(dev),
            _words(pack_constraints(cons), dev))


@pytest.mark.parametrize("kernel", ["bitset", "compact", "segment_agg",
                                    "refine"])
def test_kernel_matches_plain_version(card, kernel):
    rng = np.random.default_rng(7)
    before = sum(_build.kernel_launches().values())
    if kernel == "bitset":
        stack = _words(rng.integers(0, 1 << 32, (5, 3, 65), dtype=np.uint64)
                       .astype(np.uint32), card)
        pairs = [(bitset.bitmap_intersect_batched(stack),
                  ref.bitmap_intersect_batched_ref(stack))]
    elif kernel == "compact":
        masks = torch.from_numpy(rng.random((4, 5000)) < .3).to(card)
        pairs = [(compact.compact_batched(masks),
                  ref.compact_batched_ref(masks))]
    elif kernel == "segment_agg":
        for groups in (300, 30_000):        # shared- and global-atomic paths
            gid = torch.from_numpy(rng.integers(-1, groups, 50_000)
                                   .astype(np.int32)).to(card)
            vals = torch.from_numpy(rng.uniform(1, 100, 50_000)
                                    .astype(np.float32)).to(card)
            got = segment_agg.segment_agg(gid, vals, groups)
            want = ref.segment_agg_ref(gid, vals, groups)
            assert torch.equal(got[0], want[0])
            for a, b in zip(got[1:], want[1:]):
                torch.testing.assert_close(a, b, rtol=1e-12, atol=0)
        pairs = []
    else:
        args = _refine_inputs(rng, [300, 120, 0, 33], card)
        pairs = []
        for kw in ({}, {"with_first_hits": True}, {"with_analytics": True}):
            got = refine.refine_tracks_batched(*args, 300, **kw)
            want = ref.refine_tracks_batched_ref(*args, 300, **kw)
            pairs.append((got, want) if kw else ((got,), (want,)))
        assert pairs[0][0][0].any() and not pairs[0][0][0].all()
    torch.cuda.synchronize()
    for got, want in pairs:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert sum(_build.kernel_launches().values()) > before


def test_fused_wave_on_card_matches_numpy_oracle(card):
    """Tesseract selection with a dwell reduction, and a group-by
    aggregate, through ``TorchBackend()`` on the card: one fused
    dispatch a wave, every kernel launched, results equal to the numpy
    oracle (aggregates within float32 staging)."""
    from repro_torch.core import P, Session, fdb, group, proto
    from repro_torch.tess import Tesseract
    w = generate_world(scale=2.0, seed=1)
    cat = Catalog()
    cat.register(build_fdb("Trips", w["trips_schema"], w["trips"],
                           num_shards=10))
    day = 2 * 86400.0
    sf = Tesseract(city_region("SF"), day + 6 * 3600, day + 12 * 3600)
    bk = (city_region("Berkeley"), day + 6 * 3600, day + 14 * 3600)
    flows = [fdb("Trips").tesseract(sf.dwell(300.0).also(*bk))
             .map(lambda p: proto(id=p.id)),
             fdb("Trips").tesseract(sf.also(*bk)).aggregate(
                 group(P.day).count("n").avg(d=P.duration_s))]
    gpu = Session(catalog=cat, config=ExecConfig(backend=TorchBackend()))
    host = Session(catalog=cat, config=ExecConfig(backend=NumpyBackend()))
    for flow in flows:
        ops.reset_launch_counts()
        _build.reset_kernel_launches()
        res = gpu.run(flow)
        waves = math.ceil(len(res.plan.shard_ids) / 8)
        assert ops.launch_counts() == {"run_wave_fused": waves}
        kc = _build.kernel_launches()
        assert kc["bitmap_intersect_batched"] == waves
        assert kc["refine_tracks_batched"] == waves
        assert kc["compact_batched"] == waves
        got, want = res.to_records(), host.run(flow).to_records()
        assert len(got) == len(want) > 0
        for g, r in zip(got, want):
            assert g.keys() == r.keys()
            for k, v in r.items():
                if isinstance(v, float):
                    assert abs(g[k] - v) <= 1e-6 * abs(v)
                else:
                    assert g[k] == v
