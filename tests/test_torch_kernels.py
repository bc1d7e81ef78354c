"""The port's four kernels held against the JAX package's Pallas kernels.

On the CPU every wrapper in ``repro_torch.kernels`` runs its plain PyTorch
version; these tests hold those versions to the JAX kernels run in
interpret mode and to ``repro/kernels/ref.py`` on the same inputs, made
with numpy from a seed.  Selections and integer tables must be equal;
float32 sums must agree with the interpret kernel to rtol 1e-6 (it sums
in float32 on the MXU's one-hot formulation, the port in float64).
The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                            # noqa: E402
import jax.experimental                               # noqa: E402
import jax.numpy as jnp                               # noqa: E402

from repro.exec.refine import (f64_from_sort_key, f64_sort_key,  # noqa: E402
                               pack_constraints, pack_track_points,
                               refine_tracks_host)
from repro.fdb.index import bitmap_from_ids, mask_from_bitmap  # noqa: E402
from repro.geo import mercator as M                   # noqa: E402
from repro.geo.areatree import AreaTree               # noqa: E402
from repro.kernels import bitset as jbitset           # noqa: E402
from repro.kernels import compact as jcompact         # noqa: E402
from repro.kernels import fused as jfused             # noqa: E402
from repro.kernels import ref as jref                 # noqa: E402
from repro.kernels import refine as jrefine           # noqa: E402
from repro.kernels import segment_agg as jseg         # noqa: E402

from repro_torch.kernels import (bitset, compact, fused, ops,  # noqa: E402
                                 ref, refine, segment_agg)


def _x64():
    """float64 in JAX: the experimental context manager where this jax
    has it, else ``jax.enable_x64`` (jax ≥ 0.9 moved it there)."""
    legacy = getattr(jax.experimental, "enable_x64", None)
    return legacy() if legacy is not None else jax.enable_x64(True)


def _words(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy words → int32 torch tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ------------------------------------------------------------------ bitset

@pytest.mark.parametrize("s,k,w", [(1, 1, 31), (3, 2, 32), (4, 3, 33),
                                   (2, 4, 64), (5, 2, 65), (8, 3, 700)])
def test_bitmap_intersect_batched(s, k, w):
    """Ragged (zero-padded) and empty shards, word-boundary widths."""
    rng = np.random.default_rng(1000 * s + 10 * k + w)
    stack = rng.integers(0, 1 << 32, (s, k, w), dtype=np.uint64) \
        .astype(np.uint32)
    stack |= stack[:, :1] & rng.integers(0, 1 << 32, (s, 1, w),
                                         dtype=np.uint64).astype(np.uint32)
    for i in range(s):                       # ragged: zero tail words
        stack[i, :, int(rng.integers(0, w + 1)):] = 0
    if s > 2:
        stack[1] = 0                         # an empty shard
    bm, cnt = bitset.bitmap_intersect_batched(_words(stack))
    jbm, jcnt = jbitset.bitmap_intersect_batched(jnp.asarray(stack),
                                                 interpret=True)
    rbm, rcnt = jref.bitmap_intersect_batched_ref(jnp.asarray(stack))
    for want_bm, want_cnt in ((jbm, jcnt), (rbm, rcnt)):
        assert np.array_equal(_u32(bm), np.asarray(want_bm))
        assert np.array_equal(cnt.numpy(), np.asarray(want_cnt))
    assert cnt.dtype == torch.int32 and bm.dtype == torch.int32


def test_bitmap_intersect_batched_empty_wave():
    bm, cnt = bitset.bitmap_intersect_batched(
        torch.zeros((0, 3, 5), dtype=torch.int32))
    assert bm.shape == (0, 5) and cnt.shape == (0,)
    with pytest.raises(ValueError):
        bitset.bitmap_intersect_batched(torch.zeros((2, 3, 5)))


def test_popcount_words_sign_bit():
    """Arithmetic ``>>`` on int32 would smear the sign bit: the SWAR
    popcount must see 0x80000000 and 0xFFFFFFFF as 1 and 32 bits."""
    w = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x55555555],
                 np.uint32)
    got = ref.popcount_words(_words(w)).numpy()
    assert got.tolist() == [bin(int(x)).count("1") for x in w]


# ------------------------------------------------------------------ compact

@pytest.mark.parametrize("s,n,density", [(1, 31, .5), (3, 32, .3),
                                         (4, 33, .9), (2, 64, .05),
                                         (5, 65, .5), (3, 4100, .4)])
def test_compact_batched(s, n, density):
    """Byte parity with the TPU kernel: ragged masks, an empty shard,
    word-boundary lengths, and more than one 4096-row scan block."""
    rng = np.random.default_rng(int(n * 10 + s + density * 100))
    masks = rng.random((s, n)) < density
    masks[0] = False                         # an empty shard
    for i in range(1, s):                    # ragged: False-padded tail
        masks[i, int(rng.integers(0, n + 1)):] = False
    idx, cnt = compact.compact_batched(torch.from_numpy(masks))
    jidx, jcnt = jcompact.compact_batched(jnp.asarray(masks), interpret=True)
    ridx, rcnt = jref.compact_batched_ref(jnp.asarray(masks))
    for want_idx, want_cnt in ((jidx, jcnt), (ridx, rcnt)):
        assert np.array_equal(idx.numpy(), np.asarray(want_idx))
        assert np.array_equal(cnt.numpy(), np.asarray(want_cnt))


@pytest.mark.parametrize("shape", [(0, 7), (3, 0), (0, 0)])
def test_compact_batched_empty(shape):
    masks = np.zeros(shape, bool)
    idx, cnt = compact.compact_batched(torch.from_numpy(masks))
    jidx, jcnt = jcompact.compact_batched(jnp.asarray(masks), interpret=True)
    assert idx.shape == np.asarray(jidx).shape and cnt.shape == (shape[0],)
    assert np.array_equal(cnt.numpy(), np.asarray(jcnt))


# -------------------------------------------------------------- segment_agg

@pytest.mark.parametrize("n,g", [(31, 3), (64, 33), (65, 1), (1000, 130),
                                 (5000, 257)])
def test_segment_agg_float32(n, g):
    """Exact counts; float32 sums within rtol 1e-6 of the interpret
    kernel (positive values, so rtol is meaningful per group)."""
    rng = np.random.default_rng(n + g)
    gid = rng.integers(-1, g, n).astype(np.int32)
    vals = rng.uniform(1.0, 100.0, n).astype(np.float32)
    cnt, s, s2 = segment_agg.segment_agg(torch.from_numpy(gid),
                                         torch.from_numpy(vals), g)
    jc, js, js2 = jseg.segment_agg(jnp.asarray(gid), jnp.asarray(vals), g,
                                   interpret=True)
    assert np.array_equal(cnt.numpy(), np.rint(np.asarray(jc)).astype(int))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), rtol=1e-6)
    rc, rs, rs2 = jref.segment_agg_ref(jnp.asarray(gid), jnp.asarray(vals), g)
    assert np.array_equal(cnt.numpy(), np.rint(np.asarray(rc)).astype(int))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-6)


def test_segment_agg_float64_bit_equal():
    """float64 values sum in row order: bit-equal to the JAX oracle under
    x64 and to the numpy oracle's bincount."""
    rng = np.random.default_rng(5)
    n, g = 20_000, 300
    gid = rng.integers(-1, g, n).astype(np.int32)
    vals = rng.normal(48.0, 9.0, n)
    cnt, s, s2 = segment_agg.segment_agg(torch.from_numpy(gid),
                                         torch.from_numpy(vals), g)
    keep = gid >= 0
    assert np.array_equal(s.numpy(), np.bincount(gid[keep], vals[keep], g))
    assert np.array_equal(s2.numpy(),
                          np.bincount(gid[keep], vals[keep] ** 2, g))
    with _x64():
        rc, rs, rs2 = jref.segment_agg_ref(jnp.asarray(gid),
                                           jnp.asarray(vals), g)
        rc, rs, rs2 = np.asarray(rc), np.asarray(rs), np.asarray(rs2)
    assert np.array_equal(cnt.numpy(), rc.astype(np.int64))
    assert np.array_equal(s.numpy(), rs)
    assert np.array_equal(s2.numpy(), rs2)


# ------------------------------------------------------------------- refine

def _tracks(rng, n_docs, max_len, empty_every=3):
    lens = rng.integers(0, max_len, n_docs)
    lens[::empty_every] = 0                  # empty tracks
    splits = np.zeros(n_docs + 1, np.int64)
    np.cumsum(lens, out=splits[1:])
    p = int(splits[-1])
    lat = rng.uniform(37.6, 37.9, p)
    lng = rng.uniform(-122.6, -122.2, p)
    # negative timestamps give sort keys with bit 63 clear, positive ones
    # bit 63 set: both halves of the key space are exercised
    t = rng.uniform(-5e4, 1e5, p)
    return lat, lng, t, splits


def _constraints(rng, lat, lng, n_c):
    """Multi-range covers: random ranges around sampled track keys (many
    disjoint ranges, R padded past one 128-slot block) and boxes."""
    keys = M.latlng_to_morton(lat, lng) if lat.size else \
        np.zeros(1, np.uint64)
    cons = []
    for c in range(n_c):
        if c % 2 == 0:
            pick = rng.choice(keys, size=min(150, keys.size))
            width = rng.integers(1 << 20, 1 << 34, pick.size).astype(
                np.uint64)
            region = AreaTree.from_ranges(pick - width // np.uint64(2),
                                          pick + width)
        else:
            ix, iy = M.latlng_to_xy(rng.uniform(37.6, 37.9),
                                    rng.uniform(-122.6, -122.2))
            d = int(rng.integers(3_000, 2_000_000))
            region = AreaTree.from_box(int(ix) - d, int(iy) - d,
                                       int(ix) + d, int(iy) + d, max_level=7)
        t0 = float(rng.uniform(-5e4, 3e4))
        cons.append((region, t0, float(t0 + rng.uniform(1e4, 1e5))))
    return cons


def _wave(rng, shard_docs, n_c, max_len=12):
    """Stacked (pts, rows) for ragged shards sharing one constraint set."""
    tracks = [_tracks(rng, n, max_len) for n in shard_docs]
    all_lat = np.concatenate([t[0] for t in tracks])
    all_lng = np.concatenate([t[1] for t in tracks])
    cons = _constraints(rng, all_lat, all_lng, n_c)
    packs = [pack_track_points(*t) for t in tracks]
    p_max = max(1, max(p.shape[1] for p, _ in packs))
    pts = np.zeros((len(packs), 4, p_max), np.uint32)
    rows = np.full((len(packs), p_max), -1, np.int32)
    for i, (p, r) in enumerate(packs):
        pts[i, :, :p.shape[1]] = p
        rows[i, :r.size] = r
    return tracks, cons, pts, rows, pack_constraints(cons)


def _port_refine(pts, rows, cov, n, **kw):
    out = refine.refine_tracks_batched(_words(pts), torch.from_numpy(rows),
                                       _words(cov), n, **kw)
    out = out if isinstance(out, tuple) else (out,)
    return [o.numpy().view(np.uint32) if o.dtype == torch.int32 and i in
            (1, 2, 3, 4) else o.numpy() for i, o in enumerate(out)]


def _jax_refine(fn, pts, rows, cov, n, **kw):
    out = fn(jnp.asarray(pts), jnp.asarray(rows), jnp.asarray(cov), n, **kw)
    out = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o) for o in out]


MODES = [{}, {"with_first_hits": True}, {"with_analytics": True}]


@pytest.mark.parametrize("n_docs", [31, 32, 33, 64, 65])
def test_refine_tracks_batched_modes(n_docs):
    """All three output modes, word-boundary doc counts, several cover
    ranges, empty tracks, bit-63 sort keys: equal to the interpret kernel
    and to the jnp oracle, word for word."""
    rng = np.random.default_rng(n_docs)
    _, _, pts, rows, cov = _wave(rng, [n_docs, n_docs // 2, 0], 3)
    assert cov.shape[2] > 128                # more than one range block
    for kw in MODES:
        got = _port_refine(pts, rows, cov, n_docs, **kw)
        want_i = _jax_refine(lambda *a, **k: jrefine.refine_tracks_batched(
            *a, interpret=True, **k), pts, rows, cov, n_docs, **kw)
        want_r = _jax_refine(jref.refine_tracks_batched_ref, pts, rows, cov,
                             n_docs, **kw)
        assert len(got) == len(want_i) == len(want_r) == 1 + 2 * bool(kw) \
            + 3 * ("with_analytics" in kw)
        for g, wi, wr in zip(got, want_i, want_r):
            assert np.array_equal(g, wi), kw
            assert np.array_equal(g, wr), kw
    assert got[0].any() and not got[0].all()   # the case discriminates


def test_refine_tracks_batched_vs_host_oracle():
    """Per shard, equal to the numpy host oracle's mask and uint64
    first/last/count tables (the backend's parity surfaces)."""
    rng = np.random.default_rng(11)
    shard_docs = [40, 1, 0, 17]
    tracks, cons, pts, rows, cov = _wave(rng, shard_docs, 2)
    m, fh, fl, lh, ll, cnt = _port_refine(pts, rows, cov, max(shard_docs),
                                          with_analytics=True)
    for i, (track, n) in enumerate(zip(tracks, shard_docs)):
        want, first, last, count = refine_tracks_host(
            *track, n, cons, with_analytics=True)
        got_first = ((fh[i, :, :n].astype(np.uint64) << np.uint64(32))
                     | fl[i, :, :n].astype(np.uint64)).T
        got_last = ((lh[i, :, :n].astype(np.uint64) << np.uint64(32))
                    | ll[i, :, :n].astype(np.uint64)).T
        assert np.array_equal(m[i, :n], want)
        assert np.array_equal(got_first, first)
        assert np.array_equal(got_last, last)
        assert np.array_equal(cnt[i, :, :n].T, count)
        assert not m[i, n:].any()            # padding never hits


@pytest.mark.parametrize("kw", MODES)
def test_refine_tracks_batched_empty(kw):
    """No shards, no docs, no points, no constraints."""
    cov = pack_constraints([(AreaTree.everything(), 0.0, 1.0)])
    for shape, n in (((0, 4, 0), 5), ((2, 4, 0), 5), ((2, 4, 3), 0)):
        pts = np.zeros(shape, np.uint32)
        rows = np.full((shape[0], shape[2]), -1, np.int32)
        got = _port_refine(pts, rows, cov, n, **kw)
        want = _jax_refine(jref.refine_tracks_batched_ref, pts, rows, cov, n,
                           **kw)
        for g, w in zip(got, want):
            assert g.shape == w.shape and np.array_equal(g, w)
    no_cons = np.zeros((0, 8, 128), np.uint32)
    got = _port_refine(np.zeros((1, 4, 2), np.uint32),
                       np.zeros((1, 2), np.int32), no_cons, 3, **kw)
    assert got[0].all()                      # vacuous truth


def test_refine_rejects_bad_inputs():
    pts = torch.zeros((1, 4, 2), dtype=torch.int32)
    rows = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        refine.refine_tracks_batched(
            pts, rows, torch.zeros((31, 8, 128), dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        refine.refine_tracks_batched(
            pts, torch.zeros((1, 3), dtype=torch.int32),
            torch.zeros((1, 8, 128), dtype=torch.int32), 3)


# ------------------------------------------------------ the fused stages

def test_key64_orders_word_pairs_unsigned():
    rng = np.random.default_rng(3)
    u = rng.integers(0, 1 << 64, 4000, dtype=np.uint64)
    u[:4] = [0, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    hi, lo = (u >> np.uint64(32)).astype(np.uint32), u.astype(np.uint32)
    k = ref.key64(_words(hi), _words(lo))
    order = np.argsort(k.numpy(), kind="stable")
    assert np.array_equal(u[order], np.sort(u))
    h2, l2 = ref.split64(k)
    assert np.array_equal(_u32(h2), hi) and np.array_equal(_u32(l2), lo)


def test_unpack_sort_key_matches_host():
    rng = np.random.default_rng(4)
    t = np.concatenate([rng.uniform(-1e6, 1e6, 500), [0.0, -0.0, 1e-300]])
    k = f64_sort_key(t)
    hi, lo = (k >> np.uint64(32)).astype(np.uint32), k.astype(np.uint32)
    got = fused._unpack_sort_key(_words(hi), _words(lo)).numpy()
    assert np.array_equal(got.view(np.uint64),
                          f64_from_sort_key(k).view(np.uint64))


def test_mask_stage_matches_host_bitmaps():
    rng = np.random.default_rng(8)
    ns = [65, 0, 31, 64]
    w = max(1, (max(ns) + 31) // 32)
    bms = np.zeros((len(ns), w), np.uint32)
    for i, n in enumerate(ns):
        b = bitmap_from_ids(np.nonzero(rng.random(n) < .5)[0], n)
        bms[i, :b.size] = b
    got = fused._mask_stage(_words(bms), torch.tensor(ns, dtype=torch.int32),
                            max(ns)).numpy()
    for i, n in enumerate(ns):
        assert np.array_equal(got[i, :n], mask_from_bitmap(bms[i], n))
        assert not got[i, n:].any()


def _fused_inputs(rng):
    shard_docs = [70, 33, 0, 64]
    n_max = max(shard_docs)
    _, cons, pts, rows, cov = _wave(rng, shard_docs, 2)
    w = (n_max + 31) // 32
    stack = np.zeros((len(shard_docs), 3, w), np.uint32)
    for i, n in enumerate(shard_docs):
        full = bitmap_from_ids(np.arange(n), n)
        stack[i, 0, :full.size] = full
        probe = bitmap_from_ids(np.nonzero(rng.random(n) < .8)[0], n)
        stack[i, 1, :probe.size] = probe
        stack[i, 2, :full.size] = full
    g = [5, 0, 0, 7]
    offs = np.cumsum([0] + g)
    codes = np.full((len(shard_docs), n_max), -1, np.int32)
    for i, n in enumerate(shard_docs):
        if g[i]:
            codes[i, :n] = rng.integers(0, g[i], n) + offs[i]
    vals = rng.uniform(1.0, 50.0, (len(shard_docs), n_max)).astype(
        np.float32)
    ns = np.asarray(shard_docs, np.int32)
    return stack, ns, pts, rows, cov, codes, vals, n_max, int(offs[-1])


def test_run_wave_fused_matches_jax_interpret():
    """The whole wave — probe, refine with an ordering edge, compact,
    segment-agg with a min/max slot — against the JAX fused pipeline on
    its interpret kernels; one logical dispatch."""
    rng = np.random.default_rng(21)
    stack, ns, pts, rows, cov, codes, vals, n_max, total = \
        _fused_inputs(rng)
    ops.reset_launch_counts()
    cand, idx, cnt, segs = ops.run_wave_fused(
        _words(stack), torch.from_numpy(ns), _words(pts),
        torch.from_numpy(rows), _words(cov), torch.from_numpy(codes),
        (torch.from_numpy(vals),), num_docs=n_max, edges=((0, 1),),
        total_groups=total, minmax=(True,))
    assert ops.launch_counts() == {"run_wave_fused": 1}
    jc, jidx, jcnt, jsegs = jfused.run_wave_fused(
        jnp.asarray(stack), jnp.asarray(ns), jnp.asarray(pts),
        jnp.asarray(rows), jnp.asarray(cov), jnp.asarray(codes),
        (jnp.asarray(vals),), num_docs=n_max, edges=((0, 1),),
        total_groups=total, impl="interpret", minmax=(True,))
    assert np.array_equal(cand.numpy(), np.asarray(jc))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(cnt.numpy(), np.asarray(jcnt))
    assert cnt.numpy().sum() > 0
    (c, s, s2, mn, mx), = segs
    jc_, js, js2, jmn, jmx = jsegs[0]
    assert np.array_equal(c.numpy(), np.rint(np.asarray(jc_)).astype(int))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), rtol=1e-6)
    assert np.array_equal(mn.numpy(), np.asarray(jmn))
    assert np.array_equal(mx.numpy(), np.asarray(jmx))


@pytest.mark.parametrize("min_counts,dwells", [((2, 1), (None, None)),
                                               ((1, 0), (None, None)),
                                               ((1, 1), (5000.0, None))])
def test_refine_stage_reductions_match_host(min_counts, dwells):
    """Count / vacuous-count / dwell verdicts recomputed from the
    analytics tables equal the numpy host oracle's."""
    rng = np.random.default_rng(31)
    shard_docs = [50, 20]
    tracks, cons, pts, rows, cov = _wave(rng, shard_docs, 2, max_len=30)
    got = fused._refine_stage(_words(pts), torch.from_numpy(rows),
                              _words(cov), max(shard_docs), ((0, 1),),
                              min_counts, dwells).numpy()
    for i, (track, n) in enumerate(zip(tracks, shard_docs)):
        want = refine_tracks_host(*track, n, cons, edges=((0, 1),),
                                  min_counts=min_counts, dwells=dwells)
        assert np.array_equal(got[i, :n], want)
