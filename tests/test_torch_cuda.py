"""The hand-written CUDA kernels on the card (marker ``cuda``).

Each kernel is held to its plain PyTorch version on the same CUDA inputs
(exact, except float64 sums, which may differ by summation order only),
and the fused wave and the coalescing query server run end to end on the
card against the port's numpy oracle — and, with two cards or more, with
each partition's waves on its own card (these tests skip below two
cards); the LM's prefill (through the
flash-attention and ssm_scan kernels) is held to its plain decode path.  Without a GPU every test here skips.  This file imports nothing
of ``jax`` or ``repro``, so a GPU machine without jax runs it with

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
"""
import contextlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.synthetic import city_region, generate_world  # noqa
from repro_torch.exec import (Catalog, ExecConfig, NumpyBackend,  # noqa
                              TorchBackend)
from repro_torch.exec.refine import (f64_sort_key,  # noqa: E402
                                     pack_constraints,
                                     pack_constraints_multi,
                                     pack_track_points)
from repro_torch.fdb import build_fdb                 # noqa: E402
from repro_torch.geo import mercator as M             # noqa: E402
from repro_torch.geo.areatree import AreaTree         # noqa: E402
from repro_torch.configs import get_config            # noqa: E402
from repro_torch.kernels import (_build, bitset, compact, ops,  # noqa: E402
                                 ref, refine, segment_agg)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssm_scan as ssm       # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.ml.transformer import LM             # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card(monkeypatch):
    """One card.  On a host with more, queries would default to one
    partition a card; the one-card contracts here pin P = 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    from repro_torch.core.planner import PARTITIONS_ENV
    monkeypatch.setenv(PARTITIONS_ENV, "1")
    return torch.device("cuda")


def _words(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                            .view(np.int32)).to(dev)


def _refine_inputs(rng, shard_docs, dev, n_ranges=(150, 150)):
    """Ragged shards of random tracks (negative and positive times) and
    one constraint per ``n_ranges`` entry around sampled track keys;
    returns ``(pts, rows, cov, constraints)``."""
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
    for n_r in n_ranges:
        pick = rng.choice(keys, n_r)
        width = rng.integers(1 << 20, 1 << 34, n_r).astype(np.uint64)
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
            _words(pack_constraints(cons), dev), cons)


@pytest.mark.parametrize("kernel", ["bitset", "compact", "segment_agg",
                                    "refine", "refine_multi",
                                    "bitmap_intersect", "mask_scan",
                                    "bitset_binary"])
def test_kernel_matches_plain_version(card, kernel):
    rng = np.random.default_rng(7)
    before = sum(_build.kernel_launches().values())
    pairs = []
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
    elif kernel == "refine":
        args = _refine_inputs(rng, [300, 120, 0, 33], card)[:3]
        pairs = []
        for kw in ({}, {"with_first_hits": True}, {"with_analytics": True}):
            got = refine.refine_tracks_batched(*args, 300, **kw)
            want = ref.refine_tracks_batched_ref(*args, 300, **kw)
            pairs.append((got, want) if kw else ((got,), (want,)))
        assert pairs[0][0][0].any() and not pairs[0][0][0].all()
    elif kernel == "refine_multi":
        # three queries of 1, 2 and 3 constraints (pad constraints and
        # pad range slots); the 3rd query's 5000 ranges push the table
        # past shared memory, so the global-memory path runs too
        pts, rows, _, cons = _refine_inputs(rng, [300, 120, 0, 33], card,
                                            (150, 40, 5000))
        for table in ([cons[:1], cons[:2], cons], [cons[:1], cons[1:2]]):
            cov = _words(pack_constraints_multi(table), card)
            pairs = []
            for kw in ({}, {"with_first_hits": True},
                       {"with_analytics": True}):
                got = refine.refine_tracks_multi(pts, rows, cov, 300, **kw)
                want = ref.refine_tracks_multi_ref(pts, rows, cov, 300, **kw)
                pairs.append((got, want) if kw else ((got,), (want,)))
            assert pairs[0][0][0].any() and not pairs[0][0][0].all()
            torch.cuda.synchronize()
            for got, want in pairs:
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype and torch.equal(a, b)
        pairs = []
        # the single-shard wrapper is the batched kernel at S=1
        one = refine.refine_tracks(pts[0], rows[0], _words(
            pack_constraints(cons[:2]), card), 300, with_analytics=True)
        want = ref.refine_tracks_batched_ref(pts[:1], rows[:1], _words(
            pack_constraints(cons[:2]), card), 300, with_analytics=True)
        pairs.append((one, tuple(w[0] for w in want)))
    elif kernel == "bitmap_intersect":
        for k, w in ((1, 31), (3, 65), (4, 100_003)):
            stack = _words(rng.integers(0, 1 << 32, (k, w), dtype=np.uint64)
                           .astype(np.uint32), card)
            pairs.append((bitset.bitmap_intersect(stack),
                          ref.bitmap_intersect_ref(stack)))
    elif kernel == "mask_scan":
        for n, density in ((1, 1.0), (4095, .5), (4097, .3),
                           (900_001, .01), (70_000, .999)):
            mask = torch.from_numpy(rng.random(n + 3) < density).to(card)
            for m in (mask[:n], mask[3:]):   # aligned and unaligned bytes
                pairs.append((compact.compact(m), ref.compact_ref(m)))
                pairs.append((compact.mask_prefix_sum(m),
                              ref.mask_prefix_sum_ref(m)))
    else:
        for w in (1, 7, 4096, 100_001):
            a, b = (_words(rng.integers(0, 1 << 32, w + 1, dtype=np.uint64)
                           .astype(np.uint32), card) for _ in range(2))
            for op in bitset.BINARY_OPS:
                # aligned (16-byte vectors) and offset (scalar) buffers
                for x, y in ((a[:w], b[:w]), (a[1:], b[1:])):
                    pairs.append(((bitset.bitset_binary(x, y, op),),
                                  (ref.bitset_binary_ref(x, y, op),)))
    torch.cuda.synchronize()
    for got, want in pairs:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert sum(_build.kernel_launches().values()) > before


def _seg_ids(rng, case):
    """(group ids, G) for one segment_agg case: both branches at their
    threshold, the edge cases, and the smoke run's wave and large shapes
    (rows, groups, selected share) on each branch."""
    shapes = {"wave_shared": (19_200, 56, .0075),
              "large_shared": (864_000, 56, .0075),
              "wave_global": (160_000, 77_888, .0049),
              "large_global": (7_200_000, 3_504_960, .0049)}
    if case in shapes:
        n, g, share = shapes[case]
        ids = np.where(rng.random(n) < share, rng.integers(0, g, n), -1)
        return ids, g
    g = {"g2048": 2048, "g2049": 2049}.get(case, 300)
    n = {"empty": 0, "unaligned": 50_001}.get(case, 50_000)
    if case == "all_masked":
        return np.full(n, -1), g
    if case == "past_g":                 # masked, in range and past G
        return rng.integers(-3, 2 * g, n), g
    if case == "one_group":              # every row in group 7
        return np.full(n, 7), g
    return rng.integers(-1, g, n), g


SEG_CASES = ["g2048", "g2049", "empty", "all_masked", "past_g", "one_group",
             "unaligned", "wave_shared", "large_shared", "wave_global",
             "large_global"]


@pytest.mark.parametrize("case", SEG_CASES)
def test_segment_agg_kernel_cases(card, case):
    """Both branches: counts exact, sums within 1e-12 of the group's Σ|v|
    (Σv² for the squares) of the plain version's row-order float64 sums;
    one launch a call with rows and groups, none without."""
    rng = np.random.default_rng(SEG_CASES.index(case))
    ids, g = _seg_ids(rng, case)
    gid = torch.from_numpy(ids.astype(np.int32)).to(card)
    vals = torch.from_numpy(rng.uniform(-50.0, 130.0, ids.size)
                            .astype(np.float32)).to(card)
    if case == "unaligned":              # ids off a 16-byte boundary
        gid, vals = gid[1:], vals[1:]
    want = ref.segment_agg_ref(gid, vals, g)
    scales = ref.segment_agg_ref(gid, vals.abs(), g)[1:]
    before = _build.kernel_launches().get("segment_agg", 0)
    got = segment_agg.segment_agg(gid, vals, g)
    torch.cuda.synchronize()
    assert _build.kernel_launches().get("segment_agg", 0) == \
        before + int(gid.numel() > 0)
    assert got[0].dtype == torch.int32 and torch.equal(got[0], want[0])
    for a, b, scale in zip(got[1:], want[1:], scales):
        assert a.dtype == torch.float64 and a.shape == (g,)
        assert bool(((a - b).abs() <= 1e-12 * scale).all())
    if case == "one_group":
        assert int(got[0][7]) == ids.size and int(got[0].sum()) == ids.size


@pytest.mark.parametrize("case", ["g2048", "past_g", "one_group",
                                  "wave_shared", "large_shared"])
def test_segment_agg_shared_branch_bit_identical(card, case):
    """The shared branch adds in a fixed order: two calls give the same
    bits (float64 atomics would not)."""
    rng = np.random.default_rng(100 + SEG_CASES.index(case))
    ids, g = _seg_ids(rng, case)
    assert g <= segment_agg.SHARED_MAX_GROUPS
    gid = torch.from_numpy(ids.astype(np.int32)).to(card)
    vals = torch.from_numpy(rng.normal(0.0, 1e3, ids.size)
                            .astype(np.float32)).to(card)
    first = segment_agg.segment_agg(gid, vals, g)
    second = segment_agg.segment_agg(gid, vals, g)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _edge_constraints(rng, n_c, n_ranges):
    """``n_c`` constraints of ``n_ranges`` sorted, disjoint, non-touching
    key ranges in [0, 2^60) and a time window each."""
    cons = []
    for _ in range(n_c):
        cuts = np.unique(rng.integers(0, 1 << 40, 3 * n_ranges + 8))
        cuts = cuts[:2 * n_ranges].astype(np.uint64) << np.uint64(20)
        tree = AreaTree.from_ranges(cuts[0::2], cuts[1::2])
        assert tree.lo.size == n_ranges
        t0 = float(rng.uniform(0.0, 4e5))
        cons.append((tree, t0, t0 + float(rng.uniform(1e5, 4e5))))
    return cons


def _edge_points(rng, cons, shard_points, p):
    """Shards of docs (runs of 1-70 points, -1 padding after
    ``shard_points[s]`` points, so docs straddle the kernel's 8-point,
    256-point and 2048-point edges) whose keys sit exactly at range los,
    at his (the first key past a range), one below each, in gaps, or
    repeat the point before (a track that stays in one range), and whose
    times sit exactly at, just outside and inside the windows."""
    los = np.concatenate([c[0].lo for c in cons])
    his = np.concatenate([c[0].hi for c in cons])
    pool = np.concatenate([los, his, his - np.uint64(1), los - np.uint64(1),
                           los // np.uint64(2) + his // np.uint64(2),
                           rng.integers(0, 1 << 60, los.size)
                           .astype(np.uint64)])
    w = np.array([[t0, t1] for _, t0, t1 in cons]).ravel()
    tpool = np.concatenate([w, np.nextafter(w, -np.inf),
                            np.nextafter(w, np.inf),
                            rng.uniform(-1e5, 9e5, w.size)])
    pts = np.zeros((len(shard_points), 4, p), np.uint32)
    rows = np.full((len(shard_points), p), -1, np.int32)
    for s, n in enumerate(shard_points):
        lens = rng.integers(1, 71, n)
        doc = np.repeat(np.arange(n), lens)[:n]
        keys = rng.choice(pool, n)
        stay = rng.random(n) < 0.5
        for i in np.flatnonzero(stay[1:]) + 1:
            keys[i] = keys[i - 1]
        t = f64_sort_key(rng.choice(tpool, n))
        for j, v in enumerate((keys, t)):
            pts[s, 2 * j, :n] = (v >> np.uint64(32)).astype(np.uint32)
            pts[s, 2 * j + 1, :n] = (v & np.uint64(0xFFFFFFFF)).astype(
                np.uint32)
        rows[s, :n] = doc
    return pts, rows


#: name → (constraints, ranges each); R is pack_constraints' padding of
#: the ranges to a multiple of 128 (R = 1: the table's first slot only);
#: the kernel queues constraints two at a time, so C = 1 and 3 leave a
#: lone one
REFINE_EDGE_CASES = {"r1_c1": (1, 1), "r896_c2": (2, 896),
                     "r256_c3": (3, 200), "r128_c30": (30, 100),
                     "global_c2": (2, 8000)}
_REFINE_MODES = ({}, {"with_first_hits": True}, {"with_analytics": True})


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", list(REFINE_EDGE_CASES))
def test_refine_kernel_edge_cases(card, case):
    """The three refine wrappers against their plain versions, exact in
    every output mode, and two calls equal bit for bit: keys at a range's
    lo, at its hi and in gaps, times at a window's ends, docs straddling
    the kernel's tiles, an all-padding shard, multi tables padded by
    ``pack_constraints_multi`` (pad constraints and pad slots; 3 queries
    double-buffer the shared tables, 2 keep one each).  ``global_c2``'s
    table is past shared memory, so it runs the global-memory route."""
    n_c, n_r = REFINE_EDGE_CASES[case]
    rng = np.random.default_rng(sorted(REFINE_EDGE_CASES).index(case))
    cons = _edge_constraints(rng, n_c, n_r)
    cov_np = pack_constraints(cons)
    if n_r == 1:
        cov_np = np.ascontiguousarray(cov_np[:, :, :1])
    c, _, r = cov_np.shape
    assert r == (1 if n_r == 1 else -(-n_r // 128) * 128)
    if case == "global_c2":
        assert 8 * refine._record_words(c, r) > 232448
    pts_np, rows_np = _edge_points(rng, cons, [5000, 2100, 0], 5000)
    assert rows_np[0, 255] == rows_np[0, 256] or \
        rows_np[0, 2047] == rows_np[0, 2048]
    keys = (pts_np[0, 0].astype(np.uint64) << np.uint64(32)) | pts_np[0, 1]
    assert np.isin(keys, cons[0][0].lo).any()
    assert np.isin(keys, cons[0][0].hi).any()
    pts, rows = _words(pts_np, card), torch.from_numpy(rows_np).to(card)
    cov = _words(cov_np, card)
    docs = 200
    small = _edge_constraints(rng, 1, 50)
    tables = [_words(pack_constraints_multi(t), card)
              for t in ([cons, small, cons[::-1]], [small, cons])]
    calls = [(lambda kw: refine.refine_tracks_batched(pts, rows, cov, docs,
                                                      **kw),
              lambda kw: ref.refine_tracks_batched_ref(pts, rows, cov, docs,
                                                       **kw))]
    for s in (0, 2):                     # a shard, and the all-padding one
        calls.append((
            lambda kw, s=s: refine.refine_tracks(pts[s], rows[s], cov, docs,
                                                 **kw),
            lambda kw, s=s: (lambda o: tuple(x[0] for x in o)
                             if isinstance(o, tuple) else o[0])(
                ref.refine_tracks_batched_ref(pts[s:s + 1], rows[s:s + 1],
                                              cov, docs, **kw))))
    for tab in tables:
        calls.append((
            lambda kw, tab=tab: refine.refine_tracks_multi(pts, rows, tab,
                                                           docs, **kw),
            lambda kw, tab=tab: ref.refine_tracks_multi_ref(pts, rows, tab,
                                                            docs, **kw)))
    hits = 0
    for kernel, plain in calls:
        for kw in _REFINE_MODES:
            first, second = kernel(kw), kernel(kw)
            torch.cuda.synchronize()
            want = plain(kw)
            _same(first, want)
            _same(second, first)
            hits += int((want[0] if kw else want).sum())
    assert hits > 0


@pytest.mark.parametrize("kernel", ["flash_attention", "ssm_scan"])
def test_kernels_raise_under_grad(card, kernel):
    """The CUDA kernels have no backward: under grad mode an input that
    requires grad raises instead of silently cutting the gradient; without
    grad mode, or without such an input, the kernel runs."""
    if kernel == "flash_attention":
        x = torch.randn((1, 2, 64, 64), device=card).to(torch.bfloat16)

        def call(a):
            return fa.flash_attention(a, x, x)
    else:
        x = torch.rand((1, 16, 32), device=card)

        def call(a):
            return ssm.ssm_scan(a, x)[0]
    leaf = x.clone().requires_grad_(True)
    before = _build.kernel_launches().get(kernel, 0)
    with pytest.raises(RuntimeError, match="no backward"):
        call(leaf)
    assert _build.kernel_launches().get(kernel, 0) == before
    with torch.no_grad():
        out = call(leaf)
    torch.cuda.synchronize()
    assert not out.requires_grad
    call(x)
    assert _build.kernel_launches()[kernel] == before + 2


def _wrapper_calls(card):
    """One call of every kernel wrapper on small card inputs, by the
    counter it must bump."""
    rng = np.random.default_rng(11)
    words = _words(rng.integers(0, 1 << 32, (3, 2, 70), dtype=np.uint64)
                   .astype(np.uint32), card)
    mask = torch.from_numpy(rng.random(5000) < .3).to(card)
    gid = torch.from_numpy(rng.integers(-1, 40, 3000).astype(np.int32)) \
        .to(card)
    vals = torch.rand(3000, device=card)
    pts, rows, cov, cons = _refine_inputs(rng, [40, 20], card, (30, 30))
    cov_multi = _words(pack_constraints_multi([cons[:1], cons]), card)
    q = torch.randn((1, 4, 64, 64), device=card).to(torch.bfloat16)
    a = torch.rand((1, 16, 32), device=card)
    return {
        "bitmap_intersect_batched": lambda: bitset.bitmap_intersect_batched(
            words),
        "bitmap_intersect": lambda: bitset.bitmap_intersect(words[0]),
        "bitset_binary": lambda: bitset.bitset_binary(words[0, 0],
                                                      words[1, 0]),
        "compact_batched": lambda: compact.compact_batched(mask[None]),
        "compact": lambda: compact.compact(mask),
        "mask_prefix_sum": lambda: compact.mask_prefix_sum(mask),
        "segment_agg": lambda: segment_agg.segment_agg(gid, vals, 40),
        "segment_agg[global]": lambda: segment_agg.segment_agg(gid, vals,
                                                               5000),
        "refine_tracks_batched": lambda: refine.refine_tracks_batched(
            pts, rows, cov, 40),
        "refine_tracks_multi": lambda: refine.refine_tracks_multi(
            pts, rows, cov_multi, 40),
        "refine_tracks": lambda: refine.refine_tracks(pts[0], rows[0], cov,
                                                      40),
        "flash_attention": lambda: fa.flash_attention(q, q, q),
        "ssm_scan": lambda: ssm.ssm_scan(a, a),
    }


def test_launch_counter_equals_wrapper_calls(card):
    """Every wrapper adds one to its own kernel counter a call and touches
    no other counter."""
    for name, call in _wrapper_calls(card).items():
        counter = name.split("[")[0]
        before = _build.kernel_launches()
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        after = _build.kernel_launches()
        grew = {k: n - before.get(k, 0) for k, n in after.items()
                if n != before.get(k, 0)}
        assert grew == {counter: 3}, name


_T = compact.SCAN_TILE


@pytest.mark.parametrize("kind", ["none", "all", "random"])
@pytest.mark.parametrize("s", [1, 3, 128])
@pytest.mark.parametrize("n", [_T - 1, _T, _T + 1, 3 * _T + 1])
def test_compact_batched_kernel_tile_edges(card, n, s, kind):
    """Masks that straddle the scan's tile (``compact.SCAN_TILE`` rows):
    the kernel against the plain version, byte for byte, one launch a
    call."""
    if kind == "none":
        masks = np.zeros((s, n), bool)
    elif kind == "all":
        masks = np.ones((s, n), bool)
    else:                      # a density a shard, one empty, one full
        rng = np.random.default_rng(n + s)
        masks = rng.random((s, n)) < rng.random((s, 1))
        if s > 2:
            masks[1], masks[2] = False, True
    masks = torch.from_numpy(masks).to(card)
    before = _build.kernel_launches().get("compact_batched", 0)
    got = compact.compact_batched(masks)
    torch.cuda.synchronize()
    assert _build.kernel_launches()["compact_batched"] == before + 1
    want = ref.compact_batched_ref(masks)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _one_launch(counter, call):
    """``call()`` once, asserting it added exactly one launch to
    ``counter``; returns its result."""
    before = _build.kernel_launches().get(counter, 0)
    out = call()
    torch.cuda.synchronize()
    assert _build.kernel_launches()[counter] == before + 1
    return out


@pytest.mark.parametrize("n,s", [(17, 5), (4111, 3), (900_001, 2),
                                 (20_003, 8)])
def test_compact_batched_kernel_unaligned_rows(card, n, s):
    """N not a multiple of 16: every shard after the first starts off a
    16-byte boundary, so its rows take the scalar loads."""
    rng = np.random.default_rng(n)
    masks = torch.from_numpy(rng.random((s, n)) < rng.random((s, 1))) \
        .to(card)
    _same(_one_launch("compact_batched",
                      lambda: compact.compact_batched(masks)),
          ref.compact_batched_ref(masks))


@pytest.mark.parametrize("n", [2 * _T - 1, 2 * _T, 2 * _T + 1, 3 * _T + 5])
def test_compact_batched_kernel_more_tiles_than_resident(card, n):
    """600 shards: more tiles than the card holds blocks at once, so tiles
    look back over predecessors that ran in earlier waves of blocks; n
    straddles the tile edges."""
    rng = np.random.default_rng(n)
    masks = torch.from_numpy(rng.random((600, n)) < rng.random((600, 1))) \
        .to(card)
    _same(_one_launch("compact_batched",
                      lambda: compact.compact_batched(masks)),
          ref.compact_batched_ref(masks))


def test_mask_scan_kernel_long_mask(card):
    """One mask of 5,000,003 rows (1,221 tiles, more than the card holds
    at once): ids and exclusive positions against the plain versions."""
    n = 5_000_003
    rng = np.random.default_rng(5)
    mask = torch.from_numpy(rng.random(n) < .2).to(card)
    _same(_one_launch("compact", lambda: compact.compact(mask)),
          ref.compact_ref(mask))
    _same(_one_launch("mask_prefix_sum",
                      lambda: compact.mask_prefix_sum(mask)),
          ref.mask_prefix_sum_ref(mask))


def test_compact_batched_kernel_past_65535_shards(card):
    """70,000 shards of 16 rows: more shards than a grid's y extent; the
    kernel answers, equal to the plain version."""
    rng = np.random.default_rng(70_000)
    masks = torch.from_numpy(rng.random((70_000, 16)) < .4).to(card)
    _same(_one_launch("compact_batched",
                      lambda: compact.compact_batched(masks)),
          ref.compact_batched_ref(masks))


INTERSECT_W = [1, 255, 256, 257, 625, 2048, 28125]


@pytest.mark.parametrize("s", [1, 8, 128])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("w", INTERSECT_W)
def test_bitmap_intersect_kernel_edges(card, w, k, s):
    """Across the block and cluster edges of W, K = 1 and 5, S = 1, 8 and
    128: random and all-ones words (count = 32·W), byte for byte against
    the plain version, one launch a call; at S = 1 the single-stack
    wrapper through the same entry."""
    rng = np.random.default_rng(w * 7 + k * 3 + s)
    words = rng.integers(0, 1 << 32, (s, k, w), dtype=np.uint64) \
        .astype(np.uint32)
    words[:, :, rng.integers(0, w)] |= 0x80000000          # the sign bit
    for stack in (_words(words, card),
                  _words(np.full((s, k, w), 0xFFFFFFFF, np.uint32), card)):
        got = _one_launch("bitmap_intersect_batched",
                          lambda: bitset.bitmap_intersect_batched(stack))
        _same(got, ref.bitmap_intersect_batched_ref(stack))
        if s == 1:
            one = _one_launch("bitmap_intersect",
                              lambda: bitset.bitmap_intersect(stack[0]))
            _same(one, ref.bitmap_intersect_ref(stack[0]))
    assert got[1].tolist() == [32 * w] * s


def test_bitmap_intersect_kernel_unaligned_stack(card):
    """A stack that starts 4 bytes past a 16-byte boundary: the scalar
    loads, equal to the plain version."""
    rng = np.random.default_rng(5)
    flat = _words(rng.integers(0, 1 << 32, 8 * 5 * 1024 + 1,
                               dtype=np.uint64).astype(np.uint32), card)
    stack = flat[1:].view(8, 5, 1024)
    _same(bitset.bitmap_intersect_batched(stack),
          ref.bitmap_intersect_batched_ref(stack))


def test_no_stale_state_across_calls(card):
    """200 calls in a row of both kernels at varying S, W, N and
    densities (freed buffers, status words and epochs reused), each equal
    to the plain version; and two calls on one input give the same
    bits."""
    rng = np.random.default_rng(200)
    for i in range(200):
        s = int(rng.choice([1, 2, 8, 37, 128]))
        w = int(rng.integers(1, 3000))
        k = int(rng.integers(1, 6))
        stack = _words(rng.integers(0, 1 << 32, (s, k, w), dtype=np.uint64)
                       .astype(np.uint32) | rng.integers(
                           0, 2, (s, k, 1)).astype(np.uint32) * 0xFFFFFFFF,
                       card)
        want = ref.bitmap_intersect_batched_ref(stack)
        _same(bitset.bitmap_intersect_batched(stack), want)
        _same(bitset.bitmap_intersect_batched(stack), want)
        n = int(rng.choice([1, 15, 4096, 4097, 20_000, 100_003]))
        masks = torch.from_numpy(rng.random((s, n)) < rng.random((s, 1))) \
            .to(card)
        want = ref.compact_batched_ref(masks)
        _same(compact.compact_batched(masks), want)
        _same(compact.compact_batched(masks), want)
        one = masks[i % s]
        _same(compact.compact(one), ref.compact_ref(one))
        _same(compact.mask_prefix_sum(one), ref.mask_prefix_sum_ref(one))


def test_scan_epoch_wrap_on_card(card):
    """The calls across an epoch wrap (the state zero-filled, the ticket
    restarted) stay equal to the plain version."""
    rng = np.random.default_rng(3)
    masks = torch.from_numpy(rng.random((4, 9000)) < .5).to(card)
    want = ref.compact_batched_ref(masks)
    _same(compact.compact_batched(masks), want)
    st = _build.stream_state("mask_scan", masks.device)
    st.epoch = compact.EPOCH_LIMIT - 3
    for _ in range(5):       # epochs L-2, L-1, then 1, 2, 3 after the wrap
        _same(compact.compact_batched(masks), want)
    assert st.epoch == 3


def test_intersect_state_reset_on_card(card):
    """Shards of several blocks close on their arrival words, and the last
    block of each leaves its word at 0 for the next call."""
    rng = np.random.default_rng(4)
    stack = _words(rng.integers(0, 1 << 32, (6, 3, 5000), dtype=np.uint64)
                   .astype(np.uint32), card)
    _same(bitset.bitmap_intersect_batched(stack),
          ref.bitmap_intersect_batched_ref(stack))
    torch.cuda.synchronize()
    st = _build.stream_state("bitmap_intersect", stack.device)
    assert not bool(st.buf[:6].any())


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


def test_server_on_card_matches_numpy_oracle(card):
    """Coalesced Tesseract queries (unordered, ordered, dwell) through
    ``QueryServer`` on the card: one ``run_wave_fused_multi`` dispatch a
    wave for the whole group, one multi-query refine launch a wave, and
    each query's rows equal to the numpy oracle run alone."""
    from repro_torch.core import Session, fdb
    from repro_torch.serve import QueryServer
    from repro_torch.tess import Tesseract
    w = generate_world(scale=2.0, seed=1)
    cat = Catalog()
    cat.register(build_fdb("Trips", w["trips_schema"], w["trips"],
                           num_shards=10))
    day = 2 * 86400.0
    legs = [(city_region(a), day + h * 3600, day + (h + 8) * 3600)
            for a, h in (("SF", 5), ("Berkeley", 6), ("Fremont", 7),
                         ("SF", 9))]
    flows = [fdb("Trips").tesseract(Tesseract(*legs[0]).also(*legs[1])),
             fdb("Trips").tesseract(Tesseract(*legs[2]).then(*legs[3])),
             fdb("Trips").tesseract(Tesseract(*legs[0]).dwell(300.0)
                                    .also(*legs[2])),
             fdb("Trips").tesseract(Tesseract(*legs[3]))]
    host = Session(catalog=cat, config=ExecConfig(backend=NumpyBackend()))
    srv = QueryServer(catalog=cat, backend=TorchBackend(), cache=False,
                      start=False)
    futs = [srv.submit(f) for f in flows]
    ops.reset_launch_counts()
    _build.reset_kernel_launches()
    srv.run_pending()
    waves = math.ceil(cat.get("Trips").num_shards / 8)
    assert ops.launch_counts() == {"run_wave_fused_multi": waves}
    assert _build.kernel_launches()["refine_tracks_multi"] == waves
    total = 0
    for fut, flow in zip(futs, flows):
        got, want = fut.result(60).to_records(), host.run(flow).to_records()
        assert got == want
        total += len(want)
    assert total > 0
    assert srv.stats()["coalesced_batches"] == 1


@pytest.fixture
def fp32_card(card):
    """The card with TF32 off for every float32 product and convolution."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


FLASH_CASES = [   # (b, hq, hkv, sq, skv, d), options
    ((2, 4, 2, 128, 128, 64), {}),
    ((1, 8, 8, 64, 64, 128), {}),
    ((1, 2, 1, 100, 200, 64), {}),                 # ragged, decode offset
    ((1, 4, 2, 1, 384, 64), {}),                   # single token
    ((2, 15, 5, 300, 300, 64), {}),                # smollm heads
    ((1, 32, 8, 130, 130, 128), {}),               # Jamba heads
    ((1, 2, 1, 256, 256, 64), {"window": 64}),
    ((1, 2, 2, 128, 128, 64), {"softcap": 30.0}),
    ((1, 2, 1, 192, 192, 256), {"window": 50, "softcap": 20.0}),
    ((3, 4, 2, 70, 90, 16), {"window": 7}),
    ((1, 2, 1, 33, 33, 32), {"causal": False}),
    # the tensor-core kernel's tile edges: Sq 1, 63, 64, 65 against Skv =
    # 445 (not a multiple of 64), GQA groups 1, 3 and 4, hd 64 and 128
    ((1, 4, 4, 1, 445, 128), {}),
    ((2, 3, 1, 63, 445, 64), {}),
    ((1, 8, 2, 64, 445, 128), {}),
    ((2, 4, 1, 65, 445, 64), {}),
    ((1, 6, 2, 445, 445, 128), {}),
    ((1, 4, 4, 65, 445, 64), {"causal": False}),
    ((1, 4, 1, 200, 445, 128), {"window": 100}),   # starts mid-tile
    ((1, 6, 2, 130, 445, 64), {"window": 97, "softcap": 30.0}),
    # Whisper's encoder (1500 = 23 × 64 + 28: both the last query tile and
    # the last key tile partial) and cross-attention (Sq ≠ Skv, no mask)
    ((1, 20, 20, 1500, 1500, 64), {"causal": False}),
    ((2, 20, 20, 37, 1500, 64), {"causal": False}),
]


def _flash_kernel(dtype, d):
    """The kernel the wrapper must pick: tensor cores for bf16 at head
    dims 64 and 128, SIMT otherwise."""
    return ("tensor_core" if dtype == torch.bfloat16 and d in (64, 128)
            else "simt")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kw", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(fp32_card, shape, kw, dtype):
    b, hq, hkv, sq, skv, d = shape
    g = torch.Generator(device=fp32_card).manual_seed(sum(shape))
    q = torch.randn((b, hq, sq, d), generator=g, device=fp32_card)
    k = torch.randn((b, hkv, skv, d), generator=g, device=fp32_card)
    v = torch.randn((b, hkv, skv, d), generator=g, device=fp32_card)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    assert fa.kernel_for(dtype, d) == _flash_kernel(dtype, d)
    before = _build.kernel_launches().get("flash_attention", 0)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _build.kernel_launches()["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    # scaled to the output compared: an ulp of the element and of the
    # largest element in bf16, 2^-12 of them in float32
    atol, rtol = ref.flash_tolerance(want)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_fully_masked_rows_are_zero(card, dtype):
    """Sq > Skv: the first Sq - Skv queries see no key.  Both kernels
    (SIMT in float32, tensor cores in bf16) give them 0, as the TPU
    kernel; the plain version the mean of V, as the JAX reference.  The
    other rows agree."""
    assert fa.kernel_for(dtype, 64) == _flash_kernel(dtype, 64)
    g = torch.Generator(device=card).manual_seed(1)
    q, k, v = (torch.randn(s, generator=g, device=card).to(dtype)
               for s in ((1, 2, 80, 64), (1, 1, 50, 64), (1, 1, 50, 64)))
    got = fa.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    assert bool((got[:, :, :30] == 0).all())
    tol = 3e-3 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got[:, :, 30:].float(),
                               want[:, :, 30:].float(), rtol=tol, atol=tol)


def test_flash_attention_kernel_rejects(card):
    q = torch.zeros((1, 2, 8, 48), device=card)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)                         # head dim 48
    q = torch.zeros((1, 2, 8, 64), device=card, dtype=torch.float16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)                         # float16


@pytest.mark.parametrize("b,l,d,with_h0", [(2, 64, 32, False),
                                           (1, 500, 130, True),
                                           (3, 1024, 16, True),
                                           (4, 256, 8192 * 16, True),
                                           (1, 7, 260, False)])
def test_ssm_scan_kernel_matches_plain(card, b, l, d, with_h0):
    g = torch.Generator(device=card).manual_seed(l)
    a = torch.rand((b, l, d), generator=g, device=card) * 0.5 + 0.5
    bx = torch.randn((b, l, d), generator=g, device=card)
    h0 = torch.randn((b, d), generator=g, device=card) if with_h0 else None
    before = _build.kernel_launches().get("ssm_scan", 0)
    h, hT = ssm.ssm_scan(a, bx, h0)
    torch.cuda.synchronize()
    assert _build.kernel_launches()["ssm_scan"] == before + 1
    hr, hTr = ref.ssm_scan_ref(a, bx, h0)
    torch.testing.assert_close(h, hr, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(hT, hTr, rtol=3e-4, atol=3e-4)


def _lm_consistency(arch, dev, s=300):
    """Float32, dropless MoE: decode logits at position s-1 after a
    prefill of s-1 tokens against the prefill's logits over s tokens."""
    from dataclasses import replace
    cfg = replace(get_config(arch).reduced(), act_dtype="float32")
    if cfg.moe_experts:
        cfg = replace(cfg, moe_capacity_factor=float(cfg.moe_experts))
    lm = LM(cfg)
    p = lm.init(seed=0, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, s), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    ops.reset_launch_counts()
    want, _ = lm.prefill(p, toks)
    _, caches = lm.prefill(p, toks[:, :-1])
    got, _ = lm.decode_step(p, toks[:, -1:], caches, s - 1)
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 0.02, err
    assert bool((got.argmax(-1) == want.argmax(-1)).all())
    return ops.launch_counts()


def test_lm_prefill_decode_consistency_on_card(fp32_card):
    with torch.inference_mode():
        lc = _lm_consistency("smollm_360m", fp32_card)
        assert lc == {"flash_attention": 2 * 2}
        lc = _lm_consistency("jamba_v0_1_52b", fp32_card)
        # 14 Mamba layers, 2 chunks of 256 for 300 and for 299 tokens
        assert lc == {"flash_attention": 2 * 2, "ssm_scan": 2 * 14 * 2}


def test_server_on_card(card):
    srv = Server(get_config("jamba_v0_1_52b"), max_batch=4)
    assert srv.params["embed"].is_cuda
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, srv.cfg.vocab_size,
                                    rng.integers(4, 40)).astype(np.int32),
                    max_new=5) for i in range(6)]
    _build.reset_kernel_launches()
    srv.serve(reqs)
    assert all(r.done and len(r.out) == 5 for r in reqs)
    assert _build.kernel_launches() == {"flash_attention": 2 * 2,
                                        "ssm_scan": 2 * 14}


# ------------------------------------- segment_hll, merge_partials, engines

@pytest.mark.parametrize("n,g,m,masked", [(0, 3, 16, 0.0), (50, 7, 16, 0.3),
                                          (20000, 24, 4096, 0.05),
                                          (3000, 600_000, 4096, 0.1)])
def test_segment_hll_on_card_matches_cpu(card, n, g, m, masked):
    """The scatter-max on the card against the same function on the CPU,
    byte for byte (uint8 amax); the last case's composite index G·M
    passes 2³¹."""
    rng = np.random.default_rng(n + g)
    ids = rng.integers(0, g, n)
    if n:
        ids[0] = g - 1
    ids[rng.random(n) < masked] = -1
    regs = rng.integers(0, 40, (n, 1 if g * m > 2 ** 31 else m)) \
        .astype(np.uint8)
    gm = g if regs.shape[1] == m else g * m
    if regs.shape[1] == 1:
        ids = np.where(ids >= 0, ids * m + rng.integers(0, m, n), -1)
    t_ids, t_regs = torch.from_numpy(ids), torch.from_numpy(regs)
    got = ops.segment_hll(t_ids.to(card), t_regs.to(card), gm)
    want = ops.segment_hll(t_ids, t_regs, gm)
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("s,k,g", [(1, 1, 1), (20, 1, 80_000), (4, 3, 17),
                                   (2, 1, 0)])
def test_merge_partials_on_card_matches_cpu(card, s, k, g):
    """The in-order combine on the card against the CPU, bit for bit."""
    rng = np.random.default_rng(s * 10 + g)
    cnt = rng.integers(0, 6, (s, k, g)).astype(np.int64)
    sm = rng.normal(0.0, 1e3, (s, k, g)) * (cnt > 0)
    s2 = rng.random((s, k, g)) * 1e6 * (cnt > 0)
    mn = np.where(cnt > 0, rng.normal(0, 50, (s, k, g)), np.inf)
    mx = np.where(cnt > 0, mn + 1.0, -np.inf)
    msk = cnt[:, 0, :] > 0
    host = [torch.from_numpy(a) for a in (cnt, sm, s2, mn, mx, msk)]
    got = ops.merge_partials(*(t.to(card) for t in host))
    want = ops.merge_partials(*host)
    for a, b in zip(got, want):
        assert a.device.type == "cuda"
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


def _engine_world():
    w = generate_world(scale=2.0, seed=1)
    cat = Catalog(server_slots=16)
    cat.register(build_fdb("Trips", w["trips_schema"], w["trips"],
                           num_shards=10))
    cat.register(build_fdb("SpeedObservations", w["observations_schema"],
                           w["observations"], num_shards=20))
    return cat


def _close(got, want):
    assert len(got) == len(want) > 0
    key = lambda r: tuple(v for v in r.values() if isinstance(v, int))
    for g, r in zip(sorted(got, key=key), sorted(want, key=key)):
        assert g.keys() == r.keys()
        for k, v in r.items():
            if isinstance(v, float):
                assert abs(g[k] - v) <= 1e-6 * abs(v) + 1e-9
            else:
                assert g[k] == v


def test_partitions_on_one_card(card):
    """P = 4 on one card: selections byte-identical to P = 1 there,
    aggregates float64-identical, Σ_p ⌈shards_p/8⌉ fused dispatches and
    one merge combine; aggregates within float32 staging of the oracle."""
    from repro_torch.core import BETWEEN, P, fdb, group, proto
    from repro_torch.core.planner import partition_shards
    from repro_torch.exec import AdHocEngine
    cat = _engine_world()
    flows = {
        "agg": fdb("SpeedObservations").find(BETWEEN(P.hour, 7, 10))
        .aggregate(group(P.road_id).count("n").avg(a=P.speed)
                   .std_dev(sd=P.speed)),
        "select": fdb("SpeedObservations").find(BETWEEN(P.hour, 8, 9))
        .map(lambda p: proto(road_id=p.road_id, speed=p.speed))}
    be = TorchBackend()
    oracle = AdHocEngine(cat, backend=NumpyBackend())
    for name, flow in flows.items():
        base = AdHocEngine(cat, backend=be, partitions=1).collect(flow)
        ops.reset_launch_counts()
        got = AdHocEngine(cat, backend=be, partitions=4).collect(flow)
        pp = partition_shards(got.plan.shard_ids, 4)
        want = {"run_wave_fused": pp.wave_dispatches(8)}
        if name == "agg":
            want["merge_partials"] = 1
        assert ops.launch_counts() == want
        assert got.batch.paths() == base.batch.paths()
        for p in base.batch.paths():
            assert got.batch[p].values.tobytes() == \
                base.batch[p].values.tobytes(), (name, p)
        _close(got.to_records(), oracle.collect(flow).to_records())


def test_flume_speculation_on_card(card, tmp_path):
    """Flume on the card with a straggling shard: speculative backups run
    the same shard task on a second thread while the other tasks run
    theirs (concurrent launches through the kept scan and intersect
    state); records match the oracle, and a re-run of the job launches
    nothing."""
    from repro_torch.core import P, fdb, group
    from repro_torch.exec import AdHocEngine, FaultPlan, FlumeEngine
    from repro_torch.tess import Tesseract
    cat = _engine_world()
    day = 2 * 86400.0
    flow = fdb("Trips").tesseract(
        Tesseract(city_region("SF"), day + 6 * 3600, day + 12 * 3600)
        .also(city_region("Berkeley"), day + 6 * 3600, day + 14 * 3600)
    ).aggregate(group(P.day).count("n").avg(d=P.duration_s))
    want = AdHocEngine(cat, backend=NumpyBackend()).collect(flow)
    fl = FlumeEngine(cat, ckpt_dir=str(tmp_path), backend=TorchBackend(),
                     speculation=True, speculation_factor=2.0)
    res = fl.collect(flow, fault_plan=FaultPlan(
        straggle={("server", 0): 0.5, ("server", 3): 0.5}))
    assert fl.stats["speculative_launched"] >= 1
    _close(res.to_records(), want.to_records())
    ops.reset_launch_counts()
    _build.reset_kernel_launches()
    fl2 = FlumeEngine(cat, ckpt_dir=str(tmp_path), backend=TorchBackend())
    again = fl2.collect(flow, job_id=fl._job_id(flow))
    assert again.to_records() == res.to_records()
    assert ops.launch_counts() == {} and _build.kernel_launches() == {}


# ------------------------------------------------------ the training paths
#
# Card against CPU, TF32 off: float32 products and sums in another order
# (cuBLAS against the CPU's BLAS): losses rtol 1e-4, grad norm 1e-3,
# gradients 1e-4 of each leaf's largest, parameters within AdamW's reach
# (below); the Viterbi path is equal.

def test_mlp_fit_on_card_matches_cpu(fp32_card):
    """The same initial params and index stream (both drawn on the CPU
    from the seed) give the same loss curve and predictions."""
    from repro_torch.ml.integration import MLPRegressor
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5000, 3)) * [1.0, 4.0, 0.5]
    y = x @ np.array([2.0, -0.5, 3.0]) + 10.0 + rng.normal(size=5000)
    models = {}
    for dev in ("cuda", "cpu"):
        m = MLPRegressor(3, hidden=64, depth=2, seed=0, device=dev)
        models[dev] = (m, m.train(x, y, steps=200, lr=2e-3, batch=1024))
    (gpu, lg), (cpu, lc) = models["cuda"], models["cpu"]
    assert gpu.params["layers"][0]["w"].is_cuda
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    cols = {"a": x[:100, 0], "b": x[:100, 1], "c": x[:100, 2]}
    np.testing.assert_allclose(
        gpu.as_column_model(["a", "b", "c"]).apply_columns(cols),
        cpu.as_column_model(["a", "b", "c"]).apply_columns(cols),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["smollm_360m", "jamba_v0_1_52b"])
def test_train_step_on_card_matches_cpu(fp32_card, arch):
    """Three reduced train steps (float32 activations) from the same
    params on the card and on the CPU, launching no kernel."""
    from dataclasses import replace
    from repro_torch.ml.model import ModelBundle, TrainConfig
    cfg = replace(get_config(arch).reduced(), act_dtype="float32")
    tc = TrainConfig(warmup=2, total_steps=10, loss_chunk=16, remat="full")
    p0 = ModelBundle(cfg, train_cfg=tc, device="cuda").init_params(0)
    runs = {}
    for dev in ("cuda", "cpu"):
        mb = ModelBundle(cfg, train_cfg=tc, device=dev)
        p = _to(p0, dev)
        opt = mb.init_opt_state(p)
        step = mb.make_train_step()
        metrics, kept = [], []
        before = dict(_build.kernel_launches())
        for i in range(3):
            p, opt, m = step(p, opt, _batch_on(cfg, dev, seed=i))
            kept.append(p)
            metrics.append({k: float(v) for k, v in m.items()})
        assert _build.kernel_launches() == before
        runs[dev] = (p, metrics, kept[0])
    for g, c in zip(runs["cuda"][1], runs["cpu"][1]):
        np.testing.assert_allclose(g["loss"], c["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["grad_norm"], c["grad_norm"], rtol=1e-3)
        assert g["lr"] == pytest.approx(c["lr"], rel=1e-6)
    # the gradients of the first step, each leaf within 1e-4 of its
    # largest element; 2^-8 where the Mamba path stages its scan inputs in
    # bf16 (a float32 ulp upstream can flip one bf16 rounding)
    rel = 2.0 ** -8 if "mamba" in cfg.block_pattern else 1e-4
    grads = {dev: ModelBundle(cfg, train_cfg=tc, device=dev).loss_and_grads(
        _to(p0, dev), _batch_on(cfg, dev))[3] for dev in ("cuda", "cpu")}
    for k, (a, b) in _pairs(grads["cuda"], grads["cpu"]):
        scale = float(b.abs().max()) + 1e-30
        np.testing.assert_allclose(a.cpu().numpy() / scale,
                                   b.numpy() / scale, atol=rel, err_msg=k)
    # AdamW's first update is g / (|g| + eps) ≈ ±1 whatever |g|: where the
    # CPU's clipped gradient is signal (4 × the gradient bound above, and
    # 100 × eps), its sign is fixed by the check above and the first step
    # must move the param as on the CPU, within 1e-5
    clip = min(1.0, tc.clip_norm / runs["cpu"][1][0]["grad_norm"])
    held = 0
    for (k, (a, b)), (_, (g, _)) in zip(
            _pairs(runs["cuda"][2], runs["cpu"][2]),
            _pairs(grads["cpu"], grads["cpu"])):
        mag = g.abs()
        sig = (mag >= 4 * rel * mag.max()) & (mag * clip >= 1e-6)
        held += int(sig.sum())
        np.testing.assert_allclose(a.cpu()[sig].numpy(), b[sig].numpy(),
                                   atol=1e-5, err_msg=k)
    assert held > 0
    # one whose gradient is float32 noise may go either way, ±lr a step:
    # the rest are held within that reach, 2·Σ lr
    reach = 2 * sum(m["lr"] for m in runs["cpu"][1])
    for k, (a, b) in _pairs(runs["cuda"][0], runs["cpu"][0]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=reach,
                                   err_msg=k)


def _batch_on(cfg, dev, seed=0):
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32))
                           .astype(np.int32)).to(dev)
    return {"tokens": tok, "labels": tok.roll(-1, 1)}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _pairs(a, b, prefix=""):
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], (a, b)


@pytest.mark.parametrize("arch", ["xlstm_1_3b", "whisper_large_v3"])
def test_whisper_and_xlstm_on_card_match_cpu(fp32_card, arch):
    """Reduced, float32 activations, the same params on both: one prefill
    (Whisper's with 150 frame embeddings: its encoder, cross and decoder
    attention through flash_attention, 2 + 2 × 2 launches; xLSTM's
    launching nothing), two decode steps fed the CPU's greedy tokens and
    one train step, on the card against the CPU.  Prefill logits within
    1e-4 of max |logit|; decode reads bf16 caches, where a float32 ulp can
    flip a rounding: 2e-3; the train step's loss 1e-4 and grad norm 1e-3,
    as the other train checks, and every gradient leaf (the sLSTM's
    recurrent ``r*``, the mLSTM gates, the cross-attention's ``wk``/``wv``
    among them) within a share of its largest element: 1e-4 for Whisper,
    as ``test_train_step_on_card_matches_cpu`` holds the attention models;
    1e-3 for xLSTM, whose exponential gates and running maxima make its
    gradients ~70× as sensitive to float32 rounding (``tools/grad_noise.py``:
    one ulp of noise on every param moves them by up to 1.0e-4 of a leaf's
    largest on the CPU, Whisper's by 3.0e-6, SmolLM's by 1.5e-6)."""
    from dataclasses import replace
    from repro_torch.ml.model import ModelBundle, TrainConfig
    cfg = replace(get_config(arch).reduced(), act_dtype="float32")
    p0 = LM(cfg).init(0, "cpu")
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24))
                           .astype(np.int32))
    batch = {"tokens": tok, "labels": tok.roll(-1, 1)}
    if cfg.encoder_layers:
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(2, 150, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    kw = {"frames": batch["frames"]} if "frames" in batch else {}
    runs, fed = {}, []
    for dev in ("cpu", "cuda"):
        lm, p = LM(cfg), _to(p0, dev)
        _build.reset_kernel_launches()
        with torch.inference_mode():
            logits, caches = lm.prefill(p, tok.to(dev), **_to(kw, dev))
            out = [logits.cpu()]
            for t in range(2):
                if dev == "cpu":
                    fed.append(torch.argmax(out[-1], dim=-1).to(torch.int32))
                logits, caches = lm.decode_step(p, fed[t].to(dev), caches,
                                                24 + t)
                out.append(logits.cpu())
        runs[dev] = out
    want = {"flash_attention": 2 + 2 * 2} if kw else {}
    assert {k: n for k, n in _build.kernel_launches().items() if n} == want
    for i, (g, c) in enumerate(zip(runs["cuda"], runs["cpu"])):
        err = float((g - c).abs().max() / c.abs().max())
        assert err < (1e-4 if i == 0 else 2e-3), (i, err)
    tc = TrainConfig(warmup=2, total_steps=10, loss_chunk=16, remat="full")
    metrics = {}
    for dev in ("cuda", "cpu"):
        mb = ModelBundle(cfg, train_cfg=tc, device=dev)
        p = _to(p0, dev)
        before = dict(_build.kernel_launches())
        _, _, m = mb.make_train_step()(p, mb.init_opt_state(p),
                                       _to(batch, dev))
        assert _build.kernel_launches() == before
        metrics[dev] = {k: float(v) for k, v in m.items()}
    np.testing.assert_allclose(metrics["cuda"]["loss"],
                               metrics["cpu"]["loss"], rtol=1e-4)
    np.testing.assert_allclose(metrics["cuda"]["grad_norm"],
                               metrics["cpu"]["grad_norm"], rtol=1e-3)
    rel = 1e-4 if cfg.encoder_layers else 1e-3
    grads = {dev: ModelBundle(cfg, train_cfg=tc, device=dev).loss_and_grads(
        _to(p0, dev), _to(batch, dev))[3] for dev in ("cuda", "cpu")}
    held, worst = [], (0.0, "")
    for k, (a, b) in _pairs(grads["cuda"], grads["cpu"]):
        scale = float(b.abs().max()) + 1e-30
        np.testing.assert_allclose(a.cpu().numpy() / scale,
                                   b.numpy() / scale, atol=rel, err_msg=k)
        held.append(k)
        worst = max(worst, (float((a.cpu() - b).abs().max()) / scale, k))
    print(f"{arch}: gradients card vs CPU, worst leaf {worst}")
    for part in (("cell/ri", "cell/wi") if not cfg.encoder_layers
                 else ("xattn/wk", "xattn/wv", "enc_blocks")):
        assert any(part in k for k in held), (part, held)


def test_snap_path_on_card_equals_cpu(card):
    from repro_torch.geo.denoise import snap_path
    rng = np.random.default_rng(4)
    s, t = 400, 300
    ax, ay = rng.uniform(0, 40_000, s), rng.uniform(0, 40_000, s)
    ang = rng.uniform(0, 2 * np.pi, s)
    bx, by = ax + 900 * np.cos(ang), ay + 900 * np.sin(ang)
    pop = rng.integers(0, 5, s).astype(np.float64)
    walk = np.cumsum(rng.normal(0, 300, (t, 2)), axis=0) + 20_000
    got = snap_path(walk[:, 0], walk[:, 1], ax, ay, bx, by, pop, 0.05)
    want = snap_path(walk[:, 0], walk[:, 1], ax, ay, bx, by, pop, 0.05,
                     device="cpu")
    assert np.array_equal(got, want)


def test_lm_kernel_impl_raises_under_grad_on_card(card):
    """``LM(impl="kernel")`` reaches the CUDA flash_attention / ssm_scan,
    which have no backward: a forward whose params require grad raises;
    ``impl="reference"`` differentiates on the card and launches nothing."""
    cfg = get_config("jamba_v0_1_52b").reduced()
    live = LM(cfg).init(0, "cuda", dtype=torch.float32)
    for _, (leaf, _) in _pairs(live, live):
        leaf.requires_grad_(True)
    tok = torch.randint(0, cfg.vocab_size, (2, 16), device=card)
    with pytest.raises(RuntimeError, match="no backward"):
        LM(cfg, impl="kernel").apply(live, tok)
    before = dict(_build.kernel_launches())
    logits, _ = LM(cfg, impl="reference").apply(live, tok)
    logits.float().square().mean().backward()
    assert live["embed"].grad is not None
    assert _build.kernel_launches() == before


# ------------------------------------------ partitions on their own cards
#
# These need two cards or more (a host with four runs them all); with one
# they skip.  Partition p of P runs on card p mod D of ``make_exec_mesh(P)``.

@pytest.fixture
def cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs two CUDA devices or more, {n} visible: "
                    "partitions on their own cards")
    return [torch.device("cuda", i) for i in range(n)]


def _per_card(parts, n_cards, wave=8):
    """Expected waves a card: partition p's ⌈shards_p/wave⌉ on card
    p mod D, D = min(P, n_cards)."""
    d = min(len(parts), n_cards)
    out = [0] * n_cards
    for p, part in enumerate(parts):
        out[p % d] += math.ceil(len(part) / wave)
    return out


def _multicard_world():
    """The scale-2 world, with SpeedObservations also at 64 shards so that
    each of 4 partitions runs two waves of 8."""
    w = generate_world(scale=2.0, seed=1)
    cat = _engine_world()
    cat.register(build_fdb("Obs64", w["observations_schema"],
                           w["observations"], num_shards=64))
    return cat


def _multicard_flows():
    from repro_torch.core import BETWEEN, P, fdb, group, proto
    from repro_torch.tess import Tesseract
    day = 2 * 86400.0
    sf = Tesseract(city_region("SF"), day + 6 * 3600, day + 12 * 3600)
    bk = (city_region("Berkeley"), day + 6 * 3600, day + 14 * 3600)
    return {
        "Q7-agg": (fdb("Trips").tesseract(sf.also(*bk)).aggregate(
            group(P.day).count("n").avg(d=P.duration_s)
            .std_dev(sd=P.duration_s)), True, True),
        "Q1": (fdb("Obs64").find(BETWEEN(P.hour, 7, 10)).aggregate(
            group(P.road_id).count("n").avg(a=P.speed)
            .std_dev(sd=P.speed)), False, True),
        "Q11": (fdb("Trips").tesseract(sf.dwell(300.0).also(*bk))
                .map(lambda p: proto(id=p.id)), True, False)}


def _same_bytes(got, base):
    assert got.batch.paths() == base.batch.paths()
    assert got.batch.n == base.batch.n
    for p in base.batch.paths():
        a, b = got.batch[p].values, base.batch[p].values
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), p


@pytest.mark.parametrize("kernel", ["bitset", "compact", "segment_agg",
                                    "refine", "refine_multi",
                                    "bitmap_intersect", "mask_scan"])
def test_kernels_on_every_card_match_card_0(cards, kernel):
    """Each main-path kernel launched on every card (from a thread whose
    current card is 0, so the launch switches, and from inside each
    card) gives card 0's bytes — the per-device state in the sources
    (raised shared-memory caps, occupancy, kept scan and intersect
    state) is right on every card — and counts on that card only."""
    rng = np.random.default_rng(3)
    if kernel == "bitset":
        host = [rng.integers(0, 1 << 32, (9, 5, 2000), dtype=np.uint64)
                .astype(np.uint32)]

        def run(dev):
            return bitset.bitmap_intersect_batched(_words(host[0], dev))
    elif kernel == "compact":
        host = [rng.random((8, 20_000)) < .3]

        def run(dev):
            return compact.compact_batched(torch.from_numpy(host[0]).to(dev))
    elif kernel == "segment_agg":
        host = []
        for groups in (56, 77_888):         # the shared and global branches
            host.append((np.where(rng.random(160_000) < .3,
                                  rng.integers(0, groups, 160_000), -1)
                         .astype(np.int32),
                         rng.uniform(1, 100, 160_000).astype(np.float32),
                         groups))

        def run(dev):
            out = []
            for gid, vals, groups in host:
                out.extend(segment_agg.segment_agg(
                    torch.from_numpy(gid).to(dev),
                    torch.from_numpy(vals).to(dev), groups))
            return out
    elif kernel in ("refine", "refine_multi"):
        seed = int(rng.integers(1 << 30))

        def run(dev):
            r = np.random.default_rng(seed)
            out = []
            if kernel == "refine":
                # a table in shared memory, and one past it (5000 ranges)
                for ranges in ((150, 150), (150, 40, 5000)):
                    pts, rows, cov, _ = _refine_inputs(
                        r, [300, 120, 0, 33], dev, ranges)
                    for kw in ({}, {"with_first_hits": True},
                               {"with_analytics": True}):
                        out.extend(_as_tuple(refine.refine_tracks_batched(
                            pts, rows, cov, 300, **kw)))
                    out.extend(refine.refine_tracks(
                        pts[0], rows[0], cov, 300, with_analytics=True))
            else:
                pts, rows, _, cons = _refine_inputs(
                    r, [300, 120, 0, 33], dev, (150, 40, 5000))
                multi = _words(pack_constraints_multi(
                    [cons[:1], cons[:2], cons]), dev)
                for kw in ({}, {"with_first_hits": True},
                           {"with_analytics": True}):
                    out.extend(_as_tuple(refine.refine_tracks_multi(
                        pts, rows, multi, 300, **kw)))
            return out
    elif kernel == "bitmap_intersect":
        host = [rng.integers(0, 1 << 32, (4, 100_003), dtype=np.uint64)
                .astype(np.uint32)]

        def run(dev):
            return bitset.bitmap_intersect(_words(host[0], dev))
    else:
        host = [rng.random(900_001) < .01]

        def run(dev):
            m = torch.from_numpy(host[0]).to(dev)
            return (*compact.compact(m), *compact.mask_prefix_sum(m))

    def to_host(outs):
        torch.cuda.synchronize()
        return [t.cpu() for t in _as_tuple(outs)]

    want = to_host(run(cards[0]))
    for dev in cards[1:]:
        for inside in (False, True):
            _build.reset_kernel_launches()
            with (torch.cuda.device(dev) if inside
                  else contextlib.nullcontext()):
                got = to_host(run(dev))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                if g.dtype == torch.float64:   # float64 atomics: any order
                    torch.testing.assert_close(g, w, rtol=1e-12, atol=0)
                else:
                    assert torch.equal(g, w)
            launched = _build.kernel_launches()
            assert launched and launched == _build.kernel_launches(dev)
            assert _build.kernel_launches(cards[0]) == {}


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


@pytest.mark.parametrize("query", ["Q7-agg", "Q1", "Q11"])
def test_partitions_across_cards_byte_identical(cards, query):
    """P = 2 and 4 across the cards: selections byte-identical to P = 1
    on one card and aggregates float64-identical, Σ_p ⌈shards_p/8⌉ fused
    dispatches plus one merge for an aggregate, each partition's kernels
    counted on card p mod D, results close to the numpy oracle; a warm
    repeat copies no buffer and builds no stack on any card."""
    from repro_torch.core.planner import partition_shards
    from repro_torch.exec import AdHocEngine
    cat = _multicard_world()
    flow, has_refine, has_agg = _multicard_flows()[query]
    be = TorchBackend()
    base = AdHocEngine(cat, backend=be, partitions=1).collect(flow)
    _close(base.to_records(),
           AdHocEngine(cat, backend=NumpyBackend()).collect(flow)
           .to_records())
    for parts in (2, 4):
        eng = AdHocEngine(cat, backend=be, partitions=parts)
        for run in ("cold", "warm"):
            stats = {d: c.stats() for d, c in be.device_caches().items()}
            ops.reset_launch_counts()
            _build.reset_kernel_launches()
            got = eng.collect(flow)
            pp = partition_shards(got.plan.shard_ids, parts)
            want = {"run_wave_fused": pp.wave_dispatches(8)}
            if has_agg:
                want["merge_partials"] = 1
            assert ops.launch_counts() == want
            _same_bytes(got, base)
            per_card = _per_card(pp.parts, len(cards))
            for dev, waves in zip(cards, per_card):
                kc = _build.kernel_launches(dev)
                assert kc.get("bitmap_intersect_batched", 0) == waves
                assert kc.get("compact_batched", 0) == waves
                if has_refine:
                    assert kc.get("refine_tracks_batched", 0) == waves
            if run == "warm":
                for dev, cache in be.device_caches().items():
                    now = cache.stats()
                    for k in ("buffers", "keyed", "misses"):
                        assert now[k] == stats[dev][k], (dev, k)


def test_default_partitions_use_every_card(cards, monkeypatch):
    """C10: with no partition count given, a query on a host with D
    cards runs D partitions, one a card, byte-identical to P = 1."""
    from repro_torch.core.planner import PARTITIONS_ENV, partition_shards
    from repro_torch.exec import AdHocEngine
    monkeypatch.delenv(PARTITIONS_ENV, raising=False)
    cat = _multicard_world()
    flow = _multicard_flows()["Q1"][0]
    be = TorchBackend()
    base = AdHocEngine(cat, backend=be, partitions=1).collect(flow)
    ops.reset_launch_counts()
    _build.reset_kernel_launches()
    got = AdHocEngine(cat, backend=be).collect(flow)
    pp = partition_shards(got.plan.shard_ids, len(cards))
    assert pp.num_partitions == len(cards)
    assert ops.launch_counts() == {
        "run_wave_fused": pp.wave_dispatches(8), "merge_partials": 1}
    for dev, waves in zip(cards, _per_card(pp.parts, len(cards))):
        assert waves > 0
        assert _build.kernel_launches(dev).get("compact_batched") == waves
    _same_bytes(got, base)


def test_failing_partition_reroutes_across_cards(cards):
    """Q7-agg at P = 4 with partition 1 failing once: its shards go to
    the survivors' cards, the result is byte-identical to P = 1, and
    the rerouted plan's waves land on their partitions' cards."""
    from repro_torch.core.planner import PartitionPlan, partition_shards
    from repro_torch.exec import AdHocEngine, FaultPlan
    from repro_torch.launch.elastic import reroute_partitions
    cat = _multicard_world()
    flow = _multicard_flows()["Q7-agg"][0]
    be = TorchBackend()
    base = AdHocEngine(cat, backend=be, partitions=1).collect(flow)
    ops.reset_launch_counts()
    _build.reset_kernel_launches()
    got = AdHocEngine(cat, backend=be, partitions=4).collect(
        flow, fault_plan=FaultPlan(fail_once={("partition", 1)}))
    rerouted = PartitionPlan(reroute_partitions(
        partition_shards(got.plan.shard_ids, 4).parts, [1]))
    assert got.profile.retries == 1 and got.coverage == 1.0
    assert ops.launch_counts() == {
        "run_wave_fused": rerouted.wave_dispatches(8), "merge_partials": 1}
    for dev, waves in zip(cards, _per_card(rerouted.parts, len(cards))):
        assert _build.kernel_launches(dev).get("refine_tracks_batched",
                                               0) == waves
    _same_bytes(got, base)


def test_server_batch_across_cards(cards):
    """A coalesced Tesseract batch through ``QueryServer`` at P = 4: one
    ``run_wave_fused_multi`` a partition's wave, launched on its card;
    each query's rows equal to the server's own at P = 1."""
    from repro_torch.core.planner import partition_shards
    from repro_torch.exec import AdHocEngine
    from repro_torch.core import fdb
    from repro_torch.serve import QueryServer
    from repro_torch.tess import Tesseract
    cat = _multicard_world()
    day = 2 * 86400.0
    flows = [fdb("Trips").tesseract(
        Tesseract(city_region(a), day + h * 3600, day + (h + 8) * 3600)
        .also(city_region(b), day + h * 3600, day + (h + 9) * 3600))
        for a, b, h in (("SF", "Berkeley", 5), ("Berkeley", "SF", 6),
                        ("Fremont", "SF", 7), ("SF", "Fremont", 8))]
    be = TorchBackend()

    def batch(parts):
        srv = QueryServer(AdHocEngine(cat, backend=be, partitions=parts),
                          cache=False, start=False)
        futs = [srv.submit(f) for f in flows]
        ops.reset_launch_counts()
        _build.reset_kernel_launches()
        srv.run_pending()
        assert srv.stats()["coalesced_batches"] == 1
        return [f.result(60) for f in futs]

    one = batch(1)
    got = batch(4)
    pp = partition_shards(got[0].plan.shard_ids, 4)
    assert ops.launch_counts() == {
        "run_wave_fused_multi": pp.wave_dispatches(8)}
    for dev, waves in zip(cards, _per_card(pp.parts, len(cards))):
        assert _build.kernel_launches(dev).get("refine_tracks_multi",
                                               0) == waves
    assert sum(r.batch.n for r in one) > 0
    for g, w in zip(got, one):
        _same_bytes(g, w)


def test_wrappers_refuse_tensors_of_two_cards(cards):
    """A kernel handed tensors of two cards raises, in the wrapper's own
    check or in the launch path's, and launches nothing."""
    a, b = cards[0], cards[1]
    gid = torch.zeros(64, dtype=torch.int32, device=a)
    _build.reset_kernel_launches()
    with pytest.raises(ValueError, match="different devices"):
        segment_agg.segment_agg(gid, torch.ones(64, device=b), 3)
    with pytest.raises(ValueError, match="different devices"):
        ssm.ssm_scan(torch.ones(1, 4, 8, device=a),
                     torch.ones(1, 4, 8, device=b))
    pts, rows, cov, _ = _refine_inputs(np.random.default_rng(1), [40], a)
    with pytest.raises(ValueError):
        refine.refine_tracks_batched(pts, rows, cov.to(b), 40)
    x = torch.zeros(8, dtype=torch.int32, device=a)
    with pytest.raises(ValueError, match="more than one device") as err:
        _build.launch("bitset_binary", "repro_bitset_binary", a, x,
                      x.to(b), torch.empty_like(x), 8, 0)
    assert str(a) in str(err.value) and str(b) in str(err.value)
    torch.cuda.synchronize()
    assert _build.kernel_launches() == {}


# ------------------------------------------------ the ML meshes on the cards
#
# ``tests/_torch_mesh_worker.py`` on NCCL, one process a card (four on a
# host with four, else two): two reduced-Qwen train steps on each mesh
# against the one-device step on the rank's card, ``compressed_psum``
# over the ranks and over the data dim, and a train state saved on the
# mesh with a model axis restored onto data only.  The bounds are
# ``tests/test_torch_mesh.py``'s (phase 3g's).

MESH_LOSS_RTOL, MESH_GNORM_RTOL, MESH_GRAD_REL = 1e-4, 1e-3, 2.0 ** -8
MESH_PARAM_ATOL, MESH_PSUM_RTOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    import json
    import os
    import subprocess
    import sys
    import time
    from pathlib import Path
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs two CUDA devices or more, {n} visible: a "
                    "device mesh")
    world = 4 if n >= 4 else 2
    tmp = tmp_path_factory.mktemp("mesh_cuda")
    worker = Path(__file__).resolve().parent / "_torch_mesh_worker.py"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(world),
         str(tmp / "rendezvous"), str(tmp), "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + 600
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    codes = [p.returncode for p in procs]
    if any(codes):
        pytest.fail(f"mesh ranks exited {codes}:\n" + "\n".join(
            f"--- rank {r}\n{log[-3000:]}" for r, log in enumerate(logs)))
    with open(tmp / "results.json") as fh:
        return world, json.load(fh)


def test_mesh_steps_on_the_cards(mesh_ranks):
    world, res = mesh_ranks
    want = ({"data4", "2x2", "zero1", "fsdp", "fsdp_2x2",
             "seq_parallel_off", "compress_grads"} if world == 4
            else {"data2", "model2"})
    assert set(res["steps"]) == want
    for name, row in res["steps"].items():
        for a, b in zip(row["mesh"], row["one"]):
            assert abs(a["loss"] - b["loss"]) <= \
                MESH_LOSS_RTOL * abs(b["loss"]), name
            assert abs(a["grad_norm"] - b["grad_norm"]) <= \
                MESH_GNORM_RTOL * b["grad_norm"], name
        assert row["grad_max_rel"] <= MESH_GRAD_REL, name
        assert row["signal_params"] > 0, name
        assert row["signal_max_abs"] <= MESH_PARAM_ATOL, name
        assert row["last_param_max_abs"] <= row["reach"], name
        assert row["params_placed"], name


def test_mesh_compressed_psum_on_nccl(mesh_ranks):
    """The int8 mean over NCCL equals the numpy mean of the ranks'
    dequantized payloads (per-tensor scale max|x|/127, round half to
    even, clip ±127)."""
    world, res = mesh_ranks
    for name, row in res["psum"].items():
        assert row["ranks"] == (list(range(world)) if name == "world"
                                else [0, 2] if world == 4 else [0, 1])
        deq = []
        for r in row["ranks"]:
            x = np.random.default_rng(100 + r).normal(size=(8, 16)) \
                .astype(np.float32)
            scale = np.maximum(np.abs(x).max(), np.float32(1e-12)) \
                / np.float32(127.0)
            q = np.clip(np.round(x / scale), -127, 127)
            deq.append(q.astype(np.float32) * scale)
        want = np.mean(np.stack(deq), axis=0, dtype=np.float32)
        np.testing.assert_allclose(np.asarray(row["got"], np.float32), want,
                                   rtol=MESH_PSUM_RTOL,
                                   atol=MESH_PSUM_RTOL * np.abs(want).max())


def test_mesh_elastic_restore_across_cards(mesh_ranks):
    _, res = mesh_ranks
    row = res["elastic"]
    assert row["bit_equal"] and row["function_bit_equal"]
    assert row["params_placed"] and row["moments_placed"]
    assert row["step"] == 3
