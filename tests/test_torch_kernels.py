"""The port's kernels held against the JAX package's Pallas kernels.

On the CPU every wrapper in ``repro_torch.kernels`` runs its plain PyTorch
version; these tests hold those versions to the JAX kernels run in
interpret mode and to ``repro/kernels/ref.py`` on the same inputs, made
with numpy from a seed.  Selections and integer tables must be equal;
float32 sums must agree with the interpret kernel to rtol 1e-6 (it sums
in float32 on the MXU's one-hot formulation, the port in float64).
The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                            # noqa: E402
import jax.experimental                               # noqa: E402
import jax.numpy as jnp                               # noqa: E402

from repro.exec.backend import NumpyBackend as JNumpyBackend  # noqa: E402
from repro.exec.refine import (f64_from_sort_key, f64_sort_key,  # noqa: E402
                               pack_constraints, pack_constraints_multi,
                               pack_track_points, refine_tracks_host)
from repro.fdb.index import bitmap_from_ids, mask_from_bitmap  # noqa: E402
from repro.geo import mercator as M                   # noqa: E402
from repro.geo.areatree import AreaTree               # noqa: E402
from repro.kernels import bitset as jbitset           # noqa: E402
from repro.kernels import compact as jcompact         # noqa: E402
from repro.kernels import fused as jfused             # noqa: E402
from repro.kernels import ref as jref                 # noqa: E402
from repro.kernels import refine as jrefine           # noqa: E402
from repro.kernels import segment_agg as jseg         # noqa: E402

from repro_torch.kernels import (_build, bitset, compact,  # noqa: E402
                                 fused, ops, ref, refine, segment_agg)


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


def _edge_masks(s, n, kind):
    """[s, n] masks: all False, all True, or random at a density drawn per
    shard (an empty shard and a full one among them when s > 2)."""
    if kind == "none":
        return np.zeros((s, n), bool)
    if kind == "all":
        return np.ones((s, n), bool)
    rng = np.random.default_rng(n + s)
    masks = rng.random((s, n)) < rng.random((s, 1))
    if s > 2:
        masks[1], masks[2] = False, True
    return masks


@pytest.mark.parametrize("kind", ["none", "all", "random"])
@pytest.mark.parametrize("s", [1, 3, 128])
@pytest.mark.parametrize("n", [4095, 4096, 4097, 12289])
def test_compact_batched_tile_edges(n, s, kind):
    """Masks that straddle the CUDA kernel's 4096-row scan tile: the plain
    version against the TPU kernel in interpret mode, byte for byte."""
    masks = _edge_masks(s, n, kind)
    idx, cnt = compact.compact_batched(torch.from_numpy(masks))
    jidx, jcnt = jcompact.compact_batched(jnp.asarray(masks), interpret=True)
    assert idx.dtype == cnt.dtype == torch.int32
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(cnt.numpy(), np.asarray(jcnt))


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


_PAST_G_MIXES = {
    # the JAX package's example: ids 5 and 7 lie past G = 3
    "example": lambda rng, n, g: np.array([0, 1, 5, -1, 2, 7, 1]),
    "past_only": lambda rng, n, g: rng.integers(0, 2 * g + 3, n),
    "masked_and_past": lambda rng, n, g: rng.integers(-3, 3 * g, n),
    "all_out": lambda rng, n, g: np.where(rng.random(n) < .5, -1,
                                          g + rng.integers(0, 9, n)),
}


@pytest.mark.parametrize("mix,g", [("example", 3)] + [
    (mix, g) for mix in sorted(_PAST_G_MIXES) if mix != "example"
    for g in (1, 3, 40)])
def test_segment_agg_drops_ids_past_num_groups(mix, g):
    """Rows whose id is >= num_groups are dropped, like masked (< 0) rows,
    by the Pallas kernel (interpret), the JAX reference and the port."""
    rng = np.random.default_rng(len(mix) * 100 + g)
    gid = _PAST_G_MIXES[mix](rng, 500, g).astype(np.int32)
    vals = rng.uniform(1.0, 100.0, gid.size).astype(np.float32)
    cnt, s, s2 = segment_agg.segment_agg(torch.from_numpy(gid),
                                         torch.from_numpy(vals), g)
    keep = (gid >= 0) & (gid < g)
    want = np.bincount(gid[keep], minlength=g)
    assert cnt.shape == (g,) and np.array_equal(cnt.numpy(), want)
    if mix == "example":
        assert cnt.tolist() == [1, 2, 1]
    np.testing.assert_array_equal(
        s.numpy(), np.bincount(gid[keep], vals[keep].astype(np.float64), g))
    jc, js, js2 = jseg.segment_agg(jnp.asarray(gid), jnp.asarray(vals), g,
                                   interpret=True)
    rc, rs, rs2 = jref.segment_agg_ref(jnp.asarray(gid), jnp.asarray(vals),
                                       g)
    for jcnt, jsum, jsq in ((jc, js, js2), (rc, rs, rs2)):
        assert np.array_equal(cnt.numpy(),
                              np.rint(np.asarray(jcnt)).astype(int))
        np.testing.assert_allclose(s.numpy(), np.asarray(jsum), rtol=1e-6)
        np.testing.assert_allclose(s2.numpy(), np.asarray(jsq), rtol=1e-6)


@pytest.mark.parametrize("slabs", [1, 20])
@pytest.mark.parametrize("g", [0, 1, 2, 3, 56, 2048, 2049, 77_888])
def test_segment_agg_output_buffer_carving(g, slabs):
    """The kernels' one output buffer: count [G] int32, sum and sumsq [G]
    float64 as views of its first slab (the shared branch's scratch slabs
    follow), the float64 planes 8-byte aligned, no two views sharing a
    byte."""
    cnt, s, s2 = segment_agg.alloc_outputs(g, "cpu", zero=True, slabs=slabs)
    assert (cnt.shape, s.shape, s2.shape) == ((g,), (g,), (g,))
    assert (cnt.dtype, s.dtype, s2.dtype) == (torch.int32, torch.float64,
                                              torch.float64)
    assert all(t.is_contiguous() for t in (cnt, s, s2))
    base = s.untyped_storage().data_ptr()
    assert cnt.untyped_storage().data_ptr() == s2.untyped_storage() \
        .data_ptr() == base
    slab = 8 * segment_agg.slab_doubles(g)
    assert s.untyped_storage().nbytes() == slabs * slab
    spans = sorted((t.data_ptr() - base, t.data_ptr() - base + t.nbytes)
                   for t in (s, s2, cnt))
    assert spans[0][0] == 0 and spans[-1][1] <= slab
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert s.data_ptr() % 8 == 0 and s2.data_ptr() % 8 == 0
    assert cnt.data_ptr() % 4 == 0
    assert s.data_ptr() == base          # the kernels' buffer pointer
    assert not (cnt.any() or s.any() or s2.any())
    if g:
        cnt.fill_(-1)
        s.fill_(1.5)
        assert not s2.any() and bool((cnt == -1).all())


@pytest.mark.parametrize("n,g", [(1, 1), (19_200, 56), (864_000, 56),
                                 (50_000, 2048), (10**7, 2048)])
def test_segment_agg_shared_blocks(n, g):
    """Pass 1's grid: at least one block, no more than the rows need, and
    the scratch (one slab a block) under its cap."""
    blocks = segment_agg.shared_blocks(n, g)
    slab_bytes = 8 * segment_agg.slab_doubles(g)
    assert 1 <= blocks <= -(-n // segment_agg.ROWS_PER_BLOCK)
    assert blocks <= segment_agg.MAX_BLOCKS
    assert blocks * slab_bytes <= max(segment_agg.SCRATCH_BYTES, slab_bytes)


_CSRC = Path(_build.__file__).resolve().parent / "csrc"
_EXPORT = re.compile(r"REPRO_EXPORT\s+int\s+(\w+)\s*\(([^)]*)\)", re.S)


def _c_kind(param: str) -> str:
    """ctypes kind of one C parameter: pointer, int, 64-bit int, float."""
    decl = " ".join(param.split())
    if "*" in decl:
        return "p"
    if "long long" in decl or "int64_t" in decl:
        return "l"
    if decl.startswith(("float ", "const float ")):
        return "f"
    if decl.startswith(("int ", "const int ")):
        return "i"
    raise AssertionError(f"no ctypes kind for C parameter {param!r}")


@pytest.mark.parametrize("lib", sorted(_build.SOURCES))
def test_c_entry_points_match_ctypes_signatures(lib):
    """Every REPRO_EXPORT entry point of ``csrc/<lib>.cu`` is in
    ``_build.SOURCES[lib]`` with one ctypes kind for each C parameter, in
    order; nothing is bound that the source does not export."""
    src = (_CSRC / f"{lib}.cu").read_text()
    exported = {name: "".join(_c_kind(p) for p in params.split(","))
                for name, params in _EXPORT.findall(src)}
    assert exported == _build.SOURCES[lib]


def test_segment_agg_shared_max_groups_matches_kernel():
    src = (_CSRC / "segment_agg.cu").read_text()
    found = re.search(r"constexpr int kSharedMaxGroups = (\d+);", src)
    assert found and int(found.group(1)) == segment_agg.SHARED_MAX_GROUPS


def test_scan_tile_matches_kernel():
    """The wrapper's SCAN_TILE is the kernel's tile: threads × mask bytes
    a thread."""
    src = (_CSRC / "compact.cu").read_text()
    threads = re.search(r"constexpr int kScanThreads = (\d+);", src)
    items = re.search(r"constexpr int kItems = (\d+);", src)
    assert threads and items
    assert int(threads.group(1)) * int(items.group(1)) == compact.SCAN_TILE


@pytest.mark.parametrize("need", [0, 1, 2, 3, 4, 7, 8, 221, 1761, 70_001])
def test_state_words(need):
    """A kernel's state buffer: a power of two of int64 words at or above
    what the call needs, and below twice that."""
    words = _build.state_words(need)
    assert words >= need and words & (words - 1) == 0
    assert words < 2 * need or words == 1


def test_intersect_block_words_matches_kernel():
    """The wrapper's INTERSECT_BLOCK_WORDS is the kernel's: threads × words
    a lane."""
    src = (_CSRC / "bitset.cu").read_text()
    threads = re.search(r"constexpr int kThreads = (\d+);", src)
    lane = re.search(r"constexpr int kLaneWords = (\d+);", src)
    assert threads and lane
    assert int(threads.group(1)) * int(lane.group(1)) == \
        bitset.INTERSECT_BLOCK_WORDS


@pytest.mark.parametrize("s,w,want", [(8, 625, 0), (128, 1024, 0),
                                      (1, 1025, 1), (8, 28_125, 8),
                                      (3, 4096, 3)])
def test_intersect_state_words(s, w, want):
    """No state for one block a shard; else one int64 word a shard."""
    assert bitset.intersect_state_words(s, w) == want


def test_scan_next_epoch_wraps():
    """Epochs count up from 1 and wrap before the 32-bit field overflows;
    0 (a zero-filled word) is never a call's epoch."""
    assert compact.next_epoch(0) == (1, False)
    assert compact.next_epoch(41) == (42, False)
    last = compact.EPOCH_LIMIT - 1
    assert compact.next_epoch(last - 1) == (last, False)
    assert compact.next_epoch(last) == (1, True)
    assert last == 0xFFFFFFFF


def _fake_card(monkeypatch):
    """Record ``_build.launch`` calls instead of launching, on one fake
    stream with no states yet; returns the list of calls."""
    calls = []

    def fake_launch(counter, entry, dev, *args):
        calls.append((counter, entry, args))

    class _Stream:
        cuda_stream = 1234

    monkeypatch.setattr(_build, "launch", fake_launch)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda index=None: _Stream())
    monkeypatch.setattr(_build, "_STATES", {})
    return calls


def test_scan_state_bookkeeping(monkeypatch):
    """Each scan passes the ticket its tiles start at and a new epoch; the
    buffer grows (zero-filled, ticket and epoch restarted) only when a call
    needs more words, and is zero-filled again when the epoch wraps."""
    calls = _fake_card(monkeypatch)
    mask = torch.zeros((3, 2 * compact.SCAN_TILE + 1), dtype=torch.bool)
    out = torch.empty(0)

    def call(s, n):
        compact._scan("compact_batched", "repro_compact_batched", mask,
                      out, out, s, n, s, n)
        args = calls[-1][2]
        return args[3], args[4:]

    t = compact.SCAN_TILE
    buf0, args = call(3, 2 * t + 1)                # 9 tiles: 16 words
    assert args == (3, 2 * t + 1, 0, 1) and buf0.numel() == 16
    buf1, args = call(2, t)                        # 2 tiles, same buffer
    assert buf1 is buf0 and args == (2, t, 9, 2)
    buf2, args = call(1, 5)
    assert buf2 is buf0 and args == (1, 5, 11, 3)
    buf3, args = call(16, t)                       # 16 tiles: grows to 32
    assert buf3.numel() == 32 and args == (16, t, 0, 1)
    assert not bool(buf3.any())
    st = next(iter(_build._STATES.values()))
    st.epoch = compact.EPOCH_LIMIT - 1
    buf3.fill_(7)
    buf4, args = call(1, 5)                        # the epoch wraps
    assert buf4 is buf3 and args == (1, 5, 0, 1) and not bool(buf4.any())


def test_intersect_state_bookkeeping(monkeypatch):
    """One block a shard launches with no state (a null pointer); wider
    shards get the kernel's zero-filled buffer, grown only when a call
    needs more, and kept per stream apart from the scan's."""
    calls = _fake_card(monkeypatch)
    stack = torch.zeros((8, 5, 3000), dtype=torch.int32)
    out = torch.empty(0)
    bitset._intersect("bitmap_intersect_batched", stack, out, out, 8, 5, 625)
    assert calls[-1][1] == "repro_bitmap_intersect"
    assert calls[-1][2][-1] is None and not _build._STATES
    bitset._intersect("bitmap_intersect_batched", stack, out, out, 8, 5, 3000)
    buf = calls[-1][2][-1]
    assert buf.numel() == 8 and not bool(buf.any())    # a word a shard
    bitset._intersect("bitmap_intersect", stack, out, out, 1, 5, 3000)
    assert calls[-1][2][-1] is buf and calls[-1][0] == "bitmap_intersect"
    compact._scan("compact", "repro_mask_scan", stack, out, out, 1, 10, 10, 1)
    assert calls[-1][2][3] is not buf and len(_build._STATES) == 2


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


@pytest.mark.parametrize("lead,c,r,d,mode", [
    ((1,), 1, 1, 1, 0), ((8,), 2, 896, 33, 0), ((3,), 30, 128, 7, 1),
    ((16, 8), 2, 640, 31, 2), ((2, 1), 3, 8064, 5, 2), ((1,), 1, 1, 3, 2)])
def test_refine_alloc_outputs_layout(lead, c, r, d, mode):
    """The CUDA refine's one buffer: scratch and outputs are disjoint
    slices of it, each contiguous, of the kernel's dtypes and shapes; the
    tables' scratch holds one laid-out record a query."""
    (tab, acc, first, last, bits), out = refine.alloc_outputs(
        lead, c, r, d, mode, "cpu")
    q = lead[0] if len(lead) == 2 else 1
    n = int(np.prod(lead)) * d
    assert tab.dtype == torch.int64 and tab.numel() == \
        q * refine._record_words(c, r)
    assert bits.dtype == torch.int32 and bits.numel() == n
    assert (first is None) == (mode == 0) and (last is None) == (mode < 2)
    # the accumulators that start at 0 are one slice: first, last, bits
    # and the count
    lo, hi = acc.data_ptr(), acc.data_ptr() + 8 * acc.numel()
    for v in (first, last, bits, out[5] if mode == 2 else None):
        if v is not None:
            assert lo <= v.data_ptr() and \
                v.data_ptr() + v.numel() * v.element_size() <= hi
    want = [(torch.bool, (*lead, d))]
    want += [(torch.int32, (*lead, c, d))] * (0, 2, 5)[mode]
    assert [(o.dtype, tuple(o.shape)) for o in out] == want
    views = [v for v in (tab, first, last, bits, *out[:5]) if v is not None]
    base = tab.untyped_storage().data_ptr()
    spans = []
    for v in views:
        assert v.is_contiguous()
        assert v.untyped_storage().data_ptr() == base
        start = v.data_ptr() - base
        spans.append((start, start + v.numel() * v.element_size()))
        assert spans[-1][1] <= tab.untyped_storage().nbytes()
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    # the 64-bit accumulators are 8-byte aligned, the int32 planes 4
    for v in views:
        assert (v.data_ptr() - base) % v.element_size() == 0


def test_refine_record_words_matches_kernel():
    """``_record_words`` sizes the scratch with the kernel's formula (the
    launcher also checks the size it is given)."""
    src = (_CSRC / "refine.cu").read_text()
    assert "return 2 * ((R + 63) / 64);" in src
    assert "return static_cast<size_t>(C) * (2 + fence_words(R) + 2 * R);" \
        in src
    for c, r in ((1, 1), (2, 63), (2, 64), (2, 65), (30, 896)):
        assert refine._record_words(c, r) == c * (2 + 2 * ((r + 63) // 64)
                                                  + 2 * r)


@pytest.mark.parametrize("case", ["plain", "requires_grad", "no_grad",
                                  "inference_mode", "none_skipped",
                                  "detached"])
def test_forbid_grad(case):
    """The CUDA kernels have no backward: ``forbid_grad`` raises, naming
    the kernel, exactly when grad mode is on and an input requires grad."""
    x = torch.ones(3)
    w = torch.ones(3, requires_grad=True)
    args = {"plain": (x, x), "requires_grad": (x, w), "no_grad": (x, w),
            "inference_mode": (x, w), "none_skipped": (x, None),
            "detached": (w.detach(), x)}[case]
    if case == "requires_grad":
        with pytest.raises(RuntimeError, match="ssm_scan"):
            _build.forbid_grad("ssm_scan", *args)
    elif case == "no_grad":
        with torch.no_grad():
            _build.forbid_grad("ssm_scan", *args)
    elif case == "inference_mode":
        with torch.inference_mode():
            _build.forbid_grad("ssm_scan", *args)
    else:
        _build.forbid_grad("ssm_scan", *args)


@pytest.mark.parametrize("kernel", ["flash_attention", "ssm_scan"])
def test_cpu_plain_versions_differentiate(kernel):
    """On CPU tensors the wrappers run the plain versions, which carry
    the gradient (the guard is the CUDA branch's only)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as ssm
    g = torch.Generator().manual_seed(0)
    if kernel == "flash_attention":
        q = torch.randn((1, 2, 8, 16), generator=g, requires_grad=True)
        out = fa.flash_attention(q, q.detach(), q.detach())
    else:
        q = torch.rand((1, 8, 4), generator=g, requires_grad=True)
        out = ssm.ssm_scan(q, torch.ones((1, 8, 4)))[0]
    out.sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    assert bool(torch.isfinite(q.grad).all()) and bool((q.grad != 0).any())


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



# ------------------------------------------- single-shard and serve kernels

@pytest.mark.parametrize("w", [1, 31, 32, 33, 4097])
@pytest.mark.parametrize("op", ["and", "or", "andnot"])
def test_bitset_binary(w, op):
    rng = np.random.default_rng(w)
    a, b = (rng.integers(0, 1 << 32, w, dtype=np.uint64).astype(np.uint32)
            for _ in range(2))
    got = _u32(bitset.bitset_binary(_words(a), _words(b), op))
    want_i = np.asarray(jbitset.bitset_binary(jnp.asarray(a), jnp.asarray(b),
                                              op=op, interpret=True))
    ref_fn = {"and": jref.bitset_and_ref, "or": jref.bitset_or_ref,
              "andnot": jref.bitset_andnot_ref}[op]
    want_r = np.asarray(ref_fn(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got, want_i) and np.array_equal(got, want_r)
    ops.reset_launch_counts()
    ops.bitmap_binary(_words(a), _words(b), op)
    assert ops.launch_counts() == {"bitmap_binary": 1}


def test_bitset_binary_rejects_bad_inputs():
    a = _words(np.zeros(4, np.uint32))
    with pytest.raises(ValueError):
        bitset.bitset_binary(a, a, "xor")
    with pytest.raises(ValueError):
        bitset.bitset_binary(a, a[:3].contiguous())


@pytest.mark.parametrize("k,w", [(1, 31), (2, 32), (3, 33), (4, 700),
                                 (2, 4097)])
def test_bitmap_intersect(k, w):
    rng = np.random.default_rng(10 * k + w)
    stack = rng.integers(0, 1 << 32, (k, w), dtype=np.uint64) \
        .astype(np.uint32)
    stack[:, rng.integers(0, w)] |= 0x80000000          # the sign bit
    bm, cnt = bitset.bitmap_intersect(_words(stack))
    jbm, jcnt = jbitset.bitmap_intersect(jnp.asarray(stack), interpret=True)
    rbm = jref.bitmap_intersect_ref(jnp.asarray(stack))
    assert np.array_equal(_u32(bm), np.asarray(jbm))
    assert np.array_equal(_u32(bm), np.asarray(rbm))
    assert int(cnt) == int(jcnt) == int(jref.popcount_ref(rbm))
    assert cnt.dtype == torch.int32 and cnt.dim() == 0
    ops.reset_launch_counts()
    ops.bitmap_intersect(_words(stack))
    assert ops.launch_counts() == {"bitmap_intersect": 1}


@pytest.mark.parametrize("n,density", [(1, 1.0), (31, .5), (4096, .3),
                                       (4097, .01), (9000, .9), (300, 0.0)])
def test_mask_prefix_sum_and_compact(n, density):
    """Across the kernel's 4096-row tiles: positions and ids equal to the
    interpret kernels and the jnp oracle, byte for byte."""
    rng = np.random.default_rng(n)
    mask = rng.random(n) < density
    pos, pc = compact.mask_prefix_sum(torch.from_numpy(mask))
    jpos, jpc = jcompact.mask_prefix_sum(jnp.asarray(mask), interpret=True)
    assert np.array_equal(pos.numpy(), np.asarray(jpos))
    idx, c = compact.compact(torch.from_numpy(mask))
    jidx, jc = jcompact.compact(jnp.asarray(mask), interpret=True)
    ridx, rc = jref.compact_ref(jnp.asarray(mask))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    assert int(pc) == int(c) == int(jc) == int(jpc) == int(rc) == mask.sum()
    assert idx.dtype == pos.dtype == torch.int32
    ops.reset_launch_counts()
    ops.compact(torch.from_numpy(mask))
    assert ops.launch_counts() == {"compact": 1}


def test_compact_empty_mask():
    idx, c = compact.compact(torch.zeros(0, dtype=torch.bool))
    jidx, jc = jcompact.compact(jnp.zeros((0,), bool), interpret=True)
    assert idx.shape == (0,) and int(c) == 0 == int(jc)
    pos, pc = compact.mask_prefix_sum(torch.zeros(0, dtype=torch.bool))
    assert pos.shape == (0,) and int(pc) == 0


@pytest.mark.parametrize("kw", MODES)
def test_refine_tracks_single_shard(kw):
    """The S=1 wrapper equals the TPU ``refine_tracks`` (interpret)."""
    rng = np.random.default_rng(5)
    _, _, pts, rows, cov = _wave(rng, [45], 2)
    got = refine.refine_tracks(_words(pts[0]), torch.from_numpy(rows[0]),
                               _words(cov), 45, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = _jax_refine(lambda *a, **k: jrefine.refine_tracks(
        *a, interpret=True, **k), pts[0], rows[0], cov, 45, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy()
        assert np.array_equal(g.view(w.dtype) if g.dtype != bool else g, w)
    ops.reset_launch_counts()
    ops.refine_tracks(_words(pts[0]), torch.from_numpy(rows[0]),
                      _words(cov), 45, **kw)
    assert ops.launch_counts() == {"refine_tracks": 1}


def _multi_wave(rng, shard_docs, n_cons):
    """Shared ragged tracks and Q queries' constraint lists (``n_cons``
    constraints each), packed into one padded multi-query table."""
    tracks = [_tracks(rng, n, 10) for n in shard_docs]
    lat = np.concatenate([t[0] for t in tracks])
    lng = np.concatenate([t[1] for t in tracks])
    cons = [_constraints(rng, lat, lng, c) for c in n_cons]
    packs = [pack_track_points(*t) for t in tracks]
    p_max = max(1, max(p.shape[1] for p, _ in packs))
    pts = np.zeros((len(packs), 4, p_max), np.uint32)
    rows = np.full((len(packs), p_max), -1, np.int32)
    for i, (p, r) in enumerate(packs):
        pts[i, :, :p.shape[1]] = p
        rows[i, :r.size] = r
    return tracks, cons, pts, rows, pack_constraints_multi(cons)


@pytest.mark.parametrize("kw", MODES)
def test_refine_tracks_multi(kw):
    """Q=3 queries of 1–3 constraints over S=2 shards (padded C and R):
    equal to the interpret multi kernel and the vmapped jnp oracle."""
    rng = np.random.default_rng(77)
    _, _, pts, rows, cov = _multi_wave(rng, [40, 33], (1, 3, 2))
    assert pts.shape[2] <= 512 and cov.shape[:2] == (3, 3)
    got = refine.refine_tracks_multi(_words(pts), torch.from_numpy(rows),
                                     _words(cov), 40, **kw)
    got = [o.numpy() for o in (got if isinstance(got, tuple) else (got,))]
    want_i = _jax_refine(lambda *a, **k: jrefine.refine_tracks_multi(
        *a, interpret=True, **k), pts, rows, cov, 40, **kw)
    want_r = _jax_refine(jref.refine_tracks_multi_ref, pts, rows, cov, 40,
                         **kw)
    assert len(got) == len(want_i) == len(want_r)
    for g, wi, wr in zip(got, want_i, want_r):
        g = g.view(wi.dtype) if g.dtype != bool else g
        assert np.array_equal(g, wi) and np.array_equal(g, wr)
    assert got[0].any() and not got[0].all()


def test_refine_tracks_multi_per_query_equals_single():
    """Each query's plane equals the single-query wave kernel on its own
    table: the always-hit pad constraints and never-hit pad ranges change
    no verdict of a doc that passes its real constraints."""
    rng = np.random.default_rng(78)
    _, cons, pts, rows, cov = _multi_wave(rng, [50, 17], (2, 1, 3))
    got = refine.refine_tracks_multi(_words(pts), torch.from_numpy(rows),
                                     _words(cov), 50).numpy()
    for q, c in enumerate(cons):
        one = _port_refine(pts, rows, pack_constraints(c), 50)[0]
        assert np.array_equal(got[q], one)
    empty = refine.refine_tracks_multi(_words(pts[:0]),
                                       torch.from_numpy(rows[:0]),
                                       _words(cov), 50, with_analytics=True)
    assert empty[0].shape == (3, 0, 50) and empty[5].shape == (3, 0, 3, 50)


def test_run_wave_fused_multi_matches_jax_interpret():
    """Q=3 coalesced queries (one with an ordering edge) through the
    multi-query wave: the query axis folded into the probe and compact
    kernels, against the JAX pipeline on its interpret kernels."""
    rng = np.random.default_rng(91)
    shard_docs = [60, 0, 33]
    _, _, pts, rows, cov = _multi_wave(rng, shard_docs, (2, 1, 2))
    n_max = max(shard_docs)
    w = (n_max + 31) // 32
    stacks = np.zeros((3, len(shard_docs), 2, w), np.uint32)
    for q in range(3):
        for i, n in enumerate(shard_docs):
            full = bitmap_from_ids(np.arange(n), n)
            probe = bitmap_from_ids(np.nonzero(rng.random(n) < .7)[0], n)
            stacks[q, i, 0, :full.size] = full
            stacks[q, i, 1, :probe.size] = probe
    ns = np.asarray(shard_docs, np.int32)
    edges = ((), (), ((0, 1),))
    ops.reset_launch_counts()
    cand, idx, cnt = ops.run_wave_fused_multi(
        _words(stacks), torch.from_numpy(ns), _words(pts),
        torch.from_numpy(rows), _words(cov), num_docs=n_max,
        edges_multi=edges)
    assert ops.launch_counts() == {"run_wave_fused_multi": 1}
    jc, jidx, jcnt = jfused.run_wave_fused_multi(
        jnp.asarray(stacks), jnp.asarray(ns), jnp.asarray(pts),
        jnp.asarray(rows), jnp.asarray(cov), num_docs=n_max,
        edges_multi=edges, impl="interpret")
    assert np.array_equal(cand.numpy(), np.asarray(jc))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(cnt.numpy(), np.asarray(jcnt))
    assert cnt.numpy().sum() > 0


@pytest.mark.parametrize("min_counts,dwells", [((2, 1), (None, None)),
                                               ((1, 1), (5000.0, None))])
def test_refine_multi_stage_reductions_match_host(min_counts, dwells):
    """A query with count / dwell reductions beside one without, in one
    multi-query launch: each verdict equals the numpy host oracle's."""
    rng = np.random.default_rng(33)
    shard_docs = [40, 25]
    tracks, cons, pts, rows, cov = _multi_wave(rng, shard_docs, (2, 2))
    got = fused._refine_multi_stage(
        _words(pts), torch.from_numpy(rows), _words(cov), max(shard_docs),
        ((), ((0, 1),)), (min_counts, ()), (dwells, ())).numpy()
    for i, (track, n) in enumerate(zip(tracks, shard_docs)):
        want0 = refine_tracks_host(*track, n, cons[0],
                                   min_counts=min_counts, dwells=dwells)
        want1 = refine_tracks_host(*track, n, cons[1], edges=((0, 1),))
        assert np.array_equal(got[0, i, :n], want0)
        assert np.array_equal(got[1, i, :n], want1)


def test_postings_bitmap_matches_host():
    """The spacetime lookup's tail: postings OR + span prune, equal to
    the JAX package's host oracle word for word (bit 31 included)."""
    rng = np.random.default_rng(4)
    for n in (1, 31, 32, 33, 100):
        ids = rng.choice(n, size=max(1, n // 2), replace=False)
        t_min = rng.uniform(0, 100, n)
        t_max = t_min + rng.uniform(0, 50, n)
        got = fused.postings_bitmap(torch.from_numpy(ids),
                                    torch.from_numpy(t_min),
                                    torch.from_numpy(t_max), 40.0, 90.0, n)
        want = JNumpyBackend().postings_bitmap(ids, t_min, t_max, 40.0,
                                               90.0, n)
        assert np.array_equal(_u32(got), want)
