"""The port's geometry and de-noising held against the JAX package.

``repro_torch.geo.geometry`` (numpy copies: ``Box``, haversine, Mercator
distance, polyline length, point-segment distance, ``bbox_of``; and
``mercator_dist_m_torch``, the reference's ``mercator_dist_m_jnp``) and
``repro_torch.geo.denoise`` (``prob_location``, ``prob_path``,
``SnapModel``, ``snap_points``, ``snap_path``) on seeded inputs, with the
tests of ``tests/test_geo.py`` (distances) and ``tests/test_denoise.py``
run on the port.

Tolerances: the numpy copies are bit-equal; area covers are equal trees;
candidate and segment indices are equal; float32 scores from ``log1p``
and the distance products may differ from XLA's by a float32 ulp or two
(1e-6 relative).  ``snap_path``'s Viterbi adds and argmaxes are
elementwise float32 with first-maximum ties, so its path is equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                               # noqa: E402

from repro.geo import denoise as jdn                  # noqa: E402
from repro.geo import geometry as jgeo                # noqa: E402

from repro_torch.geo import mercator as M             # noqa: E402
from repro_torch.geo import denoise as dn             # noqa: E402
from repro_torch.geo import geometry as geo           # noqa: E402

SCORE_RTOL = 1e-6


def _pts(seed, n, lo=1_000_000, span=50_000):
    rng = np.random.default_rng(seed)
    return (rng.integers(lo, lo + span, n).astype(np.float64),
            rng.integers(lo, lo + span, n).astype(np.float64))


# --------------------------------------------------------------- geometry

def test_numpy_geometry_bit_equal():
    rng = np.random.default_rng(0)
    lat0, lng0 = rng.uniform(-60, 60, 50), rng.uniform(-170, 170, 50)
    lat1, lng1 = lat0 + rng.normal(0, 0.5, 50), lng0 + rng.normal(0, 0.5, 50)
    assert np.array_equal(geo.haversine_m(lat0, lng0, lat1, lng1),
                          jgeo.haversine_m(lat0, lng0, lat1, lng1))
    x0, y0 = _pts(1, 50)
    x1, y1 = _pts(2, 50)
    assert np.array_equal(geo.mercator_dist_m(x0, y0, x1, y1),
                          jgeo.mercator_dist_m(x0, y0, x1, y1))
    assert geo.polyline_length_m(x0, y0) == jgeo.polyline_length_m(x0, y0)
    assert geo.polyline_length_m(x0[:1], y0[:1]) == 0.0
    ax, ay, bx, by = x0, y0, x1, y1
    px, py = _pts(3, 7)
    assert np.array_equal(
        geo.point_segment_dist(px[:, None], py[:, None], ax, ay, bx, by),
        jgeo.point_segment_dist(px[:, None], py[:, None], ax, ay, bx, by))
    b, jb = geo.bbox_of(x0, y0), jgeo.bbox_of(x0, y0)
    assert repr(b) == repr(jb) and b.center() == jb.center()
    box = geo.Box.from_latlng(37.7, -122.5, 37.8, -122.4)
    jbox = jgeo.Box.from_latlng(37.7, -122.5, 37.8, -122.4)
    assert repr(box) == repr(jbox)
    assert np.array_equal(box.contains(x0, y0), jbox.contains(x0, y0))


def test_known_distance_and_polyline():
    """``tests/test_geo.py``'s distance checks on the port."""
    a = M.latlng_to_xy(37.7749, -122.4194)   # SF
    b = M.latlng_to_xy(37.8044, -122.2711)   # Oakland
    d = float(geo.mercator_dist_m(a[0], a[1], b[0], b[1]))
    assert 12_000 < d < 15_000               # ~13.4 km
    ix0, iy0 = M.latlng_to_xy(0.0, 0.0)
    ix1, iy1 = M.latlng_to_xy(0.0, 0.008983)   # ~1km of longitude
    L = geo.polyline_length_m(np.array([float(ix0), float(ix1)]),
                              np.array([float(iy0), float(iy1)]))
    assert abs(L - 1000) < 10


@pytest.mark.parametrize("dtype", [torch.int64, torch.float32])
def test_mercator_dist_torch_matches_jnp(dtype):
    x0, y0 = _pts(4, 100)
    x1, y1 = _pts(5, 100)
    jd = jnp.int32 if dtype == torch.int64 else jnp.float32
    want = jgeo.mercator_dist_m_jnp(*(jnp.asarray(a, jd)
                                      for a in (x0, y0, x1, y1)), 0.0373)
    got = geo.mercator_dist_m_torch(*(torch.from_numpy(a).to(dtype)
                                      for a in (x0, y0, x1, y1)), 0.0373)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=SCORE_RTOL)


# ---------------------------------------------------------------- denoise

def test_prob_location_and_path_equal_reference():
    area = dn.prob_location(5_000_000, 6_000_000, 30.0, 0.05)
    want = jdn.prob_location(5_000_000, 6_000_000, 30.0, 0.05)
    assert np.array_equal(area.lo, want.lo) and \
        np.array_equal(area.hi, want.hi)
    xs = np.array([0.0, 10_000.0, 14_000.0]) + 1_000_000
    ys = np.array([0.0, 10_000.0, 9_000.0]) + 1_000_000
    strip = dn.prob_path(xs, ys, 20.0, 0.05)
    jstrip = jdn.prob_path(xs, ys, 20.0, 0.05)
    assert np.array_equal(strip.lo, jstrip.lo) and \
        np.array_equal(strip.hi, jstrip.hi)


def test_prob_location_covers_uncertainty_disk():
    ix, iy = 5_000_000, 6_000_000
    mpu = 0.05
    area = dn.prob_location(ix, iy, accuracy_m=30.0, meters_per_unit=mpu)
    r_units = 30.0 / mpu
    for ang in np.linspace(0, 2 * np.pi, 8, endpoint=False):
        px = np.uint64(ix + 0.9 * r_units * np.cos(ang))
        py = np.uint64(iy + 0.9 * r_units * np.sin(ang))
        assert area.contains(np.array([M.interleave(px, py)]))[0]


def test_prob_path_is_envelope_not_bbox():
    xs = np.array([0.0, 10_000.0]) + 1_000_000
    ys = np.array([0.0, 10_000.0]) + 1_000_000
    strip = dn.prob_path(xs, ys, accuracy_m=20.0, meters_per_unit=0.05)
    corner = M.interleave(np.uint64(1_000_000 + 9_000),
                          np.uint64(1_000_000 + 1_000))
    on_path = M.interleave(np.uint64(1_005_000), np.uint64(1_005_000))
    assert strip.contains(np.array([on_path]))[0]
    assert not strip.contains(np.array([corner]))[0]


def test_snap_model_log_score_matches():
    rng = np.random.default_rng(6)
    d = rng.uniform(0, 200, (30, 20))
    pop = rng.integers(0, 1000, (1, 20)).astype(np.float64)
    for model in (dn.SnapModel(), dn.SnapModel(sigma_m=7.0, w_pop=0.6)):
        jm = jdn.SnapModel(model.sigma_m, model.w_dist, model.w_pop)
        got = model.log_score(d, pop, device="cpu")
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jm.log_score(d, pop)),
                                   rtol=SCORE_RTOL, atol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_snap_points_matches_reference(seed):
    rng = np.random.default_rng(seed)
    cx, cy = _pts(seed + 10, 40, span=20_000)
    pop = rng.integers(0, 500, 40).astype(np.float64)
    px = cx[rng.integers(0, 40, 60)] + rng.normal(0, 400, 60)
    py = cy[rng.integers(0, 40, 60)] + rng.normal(0, 400, 60)
    px[:5] = 0.0                     # far from every candidate: −1
    for max_d in (30.0, 100.0):
        idx, score = dn.snap_points(px, py, cx, cy, pop, 0.05,
                                    max_dist_m=max_d, device="cpu")
        jidx, jscore = jdn.snap_points(px, py, cx, cy, pop, 0.05,
                                       max_dist_m=max_d)
        assert np.array_equal(idx, np.asarray(jidx))
        assert (idx[:5] == -1).all() and np.isneginf(score[:5]).all()
        np.testing.assert_allclose(score, np.asarray(jscore),
                                   rtol=SCORE_RTOL)


def test_snap_points_prefers_near_and_popular():
    """``tests/test_denoise.py`` on the port."""
    mpu = 0.05
    cand_x = np.array([1000.0, 1400.0])
    cand_y = np.array([1000.0, 1000.0])
    pop = np.array([1.0, 1000.0])
    idx, _ = dn.snap_points([1180.0], [1000.0], cand_x, cand_y, pop, mpu,
                            device="cpu")
    assert idx[0] == 1
    cand_x2 = np.array([1000.0, 3000.0])
    idx2, _ = dn.snap_points([1010.0], [1000.0], cand_x2, cand_y, pop, mpu,
                             device="cpu")
    assert idx2[0] == 0


def test_snap_path_viterbi_follows_route():
    rng = np.random.default_rng(0)
    mpu = 0.05
    ax = np.array([0.0, 2000.0, 4000.0])
    ay = np.zeros(3)
    bx = ax + 2000.0
    by = np.zeros(3)
    pop = np.ones(3)
    t = np.linspace(0, 6000, 13)
    px = t + rng.normal(0, 60.0, t.size)
    py = rng.normal(0, 60.0, t.size)
    seq = dn.snap_path(px, py, ax, ay, bx, by, pop, mpu, device="cpu")
    assert (np.diff(seq) >= 0).all()
    assert seq[0] == 0 and seq[-1] == 2
    assert np.array_equal(seq, jdn.snap_path(px, py, ax, ay, bx, by, pop,
                                             mpu))


@pytest.mark.parametrize("t,s", [(1, 5), (2, 9), (40, 60), (200, 300)])
def test_snap_path_equals_reference(t, s):
    """Random road segments and a noisy trace wandering over them,
    popularity ties included (integer popularities)."""
    rng = np.random.default_rng(t * 1000 + s)
    ax, ay = _pts(t + s, s, span=20_000)
    ang = rng.uniform(0, 2 * np.pi, s)
    bx, by = ax + 800 * np.cos(ang), ay + 800 * np.sin(ang)
    pop = rng.integers(0, 5, s).astype(np.float64)
    walk = np.cumsum(rng.normal(0, 300, (t, 2)), axis=0) + 1_010_000
    model = dn.SnapModel(sigma_m=20.0)
    jmodel = jdn.SnapModel(sigma_m=20.0)
    got = dn.snap_path(walk[:, 0], walk[:, 1], ax, ay, bx, by, pop, 0.05,
                       model=model, transition_scale_m=40.0, device="cpu")
    want = jdn.snap_path(walk[:, 0], walk[:, 1], ax, ay, bx, by, pop, 0.05,
                         model=jmodel, transition_scale_m=40.0)
    assert got.dtype == np.int64 and got.shape == (t,)
    assert np.array_equal(got, want)


def test_snap_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises((RuntimeError, AssertionError)):
        dn.snap_points([0.0], [0.0], [1.0], [1.0], [1.0], 0.05)
