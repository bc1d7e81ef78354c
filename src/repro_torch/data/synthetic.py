"""Synthetic spatiotemporal world generator (paper §6 datasets).

Deterministic generators for the datasets the paper's experiments revolve
around: road segments (with polyline geometry), traffic-speed observations
(a time series per segment with rush-hour structure), route requests (paths
over roads with actual travel times), and trips (variable-length point
tracks with timestamps — the §2 Tesseract workload).  Scales from
unit-test size to benchmark size with one ``scale`` knob.

Each road gets a *true* speed profile: base speed, rush-hour dip, and a
per-road variability level — so the paper's "coefficient of variation"
query (Q1–Q5) has real signal to find, and the §5 ML workflow can learn
to predict speeds from (road, hour) features.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..fdb.schema import (DOUBLE, INT, MESSAGE, STRING, Field, Schema)

__all__ = ["roads_schema", "observations_schema", "route_requests_schema",
           "trips_schema", "generate_world", "city_region", "CITIES"]

# city → (lat0, lng0, lat_span, lng_span); SF-bay-like layout
CITIES: Dict[str, Tuple[float, float, float, float]] = {
    "SF": (37.70, -122.52, 0.11, 0.12),
    "Berkeley": (37.85, -122.30, 0.06, 0.06),
    "SouthBay": (37.23, -122.05, 0.15, 0.25),
    "Fremont": (37.50, -122.05, 0.08, 0.10),
    "Sacramento": (38.45, -121.55, 0.15, 0.20),
    "LA": (33.90, -118.40, 0.30, 0.40),
}
BAY_AREA = ("SF", "Berkeley", "SouthBay", "Fremont")

# inter-city trip destinations: geographically plausible neighbors
NEIGHBORS: Dict[str, Tuple[str, ...]] = {
    "SF": ("Berkeley", "SouthBay", "Fremont", "LA"),
    "Berkeley": ("SF", "Fremont", "Sacramento"),
    "SouthBay": ("SF", "Fremont", "LA"),
    "Fremont": ("SouthBay", "Berkeley", "SF"),
    "Sacramento": ("Berkeley", "SF"),
    "LA": ("SF", "SouthBay"),
}


def roads_schema() -> Schema:
    return Schema("Roads", [
        Field("id", INT, indexes=("tag",)),
        Field("city", STRING, indexes=("tag",)),
        Field("loc", MESSAGE, fields=[Field("lat", DOUBLE),
                                      Field("lng", DOUBLE)],
              indexes=("location",)),
        Field("polyline", MESSAGE, fields=[
            Field("lat", DOUBLE, repeated=True),
            Field("lng", DOUBLE, repeated=True)],
            indexes=("area",), index_params={"level": 6, "width_m": 25.0},
            column_set="geometry"),
        Field("speed_limit", DOUBLE, indexes=("range",)),
        Field("base_speed", DOUBLE),
        Field("variability", DOUBLE),
    ])


def observations_schema() -> Schema:
    return Schema("SpeedObservations", [
        Field("road_id", INT, indexes=("tag",)),
        Field("loc", MESSAGE, fields=[Field("lat", DOUBLE),
                                      Field("lng", DOUBLE)],
              indexes=("location",)),
        Field("hour", INT, indexes=("range",)),
        Field("dow", INT, indexes=("range",)),         # 0=Mon … 6=Sun
        Field("month", INT, indexes=("range",)),
        Field("speed", DOUBLE),
        Field("accuracy_m", DOUBLE),
    ])


def route_requests_schema() -> Schema:
    return Schema("RouteRequests", [
        Field("id", INT, indexes=("tag",)),
        Field("start_loc", MESSAGE, fields=[Field("lat", DOUBLE),
                                            Field("lng", DOUBLE)],
              indexes=("location",)),
        Field("end_loc", MESSAGE, fields=[Field("lat", DOUBLE),
                                          Field("lng", DOUBLE)],
              indexes=("location",)),
        Field("hour", INT, indexes=("range",)),
        Field("route", MESSAGE, fields=[
            Field("id", INT, repeated=True)]),          # road segment ids
        Field("time_s", DOUBLE),
    ])


def city_region(*names: str, max_level: int = 6):
    """Union of city bounding boxes → selection :class:`AreaTree`.

    The canonical query-region builder for this world, shared by the
    benchmark queries, the Tesseract tests, and the examples.  Level 6
    ≈ 150 m cells: city-scale selection with ~100× fewer Morton ranges
    than level 7 (probe cost ∝ ranges).
    """
    from ..geo import mercator as M
    from ..geo.areatree import AreaTree
    area = AreaTree.empty()
    for c in names:
        lat0, lng0, dlat, dlng = CITIES[c]
        ix, iy = M.latlng_to_xy(np.array([lat0, lat0 + dlat]),
                                np.array([lng0, lng0 + dlng]))
        area = area | AreaTree.from_box(int(ix[0]), int(iy[1]),
                                        int(ix[1]), int(iy[0]),
                                        max_level=max_level)
    return area


def trips_schema() -> Schema:
    """Trips: variable-length space-time tracks (the Tesseract workload).

    The ``track`` message carries the repeated (lat, lng, t) point stream
    and a ``spacetime`` index — (level-6 area-tree cell × 15-min bucket)
    postings built at ingest (see :mod:`repro_torch.tess.index`).  ``t`` is
    seconds since the synthetic week's epoch (``day * 86400 + sec``).
    """
    return Schema("Trips", [
        Field("id", INT, indexes=("tag",)),
        Field("vehicle", INT, indexes=("tag",)),
        Field("day", INT, indexes=("range",)),         # 0=Mon … 6=Sun
        Field("start_hour", INT, indexes=("range",)),
        Field("track", MESSAGE, fields=[
            Field("lat", DOUBLE, repeated=True),
            Field("lng", DOUBLE, repeated=True),
            Field("t", DOUBLE, repeated=True)],
            indexes=("spacetime",),
            index_params={"level": 6, "bucket_s": 900.0, "epoch": 0.0},
            column_set="track"),
        Field("duration_s", DOUBLE, indexes=("range",)),
    ])


def _road_speed(base: float, var: float, hour: int, rng) -> float:
    """True speed model: rush-hour dips + per-road variability noise."""
    rush = 1.0
    if 7 <= hour <= 9:
        rush = 0.55 + 0.1 * np.cos(hour - 8)
    elif 16 <= hour <= 18:
        rush = 0.6
    elif 0 <= hour <= 5:
        rush = 1.15
    return max(3.0, base * rush + rng.normal(0.0, var))


def generate_world(scale: float = 1.0, seed: int = 0):
    """Returns dict of record lists + schemas; sizes scale linearly."""
    rng = np.random.default_rng(seed)
    n_roads = max(20, int(600 * scale))
    n_obs = max(100, int(20_000 * scale))
    n_req = max(20, int(1_500 * scale))

    cities = list(CITIES)
    weights = np.array([4.0, 1.0, 2.0, 1.0, 1.5, 3.0])
    weights = weights / weights.sum()

    roads: List[dict] = []
    for i in range(n_roads):
        city = cities[int(rng.choice(len(cities), p=weights))]
        lat0, lng0, dlat, dlng = CITIES[city]
        lat = lat0 + rng.uniform(0, dlat)
        lng = lng0 + rng.uniform(0, dlng)
        npts = int(rng.integers(2, 6))
        step = rng.uniform(2e-4, 8e-4, size=(npts, 2)) \
            * rng.choice([-1, 1], size=(npts, 2))
        pts = np.cumsum(np.vstack([[0, 0], step[:-1]]), axis=0) \
            + [lat, lng]
        base = float(rng.uniform(20, 100))
        roads.append({
            "id": i, "city": city,
            "loc": {"lat": lat, "lng": lng},
            "polyline": {"lat": pts[:, 0].tolist(),
                         "lng": pts[:, 1].tolist()},
            "speed_limit": float(np.ceil(base / 10) * 10),
            "base_speed": base,
            "variability": float(rng.uniform(0.5, 12.0)),
        })

    obs: List[dict] = []
    for _ in range(n_obs):
        r = roads[int(rng.integers(0, n_roads))]
        hour = int(np.clip(rng.normal(12, 5.5), 0, 23))
        obs.append({
            "road_id": r["id"],
            "loc": {"lat": r["loc"]["lat"] + rng.normal(0, 1e-4),
                    "lng": r["loc"]["lng"] + rng.normal(0, 1e-4)},
            "hour": hour,
            "dow": int(rng.integers(0, 7)),
            "month": int(rng.integers(1, 7)),
            "speed": _road_speed(r["base_speed"], r["variability"], hour,
                                 rng),
            "accuracy_m": float(np.abs(rng.normal(8, 6)) + 3),
        })

    reqs: List[dict] = []
    for i in range(n_req):
        k = int(rng.integers(2, 8))
        seg_ids = rng.integers(0, n_roads, size=k).tolist()
        start = roads[seg_ids[0]]["loc"]
        end = roads[seg_ids[-1]]["loc"]
        hour = int(np.clip(rng.normal(9, 4), 0, 23))
        t = 0.0
        for sid in seg_ids:
            r = roads[sid]
            speed = _road_speed(r["base_speed"], r["variability"], hour,
                                rng)
            t += 120.0 * r["speed_limit"] / max(speed, 1.0)
        reqs.append({
            "id": i, "start_loc": dict(start), "end_loc": dict(end),
            "hour": hour, "route": {"id": [int(s) for s in seg_ids]},
            "time_s": t,
        })

    # -- trips: space-time tracks over the road world (Tesseract workload).
    # Drawn *after* the other datasets so their streams stay byte-identical
    # for a given (scale, seed).  ~1/3 of trips are inter-city (first half
    # of the track in city A, second half in a NEIGHBORS[a] city) so
    # two-constraint region-A-then-region-B queries have real answers;
    # start times follow a commute-shaped (bimodal) distribution over a
    # 7-day week.
    n_trips = max(40, int(1_200 * scale))
    by_city: Dict[str, List[dict]] = {}
    for r in roads:
        by_city.setdefault(r["city"], []).append(r)
    trips: List[dict] = []
    for i in range(n_trips):
        a = cities[int(rng.choice(len(cities), p=weights))]
        b = a
        if rng.random() < 0.35:
            nbrs = NEIGHBORS[a]
            b = nbrs[int(rng.integers(0, len(nbrs)))]
        k = int(rng.integers(3, 9))
        k1 = k if b == a else max(1, k // 2)
        pool_a = by_city.get(a) or roads
        pool_b = by_city.get(b) or roads
        segs = [pool_a[int(rng.integers(0, len(pool_a)))]
                for _ in range(k1)] + \
               [pool_b[int(rng.integers(0, len(pool_b)))]
                for _ in range(k - k1)]
        day = int(rng.integers(0, 7))
        u = rng.random()
        if u < 0.40:
            hour = float(np.clip(rng.normal(8.0, 1.2), 0.0, 23.5))
        elif u < 0.75:
            hour = float(np.clip(rng.normal(17.5, 1.3), 0.0, 23.5))
        else:
            hour = float(rng.uniform(0.0, 23.5))
        t = day * 86400.0 + hour * 3600.0
        lats: List[float] = []
        lngs: List[float] = []
        ts: List[float] = []
        for seg in segs:
            for la, ln in zip(seg["polyline"]["lat"],
                              seg["polyline"]["lng"]):
                lats.append(float(la))
                lngs.append(float(ln))
                ts.append(t)
                t += float(rng.uniform(20.0, 90.0))
        trips.append({
            "id": i,
            "vehicle": int(rng.integers(0, max(16, n_trips // 8))),
            "day": day, "start_hour": int(hour),
            "track": {"lat": lats, "lng": lngs, "t": ts},
            "duration_s": ts[-1] - ts[0],
        })

    return {
        "roads": roads, "observations": obs, "route_requests": reqs,
        "trips": trips,
        "roads_schema": roads_schema(),
        "observations_schema": observations_schema(),
        "route_requests_schema": route_requests_schema(),
        "trips_schema": trips_schema(),
    }
