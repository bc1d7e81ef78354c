"""Data de-noising (paper §4.1.3, Figure 6).

The port of ``repro/geo/denoise.py``.  Smartphone location fixes are
3–30 m off; the paper turns a noisy point into a *probabilistic location*
(mean + confidence radius → circular area) and a noisy trace into a
*probabilistic path* (time-ordered curvilinear strip), then snaps them
onto a well-defined space (POIs, road segments) with a scored model.

  * ``prob_location`` / ``prob_path`` — the area representations, built on
    :class:`repro_torch.geo.areatree.AreaTree` (host code, as in the
    reference).
  * ``snap_points`` — point → nearest candidate, scored by a Gaussian
    distance likelihood × a popularity prior, as float32 tensors on the
    device.
  * ``snap_path`` — trace → road-segment sequence via Viterbi over an HMM
    whose emissions are distance likelihoods and whose transitions
    penalize discontinuity.  The reference's ``lax.scan`` over waypoints
    is a loop of [S, S] float32 adds and column argmaxes on device
    tensors; the back-pointers come to the host once for the backtrack.

Both run on the card unless the caller passes ``device="cpu"``.  The adds
are elementwise float32 and ``torch.argmax`` takes the first maximum, as
``jnp.argmax`` does, so the paths equal the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .areatree import AreaTree
from .geometry import point_segment_dist

__all__ = ["prob_location", "prob_path", "snap_points", "snap_path",
           "SnapModel"]


def prob_location(ix: int, iy: int, accuracy_m: float, meters_per_unit: float,
                  max_level: int = 8) -> AreaTree:
    """Probabilistic location: mean point + confidence radius → circular area."""
    r_units = max(accuracy_m / meters_per_unit, 1.0)
    return AreaTree.from_circle(ix, iy, r_units, max_level=max_level)


def prob_path(xs, ys, accuracy_m: float, meters_per_unit: float,
              max_level: int = 7) -> AreaTree:
    """Probabilistic path: waypoints + noise strength → envelope strip.

    Note (paper): this is *not* the bbox of the points — it is an envelope
    around the path, so time ordering is preserved by construction.
    """
    w_units = max(accuracy_m / meters_per_unit, 1.0)
    return AreaTree.from_path(xs, ys, w_units, max_level=max_level)


def _f32(a, device) -> torch.Tensor:
    """Host values → a float32 tensor on ``device`` (rounded once, as
    ``jnp.asarray(..., dtype=float32)``)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)


@dataclass
class SnapModel:
    """Scoring model for snapping: Gaussian distance × popularity prior.

    ``sigma_m`` is the expected GPS noise.  ``w_dist``/``w_pop`` are log-space
    weights — a learned replacement (paper §5) only has to produce the same
    log-score interface.
    """

    sigma_m: float = 15.0
    w_dist: float = 1.0
    w_pop: float = 0.25

    def log_score(self, dist_m, popularity, device="cuda"):
        d = _f32(dist_m, device)
        p = _f32(popularity, device)
        return (-self.w_dist * 0.5 * (d / self.sigma_m) ** 2
                + self.w_pop * torch.log1p(p))


def snap_points(px, py, cand_x, cand_y, cand_pop, meters_per_unit: float,
                model: SnapModel | None = None,
                max_dist_m: float = 100.0,
                device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Snap each noisy point to the best candidate POI.

    Returns (candidate index per point, log-score); index −1 where no
    candidate is within ``max_dist_m``.
    """
    model = model or SnapModel()

    def meters(a):
        return _f32(np.asarray(a, dtype=np.float64) * meters_per_unit,
                    device)

    px, py, cx, cy = meters(px), meters(py), meters(cand_x), meters(cand_y)
    pop = _f32(cand_pop, device)
    d = torch.sqrt((px[:, None] - cx[None, :]) ** 2
                   + (py[:, None] - cy[None, :]) ** 2)      # [P, C] meters
    score = model.log_score(d, pop[None, :], device)
    score = torch.where(d <= max_dist_m, score,
                        torch.full_like(score, -torch.inf))
    best = torch.argmax(score, dim=1)
    best_score = torch.amax(score, dim=1)
    best = torch.where(torch.isfinite(best_score), best,
                       torch.full_like(best, -1))
    return best.cpu().numpy(), best_score.cpu().numpy()


def snap_path(px, py, seg_ax, seg_ay, seg_bx, seg_by, seg_pop,
              meters_per_unit: float, model: SnapModel | None = None,
              transition_scale_m: float = 50.0,
              device="cuda") -> np.ndarray:
    """Map-match a noisy trace to road segments (paper Fig. 6).

    HMM over (waypoint × segment): emission = Gaussian distance likelihood ×
    popularity prior; transition penalizes hopping between far-apart
    segments.  Viterbi carries an [S]-state value vector over the
    waypoints — O(T·S²) on the device.

    Returns the best segment index per waypoint.
    """
    model = model or SnapModel()
    mpu = meters_per_unit
    # Emission distances: waypoints × segments, meters (host, float64).
    d = point_segment_dist(
        np.asarray(px, dtype=np.float64)[:, None],
        np.asarray(py, dtype=np.float64)[:, None],
        np.asarray(seg_ax, dtype=np.float64)[None, :],
        np.asarray(seg_ay, dtype=np.float64)[None, :],
        np.asarray(seg_bx, dtype=np.float64)[None, :],
        np.asarray(seg_by, dtype=np.float64)[None, :]) * mpu
    emit = model.log_score(d, np.asarray(seg_pop)[None, :], device)  # [T,S]

    # Transition: distance between segment midpoints.
    mx = (np.asarray(seg_ax, dtype=np.float64)
          + np.asarray(seg_bx, dtype=np.float64)) / 2 * mpu
    my = (np.asarray(seg_ay, dtype=np.float64)
          + np.asarray(seg_by, dtype=np.float64)) / 2 * mpu
    hop = np.hypot(mx[:, None] - mx[None, :], my[:, None] - my[None, :])
    trans = _f32(-hop / transition_scale_m, device)                 # [S,S]

    T = emit.shape[0]
    val = emit[0]                      # best log-prob ending in each state
    back = torch.empty((max(T - 1, 0), emit.shape[1]), dtype=torch.int64,
                       device=emit.device)
    for t in range(1, T):
        cand = val[:, None] + trans                                 # [S,S]
        best_prev = torch.argmax(cand, dim=0)                       # [S]
        back[t - 1] = best_prev
        val = cand.gather(0, best_prev[None])[0] + emit[t]
    back = back.cpu().numpy()                                       # [T-1,S]
    out = np.zeros(T, dtype=np.int64)
    out[-1] = int(torch.argmax(val))
    for t in range(T - 2, -1, -1):
        out[t] = back[t, out[t + 1]]
    return out
