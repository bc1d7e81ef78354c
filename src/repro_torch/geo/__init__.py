"""Geospatial substrate: integer Mercator, 64-way area trees, de-noising."""
from . import mercator
from .areatree import AreaTree, cover, OUT, PARTIAL, FULL
from .geometry import (Box, haversine_m, mercator_dist_m, polyline_length_m,
                       point_segment_dist, bbox_of)
from .denoise import prob_location, prob_path, snap_points, snap_path, SnapModel

__all__ = [
    "mercator", "AreaTree", "cover", "OUT", "PARTIAL", "FULL",
    "Box", "haversine_m", "mercator_dist_m", "polyline_length_m",
    "point_segment_dist", "bbox_of",
    "prob_location", "prob_path", "snap_points", "snap_path", "SnapModel",
]
