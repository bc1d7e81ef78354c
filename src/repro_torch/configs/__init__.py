"""Architecture configs: one module per assigned arch + the paper's own
speed-prediction model (speed_model)."""
from .base import (ArchConfig, ShapeConfig, get_config, list_archs, SHAPES,
                   shape_cells)

__all__ = ["ArchConfig", "ShapeConfig", "get_config", "list_archs",
           "SHAPES", "shape_cells"]
