"""Geospatial substrate: integer Mercator and 64-way area trees.

(``geometry`` and ``denoise`` are not ported yet: ROADMAP.md, queue A
item A10.)"""
from . import mercator
from .areatree import AreaTree, cover, OUT, PARTIAL, FULL

__all__ = ["mercator", "AreaTree", "cover", "OUT", "PARTIAL", "FULL"]
