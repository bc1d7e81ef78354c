"""FDb: column-first indexed storage for nested records (paper §4.1)."""
from .schema import (Schema, Field, BOOL, INT, UINT, FLOAT, DOUBLE, STRING,
                     MESSAGE)
from .columnar import Column, ColumnBatch
from .index import (TagIndex, RangeIndex, LocationIndex, AreaIndex,
                    bitmap_zeros, bitmap_full, bitmap_from_ids,
                    ids_from_bitmap, bitmap_count)
from .fdb import FDb, Shard, build_fdb
from .streaming import StreamingFDb

__all__ = [
    "Schema", "Field", "BOOL", "INT", "UINT", "FLOAT", "DOUBLE", "STRING",
    "MESSAGE", "Column", "ColumnBatch", "TagIndex", "RangeIndex",
    "LocationIndex", "AreaIndex", "bitmap_zeros", "bitmap_full",
    "bitmap_from_ids", "ids_from_bitmap", "bitmap_count",
    "FDb", "Shard", "build_fdb", "StreamingFDb",
]
