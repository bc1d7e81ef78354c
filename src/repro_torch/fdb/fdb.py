"""FDb: sharded, column-first, indexed storage for nested records (§4.1).

An :class:`FDb` is a manifest + N shards.  Each shard holds (a) data columns
grouped by column set and (b) the indices declared by field options on the
schema.  Index construction honours the paper's machinery:

  * a field may carry multiple indices of different kinds,
  * *virtual fields* (``Field.virtual`` = callable over the shard's columns)
    are indexed but never materialized as data,
  * ``location`` indices read companion lat/lng leaves; ``area`` indices
    expand each doc's polyline into a strip (width_m) or point into a circle
    (radius_m) and post into level-``level`` area-tree cells,
  * ``spacetime`` indices post every track point (lat/lng/t leaves) into
    (area-tree cell × time bucket) keys — the Tesseract trip index
    (:mod:`repro_torch.tess.index`).

Storage is a directory of ``.npz`` shard files + a JSON manifest — the
"simple key-value storage abstraction" of the paper (SSTable/LevelDb there,
npz here); read-only after ingest, like the paper's ingested datasets.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..geo import mercator as Mc
from ..geo.areatree import AreaTree
from .columnar import Column, ColumnBatch
from .index import (AreaIndex, LocationIndex, RangeIndex, TagIndex,
                    bitmap_full)
from .schema import MESSAGE, STRING, Schema

__all__ = ["FDb", "Shard", "build_fdb"]


@dataclass
class Shard:
    batch: ColumnBatch
    indexes: Dict[Tuple[str, str], object] = dc_field(default_factory=dict)
    # valid-doc bitmap, built once: a stable array identity lets the torch
    # backend keep it device-resident across queries (exec.device_cache)
    _all_bm: Optional[np.ndarray] = dc_field(default=None, repr=False,
                                             compare=False)

    @property
    def n(self) -> int:
        return self.batch.n

    def all_bitmap(self) -> np.ndarray:
        if self._all_bm is None:
            self._all_bm = bitmap_full(self.n)
        return self._all_bm

    def index(self, path: str, kind: str):
        return self.indexes.get((path, kind))


def _virtual_or_column(shard_batch: ColumnBatch, path: str, f) -> Tuple:
    """Returns (values, row_splits, vocab) for a leaf or virtual field."""
    if f.virtual is not None:
        raw = {p: c for p, c in shard_batch.columns.items()}
        vals = np.asarray(f.virtual(raw))
        return vals, None, None
    col = shard_batch[path]
    return col.values, col.row_splits, col.vocab


def _build_shard_indexes(schema: Schema, batch: ColumnBatch
                         ) -> Dict[Tuple[str, str], object]:
    out: Dict[Tuple[str, str], object] = {}
    n = batch.n
    for path, f in schema.indexed_paths():
        for kind in f.indexes:
            p = dict(f.index_params)
            if kind == "tag":
                vals, splits, vocab = _virtual_or_column(batch, path, f)
                out[(path, kind)] = TagIndex.build(vals, n, splits, vocab)
            elif kind == "range":
                vals, splits, _ = _virtual_or_column(batch, path, f)
                out[(path, kind)] = RangeIndex.build(vals, n, splits)
            elif kind == "location":
                lat_p = p.get("lat", path + ".lat")
                lng_p = p.get("lng", path + ".lng")
                lat, lng = batch[lat_p], batch[lng_p]
                out[(path, kind)] = LocationIndex.build(
                    lat.values, lng.values, n, lat.row_splits)
            elif kind == "area":
                lat_p = p.get("lat", path + ".lat")
                lng_p = p.get("lng", path + ".lng")
                level = int(p.get("level", 6))
                width_m = float(p.get("width_m", 20.0))
                lat, lng = batch[lat_p], batch[lng_p]
                areas: List[AreaTree] = []
                if lat.row_splits is None:   # points -> circles
                    ix, iy = Mc.latlng_to_xy(lat.values, lng.values)
                    for i in range(n):
                        mpu = float(Mc.meters_per_unit_at(lat.values[i]))
                        areas.append(AreaTree.from_circle(
                            int(ix[i]), int(iy[i]), width_m / mpu,
                            max_level=level))
                else:                         # polylines -> strips
                    ix, iy = Mc.latlng_to_xy(lat.values, lng.values)
                    sp = lat.row_splits
                    for i in range(n):
                        s, e = int(sp[i]), int(sp[i + 1])
                        if e == s:
                            areas.append(AreaTree.empty())
                            continue
                        mpu = float(Mc.meters_per_unit_at(lat.values[s]))
                        areas.append(AreaTree.from_path(
                            ix[s:e].astype(np.float64),
                            iy[s:e].astype(np.float64),
                            width_m / mpu, max_level=level))
                out[(path, kind)] = AreaIndex.build(areas, level)
            elif kind == "spacetime":
                # (cell × time-bucket) postings over a repeated track —
                # lazy import: tess sits above fdb in the layer order
                from ..tess.index import SpaceTimeIndex
                lat = batch[p.get("lat", path + ".lat")]
                lng = batch[p.get("lng", path + ".lng")]
                tt = batch[p.get("t", path + ".t")]
                out[(path, kind)] = SpaceTimeIndex.build(
                    lat.values, lng.values, tt.values, n, lat.row_splits,
                    level=int(p.get("level", 6)),
                    bucket_s=float(p.get("bucket_s", 900.0)),
                    epoch=float(p.get("epoch", 0.0)))
            else:  # pragma: no cover
                raise ValueError(f"unknown index kind {kind!r}")
    return out


class FDb:
    """A named, sharded, indexed dataset."""

    def __init__(self, name: str, schema: Schema, shards: List[Shard]):
        self.name = name
        self.schema = schema
        self.shards = shards

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def num_docs(self) -> int:
        return sum(s.n for s in self.shards)

    def nbytes(self) -> int:
        return sum(s.batch.nbytes() for s in self.shards)

    # ----------------------------------------------------------------- save
    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        manifest = {
            "name": self.name,
            "schema": self.schema.spec_json(),
            "num_shards": self.num_shards,
            "rows": [s.n for s in self.shards],
        }
        with open(os.path.join(directory, "MANIFEST.json"), "w") as fh:
            json.dump(manifest, fh, indent=1)
        for i, shard in enumerate(self.shards):
            arrays: Dict[str, np.ndarray] = {}
            for p, c in shard.batch.columns.items():
                arrays[f"col/{p}/values"] = c.values
                if c.row_splits is not None:
                    arrays[f"col/{p}/splits"] = c.row_splits
                if c.vocab is not None:
                    arrays[f"col/{p}/vocab"] = np.array(c.vocab, dtype="U")
            arrays["__n__"] = np.array([shard.n], dtype=np.int64)
            np.savez_compressed(
                os.path.join(directory, f"shard-{i:05d}.npz"), **arrays)

    @staticmethod
    def load(directory: str, schema: Optional[Schema] = None) -> "FDb":
        """Load a saved FDb; pass ``schema`` to restore virtual-field indices
        (callables are not serializable — the paper registers structures with
        the Structure manager for the same reason)."""
        with open(os.path.join(directory, "MANIFEST.json")) as fh:
            manifest = json.load(fh)
        if schema is None:
            schema = Schema.from_spec_json(manifest["schema"])
        shards: List[Shard] = []
        for i in range(manifest["num_shards"]):
            with np.load(os.path.join(directory, f"shard-{i:05d}.npz")) as z:
                n = int(z["__n__"][0])
                cols: Dict[str, Column] = {}
                paths = {k.split("/")[1] for k in z.files if k.startswith("col/")}
                for p in paths:
                    vals = z[f"col/{p}/values"]
                    splits = z.get(f"col/{p}/splits")
                    vocab_a = z.get(f"col/{p}/vocab")
                    vocab = list(vocab_a) if vocab_a is not None else None
                    cols[p] = Column(vals, splits, vocab)
            batch = ColumnBatch(schema, cols, n)
            shards.append(Shard(batch, _build_shard_indexes(schema, batch)))
        return FDb(manifest["name"], schema, shards)

    def __repr__(self):
        return (f"FDb({self.name!r}, shards={self.num_shards}, "
                f"docs={self.num_docs}, {self.nbytes()/1e6:.1f} MB)")


def build_fdb(name: str, schema: Schema, records: Sequence[dict],
              num_shards: int = 8,
              shard_key: Optional[Callable[[dict], int]] = None) -> FDb:
    """Ingest records → sharded, indexed FDb.

    ``shard_key`` maps a record to an integer (hashed onto shards); default
    is round-robin, which balances shard sizes — the paper's sampling trick
    (run on a subset of shards) then yields an unbiased sample.
    """
    buckets: List[List[dict]] = [[] for _ in range(num_shards)]
    for i, r in enumerate(records):
        k = (shard_key(r) % num_shards) if shard_key else (i % num_shards)
        buckets[k].append(r)
    shards = []
    for bucket in buckets:
        batch = ColumnBatch.from_records(schema, bucket)
        shards.append(Shard(batch, _build_shard_indexes(schema, batch)))
    return FDb(name, schema, shards)


# -- Schema JSON round-trip (save/load support) ------------------------------
# Serializes the full field tree *including index annotations* so a loaded
# FDb rebuilds its indices; virtual-field callables are the one thing that
# cannot round-trip through JSON (pass the schema to FDb.load for those).

def _field_to_json(f) -> dict:
    return {"name": f.name, "type": f.type, "repeated": f.repeated,
            "indexes": list(f.indexes), "column_set": f.column_set,
            "index_params": f.index_params, "virtual": f.virtual is not None,
            "fields": [_field_to_json(s) for s in f.fields]}


def _field_from_json(d) -> "Field":
    from .schema import Field
    return Field(d["name"], d["type"], d["repeated"],
                 [_field_from_json(s) for s in d["fields"]],
                 tuple(ix for ix in d["indexes"] if not d["virtual"]),
                 d["column_set"], None, d["index_params"])


def _schema_spec_json(self: Schema) -> dict:
    return {"name": self.name,
            "fields": [_field_to_json(f) for f in self.fields]}


def _schema_from_spec_json(spec: dict) -> Schema:
    return Schema(spec["name"],
                  [_field_from_json(f) for f in spec["fields"]])


Schema.spec_json = _schema_spec_json
Schema.from_spec_json = staticmethod(_schema_from_spec_json)
