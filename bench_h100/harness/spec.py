"""Find a cell and everything that belongs to it by name.

A cell ``<config>.<traffic>`` is an entry of ``BENCHMARK.json``'s
``workloads``.  Its pieces are files of their own:

* ``configs/<config>.json``: the model as it is run (the source's keys),
  what was cut from the source (``reduced``) and the deployment it stands
  for;
* ``traffic/<traffic>.json``: the parameters of the traffic mix that the
  general generator (``harness.traffic``) reads, with its ``kind`` (the
  loop that drives the entry point);
* ``cells/<cell>.json``: the cell's own parameters over the mix's (such as
  ``max_batch``) and the limits of its correctness check;
* ``metrics/<metric>.py``: the reader of one metric.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _load_json(ROOT / "BENCHMARK.json")


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    """A metric is read in a cell that its ``workloads`` lists, or, with
    no such key, in every cell that reports the metric it moves (an
    end-to-end metric with no key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def cell(name: str, bench: dict = None) -> Cell:
    bench = bench if bench is not None else benchmark()
    (w,) = [w for w in bench["workloads"] if w["name"] == name] or [None]
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = _load_json(BENCH / "configs" / f"{w['config']}.json")
    traffic = _load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    own = BENCH / "cells" / f"{name}.json"
    extra = _load_json(own) if own.exists() else {}
    limits = extra.pop("limits", {})
    traffic = {**traffic, **extra}
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, config=config, traffic=traffic, limits=limits,
                chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer)


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(run)``: the metric's value, or None
    where the run holds nothing to read."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_h100_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
