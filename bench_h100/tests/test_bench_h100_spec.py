"""The benchmark finds every cell's pieces by name, and BENCHMARK.json
keeps to the shape the benchmark's runs rely on."""
import json
import re

import pytest

from bench_h100_tiny import ROOT
from bench_h100.harness import spec
from bench_h100.harness.model import dims, mesh_shape

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    c = spec.cell(name, BENCH)
    data, model = mesh_shape(c.config)      # one card a rank of its mesh
    assert c.chips == data * model and c.chips in (1, 4)
    assert c.traffic["kind"] in ("serve", "train")
    assert dims(c.config).layers == c.config["num_hidden_layers"]
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no_such.cell", BENCH)


def test_names_units_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"])
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        owner = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(owner.get("workloads", CELLS))
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
