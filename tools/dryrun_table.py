#!/usr/bin/env python3
"""The dry-run sweep as a markdown table: a row an architecture, a column
a shape, each cell the single-pod and the multi-pod mesh.

    PYTHONPATH=src python3 tools/dryrun_table.py [OUT_DIR]

Reads the records ``python -m repro_torch.launch.dryrun`` wrote to
OUT_DIR (default ``runs/dryrun_torch``) for every ``list_archs()`` entry ×
``shape_cells`` × {16x16, 2x16x16}.  Each mesh: the seconds the step took
on fake tensors (``lower_s``), the peak GiB a rank (marked ``!`` above
80 GB, an H100's memory) and the collective MiB a rank by kind
(all-gather / all-reduce / reduce-scatter / all-to-all).  A cell without a
record reads "no record" (it failed or did not finish); "–" is a shape the
architecture does not run.
"""
from __future__ import annotations

import json
import os
import sys

from repro_torch.configs.base import SHAPES, get_config, list_archs, shape_cells

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
CARD_BYTES = 80e9


def _cell(path):
    if not os.path.exists(path):
        return "no record"
    with open(path) as fh:
        rec = json.load(fh)
    peak = rec["memory"]["peak_bytes"]
    mark = "!" if peak > CARD_BYTES else ""
    per = rec["collectives"]["per_kind"]
    coll = "/".join(f"{per[k]['bytes'] / 2**20:.0f}" for k in KINDS)
    return f"{rec['lower_s']:.1f} s, {peak / 2**30:.2f}{mark}, {coll}"


def main(out_dir: str = "runs/dryrun_torch") -> None:
    shapes = list(SHAPES)
    print("| arch | " + " | ".join(shapes) + " |")
    print("|---" * (len(shapes) + 1) + "|")
    for arch in list_archs():
        cells = {s.name for s in shape_cells(get_config(arch))}
        row = []
        for name in shapes:
            if name not in cells:
                row.append("–")
                continue
            row.append(" · ".join(_cell(os.path.join(
                out_dir, f"{arch}-{name}-{tag}.json"))
                for tag in ("pod", "multipod")))
        print(f"| {arch} | " + " | ".join(row) + " |")


if __name__ == "__main__":
    main(*sys.argv[1:2])
