"""Nothing a run of the benchmark loads is JAX or the JAX package
(``repro``), compared by whole top-level names, and the references take
nothing of the port; the command refuses to run without a card or
without the port's sources, and then prints no result."""
import ast
import json
import os
import shutil
import subprocess
import sys

from bench_h100_tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

RUN_TINY = """
import json, sys
sys.path[:0] = [{root!r}, {tests!r}, {src!r}]
from bench_h100_tiny import tiny_cell
from bench_h100.harness import runner
for name in ("jamba_v0_1_8of32.column", "smollm_360m.train"):
    c = tiny_cell(name)
    runner.run_cell(name, 7, 0.2, True, device="cpu", cell=c)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _python(code, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_run_loads_no_jax():
    out = _python(RUN_TINY.format(root=str(ROOT),
                                  tests=str(ROOT / "bench_h100" / "tests"),
                                  src=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in names           # the port ran ...
    assert not names & FORBIDDEN            # ... and nothing of JAX


def test_the_references_take_nothing_of_the_port():
    for path in (ROOT / "bench_h100" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in FORBIDDEN | {"repro_torch"}, \
                    (path.name, m)
    out = _python(f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
                  "import bench_h100.reference.lm, bench_h100.reference.train;"
                  " print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert out.returncode == 0, out.stderr
    assert "repro_torch" not in out.stdout and "'repro'" not in out.stdout


def _command(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload",
         "smollm_360m.column", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench_h100", tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
