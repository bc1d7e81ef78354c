"""One run of one cell of the port's benchmark on this machine's card.

    python bench_h100/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run it from the root of a checkout.  It puts ``src`` on the path, builds
the port's kernels there on a checkout's first run (``src/repro_torch/
kernels/build``), keeps any other compiler cache under ``.bench_cache``,
makes the cell's weights and inputs from ``--seed``, warms the cell's
shapes up, measures for ``--seconds`` and checks what the window served
against the plain reference.  Its last line on standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or its per-layer ones with ``--trace 1``),
``device`` and, traced, ``breakdown``, then ``readings`` and ``checks``
(each compared number with its limit); the compared numbers are also the
last lines on standard error.  It exits non-zero and prints no result
without a CUDA card, without the port's sources, or when a module of JAX
or of the JAX package is loaded once the window has closed.

A cell on several cards (``chips`` > 1) runs in one process a card
(``harness.ranks``, NCCL), started by this one once it has built the
port's kernels; this process prints rank 0's result.  If any rank fails,
or the ranks are still running ``RANKS_LIMIT_S`` after this process
started (plus the kernels' build), every rank is stopped and the run
exits non-zero with no result.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: a run on several cards ends within this many seconds of its start
RANKS_LIMIT_S = 330


def _fail(code: int, msg: str):
    print(f"bench_h100: {msg}", file=sys.stderr)
    sys.exit(code)


def prepare() -> None:
    """The port's sources on the path and every compiler cache inside the
    checkout, at fixed paths."""
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        _fail(2, f"the port's sources are missing ({src / 'repro_torch'})")
    cache = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare()

    import torch
    from bench_h100.harness import runner, spec
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        _fail(3, f"{args.workload} needs {cell.chips} CUDA card(s); "
                 f"found {torch.cuda.device_count()}")
    if cell.chips == 1:
        out = runner.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              started=STARTED, cell=cell)
        bad = runner.forbidden_modules()
    else:
        out = on_ranks(args, cell)
        bad = sorted(set(out.pop("forbidden"))
                     | set(runner.forbidden_modules()))
    if bad:
        _fail(4, f"modules of JAX or of the JAX package are loaded: {bad}")
    for key, c in out["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def on_ranks(args, cell) -> dict:
    """Rank 0's result of the run on ``cell.chips`` cards."""
    from bench_h100.harness import ranks, runner
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()          # once, here, not in each rank
    built = time.perf_counter() - t0
    # perf_counter is the host's monotonic clock, shared by the ranks:
    # their set-up counts from this process's start
    job = {"name": args.workload, "seed": args.seed,
           "seconds": args.seconds, "traced": bool(args.trace),
           "started": STARTED, "cell": cell}
    try:
        (out,) = ranks.launch(runner.run_ranks, ([job], "nccl"), cell.chips,
                              backend="nccl",
                              deadline=STARTED + RANKS_LIMIT_S + built)
    except ranks.RanksFailed as e:
        _fail(5, str(e))
    return out


if __name__ == "__main__":
    main()
