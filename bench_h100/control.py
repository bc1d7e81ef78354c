"""The correctness check's two readings on the card, several seeds in one
process: the port's numbers and the control's (the reference computed in
float8 e4m3 for a served cell; the program's own bf16-parameter path for
a training cell).  The control takes the program's place in the
benchmark's own comparison, so each of its runs has to come out not
correct; the script exits 1 where one does not.

    python bench_h100/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 5 [--train-param-dtype bfloat16] [--train-fault half]

``--train-fault half`` plants a fault in the program's train step: each
step sees the first half of its batch, the mean taken over those rows.
Each seed is a whole run (set-up, a short window at the cell's load, the
check); one JSON line a seed, the port's own numbers of a served cell
under ``readings`` as ``program_<number>``.  A training cell run with
neither option is a sound run.  A cell on several cards runs every seed
in one start of its ranks (``harness.ranks``).  The benchmark's runs
never run this.
"""
import argparse
import json
import sys
import time

from run import prepare


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--train-param-dtype", default=None)
    ap.add_argument("--train-fault", choices=("half",), default=None)
    args = ap.parse_args()
    prepare()
    from bench_h100.harness import spec
    if args.train_fault:
        _half_batch()
    passed = []
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, seconds, out in _runs(args, seeds):
        print(json.dumps({"seed": seed, "seconds": seconds,
                          "correct": out["correct"],
                          "metrics": out["metrics"],
                          "memory_peak_bytes":
                              out["device"]["memory_peak_bytes"],
                          "readings": out["readings"],
                          "checks": out["checks"]}), flush=True)
        if out["correct"]:
            passed.append(seed)
    controlled = spec.cell(args.workload).traffic["kind"] == "serve" \
        or args.train_param_dtype or args.train_fault
    if controlled and passed:
        print(f"control: seeds {passed} came out correct", file=sys.stderr)
        sys.exit(1)


def _runs(args, seeds):
    """(seed, seconds, result) of each seed's run with the control."""
    import torch
    from bench_h100.harness import runner, spec
    cell = spec.cell(args.workload)
    if cell.chips > 1:
        from bench_h100.harness import ranks
        from repro_torch.kernels import _build
        _build.build_all()
        jobs = [{"name": args.workload, "seed": seed,
                 "seconds": args.seconds, "traced": False, "control": True,
                 "cell": cell} for seed in seeds]
        t0 = time.perf_counter()
        outs = ranks.launch(runner.run_ranks, (jobs, "nccl"), cell.chips,
                            backend="nccl",
                            deadline=t0 + 330 * len(seeds))
        each = (time.perf_counter() - t0) / len(seeds)
        for seed, out in zip(seeds, outs):
            out.pop("forbidden")
            yield seed, each, out
        return
    for seed in seeds:
        cell = spec.cell(args.workload)
        if args.train_param_dtype:
            cell.traffic = dict(cell.traffic, train=dict(
                cell.traffic["train"], param_dtype=args.train_param_dtype))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = runner.run_cell(args.workload, seed, args.seconds, False,
                              device="cuda", control=True, cell=cell)
        yield seed, time.perf_counter() - t0, out


def _half_batch() -> None:
    from repro_torch.ml.model import ModelBundle
    real = ModelBundle.make_train_step

    def make_train_step(self):
        step = real(self)

        def half(params, opt, batch):
            n = batch["tokens"].shape[0] // 2
            return step(params, opt, {k: v[:n] for k, v in batch.items()})
        return half
    ModelBundle.make_train_step = make_train_step


if __name__ == "__main__":
    main()
