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
neither option is a sound run.  The benchmark's runs never run this.
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
    import torch
    from bench_h100.harness import runner, spec
    if args.train_fault:
        _half_batch()
    passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = spec.cell(args.workload)
        if args.train_param_dtype:
            cell.traffic = dict(cell.traffic, train=dict(
                cell.traffic["train"], param_dtype=args.train_param_dtype))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = runner.run_cell(args.workload, seed, args.seconds, False,
                              device="cuda", control=True, cell=cell)
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0,
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
