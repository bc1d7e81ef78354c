"""The train step's share of the card's bf16 peak: forward and backward
FLOPs by the benchmark's formula (3x the forward, recomputation not
counted) over the step spans' time (synchronised; the traced run's half
with the profiler off), in %."""
from bench_h100.harness import flops as F
from bench_h100.harness.model import dims


def read(run):
    d = run.driver
    if run.trace is None or getattr(d, "kind", None) != "train":
        return None
    spans = d.rec.spans_of("step", profiled=False)
    if not spans:
        return None
    work = len(spans) * F.train_flops(dims(run.cell.config), d.batch, d.seq)
    t = sum(t1 - t0 for _, t0, t1, _ in spans)
    return 100.0 * work / (t * F.PEAK_BF16_FLOPS)
