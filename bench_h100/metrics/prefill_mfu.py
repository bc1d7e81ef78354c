"""The prefill's share of the cards' bf16 peak: the FLOPs of the useful
(unpadded) prompt tokens, each request alone by the benchmark's formula
(the whole model's, on a mesh too), over the prefill spans' time
(synchronised; the traced run's half with the profiler off) times the
cards the cell runs on, in %."""
from bench_h100.harness import flops as F
from bench_h100.harness.model import dims


def read(run):
    rec = run.driver.rec
    spans = rec.spans_of("prefill", profiled=False)
    batches = [b for b in rec.batches if not b["profiled"]]
    if run.trace is None or not spans or len(spans) != len(batches):
        return None
    dm = dims(run.cell.config)
    work = sum(F.prefill_flops(dm, len(p)) for b in batches
               for p in b["prompts"])
    t = sum(t1 - t0 for _, t0, t1, _ in spans)
    return 100.0 * work / (t * run.cell.chips * F.PEAK_BF16_FLOPS)
