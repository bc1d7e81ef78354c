"""Row 10's share of its roofline: the least time its calls could take
(each traced prefill's Mamba layers, one float32 scan a chunk) over the device
time of the ``ssm_scan_kernel`` records in the trace, in %."""
from bench_h100.harness import flops as F
from bench_h100.harness.model import dims


def read(run):
    tr = run.trace
    if tr is None:
        return None
    ks = [k for k in tr.device if "ssm_scan_kernel" in k[0]]
    spans = run.driver.rec.spans_of("prefill", profiled=True)
    if not ks or not spans:
        return None
    dm = dims(run.cell.config)
    bound = sum(F.mamba_layers(dm) * F.ssm_scan_bound_s(dm, m["batch"],
                                                        m["seq"])
                for _, _, _, m in spans)
    return 100.0 * bound / (sum(b - a for _, a, b, _ in ks) / 1e9)
