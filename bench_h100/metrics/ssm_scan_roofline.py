"""The fused selective scan's share of its roofline
(``kernels.selective_scan``, one launch a Mamba layer's prefill; row 10
is off the path): the least time its calls could take (each traced
prefill's Mamba layers at the shapes one card computes: its share of
d_inner's channels on a mesh) over the device time of the
``selective_scan_kernel`` records in the trace (rank 0's on a mesh), in
%."""
from bench_h100.harness import flops as F
from bench_h100.harness.model import dims, mesh_shape, rows_on_card


def read(run):
    tr = run.trace
    if tr is None:
        return None
    ks = [k for k in tr.device if "selective_scan_kernel" in k[0]]
    spans = run.driver.rec.spans_of("prefill", profiled=True)
    if not ks or not spans:
        return None
    dm = dims(run.cell.config)
    data, model = mesh_shape(run.cell.config)
    bound = sum(F.mamba_layers(dm) * F.selective_scan_bound_s(
        dm, rows_on_card(m["batch"], data), m["seq"], dm.di // model)
        for _, _, _, m in spans)
    return 100.0 * bound / (sum(b - a for _, a, b, _ in ks) / 1e9)
