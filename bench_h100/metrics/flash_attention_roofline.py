"""Row 9's share of its roofline: the least time its calls could take
(each traced prefill's attention layers at the shapes the model hands the
kernel, padded batch and all, and on a mesh one card's share of the
query and KV heads) over the device time of the ``flash_*_kernel``
records in the trace (rank 0's on a mesh), in %."""
from bench_h100.harness import flops as F
from bench_h100.harness.model import dims, mesh_shape, on_card, rows_on_card


def read(run):
    tr = run.trace
    if tr is None:
        return None
    ks = [k for k in tr.device if "flash_" in k[0] and "_kernel" in k[0]]
    spans = run.driver.rec.spans_of("prefill", profiled=True)
    if not ks or not spans:
        return None
    dm = dims(run.cell.config)
    data, model = mesh_shape(run.cell.config)
    card = on_card(dm, model)
    bound = sum(F.attn_layers(dm) * F.flash_bound_s(
        card, rows_on_card(m["batch"], data), m["seq"])
        for _, _, _, m in spans)
    return 100.0 * bound / (sum(b - a for _, a, b, _ in ks) / 1e9)
