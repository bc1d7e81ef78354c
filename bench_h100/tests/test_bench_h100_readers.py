"""The readers of the kernels' rooflines, the prefill's share of the
peak and the collectives' share, on hand-made traces: the fused
selective scan's records (not row 10's) against its own count, one
card's share of the channels and heads on a mesh, the whole model's
FLOPs over every card's peak, NCCL's share of the prefill and decode
spans; at one card each reads what the one-card formulas give."""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_h100_tiny import ROOT
from bench_h100.harness import flops as F
from bench_h100.harness.model import dims
from bench_h100.harness.spans import Recorder
from bench_h100.harness.spec import cell, metric_reader
from bench_h100.harness.trace import Trace

ONE = cell("jamba_v0_1_8of32.column").config
MESH = json.loads((ROOT / "bench_h100/configs/jamba_v0_1_52b.json")
                  .read_text())
MS = 1_000_000                                   # ns


def _run(config, chips, device, spans, prompts=()):
    """A traced run: ``spans`` (name, t0, t1, meta) in the harness's
    records and the trace's ranges; batches of ``prompts`` lengths."""
    rec = Recorder(False, torch.device("cpu"))
    rec.spans = [(n, a / 1e9, b / 1e9, m) for n, a, b, m in spans]
    rec.batches = [{"prompts": [np.zeros(n, np.int32) for n in rows],
                    "profiled": False} for rows in prompts]
    tr = Trace(window=(0, 1000 * MS), device=device,
               spans=[(n, a, b) for n, a, b, m in spans if m["profiled"]])
    return SimpleNamespace(trace=tr, cell=SimpleNamespace(
        config=config, chips=chips), driver=SimpleNamespace(rec=rec))


def _prefill(t0, t1, profiled=True, batch=16, seq=2048):
    return ("prefill", t0, t1, {"profiled": profiled, "batch": batch,
                                "seq": seq})


def test_the_scan_roofline_reads_the_fused_kernel():
    spans = [_prefill(0, 100 * MS), _prefill(200 * MS, 300 * MS)]
    dev = [("void selective_scan_kernel<__nv_bfloat16, 16, 1>", 10 * MS,
            14 * MS, 0),
           ("void selective_scan_kernel<__nv_bfloat16, 16, 1>", 210 * MS,
            212 * MS, 0),
           ("ssm_scan_kernel", 20 * MS, 90 * MS, 0)]      # not counted
    read = metric_reader("ssm_scan_roofline")
    one = dims(ONE)
    want = 2 * 7 * F.selective_scan_bound_s(one, 16, 2048) / 6e-3
    assert read(_run(ONE, 1, dev, spans)) == pytest.approx(100 * want)
    # on the 1 x 4 mesh a card scans 2048 of the 8192 channels of each
    # of the 28 Mamba layers: 0.256 ms a layer-prefill
    full = dims(MESH)
    want = 2 * 28 * F.selective_scan_bound_s(full, 16, 2048, 2048) / 6e-3
    assert read(_run(MESH, 4, dev, spans)) == pytest.approx(100 * want)
    assert F.selective_scan_bound_s(full, 16, 2048, 2048) == pytest.approx(
        0.256e-3, rel=2e-3)
    # row 10 alone: nothing to read
    assert read(_run(ONE, 1, dev[2:], spans)) is None


def test_the_attention_roofline_counts_a_cards_heads():
    spans = [_prefill(0, 100 * MS, seq=1000)]
    dev = [("flash_fwd_kernel", 0, 2 * MS, 0)]
    read = metric_reader("flash_attention_roofline")
    one = dims(ONE)
    assert read(_run(ONE, 1, dev, spans)) == pytest.approx(
        100 * F.flash_bound_s(one, 16, 1000) / 2e-3)
    # 8 of 32 query heads and 2 of 8 KV heads a card, 4 attention layers
    fl = 4 * 16 * 8 * 128 * (1000 * 1001 // 2)
    by = 2 * 16 * 1000 * 128 * (2 * 8 + 2 * 2)
    bound = max(fl / 989e12, by / 3.35e12)
    assert read(_run(MESH, 4, dev, spans)) == pytest.approx(
        100 * 4 * bound / 2e-3)


def test_the_prefill_mfu_divides_by_every_cards_peak():
    spans = [_prefill(0, 500 * MS, profiled=False)]
    rows = [[1500, 700]]
    read = metric_reader("prefill_mfu")
    one = dims(ONE)
    work = F.prefill_flops(one, 1500) + F.prefill_flops(one, 700)
    assert read(_run(ONE, 1, [], spans, rows)) == pytest.approx(
        100 * work / (0.5 * 989e12))
    full = dims(MESH)
    work = F.prefill_flops(full, 1500) + F.prefill_flops(full, 700)
    assert read(_run(MESH, 4, [], spans, rows)) == pytest.approx(
        100 * work / (0.5 * 4 * 989e12))


def test_the_collective_share_of_prefill_and_decode():
    spans = [_prefill(0, 100 * MS),
             ("decode", 300 * MS, 400 * MS, {"profiled": True}),
             ("batch", 0, 500 * MS, {"profiled": True})]
    dev = [("gemm", 0, 60 * MS, 0),
           ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL", 60 * MS, 80 * MS, 0),
           ("nccl:all_reduce", 60 * MS, 80 * MS, 0),    # a range: once
           ("gemm", 300 * MS, 350 * MS, 0),
           ("ncclDevKernel_AllGather_RING_LL", 350 * MS, 380 * MS, 0),
           ("ncclDevKernel_AllGather_RING_LL", 450 * MS, 480 * MS, 0)]
    read = metric_reader("collective_share")
    # inside the spans: busy 80 + 80 ms, NCCL kernels 20 + 30 ms
    assert read(_run(MESH, 4, dev, spans)) == pytest.approx(100 * 50 / 160)
    # one card: no NCCL record, nothing to read
    assert read(_run(ONE, 1, [d for d in dev if "nccl" not in d[0]],
                     spans)) is None
