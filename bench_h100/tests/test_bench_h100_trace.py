"""The traced run's reduction: busy time is the union of the device's
intervals, so overlapping streams count once and the idle share never
reads below 0; gaps are named by what the host ran."""
from types import SimpleNamespace

import pytest

from bench_h100_tiny import ROOT  # noqa: F401  (paths)
from bench_h100.harness.trace import Trace, breakdown, gaps, union_ns
from bench_h100.harness.spec import metric_reader


def test_union_of_overlapping_intervals():
    assert union_ns([(0, 10), (5, 15), (20, 30)], (0, 100)) == 25
    assert union_ns([(0, 10), (0, 10), (2, 3)], (0, 100)) == 10
    assert union_ns([(-5, 5), (95, 105)], (0, 100)) == 10
    assert union_ns([], (0, 100)) == 0
    assert gaps([(10, 20), (15, 30), (50, 60)], (0, 100)) == [
        (0, 10), (30, 50), (60, 100)]


def _run(trace):
    return SimpleNamespace(trace=trace,
                           driver=SimpleNamespace(kind="serve"))


def test_idle_share_never_below_zero():
    # three streams busy at once over the whole window: summing the
    # kernels would count 3x the window (an idle share of -200%)
    dev = [("k", 0, 1000, 0), ("k", 0, 1000, 0), ("k", 0, 1000, 0)]
    tr = Trace(window=(0, 1000), device=dev)
    assert tr.busy_s() == pytest.approx(1e-6)
    idle = metric_reader("device_idle.serve")(_run(tr))
    assert idle == pytest.approx(0.0)
    tr = Trace(window=(0, 1000), device=[("k", 100, 300, 0),
                                         ("k", 200, 400, 0)])
    assert metric_reader("device_idle.serve")(_run(tr)) == pytest.approx(70)


def test_nothing_to_read_gives_no_number():
    assert metric_reader("device_idle.serve")(_run(None)) is None
    tr = Trace(window=(0, 1000))
    assert metric_reader("device_idle.serve")(_run(tr)) is None


def test_breakdown_names_gaps_by_the_host():
    tr = Trace(window=(0, 1000),
               device=[("gemm", 0, 400, 0), ("scan", 600, 680, 0),
                       ("gemm", 900, 1000, 0)],
               spans=[("decode", 350, 1000)],
               host=[("aten::argmax", 420, 640), ("aten::item", 700, 950)])
    b = breakdown(tr)
    assert b["device_ops"][0] == ["gemm", pytest.approx(5e-7)]
    assert b["idle_gaps"][0] == ["decode / aten::item", pytest.approx(2.2e-7)]
    assert b["idle_gaps"][1] == ["decode / aten::argmax",
                                 pytest.approx(2e-7)]
