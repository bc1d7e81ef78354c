"""The readers of the port's own spans and counters: traced at a tiny
size on the CPU each gives a number in [0, 100] in the cells that list
it and None elsewhere; on a trace with hand-placed spans the idle
readers give hand-computed shares that add up to at most the device's
idle share; and the server's own counters give the harness's padding
share and the rate's numerator."""
from types import SimpleNamespace

import pytest
import torch

from bench_h100_tiny import tiny_cell
from bench_h100.harness import runner
from bench_h100.harness.program import merged, minus, overlap_ns
from bench_h100.harness.serve import ServeRun
from bench_h100.harness.spec import benchmark, metric_reader
from bench_h100.harness.trace import Trace

READERS = ("prefill_attn_share", "prefill_mlp_share", "prefill_mamba_share",
           "prefill_moe_share", "moe_slot_use", "decode_idle", "batch_idle")
KINDS = ("prefill_attn_share", "prefill_mlp_share", "prefill_mamba_share",
         "prefill_moe_share")
CELLS = [w["name"] for w in benchmark()["workloads"]]
LISTED = {m["name"]: m["workloads"] for m in benchmark()["per_layer"]
          if m["name"] in READERS}


def _traced(name, seed=2 ** 31 + 7, seconds=0.6):
    """A traced window of the tiny cell, as ``runner.run_cell`` makes it
    → the run its readers see."""
    from repro_torch import tracing
    from torch.profiler import ProfilerActivity, profile
    tracing.clear()
    c = tiny_cell(name)
    dev = torch.device("cpu")
    driver = runner.KINDS[c.traffic["kind"]](c, seed, dev, True)
    driver.setup()
    prof, traces = profile(activities=[ProfilerActivity.CPU]), []

    def stop():
        prof.stop()
        traces.append(runner.reduce(prof))
    driver.rec.stop_trace = stop
    prof.start()
    driver.window(seconds)
    return runner.Run(cell=c, driver=driver, setup_s=0.0,
                      window_s=driver.window_s, trace=traces[0])


@pytest.fixture(scope="module")
def readings():
    out = {}
    for name in CELLS:
        run = _traced(name)
        out[name] = {m: metric_reader(m)(run) for m in
                     READERS + ("device_idle.serve",)}
    from repro_torch import tracing
    tracing.clear()
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_each_reader_reads_where_it_is_listed(readings, cell):
    got = readings[cell]
    for m in READERS:
        if cell in LISTED[m]:
            assert got[m] is not None and 0 <= got[m] <= 100, (m, got[m])
        else:
            assert got[m] is None, (m, got[m])
    shares = [got[m] for m in KINDS if got[m] is not None]
    assert sum(shares) <= 100


def test_the_jamba_column_uses_its_slots(readings):
    got = readings["jamba_v0_1_8of32.column"]
    # capacity 1.25 × the assignments: at most 80% of the slots are used
    assert 0 < got["moe_slot_use"] <= 80


def _rec(i, name, parent, t0, t1):
    return SimpleNamespace(index=i, name=name, parent=parent, t0=t0, t1=t1,
                           device_ns=t1 - t0)


def _hand_run(recs, device):
    tr = Trace(window=(0, 1000), device=[("k", a, b, 0) for a, b in device])
    srv = SimpleNamespace(tracing=SimpleNamespace(records=lambda: recs))
    return SimpleNamespace(trace=tr, driver=SimpleNamespace(
        kind="serve", srv=srv, device=torch.device("cuda")))


def test_idle_shares_by_hand():
    # the card busy over [0, 100), [150, 300), [400, 420), [700, 1000):
    # idle over [100, 150), [300, 400), [420, 700) - 43% of the window
    busy = [(0, 100), (150, 300), (400, 420), (700, 1000)]
    recs = [_rec(0, "batch", None, 50, 900),
            _rec(1, "prefill", 0, 60, 200),
            _rec(2, "decode", 0, 250, 350),
            _rec(3, "decode", 0, 450, 600),
            _rec(4, "batch", None, 1100, 1200)]   # outside the window
    run = _hand_run(recs, busy)
    idle = metric_reader("device_idle.serve")(run)
    dec = metric_reader("decode_idle")(run)
    bat = metric_reader("batch_idle")(run)
    assert idle == pytest.approx(43)
    # decode: [300, 350) and [450, 600)
    assert dec == pytest.approx(20)
    # the batch outside its children: [50, 60), [200, 250), [350, 450),
    # [600, 900); idle in [350, 400), [420, 450), [600, 700)
    assert bat == pytest.approx(18)
    assert dec + bat <= idle + 1e-9
    # no trace, or a card run whose trace holds no device record
    assert metric_reader("decode_idle")(_hand_run(recs, [])) is None
    run.trace = None
    assert metric_reader("decode_idle")(run) is None


def test_kind_shares_by_hand():
    recs = [_rec(0, "prefill", None, 0, 400),
            _rec(1, "attn", 0, 10, 110), _rec(2, "mlp", 0, 110, 160),
            _rec(3, "prefill", None, 500, 600),
            _rec(4, "attn", 3, 500, 540),
            _rec(5, "decode", None, 700, 800),
            _rec(6, "attn", 5, 700, 790)]          # not in a prefill
    run = _hand_run(recs, [(0, 1000)])
    assert metric_reader("prefill_attn_share")(run) == pytest.approx(28)
    assert metric_reader("prefill_mlp_share")(run) == pytest.approx(10)
    assert metric_reader("prefill_mamba_share")(run) is None


def test_interval_helpers():
    assert merged([(5, 8), (0, 3), (2, 4), (9, 9)]) == [(0, 4), (5, 8)]
    assert minus([(0, 10), (20, 30)], [(2, 4), (8, 22), (25, 26)]) == [
        (0, 2), (4, 8), (22, 25), (26, 30)]
    assert minus([(0, 10)], []) == [(0, 10)]
    assert overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10


def test_server_counters_give_the_harness_numbers():
    """Over the window's calls the server's own counters give the
    harness's padding share exactly, and its prompt and kept tokens the
    rate's numerator."""
    run = ServeRun(tiny_cell("smollm_360m.column"), 11, torch.device("cpu"),
                   False)
    run.setup()
    before = dict(run.srv.stats)
    run.window(0.4)
    d = {k: run.srv.stats[k] - before[k] for k in before}
    seen = SimpleNamespace(driver=run, window_s=run.window_s, trace=None)
    harness = metric_reader("pad_share")(seen)
    assert 100.0 * d["padded_positions"] / (
        d["padded_positions"] + d["prompt_tokens"]) == harness
    kept = sum(r["prompt"] + r["out"] for r in run.requests if r["done"])
    assert d["prompt_tokens"] + d["tokens_out"] == kept
    assert kept == pytest.approx(
        metric_reader("tokens_per_s")(seen) * run.window_s)
    assert d["prefills"] == len(run.rec.batches)
