"""The port's spans and counters (``repro_torch.tracing``).

Off, the LM path makes no record, no CUDA event, no profiler range and
no synchronisation; under ``torch.profiler`` (or after ``on()``) every
span is kept with its parent, its batch and its stamps on the
profiler's clock; the cap counts what it drops; the MoE routing's
counters equal counts taken by hand from its dispatch tensor.  One test
(marker ``cuda``) reads a span's device time from its CUDA events.  The
smoke's busy time is the union of the device records.
"""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.launch.serve import Request, Server
from repro_torch.ml import moe


@pytest.fixture(autouse=True)
def fresh():
    tracing.off()
    tracing.clear()
    yield
    tracing.off()
    tracing.clear()


@pytest.fixture(scope="module")
def jamba():
    return Server(get_config("jamba_v0_1_52b"), max_batch=4, device="cpu")


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _forbid(monkeypatch, *targets):
    def boom(*a, **k):
        raise AssertionError("created while tracing is off")
    for mod, name in targets:
        monkeypatch.setattr(mod, name, boom)


def test_off_records_nothing_and_creates_nothing(jamba, monkeypatch):
    _forbid(monkeypatch, (torch.cuda, "Event"),
            (torch.cuda, "synchronize"),
            (torch.profiler, "record_function"),
            (torch.autograd.profiler, "record_function"),
            (tracing, "Record"), (tracing, "_Span"))
    assert not tracing.active()
    outs = jamba.generate_batch(_prompts(256, [5, 9]), max_new=3)
    assert len(outs) == 2 and all(len(o) == 3 for o in outs)
    assert tracing.span("x") is tracing.span("y")      # one shared no-op
    assert tracing.records() == [] and tracing.counters() == {}


def test_recorded_under_the_profiler_only(jamba):
    from torch.profiler import ProfilerActivity, profile
    jamba.generate_batch(_prompts(256, [6]), max_new=2)
    assert tracing.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.active()
        jamba.generate_batch(_prompts(256, [6, 4]), max_new=2)
    assert not tracing.active()
    n = len(tracing.records())
    jamba.generate_batch(_prompts(256, [6]), max_new=2)
    assert len(tracing.records()) == n
    names = [r.name for r in tracing.records()]
    # 16 layers: 2 attention, 14 Mamba; MoE on every second layer
    per_pass = {"attn": 2, "mamba": 14, "moe": 8, "mlp": 8}
    for name, k in per_pass.items():
        assert names.count(name) == 2 * k, name       # prefill + 1 decode
    assert names.count("batch") == names.count("prefill") \
        == names.count("decode") == 1
    assert n == 3 + 2 * sum(per_pass.values())


def test_parents_and_batches_nest(jamba):
    tracing.on()
    jamba.generate_batch(_prompts(256, [7, 3, 5]), max_new=3)
    jamba.generate_batch(_prompts(256, [4]), max_new=2)
    recs = tracing.records()
    by = {r.index: r for r in recs}
    batches = [r for r in recs if r.name == "batch"]
    assert len(batches) == 2
    for b in batches:
        assert b.parent is None and b.batch == b.index
    assert [b.attrs["rows"] for b in batches] == [3, 1]
    for r in recs:
        assert r.t0 <= r.t1 and r.device_ns == r.t1 - r.t0
        if r.name == "batch":
            continue
        up = by[r.parent]
        assert r.batch == up.batch
        assert up.t0 <= r.t0 and r.t1 <= up.t1
        if r.name in ("prefill", "decode"):
            assert up.name == "batch"
        else:
            assert up.name in ("prefill", "decode")
    pre = [r for r in recs if r.name == "prefill"]
    assert [r.attrs for r in pre] == [{"batch": 3, "seq": 7},
                                      {"batch": 1, "seq": 4}]
    dec = [r for r in recs if r.name == "decode"]
    assert [(r.attrs["rows"], r.attrs["pos"]) for r in dec] == [
        (3, 7), (3, 8), (1, 4)]
    assert {r.batch for r in dec} == {b.index for b in batches}


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    tracing.on()
    with tracing.span("a"):
        with tracing.span("b"):
            pass
        with tracing.span("c"):
            with tracing.span("d"):
                pass
    for _ in range(4):
        with tracing.span("e"):
            pass
    assert [r.name for r in tracing.records()] == ["a", "b", "c"]
    assert tracing.dropped() == 5
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_stamps_on_the_profilers_clock():
    """A span inside a ``record_function`` range has its stamps inside
    the range's, within 50 µs."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            with tracing.span("inner"):
                time.sleep(0.002)
    (rec,) = tracing.records()
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "outer"]
    lo, hi = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert lo - 50_000 <= rec.t0 < rec.t1 <= hi + 50_000
    assert rec.t1 - rec.t0 >= 2_000_000


def test_counters_sum_numbers_and_tensors():
    tracing.count("x", 3)                      # off: nothing
    tracing.on()
    tracing.count("x", 2)
    tracing.count("x", torch.tensor(5))
    tracing.count("y", torch.tensor(1.5))
    for _ in range(2 * tracing._FOLD):          # folded on the way
        tracing.count("z", torch.tensor(1))
    assert tracing.counters() == {"x": 7, "y": 1.5, "z": 2 * tracing._FOLD}


@pytest.mark.parametrize("top_k,cap", [(1, 3), (2, 5), (2, 2)])
def test_moe_counters_match_the_dispatch(top_k, cap):
    gen = torch.Generator().manual_seed(top_k * 10 + cap)
    tok = torch.randn((3, 8, 16), generator=gen).to(torch.bfloat16)
    router = torch.randn((16, 4), generator=gen)
    tracing.on()
    _, _, combine, dispatch = moe._route(tok, router, top_k=top_k, cap=cap)
    c = tracing.counters()
    g, s, e, cp = dispatch.shape
    assert (g, s, e, cp) == (3, 8, 4, cap)
    assert c["moe.assigned"] == g * s * top_k
    assert c["moe.slots"] == g * e * cap
    assert c["moe.dispatched"] == int(dispatch.float().sum())
    # each (group, expert, slot) holds at most one token, each token at
    # most top_k slots
    assert dispatch.float().sum(dim=1).max() <= 1
    assert dispatch.float().sum(dim=(2, 3)).max() <= top_k
    assert c["moe.dispatched"] <= min(c["moe.assigned"], c["moe.slots"])


def test_serve_counts_the_tokens_requests_keep(jamba):
    before = dict(jamba.stats)
    lens = [5, 9, 7, 3, 6]
    reqs = [Request(i, p, max_new=m) for i, (p, m) in enumerate(
        zip(_prompts(256, lens, seed=1), [2, 4, 1, 3, 2]))]
    jamba.serve(reqs)
    d = {k: jamba.stats[k] - before[k] for k in before}
    assert d["prefills"] == 2
    assert d["tokens_out"] == sum(len(r.out) for r in reqs) == 12
    assert d["prompt_tokens"] == sum(lens)
    assert d["padded_positions"] == 4 * 9 + 6 - sum(lens)
    assert d["decode_steps"] == 3 + 1


@pytest.mark.cuda
def test_device_time_from_cuda_events():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device time comes from CUDA "
                    "events")
    dev = torch.device("cuda")
    a = torch.randn((2048, 2048), device=dev)
    tracing.on()
    with tracing.span("outer", dev):
        with tracing.span("mm", dev):
            for _ in range(20):
                a = a @ a / 2048 ** 0.5
    outer, mm = tracing.records()
    assert outer._events is None and mm.device_ns > 0
    assert mm.device_ns <= outer.device_ns
    assert outer.device_ns <= outer.t1 - outer.t0 + 10 ** 9


# ------------------------------------------------- the smoke's busy time

def _smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_busy", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Event:
    def __init__(self, dev, a, b, card=0, annotation=False):
        self._dev, self._a, self._b = dev, a, b
        self._card, self._ann = card, annotation

    def device_type(self):
        return self._dev

    def device_index(self):
        return self._card

    def is_user_annotation(self):
        return self._ann

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a


def test_smoke_busy_time_is_the_union_of_device_records():
    """``chip_smoke.py`` takes a card's busy time as the union of its
    device records: three streams at once count once (their sum read
    idle shares below 0), profiler ranges' device copies not at all."""
    from torch.autograd import DeviceType
    smoke = _smoke()
    assert smoke._union_ns([(0, 10), (5, 15), (20, 30), (20, 25)]) == 25
    assert smoke._union_ns([]) == 0
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [_Event(cuda, 0, 600_000), _Event(cuda, 0, 600_000),
              _Event(cuda, 100_000, 800_000),
              _Event(cuda, 0, 1_000_000, annotation=True),
              _Event(cpu, 0, 1_000_000),
              _Event(cuda, 0, 200_000, card=1)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert smoke._device_ms(prof) == {0: 0.8, 1: 0.2}
    cards = smoke._card_busy(torch, prof, 1.0, 2)
    assert [c["busy_ms"] for c in cards] == [0.8, 0.2]
    assert cards[0]["idle_share"] == pytest.approx(0.2)
    assert all(c["idle_share"] >= 0 for c in cards)
