"""Partitions on their own cards, and the non-blocking checkpoint save,
on the CPU.

The execution mesh (``repro_torch.launch.mesh.make_exec_mesh``) is held
to the JAX package's size rule at one device and to the same rule with
the CUDA device count faked at 4; the partition → card map is p mod D.
``TorchBackend.partition_context`` is checked on a backend whose CUDA is
faked: the card a thread's waves read (``device``, ``device_cache``) is
its own partition's while other threads run theirs, the card choice is
separate from allocation (device copies are stubbed to record their
card), a card joining gets every primed buffer, priming and eviction
reach every card, and on a backend on the CPU the context changes
nothing.  ``kernels._build.launch`` refuses tensors of two devices
before it builds or launches anything, and counts launches per card.
``CheckpointManager.save(blocking=False)`` returns before its writer is
done, and ``keep`` holds after ``wait()``.  The multi-card runs on real
cards are ``tests/test_torch_cuda.py``'s (they skip below two cards).
"""
import contextlib
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import mesh as jmesh               # noqa: E402

from repro_torch.ckpt import checkpoint as ckpt      # noqa: E402
from repro_torch.exec import TorchBackend            # noqa: E402
from repro_torch.exec import device_cache as dc      # noqa: E402
from repro_torch.fdb import (DOUBLE, INT, Schema,    # noqa: E402
                             build_fdb)
from repro_torch.fdb.schema import Field             # noqa: E402
from repro_torch.kernels import _build               # noqa: E402
from repro_torch.launch.mesh import (default_exec_partitions,  # noqa: E402
                                     make_exec_mesh)

PARTITIONS = (0, 1, 2, 4, 8)


def _fake_cuda(monkeypatch, cards: int):
    """CUDA faked with ``cards`` devices: device copies stay on the CPU
    and record the card they were meant for; entering a card records it
    for the calling thread.  Returns (copies, entered) lists."""
    copies, entered = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def to_device(arr, device):
        copies.append(torch.device(device))
        return torch.as_tensor(np.ascontiguousarray(arr).copy())

    @contextlib.contextmanager
    def enter(card):
        entered.append((threading.get_ident(), torch.device(card)))
        yield

    monkeypatch.setattr(dc, "to_device", to_device)
    monkeypatch.setattr(torch.cuda, "device", enter)
    return copies, entered


def _small_fdb(name="Cards", n=40, shards=4):
    schema = Schema(name, [Field("id", INT, indexes=("tag",)),
                           Field("v", DOUBLE)])
    recs = [{"id": i, "v": float(i) / 7.0} for i in range(n)]
    return build_fdb(name, schema, recs, num_shards=shards)


# ------------------------------------------------------------ the exec mesh

@pytest.mark.parametrize("partitions", PARTITIONS)
@pytest.mark.parametrize("cards", [1, 4])
def test_exec_mesh_size_rule(monkeypatch, cards, partitions):
    """``min(partitions, cards)`` cards, all for ``partitions=0``, in
    order; at one device the JAX package's mesh has the same size."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    size = min(partitions, cards) if partitions else cards
    mesh = make_exec_mesh(partitions)
    assert mesh == [torch.device("cuda", i) for i in range(size)]
    assert make_exec_mesh(partitions, "cpu") == [torch.device("cpu")]
    if cards == 1:
        assert jmesh.make_exec_mesh(partitions).devices.size == len(mesh)


@pytest.mark.parametrize("cards", [1, 2, 4])
def test_partition_card_map(monkeypatch, cards):
    """Partition p of P runs on card p mod D of the P-partition mesh
    (D = min(P, cards)); one partition, and a backend on the CPU, keep
    the backend's own device.  The default P is the card count."""
    _fake_cuda(monkeypatch, cards)
    be = TorchBackend()
    assert be.device == torch.device("cuda", 0)        # index resolved
    assert default_exec_partitions(be) == cards
    cpu = TorchBackend(device="cpu")
    for parts in (1, 2, 3, 4, 8):
        d = min(parts, cards)
        for p in range(parts):
            want = torch.device("cuda", p % d) if parts > 1 \
                else torch.device("cuda", 0)
            assert be.partition_card(p, parts) == want
            assert cpu.partition_card(p, parts) == torch.device("cpu")


def test_index_less_cuda_resolves_to_current_card(monkeypatch):
    """``TorchBackend(device="cuda")`` pins the constructing thread's
    current card, not "whichever card is current" at each call."""
    _fake_cuda(monkeypatch, 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert TorchBackend(device="cuda").device == torch.device("cuda", 2)
    assert TorchBackend(device="cuda:1").device == torch.device("cuda", 1)


# ------------------------------------------------------- partition_context

def test_partition_context_is_thread_local(monkeypatch):
    """Two threads inside contexts for different partitions each read
    their own card and its cache at the same time, while the calling
    thread keeps the backend's own; each thread's CUDA device is set to
    its card; leaving restores the backend's card."""
    _, entered = _fake_cuda(monkeypatch, 4)
    be = TorchBackend()
    home = torch.device("cuda", 0)
    inside = threading.Barrier(3, timeout=30)
    seen = {}

    def run(part):
        with be.partition_context(part, 4):
            inside.wait()                 # both threads are inside now
            seen[part] = (be.device, be.device_cache.device)
            inside.wait()
        seen[part, "after"] = be.device

    threads = [threading.Thread(target=run, args=(p,)) for p in (1, 2)]
    for t in threads:
        t.start()
    inside.wait()
    main_inside = (be.device, be.device_cache.device)
    inside.wait()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    for part in (1, 2):
        card = torch.device("cuda", part)
        assert seen[part] == (card, card)
        assert seen[part, "after"] == home
    assert main_inside == (home, home)
    idents = {t.ident: p for t, p in zip(threads, (1, 2))}
    assert sorted((idents[i], c) for i, c in entered) == [
        (1, torch.device("cuda", 1)), (2, torch.device("cuda", 2))]
    # nested: the inner context's card, then the outer's again
    with be.partition_context(3, 4):
        with be.partition_context(1, 2):
            assert be.device == torch.device("cuda", 1)
        assert be.device == torch.device("cuda", 3)
    assert be.device == home


def test_one_partition_places_nothing(monkeypatch):
    """P = 1 runs on the backend's own card and enters no other."""
    _, entered = _fake_cuda(monkeypatch, 4)
    be = TorchBackend()
    with be.partition_context(0, 1):
        assert be.device == torch.device("cuda", 0)
    assert entered == [] and list(be.device_caches()) == [be.device]


def test_partition_context_is_a_no_op_on_the_cpu(monkeypatch):
    """On a backend on the CPU the context changes nothing, at any P,
    even where CUDA devices exist: one device, one cache."""
    _, entered = _fake_cuda(monkeypatch, 4)
    cpu = TorchBackend(device="cpu")
    for parts in (1, 2, 4):
        for p in range(parts):
            with cpu.partition_context(p, parts):
                assert cpu.device == torch.device("cpu")
    assert entered == []
    assert list(cpu.device_caches()) == [torch.device("cpu")]


def test_card_residency_follows_priming(monkeypatch):
    """A card joins with every buffer primed so far; an FDb primed later
    is copied to every card that joined (only its new buffers, the same
    count on each); a warm repeat copies nothing; the finalizer evicts
    on every card."""
    copies, _ = _fake_cuda(monkeypatch, 4)
    be = TorchBackend()
    a = _small_fdb("CardsA")
    n_a = be.prime_fdb(a)
    assert n_a > 0 and copies == [torch.device("cuda", 0)] * n_a
    for p in range(4):
        with be.partition_context(p, 4):
            pass
    caches = be.device_caches()
    assert list(caches) == [torch.device("cuda", i) for i in range(4)]
    assert all(len(c) == n_a for c in caches.values())
    assert len(copies) == 4 * n_a             # three cards joined once
    del copies[:]
    for p in range(4):                        # a warm repeat
        with be.partition_context(p, 4):
            pass
    assert be.prime_fdb(a) == 0 and copies == []
    b = _small_fdb("CardsB", n=24, shards=3)
    n_b = be.prime_fdb(b)
    assert n_b > 0
    assert sorted(c.index for c in copies) == sorted(list(range(4)) * n_b)
    assert all(len(c) == n_a + n_b for c in caches.values())
    buf = a.shards[0].batch["v"].values
    assert all(c.get(buf) is not None for c in caches.values())
    del a
    import gc
    gc.collect()
    assert all(len(c) == n_b for c in caches.values())


def test_cards_join_while_priming_under_stress(monkeypatch):
    """Threads (more than cores) enter random partitions' contexts while
    FDbs are primed: every thread reads its own card throughout, and in
    the end every card holds the same buffers as the backend's own."""
    import sys
    _fake_cuda(monkeypatch, 4)
    be = TorchBackend()
    be.prime_fdb(_small_fdb("Stress0"))
    dbs = []
    errors = []
    stop = threading.Event()

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                parts = int(rng.choice([2, 3, 4, 8]))
                p = int(rng.integers(parts))
                want = torch.device("cuda", p % min(parts, 4))
                with be.partition_context(p, parts):
                    for _ in range(3):
                        if be.device != want or \
                                be.device_cache.device != want:
                            errors.append((seed, be.device, want))
        except Exception as e:                 # reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4 * (os.cpu_count() or 2))]
        for t in threads:
            t.start()
        for i in range(6):
            dbs.append(_small_fdb(f"Stress{i + 1}", n=20 + i, shards=2))
            be.prime_fdb(dbs[-1])
        stop.set()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    caches = be.device_caches()
    home = {id(a) for a in caches[be.device].host_arrays()}
    assert len(caches) == 4
    for cache in caches.values():
        assert {id(a) for a in cache.host_arrays()} == home


# ---------------------------------------------------------- the launch path

def test_launch_refuses_tensors_of_two_devices(monkeypatch):
    """A launch whose tensors are not all on its card raises, naming the
    entry and the devices, before anything is built or launched."""
    monkeypatch.setattr(_build, "_load", lambda: pytest.fail("built"))
    _build.reset_kernel_launches()
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError) as err:
        _build.launch("bitset_binary", "repro_bitset_binary",
                      torch.device("cuda", 1), x, x, x, 4, 0)
    msg = str(err.value)
    assert "repro_bitset_binary" in msg and "cpu" in msg \
        and "cuda:1" in msg
    assert _build.kernel_launches() == {}


def test_launch_counts_per_card(monkeypatch):
    """Each launch counts on its card; ``kernel_launches()`` sums the
    cards, ``kernel_launches(device=)`` reads one."""
    current = [0]
    calls = []

    class _Stream:
        cuda_stream = 77

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda index=None: _Stream())
    monkeypatch.setitem(_build._ENTRIES, "repro_fake",
                        lambda *a: calls.append(a) or 0)
    _build.reset_kernel_launches()
    for card in (0, 1, 1, 3):
        current[0] = card                  # the thread is on the card
        _build.launch("fake", "repro_fake", torch.device("cuda", card), 5)
    assert calls == [(5, 77)] * 4
    assert _build.kernel_launches() == {"fake": 4}
    assert _build.kernel_launches(device=torch.device("cuda", 1)) == \
        {"fake": 2}
    assert _build.kernel_launches(device="cuda:3") == {"fake": 1}
    assert _build.kernel_launches(device=2) == {}
    _build.reset_kernel_launches()


# ------------------------------------------------------------------- C9

def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4)},
            "step": np.int64(3)}


def test_non_blocking_save_does_not_wait_for_its_writer(monkeypatch,
                                                        tmp_path):
    """With ``np.savez`` slowed by 1 s, ``save(blocking=False)`` returns
    well under 1 s; after ``wait()`` the newest ``keep`` steps are
    committed and restore, and nothing is left in flight."""
    savez = np.savez

    def slow(*args, **kw):
        time.sleep(1.0)
        return savez(*args, **kw)

    monkeypatch.setattr(ckpt.np, "savez", slow)
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        t0 = time.perf_counter()
        mgr.save(step, _tree())
        assert time.perf_counter() - t0 < 0.5
    mgr.wait()
    steps = sorted(f for f in os.listdir(tmp_path))
    assert steps == ["step-00000003", "step-00000004"]
    tree, step = mgr.restore_or_none(_tree())
    assert step == 4 and torch.equal(tree["params"]["w"],
                                     _tree()["params"]["w"])


def test_retention_never_removes_a_step_being_written(monkeypatch,
                                                      tmp_path):
    """While a write is in flight, pruning counts committed steps only:
    the step being written survives, and ``keep`` holds after ``wait``."""
    gate = threading.Event()
    savez = np.savez

    def gated(*args, **kw):
        gate.wait(10)
        return savez(*args, **kw)

    mgr = ckpt.CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, _tree(), blocking=True)
    monkeypatch.setattr(ckpt.np, "savez", gated)
    mgr.save(2, _tree())
    mgr.save(3, _tree())
    assert sorted(os.listdir(tmp_path)) == [
        "step-00000001", "step-00000002.tmp", "step-00000003.tmp"]
    gate.set()
    mgr.wait()
    assert os.listdir(tmp_path) == ["step-00000003"]
