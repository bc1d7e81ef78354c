"""Multi-pod dry-run: every (architecture × input shape × mesh) cell's
step, run on fake tensors on a fake 256- or 512-rank process group.

The port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell's pjit program on 512 placeholder host devices and reads XLA's
memory and cost analyses and the post-SPMD HLO.  PyTorch makes no HLO, so
this module runs the bundle's own step instead — ``train_step`` for train
shapes, ``prefill`` for prefill shapes, one ``serve_step`` against a
seq-len cache for decode shapes — as ``ModelBundle.lower_train`` /
``lower_prefill`` / ``lower_decode`` do: the same code a real step runs,
on ``FakeTensorMode`` tensors (shapes, dtypes and placements, no data, no
allocation) placed on ``launch.mesh.make_production_mesh``'s 16×16 or
2×16×16 mesh over a fake process group (``backend="fake"``: collectives
return without communicating).  This process is rank 0.

:class:`StepCounter` takes the place of ``hlo_analysis.analyze_hlo``: one
``TorchDispatchMode`` that sees each rank's local ops only (it defers
every op on DTensors to DTensor, whose local ops it then sees, and it
pauses inside DTensor's sharding propagation, which runs ops on the
global shapes).  It counts

  * FLOPs: ``torch.utils.flop_counter``'s formulas for the matrix
    products (``mm``, ``addmm``, ``bmm``, ``baddbmm``), the class
    ``analyze_hlo`` counts (dots only);
  * bytes: Σ (input + output bytes) over every local op that returns a
    tensor and is not a view or a collective — eager PyTorch runs one
    kernel an op, so this is the kernel-level traffic that
    ``analyze_hlo`` approximates with fusions;
  * collectives: the ``_c10d_functional`` ops and DTensor's all-to-all,
    by the reference's kind names, with their operand bytes.  A CPU
    mesh's group runs an all-to-all as all-gather + chunk; the counter
    runs it as the all-to-all NCCL runs on the card (and counts that),
    and the record says so in ``warnings``;
  * memory: the live bytes of the local storages, the arguments' from the
    start and every storage an op makes until it is freed; the peak.

Every Python loop runs (the KV blocks, the mLSTM chunks), so nothing is
undercounted as a ``while`` body is in HLO; a cell costs its host time,
which ``lower_s`` records.  The sLSTM time loop (4,096 to 32,768 steps a
layer) is the exception: on fake tensors it runs two steps, and the second
step's FLOPs, bytes and collectives count once for each skipped step, whose
kept outputs are made as fresh tensors (``one_step`` / ``repeat``, which
``ml/xlstm.py``'s ``_time_loop`` asks for), as the reference counts a loop
body times its trip count.  The counts and the peak equal the step-by-step loop's.
Nothing compiles: ``compile_s`` is 0.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1_5_0_5b \\
      --shape train_4k --multi_pod false
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --multi_pod both --keep_going

Records go to ``runs/dryrun_torch/`` (one JSON a cell, the reference's
keys); ``benchmarks/roofline.py`` reads them as it reads the reference's.
Run it in a process of its own: it owns the process group.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref
from dataclasses import replace
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _flat

from ..configs.base import SHAPES, get_config, list_archs, shape_cells
from ..ml.sharding import is_dtensor

__all__ = ["StepCounter", "COLLECTIVES", "collective_kind", "fake_world",
           "run_cell", "main"]

#: the reference's collective kinds, in its order
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_out": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
          "all_reduce_coalesced": "all-reduce",
          "all_reduce_coalesced_": "all-reduce",
          "all_to_all_single": "all-to-all",
          "shard_dim_alltoall": "all-to-all",
          "broadcast": "broadcast", "broadcast_": "broadcast"}
_COMM_NAMESPACES = ("_c10d_functional", "c10d_functional",
                    "_c10d_functional_autograd", "_dtensor")
_DOTS = ("mm", "addmm", "bmm", "baddbmm")
_ALLTOALL_WARNING = ("all-to-all: the CPU mesh's group runs it as "
                     "all-gather + chunk; counted as the all-to-all NCCL "
                     "runs on the card")


def collective_kind(op) -> Optional[str]:
    """The reference's kind name of a collective op (an ``OpOverload`` or
    its packet), None for any other op (``wait_tensor`` included)."""
    qual = getattr(op, "_qualified_op_name", None) or op.name()
    namespace, _, name = qual.partition("::")
    if namespace not in _COMM_NAMESPACES:
        return None
    return _KINDS.get(name)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _tensors(tree):
    return [t for t in _flat(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _local(t):
    return t.to_local() if is_dtensor(t) else t


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _alltoall_as_nccl(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's shard-to-shard all-to-all as on a CUDA mesh (one
    ``_dtensor.shard_dim_alltoall``), for fake tensors on a CPU mesh,
    whose group would run all-gather + chunk instead."""
    from torch.distributed import _functional_collectives as funcol
    group = funcol._resolve_group((mesh, mesh_dim))
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, funcol._group_or_group_name(group))


class StepCounter(TorchDispatchMode):
    """Counts one step's local FLOPs, bytes, collectives and live memory
    (see the module docstring).  ``hold(tree)`` before the step registers
    its arguments; ``finish(out)`` after it the outputs; ``record()`` gives
    the ``memory`` / ``cost`` / ``collectives`` / ``analyzed`` parts of a
    dry-run record.  On real tensors it counts the same way, so a real
    step can be held to a fake one.  ``alltoall_as_nccl`` (fake tensors
    only) runs a CPU mesh's all-to-all as the card's.  On fake tensors a
    time loop counts one step for all (``loops_once``)."""

    def __init__(self, *, alltoall_as_nccl: bool = False):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.per_kind: Dict[str, Dict[str, int]] = {
            k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self.warnings: list = []
        self._storages: Dict[int, int] = {}
        self._paused = 0
        self._as_nccl = alltoall_as_nccl
        self._stack = contextlib.ExitStack()

    # ------------------------------------------------------------ memory
    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        weakref.finalize(st, self._free, key)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key):
        self.live -= self._storages.pop(key, 0)

    def hold(self, tree):
        """Register the step's arguments (DTensors by their local
        pieces): live from the start."""
        for t in _tensors(tree):
            self._track(_local(t))
        self.argument_bytes = self.live

    def finish(self, out):
        """The step's outputs' local bytes (``output_bytes``)."""
        seen, n = set(), 0
        for t in _tensors(out):
            st = _local(t).untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                n += st.nbytes()
        self.output_bytes = n

    # ------------------------------------------------ loops counted once
    @property
    def loops_once(self) -> bool:
        """Whether a time loop counts one step for all (``one_step``,
        ``repeat``; read by ``ml.xlstm._time_loop``): under a
        ``FakeTensorMode`` only, since a real step runs every step."""
        from torch._guards import detect_fake_mode
        return detect_fake_mode() is not None

    @contextlib.contextmanager
    def one_step(self):
        """Count the block as one loop step: yields a :class:`LoopStep`
        filled in when the block ends."""
        one = LoopStep()
        flops, nbytes, live, peak = self.flops, self.bytes, self.live, \
            self.peak
        kinds = {k: dict(v) for k, v in self.per_kind.items()}
        self.peak = live
        try:
            yield one
        finally:
            one.flops = self.flops - flops
            one.bytes = self.bytes - nbytes
            one.per_kind = {
                k: {f: n - kinds.get(k, {}).get(f, 0) for f, n in v.items()}
                for k, v in self.per_kind.items()}
            one.kept = self.live - live
            one.transient = self.peak - live
            self.peak = max(peak, self.peak)

    def repeat(self, one: "LoopStep", like):
        """Count a step the loop skips as ``one`` again: its FLOPs, bytes
        and collectives, its transient peak above the live bytes, and
        fresh tensors shaped as ``like`` (the step's kept outputs), live
        from now on, which it returns."""
        self.flops += one.flops
        self.bytes += one.bytes
        for k, v in one.per_kind.items():
            row = self.per_kind.setdefault(k, {"count": 0, "bytes": 0})
            for f, n in v.items():
                row[f] += n
        self.peak = max(self.peak, self.live + one.transient)
        self._paused += 1
        try:
            fresh = tuple(torch.empty_like(t) for t in like)
        finally:
            self._paused -= 1
        live = self.live
        for t in fresh:
            self._track(_local(t))
        if self.live - live != one.kept:
            raise RuntimeError(
                f"a loop counted once keeps {self.live - live} bytes a "
                f"skipped step, its counted step {one.kept}: the step "
                "keeps more than its outputs")
        return fresh

    # ----------------------------------------------------------- the mode
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        for name in ("_propagate_tensor_meta_non_cached",
                     "_propagate_tensor_meta"):
            fn = getattr(ShardingPropagator, name, None)
            if fn is not None:
                self._stack.enter_context(_patched(
                    ShardingPropagator, name, self._pausing(fn)))
                break
        if self._as_nccl:
            self._patch_alltoall()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def _pausing(self, fn):
        counter = self

        def run(*args, **kwargs):
            counter._paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                counter._paused -= 1
        return run

    def _patch_alltoall(self):
        import importlib
        from torch.distributed.tensor import _collective_utils as cu
        orig = cu.shard_dim_alltoall
        counter = self

        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            if mesh.device_type != "cpu":
                return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
            if _ALLTOALL_WARNING not in counter.warnings:
                counter.warnings.append(_ALLTOALL_WARNING)
            return _alltoall_as_nccl(input, gather_dim, shard_dim, mesh,
                                     mesh_dim)

        for mod in ("_collective_utils", "placement_types", "_redistribute"):
            try:
                m = importlib.import_module(f"torch.distributed.tensor.{mod}")
            except ImportError:
                continue
            if getattr(m, "shard_dim_alltoall", None) is orig:
                self._stack.enter_context(_patched(m, "shard_dim_alltoall",
                                                   alltoall))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(is_dtensor(t) for t in _flat((args, kwargs))):
            return NotImplemented       # DTensor runs it; we see its ops
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        kind = collective_kind(func)
        ins = _tensors((args, kwargs))
        if kind is not None:
            row = self.per_kind.setdefault(kind, {"count": 0, "bytes": 0})
            row["count"] += 1
            row["bytes"] += sum(_nbytes(t) for t in ins)
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if kind is not None or func.namespace in _COMM_NAMESPACES \
                or not outs or _is_view(func):
            return
        if func.namespace == "aten" and func._opname in _DOTS:
            from torch.utils.flop_counter import flop_registry
            self.flops += int(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        self.bytes += sum(_nbytes(t) for t in ins) \
            + sum(_nbytes(t) for t in outs)

    # ------------------------------------------------------------ results
    def collectives(self) -> Dict:
        return {"per_kind": {k: dict(v) for k, v in self.per_kind.items()},
                "total_bytes": sum(v["bytes"]
                                   for v in self.per_kind.values())}

    def counts(self) -> Dict[str, int]:
        """Collectives a kind (kinds that ran)."""
        return {k: v["count"] for k, v in self.per_kind.items()
                if v["count"]}

    def record(self) -> Dict:
        temp = self.peak - self.argument_bytes
        coll = self.collectives()
        return {
            "memory": {"argument_bytes": self.argument_bytes,
                       "output_bytes": self.output_bytes,
                       "temp_bytes": temp,
                       "peak_bytes": self.argument_bytes + temp},
            "cost": {"flops_per_device": self.flops,
                     "bytes_per_device": self.bytes},
            "collectives": coll,
            "analyzed": {"flops_per_device": self.flops,
                         "bytes_per_device": self.bytes,
                         "bytes_flash_interior": 0,
                         "collective_bytes": coll["total_bytes"],
                         "per_kind": coll["per_kind"],
                         "warnings": list(self.warnings)},
        }


class LoopStep:
    """What one counted loop step did (``StepCounter.one_step``): its
    FLOPs, bytes and collectives a kind, the bytes it left live
    (``kept``) and its peak above the live bytes it found
    (``transient``)."""
    __slots__ = ("flops", "bytes", "per_kind", "kept", "transient")


# ------------------------------------------------------------ fake world

@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks, this process rank 0, for
    the block; destroyed after it.  Refuses to run beside a real group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run needs a process of its own: a "
                           "process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _model_flops(params: int, shape) -> int:
    return 6 * params * shape.global_batch * (
        1 if shape.kind == "decode" else shape.seq_len)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = "runs/dryrun_torch", *,
             train_overrides: Optional[dict] = None,
             tag: str = "", arch_overrides: Optional[dict] = None) -> dict:
    """Dry-run one cell on the production mesh → its record (the
    reference's keys), also written to ``out_dir``.  ``arch_overrides``
    are ``ArchConfig`` fields (``--moe_group``, ``--ssm_chunk``)."""
    from ..ml.model import ModelBundle, TrainConfig
    from .mesh import make_production_mesh, production_mesh_shape
    cfg = get_config(arch)
    if arch_overrides:
        cfg = replace(cfg, **arch_overrides)
    shape = SHAPES[shape_name]
    sizes = tuple(production_mesh_shape(multi_pod).shape.values())
    with fake_world(math.prod(sizes)):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        tc = TrainConfig(**(train_overrides or {}))
        mb = ModelBundle(cfg, mesh, impl="reference", train_cfg=tc)
        t0 = time.time()
        lowered = {"train": mb.lower_train, "prefill": mb.lower_prefill,
                   "decode": mb.lower_decode}[shape.kind](shape)
        t_lower = time.time() - t0
    record = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in sizes),
        "axes": list(mesh.mesh_dim_names), "chips": math.prod(sizes),
        "kind": shape.kind,
        "lower_s": round(t_lower, 2), "compile_s": 0.0,
        **lowered.record,
        "model_flops_dense": _model_flops(cfg.params_count(), shape),
        "model_flops_active": _model_flops(cfg.active_params_count(),
                                           shape),
        "params": cfg.params_count(),
        "tag": tag,
    }
    os.makedirs(out_dir, exist_ok=True)
    mesh_tag = "multipod" if multi_pod else "pod"
    suffix = f"-{tag}" if tag else ""
    path = os.path.join(out_dir,
                        f"{arch}-{shape_name}-{mesh_tag}{suffix}.json")
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1)
    return record


def _arch_overrides(args) -> dict:
    """The reference's environment knobs as the port's config fields."""
    out = {}
    if args.moe_group:
        out["moe_group_size"] = args.moe_group
    if args.ssm_chunk:
        out["ssm_chunk"] = args.ssm_chunk
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi_pod", default="both",
                    choices=["true", "false", "both"])
    ap.add_argument("--out_dir", default="runs/dryrun_torch")
    ap.add_argument("--tag", default="", help="artifact suffix (perf iters)")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--loss_chunk", type=int, default=2048)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--fsdp", default="false", choices=["true", "false"])
    ap.add_argument("--param_dtype", default="bfloat16")
    ap.add_argument("--no_zero1", action="store_true")
    ap.add_argument("--no_seq_parallel", action="store_true")
    ap.add_argument("--moe_group", type=int, default=None)
    ap.add_argument("--ssm_chunk", type=int, default=None)
    ap.add_argument("--keep_going", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    pods = {"true": [True], "false": [False],
            "both": [False, True]}[args.multi_pod]
    overrides = {"remat": args.remat, "loss_chunk": args.loss_chunk,
                 "zero1": not args.no_zero1, "fsdp": args.fsdp == "true",
                 "param_dtype": args.param_dtype,
                 "seq_parallel": not args.no_seq_parallel}
    arch_over = _arch_overrides(args)

    failures = []
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([s.name for s in shape_cells(cfg)]
                  if args.shape == "all" else [args.shape])
        for shape_name in shapes:
            for mp in pods:
                cell = f"{arch} × {shape_name} × " \
                       f"{'2x16x16' if mp else '16x16'}"
                try:
                    rec = run_cell(arch, shape_name, mp, args.out_dir,
                                   train_overrides=overrides, tag=args.tag,
                                   arch_overrides=arch_over)
                    mem_gb = rec["memory"]["peak_bytes"] / 2**30
                    print(f"[OK]   {cell:58s} lower={rec['lower_s']:7.1f}s"
                          f" mem/dev={mem_gb:6.2f}GiB"
                          f" coll={rec['collectives']['total_bytes']/2**20:9.1f}MiB",
                          flush=True)
                except Exception as e:
                    failures.append((cell, repr(e)))
                    print(f"[FAIL] {cell}: {e}", flush=True)
                    if not args.keep_going:
                        traceback.print_exc()
                        raise
    if failures:
        print(f"\n{len(failures)} failures:")
        for cell, err in failures:
            print(f"  {cell}: {err[:200]}")
        raise SystemExit(1)
    print("\nAll dry-run cells ran.")


if __name__ == "__main__":
    main()
