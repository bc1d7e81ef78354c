"""Build, load, launch and count the hand-written CUDA kernels.

Every kernel source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface and
loaded with :mod:`ctypes`.  Nothing is built when the package is
imported: the first :func:`library` call builds every source at once, one
``nvcc`` process per file, all started together, into ``kernels/build/``
(listed in ``.gitignore``).  A library's file name carries a hash of its
sources and flags, so an edited source is rebuilt and an unchanged one is
reused.  A failed build raises; nothing falls back to another
implementation.

Each C entry point takes its pointers and PyTorch's current stream as
``void*`` and returns ``cudaGetLastError()`` after its launches (each
library also exports ``repro_strerror``); :func:`launch` raises on a
non-zero code, because a refused launch never runs and a later
synchronise does not report it.  Loading binds every entry point once
into a table of ctypes functions with their argument types set, so a
launch takes no lock and looks up no symbol: it reads the table, the
current stream (entering ``torch.cuda.device`` only when the tensors'
card is not the current one) and calls the entry.

:func:`launch` raises when a tensor argument sits on another device than
the launch's (a kernel handed two cards' pointers does not fail cleanly),
and bumps the launch counter of the kernel on its card
(:func:`kernel_launches`, per card with ``device=``).  It is the only
place that counts, so a wrapper
that runs the plain PyTorch version (CPU tensors) counts nothing: the
counter is the evidence that a run went through the kernels.  The logical
dispatch counter the engines' launch contract reads lives in
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from collections import Counter
from pathlib import Path
from typing import Callable, Dict

import torch

__all__ = ["SOURCES", "NVCC_FLAGS", "BUILD_LOGS", "BUILD_DIR", "library",
           "build_all", "require", "forbid_grad", "launch",
           "kernel_launches", "reset_kernel_launches", "StreamState",
           "stream_state", "state_words"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"

#: kernel library name → its C entry points' ctypes signatures
#: (``p`` pointer or stream, ``i`` int, ``l`` 64-bit int, ``f`` float);
#: every entry returns an int error
SOURCES: Dict[str, Dict[str, str]] = {
    "bitset": {"repro_bitmap_intersect": "pppiiipp",
               "repro_bitset_binary": "pppiip"},
    "compact": {"repro_compact_batched": "ppppiillp",
                "repro_mask_scan": "ppppiillp"},
    "segment_agg": {"repro_segment_agg_shared": "ppiipip",
                    "repro_segment_agg_global": "ppiipp"},
    "refine": {"repro_refine_tracks": "pppiiiiiiiplpl" + "p" * 10},
    "flash_attention": {"repro_flash_attention_simt": "ppppiiiiiiiiiffp",
                        "repro_flash_attention_tc": "ppppiiiiiiiiffp"},
    "ssm_scan": {"repro_ssm_scan": "pppppiilp"},
    "selective_scan": {"repro_selective_scan": "ppppppppiiiiiip"},
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_CTYPE = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
          "f": ctypes.c_float}
_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: C entry point name → its ctypes function, argument types set
_ENTRIES: Dict[str, Callable[..., int]] = {}
#: nvcc's output (the ptxas register / shared-memory report) per library
#: built by this process
BUILD_LOGS: Dict[str, str] = {}
#: (counter, device index) → launches
_LAUNCHES: Counter = Counter()
_LAUNCH_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" \
        / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return str(path)


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([_CSRC / f"{name}.cu", *_CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every missing kernel library in parallel; returns the
    library paths.  Raises with nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SOURCES}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            errors.append(f"{name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return targets


def _load() -> None:
    """Build and load every kernel library, then publish its entry points
    in ``_ENTRIES`` (done once, under ``_LOCK``)."""
    with _LOCK:
        if _ENTRIES:
            return
        entries = {}
        for lname, path in build_all().items():
            cdll = ctypes.CDLL(str(path))
            for fn, sig in SOURCES[lname].items():
                f = getattr(cdll, fn)
                f.argtypes = [_CTYPE[ch] for ch in sig]
                f.restype = ctypes.c_int
                entries[fn] = f
            cdll.repro_strerror.argtypes = [ctypes.c_int]
            cdll.repro_strerror.restype = ctypes.c_char_p
            _LIBS[lname] = cdll
        _ENTRIES.update(entries)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (building all on first use)."""
    if not _ENTRIES:
        _load()
    return _LIBS[name]


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            ndim: int) -> None:
    """Raise unless ``t`` is a ``dtype`` tensor of rank ``ndim`` on the
    CPU (plain version) or a contiguous one on a CUDA device (kernel)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {dtype} of rank {ndim}, got "
                         f"{t.dtype} of shape {tuple(t.shape)}")
    if t.is_cuda:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel needs a contiguous "
                             "tensor")
    elif not t.is_cpu:
        raise ValueError(f"{name}: unsupported device {t.device}")


def forbid_grad(kernel: str, *tensors) -> None:
    """Raise when autograd would have to differentiate through the CUDA
    kernel ``kernel``: grad mode is on and an input requires grad.  The
    kernels write their outputs through raw pointers and have no backward,
    so without this check the result would silently carry no gradient.
    ``None`` inputs are skipped."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise no_backward(kernel)


def no_backward(kernel: str) -> RuntimeError:
    """The error for a backward through the CUDA kernel ``kernel``."""
    return RuntimeError(
        f"{kernel}: the CUDA kernel has no backward, and an input "
        "requires grad; run it under torch.no_grad() or "
        "torch.inference_mode(), or on CPU tensors (the plain version "
        "differentiates)")


def launch(counter: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` on ``device``'s current stream; tensors
    pass as their data pointers (``None`` as a null pointer), numbers as
    themselves.  Raises when a tensor is a DTensor (a mesh runs the
    wrapper on each rank's pieces, through ``local_map``) or not on
    ``device``, and on a CUDA error; then counts one launch under
    ``counter`` on ``device``."""
    index = device.index
    ptrs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if type(a) is not torch.Tensor and _is_dtensor(a):
                raise TypeError(
                    f"{counter}: got a DTensor; the kernel takes a plain "
                    "tensor on one card: call the wrapper on each rank's "
                    "pieces through torch.distributed.tensor.experimental."
                    "local_map")
            if a.get_device() != index:
                _mixed_devices(entry, device, args)
            ptrs.append(a.data_ptr())
        else:
            ptrs.append(a)
    fn = _ENTRIES.get(entry)
    if fn is None:
        _load()
        fn = _ENTRIES[entry]
    if index == torch.cuda.current_device():
        err = fn(*ptrs, torch.cuda.current_stream(index).cuda_stream)
    else:
        with torch.cuda.device(index):
            err = fn(*ptrs, torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        lib = next(n for n, e in SOURCES.items() if entry in e)
        msg = _LIBS[lib].repro_strerror(err).decode(errors="replace")
        raise RuntimeError(f"{entry}: CUDA error {err} ({msg})")
    with _LAUNCH_LOCK:
        _LAUNCHES[(counter, index)] += 1


def _is_dtensor(a) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(a, mod.DTensor)


def _mixed_devices(entry: str, device: torch.device, args) -> None:
    """Raise for a launch whose tensors do not all sit on ``device``: a
    kernel handed another card's pointers would read that card's memory
    or fault later, so nothing is copied on the fly."""
    devs = sorted({str(device)} | {str(a.device) for a in args
                                   if isinstance(a, torch.Tensor)})
    raise ValueError(f"{entry}: tensors on more than one device "
                     f"({', '.join(devs)}); a kernel runs on one card")


def kernel_launches(device=None) -> Dict[str, int]:
    """CUDA kernel launches per wrapper since the last reset, on every
    card, or only on ``device`` (a ``torch.device``, its string or its
    index)."""
    index = None
    if device is not None:
        index = device if isinstance(device, int) else \
            torch.device(device).index
    out: Counter = Counter()
    with _LAUNCH_LOCK:
        for (counter, i), n in _LAUNCHES.items():
            if index is None or i == index:
                out[counter] += n
    return dict(out)


def reset_kernel_launches() -> None:
    with _LAUNCH_LOCK:
        _LAUNCHES.clear()


def state_words(need: int) -> int:
    """int64 words of a kernel state buffer that must hold ``need``: the
    power of two at or above it, so that a buffer grown for one call
    serves calls of nearby sizes."""
    return 1 << max(need - 1, 0).bit_length()


class StreamState:
    """Device memory that one kernel keeps across its calls on one (device,
    stream): ``buf``, an int64 buffer that only that kernel writes,
    zero-filled when it is allocated; ``lock``, held around a call's
    bookkeeping and launch where the kernel needs them in stream order;
    ``ticket`` and ``epoch``, bookkeeping for the kernel's wrapper."""

    def __init__(self):
        self.buf = None
        self.ticket = 0
        self.epoch = 0
        self.lock = threading.Lock()

    def reserve(self, need: int, device: torch.device) -> None:
        """Make ``buf`` hold at least ``need`` words: a buffer allocated
        anew is zero-filled, with ``ticket`` and ``epoch`` reset to 0."""
        if self.buf is None or self.buf.numel() < need:
            self.buf = torch.zeros((state_words(need),), dtype=torch.int64,
                                   device=device)
            self.ticket = self.epoch = 0


_STATES: Dict[tuple, StreamState] = {}
_STATES_LOCK = threading.Lock()


def stream_state(kernel: str, device: torch.device) -> StreamState:
    """The state ``kernel`` keeps on ``device``'s current stream (calls on
    one stream run in order, so they may share it; another stream gets its
    own)."""
    key = (kernel, device.index,
           torch.cuda.current_stream(device.index).cuda_stream)
    st = _STATES.get(key)
    if st is None:
        with _STATES_LOCK:
            st = _STATES.setdefault(key, StreamState())
    return st
