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
synchronise does not report it.

:func:`launch` also bumps the per-kernel launch counter
(:func:`kernel_launches`).  It is the only place that counts, so a wrapper
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
import threading
from collections import Counter
from pathlib import Path
from typing import Dict

import torch

__all__ = ["SOURCES", "NVCC_FLAGS", "BUILD_LOGS", "BUILD_DIR", "library",
           "build_all", "require", "launch", "kernel_launches",
           "reset_kernel_launches"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"

#: kernel library name → its C entry points' ctypes signatures
#: (``p`` pointer or stream, ``i`` int); every entry returns an int error
SOURCES: Dict[str, Dict[str, str]] = {
    "bitset": {"repro_bitmap_intersect_batched": "pppiiip"},
    "compact": {"repro_compact_batched": "pppiip"},
    "segment_agg": {"repro_segment_agg": "ppiipppp"},
    "refine": {"repro_refine_tracks_batched": "pppiiiiiippppp"},
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_CTYPE = {"p": ctypes.c_void_p, "i": ctypes.c_int}
_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (the ptxas register / shared-memory report) per library
#: built by this process
BUILD_LOGS: Dict[str, str] = {}
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


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (building all on first use)."""
    with _LOCK:
        if not _LIBS:
            for lname, path in build_all().items():
                cdll = ctypes.CDLL(str(path))
                for fn, sig in SOURCES[lname].items():
                    f = getattr(cdll, fn)
                    f.argtypes = [_CTYPE[ch] for ch in sig]
                    f.restype = ctypes.c_int
                cdll.repro_strerror.argtypes = [ctypes.c_int]
                cdll.repro_strerror.restype = ctypes.c_char_p
                _LIBS[lname] = cdll
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
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel needs a contiguous "
                         "tensor")


def launch(counter: str, lib_name: str, entry: str, device: torch.device,
           *args) -> None:
    """Call C entry ``entry`` of library ``lib_name`` on ``device``'s
    current stream; tensors pass as their data pointers, ints as ints.
    Raises on a CUDA error, then counts one launch under ``counter``."""
    lib = library(lib_name)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*ptrs, stream)
    if err != 0:
        msg = lib.repro_strerror(err).decode(errors="replace")
        raise RuntimeError(f"{entry}: CUDA error {err} ({msg})")
    with _LAUNCH_LOCK:
        _LAUNCHES[counter] += 1


def kernel_launches() -> Dict[str, int]:
    """CUDA kernel launches per wrapper since the last reset."""
    with _LAUNCH_LOCK:
        return dict(_LAUNCHES)


def reset_kernel_launches() -> None:
    with _LAUNCH_LOCK:
        _LAUNCHES.clear()
