"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded with ``ctypes``. The build happens at first use, into
``deepfm_tpu_torch/_build/``, and the library's file name carries a hash of
the source and the flags, so an edited source never loads a stale build.
A build that fails raises :class:`KernelBuildError` with the compiler's
output: no kernel silently goes missing.

One process-wide lock serialises build and load, because the serving
engine's executor thread and the hot-swap watcher's bucket warm-up can both
make the first call. Concurrent processes each compile to a private
temporary file and ``os.replace`` it into place, so a reader never sees a
half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Iterable, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p


def _bind_fused_fm(lib: ctypes.CDLL) -> None:
    fwd = lib.dfm_fused_fm_fwd
    fwd.argtypes = [_P, _P, _P, _P, ctypes.c_int64, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, _P]
    fwd.restype = ctypes.c_int
    bwd = lib.dfm_fused_fm_bwd
    bwd.argtypes = [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, _P]
    bwd.restype = ctypes.c_int


def _bind_embedding(lib: ctypes.CDLL) -> None:
    ptrs = ctypes.POINTER(ctypes.c_void_p)  # a host array of device pointers
    ints = ctypes.POINTER(ctypes.c_int64)
    plan = lib.dfm_plan_build
    plan.argtypes = [_P, _P, _P, _P, _P, ints, ctypes.c_int, ctypes.c_int64,
                     _P]
    plan.restype = ctypes.c_int
    fwd = lib.dfm_take_fwd
    fwd.argtypes = [ptrs, ptrs, ptrs, ints, ctypes.c_int, _P,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _P]
    fwd.restype = ctypes.c_int
    bwd = lib.dfm_take_bwd
    bwd.argtypes = [_P, ptrs, ptrs, ptrs, ints, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int, _P, _P, _P]
    bwd.restype = ctypes.c_int
    install = lib.dfm_install
    install.argtypes = [ptrs, ints, ctypes.c_int, _P, ctypes.c_int64,
                        ctypes.c_int64, _P]
    install.restype = ctypes.c_int
    segments = lib.dfm_segments
    segments.argtypes = [_P, ctypes.c_int, _P, ints, ctypes.c_int,
                         ctypes.c_int64, _P, _P, _P, ctypes.c_int64, _P]
    segments.restype = ctypes.c_int
    scratch = lib.dfm_segments_scratch
    scratch.argtypes = [ctypes.c_int, ctypes.c_int64]
    scratch.restype = ctypes.c_int64


def _bind_optimizer(lib: ctypes.CDLL) -> None:
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    ints = ctypes.POINTER(ctypes.c_int64)
    adagrad = lib.dfm_sparse_adagrad
    adagrad.argtypes = [ptrs, ints, ints, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float, ctypes.c_float, _P]
    adagrad.restype = ctypes.c_int


# Kernel library name -> function that declares its C signatures.
_BINDERS: Dict[str, Callable[[ctypes.CDLL], None]] = {
    "fused_fm": _bind_fused_fm,
    "embedding": _bind_embedding,
    "optimizer": _bind_optimizer,
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise KernelBuildError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the port's CUDA "
        "kernels are built from source at first use")


def _source(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    """Where the build of ``csrc/<name>.cu`` lives, keyed on its content."""
    h = hashlib.sha256()
    with open(_source(name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start nvcc for ``name`` unless its library is already built; returns
    ``(process, temporary output, final output)`` or None."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, _source(name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, proc: subprocess.Popen, tmp: str,
                  out: str) -> Optional[str]:
    """Wait for one nvcc; install its library, or return its error text."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}"
    os.replace(tmp, out)
    return None


def build(names: Optional[Iterable[str]] = None) -> float:
    """Build the named kernels (default: all), one nvcc per source, all
    started together. Returns the wall seconds spent; raises on failure."""
    names = list(_BINDERS if names is None else names)
    t0 = time.perf_counter()
    with _lock:
        started = [(n, _start_build(n)) for n in names]
        errors = [_finish_build(n, *job) for n, job in started if job]
        errors = [e for e in errors if e]
        if errors:
            raise KernelBuildError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(library_path(name))
            _BINDERS[name](lib)
            _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
