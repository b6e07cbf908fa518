"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``.cu`` source under ``repro_torch/csrc`` is compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, loaded with ``ctypes``. The library lands in the repo's
``build/kernels/`` directory (git-ignored), keyed by a hash of the source, the
shared headers and the flags, so an edited source rebuilds and an unchanged
one loads at once.
``load_libraries`` starts one ``nvcc`` per source, all together. Nothing
here runs at import: the CPU tests import every module of the port without a
compiler. The helpers at the end are what every kernel wrapper uses to check
its tensors and call a typed entry point.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
#: seconds each library took to build in this process (about 0 when it was
#: found already built), and what ``ptxas -v`` said about its kernels when
#: this process built it
build_seconds: dict[str, float] = {}
build_log: dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else
    the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from source at first use"
    )


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library.
    Builds of different sources may run at once; one source builds once."""
    with _lock:
        lock = _name_locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        src = CSRC / f"{name}.cu"
        # the shared headers count too: an edited header rebuilds its users
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(
            src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        t0 = time.perf_counter()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # build into a temporary name, then rename: a concurrent builder
            # never loads a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed for {src.name} ({proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, out)
            build_log[name] = proc.stdout + proc.stderr
        build_seconds[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib


def load_libraries(names) -> dict[str, ctypes.CDLL]:
    """Build the named sources in parallel (one ``nvcc`` each, all started
    together) and load them."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(load_library, names)))


# ---- calling an entry point ------------------------------------------------
PTR = ctypes.c_void_p
INT = ctypes.c_int
_typed: dict[str, ctypes.CDLL] = {}


def typed_library(name: str, signatures: dict) -> ctypes.CDLL:
    """``load_library(name)`` with each entry point's argument types set
    (every entry point returns its ``cudaError_t`` as an int)."""
    lib = _typed.get(name)
    if lib is None:
        lib = load_library(name)
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _typed[name] = lib
    return lib


def check_tensor(name, t, dtype, ndim, device) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-d tensor of ``dtype`` on
    ``device`` (``dtype`` may be a tuple of allowed types)."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes or t.dim() != ndim:
        raise TypeError(
            f"{name}: expected {ndim}-d {'/'.join(map(str, dtypes))}, got "
            f"{t.dim()}-d {t.dtype}"
        )
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``: every kernel launches there."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {rc}")
