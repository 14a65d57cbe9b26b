"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface: ``nvcc`` compiles every ``.cu`` file
under ``csrc/`` for ``sm_90a`` into one shared library, which is loaded with
``ctypes``. The build happens at first use, from the repository's sources
alone, into ``mola_fe_lidar_tpu_torch/build/`` (ignored by git); the file
name carries a hash of the sources, so an edited kernel is never served
from a stale library. Nothing here runs at import time: machines without
``nvcc`` (the CPU test hosts) import the package and never build.
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
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
# seconds the last build took in this process (0.0 when a built library was
# reused) and the compiler's resource report (-Xptxas -v)
build_seconds = 0.0
build_log = ""


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on "
                       "this machine (CUDA tensors need them)")


def build() -> Path:
    """Compile ``csrc/*.cu`` into the build directory (once per source
    hash) and return the library path."""
    global build_seconds, build_log
    out = BUILD_DIR / f"libmola_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, cu)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.mola_knn_launch.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                            vp, vp, vp, vp, vp]
            lib.mola_knn_launch.restype = i32
            lib.mola_nn_launch.argtypes = [vp, vp, vp, vp, i32, i32, i32,
                                           vp, vp, vp, vp, vp]
            lib.mola_nn_launch.restype = i32
            lib.mola_cuda_error_string.argtypes = [i32]
            lib.mola_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a failed launch."""
    if code != 0:
        msg = (library().mola_cuda_error_string(code).decode()
               if code > 0 else "unsupported argument")
        raise RuntimeError(f"{what} launch failed: {msg} (code {code})")
