"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface: ``nvcc`` compiles every ``.cu`` file
under ``csrc/`` for ``sm_90a`` (one compiler process per file, all started
together) and links the objects into one shared library, which is loaded
with ``ctypes``. The build happens at first use, from the repository's sources
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
# seconds the last build took in this process (0.0 when a built library was
# reused) and the compiler's resource report (-Xptxas -v)
build_seconds = 0.0
build_log = ""


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest(flags) -> str:
    h = hashlib.sha256()
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
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


def build(defines=()) -> Path:
    """Compile ``csrc/*.cu`` into the build directory (once per source
    hash and flags) and return the library path. ``defines`` (``-D``
    options) make the timing variants of ``scripts/torch_knn_sweep.py``."""
    global build_seconds, build_log
    flags = (*NVCC_FLAGS, *defines)
    out = BUILD_DIR / f"libmola_kernels_{_digest(flags)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tmpdir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objs = [tmpdir / f"{p.stem}.o" for p in cu]
        procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", str(o), str(p)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(cu, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        build_log = "".join(f"== {p.name}\n{log}" for p, log in zip(cu, logs))
        failed = [p.name for p, proc in zip(cu, procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp = tmpdir / "lib.so"
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out


def load(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its C entry points."""
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # src, src_mask, tgt, tgt_mask, n, m, [k,] batch, the four lane strides,
    # rows, cluster, tiles, part_len, chunk, smem, out_dist, out_idx, stream
    lib.mola_knn_launch.argtypes = [vp] * 4 + [i32] * 4 + [i64] * 4 + [i32] * 6 + [vp] * 3
    lib.mola_knn_launch.restype = i32
    lib.mola_nn_launch.argtypes = [vp] * 4 + [i32] * 3 + [i64] * 4 + [i32] * 6 + [vp] * 3
    lib.mola_nn_launch.restype = i32
    lib.mola_knn_max_active_clusters.argtypes = [i32] * 4
    lib.mola_knn_max_active_clusters.restype = i32
    lib.mola_cuda_error_string.argtypes = [i32]
    lib.mola_cuda_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it on first call."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a failed launch."""
    if code != 0:
        msg = (library().mola_cuda_error_string(code).decode()
               if code > 0 else "unsupported argument")
        raise RuntimeError(f"{what} launch failed: {msg} (code {code})")
