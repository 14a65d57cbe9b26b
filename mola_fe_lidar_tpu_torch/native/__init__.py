"""ctypes bindings for the native C++ runtime: the local pose graph
(``pose_graph.cpp``, O(E log V) Dijkstra) and the KITTI ``.bin`` reader
(``io.cpp``), copies of the JAX package's sources with the same surface
(``NativePoseGraph``, ``kitti_read_bin_native``, ``NATIVE_AVAILABLE``).

``g++`` compiles the two sources into one shared library at first use,
never at import, into ``mola_fe_lidar_tpu_torch/build/`` (ignored by git).
The file name carries a hash of the sources, the flags and the machine
type, so an edited source is never served from a stale library; the
library is written under a temporary name and renamed into place, so
processes that build at once each see a whole file. Without ``g++`` the
library is unavailable, ``NATIVE_AVAILABLE`` is false and
``frontend/pose_graph.py::make_pose_graph`` returns the pure-Python graph;
:data:`build_error` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "build"
SOURCES = ("pose_graph.cpp", "io.cpp")
# no -march=native: the library may be reused on another host; no FMA
# contraction, so a pose composes with the same roundings everywhere
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

_lock = threading.Lock()
_lib = None
_tried = False
build_error = ""  # why the library is unavailable ("" when it loaded)


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((_DIR / name).read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(platform.machine().encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources into the build directory (once per hash) and
    return the library path; raise if ``g++`` is missing or fails."""
    out = BUILD_DIR / f"libmola_native_{_digest()}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native runtime cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmpdir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        tmp = tmpdir / "lib.so"
        proc = subprocess.run([gxx, *GXX_FLAGS, *(str(_DIR / s) for s in SOURCES),
                               "-o", str(tmp)], capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    c_dp = ctypes.POINTER(ctypes.c_double)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_fp = ctypes.POINTER(ctypes.c_float)
    lib.pg_create.restype = vp
    lib.pg_destroy.argtypes = [vp]
    lib.pg_insert_node.argtypes = [vp, i64]
    lib.pg_insert_edge.argtypes = [vp, i64, i64, c_dp, c_dp]
    lib.pg_has_edge.argtypes = [vp, i64, i64]
    lib.pg_has_edge.restype = ctypes.c_int
    for name in ("pg_num_nodes", "pg_num_edges", "pg_root"):
        getattr(lib, name).argtypes = [vp]
        getattr(lib, name).restype = i64
    lib.pg_remove_node.argtypes = [vp, i64]
    lib.pg_dijkstra.argtypes = [vp, i64, i64, c_i64p, c_i64p, c_dp, c_dp]
    lib.pg_dijkstra.restype = i64
    lib.kitti_read_bin.argtypes = [ctypes.c_char_p, i64, ctypes.c_float, ctypes.c_float,
                                   i64, c_fp, c_fp]
    lib.kitti_read_bin.restype = i64
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None (and
    :data:`build_error` set) when it cannot be built or loaded. A failure
    is not retried within the process."""
    global _lib, _tried, build_error
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            try:
                _lib = _declare(ctypes.CDLL(str(build())))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                build_error = f"{type(e).__name__}: {e}"
            _tried = True
    return _lib


def __getattr__(name):
    # NATIVE_AVAILABLE, as in the reference, but built at its first read,
    # not at import
    if name == "NATIVE_AVAILABLE":
        return _load() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativePoseGraph:
    """C++-backed pose graph with the surface of
    :class:`..frontend.pose_graph.PoseGraph`. The C++ edge vector can
    reallocate on insert: readers of a graph that another thread extends
    hold that thread's lock (the module's ``_state_lock``)."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable ({build_error})")
        self._lib = lib
        self._h = lib.pg_create()
        self._nodes = set()  # host mirror for O(1) membership queries

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pg_destroy(h)
            self._h = None

    def __len__(self):
        return int(self._lib.pg_num_nodes(self._h))

    @property
    def root(self) -> Optional[int]:
        r = int(self._lib.pg_root(self._h))
        return None if r < 0 else r

    @property
    def num_edges(self) -> int:
        return int(self._lib.pg_num_edges(self._h))

    @property
    def nodes(self):
        return self._nodes

    def insert_node(self, node: int) -> None:
        self._nodes.add(node)
        self._lib.pg_insert_node(self._h, node)

    def insert_edge(self, a: int, b: int, R: np.ndarray, t: np.ndarray) -> None:
        """Add an edge with the pose of ``b`` in frame ``a``."""
        self._nodes.add(a)
        self._nodes.add(b)
        # the C side reads 9 + 3 doubles: a wrong size raises here
        R = np.ascontiguousarray(R, np.float64).reshape(3, 3)
        t = np.ascontiguousarray(t, np.float64).reshape(3)
        self._lib.pg_insert_edge(self._h, a, b, _ptr(R, ctypes.c_double),
                                 _ptr(t, ctypes.c_double))

    def has_edge(self, a: int, b: int) -> bool:
        return bool(self._lib.pg_has_edge(self._h, a, b))

    def remove_node(self, node: int) -> None:
        self._nodes.discard(node)
        self._lib.pg_remove_node(self._h, node)

    def dijkstra_nodes_estimate(
        self, source: Optional[int] = None
    ) -> Tuple[Dict[int, Tuple[np.ndarray, np.ndarray]], Dict[int, int]]:
        """(poses {node: (R, t)} in the source's frame, hops {node: n}) of
        every node reachable from ``source`` (the root if None)."""
        cap = max(len(self), 1)
        nodes = np.empty(cap, np.int64)
        topo = np.empty(cap, np.int64)
        Rs = np.empty((cap, 3, 3), np.float64)
        ts = np.empty((cap, 3), np.float64)
        n = min(cap, int(self._lib.pg_dijkstra(
            self._h, -1 if source is None else source, cap, _ptr(nodes, ctypes.c_int64),
            _ptr(topo, ctypes.c_int64), _ptr(Rs, ctypes.c_double), _ptr(ts, ctypes.c_double))))
        poses = {int(nodes[i]): (Rs[i].copy(), ts[i].copy()) for i in range(n)}
        return poses, {int(nodes[i]): int(topo[i]) for i in range(n)}


def kitti_read_bin_native(path: str, stride: int = 1, min_range: float = 0.0,
                          max_range: float = 0.0, max_points: int = 200_000,
                          want_intensity: bool = True):
    """Read a KITTI velodyne ``.bin`` with ``stride`` decimation and range
    gating (``max_range <= 0``: unlimited); returns (xyz [n, 3] f32,
    intensity [n] f32 or None)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable ({build_error})")
    xyz = np.empty((max_points, 3), np.float32)
    inten = np.empty(max_points, np.float32) if want_intensity else None
    n = int(lib.kitti_read_bin(str(path).encode(), stride, min_range, max_range, max_points,
                               _ptr(xyz, ctypes.c_float),
                               _ptr(inten, ctypes.c_float) if inten is not None else None))
    if n < 0:
        raise IOError(f"cannot read {path}")
    return xyz[:n], (inten[:n] if inten is not None else None)
