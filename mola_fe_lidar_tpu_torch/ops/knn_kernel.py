"""K1: exact k-NN on the card -- the port of the Pallas kernel
``mola_fe_lidar_tpu/ops/pallas_knn.py::_knn_kernel`` (wrapper
``pallas_knn``).

``knn`` launches the CUDA kernel in ``csrc/knn.cu`` (design and bounds in
``csrc/knn_common.cuh``) for CUDA tensors and returns the plain twin
``ops.matching.knn`` for CPU tensors; any other device raises. On the main
path it serves the candidate-cache refreshes (k = 4 for decimated -> planes
and k = 8 for edges -> edges) and the point-to-line matcher (k = 5); on the
pairwise-registration path the ``point2plane_knn`` matcher (k = 6), the kNN
normals (k = 8) and the GICP covariances (k = 10).

Like the Pallas kernel, K1 takes any k <= 128 (a larger k raises). It is
compiled for the list lengths ``COMPILED_K``: ``REGISTER_K`` keep their
lists in registers (``csrc/knn_common.cuh::knn_search``), ``SHARED_K`` in
shared memory (``knn_search_shared``, R = 1). Any other k runs at the next
compiled length and returns the first k columns (:func:`compiled_k`). That
is exact: both lists are in (d2, index) order, and the fill for missing
neighbours (the sentinel with index 0) comes after every real neighbour.

Both wrappers take one search (``src [N,3]``, ``tgt [M,3]``) or a batch of
B independent ones (``src [B,N,3]``, ``tgt [B,M,3]``, masks ``[B,N]`` /
``[B,M]``) in one launch: the nearby-keyframe batch and the loop-closure
Monte-Carlo batch. Each lane must be contiguous; an operand whose lane
stride is 0 (``Tensor.expand`` of one cloud) is shared, never copied.

:func:`plan_launch` is the host-side launch plan shared with K2
(``ops/nn_kernel.py``): a pure function of the shape and the SM count, so
the CPU tests check it without a card.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch

from . import cuda_build
from .matching import NNResult, knn as knn_plain

#: list lengths compiled with the lists in registers, and in shared memory
#: (``csrc/knn.cu`` instantiates exactly these; ``-Xptxas -v`` shows no
#: spills at any of them)
REGISTER_K = (1, 4, 5, 6, 8, 10, 16)
SHARED_K = (32, 64, 128)
COMPILED_K = REGISTER_K + SHARED_K
MAX_K = 128        # the Pallas wrapper's limit (pallas_knn.py:133)
#: sources per thread compiled for every register length (the shared-
#: memory lengths take R = 1 only)
ROWS = (1, 2)
THREADS = 128      # threads per block (csrc: kThreads)
WARPS = THREADS // 32  # target parts a block: one a warp (csrc: kWarps)
STEP_ALIGN = 8     # part and chunk lengths are multiples of it (csrc: kStepAlign)
CLUSTERS = (1, 2, 4, 8)  # blocks per cluster: the portable sizes
STAGE_TARGETS = 6144     # targets a block stages at once (96 KB at 16 B each)
SHARED_STAGE_TARGETS = 2048  # the same beside shared-memory lists (32 KB)
MIN_PART = 1024    # targets below which a part costs more than more blocks gain
MAX_TILES = 65535  # grid.y limit

#: launches of the CUDA kernel through :func:`knn` (plain-twin calls on the
#: CPU do not count), in all and per ``(B, n, m, k)`` (B = 1 unbatched)
launches = 0
launches_by_shape: Counter = Counter()


class LaunchPlan(NamedTuple):
    """One launch of ``csrc/knn_common.cuh::knn_search``: a grid of
    ``(cluster, tiles)`` blocks of ``THREADS`` threads. Each block holds a
    tile of ``32 * rows`` sources; its ``WARPS`` warps and the ``cluster``
    blocks of its cluster split the targets into ``parts`` contiguous parts
    of ``part_len`` targets, in ascending order (cluster rank major, warp
    minor)."""
    rows: int      # sources per thread (R)
    cluster: int   # blocks per cluster (C)
    tiles: int     # source tiles (grid.y)
    part_len: int  # targets per part, a multiple of STEP_ALIGN
    chunk: int     # targets per part staged at once, a multiple of STEP_ALIGN
    smem: int      # dynamic shared memory of a block, bytes

    @property
    def parts(self) -> int:
        return self.cluster * WARPS

    @property
    def tile(self) -> int:
        return 32 * self.rows

    @property
    def blocks(self) -> int:
        return self.cluster * self.tiles


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def compiled_k(k: int) -> int:
    """The compiled list length a request for ``k`` neighbours runs at:
    the smallest of ``COMPILED_K`` that is at least ``k``."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn kernel supports 1 <= k <= {MAX_K}, got {k}")
    return next(c for c in COMPILED_K if c >= k)


def rows_for(k: int) -> tuple:
    """The sources-per-thread counts compiled for a request of ``k``."""
    return ROWS if compiled_k(k) in REGISTER_K else (1,)


def make_plan(n: int, m: int, k: int, rows: int, cluster: int,
              stage_targets: int = 0) -> LaunchPlan:
    """The plan for a request of ``k`` with these choices: ``m`` cut into
    ``cluster * WARPS`` equal parts (rounded up to STEP_ALIGN), each staged
    ``stage_targets // WARPS`` targets at a time (by default
    ``STAGE_TARGETS``, or ``SHARED_STAGE_TARGETS`` for a shared-memory
    length)."""
    kc = compiled_k(k)
    if rows not in rows_for(k):
        raise ValueError(f"k={k} runs at {kc}, compiled for R in {rows_for(k)}, got {rows}")
    shared = kc in SHARED_K
    stage_targets = stage_targets or (SHARED_STAGE_TARGETS if shared else STAGE_TARGETS)
    part_len = _round_up(-(-m // (cluster * WARPS)), STEP_ALIGN)
    chunk = min(part_len, max(STEP_ALIGN, (stage_targets // WARPS) // STEP_ALIGN * STEP_ALIGN))
    tiles = -(-n // (32 * rows))
    # staged targets (x, y, z and mask: 16 B) and the per-part sorted lists
    # (d2 f32 + index i32) of the warps: aliased over the staging after the
    # scan for register lists, beside it for shared-memory lists
    staged, lists = WARPS * chunk * 16, THREADS * rows * kc * 8
    smem = staged + lists if shared else max(staged, lists)
    return LaunchPlan(rows, cluster, tiles, part_len, chunk, smem)


def step_len(k: int) -> int:
    """Targets a scan step covers (csrc: ``step_len<K>``)."""
    return 8 if k <= 5 else 4


def plan_launch(n: int, m: int, k: int, sm_count: int) -> LaunchPlan:
    """The launch plan for ``n`` sources, ``m`` targets and a request of
    ``k`` neighbours (run at ``compiled_k(k)``) on a card with ``sm_count``
    SMs, by a rule that picks the fastest plan of
    ``scripts/torch_knn_sweep.py`` at every main-path shape:

    * R = 2 sources a thread (one shared load feeds two pairs) when tiles of
      64 sources still give half an SM count of blocks and the lists are in
      registers, else 1;
    * the smallest cluster that gives at least half an SM count of blocks
      (two warps a sub-partition), doubled while the blocks still fit two
      to an SM and the parts keep ``MIN_PART`` targets."""
    if n < 1 or m < 1:
        raise ValueError(f"plan_launch needs n, m >= 1, got {n}, {m}")
    rows = 2 if 2 * -(-n // 64) >= sm_count and 2 in rows_for(k) else 1
    tiles = -(-n // (32 * rows))
    if tiles > MAX_TILES:
        raise ValueError(f"plan_launch: {n} sources exceed {MAX_TILES} tiles")
    cluster = next((c for c in CLUSTERS if 2 * c * tiles >= sm_count), CLUSTERS[-1])
    while (cluster < CLUSTERS[-1] and 2 * cluster * tiles <= 2 * sm_count
           and m // (2 * cluster * WARPS) >= MIN_PART):
        cluster *= 2
    return make_plan(n, m, k, rows, cluster)


_sm_counts: dict = {}
_plans: dict = {}


def cached_plan(device: torch.device, n: int, m: int, k: int) -> LaunchPlan:
    """:func:`plan_launch` for a CUDA device, memoised per device and
    shape (the SM count is read once per device)."""
    dev = device.index
    key = (dev, n, m, k)
    plan = _plans.get(key)
    if plan is None:
        if dev not in _sm_counts:
            _sm_counts[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = _plans[key] = plan_launch(n, m, k, _sm_counts[dev])
    return plan


def check_inputs(src, src_mask, tgt, tgt_mask) -> int:
    """Shared argument checks of the K1/K2 wrappers; returns the batch size
    B (1 for unbatched inputs)."""
    dev = src.device
    batched = src.dim() == 3
    lead = tuple(src.shape[:1]) if batched else ()
    for name, x, shape in (("src", src, (*lead, None, 3)),
                           ("src_mask", src_mask, (*lead, src.shape[-2])),
                           ("tgt", tgt, (*lead, None, 3)),
                           ("tgt_mask", tgt_mask, (*lead, tgt.shape[-2]))):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, src on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, x.shape)):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, want {shape}")
        if batched and x.shape[0] == 0:
            raise ValueError("empty batch")
        if not (x[0] if batched else x).is_contiguous():
            raise ValueError(f"{name} must be contiguous" + (" in each lane" if batched else ""))
    if tgt.shape[-2] == 0:
        raise ValueError("empty target cloud")
    return src.shape[0] if batched else 1


def launch(src, src_mask, tgt, tgt_mask, k: int, plan: LaunchPlan, dist, idx,
           lib=None) -> None:
    """One launch of the search with an explicit plan into ``dist``/``idx``
    (``[..., n, k]`` for a compiled length ``k``, or ``[..., n]`` for K2),
    through K2's entry point for the 1-NN form and K1's otherwise, on the
    current stream of the tensors' device. A batch runs its lanes on
    grid.z, each with ``plan``. The wrappers call it; tuning runs may call
    it with another plan or another build of the library (``lib``)."""
    lib = lib or cuda_build.library()
    dev = src.device.index
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch(src, src_mask, tgt, tgt_mask, k, plan, dist, idx, lib)
    batched = src.dim() == 3
    lane_strides = tuple(x.stride(0) if batched else 0 for x in (src, src_mask, tgt, tgt_mask))
    ptrs = (src.data_ptr(), src_mask.data_ptr(), tgt.data_ptr(), tgt_mask.data_ptr(),
            src.shape[-2], tgt.shape[-2])
    shape = (src.shape[0] if batched else 1, *lane_strides,
             plan.rows, plan.cluster, plan.tiles, plan.part_len,
             plan.chunk, plan.smem, dist.data_ptr(), idx.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if dist.dim() < src.dim():
        cuda_build.check(lib.mola_nn_launch(*ptrs, *shape), "nearest_neighbors")
    else:
        cuda_build.check(lib.mola_knn_launch(*ptrs, k, *shape), "knn")


def knn(src, src_mask, tgt, tgt_mask, k: int) -> NNResult:
    """Exact k-NN, ``idx i32[..., N, k]`` / ``dist f32[..., N, k]``
    ascending (the ``pallas_knn`` contract; see ``ops/matching.py``), for
    any ``1 <= k <= MAX_K``."""
    global launches
    if src.device.type == "cpu":
        return knn_plain(src, src_mask, tgt, tgt_mask, k)
    if src.device.type != "cuda":
        raise ValueError(f"knn: unsupported device {src.device}")
    kc = compiled_k(k)
    batch = check_inputs(src, src_mask, tgt, tgt_mask)
    n, m = src.shape[-2], tgt.shape[-2]
    dist = torch.empty((*src.shape[:-1], kc), dtype=torch.float32, device=src.device)
    idx = torch.empty((*src.shape[:-1], kc), dtype=torch.int32, device=src.device)
    if n > 0:
        launch(src, src_mask, tgt, tgt_mask, kc, cached_plan(src.device, n, m, k), dist, idx)
        launches += 1
        launches_by_shape[(batch, n, m, k)] += 1
    if kc != k:
        dist, idx = dist[..., :k].contiguous(), idx[..., :k].contiguous()
    return NNResult(idx, dist)
