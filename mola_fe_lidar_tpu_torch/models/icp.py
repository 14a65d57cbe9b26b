"""The ICP engine on tensors (port of ``mola_fe_lidar_tpu/models/icp.py``).

Ported: the matchers ``point2point``, ``point2plane_normals``,
``point2plane_knn`` (a plane fit to the kNN neighbourhood every iteration),
``point2line_knn`` and ``gicp`` (residuals whitened by the combined surface
covariances); point-to-point pairings folded into the plane-row system as
three axis-normal rows; the scale-outlier gate and the robust kernels; the
Gauss-Newton solver with its weak prior and the closed-form Horn and OLAE
solvers; the paired-ratio quality with its fixed subsample and its
symmetric (reverse-direction) form; the candidate cache (top-K refresh
every ``cand_refresh`` iterations, exact re-argmin over the K candidates in
between; opt-in for the kNN matchers with ``cand_k >= knn``; with
``cand_refresh_min_trans`` / ``_rot`` a block head refreshes only once the
pose has moved that far since the last refresh), the plain loop and its
Anderson-accelerated form (``anderson_m``: type-II Anderson extrapolation
on the SE(3) chart at the initial pose, with the reference's revert and
reset rules; incompatible with candidate caches, as in the reference).
Nearest-neighbour searches go through the hand-written kernels
(``ops/knn_kernel.py`` K1, ``ops/nn_kernel.py`` K2), which take their plain
twins for CPU tensors: every exact ``nn_backend`` of the reference is the
same exact search here. ``nn_backend="grid"`` is the reference's voxel hash
(``ops/grid_nn.py``, radius-limited at the matcher's distance threshold) for
the 1-NN of ``point2point``, ``point2plane_normals`` and ``gicp`` where no
candidate cache serves the matcher (the final covariance system included);
its index is built once per align per matcher. The kNN matchers stay on K1
and a split target on the split K2, as in the reference.

Tensor parallelism (``shard_axis``, the reference's ``shard_map`` over a
``model`` axis, ``parallel/distributed.py``): every target layer is a
``ShardedCloud`` (its point axis split over the axis's positions) and every
search and gather of a target goes through ``ops/tp.py``; the candidate
cache is off, as in the reference. A symmetric quality's reverse direction
pairs the whole target, gathered to the source's device (the reference
pairs one slice there, ROADMAP Queue 3).

The reference runs the whole loop as one ``lax.while_loop``. Here the host
reads the iteration count and the convergence flag once per block of
``cand_refresh`` iterations (4 for the plain loop); inside a block,
converged or over-budget iterations are frozen exactly as the reference's
``_cand_block`` freezes them, so the iterates are the reference's.

Batches (the reference's ``vmap`` of ``align``, ``parallel/batch.py``): an
``init_pose`` with a leading axis ``[B]`` aligns B lanes at once. Layers
given as one cloud ``[N,3]`` are shared by every lane (a stride-0 expand,
never copied); layers ``[B,N,3]`` are per lane. Each lane has its own
iteration count and convergence flag and is frozen once it is done, as
under ``vmap`` of the ``while_loop``; the loop ends when every lane is done
or at the cap, with one host read per block for the whole batch, and every
search of a block is one K1/K2 launch for all lanes.

Spans (``utils/profiler.py``, recorded only under ``torch.profiler``): one
``icp.align`` a call, around the leaves ``icp.refresh`` (a block head's
candidate refresh), ``icp.match`` and ``icp.solve`` (each iteration's
pairings, then its solve, freeze and convergence test), ``icp.read`` (the
block's host read) and ``icp.final`` (covariance and quality). Its counters
come from values the host already holds: ``lanes``, ``block``, ``blocks``,
``iterations`` (blocks x block, the iterations dispatched) and
``lane_iterations`` (the lanes' final iteration counts summed, from the
last block's read).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..cloud.metric_map import MetricMap, PointCloud, ShardedCloud
from ..geometry import se3
from ..ops import eigen3, grid_nn, knn_kernel, nn_kernel, tp
from ..ops.matching import NNResult
from ..solve import gauss_newton, horn, olae, robust
from ..solve import quality as quality_mod
from ..utils import profiler
from .config import ICPParams, Matcher

TERM_CONVERGED = 0
TERM_MAX_ITERS = 1
_PLAIN_BLOCK = 4  # iterations between host convergence reads, plain loop

_CAND_KINDS = ("point2point", "point2plane_normals")
_CAND_KNN_KINDS = ("point2plane_knn", "point2line_knn")
_MATCHERS = ("point2point", "point2plane_normals", "point2plane_knn", "point2line_knn", "gicp")
_SOLVERS = ("gauss_newton", "horn", "olae")
_EXACT_BACKENDS = ("auto", "xla", "fused", "mxu", "pallas")


class ICPResult(NamedTuple):
    pose: se3.Pose
    cov: torch.Tensor           # f32[..., 6, 6]
    quality: torch.Tensor       # f32[...]
    n_iterations: torch.Tensor  # i32[...]
    term_reason: torch.Tensor   # i32[...]


class _Pairings(NamedTuple):
    p: torch.Tensor  # f32[..., K, 3] source points (untransformed)
    q: torch.Tensor  # f32[..., K, 3] matched target points / plane anchors
    n: torch.Tensor  # f32[..., K, 3] plane normals (zeros for p2p rows)
    w: torch.Tensor  # f32[..., K] weights (0 drops)
    is_plane: bool = True


def _resolve_backend(backend: str) -> None:
    """Every exact backend of the reference is the same search in the
    port: K1/K2 on CUDA tensors, their plain twins on CPU tensors;
    ``"grid"`` is the voxel hash."""
    if backend not in _EXACT_BACKENDS and backend != "grid":
        raise ValueError(f"unknown nn_backend {backend!r}")


def check_params(params: ICPParams) -> None:
    """Raise ValueError for settings the reference rejects."""
    for m in params.matchers:
        if m.kind not in _MATCHERS:
            raise ValueError(f"unknown matcher kind {m.kind!r}")
        _resolve_backend(m.nn_backend)
    if params.solver.kind not in _SOLVERS:
        raise ValueError(f"unknown solver kind {params.solver.kind!r}")
    if params.solver.kind != "gauss_newton" and not any(
            m.kind == "point2point" for m in params.matchers):
        raise ValueError(f"{params.solver.kind} solver needs at least one point2point matcher")
    if params.weights.use_robust_kernel and params.weights.robust_kernel not in robust.ROBUST_KERNELS:
        raise ValueError(f"unknown robust kernel {params.weights.robust_kernel!r}")
    for q in params.quality:
        if q.kind != "paired_ratio":
            raise ValueError(f"unknown quality kind {q.kind!r}")


def _check_sharding(params: ICPParams, tgt_map) -> None:
    """Under ``shard_axis`` every target layer the stages read is split
    over the mesh, and split only then."""
    layers = {m.tgt_layer for m in params.matchers} | {q.tgt_layer for q in params.quality}
    for name in layers:
        if isinstance(tgt_map[name], ShardedCloud) != (params.shard_axis is not None):
            raise ValueError(
                f"target layer {name!r}: shard_axis={params.shard_axis!r} needs the target "
                "split over the mesh's positions exactly when it is set "
                "(parallel.make_sharded_align)")


def _cand_eligible(m: Matcher) -> bool:
    if m.cand_k <= 0:
        return False
    if m.kind in _CAND_KINDS:
        return True
    return m.kind in _CAND_KNN_KINDS and m.cand_k >= m.knn


def _c(x: torch.Tensor) -> torch.Tensor:
    """Contiguous in each lane; a lane-shared operand (stride-0 lane axis)
    stays shared."""
    if x.dim() > 1 and x.stride(0) == 0:
        return x[0].contiguous().expand_as(x)
    return x.contiguous()


def _take(pc: PointCloud, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for a field ``x`` of the cloud ``pc``, per lane when the
    cloud is batched (``x [B, M, ...]``, ``idx [B, ...]``)."""
    if pc.xyz.dim() == 2:
        return x[idx]
    lane = torch.arange(idx.shape[0], device=idx.device)
    return x[lane.view(-1, *([1] * (idx.dim() - 1))), idx]


def _nn_1(sp, src_mask, tgt) -> NNResult:
    return nn_kernel.nearest_neighbors(_c(sp), _c(src_mask), _c(tgt.xyz), _c(tgt.mask))


def _refresh_cands(m: Matcher, pose, src, tgt) -> torch.Tensor:
    """Top-``cand_k`` candidate indices per source point at ``pose``."""
    sp = se3.transform(pose, src.xyz)
    return knn_kernel.knn(_c(sp), _c(src.mask), _c(tgt.xyz), _c(tgt.mask), m.cand_k).idx


def _cand_sq_dists(sp, tgt, cand_idx):
    cand_idx = cand_idx.long()
    diff = _take(tgt, tgt.xyz, cand_idx) - sp[..., None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    return torch.where(_take(tgt, tgt.mask, cand_idx) > 0.5, d2, torch.full_like(d2, 1e30))


def _knn_from_cands(sp, tgt, cand_idx, k: int) -> NNResult:
    """Exact kNN restricted to the cached candidates (masked TARGETS at
    ~1e15; masked SOURCE rows are not sentineled -- consumers gate on the
    source mask, as in the reference)."""
    d2 = _cand_sq_dists(sp, tgt, cand_idx)
    vals, j = torch.sort(d2, dim=-1, stable=True)  # ties: lower slot first
    idx = torch.gather(cand_idx, -1, j[..., :k])
    return NNResult(idx.to(torch.int32), torch.sqrt(torch.clamp(vals[..., :k], min=0.0)))


def _nn_from_cands(sp, tgt, cand_idx) -> NNResult:
    """Exact re-argmin over the cached candidates (first minimum wins)."""
    vals, j = torch.min(_cand_sq_dists(sp, tgt, cand_idx), dim=-1)
    idx = torch.gather(cand_idx, -1, j[..., None])[..., 0]
    return NNResult(idx.to(torch.int32), torch.sqrt(torch.clamp(vals, min=0.0)))


def _matcher_active(m: Matcher, it: torch.Tensor) -> torch.Tensor:
    act = it >= m.run_from_iteration
    if m.run_up_to_iteration > 0:
        act = act & (it <= m.run_up_to_iteration)
    return act.to(torch.float32)


def _knn_fit(neigh, dist):
    """Centroid, covariance, eigenvalues and valid-neighbour count of kNN
    neighbourhoods (``neigh [..., k, 3]``; sentinel distances are invalid)."""
    valid = (dist < 1e9).to(neigh.dtype)
    _, centroid, cov = eigen3.neighbourhood_covariance(neigh, valid)
    return centroid, cov, eigen3.sym_eigenvalues_3x3(cov), torch.sum(valid, dim=-1)


def _match_one(m: Matcher, pose, it, src_map: MetricMap, tgt_map: MetricMap,
               cand_idx=None, grid=None) -> _Pairings:
    src = src_map[m.src_layer]
    tgt = tgt_map[m.tgt_layer]
    sp = se3.transform(pose, src.xyz)
    act = _matcher_active(m, it)[..., None]
    f32 = sp.dtype

    if isinstance(tgt, ShardedCloud):
        def nn1():
            return tp.tp_nearest_neighbors(sp, src.mask, tgt.xyz, tgt.mask)

        def nnk():
            return tp.tp_knn(sp, src.mask, tgt.xyz, tgt.mask, m.knn)

        take = tp.tp_gather_points
    else:
        def nn1():
            if cand_idx is not None:
                return _nn_from_cands(sp, tgt, cand_idx)
            if grid is not None:
                return grid_nn.grid_nearest_neighbors(sp, src.mask, grid, tgt.xyz, tgt.mask)
            return _nn_1(sp, src.mask, tgt)

        def nnk():
            if cand_idx is not None:
                return _knn_from_cands(sp, tgt, cand_idx, m.knn)
            return knn_kernel.knn(_c(sp), _c(src.mask), _c(tgt.xyz), _c(tgt.mask), m.knn)

        def take(x, idx):
            return _take(tgt, x, idx)

    if m.kind == "point2point":
        nn = nn1()
        q = take(tgt.xyz, nn.idx.long())
        w = src.mask * (nn.dist < m.distance_threshold).to(f32) * act
        return _Pairings(src.xyz, q, torch.zeros_like(q), w, False)

    if m.kind == "point2plane_normals":
        nn = nn1()
        sel = nn.idx.long()
        q = take(tgt.xyz, sel)
        normals = take(tgt.attrs["normal"], sel)
        gate = (take(tgt.attrs["planarity"], sel)[..., 0] if "planarity" in tgt.attrs
                else torch.ones_like(nn.dist))
        w = src.mask * (nn.dist < m.distance_threshold).to(f32) * gate * act
        return _Pairings(src.xyz, q, normals, w)

    if m.kind == "gicp":
        # Generalized ICP: the residual whitened by S = C_q + R C_p Rᵀ. The
        # rows of M⁻¹ (M = chol(S)) satisfy Σ lₖlₖᵀ = S⁻¹: three plane rows
        # a pairing whose non-unit normals carry the information weight
        nn = nn1()
        sel = nn.idx.long()
        q = take(tgt.xyz, sel)
        Cq = take(tgt.attrs["cov"], sel).reshape(*q.shape[:-1], 3, 3)
        Cp = src.attrs["cov"].reshape(*src.xyz.shape[:-1], 3, 3)
        R = pose.R[..., None, :, :]
        Minv = eigen3.invert_lower_3x3(eigen3.cholesky_3x3(Cq + R @ Cp @ R.transpose(-1, -2)))
        w1 = src.mask * (nn.dist < m.distance_threshold).to(f32) * act
        return _Pairings(torch.repeat_interleave(src.xyz, 3, dim=-2),
                         torch.repeat_interleave(q, 3, dim=-2), Minv.flatten(-3, -2),
                         torch.repeat_interleave(w1, 3, dim=-1))

    if m.kind == "point2line_knn":
        # LOAM-style edge matching: line fit to the kNN neighbourhood,
        # linearity gate, two plane rows spanning the line's normal plane
        nn = nnk()
        centroid, cov, evs, n_valid = _knn_fit(take(tgt.xyz, nn.idx.long()), nn.dist)
        dirv = eigen3.largest_eigenvector_3x3(cov, evs)
        linear = evs[..., 2] >= (1.0 / max(m.plane_eigen_threshold, 1e-3)) * torch.clamp(
            evs[..., 1], min=1e-9)
        # the x axis, or the y axis where the line runs along x (built on
        # the device: a constant copied from the host would sync the stream)
        use_x = (torch.abs(dirv[..., 0:1]) < 0.9).to(f32)
        a = torch.cat([use_x, 1.0 - use_x, torch.zeros_like(use_x)], dim=-1)
        n1 = torch.linalg.cross(dirv, a, dim=-1)
        n1 = n1 / torch.clamp(torch.linalg.vector_norm(n1, dim=-1, keepdim=True), min=1e-9)
        n2 = torch.linalg.cross(dirv, n1, dim=-1)
        w1 = (src.mask * (nn.dist[..., 0] < m.distance_threshold).to(f32)
              * linear.to(f32) * (n_valid >= 3.0).to(f32) * act)
        n_rows = torch.stack([n1, n2], dim=-2).flatten(-3, -2)
        return _Pairings(torch.repeat_interleave(src.xyz, 2, dim=-2),
                         torch.repeat_interleave(centroid, 2, dim=-2),
                         n_rows, torch.repeat_interleave(w1, 2, dim=-1))

    if m.kind == "point2plane_knn":
        nn = nnk()
        centroid, cov, evs, n_valid = _knn_fit(take(tgt.xyz, nn.idx.long()), nn.dist)
        # an exactly collinear neighbourhood passes the planar gate but has
        # no normal: its +z fallback is gated out by ``well``
        normal, well = eigen3.smallest_eigenvector_3x3(cov, evs, return_valid=True)
        planar = evs[..., 0] <= m.plane_eigen_threshold * torch.clamp(evs[..., 2], min=1e-12)
        w = (src.mask * (nn.dist[..., 0] < m.distance_threshold).to(f32) * planar.to(f32)
             * well.to(f32) * (n_valid >= 3.0).to(f32) * act)
        return _Pairings(src.xyz, centroid, normal, w)

    raise ValueError(f"unknown matcher kind {m.kind!r}")


def _expand_p2p(pr: _Pairings) -> _Pairings:
    """A point-to-point pairing as three axis-normal plane rows."""
    eye = torch.eye(3, dtype=pr.p.dtype, device=pr.p.device)
    n = eye.repeat(pr.p.shape[-2], 1).expand(*pr.p.shape[:-2], 3 * pr.p.shape[-2], 3)
    return _Pairings(torch.repeat_interleave(pr.p, 3, dim=-2),
                     torch.repeat_interleave(pr.q, 3, dim=-2), n,
                     torch.repeat_interleave(pr.w, 3, dim=-1))


def _apply_pair_weights(pr: _Pairings, pose, params: ICPParams) -> _Pairings:
    """The scale-outlier gate, then the robust kernel's IRLS weights at the
    current pose (point-to-plane or point-to-point residuals)."""
    pw = params.weights
    w = pr.w
    if pw.use_scale_outlier_detector:
        w = robust.scale_outlier_weights(pr.p, pr.q, w, pw.scale_outlier_threshold)
    if pw.use_robust_kernel:
        diff = se3.transform(pose, pr.p) - pr.q
        r = (torch.abs(torch.sum(diff * pr.n, dim=-1)) if pr.is_plane
             else torch.linalg.vector_norm(diff, dim=-1))
        w = w * robust.robust_weights(r, pw.robust_kernel, pw.robust_kernel_param,
                                      pw.robust_kernel_scale)
    return pr._replace(w=w)


def _build_grids(tgt_map, params: ICPParams):
    """The loop-invariant grid index of every ``nn_backend="grid"`` 1-NN
    matcher, at ``cell = distance_threshold`` (the reference's
    ``_prebuild_matcher_aux``; a split target keeps the split K2)."""
    return tuple(
        grid_nn.build_grid(tgt_map[m.tgt_layer].xyz, tgt_map[m.tgt_layer].mask,
                           float(m.distance_threshold))
        if (m.nn_backend == "grid" and params.shard_axis is None
            and m.kind not in _CAND_KNN_KINDS) else None
        for m in params.matchers)


def _gather(pose, it, src_map, tgt_map, params: ICPParams, cands=None, grids=None):
    """Every matcher's pairings, re-weighted: (the plane-row system, the
    raw point-to-point pairings for the closed-form solvers)."""
    plane_rows, p2p_rows = [], []
    for i, m in enumerate(params.matchers):
        pr = _apply_pair_weights(_match_one(m, pose, it, src_map, tgt_map,
                                            cands[i] if cands is not None else None,
                                            grids[i] if grids is not None else None),
                                 pose, params)
        if pr.is_plane:
            plane_rows.append(pr)
        else:
            p2p_rows.append(pr)
            plane_rows.append(_expand_p2p(pr))
    plane = _Pairings(*(torch.cat([getattr(r, f) for r in plane_rows], dim=-2 if f != "w" else -1)
                        for f in ("p", "q", "n", "w")))
    return plane, p2p_rows


def _prior_weights(params: ICPParams, dev) -> torch.Tensor:
    """The weak prior's diagonal weights, or None without a prior."""
    s = params.solver
    if not (s.prior_sigma_trans > 0 or s.prior_sigma_rot > 0):
        return None
    wt = 1.0 / s.prior_sigma_trans ** 2 if s.prior_sigma_trans > 0 else 0.0
    wr = 1.0 / s.prior_sigma_rot ** 2 if s.prior_sigma_rot > 0 else 0.0
    return torch.tensor([wt] * 3 + [wr] * 3, dtype=torch.float32, device=dev)


def _solve(pose, plane: _Pairings, p2p_rows, params: ICPParams, init_pose,
           prior_w) -> se3.Pose:
    s = params.solver
    if s.kind == "gauss_newton":
        return gauss_newton.point_to_plane_step(
            pose, plane.p, plane.q, plane.n, plane.w,
            inner_iterations=s.max_iterations, damping=s.damping,
            prior_pose=init_pose if prior_w is not None else None, prior_w=prior_w).pose
    p, q, w = (torch.cat([getattr(r, f) for r in p2p_rows], dim=-2 if f != "w" else -1)
               for f in ("p", "q", "w"))
    return (olae.weighted_olae if s.kind == "olae" else horn.weighted_horn)(p, q, w)


@functools.lru_cache(maxsize=None)
def _quality_subsample(n: int, keep: int, dev: torch.device) -> torch.Tensor:
    """The reference's fixed quality subsample (numpy, seed 0xC0FFEE), kept
    on ``dev``."""
    return torch.from_numpy(np.sort(np.random.default_rng(0xC0FFEE).permutation(n)[:keep])).to(dev)


def _quality(pose, src_map, tgt_map, params: ICPParams) -> torch.Tensor:
    """Weighted mean of the paired ratios, forced to 0 when an evaluator
    falls below its ``required_min``. A symmetric evaluator also pairs the
    target layer into the source layer under the inverse pose and keeps the
    larger ratio (occlusion-asymmetric loop-closure viewpoints)."""
    dev = pose.t.device
    gate = torch.ones(pose.t.shape[:-1], device=dev)
    if not params.quality:
        return gate
    vals = []
    for qc in params.quality:
        src = src_map[qc.src_layer]
        tgt = tgt_map[qc.tgt_layer]
        sxyz, smask = src.xyz, src.mask
        n = sxyz.shape[-2]
        if qc.max_points and n > qc.max_points:
            sel = _quality_subsample(n, qc.max_points, dev)
            sxyz, smask = sxyz[..., sel, :], smask[..., sel]
        sp = se3.transform(pose, sxyz)
        sharded = isinstance(tgt, ShardedCloud)
        nn = (tp.tp_nearest_neighbors(sp, smask, tgt.xyz, tgt.mask) if sharded
              else _nn_1(sp, smask, tgt))
        ratio = quality_mod.paired_ratio(nn.dist, smask, qc.threshold_distance)
        if qc.symmetric:
            if sharded:  # the whole target, on the source's device
                tgt = PointCloud(torch.cat([x.to(dev) for x in tgt.xyz], dim=-2),
                                 torch.cat([x.to(dev) for x in tgt.mask], dim=-1), {})
            back = se3.transform(se3.inverse(pose), tgt.xyz)
            nn_r = _nn_1(back, tgt.mask, src)
            ratio = torch.maximum(ratio, quality_mod.paired_ratio(
                nn_r.dist, tgt.mask, qc.threshold_distance))
        if qc.weight > 0.0:
            vals.append(qc.weight * ratio)
        if qc.required_min > 0.0:
            gate = gate * (ratio >= qc.required_min).to(ratio.dtype)
    total_w = sum(qc.weight for qc in params.quality if qc.weight > 0.0)
    if not vals:
        return gate
    return gate * functools.reduce(torch.add, vals) / total_w


def _freeze(active, new_pose: se3.Pose, pose: se3.Pose) -> se3.Pose:
    return se3.Pose(torch.where(active[..., None, None], new_pose.R, pose.R),
                    torch.where(active[..., None], new_pose.t, pose.t))


class _Anderson(NamedTuple):
    """Per-lane Anderson history: the last ``m + 1`` Picard residuals
    ``f`` and images ``g`` on the chart (newest last), the valid count, the
    best residual norm since the last reset, the plain Picard image to fall
    back to, and whether the current iterate was extrapolated."""
    Fh: torch.Tensor
    Gh: torch.Tensor
    cnt: torch.Tensor
    best: torch.Tensor
    g_fb: torch.Tensor
    was_aa: torch.Tensor

    @classmethod
    def empty(cls, lanes, m: int, dev) -> "_Anderson":
        z = torch.zeros((*lanes, m + 1, 6), dtype=torch.float32, device=dev)
        return cls(z, z.clone(), torch.zeros(lanes, dtype=torch.int64, device=dev),
                   torch.full(lanes, float("inf"), device=dev),
                   torch.zeros((*lanes, 6), device=dev),
                   torch.zeros(lanes, dtype=torch.bool, device=dev))


def _anderson(h: _Anderson, pose: se3.Pose, new_pose: se3.Pose, converged, init_pose,
              params: ICPParams):
    """The reference's ``body_anderson`` after its Picard step ``pose ->
    new_pose``: type-II Anderson extrapolation (AA-ICP) over the history's
    differences, the ``m x m`` normal equations solved by ``solve_ex`` (no
    host read). An extrapolated iterate whose residual blows past
    ``anderson_reset_ratio`` x the best (or goes non-finite) is reverted to
    the stored Picard image and the history resets; a plain iterate that
    blows up only resets it. No extrapolation outside the rotation basin
    of the chart (|rotation| >= pi/2). Returns (pose, converged, history)."""
    m = params.anderson_m
    inv0 = se3.inverse(init_pose)
    x = se3.log(se3.compose(pose, inv0))
    g = se3.log(se3.compose(new_pose, inv0))
    f = g - x
    fnorm = torch.linalg.vector_norm(f, dim=-1)
    blown = (h.cnt > 0) & ((fnorm > params.anderson_reset_ratio * h.best)
                           | ~torch.isfinite(fnorm))
    # only an extrapolated iterate is reverted; its f and g describe the
    # rejected point and stay out of the history
    revert = blown & h.was_aa
    cnt = torch.where(blown, torch.zeros_like(h.cnt), h.cnt)
    best = torch.where(blown, torch.full_like(h.best, float("inf")), torch.minimum(h.best, fnorm))
    keep = revert[..., None, None]
    Fh = torch.where(keep, h.Fh, torch.cat([h.Fh[..., 1:, :], f[..., None, :]], dim=-2))
    Gh = torch.where(keep, h.Gh, torch.cat([h.Gh[..., 1:, :], g[..., None, :]], dim=-2))
    cnt = torch.clamp(cnt + (~revert).to(cnt.dtype), max=m + 1)
    dF = Fh[..., 1:, :] - Fh[..., :-1, :]
    dG = Gh[..., 1:, :] - Gh[..., :-1, :]
    valid = (torch.arange(m, device=f.device) >= (m - (cnt[..., None] - 1))).to(f.dtype)
    A = dF * valid[..., None]  # stale rows zeroed
    M = A @ A.transpose(-1, -2)
    lam = 1e-10 + 1e-8 * torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / m
    M = M + lam[..., None, None] * torch.eye(m, dtype=f.dtype, device=f.device)
    gamma = torch.linalg.solve_ex(M, (A @ f[..., None]))[0][..., 0]
    x_acc = g - (gamma[..., None, :] @ (dG * valid[..., None]))[..., 0, :]
    in_basin = torch.linalg.vector_norm(x[..., 3:], dim=-1) < (np.pi / 2)
    use_aa = ((cnt >= 2) & torch.all(torch.isfinite(x_acc), dim=-1) & in_basin
              & ~converged & ~revert)
    new_x = torch.where(revert[..., None], h.g_fb,
                        torch.where(use_aa[..., None], x_acc, g))
    out = se3.compose(se3.exp(new_x), init_pose)
    g_fb = torch.where(revert[..., None], h.g_fb, g)
    return out, converged & ~revert, _Anderson(Fh, Gh, cnt, best, g_fb, use_aa)


def _freeze_history(active, new: _Anderson, old: _Anderson) -> _Anderson:
    return _Anderson(*(torch.where(active.reshape(active.shape + (1,) * (a.dim() - active.dim())),
                                   a, b) for a, b in zip(new, old)))


def _lift(mm: MetricMap, batch: int) -> MetricMap:
    """Every layer with a leading lane axis: one-cloud layers become
    stride-0 expands shared by all lanes (a split layer slice by slice)."""
    def lift(name, pc):
        if pc.xyz.dim() == 3:
            if pc.xyz.shape[0] != batch:
                raise ValueError(f"layer {name!r} has {pc.xyz.shape[0]} lanes, the poses {batch}")
            return pc
        return PointCloud(pc.xyz.expand(batch, *pc.xyz.shape),
                          pc.mask.expand(batch, *pc.mask.shape),
                          {k: v.expand(batch, *v.shape) for k, v in pc.attrs.items()})

    out = {}
    for name, pc in mm.items():
        if isinstance(pc, ShardedCloud):
            parts = [lift(name, PointCloud(x, m, {k: v[i] for k, v in pc.attrs.items()}))
                     for i, (x, m) in enumerate(zip(pc.xyz, pc.mask))]
            out[name] = ShardedCloud(tuple(q.xyz for q in parts), tuple(q.mask for q in parts),
                                     {k: tuple(q.attrs[k] for q in parts) for k in pc.attrs})
        else:
            out[name] = lift(name, pc)
    return out


def align(src_map: MetricMap, tgt_map: MetricMap, init_pose: se3.Pose,
          params: ICPParams) -> ICPResult:
    """Register ``src_map`` onto ``tgt_map`` from ``init_pose``; the pose
    maps source-frame points into the target frame. With ``init_pose`` of
    shape ``[B]`` the result is per lane (see the module docstring)."""
    with profiler.span("icp.align") as sp:
        return _align(src_map, tgt_map, init_pose, params, sp)


def _align(src_map, tgt_map, init_pose, params: ICPParams, sp) -> ICPResult:
    check_params(params)
    dev = init_pose.t.device
    lanes = tuple(init_pose.t.shape[:-1])
    if lanes:
        src_map, tgt_map = _lift(src_map, lanes[0]), _lift(tgt_map, lanes[0])
    _check_sharding(params, tgt_map)
    # no candidate cache under tensor parallelism, as in the reference
    elig = () if params.shard_axis is not None else tuple(
        i for i, m in enumerate(params.matchers) if _cand_eligible(m))
    uses_cands = bool(elig)
    if params.anderson_m > 0 and uses_cands:
        raise ValueError(
            "anderson_m is incompatible with candidate-cached matchers (cand_k > 0): "
            "the cache's block loop already amortizes the per-iteration cost")
    block = max(1, params.cand_refresh) if uses_cands else _PLAIN_BLOCK
    prior_w = _prior_weights(params, dev)
    grids = _build_grids(tgt_map, params)

    def step(pose, plane, p2p_rows):
        new_pose = _solve(pose, plane, p2p_rows, params, init_pose, prior_w)
        # too few effective pairings: stall instead of trusting the solve
        new_pose = _freeze(torch.sum(plane.w, dim=-1) >= 6.0, new_pose, pose)
        delta = se3.log(se3.compose(new_pose, se3.inverse(pose)))
        converged = ((torch.linalg.vector_norm(delta[..., :3], dim=-1) < params.min_abs_step_trans)
                     & (torch.linalg.vector_norm(delta[..., 3:], dim=-1) < params.min_abs_step_rot))
        return new_pose, converged

    def refresh(at):
        full = [None] * len(params.matchers)
        for i in elig:
            m = params.matchers[i]
            full[i] = _refresh_cands(m, at, src_map[m.src_layer], tgt_map[m.tgt_layer])
        return tuple(full)

    # the motion-conditional refresh (the reference's ``body_cands_cond``):
    # a block head refreshes the lists only where the pose moved at least
    # cand_refresh_min_trans / _rot since the last refresh (``ref``)
    cond_refresh = uses_cands and (params.cand_refresh_min_trans > 0
                                   or params.cand_refresh_min_rot > 0)

    def moved_since(ref):
        delta = se3.log(se3.compose(pose, se3.inverse(ref)))
        terms = []
        if params.cand_refresh_min_trans > 0:
            terms.append(torch.linalg.vector_norm(delta[..., :3], dim=-1)
                         >= params.cand_refresh_min_trans)
        if params.cand_refresh_min_rot > 0:
            terms.append(torch.linalg.vector_norm(delta[..., 3:], dim=-1)
                         >= params.cand_refresh_min_rot)
        return functools.reduce(torch.logical_or, terms)

    pose = init_pose
    it = torch.zeros(lanes, dtype=torch.int32, device=dev)
    done = torch.zeros(lanes, dtype=torch.bool, device=dev)
    hist = _Anderson.empty(lanes, params.anderson_m, dev) if params.anderson_m > 0 else None
    finished = params.max_iterations <= 0
    cands = ref = moved = None
    blocks, lane_iterations = 0, 0
    while not finished:
        if uses_cands:
            with profiler.span("icp.refresh", leaf=True):
                if cands is None or not cond_refresh:
                    cands, ref = refresh(pose), pose  # the first refresh is at init_pose
                elif lanes:
                    # per lane, as under the reference's vmap: both branches run
                    # and the lanes that moved (and are not done) take the refresh
                    moved = moved & ~done & (it < params.max_iterations)
                    cands = tuple(c if c is None else torch.where(moved[..., None, None], f, c)
                                  for c, f in zip(cands, refresh(pose)))
                    ref = _freeze(moved, pose, ref)
                elif moved:
                    cands, ref = refresh(pose), pose
        for _ in range(block):
            with profiler.span("icp.match", leaf=True):
                plane, p2p_rows = _gather(pose, it, src_map, tgt_map, params, cands, grids)
            with profiler.span("icp.solve", leaf=True):
                active = ~done & (it < params.max_iterations)
                new_pose, converged = step(pose, plane, p2p_rows)
                if hist is not None:
                    new_pose, converged, new_hist = _anderson(hist, pose, new_pose, converged,
                                                              init_pose, params)
                    hist = _freeze_history(active, new_hist, hist)
                pose = _freeze(active, new_pose, pose)
                done = done | (active & converged)
                it = it + active.to(torch.int32)
        # the one host read per block, for every lane; unbatched, the moved
        # flag rides it and a block head without motion skips the refresh
        rows = [it.to(torch.float32), done.to(torch.float32)]
        if cond_refresh:
            moved = moved_since(ref)
            if not lanes:
                rows.append(moved.to(torch.float32))
        with profiler.span("icp.read", leaf=True):
            read = torch.stack(rows).reshape(len(rows), -1).tolist()
        if cond_refresh and not lanes:
            moved = read[2][0] > 0.5
        finished = all(d > 0.5 or n >= params.max_iterations for n, d in zip(read[0], read[1]))
        blocks += 1
        lane_iterations = int(sum(read[0]))
    sp.set(lanes=math.prod(lanes), block=block, blocks=blocks, iterations=blocks * block,
           lane_iterations=lane_iterations)

    with profiler.span("icp.final", leaf=True):
        # final system at the converged pose -> covariance
        plane, _ = _gather(pose, it, src_map, tgt_map, params, grids=grids)
        final = gauss_newton.point_to_plane_step(pose, plane.p, plane.q, plane.n, plane.w,
                                                 inner_iterations=0)
        cov = gauss_newton.covariance_from_normal_matrix(
            final.normal_matrix, final.sq_residual_sum, final.weight_sum)
        q = _quality(pose, src_map, tgt_map, params)
        term = torch.where(done, TERM_CONVERGED, TERM_MAX_ITERS).to(torch.int32)
    return ICPResult(pose, cov, q, it, term)


def align_pipeline(src_map: MetricMap, tgt_map: MetricMap, init_pose: se3.Pose,
                   stages: Tuple[ICPParams, ...]) -> ICPResult:
    """Coarse-to-fine: each stage starts from the previous stage's pose;
    returns the last stage's result."""
    if not stages:
        raise ValueError("align_pipeline needs at least one stage")
    result = None
    pose = init_pose
    for st in stages:
        result = align(src_map, tgt_map, pose, st)
        pose = result.pose
    return result


def align_with_normal_precompute(src_map: MetricMap, tgt_map: MetricMap, init_pose: se3.Pose,
                                 params: ICPParams, normals_k: int = 8) -> ICPResult:
    """``align`` after attaching kNN normals (``normals_k`` neighbours) to
    every ``point2plane_normals`` target layer that has none."""
    from ..filters.pipeline import _attach_normals_knn

    tgt_map = dict(tgt_map)
    for m in params.matchers:
        layer = tgt_map[m.tgt_layer]
        if m.kind == "point2plane_normals" and "normal" not in layer.attrs:
            tgt_map[m.tgt_layer] = _attach_normals_knn(layer.xyz, layer.mask, normals_k)
    return align(src_map, tgt_map, init_pose, params)
