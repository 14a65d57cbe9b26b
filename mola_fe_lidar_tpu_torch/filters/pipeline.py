"""Point-cloud filters (port of ``mola_fe_lidar_tpu/filters/pipeline.py``):
voxel downsampling, decimation, bounding-box crop, voxel eigen-ratio
edge/plane segmentation (both ``stats_mode``s), per-point normals by kNN or
by voxel, GICP surface covariances, a fixed point-count cap and motion
compensation (``FilterDeskew``, and ``delta_redeskew``, which re-warps
deskewed layers to another twist for in-loop deskew). The self-kNN of the
normal and covariance filters is K1 (``ops/knn_kernel.py``) on CUDA tensors
and its plain twin on CPU tensors.

Everything keeps static shapes: "discarding" points compacts flagged rows
to the front of a fixed-capacity buffer (:func:`_compact`), and over-
capacity selections are first decorrelated from input order by a fixed
hash permutation (:func:`_compact_uniform`) so no spatial slab is kept.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..cloud import voxel
from ..cloud.metric_map import MetricMap, PointCloud
from ..geometry import se3
from ..ops import eigen3, knn_kernel
from .base import FILTER_REGISTRY


def _compact(flags: torch.Tensor, capacity: int, *arrays):
    """Gather rows where ``flags > 0.5`` to the front of ``capacity``-row
    buffers, in order. Returns (mask, gathered arrays...). The j-th slot is
    the first row whose running keep-count reaches j + 1."""
    keep = flags > 0.5
    c = torch.cumsum(keep.to(torch.int64), 0)
    want = torch.arange(1, capacity + 1, device=flags.device)
    order = torch.searchsorted(c, want)
    mask = (want <= c[-1]).to(flags.dtype)
    order = torch.clamp(order, max=flags.shape[0] - 1)  # junk rows, masked out
    return (mask, *[a[order] for a in arrays])


@functools.lru_cache(maxsize=None)
def _hash_perm_host(n: int) -> np.ndarray:
    """Fixed pseudo-random permutation of [0, n) (Knuth multiplicative
    hash) -- the reference's numpy permutation, verbatim."""
    h = (np.arange(n, dtype=np.uint64) * 2654435761) & 0xFFFFFFFF
    return np.argsort(h).astype(np.int32)  # bijective hash: no ties


@functools.lru_cache(maxsize=None)
def _hash_perm(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_hash_perm_host(n).astype(np.int64)).to(device)


def _compact_uniform(flags: torch.Tensor, capacity: int, *arrays):
    """:func:`_compact` after the fixed hash permutation of the rows."""
    perm = _hash_perm(flags.shape[0], flags.device)
    return _compact(flags[perm], capacity, *[a[perm] for a in arrays])


def _segment_start_positions(first: torch.Tensor) -> torch.Tensor:
    """For sorted runs marked by ``first``, the index where each row's run
    starts (-1 before the first run)."""
    idx = torch.arange(first.shape[0], device=first.device)
    return torch.cummax(torch.where(first > 0.5, idx, torch.full_like(idx, -1)), 0).values


def _far(x: torch.Tensor) -> torch.Tensor:
    return torch.full((), 1e6, dtype=x.dtype, device=x.device)


@FILTER_REGISTRY.register("FilterVoxelDownsample")
@FILTER_REGISTRY.register("mp2p_icp_filters::FilterDecimateVoxels")
class FilterVoxelDownsample:
    """One representative point per voxel: the first point of each voxel
    (``method="first"``) or the voxel centroid (``"mean"``), compacted
    uniformly into ``output_capacity`` rows."""

    def __init__(self, input_layer="raw", output_layer="decimated",
                 voxel_size=1.0, method="first", output_capacity=4096):
        if method not in ("first", "mean"):
            raise ValueError(f"unknown voxel downsample method {method!r}")
        self.input_layer = input_layer
        self.output_layer = output_layer
        self.voxel_size = float(voxel_size)
        self.method = method
        self.output_capacity = int(output_capacity)

    def __call__(self, mm: MetricMap) -> MetricMap:
        pc = mm[self.input_layer]
        mm = dict(mm)
        mm[self.output_layer] = _voxel_downsample(pc.xyz, pc.mask, self.voxel_size,
                                                  self.method, self.output_capacity)
        return mm


def _voxel_downsample(xyz, mask, res, method, capacity) -> PointCloud:
    vs = voxel.lex_sort_by_voxel(xyz, mask, res)
    if method == "first":
        m, pts = _compact_uniform(vs.first, capacity, vs.xyz)
    else:
        # a table of N voxels never overflows; voxels are then compacted
        # uniformly to the output capacity
        st = voxel.voxel_stats(vs, num_segments=xyz.shape[0])
        m, pts = _compact_uniform(st.valid, capacity, st.mean)
    return PointCloud(torch.where(m[:, None] > 0.5, pts, _far(pts)), m, {})


@FILTER_REGISTRY.register("FilterDecimate")
class FilterDecimate:
    """Every ``decimation``-th valid point (``full_pointcloud_decimation``)."""

    def __init__(self, input_layer="raw", output_layer="decimated",
                 decimation=10, output_capacity: Optional[int] = None):
        self.input_layer = input_layer
        self.output_layer = output_layer
        self.decimation = int(decimation)
        self.output_capacity = output_capacity

    def __call__(self, mm: MetricMap) -> MetricMap:
        pc = mm[self.input_layer]
        cap = self.output_capacity or -(-pc.capacity // self.decimation)
        mm = dict(mm)
        mm[self.output_layer] = _decimate(pc.xyz, pc.mask, self.decimation, int(cap))
        return mm


def _decimate(xyz, mask, k, capacity) -> PointCloud:
    # valid points to the front, a static stride, then a uniform compaction
    # (a plain [:capacity] of an overflow would keep an azimuth slab)
    m, pts = _compact(mask, xyz.shape[0], xyz)
    m, pts = _compact_uniform(m[::k], capacity, pts[::k])
    return PointCloud(torch.where(m[:, None] > 0.5, pts, _far(pts)), m, {})


@FILTER_REGISTRY.register("FilterBoundingBox")
@FILTER_REGISTRY.register("mp2p_icp_filters::FilterBoundingBox")
class FilterBoundingBox:
    """Keep (or, with ``keep_inside=False``, drop) the points inside an
    axis-aligned box."""

    def __init__(self, input_layer="raw", output_layer="raw",
                 min_corner=(-100.0, -100.0, -100.0),
                 max_corner=(100.0, 100.0, 100.0), keep_inside=True):
        self.input_layer = input_layer
        self.output_layer = output_layer
        self.min_corner = tuple(float(v) for v in min_corner)
        self.max_corner = tuple(float(v) for v in max_corner)
        self.keep_inside = bool(keep_inside)

    def __call__(self, mm: MetricMap) -> MetricMap:
        pc = mm[self.input_layer]
        inside = torch.ones_like(pc.mask, dtype=torch.bool)
        for axis, (lo, hi) in enumerate(zip(self.min_corner, self.max_corner)):
            inside &= (pc.xyz[:, axis] >= lo) & (pc.xyz[:, axis] <= hi)
        keep = inside if self.keep_inside else ~inside
        new_mask = pc.mask * keep.to(pc.mask.dtype)
        mm = dict(mm)
        mm[self.output_layer] = PointCloud(
            torch.where(new_mask[:, None] > 0.5, pc.xyz, _far(pc.xyz)), new_mask, pc.attrs)
        return mm


@FILTER_REGISTRY.register("FilterEdgesPlanes")
@FILTER_REGISTRY.register("mola::lidar_segmentation::FilterEdgesPlanes")
class FilterEdgesPlanes:
    """Voxel eigen-ratio edge/plane segmentation (the KITTI preset filter):
    layers ``edges``, ``planes`` (with ``normal``/``planarity``) and
    ``decimated``. See the reference class for the rules. ``stats_mode``
    ``"segment"`` builds per-voxel tables of ``max_voxels`` voxels (default:
    the input's point count, which never overflows; points of overflowed
    voxels are dropped from edges and planes) and gathers them per point;
    ``"scan"`` computes the same statistics per point by prefix sums."""

    def __init__(self, input_layer="raw",
                 voxel_filter_resolution=1.0,
                 full_pointcloud_decimation=10,
                 voxel_filter_decimation=10,
                 voxel_filter_max_e2_e0=30.0, voxel_filter_max_e1_e0=30.0,
                 voxel_filter_min_e2_e0=80.0, voxel_filter_min_e1_e0=80.0,
                 eigen_noise_floor=None,
                 edges_capacity=2048, planes_capacity=4096,
                 decimated_capacity=None,
                 max_voxels=None, edge_min_verticality=0.6,
                 stats_mode="segment"):
        if stats_mode not in ("segment", "scan"):
            raise ValueError(f"unknown stats_mode {stats_mode!r}")
        self.input_layer = input_layer
        self.res = float(voxel_filter_resolution)
        self.full_decim = int(full_pointcloud_decimation)
        self.voxel_decim = int(voxel_filter_decimation)
        self.max_e2_e0 = float(voxel_filter_max_e2_e0)
        self.max_e1_e0 = float(voxel_filter_max_e1_e0)
        self.min_e2_e0 = float(voxel_filter_min_e2_e0)
        self.min_e1_e0 = float(voxel_filter_min_e1_e0)
        self.eigen_noise_floor = (float(eigen_noise_floor) if eigen_noise_floor is not None
                                  else (0.01 * self.res) ** 2)
        self.edges_capacity = int(edges_capacity)
        self.planes_capacity = int(planes_capacity)
        self.decimated_capacity = decimated_capacity
        self.max_voxels = None if max_voxels is None else int(max_voxels)
        self.edge_min_verticality = float(edge_min_verticality)
        self.stats_mode = stats_mode

    def __call__(self, mm: MetricMap) -> MetricMap:
        pc = mm[self.input_layer]
        dec_cap = self.decimated_capacity or -(-pc.capacity // self.full_decim)
        edges, planes, decimated = _edges_planes(
            pc.xyz, pc.mask, self.res, self.voxel_decim, self.full_decim,
            self.min_e2_e0, self.max_e1_e0, self.min_e1_e0,
            self.eigen_noise_floor, self.edges_capacity, self.planes_capacity,
            int(dec_cap), self.max_voxels or pc.xyz.shape[-2], self.edge_min_verticality,
            pc.attrs.get("time"), self.stats_mode)
        mm = dict(mm)
        mm["edges"] = edges
        mm["planes"] = planes
        mm["decimated"] = decimated
        return mm


def _edges_planes(xyz, mask, res, voxel_decim, full_decim,
                  min_e2_e0, max_e1_e0, min_e1_e0, noise_floor,
                  edges_cap, planes_cap, dec_cap, max_voxels, edge_min_verticality,
                  tim=None, stats_mode="segment"):
    vs = voxel.lex_sort_by_voxel(xyz, mask, res)
    # per-point sweep-time fractions ride along in the same order
    tim_s = None if tim is None else tim[vs.order]
    if stats_mode == "scan":
        stp = voxel.voxel_stats_scan(vs)
        st_count, st_cov = stp.count, stp.cov
        st_valid = (st_count > 0.5).to(xyz.dtype)
    else:
        st = voxel.voxel_stats(vs, num_segments=max_voxels)
        st_count, st_cov, st_valid = st.count, st.cov, st.valid
    evs = eigen3.sym_eigenvalues_3x3(st_cov)
    e0 = torch.clamp(evs[..., 0], min=noise_floor)
    e1 = torch.clamp(evs[..., 1], min=noise_floor)
    e2 = torch.clamp(evs[..., 2], min=noise_floor)
    enough = (st_count >= 5.0).to(xyz.dtype)
    is_plane = st_valid * enough * (e1 >= min_e1_e0 * e0).to(xyz.dtype)
    is_edge = (st_valid * enough * (e2 >= min_e2_e0 * e0).to(xyz.dtype)
               * (e1 <= max_e1_e0 * e0).to(xyz.dtype) * (1.0 - is_plane))
    # verticality gate: ground scan rings classify as lines but move with
    # the sensor; real edge features (poles, corners) are near-vertical
    line_dir = eigen3.largest_eigenvector_3x3(st_cov, evs)
    is_edge = is_edge * (torch.abs(line_dir[..., 2]) >= edge_min_verticality).to(xyz.dtype)
    normals = eigen3.smallest_eigenvector_3x3(st_cov, evs)
    planarity = torch.clamp(1.0 - e0 / torch.clamp(e1, min=1e-9), 0.0, 1.0)
    if stats_mode == "scan":
        pt_plane, pt_edge = is_plane * vs.mask, is_edge * vs.mask
        pt_normal, pt_planarity = normals, planarity
    else:
        seg = voxel.voxel_segments(vs, max_voxels)
        seg_c = torch.clamp(seg, max=max_voxels - 1)
        # points of overflowed voxels carry no statistics: dropped
        in_stats = (seg < max_voxels).to(xyz.dtype)
        pt_plane = is_plane[seg_c] * vs.mask * in_stats
        pt_edge = is_edge[seg_c] * vs.mask * in_stats
        pt_normal, pt_planarity = normals[seg_c], planarity[seg_c]

    # intra-voxel stride: keep every voxel_decim-th point of each voxel
    n = vs.xyz.shape[0]
    idx = torch.arange(n, device=xyz.device)
    pos_in_voxel = idx - torch.clamp(_segment_start_positions(vs.first), min=0)
    stride_keep = ((pos_in_voxel % voxel_decim) == 0).to(xyz.dtype)

    extra = () if tim_s is None else (tim_s,)
    em, e_pts, *e_attrs = _compact_uniform(pt_edge * stride_keep, edges_cap, vs.xyz, *extra)
    pm, p_pts, p_n, p_pl, *p_attrs = _compact_uniform(
        pt_plane * stride_keep, planes_cap, vs.xyz, pt_normal, pt_planarity, *extra)
    far = torch.full((), 1e6, dtype=xyz.dtype, device=xyz.device)
    e_pts = torch.where(em[:, None] > 0.5, e_pts, far)
    p_pts = torch.where(pm[:, None] > 0.5, p_pts, far)
    edges = PointCloud(e_pts, em, {} if tim_s is None else {"time": e_attrs[0]})
    planes_attrs = {"normal": p_n, "planarity": p_pl[:, None]}
    if tim_s is not None:
        planes_attrs["time"] = p_attrs[0]
    planes = PointCloud(p_pts, pm, planes_attrs)

    # full-cloud decimation: stride in sorted order (spatially stratified)
    stride_flag = ((idx % full_decim) == 0).to(xyz.dtype)
    dm, d_pts, *d_attrs = _compact_uniform(vs.mask * stride_flag, dec_cap, vs.xyz, *extra)
    d_pts = torch.where(dm[:, None] > 0.5, d_pts, far)
    decimated = PointCloud(d_pts, dm, {} if tim_s is None else {"time": d_attrs[0]})
    return edges, planes, decimated


@FILTER_REGISTRY.register("FilterNormals")
class FilterNormals:
    """Attach per-point ``normal`` / ``planarity`` attrs, the precompute of
    the ``point2plane_normals`` matcher: by an eigen-fit to each point's
    ``knn`` nearest neighbours within the cloud (``method="knn"``), or by
    voxel (``"voxel"``: points inherit their voxel's normal)."""

    def __init__(self, input_layer="raw", output_layer=None, method="knn",
                 knn=8, voxel_size=1.5, max_voxels=8192):
        if method not in ("knn", "voxel"):
            raise ValueError(f"unknown normals method {method!r}")
        self.input_layer = input_layer
        self.output_layer = output_layer or input_layer
        self.method = method
        self.knn = int(knn)
        self.voxel_size = float(voxel_size)
        self.max_voxels = int(max_voxels)

    def __call__(self, mm: MetricMap) -> MetricMap:
        pc = mm[self.input_layer]
        mm = dict(mm)
        mm[self.output_layer] = (
            _attach_normals(pc.xyz, pc.mask, self.voxel_size, self.max_voxels)
            if self.method == "voxel" else _attach_normals_knn(pc.xyz, pc.mask, self.knn))
        return mm


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the point axis, per lane for ``x [B, N, ...]``."""
    if idx.dim() == 2:
        return x[idx]
    lane = torch.arange(idx.shape[0], device=idx.device).view(-1, 1, 1)
    return x[lane, idx]


def _self_knn_fit(xyz, mask, k):
    """Eigen-fit of each point's k-neighbourhood in its own cloud (``xyz
    [..., N, 3]``): (count of valid neighbours, ascending eigenvalues,
    smallest eigenvector)."""
    x, m = xyz.contiguous(), mask.contiguous()
    nn = knn_kernel.knn(x, m, x, m, k)
    cnt, _, cov = eigen3.neighbourhood_covariance(_take_rows(xyz, nn.idx.long()),
                                                  (nn.dist < 1e9).to(xyz.dtype))
    evs = eigen3.sym_eigenvalues_3x3(cov)
    return cnt, evs, eigen3.smallest_eigenvector_3x3(cov, evs)


def _attach_normals_knn(xyz, mask, k) -> PointCloud:
    cnt, evs, normals = _self_knn_fit(xyz, mask, k)
    # collinear neighbourhoods have no normal: planarity 0
    planarity = eigen3.planarity_score_3x3(evs) * (cnt >= 4.0).to(xyz.dtype) * mask
    return PointCloud(xyz, mask, {"normal": normals, "planarity": planarity[..., None]})


def _attach_normals(xyz, mask, res, max_voxels) -> PointCloud:
    vs = voxel.lex_sort_by_voxel(xyz, mask, res)
    st = voxel.voxel_stats(vs, num_segments=max_voxels)
    evs = eigen3.sym_eigenvalues_3x3(st.cov)
    normals = eigen3.smallest_eigenvector_3x3(st.cov, evs)
    planarity = eigen3.planarity_score_3x3(evs) * (st.count >= 4.0).to(xyz.dtype)
    seg_c = torch.clamp(voxel.voxel_segments(vs, max_voxels), max=max_voxels - 1)
    # back to the input's point order, so the layer lines up with siblings
    inv = torch.argsort(vs.order)
    return PointCloud(xyz, mask, {"normal": normals[seg_c][inv],
                                  "planarity": planarity[seg_c][inv][:, None]})


@FILTER_REGISTRY.register("FilterGICPCovariances")
class FilterGICPCovariances:
    """Attach the GICP surface covariance of each point, ``C = I - (1 - ε)
    n nᵀ`` for the normal n of its ``knn``-neighbourhood (attr ``cov``
    ``[N, 9]``), with its ``normal`` and ``planarity``. Both clouds of a
    ``gicp`` align need it."""

    def __init__(self, input_layer="raw", output_layer=None, knn=10, epsilon=1e-3):
        self.input_layer = input_layer
        self.output_layer = output_layer or input_layer
        self.knn = int(knn)
        self.epsilon = float(epsilon)

    def __call__(self, mm: MetricMap) -> MetricMap:
        pc = mm[self.input_layer]
        mm = dict(mm)
        mm[self.output_layer] = _attach_gicp_covs(pc.xyz, pc.mask, self.knn, self.epsilon)
        return mm


def _attach_gicp_covs(xyz, mask, k, epsilon) -> PointCloud:
    cnt, evs, n = _self_knn_fit(xyz, mask, k)
    eye = torch.eye(3, dtype=xyz.dtype, device=xyz.device)
    C = eye - (1.0 - epsilon) * n[..., :, None] * n[..., None, :]
    return PointCloud(xyz, mask, {
        "cov": C.reshape(*C.shape[:-2], 9), "normal": n,
        "planarity": (eigen3.planarity_score_3x3(evs) * (cnt >= 4.0).to(xyz.dtype))[..., None]})


@FILTER_REGISTRY.register("FilterDecimateToCount")
class FilterDecimateToCount:
    """Cap a layer at ``count`` points: a hash-uniform subset of the valid
    points, attributes kept (the preset's ``decimate_to_point_count``; the
    front-end puts it first in the pipeline)."""

    def __init__(self, input_layer="raw", output_layer=None, count=4096):
        self.input_layer = input_layer
        self.output_layer = output_layer or input_layer
        self.count = int(count)

    def __call__(self, mm: MetricMap) -> MetricMap:
        pc = mm[self.input_layer]
        names = sorted(pc.attrs)
        m, pts, *vals = _compact_uniform(pc.mask, self.count, pc.xyz,
                                         *(pc.attrs[k] for k in names))
        mm = dict(mm)
        mm[self.output_layer] = PointCloud(torch.where(m[:, None] > 0.5, pts, _far(pts)), m,
                                           dict(zip(names, vals)))
        return mm


@FILTER_REGISTRY.register("FilterDeskew")
class FilterDeskew:
    """Motion compensation with a constant twist over the sweep: each point
    (sensor frame at its own fire time, ``time`` attr in [0, 1]) is mapped
    to the scan-start (``anchor="start"``) or scan-end frame. The front-end
    passes the twist per scan."""

    def __init__(self, input_layer="raw", output_layer=None, scan_period=0.1,
                 anchor="end"):
        if anchor not in ("end", "start"):
            raise ValueError(f"FilterDeskew anchor must be end|start, got {anchor!r}")
        self.input_layer = input_layer
        self.output_layer = output_layer or input_layer
        self.scan_period = float(scan_period)
        self.anchor = anchor

    def __call__(self, mm: MetricMap, twist=None) -> MetricMap:
        pc = mm[self.input_layer]
        if "time" not in pc.attrs:
            return mm  # nothing to deskew
        if twist is None:
            twist = torch.zeros(6, dtype=pc.xyz.dtype, device=pc.xyz.device)
        mm = dict(mm)
        mm[self.output_layer] = _deskew(pc, twist, self.scan_period, self.anchor == "end")
        return mm


def _deskew(pc: PointCloud, twist: torch.Tensor, period: float, to_end: bool) -> PointCloud:
    t_frac = pc.attrs["time"][..., 0]
    off = t_frac - 1.0 if to_end else t_frac
    poses = se3.exp(off[:, None] * (twist * period))
    xyz = (poses.R @ pc.xyz[..., None])[..., 0] + poses.t
    xyz = torch.where(pc.mask[:, None] > 0.5, xyz, torch.full_like(xyz, 1e6))
    return PointCloud(xyz, pc.mask, dict(pc.attrs))


def delta_redeskew(pc: PointCloud, xi0: torch.Tensor, xi1: torch.Tensor, period: float,
                   to_end: bool = True) -> PointCloud:
    """Re-express a cloud deskewed with twist ``xi0`` as if it had been
    deskewed with ``xi1``, without the raw points: each point gets
    ``exp(off·T·ξ1) ∘ exp(off·T·ξ0)⁻¹``, ``normal`` rotates by the delta
    rotation and ``cov`` (row-major ``[..., 9]``) transforms by congruence.
    The in-loop (two-pass) deskew of the front-end re-warps its filtered
    layers with it."""
    t_frac = pc.attrs["time"][..., 0]
    off = t_frac - 1.0 if to_end else t_frac
    p1 = se3.exp(off[:, None] * (xi1.to(torch.float32) * period))
    p0 = se3.exp(off[:, None] * (xi0.to(torch.float32) * period))
    Rd = p1.R @ p0.R.transpose(-1, -2)
    td = p1.t - (Rd @ p0.t[..., None])[..., 0]
    xyz = (Rd @ pc.xyz[..., None])[..., 0] + td
    xyz = torch.where(pc.mask[:, None] > 0.5, xyz, torch.full_like(xyz, 1e6))
    attrs = dict(pc.attrs)
    if "normal" in attrs:
        attrs["normal"] = (Rd @ attrs["normal"][..., None])[..., 0]
    if "cov" in attrs:
        C = attrs["cov"].reshape(-1, 3, 3)
        attrs["cov"] = (Rd @ C @ Rd.transpose(-1, -2)).reshape(-1, 9)
    return PointCloud(xyz, pc.mask, attrs)
