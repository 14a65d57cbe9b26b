"""Point-cloud filters on the main path (port of
``mola_fe_lidar_tpu/filters/pipeline.py``): motion compensation
(:class:`FilterDeskew`) and voxel eigen-ratio edge/plane segmentation
(:class:`FilterEdgesPlanes`, ``stats_mode="scan"``).

Everything keeps static shapes: "discarding" points compacts flagged rows
to the front of a fixed-capacity buffer (:func:`_compact`), and over-
capacity selections are first decorrelated from input order by a fixed
hash permutation (:func:`_compact_uniform`) so no spatial slab is kept.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..cloud import voxel
from ..cloud.metric_map import MetricMap, PointCloud
from ..geometry import se3
from ..ops import eigen3
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


@FILTER_REGISTRY.register("FilterEdgesPlanes")
@FILTER_REGISTRY.register("mola::lidar_segmentation::FilterEdgesPlanes")
class FilterEdgesPlanes:
    """Voxel eigen-ratio edge/plane segmentation (the KITTI preset filter):
    layers ``edges``, ``planes`` (with ``normal``/``planarity``) and
    ``decimated``. See the reference class for the rules; only
    ``stats_mode="scan"`` (per-point prefix-sum statistics) is ported."""

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
        if stats_mode != "scan":
            raise NotImplementedError(
                f"FilterEdgesPlanes stats_mode={stats_mode!r}: only 'scan' is "
                "ported (ROADMAP Queue 1 item 5: segment stats)")
        # max_voxels sizes the segment-mode voxel table; scan mode has none
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
        self.edge_min_verticality = float(edge_min_verticality)
        self.stats_mode = stats_mode

    def __call__(self, mm: MetricMap) -> MetricMap:
        pc = mm[self.input_layer]
        dec_cap = self.decimated_capacity or -(-pc.capacity // self.full_decim)
        edges, planes, decimated = _edges_planes(
            pc.xyz, pc.mask, self.res, self.voxel_decim, self.full_decim,
            self.min_e2_e0, self.max_e1_e0, self.min_e1_e0,
            self.eigen_noise_floor, self.edges_capacity, self.planes_capacity,
            int(dec_cap), self.edge_min_verticality, pc.attrs.get("time"))
        mm = dict(mm)
        mm["edges"] = edges
        mm["planes"] = planes
        mm["decimated"] = decimated
        return mm


def _edges_planes(xyz, mask, res, voxel_decim, full_decim,
                  min_e2_e0, max_e1_e0, min_e1_e0, noise_floor,
                  edges_cap, planes_cap, dec_cap, edge_min_verticality,
                  tim=None):
    vs = voxel.lex_sort_by_voxel(xyz, mask, res)
    # per-point sweep-time fractions ride along in the same order
    tim_s = None if tim is None else tim[vs.order]
    stp = voxel.voxel_stats_scan(vs)
    st_count, st_cov = stp.count, stp.cov
    st_valid = (st_count > 0.5).to(xyz.dtype)
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
    pt_plane = is_plane * vs.mask
    pt_edge = is_edge * vs.mask

    # intra-voxel stride: keep every voxel_decim-th point of each voxel
    n = vs.xyz.shape[0]
    idx = torch.arange(n, device=xyz.device)
    pos_in_voxel = idx - torch.clamp(_segment_start_positions(vs.first), min=0)
    stride_keep = ((pos_in_voxel % voxel_decim) == 0).to(xyz.dtype)

    extra = () if tim_s is None else (tim_s,)
    em, e_pts, *e_attrs = _compact_uniform(pt_edge * stride_keep, edges_cap, vs.xyz, *extra)
    pm, p_pts, p_n, p_pl, *p_attrs = _compact_uniform(
        pt_plane * stride_keep, planes_cap, vs.xyz, normals, planarity, *extra)
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
