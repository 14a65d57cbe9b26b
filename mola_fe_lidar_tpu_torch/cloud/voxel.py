"""Voxel sort and per-point voxel statistics on tensors (port of
``mola_fe_lidar_tpu/cloud/voxel.py``, the parts on the main path).

* :func:`lex_sort_by_voxel`: the reference's two-key ``lax.sort`` over
  (x*2^15 + y, z) cells becomes ONE stable sort on the int64 key
  ``(key1 << 15) | key2``; invalid rows carry the int32 maximum in both
  halves, so they still sort last.
* :func:`voxel_stats`: per-voxel count / mean / covariance tables by
  segment sums at a static table size (``index_add_``, which adds the rows
  of a voxel in order, as the reference's ``segment_sum`` does on the
  CPU), with the two-pass centered covariance.
* :func:`voxel_stats_scan`: the same statistics per point, by segmented
  prefix sums.
  :func:`prefix_sum` reproduces the association of the reference's f32
  ``cumsum`` (base-16 blocked scan), so the f32 round-off of the voxel
  statistics is the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_COORD_BITS = 15
_COORD_MAX = (1 << _COORD_BITS) - 1
_KEY_INVALID = 2**31 - 1
_SCAN_BASE = 16


def voxel_coords(xyz: torch.Tensor, res, origin: torch.Tensor) -> torch.Tensor:
    """Integer cell coordinates [...,N,3] (int32) of points on a grid of
    pitch ``res`` anchored at ``origin``."""
    return torch.floor((xyz - origin) / res).to(torch.int32)


class VoxelSort(NamedTuple):
    order: torch.Tensor       # i64[N] sorted position -> original index
    xyz: torch.Tensor         # f32[N,3] points in sorted order
    mask: torch.Tensor        # f32[N]
    first: torch.Tensor       # f32[N] 1.0 where a new voxel starts (valid only)
    seg_id: torch.Tensor      # i32[N] voxel index per sorted point (pad: N)
    num_voxels: torch.Tensor  # i32[]


def lex_sort_by_voxel(xyz: torch.Tensor, mask: torch.Tensor, res: float) -> VoxelSort:
    """Sort a padded cloud by voxel cell (lexicographic over x, y, z cells;
    equal cells keep input order). Grid origin = masked minimum corner."""
    n = xyz.shape[-2]
    big = torch.full((), 1e9, dtype=xyz.dtype, device=xyz.device)
    masked = torch.where(mask[:, None] > 0.5, xyz, big)
    origin = torch.amin(masked, dim=-2, keepdim=True) - 0.5 * res
    cells = torch.floor((xyz - origin) / res)
    cells = torch.clamp(cells, 0, _COORD_MAX).to(torch.int64)
    key1 = cells[:, 0] * (1 << _COORD_BITS) + cells[:, 1]
    key2 = cells[:, 2]
    invalid = mask < 0.5
    key1 = torch.where(invalid, torch.full_like(key1, _KEY_INVALID), key1)
    key2 = torch.where(invalid, torch.full_like(key2, _KEY_INVALID), key2)
    key = (key1 << _COORD_BITS) | key2
    key_s, order = torch.sort(key, stable=True)
    xyz_s = xyz[order]
    mask_s = mask[order]
    is_new = key_s != torch.roll(key_s, 1)
    is_new[0] = True
    first = torch.where(mask_s > 0.5, is_new.to(xyz.dtype), torch.zeros_like(mask_s))
    seg_id = torch.cumsum(first.to(torch.int64), 0).to(torch.int32) - 1
    seg_id = torch.where(mask_s > 0.5, seg_id, torch.full_like(seg_id, n))
    num_voxels = torch.sum(first).to(torch.int32)
    return VoxelSort(order, xyz_s, mask_s, first, seg_id, num_voxels)


def _sequential_prefix(x: torch.Tensor) -> torch.Tensor:
    acc = x[0]
    out = [acc]
    for j in range(1, x.shape[0]):
        acc = acc + x[j]
        out.append(acc)
    return torch.stack(out)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum along dim 0, associated like the
    reference's XLA ``cumsum``: sequential inside blocks of 16 rows, the
    block totals scanned recursively the same way, then added back.
    (``torch.cumsum`` accumulates in another order -- in f64 on the CPU --
    and the prefix values of a 131k-row scan reach ~1e6, where one f32 ulp
    is 0.06.)"""
    n = x.shape[0]
    if n <= _SCAN_BASE:
        return _sequential_prefix(x)
    pad = (-n) % _SCAN_BASE
    if pad:
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
    xb = x.reshape(-1, _SCAN_BASE, *x.shape[1:])
    acc = xb[:, 0]
    cols = [acc]
    for j in range(1, _SCAN_BASE):
        acc = acc + xb[:, j]
        cols.append(acc)
    within = torch.stack(cols, dim=1)
    totals = prefix_sum(within[:, -1])
    excl = torch.cat([totals.new_zeros((1, *totals.shape[1:])), totals[:-1]])
    out = within + excl[:, None]
    return out.reshape(-1, *x.shape[1:])[:n]


class VoxelStats(NamedTuple):
    """Per-voxel statistics at static capacity S (= num_segments)."""
    count: torch.Tensor  # f32[S]
    mean: torch.Tensor   # f32[S,3]
    cov: torch.Tensor    # f32[S,3,3]
    valid: torch.Tensor  # f32[S] 1.0 for occupied voxels


def voxel_segments(vs: VoxelSort, num_segments: int) -> torch.Tensor:
    """Segment ids with one trash slot at ``num_segments`` for padding and
    for voxels past the capacity (i64)."""
    return torch.clamp(vs.seg_id.to(torch.int64), max=num_segments)


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, total: int) -> torch.Tensor:
    out = torch.zeros((total, *vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg, vals)


def voxel_stats(vs: VoxelSort, num_segments: int) -> VoxelStats:
    """Count / mean / two-pass centered covariance per voxel, at a static
    table of ``num_segments`` voxels (one more slot absorbs padding and
    overflow, and is dropped). The one-pass E[xxᵀ] - μμᵀ would cancel in
    f32 on absolute LiDAR coordinates."""
    seg = voxel_segments(vs, num_segments)
    total = num_segments + 1
    w = vs.mask
    count = _segment_sum(w, seg, total)
    sum_x = _segment_sum(vs.xyz * w[:, None], seg, total)
    mean_all = sum_x / torch.clamp(count, min=1.0)[:, None]
    # each residual outer product weighted by w once (w r rᵀ)
    r = vs.xyz - mean_all[seg]
    outer = (r * w[:, None])[:, :, None] * r[:, None, :]
    sum_cc = _segment_sum(outer, seg, total)
    count, mean = count[:-1], mean_all[:-1]
    cov = sum_cc[:-1] / torch.clamp(count, min=1.0)[:, None, None]
    return VoxelStats(count, mean, cov, (count > 0.5).to(vs.xyz.dtype))


class PointVoxelStats(NamedTuple):
    count: torch.Tensor  # f32[N]
    mean: torch.Tensor   # f32[N,3]
    cov: torch.Tensor    # f32[N,3,3]


def voxel_stats_scan(vs: VoxelSort) -> PointVoxelStats:
    """Count/mean/covariance of each sorted point's voxel, from prefix sums
    read at the voxel's [start - 1, end] rows (voxels are contiguous after
    the sort). Masked tail rows carry garbage stats; callers gate on the
    mask."""
    n = vs.xyz.shape[-2]
    dev = vs.xyz.device
    idx = torch.arange(n, device=dev)
    start = torch.cummax(torch.where(vs.first > 0.5, idx, torch.full_like(idx, -1)), 0).values
    start = torch.clamp(start, min=0)
    nxt_first = torch.cat([vs.first[1:] > 0.5, torch.ones((1,), dtype=torch.bool, device=dev)])
    end_here = torch.where(nxt_first, idx, torch.full_like(idx, n))
    end = torch.flip(torch.cummin(torch.flip(end_here, [0]), 0).values, [0])

    def seg_sum(vals):
        P = prefix_sum(vals)
        lo = torch.where(start[:, None] > 0, P[torch.clamp(start - 1, min=0)],
                         torch.zeros((), dtype=P.dtype, device=dev))
        return P[end] - lo

    w = vs.mask
    s1 = seg_sum(torch.cat([w[:, None], vs.xyz * w[:, None]], dim=1))
    count = s1[:, 0]
    mean = s1[:, 1:4] / torch.clamp(count, min=1.0)[:, None]
    r = vs.xyz - mean
    outer = ((r * w[:, None])[:, :, None] * r[:, None, :]).reshape(n, 9)
    cov = seg_sum(outer).reshape(n, 3, 3) / torch.clamp(count, min=1.0)[:, None, None]
    return PointVoxelStats(count, mean, cov)


def voxel_first_indices_np(xyz, res: float):
    """Host-side exact "first point per voxel" dedup -> sorted indices (a
    copy of the reference's numpy helper; the host ``LocalMap`` uses it)."""
    cells = np.floor(np.asarray(xyz) / res).astype(np.int64)
    _, idx = np.unique(cells, axis=0, return_index=True)
    return np.sort(idx)


def hash_subsample_np(idx, cap: int):
    """Deterministic hash-uniform subsample of an index array to ``cap``
    (Knuth multiplicative hash; never an input-order slab)."""
    idx = np.asarray(idx)
    if len(idx) <= cap:
        return idx
    h = (idx.astype(np.uint64) * np.uint64(2654435761)) % np.uint64(1 << 32)
    return idx[np.argsort(h)][:cap]
