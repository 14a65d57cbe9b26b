"""Voxel-hash (grid) nearest-neighbour search on tensors (port of
``mola_fe_lidar_tpu/ops/grid_nn.py``).

* **build**: quantise the target points to cells of pitch ``cell`` (at
  least the matcher's distance threshold), hash each cell into a table of
  ``table_size`` slots x ``bucket`` entries, and scatter the point indices
  by (slot, rank within the slot). The rank comes from a stable sort of the
  slots, so an overfull slot keeps its ``bucket`` lowest point indices.
* **query**: each source point gathers the buckets of the 27 cells around
  it (at most 27 x ``bucket`` candidates) and keeps the nearest candidate.

Radius-limited semantics, as in the reference: a source whose nearest
target lies farther than ``cell`` reports the sentinel distance 1e15 (the
square root of ``_BIG``); a neighbour dropped from an overfull bucket is
not found. Consumers threshold matches at ``distance_threshold <= cell``,
so a dropped candidate degrades a pairing and never corrupts one.

The results are the JAX function's, bit for bit: the hash wraps in int32
as XLA's does (computed in int64, the low 32 bits kept as a signed value,
then ``abs`` with ``abs(INT_MIN) == INT_MIN`` and a floor modulo); the
float-to-int32 cast of a cell saturates as XLA's does (an all-masked
target puts the origin near 1e9); the 27 offsets are in ``meshgrid(...,
indexing="ij")`` order and ``argmin`` keeps the first minimum, which fixes
the winner of a tie. Squared distances are ``(dx*dx + dy*dy) + dz*dz`` in
f32, each operation rounded, and the distance is their correctly rounded
square root.

This is plain PyTorch on whatever device the inputs are on; it is XLA in
the JAX package, not a Pallas kernel. A lane axis is supported: targets
``[B, M, 3]`` get per-lane tables ``[B, H, K]``; a target shared by every
lane (a stride-0 ``expand``) is built once and its table expanded.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .matching import NNResult

_BIG = 1e30
_P1, _P2, _P3 = 73856093, 19349663, 83492791  # classic spatial-hash primes
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1

_OFFSETS = np.stack(np.meshgrid(
    np.arange(-1, 2), np.arange(-1, 2), np.arange(-1, 2),
    indexing="ij"), axis=-1).reshape(27, 3).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _offsets(dev: torch.device) -> torch.Tensor:
    """The 27 cell offsets on ``dev``, copied there once (a copy per query
    would make the host wait for the device)."""
    return torch.from_numpy(_OFFSETS).to(dev)


class GridIndex(NamedTuple):
    table: torch.Tensor   # i32[..., H, K] point indices, -1 = empty
    origin: torch.Tensor  # f32[..., 3]
    cell: torch.Tensor    # f32[] on the table's device


def _shared(x: torch.Tensor) -> bool:
    return x.dim() > 1 and x.stride(0) == 0


def _to_cells(x: torch.Tensor, origin: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """``floor((x - origin) / cell)`` cast to int32 with XLA's saturation
    (held in int64)."""
    f = torch.floor((x - origin) / cell)
    f = torch.clamp(f, float(_I32_MIN), float(1 << 31))  # both exact in f32
    return torch.clamp(f.to(torch.int64), _I32_MIN, _I32_MAX)


def _cell_hash(cells: torch.Tensor, table_size: int) -> torch.Tensor:
    """int32 ``abs(c0*P1 ^ c1*P2 ^ c2*P3) % table_size`` with wrap-around,
    computed in int64 (``cells`` int64, any int32-wrapped value)."""
    h = (cells[..., 0] * _P1) ^ (cells[..., 1] * _P2) ^ (cells[..., 2] * _P3)
    h = h & 0xFFFFFFFF
    h = torch.where(h > _I32_MAX, h - (1 << 32), h)   # the signed int32 value
    h = torch.where(h == _I32_MIN, h, torch.abs(h))   # abs(INT_MIN) == INT_MIN
    return torch.remainder(h, table_size)


def build_grid(tgt: torch.Tensor, tgt_mask: torch.Tensor, cell: float,
               table_size: int = 0, bucket: int = 8) -> GridIndex:
    """The hash table of ``tgt [..., M, 3]`` (masked points left out)."""
    if tgt.dim() == 3 and _shared(tgt) and _shared(tgt_mask):
        g = build_grid(tgt[0], tgt_mask[0], cell, table_size, bucket)
        b = tgt.shape[0]
        return GridIndex(g.table.expand(b, *g.table.shape), g.origin.expand(b, 3), g.cell)
    dev = tgt.device
    m = tgt.shape[-2]
    H = table_size or 1 << max(8, (2 * m - 1).bit_length())
    cell_t = torch.full((), cell, dtype=tgt.dtype, device=dev)  # a fill: no host copy
    valid = tgt_mask > 0.5
    masked = torch.where(valid[..., None], tgt, torch.full((), 1e9, dtype=tgt.dtype, device=dev))
    origin = torch.amin(masked, dim=-2) - cell_t
    cells = _to_cells(tgt, origin[..., None, :], cell_t)
    slot = torch.where(valid, _cell_hash(cells, H), torch.full((), H, dtype=torch.int64, device=dev))

    # rank within a slot: a stable sort by slot, positions within its runs
    slot_s, idx_s = torch.sort(slot, dim=-1, stable=True)
    iota = torch.arange(m, device=dev).expand_as(slot_s)
    first = torch.ones_like(slot_s, dtype=torch.bool)
    first[..., 1:] = slot_s[..., 1:] != slot_s[..., :-1]
    run_start = torch.cummax(torch.where(first, iota, -1), dim=-1).values
    rank = iota - run_start
    keep = (rank < bucket) & (slot_s < H)
    flat = torch.where(keep, slot_s * bucket + rank, H * bucket)
    table = torch.full((*slot.shape[:-1], H * bucket + 1), -1, dtype=torch.int32, device=dev)
    table.scatter_(-1, flat, idx_s.to(torch.int32))  # ties only at the dropped slot
    table = table[..., :-1].reshape(*slot.shape[:-1], H, bucket)
    return GridIndex(table, origin, cell_t)


def grid_nearest_neighbors(src: torch.Tensor, src_mask: torch.Tensor, grid: GridIndex,
                           tgt: torch.Tensor, tgt_mask: torch.Tensor) -> NNResult:
    """1-NN among the candidates within +-1 cell of each source point
    (``src [..., N, 3]``; ``tgt`` the cloud the grid was built from).
    Sources with no candidate within ``cell``, and masked sources, report
    the sentinel distance with index 0."""
    H, K = grid.table.shape[-2:]
    if src.dim() == 3:
        b, n = src.shape[:2]
        if _shared(grid.table) and _shared(tgt) and _shared(tgt_mask):
            one = GridIndex(grid.table[0], grid.origin[0], grid.cell)
            r = grid_nearest_neighbors(src.reshape(b * n, 3), src_mask.reshape(b * n), one,
                                       tgt[0], tgt_mask[0])
            return NNResult(r.idx.reshape(b, n), r.dist.reshape(b, n))
        m = tgt.shape[-2]
        lane = torch.arange(b, device=src.device)[:, None, None]
        table = grid.table.reshape(b * H, K)
        tgt_flat = tgt.reshape(b * m, 3)
        tmask_flat = tgt_mask.reshape(b * m)
        origin = grid.origin[:, None, None, :]
    else:
        n = src.shape[0]
        lane = torch.zeros((), dtype=torch.int64, device=src.device)
        table, tgt_flat, tmask_flat, m = grid.table, tgt, tgt_mask, 0
        origin = grid.origin
    cells = _to_cells(src[..., None, :], origin, grid.cell)     # [..., N, 1, 3]
    slots = _cell_hash(cells + _offsets(src.device), H)         # [..., N, 27]
    cand = table[slots + lane * H].reshape(*src.shape[:-1], 27 * K)
    valid = cand >= 0
    safe = torch.clamp(cand, min=0).to(torch.int64) + lane * m
    d2 = torch.zeros(cand.shape, dtype=torch.float32, device=src.device)
    for c in range(3):
        dc = tgt_flat[:, c][safe] - src[..., c:c + 1]
        d2 = d2 + dc * dc
    valid = valid & (tmask_flat[safe] > 0.5)
    d2 = torch.where(valid, d2, torch.full((), _BIG, dtype=d2.dtype, device=d2.device))
    best = torch.argmin(d2, dim=-1, keepdim=True)
    dist2 = torch.gather(d2, -1, best)[..., 0]
    idx = torch.gather(cand, -1, best)[..., 0]
    big = torch.full((), _BIG, dtype=d2.dtype, device=d2.device)
    dist2 = torch.where(dist2 <= grid.cell * grid.cell, dist2, big)
    dist2 = torch.where(src_mask > 0.5, dist2, big)
    idx = torch.clamp(idx, min=0)
    # the square root in f64, rounded once to f32: correctly rounded, as
    # XLA's is (PyTorch's vectorised f32 sqrt on the CPU is not, always)
    return NNResult(idx, torch.sqrt(torch.clamp(dist2, min=0.0).double()).float())


def grid_nn(src, src_mask, tgt, tgt_mask, cell: float, bucket: int = 8) -> NNResult:
    """Build and query in one call (``cell`` at least the matcher's
    threshold)."""
    grid = build_grid(tgt, tgt_mask, cell, bucket=bucket)
    return grid_nearest_neighbors(src, src_mask, grid, tgt, tgt_mask)
