"""Tensor-parallel searches: the target point axis split over the positions
of a mesh axis (port of ``mola_fe_lidar_tpu/ops/matching.py``'s ``tp_*``).

The reference runs these inside ``shard_map``: each device searches its
shard of the target, ``all_gather``s the per-shard champions and merges
them, replicated. Here one process holds the source on the lead position
(its device) and the target as per-position slices (``cloud.metric_map.
ShardedCloud``). Each slice is searched by K1/K2's wrappers
(``ops/knn_kernel.py::knn``, ``ops/nn_kernel.py::nearest_neighbors``: the
kernels on CUDA tensors, their plain twins on CPU tensors) on the slice's
device; the ``[P, N(, k)]`` champions, their indices offset to global
ones, come back to the lead position and are merged there with torch ops.

The merge gives the unsharded search's answer bit for bit wherever equal
distances mean equal squared distances: the k-NN merge keys on
(distance bits, global index), as the twin keys on (d² bits, index), and
the 1-NN merge takes the first minimum over the slices in order. (Two
distinct d² that round to one f32 distance are ordered by d² unsharded and
by index here.) Masked sources are searched at the origin, where the
kernels park them, and get the sentinel distance after the merge, so their
indices are the unsharded search's too. A neighbour slot beyond 1e4 m (or
missing) carries slice 0's index 0 after the merge, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import knn_kernel, nn_kernel
from .matching import BIG, NNResult


def _merge(search, src, src_mask, tgt_slices, mask_slices, k: Optional[int]) -> NNResult:
    """``search`` of every slice on its device, then the k smallest of the
    slices' champions by (distance bits, global index) on the source's
    device (``k=None``: 1-NN, no list axis)."""
    lead = src.device
    parked = torch.where(src_mask[..., None] > 0.5, src, torch.zeros((), device=lead))
    everyone = torch.ones_like(src_mask)
    dists, idxs, offset = [], [], 0
    for t, tm in zip(tgt_slices, mask_slices):
        dev = t.device
        res = search(parked.to(dev), everyone.to(dev), t, tm)
        dists.append(res.dist.to(lead))
        idxs.append(res.idx.to(lead) + offset)
        offset += t.shape[-2]
    cat = (lambda xs: torch.stack(xs, dim=-1)) if k is None else (lambda xs: torch.cat(xs, dim=-1))
    d, i = cat(dists), cat(idxs)  # [..., N, P] or [..., N, P*k], slices in order
    # non-negative floats order like their bit patterns; indices are unique
    key = (d.view(torch.int32).to(torch.int64) << 32) | i.to(torch.int64)
    key = torch.topk(key, k or 1, dim=-1, largest=False, sorted=True).values
    if k is None:
        key = key[..., 0]
    dist = (key >> 32).to(torch.int32).view(torch.float32)
    ok = src_mask > 0.5
    if dist.dim() > ok.dim():
        ok = ok[..., None]
    return NNResult((key & 0xFFFFFFFF).to(torch.int32),
                    torch.where(ok, dist, torch.sqrt(torch.full((), BIG, device=lead))))


def tp_nearest_neighbors(src, src_mask, tgt_slices: Sequence[torch.Tensor],
                         mask_slices: Sequence[torch.Tensor]) -> NNResult:
    """1-NN of each source point over a target held as slices: the first
    minimum of the slices' champions, slices in order (``idx`` global)."""
    return _merge(nn_kernel.nearest_neighbors, src, src_mask, tgt_slices, mask_slices, None)


def tp_knn(src, src_mask, tgt_slices: Sequence[torch.Tensor],
           mask_slices: Sequence[torch.Tensor], k: int) -> NNResult:
    """k-NN over a target held as slices: the k smallest of the P·k
    champions by (distance bits, global index), ascending."""
    return _merge(lambda *a: knn_kernel.knn(*a, k), src, src_mask, tgt_slices, mask_slices, k)


def tp_gather_points(slices: Sequence[torch.Tensor], global_idx: torch.Tensor) -> torch.Tensor:
    """Rows of a point-axis-split ``[..., M, D]`` array by global index,
    on the index's device: each row read from the slice that owns it. A
    batched array (``[B, M/P, D]`` slices) is gathered per lane."""
    lead = global_idx.device
    out, offset = None, 0
    for x in slices:
        size = x.shape[-2]
        local = global_idx.long() - offset
        inside = (local >= 0) & (local < size)
        at = local.clamp(0, size - 1).to(x.device)
        if x.dim() == 2:
            vals = x[at]
        else:
            lane = torch.arange(at.shape[0], device=x.device).view(-1, *([1] * (at.dim() - 1)))
            vals = x[lane, at]
        vals = vals.to(lead)
        out = vals if out is None else torch.where(inside[..., None], vals, out)
        offset += size
    return out
