"""Exact nearest-neighbour search in plain PyTorch (port of
``mola_fe_lidar_tpu/ops/matching.py``'s contract).

These are the plain twins of the CUDA kernels K1 (``ops/knn_kernel.py``)
and K2 (``ops/nn_kernel.py``): the wrappers call them for CPU tensors, and
on the card they are the reference the kernels are held against. They
follow the Pallas kernels' contract (``pallas_knn`` / ``pallas_nearest_
neighbors``), which is also ``matching.knn``'s up to f32 round-off:

* squared distances in difference form, ``((dx*dx + dy*dy) + dz*dz)``,
  each op rounded in f32 -- the same bits the CUDA kernels produce;
* masked targets are parked at 3e4 per axis, masked sources sit at the
  origin; a neighbour farther than 1e4 m is reported at the 1e15 sentinel
  with index 0, and masked sources report the sentinel;
* the k results are the k smallest (d2, index) pairs, ascending: equal
  distances keep the lower target index.

The distance matrix is materialised one source chunk at a time. A batch
(``src [B,N,3]``, ``tgt [B,M,3]``, either possibly a stride-0 expand of one
cloud) is B separate searches, one lane at a time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PARK = 3e4
INVALID_D2 = 1e8  # (1e4 m)^2
BIG = 1e30
_CHUNK_ELEMS = 1 << 24  # distance-matrix entries per source chunk


class NNResult(NamedTuple):
    idx: torch.Tensor   # i32[N] or i32[N, k]: index into the target cloud
    dist: torch.Tensor  # f32[N] or f32[N, k]: euclidean distance


def _sq_dists(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """``dx*dx + dy*dy + dz*dz`` in that order, in place (two buffers)."""
    d2 = src[:, None, 0] - tgt[None, :, 0]
    d2.mul_(d2)
    tmp = src[:, None, 1] - tgt[None, :, 1]
    d2.add_(tmp.mul_(tmp))
    torch.sub(src[:, None, 2], tgt[None, :, 2], out=tmp)
    return d2.add_(tmp.mul_(tmp))


def _prepare(src, src_mask, tgt, tgt_mask):
    s = torch.where(src_mask[:, None] > 0.5, src, torch.zeros((), dtype=src.dtype, device=src.device))
    t = torch.where(tgt_mask[:, None] > 0.5, tgt, torch.full((), PARK, dtype=tgt.dtype, device=tgt.device))
    return s, t


def _finish(d2, idx, src_mask, m) -> NNResult:
    invalid = d2 > INVALID_D2
    d2 = torch.where(invalid, torch.full_like(d2, BIG), d2)
    idx = torch.where(invalid, torch.zeros_like(idx), torch.clamp(idx, max=m - 1))
    ok = src_mask > 0.5
    if d2.dim() == 2:
        ok = ok[:, None]
    d2 = torch.where(ok, d2, torch.full_like(d2, BIG))
    return NNResult(idx.to(torch.int32), torch.sqrt(d2))


def _per_lane(fn, src, src_mask, tgt, tgt_mask, *rest) -> NNResult:
    outs = [fn(src[b], src_mask[b], tgt[b], tgt_mask[b], *rest) for b in range(src.shape[0])]
    if not outs:
        raise ValueError("empty batch")
    return NNResult(torch.stack([o.idx for o in outs]), torch.stack([o.dist for o in outs]))


def knn(src, src_mask, tgt, tgt_mask, k: int) -> NNResult:
    """k-NN of each source point: ``idx i32[..., N, k]``, ``dist
    f32[..., N, k]`` ascending (the K1 contract)."""
    if src.dim() == 3:
        return _per_lane(knn, src, src_mask, tgt, tgt_mask, k)
    s, t = _prepare(src, src_mask, tgt, tgt_mask)
    n, m = s.shape[0], t.shape[0]
    chunk = max(1, _CHUNK_ELEMS // max(m, 1))
    kk = min(k, m)
    d_parts, i_parts = [], []
    cols = torch.arange(m, device=s.device)
    for lo in range(0, n, chunk):
        d2 = _sq_dists(s[lo:lo + chunk], t)
        # one int64 key per pair, (d2 bits, index): non-negative floats
        # order like their bit patterns, so the k smallest keys are the k
        # smallest distances with ties going to the lower target index
        key = (d2.view(torch.int32).to(torch.int64) << 32) | cols
        key = torch.topk(key, kk, dim=1, largest=False, sorted=True).values
        d_parts.append((key >> 32).to(torch.int32).view(torch.float32))
        i_parts.append(key & 0xFFFFFFFF)
    d2 = torch.cat(d_parts) if d_parts else s.new_zeros((0, kk))
    idx = torch.cat(i_parts) if i_parts else s.new_zeros((0, kk), dtype=torch.int64)
    if kk < k:  # fewer targets than k: the empty slots are invalid
        d2 = torch.cat([d2, d2.new_full((n, k - kk), BIG)], dim=1)
        idx = torch.cat([idx, idx.new_zeros((n, k - kk))], dim=1)
    return _finish(d2, idx, src_mask, m)


def nearest_neighbors(src, src_mask, tgt, tgt_mask) -> NNResult:
    """1-NN of each source point: ``idx i32[..., N]``, ``dist f32[..., N]``
    (the K2 contract)."""
    if src.dim() == 3:
        return _per_lane(nearest_neighbors, src, src_mask, tgt, tgt_mask)
    s, t = _prepare(src, src_mask, tgt, tgt_mask)
    n, m = s.shape[0], t.shape[0]
    chunk = max(1, _CHUNK_ELEMS // max(m, 1))
    d_parts, i_parts = [], []
    for lo in range(0, n, chunk):
        # min() returns the first minimal index: ties keep the lower index
        vals, idx = torch.min(_sq_dists(s[lo:lo + chunk], t), dim=1)
        d_parts.append(vals)
        i_parts.append(idx)
    d2 = torch.cat(d_parts) if d_parts else s.new_zeros((0,))
    idx = torch.cat(i_parts) if i_parts else s.new_zeros((0,), dtype=torch.int64)
    return _finish(d2, idx, src_mask, m)
