"""Rolling local map for scan-to-map odometry, built on the device (port of
``mola_fe_lidar_tpu/frontend/local_map.py``: ``DeviceLocalMap`` in
``mode="hash"`` and ``_device_build_hash``).

The last ``window`` keyframes' layers stay stacked on the device in a ring
(one slot updated per keyframe). A build world-transforms every slot,
deduplicates voxels with one hash-table scatter-min over an age-ordered
priority (the oldest keyframe's first row wins), and compacts the occupied
table slots to each layer's fixed capacity.
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np
import torch

from ..cloud.metric_map import MetricMap, PointCloud
from ..filters.pipeline import _compact

_INT32_MAX = 2**31 - 1
_MASK32 = (1 << 32) - 1


def _round_up(n: int, mult: int = 256) -> int:
    return max(mult, (n + mult - 1) // mult * mult)


def _spatial_hash(cell: torch.Tensor, table_size: int) -> torch.Tensor:
    """The reference's int32 multiply-XOR hash of voxel cells, masked to a
    power-of-two table. Products are taken in int64 and reduced mod 2^32,
    which leaves the low 32 bits of int32 wrap-around arithmetic; the table
    mask reads only those bits."""
    c = cell.to(torch.int64)
    h = (((c[:, 0] * 73856093) & _MASK32)
         ^ ((c[:, 1] * 19349663) & _MASK32)
         ^ ((c[:, 2] * 83492791) & _MASK32))
    return h & (table_size - 1)


def _device_build_hash(layers, poses_R, poses_t, kf_valid, res: float, out_caps,
                       ranks=None, inv_ranks=None) -> MetricMap:
    """Sort-free aggregate build.

    ``layers``: {name: (xyz[W,C,3], mask[W,C], attrs{k: [W,C,D]})}, slot
    order arbitrary when ``ranks``/``inv_ranks`` (i64[W], inverse
    permutations ordering slots by keyframe age) are given, else oldest
    first. ``kf_valid[W]`` zeroes unused slots."""
    out = {}
    caps = dict(out_caps)
    for name, (xyz, mask, attrs) in layers.items():
        W, C, _ = xyz.shape
        dev = xyz.device
        world = poses_R @ xyz.transpose(-1, -2)
        world = world.transpose(-1, -2) + poses_t[:, None, :]
        m = (mask * kf_valid[:, None]).reshape(W * C)
        flat = world.reshape(W * C, 3)
        cap = caps[name]
        T = 1 << max(int(cap * 4 - 1).bit_length(), 8)
        cell = torch.floor(flat / res).to(torch.int32)
        slot = _spatial_hash(cell, T)
        row_iota = torch.arange(C, dtype=torch.int64, device=dev)[None, :]
        slot_rank = (torch.arange(W, dtype=torch.int64, device=dev) if ranks is None
                     else ranks.to(torch.int64))
        pri_all = (slot_rank[:, None] * C + row_iota).reshape(W * C)
        pri = torch.where(m > 0.5, pri_all, torch.full_like(pri_all, _INT32_MAX))
        table = torch.full((T,), _INT32_MAX, dtype=torch.int64, device=dev)
        table.scatter_reduce_(0, slot, pri, reduce="amin", include_self=True)
        occ = table < _INT32_MAX
        win = torch.where(occ, table, torch.zeros_like(table))
        if inv_ranks is None:
            rowidx = win
        else:  # priority -> (rank, row) -> flat slot-major row index
            rowidx = inv_ranks.to(torch.int64)[win // C] * C + win % C
        pts = flat[rowidx]
        a_names = sorted(k for k in attrs if k != "time")
        avals = []
        for k in a_names:
            a = attrs[k]
            if k == "normal":
                a = (poses_R @ a.transpose(-1, -2)).transpose(-1, -2)
            avals.append(a.reshape(W * C, a.shape[-1])[rowidx])
        mk, pts, *vals = _compact(occ.to(torch.float32), cap, pts, *avals)
        pts = torch.where(mk[:, None] > 0.5, pts, torch.full_like(pts, 1e6))
        out[name] = PointCloud(pts, mk, dict(zip(a_names, vals)))
    return out


class DeviceLocalMap:
    """Aggregate of the last ``window`` keyframes' layers in the odometry
    world frame, built on the layers' device (hash mode only)."""

    def __init__(self, window: int = 10, capacity_mult=4,
                 dedup_voxel: float = 0.25, keep_layers=None, mode: str = "hash"):
        if mode != "hash":
            raise NotImplementedError(
                f"DeviceLocalMap mode={mode!r}: only 'hash' is ported "
                "(ROADMAP Queue 1 item 9: sort map build)")
        self.window = int(window)
        self.capacity_mult = capacity_mult
        self.dedup_voxel = float(dedup_voxel)
        self.keep_layers = set(keep_layers) if keep_layers is not None else None
        self.mode = mode
        self._caps: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._ring = None
        self._ring_slot_seq = np.full(self.window, -1, np.int64)
        self._ring_poses_R = np.tile(np.eye(3, dtype=np.float32), (self.window, 1, 1))
        self._ring_poses_t = np.zeros((self.window, 3), np.float32)
        self._seq = 0

    def __len__(self) -> int:
        return min(self._seq, self.window)

    def _ring_update(self, layers: Dict) -> None:
        """Fold one keyframe's layers into the stacked ring (in place)."""
        attrs_of = lambda pc: {k: pc.attrs[k] for k in sorted(pc.attrs) if k != "time"}
        if self._ring is not None:
            ok = set(self._ring) == set(layers) and all(
                self._ring[n][0].shape[1:] == layers[n].xyz.shape
                and set(self._ring[n][2]) == set(attrs_of(layers[n]))
                for n in layers)
            if not ok:  # layer structure changed: restart the ring
                self._ring = None
                self._ring_slot_seq.fill(-1)
        slot = self._seq % self.window
        W = self.window
        if self._ring is None:
            self._ring = {
                n: (pc.xyz.expand(W, *pc.xyz.shape).clone(),
                    torch.zeros((W, pc.mask.shape[0]), dtype=pc.mask.dtype, device=pc.mask.device),
                    {k: v.expand(W, *v.shape).clone() for k, v in attrs_of(pc).items()})
                for n, pc in layers.items()}
        for n, pc in layers.items():
            xyz, mask, attrs = self._ring[n]
            xyz[slot] = pc.xyz
            mask[slot] = pc.mask
            for k, v in attrs.items():
                v[slot] = pc.attrs[k]
        self._ring_slot_seq[slot] = self._seq

    def add_keyframe(self, mm: MetricMap, world_pose) -> None:
        R = np.asarray(world_pose[0], np.float32)
        t = np.asarray(world_pose[1], np.float32)
        layers = {}
        for name, pc in mm.items():
            if self.keep_layers is not None and name not in self.keep_layers:
                continue
            layers[name] = pc
            if name not in self._caps:
                mult = (self.capacity_mult.get(name, 1) if isinstance(self.capacity_mult, dict)
                        else self.capacity_mult)
                self._caps[name] = _round_up(int(pc.capacity * mult))
        with self._lock:
            slot = self._seq % self.window
            self._ring_update(layers)
            self._ring_poses_R[slot] = R
            self._ring_poses_t[slot] = t
            self._seq += 1

    def build(self) -> MetricMap:
        with self._lock:
            if self._ring is None:
                raise RuntimeError("DeviceLocalMap: no keyframes added")
            ring, slot_seq = self._ring, self._ring_slot_seq.copy()
            poses_R = self._ring_poses_R.copy()
            poses_t = self._ring_poses_t.copy()
        dev = next(iter(ring.values()))[0].device
        # age ranks: oldest live slot -> rank 0; dead slots last
        order = np.argsort(np.where(slot_seq < 0, np.iinfo(np.int64).max, slot_seq))
        ranks = np.empty(self.window, np.int64)
        ranks[order] = np.arange(self.window)
        kf_valid = (slot_seq >= 0).astype(np.float32)
        out_caps = tuple(sorted((n, self._caps[n]) for n in ring))
        return _device_build_hash(
            ring, torch.from_numpy(poses_R).to(dev), torch.from_numpy(poses_t).to(dev),
            torch.from_numpy(kf_valid).to(dev), self.dedup_voxel, out_caps,
            torch.from_numpy(ranks).to(dev), torch.from_numpy(order.astype(np.int64)).to(dev))
