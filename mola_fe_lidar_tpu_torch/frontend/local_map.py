"""Rolling local map for scan-to-map odometry (port of
``mola_fe_lidar_tpu/frontend/local_map.py``).

:class:`DeviceLocalMap` keeps the last ``window`` keyframes' layers on the
device and aggregates them in the odometry world frame:

* ``mode="sort"`` (the reference's default, :func:`_device_build`): stack
  the keyframes oldest first, world-transform, one stable voxel sort, keep
  the first point of every voxel (the oldest keyframe wins) and compact
  hash-uniformly to each layer's fixed capacity;
* ``mode="hash"`` (:func:`_device_build_hash`): the keyframes stay stacked
  in a ring (one slot updated per keyframe); voxels are deduplicated by one
  hash-table scatter-min over an age-ordered priority and the occupied
  table slots are compacted.

:class:`LocalMap` is the reference's host builder (numpy), with the
multi-view transient filter (``transient_min_views``); it hands its map to
the device it was given.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, Optional, Tuple

import numpy as np
import torch

from ..cloud import voxel
from ..cloud.metric_map import MetricMap, PointCloud, from_points
from ..filters.pipeline import _compact, _compact_uniform

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
        m = (mask * kf_valid[:, None]).reshape(W * C)
        flat = _world(poses_R, poses_t, xyz).reshape(W * C, 3)
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


def _world(poses_R: torch.Tensor, poses_t: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Every slot's points ``[W, C, 3]`` in the world frame."""
    return (poses_R @ xyz.transpose(-1, -2)).transpose(-1, -2) + poses_t[:, None, :]


def _device_build(layers, poses_R, poses_t, kf_valid, res: float, out_caps) -> MetricMap:
    """Sort build: ``layers`` as in :func:`_device_build_hash`, slots oldest
    first. The first point of each ``res`` voxel in slot order survives
    (the oldest keyframe wins, as the host build's ``np.unique``); a
    hash-decorrelated compaction (never an input-order slab) cuts the
    survivors to ``out_caps[name]``."""
    out = {}
    caps = dict(out_caps)
    for name, (xyz, mask, attrs) in layers.items():
        W, C, _ = xyz.shape
        flat = _world(poses_R, poses_t, xyz).reshape(W * C, 3)
        m = (mask * kf_valid[:, None]).reshape(W * C)
        vs = voxel.lex_sort_by_voxel(flat, m, res)
        a_names = sorted(k for k in attrs if k != "time")
        avals = []
        for k in a_names:
            a = attrs[k]
            if k == "normal":
                a = (poses_R @ a.transpose(-1, -2)).transpose(-1, -2)
            avals.append(a.reshape(W * C, a.shape[-1])[vs.order])
        cap = caps[name]
        mk, pts, *vals = _compact_uniform(vs.first, min(cap, W * C), vs.xyz, *avals)
        if mk.shape[0] < cap:  # fewer input rows than capacity: pad out
            pad = cap - mk.shape[0]
            mk = torch.nn.functional.pad(mk, (0, pad))
            pts = torch.nn.functional.pad(pts, (0, 0, 0, pad))
            vals = [torch.nn.functional.pad(v, (0, 0, 0, pad)) for v in vals]
        pts = torch.where(mk[:, None] > 0.5, pts, torch.full_like(pts, 1e6))
        out[name] = PointCloud(pts, mk, dict(zip(a_names, vals)))
    return out


def _voxel_keys64(xyz: np.ndarray, res: float) -> np.ndarray:
    """Voxel coordinates packed into one int64 key (21 bits an axis)."""
    c = np.floor(xyz / res).astype(np.int64)
    m = np.int64((1 << 21) - 1)
    return ((c[:, 0] & m) << 42) | ((c[:, 1] & m) << 21) | (c[:, 2] & m)


class LocalMap:
    """The host builder: the last ``window`` keyframes' valid points as
    numpy copies at their world poses; a build transforms, optionally drops
    transient voxels (seen by fewer than ``transient_min_views`` distinct
    keyframes, the newest ``transient_protect_recent`` exempt), keeps the
    first point per voxel, subsamples hash-uniformly to capacity and puts
    the map on ``device``."""

    def __init__(self, window: int = 10, capacity_mult=4, dedup_voxel: float = 0.25,
                 keep_layers=None, transient_min_views: int = 1,
                 transient_protect_recent: int = 2,
                 transient_voxel: Optional[float] = None, device="cuda"):
        self.window = int(window)
        self.capacity_mult = capacity_mult
        self.dedup_voxel = float(dedup_voxel)
        self.keep_layers = set(keep_layers) if keep_layers is not None else None
        self.transient_min_views = int(transient_min_views)
        self.transient_protect_recent = int(transient_protect_recent)
        self.transient_voxel = (float(transient_voxel) if transient_voxel
                                else 2.0 * self.dedup_voxel)
        self.device = torch.device(device)
        self._kfs: Deque[Tuple[Dict, Tuple[np.ndarray, np.ndarray]]] = deque(maxlen=self.window)
        self._caps: Dict[str, int] = {}
        self._lock = threading.Lock()  # adds on the scan thread, builds maybe on the pool

    def __len__(self) -> int:
        return len(self._kfs)

    def entries(self):
        """Snapshot of the (layers, (R, t)) entries, oldest first."""
        with self._lock:
            return list(self._kfs)

    def add_keyframe(self, mm: MetricMap, world_pose) -> None:
        R = np.asarray(world_pose[0], np.float64)
        t = np.asarray(world_pose[1], np.float64)
        layers = {}
        for name, pc in mm.items():
            if self.keep_layers is not None and name not in self.keep_layers:
                continue
            m = pc.mask.cpu().numpy() > 0.5
            layers[name] = (pc.xyz.cpu().numpy()[m],
                            {k: v.cpu().numpy()[m] for k, v in pc.attrs.items()})
            if name not in self._caps:
                self._caps[name] = _round_up(int(pc.capacity * _layer_mult(self, name)))
        with self._lock:
            self._kfs.append((layers, (R, t)))

    def build(self, entries=None) -> MetricMap:
        if entries is None:
            entries = self.entries()
        if not entries:
            raise RuntimeError("LocalMap: no keyframes added")
        out: MetricMap = {}
        for name in list(entries[-1][0].keys()):
            xs, attr_lists = [], []
            for layers, (R, t) in entries:
                if name not in layers:
                    continue
                xyz, attrs = layers[name]
                xs.append(xyz @ R.T.astype(np.float32) + t.astype(np.float32))
                a = dict(attrs)
                if "normal" in a:
                    a["normal"] = a["normal"] @ R.T.astype(np.float32)
                attr_lists.append(a)
            xyz = np.concatenate(xs).astype(np.float32)
            # attributes every keyframe has; "time" means nothing in a map
            keys = set(attr_lists[0]) if attr_lists else set()
            for a in attr_lists[1:]:
                keys &= set(a)
            keys.discard("time")
            attrs = {k: np.concatenate([a[k] for a in attr_lists]) for k in keys}
            if self.transient_min_views > 1 and len(xs) > self.transient_protect_recent:
                entry_ids = np.concatenate([np.full(len(x), i, np.int64)
                                            for i, x in enumerate(xs)])
                vkeys = _voxel_keys64(xyz, self.transient_voxel)
                pk = np.unique(np.stack([vkeys, entry_ids], 1), axis=0)
                uk, views = np.unique(pk[:, 0], return_counts=True)
                v = views[np.searchsorted(uk, vkeys)]
                keep_pt = ((v >= self.transient_min_views)
                           | (entry_ids >= len(xs) - self.transient_protect_recent))
                xyz = xyz[keep_pt]
                attrs = {k: a[keep_pt] for k, a in attrs.items()}
            cap = self._caps[name]
            keep = voxel.hash_subsample_np(voxel.voxel_first_indices_np(xyz, self.dedup_voxel), cap)
            out[name] = from_points(xyz[keep], capacity=cap,
                                    attrs={k: v[keep] for k, v in attrs.items()},
                                    device=self.device)
        return out


def _layer_mult(builder, name: str) -> int:
    mult = builder.capacity_mult
    return mult.get(name, 1) if isinstance(mult, dict) else mult


class DeviceLocalMap:
    """Aggregate of the last ``window`` keyframes' layers in the odometry
    world frame, built on the layers' device (``mode`` "sort" or "hash",
    see the module docstring). ``add_keyframe`` keeps references to the
    keyframe's device layers; :meth:`entries` snapshots them for a build on
    another thread."""

    def __init__(self, window: int = 10, capacity_mult=4,
                 dedup_voxel: float = 0.25, keep_layers=None, mode: str = "sort"):
        if mode not in ("sort", "hash"):
            raise ValueError(f"unknown DeviceLocalMap mode {mode!r}")
        self.window = int(window)
        self.capacity_mult = capacity_mult
        self.dedup_voxel = float(dedup_voxel)
        self.keep_layers = set(keep_layers) if keep_layers is not None else None
        self.mode = mode
        self._kfs: Deque[Tuple[Dict, Tuple[np.ndarray, np.ndarray]]] = deque(maxlen=self.window)
        self._caps: Dict[str, int] = {}
        self._lock = threading.Lock()
        # hash mode: the W keyframes stacked on the device, one slot
        # rewritten per keyframe (slot = seq % W); builds pass age ranks
        self._ring = None
        self._ring_slot_seq = np.full(self.window, -1, np.int64)
        self._ring_poses_R = np.tile(np.eye(3, dtype=np.float32), (self.window, 1, 1))
        self._ring_poses_t = np.zeros((self.window, 3), np.float32)
        self._seq = 0

    def __len__(self) -> int:
        return len(self._kfs)

    def entries(self):
        """Snapshot of the (layers, (R, t)) entries, oldest first."""
        with self._lock:
            return list(self._kfs)

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
                self._caps[name] = _round_up(int(pc.capacity * _layer_mult(self, name)))
        with self._lock:
            self._kfs.append((layers, (R, t)))
            if self.mode == "hash":
                slot = self._seq % self.window
                self._ring_update(layers)
                self._ring_poses_R[slot] = R
                self._ring_poses_t[slot] = t
                self._seq += 1

    def build(self, entries=None) -> MetricMap:
        """The aggregate; from the ring (hash mode) or from ``entries``
        (default: a snapshot of :meth:`entries`)."""
        if entries is None and self.mode == "hash":
            with self._lock:
                ring, slot_seq = self._ring, self._ring_slot_seq.copy()
                poses_R = self._ring_poses_R.copy()
                poses_t = self._ring_poses_t.copy()
            if ring is None:
                raise RuntimeError("DeviceLocalMap: no keyframes added")
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
        if entries is None:
            entries = self.entries()
        if not entries:
            raise RuntimeError("DeviceLocalMap: no keyframes added")
        W = self.window
        # W slots: the entries oldest first, then the last one repeated
        # with kf_valid = 0 (fully masked filler)
        slots = list(entries) + [entries[-1]] * (W - len(entries))
        dev = next(iter(entries[-1][0].values())).xyz.device
        kf_valid = torch.tensor([1.0] * len(entries) + [0.0] * (W - len(entries)),
                                dtype=torch.float32, device=dev)
        poses_R = torch.from_numpy(np.stack([np.asarray(R, np.float32) for _, (R, _) in slots])).to(dev)
        poses_t = torch.from_numpy(np.stack([np.asarray(t, np.float32) for _, (_, t) in slots])).to(dev)
        layers = {}
        names = list(entries[-1][0].keys())
        for name in names:
            pcs = [lay[name] for lay, _ in slots]
            # attributes every entry has ("time" is dropped in the build)
            keys = set(pcs[0].attrs)
            for pc in pcs[1:]:
                keys &= set(pc.attrs)
            layers[name] = (torch.stack([pc.xyz for pc in pcs]),
                            torch.stack([pc.mask for pc in pcs]),
                            {k: torch.stack([pc.attrs[k] for pc in pcs]) for k in keys})
        out_caps = tuple(sorted((n, self._caps[n]) for n in names))
        build = _device_build_hash if self.mode == "hash" else _device_build
        return build(layers, poses_R, poses_t, kf_valid, self.dedup_voxel, out_caps)
