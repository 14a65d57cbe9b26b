"""MetricMap -- named layers of fixed-capacity padded point clouds (port of
``mola_fe_lidar_tpu/cloud/metric_map.py``).

A layer is a :class:`PointCloud` with ``xyz: f32[N,3]``, ``mask: f32[N]``
(1.0 = real point) and per-point ``attrs``; padding rows sit at 1e6.
Capacities are bucketed to multiples of 256, as in the reference, so the
two packages hold the same shapes. ``from_numpy_layers`` /
``to_numpy_layers`` carry a map across the package boundary; the npz
format of ``save_metric_map`` / ``load_metric_map`` is the reference's.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .voxel import hash_subsample_np


class PointCloud(NamedTuple):
    xyz: torch.Tensor                 # f32[N, 3]
    mask: torch.Tensor                # f32[N]
    attrs: Dict[str, torch.Tensor]    # each f32[N, D]

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return torch.sum(self.mask, dim=-1).to(torch.int32)


MetricMap = Dict[str, PointCloud]


class ShardedCloud(NamedTuple):
    """A layer split along its point axis into contiguous slices, one per
    position of a mesh axis (each slice on its position's device): the
    target layer of a tensor-parallel align (``ops/tp.py``)."""
    xyz: Tuple[torch.Tensor, ...]               # each f32[..., M/P, 3]
    mask: Tuple[torch.Tensor, ...]              # each f32[..., M/P]
    attrs: Dict[str, Tuple[torch.Tensor, ...]]  # each f32[..., M/P, D]


def split_cloud(pc: PointCloud, devices) -> ShardedCloud:
    """``pc``'s point axis cut into ``len(devices)`` equal contiguous
    slices, slice i on ``devices[i]``: a view where it is already there,
    a copy elsewhere. The capacity must divide by the number of slices."""
    p, m = len(devices), pc.capacity
    if m % p:
        raise ValueError(f"a layer of capacity {m} does not split into {p} equal slices")
    size = m // p

    def cut(x, dim):
        return tuple(x.narrow(dim, i * size, size).to(dev) for i, dev in enumerate(devices))

    return ShardedCloud(cut(pc.xyz, -2), cut(pc.mask, -1),
                        {k: cut(v, -2) for k, v in pc.attrs.items()})


def _round_capacity(n: int, multiple: int = 256) -> int:
    return max(multiple, -(-n // multiple) * multiple)


def empty_cloud(capacity: int, attrs: tuple = (), dtype=torch.float32,
                device="cuda") -> PointCloud:
    """An all-padding cloud; ``attrs`` is ``((name, width), ...)``."""
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return PointCloud(zeros(capacity, 3), zeros(capacity),
                      {k: zeros(capacity, d) for k, d in attrs})


def concat_clouds(a: PointCloud, b: PointCloud) -> PointCloud:
    """Concatenate along the point axis (capacities add); only attributes
    both clouds carry are kept."""
    return PointCloud(torch.cat([a.xyz, b.xyz], dim=-2), torch.cat([a.mask, b.mask], dim=-1),
                      {k: torch.cat([v, b.attrs[k]], dim=-2)
                       for k, v in a.attrs.items() if k in b.attrs})


def host_to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``. To a CUDA device the copy goes through
    pinned memory without blocking the host: a copy from pageable memory
    would wait for every launch queued on the stream, and the pipelined
    scan step ingests the next scan while the current one still runs."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def from_points(points, capacity: Optional[int] = None,
                attrs: Optional[Dict[str, np.ndarray]] = None,
                pad_far: float = 1e6, device="cuda") -> PointCloud:
    """Pad (or hash-uniformly subsample, never truncate in input order) an
    ``[n,3]`` array into a fixed-capacity cloud on ``device``."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    cap = capacity if capacity is not None else _round_capacity(n)
    out = np.full((cap, 3), pad_far, dtype=np.float32)
    m = np.zeros((cap,), dtype=np.float32)
    k = min(n, cap)
    sel = np.sort(hash_subsample_np(np.arange(n), cap)) if n > cap else slice(None)
    out[:k] = points[sel][:k]
    m[:k] = 1.0
    out_attrs = {}
    for name, a in (attrs or {}).items():
        a = np.asarray(a, dtype=np.float32)
        a = (a.reshape(n, -1) if n
             else a.reshape(0, a.shape[-1] if a.ndim >= 2 else 1))
        buf = np.zeros((cap, a.shape[1]), dtype=np.float32)
        buf[:k] = a[sel][:k]
        out_attrs[name] = host_to_device(buf, device)
    return PointCloud(host_to_device(out, device), host_to_device(m, device), out_attrs)


def to_numpy(cloud: PointCloud) -> np.ndarray:
    """The valid points as a host ``f32[n,3]`` array."""
    xyz = cloud.xyz.detach().cpu().numpy()
    return xyz[cloud.mask.detach().cpu().numpy() > 0.5]


def from_numpy_layers(layers: Dict[str, dict], device="cuda") -> MetricMap:
    """``{layer: {"xyz", "mask", "attrs": {name: array}}}`` (numpy, e.g. a
    reference MetricMap read back to the host) -> tensors on ``device``."""
    return {
        name: PointCloud(
            torch.tensor(np.asarray(e["xyz"], np.float32), device=device),
            torch.tensor(np.asarray(e["mask"], np.float32), device=device),
            {k: torch.tensor(np.asarray(v, np.float32), device=device)
             for k, v in e.get("attrs", {}).items()})
        for name, e in layers.items()}


def to_numpy_layers(mm: MetricMap) -> Dict[str, dict]:
    """Inverse of :func:`from_numpy_layers`."""
    return {
        name: {"xyz": pc.xyz.detach().cpu().numpy(),
               "mask": pc.mask.detach().cpu().numpy(),
               "attrs": {k: v.detach().cpu().numpy() for k, v in pc.attrs.items()}}
        for name, pc in mm.items()}


def save_metric_map(path: str, mm: MetricMap) -> None:
    """Serialize to ``.npz`` in the reference's key layout
    (``layer/xyz``, ``layer/mask``, ``layer/attr/name``)."""
    payload = {}
    for layer, e in to_numpy_layers(mm).items():
        payload[f"{layer}/xyz"] = e["xyz"]
        payload[f"{layer}/mask"] = e["mask"]
        for aname, a in e["attrs"].items():
            payload[f"{layer}/attr/{aname}"] = a
    np.savez_compressed(path, **payload)


def load_metric_map(path: str, device="cuda") -> MetricMap:
    layers: Dict[str, dict] = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            entry = layers.setdefault(parts[0], {"attrs": {}})
            if parts[1] == "attr":
                entry["attrs"][parts[2]] = data[key]
            else:
                entry[parts[1]] = data[key]
    return from_numpy_layers(layers, device=device)
