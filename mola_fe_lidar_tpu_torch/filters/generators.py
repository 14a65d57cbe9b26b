"""Generators: raw observation -> MetricMap layers (port of
``mola_fe_lidar_tpu/filters/generators.py``).

A raw observation is a host dict ``{"xyz": np[n,3], "timestamp": float,
...}``; the generator ingests it into a fixed-capacity cloud on the
module's device, with sensor-reported invalid rows and a range gate folded
into the mask.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..cloud.metric_map import MetricMap, PointCloud, from_points, host_to_device
from .base import GENERATOR_REGISTRY


@GENERATOR_REGISTRY.register("GeneratorRawPoints")
@GENERATOR_REGISTRY.register("mp2p_icp_filters::Generator")
class GeneratorRawPoints:
    """Observation -> ``target_layer`` cloud with range gating."""

    def __init__(self, target_layer="raw", capacity=None,
                 min_range=0.0, max_range=0.0, keep_intensity=False,
                 keep_time=False, device="cuda"):
        self.target_layer = target_layer
        self.capacity = capacity
        self.min_range = float(min_range)
        self.max_range = float(max_range)  # 0 = unlimited
        self.keep_intensity = bool(keep_intensity)
        self.keep_time = bool(keep_time)
        self.device = torch.device(device)

    def __call__(self, obs: Dict[str, Any]) -> MetricMap:
        pts = np.asarray(obs["xyz"], dtype=np.float32)
        attrs = {}
        if self.keep_intensity and "intensity" in obs:
            attrs["intensity"] = np.asarray(obs["intensity"], np.float32)[:, None]
        if self.keep_time and "time" in obs:
            attrs["time"] = np.asarray(obs["time"], np.float32)[:, None]
        pc = from_points(pts, capacity=self.capacity, attrs=attrs, device=self.device)
        if "valid" in obs:
            v = np.asarray(obs["valid"], np.float32)
            pad = pc.mask.shape[0] - v.shape[0]
            v = np.pad(v, (0, pad)) if pad >= 0 else v[: pc.mask.shape[0]]
            pc = PointCloud(pc.xyz, pc.mask * host_to_device(v, self.device), pc.attrs)
        if self.min_range > 0.0 or self.max_range > 0.0:
            pc = _range_gate(pc, self.min_range, self.max_range)
        return {self.target_layer: pc}


def _range_gate(pc: PointCloud, min_range: float, max_range: float) -> PointCloud:
    r = torch.linalg.vector_norm(pc.xyz, dim=-1)
    keep = r >= min_range
    if max_range > 0.0:
        keep = keep & (r <= max_range)
    m = pc.mask * keep.to(pc.mask.dtype)
    xyz = torch.where(m[:, None] > 0.5, pc.xyz, torch.full_like(pc.xyz, 1e6))
    return PointCloud(xyz, m, pc.attrs)


def apply_generators(generators: Sequence, obs: Dict[str, Any]) -> MetricMap:
    """Run all generators on one observation (later ones win on a layer
    name collision)."""
    mm: MetricMap = {}
    for g in generators:
        mm.update(g(obs))
    return mm


def generators_from_config(cfg: List[Dict[str, Any]] | None, device="cuda") -> List:
    from .base import make_generator

    return [make_generator(item["class"], {**(item.get("params") or {}), "device": device})
            for item in cfg or [{"class": "GeneratorRawPoints", "params": {}}]]
