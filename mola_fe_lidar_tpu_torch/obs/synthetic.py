"""Synthetic LiDAR dataset: structured world + trajectory → scan stream.

The test harness the reference ecosystem lacks (SURVEY.md §4: validation
there is "run mola-cli on KITTI and eyeball trajectories"). Provides
deterministic scans with exact ground truth for odometry/loop-closure
integration tests and for benchmarking without dataset downloads.

A copy of ``mola_fe_lidar_tpu/obs/synthetic.py``: the port imports nothing of the
JAX package. ``tests/test_torch_copies.py`` holds the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class SyntheticWorld:
    """A world of ground plane + walls + poles, sampled per scan.

    Each scan takes the world points within ``max_range`` of the sensor,
    expresses them in the sensor frame, adds noise, and subsamples to
    ``points_per_scan`` — enough realism for registration (overlap,
    structure, occlusion-free).
    """

    extent: float = 120.0
    n_world_points: int = 200_000
    max_range: float = 50.0
    points_per_scan: int = 8192
    noise: float = 0.01
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        e = self.extent
        n = self.n_world_points
        # ground
        ground = np.stack([
            rng.uniform(-e, e, n // 2), rng.uniform(-e, e, n // 2),
            np.zeros(n // 2)], -1)
        # city-block walls on a grid
        walls = []
        n_wall = n // 2 // 40
        for gx in np.arange(-e + 20, e, 40.0):
            for gy in np.arange(-e + 20, e, 40.0):
                L = 12.0
                side = rng.integers(0, 2)
                xs = rng.uniform(gx - L / 2, gx + L / 2, n_wall)
                ys = np.full(n_wall, gy) if side else rng.uniform(gy - L / 2, gy + L / 2, n_wall)
                if side:
                    pass
                else:
                    xs, ys = np.full(n_wall, gx), ys
                zs = rng.uniform(0, 6, n_wall)
                walls.append(np.stack([xs, ys, zs], -1))
        # vertical poles every 15 m — distinctive structure so scans are
        # well-conditioned for registration even far from walls
        poles = []
        n_pole = max(60, n // 400)
        for px in np.arange(-e + 7.5, e, 15.0):
            for py in np.arange(-e + 7.5, e, 15.0):
                zs = rng.uniform(0, 4, n_pole)
                poles.append(np.stack([
                    np.full(n_pole, px) + rng.normal(0, 0.01, n_pole),
                    np.full(n_pole, py) + rng.normal(0, 0.01, n_pole),
                    zs], -1))
        pts = np.concatenate([ground] + walls + poles).astype(np.float32)
        self._points = pts
        self._rng = rng

    def scan_at(self, R: np.ndarray, t: np.ndarray) -> np.ndarray:
        """Points in the sensor frame at world pose (R, t)."""
        d = self._points - t
        within = np.einsum("nd,nd->n", d, d) < self.max_range**2
        local = d[within] @ R  # R^T applied from the right
        if len(local) > self.points_per_scan:
            idx = self._rng.choice(len(local), self.points_per_scan, replace=False)
            local = local[idx]
        local = local + self._rng.normal(0, self.noise, local.shape)
        return local.astype(np.float32)


def _yaw_pose(x, y, yaw) -> Tuple[np.ndarray, np.ndarray]:
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)
    return R, np.array([x, y, 1.7])  # sensor 1.7 m above ground


def synthetic_sequence(
    kind: str = "loop",
    n_scans: int = 60,
    speed: float = 2.0,
    rate_hz: float = 2.0,
    world: Optional[SyntheticWorld] = None,
    loop_side: float = 60.0,
) -> Tuple[List[Dict], List[Tuple[np.ndarray, np.ndarray]]]:
    """Generate (observations, ground_truth_poses).

    kinds: ``straight`` corridor run; ``circle`` smooth circular circuit
    returning to the start (the loop-closure case: topological distance
    grows while euclidean shrinks, with continuous yaw so scan-to-scan ICP
    stays well-conditioned); ``loop`` square circuit with hard 90° corners
    (stress case).
    """
    world = world or SyntheticWorld()
    dt = 1.0 / rate_hz
    step = speed * dt
    obs, gt = [], []
    if kind == "straight":
        xs = [(-0.45 * world.extent + i * step, 0.0, 0.0) for i in range(n_scans)]
    elif kind == "circle":
        radius = loop_side / 2.0
        # close the circle over exactly n_scans steps; heading = tangent
        xs = [(radius * np.cos(a), radius * np.sin(a), a + np.pi / 2)
              for a in (2.0 * np.pi * i / n_scans for i in range(n_scans))]
    elif kind == "loop":
        per_side = max(1, n_scans // 4)
        side = loop_side
        xs = []
        x0 = y0 = -side / 2
        for i in range(per_side):
            xs.append((x0 + i * side / per_side, y0, 0.0))
        for i in range(per_side):
            xs.append((x0 + side, y0 + i * side / per_side, np.pi / 2))
        for i in range(per_side):
            xs.append((x0 + side - i * side / per_side, y0 + side, np.pi))
        for i in range(per_side):
            xs.append((x0, y0 + side - i * side / per_side, -np.pi / 2))
        xs = xs[:n_scans]
    else:
        raise ValueError(f"unknown sequence kind {kind!r}")

    for i, (x, y, yaw) in enumerate(xs):
        R, t = _yaw_pose(x, y, yaw)
        pts = world.scan_at(R, t)
        obs.append({
            "xyz": pts,
            "timestamp": i * dt,
            "sensor_label": "lidar",
        })
        gt.append((R, t))
    return obs, gt
