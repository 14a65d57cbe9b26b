"""The one generator of the benchmark's inputs. A configuration file
(``configs/<name>.json``) fixes the deployment: the sensor, the world and
the module's or the localizer's settings; a traffic file
(``traffic/<name>.json``) fixes the mix: its ``kind`` (the feed that runs
it), the route and speed, the queries and their draws. Both
are data: a new mix is a new file.

Everything here is made from the run's ``--seed`` and the files: the range
noise and dropout of every scan (on the card), the query order and the
initial-pose perturbations. The world's layout is the configuration's
(``world.seed``): one city, so every seed does the same amount of work.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

import hdl64
import hdl64_torch


def world_and_route(cfg: dict, traffic: dict) -> Tuple[hdl64.HDL64World, hdl64.RoutePose]:
    w, s = cfg["world"], cfg["sensor"]
    world = hdl64.HDL64World(extent=float(w["extent_m"]), block_pitch=float(w["block_pitch_m"]),
                             building_fill=float(w["building_fill"]), seed=int(w["seed"]),
                             max_range=float(s["max_range_m"]),
                             range_noise=float(s["range_noise_m"]), dropout=float(s["dropout"]))
    if w.get("parked_cars"):
        world.add_parked_cars(int(w["parked_cars"]))
    if w.get("moving_cars"):
        world.add_moving_cars(int(w["moving_cars"]))
    route = hdl64.make_route(traffic["route"], world, speed=float(traffic["speed_mps"]))
    return world, route


def scans(cfg: dict, traffic: dict, seed: int, n_scans: int, azimuths: int,
          device) -> Tuple[List[Dict], List[Tuple[np.ndarray, np.ndarray]]]:
    """Scans 0 .. n_scans - 1 of the mix's route, ray-cast on ``device``."""
    world, route = world_and_route(cfg, traffic)
    return hdl64_torch.generate(world, route, n_scans, azimuths, seed, device)


def valid_points(obs: Dict, min_range: float = 0.0) -> np.ndarray:
    """The valid returns of a scan (f32 [n, 3]), those nearer than
    ``min_range`` left out."""
    keep = obs["valid"] > 0
    if min_range > 0:
        keep &= np.linalg.norm(obs["xyz"], axis=1) >= min_range
    return obs["xyz"][keep]


def voxel_first(points: np.ndarray, res: float) -> np.ndarray:
    """The first point (in input order) of each ``res`` voxel."""
    if len(points) == 0:
        return points
    cells = np.floor(points / res).astype(np.int64)
    _, first = np.unique(cells, axis=0, return_index=True)
    return points[np.sort(first)]


def map_sizes(kf_points, kf_edges, poses, voxel: float) -> Tuple[int, int]:
    """Real points of the localizer map and of its edges layer: each
    keyframe placed at its pose and deduplicated in ``voxel`` voxels, then
    the concatenation deduplicated again."""
    def merged(clouds):
        placed = [voxel_first((np.asarray(c, np.float32) @ np.asarray(R, np.float64).T
                               + np.asarray(t)).astype(np.float32), voxel)
                  for c, (R, t) in zip(clouds, poses) if len(c)]
        return len(voxel_first(np.concatenate(placed), voxel)) if placed else 0
    return merged(kf_points), merged(kf_edges)


def spread_subsample(points: np.ndarray, cap: int) -> np.ndarray:
    """At most ``cap`` points, evenly spaced in input order (scan order is
    azimuth order, so this keeps the whole sweep)."""
    if len(points) <= cap:
        return points
    return points[np.unique(np.linspace(0, len(points) - 1, cap).round().astype(np.int64))]


def edge_points(points: np.ndarray, res: float, cap: int, device, min_count: int = 5,
                line_ratio: float = 80.0, max_plane_ratio: float = 30.0,
                min_verticality: float = 0.6, stride: int = 10) -> np.ndarray:
    """Points of line-like, near-vertical ``res`` voxels (poles, corners):
    eigenvalues e0 <= e1 <= e2 of a voxel's covariance with e2 >=
    ``line_ratio`` e0 and e1 <= ``max_plane_ratio`` e0, its main axis within
    ~53 degrees of vertical; every ``stride``-th point of each such voxel,
    at most ``cap`` (evenly spaced). The query and map ``edges`` layer of
    the localizer cells, made by the benchmark and handed to both sides."""
    if len(points) == 0:
        return points
    p = torch.as_tensor(points, dtype=torch.float64, device=device)
    cells = torch.floor(p / res).to(torch.int64)
    _, inv, counts = torch.unique(cells, dim=0, return_inverse=True, return_counts=True)
    nv = counts.shape[0]
    cnt = counts.to(torch.float64)
    mean = torch.zeros((nv, 3), dtype=torch.float64, device=p.device).index_add_(0, inv, p)
    mean = mean / cnt[:, None]
    d = p - mean[inv]
    cov = torch.zeros((nv, 3, 3), dtype=torch.float64, device=p.device).index_add_(
        0, inv, d[:, :, None] * d[:, None, :]) / cnt[:, None, None]
    evals, evecs = torch.linalg.eigh(cov)
    floor = (0.01 * res) ** 2
    e = torch.clamp(evals, min=floor)
    line = ((counts >= min_count) & (e[:, 2] >= line_ratio * e[:, 0])
            & (e[:, 1] <= max_plane_ratio * e[:, 0])
            & (evecs[:, 2, 2].abs() >= min_verticality))
    order = torch.argsort(inv, stable=True)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(inv)
    pos[order] = torch.arange(len(inv), device=p.device) - start[inv[order]]
    keep = line[inv] & (pos % stride == 0)
    return spread_subsample(points[keep.cpu().numpy()], cap)


def _rng(seed: int, salt: int) -> np.random.Generator:
    """A numpy generator for one use of the run's seed (any whole number)."""
    s = int(seed) % (1 << 64)
    return np.random.default_rng([s & 0xFFFFFFFF, s >> 32, salt])


def perturbations(seed: int, n: int, sigma_xyz: float, sigma_yaw_deg: float) -> np.ndarray:
    """[n, 4] draws (dx, dy, dz, dyaw) of N(0, sigma) from the seed."""
    rng = _rng(seed, 0x10CA1)
    out = np.empty((n, 4))
    out[:, :3] = rng.normal(0.0, sigma_xyz, (n, 3))
    out[:, 3] = rng.normal(0.0, np.deg2rad(sigma_yaw_deg), n)
    return out


def perturbed(pose: Tuple[np.ndarray, np.ndarray], draw: np.ndarray):
    """A pose moved by a draw: yaw about its own vertical axis, the
    translation in the world frame."""
    c, s = np.cos(draw[3]), np.sin(draw[3])
    Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return np.asarray(pose[0], np.float64) @ Rz, np.asarray(pose[1], np.float64) + draw[:3]


def query_order(seed: int, n: int) -> np.ndarray:
    """A permutation of the held-out queries from the seed; a run cycles
    through it."""
    return _rng(seed, 0x0DE7).permutation(n)


def sample(seed: int, n: int, k: int, salt: int) -> List[int]:
    """``k`` of ``range(n)`` drawn from the seed (all when n <= k), sorted."""
    if n <= k:
        return list(range(n))
    return sorted(_rng(seed, salt).choice(n, size=k, replace=False).tolist())
