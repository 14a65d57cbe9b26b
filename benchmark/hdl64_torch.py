"""The HDL-64 scans of a run, ray-cast on the card.

A rewrite in PyTorch of :meth:`hdl64.HDL64World.scan` (the benchmark's copy
of the simulator): the same world, route, beam table, ray directions,
primitives and fixed-shape output, in float64, for many scans at once. The
range noise and the dropout are drawn from a ``torch.Generator`` seeded by
the run's seed, so they differ from the numpy copy's draws;
``tests/test_bench_generator.py`` holds the geometry (every range, with
noise and dropout off) to the numpy copy.

The scans come back as host numpy dicts, as a sensor interface hands them
to the program: ``xyz`` f32 [N, 3] in the sensor frame at each column's fire
time, ``valid`` f32 [N], ``time`` f32 [N] (sweep fraction), ``timestamp``
and ``sensor_label``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from hdl64 import _BEAM_ELEVATIONS, SWEEP_PERIOD, HDL64World, RoutePose

_F64 = torch.float64
# primitives tested against a block of rays at once (bounds the temporaries)
_PRIM_CHUNK = 32


def _ground(o, d):
    dz = d[:, 2]
    t = (0.0 - o[:, 2]) / torch.where(dz.abs() < 1e-9, torch.full_like(dz, 1e-9), dz)
    return torch.where((t > 0.1) & (dz < 0), t, torch.full_like(t, float("inf")))


def _boxes(o, d, lo, hi):
    """Nearest entry range of each ray over boxes ``lo``/``hi`` [K, 3]."""
    inv = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)   # [R, 3]
    t0 = (lo[None] - o[:, None]) * inv[:, None]                            # [R, K, 3]
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    tnear = torch.minimum(t0, t1).amax(dim=-1)
    tfar = torch.maximum(t0, t1).amin(dim=-1)
    hit = (tnear < tfar) & (tfar > 0) & (tnear > 0.1)
    return torch.where(hit, tnear, torch.full_like(tnear, float("inf"))).amin(dim=-1)


def _cylinders(o, d, poles):
    """Nearest hit range of each ray over vertical cylinders [K, 4]
    (cx, cy, r, h)."""
    ox = o[:, 0:1] - poles[None, :, 0]
    oy = o[:, 1:2] - poles[None, :, 1]
    dx, dy = d[:, 0:1], d[:, 1:2]
    a = dx * dx + dy * dy
    b = 2 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - poles[None, :, 2] * poles[None, :, 2]
    disc = b * b - 4 * a * c
    a_safe = torch.where(a < 1e-12, torch.full_like(a, 1e-12), a)
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a_safe)
    z = o[:, 2:3] + t * d[:, 2:3]
    hit = (disc > 0) & (t > 0.1) & (z >= 0) & (z <= poles[None, :, 3])
    return torch.where(hit, t, torch.full_like(t, float("inf"))).amin(dim=-1)


class TorchWorld:
    """The primitives of an :class:`HDL64World` as tensors on ``device``."""

    def __init__(self, world: HDL64World, device):
        self.world = world
        self.device = torch.device(device)
        as_t = lambda rows: torch.as_tensor(np.array(rows, np.float64), device=self.device)
        self.lo = as_t([b.lo for b in world.boxes]) if world.boxes else None
        self.hi = as_t([b.hi for b in world.boxes]) if world.boxes else None
        self.centers = np.array([b.center()[:2] for b in world.boxes]).reshape(-1, 2)
        self.radii = np.array([b.radius() for b in world.boxes])
        self.poles = as_t(world.poles) if world.poles else None
        self.pole_xy = np.array([p[:2] for p in world.poles]).reshape(-1, 2)
        self.moving = world.moving

    def cast(self, origins: torch.Tensor, dirs: torch.Tensor, times: torch.Tensor,
             center: np.ndarray, reach: float) -> torch.Tensor:
        """Nearest-hit ranges of rays [R, 3] (``HDL64World.cast``). Boxes
        and poles farther than ``reach`` from ``center`` (the numpy copy's
        cull) are skipped: every hit on them lies beyond the sensor's range."""
        best = _ground(origins, dirs)
        if self.lo is not None:
            near = np.nonzero(np.linalg.norm(self.centers - center[:2], axis=1)
                              <= reach + self.radii)[0]
            for s in range(0, len(near), _PRIM_CHUNK):
                sel = torch.as_tensor(near[s:s + _PRIM_CHUNK], device=self.device)
                best = torch.minimum(best, _boxes(origins, dirs, self.lo[sel], self.hi[sel]))
        if self.poles is not None:
            near = np.nonzero(np.linalg.norm(self.pole_xy - center[:2], axis=1) <= reach)[0]
            for s in range(0, len(near), _PRIM_CHUNK):
                sel = torch.as_tensor(near[s:s + _PRIM_CHUNK], device=self.device)
                best = torch.minimum(best, _cylinders(origins, dirs, self.poles[sel]))
        for mb in self.moving:
            disp = torch.as_tensor(mb.velocity, dtype=_F64, device=self.device)[None] * times[:, None]
            lo = torch.as_tensor(mb.lo, dtype=_F64, device=self.device)[None]
            hi = torch.as_tensor(mb.hi, dtype=_F64, device=self.device)[None]
            best = torch.minimum(best, _boxes(origins - disp, dirs, lo, hi))
        return best


def scan_geometry(world: TorchWorld, route: RoutePose, t0s: Sequence[float], n_azimuth: int,
                  beams: np.ndarray = _BEAM_ELEVATIONS) -> Tuple[torch.Tensor, torch.Tensor,
                                                                  torch.Tensor]:
    """For scans starting at ``t0s``: (ranges [S, B*A] f64 with inf for a
    miss, sensor-frame unit directions [B*A, 3] f64, sweep fractions [A]),
    rays in the numpy copy's order (beam-major)."""
    dev = world.device
    n_beams = len(beams)
    tau = np.arange(n_azimuth) / n_azimuth
    az = 2 * np.pi * tau
    ce, se = np.cos(beams), np.sin(beams)
    ca, sa = np.cos(az), np.sin(az)
    d_sensor = np.stack([np.outer(ce, ca), np.outer(ce, sa),
                         np.broadcast_to(se[:, None], (n_beams, n_azimuth))], -1)
    d_sensor_t = torch.as_tensor(d_sensor, device=dev)                       # [B, A, 3]
    out = []
    for t0 in t0s:
        times = t0 + tau * SWEEP_PERIOD
        Rs, ps = route.poses(times)                                          # [A,3,3], [A,3]
        Rs_t = torch.as_tensor(Rs, device=dev)
        d_world = torch.einsum("ajk,bak->baj", Rs_t, d_sensor_t).reshape(-1, 3)
        o_world = torch.as_tensor(ps, device=dev)[None].expand(n_beams, -1, -1).reshape(-1, 3)
        t_flat = torch.as_tensor(times, device=dev)[None].expand(n_beams, -1).reshape(-1)
        center = ps.mean(0)
        reach = world.world.max_range + float(np.linalg.norm(ps - center, axis=1).max())
        out.append(world.cast(o_world, d_world, t_flat, center, reach))
    return torch.stack(out), d_sensor_t.reshape(-1, 3), torch.as_tensor(tau, device=dev)


def generate(world: HDL64World, route: RoutePose, n_scans: int, n_azimuth: int,
             seed: int, device, first_scan: int = 0,
             batch: int = 8) -> Tuple[List[Dict], List[Tuple[np.ndarray, np.ndarray]]]:
    """Scans ``first_scan ..`` of the sequence (scan i starts at i x 0.1 s),
    with range noise and dropout drawn on ``device`` from ``seed``; returns
    (observations, ground-truth poses at each scan's start), on the host."""
    tw = TorchWorld(world, device)
    gen = torch.Generator(device=tw.device)
    gen.manual_seed(int(seed))
    obs, gt = [], []
    n_beams = len(_BEAM_ELEVATIONS)
    tau32 = np.broadcast_to((np.arange(n_azimuth) / n_azimuth)[None],
                            (n_beams, n_azimuth)).reshape(-1).astype(np.float32)
    for s in range(first_scan, first_scan + n_scans, batch):
        idx = list(range(s, min(s + batch, first_scan + n_scans)))
        t0s = [i * SWEEP_PERIOD for i in idx]
        rng_hit, d_sensor, _ = scan_geometry(tw, route, t0s, n_azimuth)
        drop = torch.rand(rng_hit.shape, generator=gen, device=tw.device, dtype=_F64)
        noise = torch.randn(rng_hit.shape, generator=gen, device=tw.device, dtype=_F64)
        valid = (rng_hit < world.max_range) & (drop > world.dropout)
        rng_noisy = torch.where(valid, rng_hit, torch.zeros_like(rng_hit)) + world.range_noise * noise
        p_local = d_sensor[None] * rng_noisy[..., None]
        p_local = torch.where(valid[..., None], p_local, torch.zeros_like(p_local)).to(torch.float32)
        xyz = p_local.cpu().numpy()
        vf = valid.to(torch.float32).cpu().numpy()
        for j, i in enumerate(idx):
            obs.append({"xyz": xyz[j], "valid": vf[j], "time": tau32,
                        "timestamp": float(t0s[j]), "sensor_label": "lidar"})
            R0, p0 = route(t0s[j])
            gt.append((R0, p0))
    return obs, gt
