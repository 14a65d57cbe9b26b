"""Synthetic scan pairs for pairwise registration: a copy of the world and
pair generators of the reference repository's ``bench.py`` (``make_world``,
``make_pairs``, its ``_cpu_se3_exp`` and ``_stack_pairs``), held equal to
them by ``tests/test_torch_copies.py``, plus the batched maps and pose
errors the port's checks use.

A world is a ground patch and two walls of ``n`` uniform random points; a
pair is a world and a random twist ``tau``: the source is the world moved
by ``exp(-tau)``, so ``exp(tau)`` aligns source onto target.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cloud.metric_map import MetricMap, from_points
from ..geometry import se3


def make_world(rng, n, extent=30.0):
    g = np.stack([rng.uniform(-extent, extent, n // 2),
                  rng.uniform(-extent, extent, n // 2),
                  rng.normal(0, 0.02, n // 2)], -1)
    w1 = np.stack([rng.uniform(-extent, extent, n // 4),
                   np.full(n // 4, extent),
                   rng.uniform(0, 6, n // 4)], -1)
    w2 = np.stack([np.full(n // 4, -extent),
                   rng.uniform(-extent, extent, n // 4),
                   rng.uniform(0, 6, n // 4)], -1)
    return np.concatenate([g, w1, w2]).astype(np.float32)


def make_pairs(rng, b, cap, tau_sigma=0.08):
    return [(make_world(rng, cap), rng.normal(0, tau_sigma, 6).astype(np.float32))
            for _ in range(b)]


def _cpu_se3_exp(tau):
    v, w = tau[:3], tau[3:]
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-8:
        R = np.eye(3) + W
        V = np.eye(3) + 0.5 * W
    else:
        A, Bc, C = np.sin(th) / th, (1 - np.cos(th)) / th**2, (th - np.sin(th)) / th**3
        R = np.eye(3) + A * W + Bc * W @ W
        V = np.eye(3) + Bc * W + C * W @ W
    return R, V @ v


def pair_clouds(pairs):
    """(source points, target points, taus) of each pair, numpy f32. A
    pair's world may be a (source world, target world) tuple, so that the
    target can hold outliers the source lacks."""
    srcs, tgts, taus = [], [], []
    for world, tau in pairs:
        src_world, tgt_world = world if isinstance(world, tuple) else (world, world)
        R0, t0 = _cpu_se3_exp(-tau)
        srcs.append((src_world @ R0.T + t0).astype(np.float32))
        tgts.append(np.asarray(tgt_world, np.float32))
        taus.append(tau)
    return srcs, tgts, taus


def stack_pairs(pairs, cap: int, layer: str = "raw", device="cuda"):
    """The pairs as lane-stacked maps ``{layer: [B, cap, 3]}`` (source,
    target) on ``device``, and their taus."""
    srcs, tgts, taus = pair_clouds(pairs)

    def stack(clouds) -> MetricMap:
        pcs = [from_points(c, capacity=cap, device=device) for c in clouds]
        return {layer: type(pcs[0])(torch.stack([p.xyz for p in pcs]),
                                    torch.stack([p.mask for p in pcs]), {})}

    return stack(srcs), stack(tgts), taus


def pose_errors(pose: se3.Pose, taus) -> np.ndarray:
    """Translation error (m) of each lane of ``pose`` against exp(tau)."""
    R = pose.R.detach().cpu().numpy().astype(np.float64)
    t = pose.t.detach().cpu().numpy().astype(np.float64)
    errs = []
    for i, tau in enumerate(taus):
        Rt, tt = _cpu_se3_exp(np.asarray(tau, np.float64))
        # translation of pose ∘ true⁻¹
        errs.append(float(np.linalg.norm(t[i] - R[i] @ Rt.T @ tt)))
    return np.asarray(errs)
