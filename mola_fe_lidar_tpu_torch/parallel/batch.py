"""Batched ICP alignment (port of ``mola_fe_lidar_tpu/parallel/batch.py``).

The reference ``vmap``s ``align`` over scan pairs and over loop-closure
Monte-Carlo guesses. Here a batch is ``models.icp.align`` with a leading
lane axis: every nearest-neighbour search of an iteration is one K1/K2
launch for all lanes, and each lane freezes once it has converged. Layers
given as one cloud are shared by every lane without a copy.

With a mesh (data parallelism), the lanes split into one contiguous slice
per position of the data axis, each slice one batched align on its
position, and the results come back to the lead position in lane order.
Each lane freezes on its own, so a lane's result does not depend on the
split.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..cloud.metric_map import MetricMap
from ..geometry import se3
from ..models.config import ICPParams
from ..models.icp import ICPResult, align
from .mesh import Mesh, gather_batch, run_per_position, shard_batch, tree_map


def data_parallel(mesh: Mesh, fn, src_maps: MetricMap, tgt_maps: MetricMap, *lane_args,
                  data_axis: str = "data"):
    """``fn(src_map, tgt_map, *lane_args)`` with the lanes split over the
    positions of ``data_axis``: layers ``[B,N,3]`` and the ``lane_args``
    (leading lane axis) one contiguous slice a position, layers ``[N,3]``
    whole to every position. The per-position results come back to the
    first position, concatenated in lane order."""
    def split(mm):
        return ({n: pc for n, pc in mm.items() if pc.xyz.dim() == 3},
                {n: pc for n, pc in mm.items() if pc.xyz.dim() != 3})

    (src, src_whole), (tgt, tgt_whole) = split(src_maps), split(tgt_maps)
    positions = mesh.axis_devices(data_axis)
    args = []
    for (s, t, *rest), dev in zip(shard_batch(mesh, (src, tgt, *lane_args), data_axis), positions):
        s1, t1 = tree_map(lambda x: x.to(dev), (src_whole, tgt_whole))
        args.append(({**s, **s1}, {**t, **t1}, *rest))
    return gather_batch(run_per_position(fn, args, positions), positions[0])


def make_batched_align(params: ICPParams, mesh: Optional[Mesh] = None,
                       data_axis: str = "data"):
    """A batched align over the lane axis: ``run(src_maps, tgt_maps,
    init_poses)`` aligns lane b of ``src_maps`` onto lane b of ``tgt_maps``
    from ``init_poses[b]``; layers ``[N,3]`` are shared, ``[B,N,3]`` per
    lane. With a mesh the lanes split over ``data_axis`` (the batch must
    divide by its size); ``run`` takes the whole batch or the
    per-position slices ``shard_batch`` made of each argument (lists),
    and returns the whole result on the lead position."""
    one = functools.partial(align, params=params)
    if mesh is None:
        return one

    def run(src_maps, tgt_maps, init_poses) -> ICPResult:
        if isinstance(src_maps, list):  # per-position slices from shard_batch
            positions = mesh.axis_devices(data_axis)
            parts = run_per_position(one, list(zip(src_maps, tgt_maps, init_poses)), positions)
            return gather_batch(parts, positions[0])
        return data_parallel(mesh, one, src_maps, tgt_maps, init_poses, data_axis=data_axis)

    return run


def batched_align(src_maps: MetricMap, tgt_maps: MetricMap, init_poses: se3.Pose,
                  params: ICPParams, mesh: Optional[object] = None) -> ICPResult:
    """One-shot convenience wrapper over :func:`make_batched_align`."""
    return make_batched_align(params, mesh)(src_maps, tgt_maps, init_poses)


def make_chunked_batched_align(params: ICPParams, chunk: int = 16):
    """Batched align over consecutive chunks of ``chunk`` lanes, so that a
    straggler holds up only its own chunk (the reference's ``lax.scan``
    over vmapped chunks). The batch must divide by ``chunk``."""

    def run(src_maps: MetricMap, tgt_maps: MetricMap, init_poses: se3.Pose) -> ICPResult:
        b = init_poses.t.shape[0]
        if b % chunk:
            raise ValueError(f"batch {b} not divisible by chunk {chunk}")

        def part(mm, lo):
            return {n: pc if pc.xyz.dim() == 2 else type(pc)(
                pc.xyz[lo:lo + chunk], pc.mask[lo:lo + chunk],
                {k: v[lo:lo + chunk] for k, v in pc.attrs.items()}) for n, pc in mm.items()}

        outs = [align(part(src_maps, lo), part(tgt_maps, lo),
                      se3.Pose(init_poses.R[lo:lo + chunk], init_poses.t[lo:lo + chunk]),
                      params)
                for lo in range(0, b, chunk)]
        cat = lambda xs: torch.cat(xs, dim=0)
        return ICPResult(se3.Pose(cat([o.pose.R for o in outs]), cat([o.pose.t for o in outs])),
                         *(cat([getattr(o, f) for o in outs])
                           for f in ("cov", "quality", "n_iterations", "term_reason")))

    return run


def monte_carlo_guesses(generator: torch.Generator, center: se3.Pose, n_samples: int,
                        sigma_xyz: float, sigma_rot: float,
                        full_rotation: bool = False) -> se3.Pose:
    """``n_samples`` Gaussian perturbations of ``center`` (the loop-closure
    Monte-Carlo guesses): translation noise of ``sigma_xyz`` on every axis
    and yaw noise of ``sigma_rot`` (all three rotation axes with
    ``full_rotation``), drawn from ``generator`` on the CPU. The reference
    draws from ``jax.random``, whose numbers torch cannot reproduce: tests
    inject the same guesses into both packages."""
    dxyz = sigma_xyz * torch.randn((n_samples, 3), generator=generator)
    if full_rotation:
        drot = sigma_rot * torch.randn((n_samples, 3), generator=generator)
    else:
        yaw = sigma_rot * torch.randn((n_samples, 1), generator=generator)
        drot = torch.cat([torch.zeros((n_samples, 2)), yaw], dim=-1)
    tau = torch.cat([dxyz, drot], dim=-1).to(center.t.device, center.t.dtype)
    perturb = se3.exp(tau)
    return se3.compose(perturb, se3.Pose(center.R.expand(n_samples, 3, 3),
                                         center.t.expand(n_samples, 3)))
