"""Constant-velocity motion model on tensors (port of
``mola_fe_lidar_tpu/geometry/twist.py``): a twist is the se(3) tangent
velocity ``[vx, vy, vz, wx, wy, wz]`` (units 1/s), propagated in full,
angular part included.
"""

from __future__ import annotations

import torch

from . import se3

Twist = torch.Tensor


def twist_zero(dtype=torch.float32, device="cuda") -> Twist:
    return torch.zeros((6,), dtype=dtype, device=device)


def twist_from_delta(rel_pose: se3.Pose, dt) -> Twist:
    """The twist of an SE(3) increment over ``dt`` seconds (the full log
    map); zero for ``dt <= 0``."""
    dt = torch.as_tensor(dt, dtype=rel_pose.t.dtype, device=rel_pose.t.device)
    safe_dt = torch.where(dt <= 0, torch.ones_like(dt), dt)
    tau = se3.log(rel_pose) / safe_dt
    return torch.where(dt <= 0, torch.zeros_like(tau), tau)


def propagate_pose(twist: Twist, dt) -> se3.Pose:
    """Predicted relative motion over ``dt``: exp(dt · twist)."""
    return se3.exp(twist * torch.as_tensor(dt, dtype=twist.dtype, device=twist.device))
