"""SE(3) Lie-group core on tensors (port of ``mola_fe_lidar_tpu/geometry/
se3.py``).

A pose is ``Pose(R: f32[...,3,3], t: f32[...,3])``; every function
broadcasts over leading batch dims. Tangent convention ``tau = [v, w]``
(translation first). The small-angle and near-pi branches keep the
reference's f32 cutoffs; both branches are computed on sanitized inputs
and selected with ``torch.where``, as in the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_EPS = 1e-8


class Pose(NamedTuple):
    """Rigid transform: ``x_world = R @ x_local + t``."""

    R: torch.Tensor  # f32[..., 3, 3]
    t: torch.Tensor  # f32[..., 3]


def identity(batch_shape=(), dtype=torch.float32, device="cuda") -> Pose:
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3).clone()
    return Pose(R, torch.zeros((*batch_shape, 3), dtype=dtype, device=device))


def from_xyz_ypr(x, y, z, yaw, pitch, roll, dtype=torch.float32, device="cuda") -> Pose:
    """MRPT CPose3D convention: R = Rz(yaw) Ry(pitch) Rx(roll)."""
    x, y, z, yaw, pitch, roll = (torch.as_tensor(v, dtype=dtype, device=device)
                                 for v in (x, y, z, yaw, pitch, roll))
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    R = torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        torch.stack([-sp, cp * sr, cp * cr], -1),
    ], dim=-2)
    return Pose(R, torch.stack([x, y, z], dim=-1))


def from_matrix(T, dtype=torch.float32, device="cuda") -> Pose:
    """A homogeneous ``[..., 4, 4]`` transform as a Pose."""
    T = torch.as_tensor(T, dtype=dtype, device=device)
    return Pose(T[..., :3, :3], T[..., :3, 3])


def to_matrix(p: Pose) -> torch.Tensor:
    """The homogeneous ``[..., 4, 4]`` transform of a Pose."""
    T = torch.zeros((*p.t.shape[:-1], 4, 4), dtype=p.t.dtype, device=p.t.device)
    T[..., :3, :3] = p.R
    T[..., :3, 3] = p.t
    T[..., 3, 3] = 1.0
    return T


def to_xyz_ypr(p: Pose):
    """Inverse of :func:`from_xyz_ypr` (gimbal-lock tolerant)."""
    R = p.R
    pitch = -torch.arcsin(torch.clamp(R[..., 2, 0], -1.0, 1.0))
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return p.t[..., 0], p.t[..., 1], p.t[..., 2], yaw, pitch, roll


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: w[...,3] -> skew-symmetric [...,3,3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta_sq: torch.Tensor):
    """(A, B, C) = (sinθ/θ, (1-cosθ)/θ², (θ-sinθ)/θ³); Taylor below
    θ² < 1e-5, where 1 - cos θ would lose all f32 digits."""
    small = theta_sq < 1e-5
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    A_exact = torch.sin(theta) / theta
    B_exact = (1.0 - torch.cos(theta)) / safe_sq
    C_exact = (theta - torch.sin(theta)) / (safe_sq * theta)
    A = torch.where(small, 1.0 - theta_sq / 6.0, A_exact)
    B = torch.where(small, 0.5 - theta_sq / 24.0, B_exact)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, C_exact)
    return A, B, C


def so3_exp(w, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Rodrigues: so(3) tangent [...,3] -> rotation matrix [...,3,3]."""
    w = torch.as_tensor(w, dtype=dtype, device=device)
    A, B, _ = _sinc_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> so(3) tangent; handles θ near 0 and near π."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    sin_theta = torch.sin(theta)
    small = theta < 1e-3
    near_pi = theta > math.pi - 1e-3
    one = torch.ones_like(theta)
    safe_sin = torch.where(small | near_pi, one, sin_theta)
    skew = vee(R - R.transpose(-1, -2))
    w_generic = (theta / (2.0 * safe_sin))[..., None] * skew
    w_small = 0.5 * skew * (1.0 + theta[..., None] ** 2 / 6.0)
    # near π: axis from the symmetric part, aaᵀ = I + (Rsym - I)/(1-cosθ)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    Rsym = (R + R.transpose(-1, -2)) * 0.5
    one_minus_cos = torch.where(near_pi, 1.0 - cos_theta, one)
    aa = eye + (Rsym - eye) / one_minus_cos[..., None, None]
    diag = torch.stack([aa[..., 0, 0], aa[..., 1, 1], aa[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(aa, -1, k[..., None, None].expand(*aa.shape[:-1], 1))[..., 0]
    a_k = torch.sqrt(torch.clamp(torch.gather(diag, -1, k[..., None]), min=_EPS))
    axis = col / a_k
    norm = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    axis_unit = axis / torch.where(norm < _EPS, torch.ones_like(norm), norm)
    w_pi = axis_unit * theta[..., None]
    w = torch.where(small[..., None], w_small, w_generic)
    return torch.where(near_pi[..., None], w_pi, w)


def exp(tau: torch.Tensor) -> Pose:
    """se(3) exp map: tau[...,6] = [v, w] -> Pose."""
    v, w = tau[..., :3], tau[..., 3:]
    theta_sq = torch.sum(w * w, dim=-1)
    A, B, C = _sinc_coeffs(theta_sq)
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=tau.dtype, device=tau.device)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    return Pose(R, (V @ v[..., None])[..., 0])


def log(pose: Pose) -> torch.Tensor:
    """se(3) log map: Pose -> tau[...,6] = [v, w]."""
    w = so3_log(pose.R)
    theta_sq = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    W = hat(w)
    W2 = W @ W
    small = theta_sq < 1e-5
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    coef = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                       (1.0 - A / (2.0 * B)) / safe_sq)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    Vinv = eye - 0.5 * W + coef[..., None, None] * W2
    return torch.cat([(Vinv @ pose.t[..., None])[..., 0], w], dim=-1)


def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b: apply b first, then a."""
    return Pose(a.R @ b.R, (a.R @ b.t[..., None])[..., 0] + a.t)


def inverse(p: Pose) -> Pose:
    Rt = p.R.transpose(-1, -2)
    return Pose(Rt, -(Rt @ p.t[..., None])[..., 0])


def relative_to(a: Pose, b: Pose) -> Pose:
    """Pose of ``a`` expressed in frame ``b``: b⁻¹ ∘ a (CPose3D ``a - b``)."""
    return compose(inverse(b), a)


def transform(p: Pose, pts: torch.Tensor) -> torch.Tensor:
    """Apply a pose to points [..., N, 3]."""
    return pts @ p.R.transpose(-1, -2) + p.t[..., None, :]


def rotation_log(p: Pose) -> torch.Tensor:
    """so(3) log of the rotation part."""
    return so3_log(p.R)


def rotation_angle(p: Pose) -> torch.Tensor:
    return torch.linalg.vector_norm(so3_log(p.R), dim=-1)


def translation_norm(p: Pose) -> torch.Tensor:
    """‖t‖ (CPose3D::norm())."""
    return torch.linalg.vector_norm(p.t, dim=-1)
