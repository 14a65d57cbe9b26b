"""Point-to-plane Gauss-Newton solver (port of
``mola_fe_lidar_tpu/solve/gauss_newton.py``).

Residual per pairing r_i = n_iᵀ (R p_i + t − q_i); Jacobian in the tangent
δ = [δt, δw] at the current pose J_i = [nᵀ, ((R p_i) × n_i)ᵀ]; normal
equations A δ = b with A = Σ w J Jᵀ, b = −Σ w J r; a left-multiplied exp
update. The inner loop re-linearizes at fixed correspondences. Every
function takes leading batch dimensions (one system per lane of a batched
align, ``models/icp.py``); the prior weights are shared. The 6x6
solves use ``torch.linalg.solve_ex`` / ``inv_ex``, which do not wait for
the device to report singularity, so the inner loop never stalls the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import se3


class GNResult(NamedTuple):
    pose: se3.Pose
    normal_matrix: torch.Tensor    # f32[6, 6] (A at the final pose)
    sq_residual_sum: torch.Tensor  # f32[]
    weight_sum: torch.Tensor       # f32[]


def _scaled_eye(A: torch.Tensor, scale: float) -> torch.Tensor:
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return scale * eye * torch.clamp(diag.amax(dim=-1), min=1.0)[..., None, None]


def solve_normal_equations(A: torch.Tensor, b: torch.Tensor,
                           damping: float = 1e-6) -> torch.Tensor:
    """Solve (A + λ·max(max diag A, 1)·I) δ = b (uniform damping keeps
    rank-deficient systems finite)."""
    return torch.linalg.solve_ex(A + _scaled_eye(A, damping), b[..., None]).result[..., 0]


def _build_system(pose, src_pts, tgt_pts, normals, w):
    rp = se3.transform(pose, src_pts)
    r = torch.sum((rp - tgt_pts) * normals, dim=-1)
    cross = torch.linalg.cross(rp, normals, dim=-1)
    J = torch.cat([normals, cross], dim=-1)
    Jw = J * w[..., None]
    A = Jw.transpose(-1, -2) @ J
    b = -(Jw.transpose(-1, -2) @ r[..., None])[..., 0]
    sse = torch.sum(w * r * r, dim=-1)
    return A, b, sse


def point_to_plane_step(pose: se3.Pose, src_pts, tgt_pts, normals, w,
                        inner_iterations: int = 20, damping: float = 1e-6,
                        prior_pose: Optional[se3.Pose] = None,
                        prior_w: Optional[torch.Tensor] = None) -> GNResult:
    """GN inner loop at fixed correspondences, with an optional weak MAP
    prior toward ``prior_pose`` (A += diag(wᵖ), b += wᵖ·log(prior ∘ p⁻¹))."""
    for _ in range(inner_iterations):
        A, b, _ = _build_system(pose, src_pts, tgt_pts, normals, w)
        if prior_pose is not None:
            e = se3.log(se3.compose(prior_pose, se3.inverse(pose)))
            A = A + torch.diag(prior_w).to(A.dtype)
            b = b + prior_w * e
        delta = solve_normal_equations(A, b, damping)
        pose = se3.compose(se3.exp(delta), pose)
    A, _, sse = _build_system(pose, src_pts, tgt_pts, normals, w)
    return GNResult(pose, A, sse, torch.sum(w, dim=-1))


def covariance_from_normal_matrix(A, sse, weight_sum) -> torch.Tensor:
    """cov ≈ σ² A⁻¹ with σ² = SSE / max(n_eff − 6, 1)."""
    sigma2 = sse / torch.clamp(weight_sum - 6.0, min=1.0)
    return sigma2[..., None, None] * torch.linalg.inv_ex(A + _scaled_eye(A, 1e-9)).inverse
