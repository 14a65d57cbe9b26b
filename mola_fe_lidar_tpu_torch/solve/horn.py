"""Weighted closed-form rigid alignment, Horn/Kabsch by SVD (port of
``mola_fe_lidar_tpu/solve/horn.py``).

The 3x3 SVD of the cross-covariance is one-sided Jacobi in float64 with a
fixed number of sweeps, in tensor ops: ``torch.linalg.svd`` on a CUDA
tensor reads its convergence flags back to the host, and the align loop
must not wait for the device inside a block. The rotation does not depend
on the signs or order the SVD picks for its vectors, so it agrees with the
reference's LAPACK SVD to f32 round-off wherever it is unique (rank ≥ 2).
"""

from __future__ import annotations

import torch

from ..geometry import se3

_SWEEPS = 6  # cyclic Jacobi sweeps: 3x3 converges in f64 within 4


def _givens(c: torch.Tensor, s: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """[..., 3, 3] rotation of columns p, q: col_p <- c col_p - s col_q,
    col_q <- s col_p + c col_q (right-multiplied)."""
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    e = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]
    e[p][p], e[q][q], e[p][q], e[q][p] = c, c, s, -s
    return torch.stack([torch.stack(row, dim=-1) for row in e], dim=-2)


def rotation_from_cross_covariance(H: torch.Tensor) -> torch.Tensor:
    """The proper rotation R = V diag(1, 1, det(V Uᵀ)) Uᵀ for H = U S Vᵀ
    (singular values descending), [..., 3, 3] in H's dtype."""
    # W = H V with orthogonal columns after the sweeps; rows 3..5 carry V
    M = torch.cat([H.to(torch.float64),
                   torch.eye(3, dtype=torch.float64, device=H.device).expand(H.shape)], dim=-2)
    for _ in range(_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            W = M[..., :3, :]
            a = torch.sum(W[..., p] * W[..., p], dim=-1)
            b = torch.sum(W[..., q] * W[..., q], dim=-1)
            g = torch.sum(W[..., p] * W[..., q], dim=-1)
            skip = g == 0.0
            zeta = (b - a) / (2.0 * torch.where(skip, torch.ones_like(g), g))
            sign = torch.where(zeta >= 0.0, torch.ones_like(zeta), -torch.ones_like(zeta))
            t = torch.where(skip, torch.zeros_like(g),
                            sign / (torch.abs(zeta) + torch.sqrt(1.0 + zeta * zeta)))
            c = torch.rsqrt(1.0 + t * t)
            M = M @ _givens(c, c * t, p, q)
    W, V = M[..., :3, :], M[..., 3:, :]
    s = torch.linalg.vector_norm(W, dim=-2)
    order = torch.argsort(s, dim=-1, descending=True)
    cols = order[..., None, :].expand(W.shape)
    W, V = torch.gather(W, -1, cols), torch.gather(V, -1, cols)
    s = torch.gather(s, -1, order)
    eye = torch.eye(3, dtype=W.dtype, device=W.device)
    tiny = 1e-12 * torch.clamp(s[..., :1], min=1e-300)
    u1 = torch.where(s[..., :1] > 0.0, W[..., 0] / torch.clamp(s[..., :1], min=1e-300),
                     eye[0].expand(W.shape[:-1]))
    w2 = W[..., 1] - torch.sum(W[..., 1] * u1, dim=-1, keepdim=True) * u1
    n2 = torch.linalg.vector_norm(w2, dim=-1, keepdim=True)
    # rank 1: any unit vector orthogonal to u1 (the rotation is not unique)
    axis = torch.where(torch.abs(u1[..., :1]) < 0.9, eye[0].expand(u1.shape), eye[1].expand(u1.shape))
    perp = torch.linalg.cross(u1, axis, dim=-1)
    perp = perp / torch.linalg.vector_norm(perp, dim=-1, keepdim=True)
    u2 = torch.where(n2 > tiny, w2 / torch.clamp(n2, min=1e-300), perp)
    u3 = torch.linalg.cross(u1, u2, dim=-1)  # det U = +1, so D = diag(1, 1, det V)
    d = torch.sum(V[..., :, 0] * torch.linalg.cross(V[..., :, 1], V[..., :, 2], dim=-1), dim=-1)
    R = (V[..., :, 0, None] * u1[..., None, :] + V[..., :, 1, None] * u2[..., None, :]
         + (d[..., None, None] * V[..., :, 2, None]) * u3[..., None, :])
    return R.to(H.dtype)


def weighted_horn(src_pts: torch.Tensor, tgt_pts: torch.Tensor, w: torch.Tensor) -> se3.Pose:
    """The pose minimising Σ w ‖R p + t − q‖² (``src_pts``/``tgt_pts``
    ``[..., N, 3]``, ``w [..., N]``, zeros drop pairings); identity when
    the total weight is ~0."""
    tot = torch.sum(w, dim=-1, keepdim=True)
    safe_tot = torch.clamp(tot, min=1e-9)
    mu_s = torch.sum(src_pts * w[..., None], dim=-2) / safe_tot
    mu_t = torch.sum(tgt_pts * w[..., None], dim=-2) / safe_tot
    ps = src_pts - mu_s[..., None, :]
    qs = tgt_pts - mu_t[..., None, :]
    H = (ps * w[..., None]).transpose(-1, -2) @ qs
    R = rotation_from_cross_covariance(H)
    t = mu_t - (R @ mu_s[..., None])[..., 0]
    degenerate = tot[..., 0] < 1e-6
    R = torch.where(degenerate[..., None, None], torch.eye(3, dtype=R.dtype, device=R.device), R)
    t = torch.where(degenerate[..., None], torch.zeros_like(t), t)
    return se3.Pose(R, t)


def point_to_point_normal_matrix(src_pts: torch.Tensor, pose: se3.Pose,
                                 w: torch.Tensor) -> torch.Tensor:
    """Gauss-Newton normal matrix A = Σ w JᵀJ [..., 6, 6] of point-to-point
    residuals R p + t − q, J = [I | −[R p]ₓ] (tangent [δt, δw])."""
    X = se3.hat(se3.transform(pose, src_pts))
    wsum = torch.sum(w, dim=-1)
    eye = torch.eye(3, dtype=src_pts.dtype, device=src_pts.device)
    A_tt = wsum[..., None, None] * eye
    A_tw = -torch.sum(w[..., None, None] * X, dim=-3)
    A_ww = torch.einsum("...nij,...nik->...jk", X * w[..., None, None], X)
    top = torch.cat([A_tt, A_tw], dim=-1)
    bot = torch.cat([A_tw.transpose(-1, -2), A_ww], dim=-1)
    return torch.cat([top, bot], dim=-2)
