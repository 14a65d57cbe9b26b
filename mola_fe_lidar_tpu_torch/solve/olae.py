"""OLAE, the optimal linear attitude estimator (port of
``mola_fe_lidar_tpu/solve/olae.py``): the ``Solver_OLAE`` of mp2p_icp.

For centred weighted pairings a_i -> b_i, the Cayley-Gibbs-Rodrigues
vector g of R = (I - [g]x)^-1 (I + [g]x) satisfies d_i = g x s_i with
s = a + b and d = b - a exactly, so the attitude is one 3x3 weighted least-
squares solve; translation follows from the weighted centroids. The solves
are ``torch.linalg.solve_ex``, which does not read its status back to the
host.
"""

from __future__ import annotations

import torch

from ..geometry import se3


def weighted_olae(src_pts: torch.Tensor, tgt_pts: torch.Tensor, w: torch.Tensor) -> se3.Pose:
    """The pose of the linear CGR solve (same contract as
    :func:`solve.horn.weighted_horn`: ``[..., N, 3]`` pairings, ``[..., N]``
    weights, identity on ~0 total weight)."""
    tot = torch.sum(w, dim=-1, keepdim=True)
    safe_tot = torch.clamp(tot, min=1e-9)
    mu_s = torch.sum(src_pts * w[..., None], dim=-2) / safe_tot
    mu_t = torch.sum(tgt_pts * w[..., None], dim=-2) / safe_tot
    a = src_pts - mu_s[..., None, :]
    b = tgt_pts - mu_t[..., None, :]
    s = a + b
    d = b - a
    # M = Σ w (|s|² I - s sᵀ), v = Σ w (s x d); a tiny Tikhonov term keeps
    # rank-deficient pairings (collinear points) finite
    ws = w[..., None]
    nrm = torch.sum(torch.sum(s * s * ws, dim=-2), dim=-1)
    outer = (s * ws).transpose(-1, -2) @ s
    eye = torch.eye(3, dtype=src_pts.dtype, device=src_pts.device)
    M = nrm[..., None, None] * eye - outer
    v = torch.sum(torch.linalg.cross(s, d, dim=-1) * ws, dim=-2)
    g = torch.linalg.solve_ex(M + 1e-9 * eye, v[..., None]).result[..., 0]
    G = se3.hat(g)
    R = torch.linalg.solve_ex(eye - G, eye + G).result
    t = mu_t - (R @ mu_s[..., None])[..., 0]
    degenerate = tot[..., 0] < 1e-6
    R = torch.where(degenerate[..., None, None], eye, R)
    t = torch.where(degenerate[..., None], torch.zeros_like(t), t)
    return se3.Pose(R, t)
