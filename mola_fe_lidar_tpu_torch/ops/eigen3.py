"""Closed-form 3x3 linear algebra, batched (port of
``mola_fe_lidar_tpu/ops/eigen3.py``).

Symmetric eigenvalues by the trigonometric method; eigenvectors from the
column space of ``(A - λi I)(A - λj I)``, largest column for conditioning;
the planarity score of the normal filters; the closed-form Cholesky factor
and lower-triangular inverse of the GICP matcher. Element-wise tensor ops
only: nothing here waits for the device.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def sym_eigenvalues_3x3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [..., 3, 3] matrices, ascending [..., 3]."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p_sq = (b00 * b00 + b11 * b11 + b22 * b22
            + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = torch.sqrt(torch.clamp(p_sq, min=_EPS))
    det_b = (b00 * (b11 * b22 - a12 * a12)
             - a01 * (a01 * b22 - a12 * a02)
             + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(det_b / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e2 = q + 2.0 * p * torch.cos(phi)
    e0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e1 = 3.0 * q - e0 - e2
    return torch.stack([e0, e1, e2], dim=-1)


def _best_column(B: torch.Tensor):
    norms = torch.sum(B * B, dim=-2)
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(B, -1, best[..., None, None].expand(*B.shape[:-1], 1))[..., 0]
    return v, torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def smallest_eigenvector_3x3(A: torch.Tensor, eigenvalues=None,
                             return_valid: bool = False):
    """Unit eigenvector of the smallest eigenvalue; +z where the extraction
    matrix vanishes relative to λ2² (``return_valid`` flags those rows)."""
    if eigenvalues is None:
        eigenvalues = sym_eigenvalues_3x3(A)
    e1, e2 = eigenvalues[..., 1], eigenvalues[..., 2]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    v, n = _best_column((A - e1[..., None, None] * eye) @ (A - e2[..., None, None] * eye))
    ok = n[..., 0] > torch.clamp(1e-5 * e2 * e2, min=1e-9)
    fallback = eye[2].expand_as(v)  # +z, made on the device (no host copy)
    v = torch.where(ok[..., None], v / torch.where(ok[..., None], n, torch.ones_like(n)), fallback)
    return (v, ok) if return_valid else v


def largest_eigenvector_3x3(A: torch.Tensor, eigenvalues=None) -> torch.Tensor:
    """Unit eigenvector of the largest eigenvalue (line direction); +x
    where the extraction matrix vanishes."""
    if eigenvalues is None:
        eigenvalues = sym_eigenvalues_3x3(A)
    e0, e1 = eigenvalues[..., 0], eigenvalues[..., 1]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    v, n = _best_column((A - e0[..., None, None] * eye) @ (A - e1[..., None, None] * eye))
    ok = n[..., 0] > 1e-9
    fallback = eye[0].expand_as(v)  # +x
    return torch.where(ok[..., None], v / torch.where(ok[..., None], n, torch.ones_like(n)), fallback)


def planarity_score_3x3(eigenvalues: torch.Tensor, rel_floor: float = 1e-3) -> torch.Tensor:
    """Planarity in [0, 1] from ascending eigenvalues: ``1 - λ0/λ1``, gated
    to 0 for line-like spectra (λ1 ≤ rel_floor·λ2), whose λ0/λ1 ratio is
    f32 noise."""
    e0, e1, e2 = eigenvalues[..., 0], eigenvalues[..., 1], eigenvalues[..., 2]
    score = torch.clamp(1.0 - e0 / torch.clamp(e1, min=1e-9), 0.0, 1.0)
    return score * (e1 > rel_floor * torch.clamp(e2, min=_EPS)).to(score.dtype)


def cholesky_3x3(A: torch.Tensor, jitter: float = 1e-9) -> torch.Tensor:
    """Closed-form lower Cholesky factor of SPD [..., 3, 3] (pivots floored
    at ``jitter``)."""
    l00 = torch.sqrt(torch.clamp(A[..., 0, 0], min=jitter))
    l10 = A[..., 1, 0] / l00
    l20 = A[..., 2, 0] / l00
    l11 = torch.sqrt(torch.clamp(A[..., 1, 1] - l10 * l10, min=jitter))
    l21 = (A[..., 2, 1] - l20 * l10) / l11
    l22 = torch.sqrt(torch.clamp(A[..., 2, 2] - l20 * l20 - l21 * l21, min=jitter))
    zero = torch.zeros_like(l00)
    return torch.stack([torch.stack([l00, zero, zero], dim=-1),
                        torch.stack([l10, l11, zero], dim=-1),
                        torch.stack([l20, l21, l22], dim=-1)], dim=-2)


def invert_lower_3x3(L: torch.Tensor) -> torch.Tensor:
    """Inverse of lower-triangular [..., 3, 3] (closed form)."""
    l11 = L[..., 1, 1]
    i00 = 1.0 / L[..., 0, 0]
    i11 = 1.0 / l11
    i22 = 1.0 / L[..., 2, 2]
    i10 = -L[..., 1, 0] * i00 * i11
    i20 = (L[..., 1, 0] * L[..., 2, 1] - L[..., 2, 0] * l11) * i00 * i11 * i22
    i21 = -L[..., 2, 1] * i11 * i22
    zero = torch.zeros_like(i00)
    return torch.stack([torch.stack([i00, zero, zero], dim=-1),
                        torch.stack([i10, i11, zero], dim=-1),
                        torch.stack([i20, i21, i22], dim=-1)], dim=-2)


def neighbourhood_covariance(neigh: torch.Tensor, valid: torch.Tensor):
    """(count, centroid, covariance) of kNN neighbourhoods ``neigh [..., k,
    3]`` over the rows where ``valid [..., k]`` is 1; count floored at 1.

    The f32 operations are the reference's, in its order: the centroid
    summed over k in sequence, the covariance accumulated as one fused
    multiply-add per neighbour (XLA's CPU dot; emulated by adding the exact
    product in f64 and rounding to f32 at each step). The order matters:
    on a line-like neighbourhood (λ0 ≈ λ1 ≪ λ2) the trigonometric
    eigenvalues sit where ``acos`` is steep, and one ulp of the covariance
    moves λ0 and λ1, and so the normal, by far more than round-off.
    """
    cnt = torch.clamp(torch.sum(valid, dim=-1), min=1.0)
    weighted = neigh * valid[..., None]
    total = weighted[..., 0, :]
    for j in range(1, neigh.shape[-2]):
        total = total + weighted[..., j, :]
    centroid = total / cnt[..., None]
    d = ((neigh - centroid[..., None, :]) * valid[..., None]).to(torch.float64)
    outer = d[..., :, :, None] * d[..., :, None, :]  # exact in f64
    acc = outer[..., 0, :, :].to(neigh.dtype)
    for j in range(1, neigh.shape[-2]):
        acc = (acc.to(torch.float64) + outer[..., j, :, :]).to(neigh.dtype)
    return cnt, centroid, acc / cnt[..., None, None]
