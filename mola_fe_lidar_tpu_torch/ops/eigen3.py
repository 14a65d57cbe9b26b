"""Closed-form symmetric 3x3 eigen-decomposition, batched (port of
``mola_fe_lidar_tpu/ops/eigen3.py``, the parts on the main path).

Eigenvalues by the trigonometric method; eigenvectors from the column space
of ``(A - λi I)(A - λj I)``, largest column for conditioning.
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
