"""Pairing re-weighting (port of ``mola_fe_lidar_tpu/solve/robust.py``):
IRLS weights of the robust kernels and the scale-consistency outlier gate,
the ``pairingsWeightParameters`` of the reference's ICP settings.

All functions keep shapes fixed and take leading batch dimensions: a weight
of 0 drops a pairing.
"""

from __future__ import annotations

import torch


def _huber(r: torch.Tensor, c: float) -> torch.Tensor:
    a = torch.abs(r)
    return torch.where(a <= c, torch.ones_like(r), c / torch.clamp(a, min=1e-12))


def _cauchy(r: torch.Tensor, c: float) -> torch.Tensor:
    return 1.0 / (1.0 + (r / c) ** 2)


def _geman_mcclure(r: torch.Tensor, c: float) -> torch.Tensor:
    c2 = c * c
    return (c2 / (c2 + r * r)) ** 2


def _tukey(r: torch.Tensor, c: float) -> torch.Tensor:
    u = r / c
    return torch.where(torch.abs(u) <= 1.0, (1.0 - u * u) ** 2, torch.zeros_like(r))


def _welsch(r: torch.Tensor, c: float) -> torch.Tensor:
    return torch.exp(-((r / c) ** 2))


ROBUST_KERNELS = {
    "none": lambda r, c: torch.ones_like(r),
    "huber": _huber,
    "cauchy": _cauchy,
    "gemanmcclure": _geman_mcclure,
    "tukey": _tukey,
    "welsch": _welsch,
}


def robust_weights(residuals: torch.Tensor, kernel: str, param: float,
                   scale: float = 1.0) -> torch.Tensor:
    """IRLS weight ψ(r)/r of the named kernel at width ``param``; ``scale``
    pre-scales the residuals by √scale (for Cauchy: ``1 / (1 + scale·(r /
    param)²)``, the reference's ``robust_kernel_scale``)."""
    if kernel not in ROBUST_KERNELS:
        raise ValueError(f"unknown robust kernel {kernel!r}; have {sorted(ROBUST_KERNELS)}")
    r = residuals if scale == 1.0 else residuals * (scale ** 0.5)
    return ROBUST_KERNELS[kernel](r, param)


def scale_outlier_weights(src_pts: torch.Tensor, tgt_pts: torch.Tensor,
                          mask: torch.Tensor, threshold: float) -> torch.Tensor:
    """0/1 gate on pairings: a rigid motion keeps distances, so a source
    point's distance to the weighted source centroid must match its mate's
    distance to the target centroid. Pairings whose ratio ``max/min`` of
    the two exceeds ``threshold`` get weight 0; the others keep ``mask``."""
    w = mask[..., None]
    tot = torch.clamp(torch.sum(mask, dim=-1, keepdim=True), min=1.0)[..., None]
    mu_s = torch.sum(src_pts * w, dim=-2, keepdim=True) / tot
    mu_t = torch.sum(tgt_pts * w, dim=-2, keepdim=True) / tot
    ds = torch.linalg.vector_norm(src_pts - mu_s, dim=-1)
    dt = torch.linalg.vector_norm(tgt_pts - mu_t, dim=-1)
    ratio = torch.maximum(ds, dt) / torch.clamp(torch.minimum(ds, dt), min=1e-6)
    return torch.where(ratio <= threshold, mask, torch.zeros_like(mask))
