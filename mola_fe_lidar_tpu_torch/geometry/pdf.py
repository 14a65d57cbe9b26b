"""Gaussian pose PDFs on tensors (port of
``mola_fe_lidar_tpu/geometry/pdf.py``): a :class:`~.se3.Pose` mean and a
covariance over the se(3) tangent ``[v, w]`` at the mean.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3


class PosePDF(NamedTuple):
    mean: se3.Pose
    cov: torch.Tensor  # f32[..., 6, 6] over tangent [v, w]


def pdf_from_pose(pose: se3.Pose, sigma_xyz: float = 0.0, sigma_rot: float = 0.0) -> PosePDF:
    """Diagonal-covariance PDF, e.g. the fixed factor noise of 0.10 m / 1°."""
    diag = torch.tensor([sigma_xyz ** 2] * 3 + [sigma_rot ** 2] * 3,
                        dtype=pose.t.dtype, device=pose.t.device)
    return PosePDF(pose, torch.diag(diag).expand(*pose.t.shape[:-1], 6, 6))
