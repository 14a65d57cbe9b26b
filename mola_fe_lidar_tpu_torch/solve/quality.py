"""Quality evaluators (port of ``mola_fe_lidar_tpu/solve/quality.py``)."""

from __future__ import annotations

import torch


def paired_ratio(nn_dist: torch.Tensor, src_mask: torch.Tensor,
                 threshold_distance: float = 0.10) -> torch.Tensor:
    """Fraction of valid source points whose nearest neighbour lies within
    ``threshold_distance`` -- the keyframe and loop-closure goodness."""
    paired = (nn_dist < threshold_distance).to(nn_dist.dtype) * src_mask
    n = torch.clamp(torch.sum(src_mask, dim=-1), min=1.0)
    return torch.sum(paired, dim=-1) / n
