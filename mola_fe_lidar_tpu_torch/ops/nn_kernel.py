"""K2: exact 1-NN on the card -- the port of the Pallas kernel
``mola_fe_lidar_tpu/ops/pallas_nn.py::_nn_kernel`` (wrapper
``pallas_nearest_neighbors``).

``nearest_neighbors`` launches the CUDA kernel in ``csrc/nn.cu`` (the k = 1
specialisation of ``csrc/knn_common.cuh``, planned by
``knn_kernel.plan_launch``) for CUDA tensors and returns the plain twin
``ops.matching.nearest_neighbors`` for CPU tensors; any other device raises.
On the main path it serves the paired-ratio quality (1024 sources against
the 32k map layer), the final covariance pairing and the scan-to-scan
point-to-plane matcher.
"""

from __future__ import annotations

from collections import Counter

import torch

from .knn_kernel import cached_plan, check_inputs, launch
from .matching import NNResult, nearest_neighbors as nearest_neighbors_plain

#: launches of the CUDA kernel through :func:`nearest_neighbors` (plain-twin
#: calls on the CPU do not count), in all and per ``(B, n, m, 1)`` (B = 1
#: unbatched)
launches = 0
launches_by_shape: Counter = Counter()


def nearest_neighbors(src, src_mask, tgt, tgt_mask) -> NNResult:
    """Exact 1-NN, ``idx i32[..., N]`` / ``dist f32[..., N]`` (the
    ``pallas_nearest_neighbors`` contract; see ``ops/matching.py``); a
    batch as in ``knn_kernel``."""
    global launches
    if src.device.type == "cpu":
        return nearest_neighbors_plain(src, src_mask, tgt, tgt_mask)
    if src.device.type != "cuda":
        raise ValueError(f"nearest_neighbors: unsupported device {src.device}")
    batch = check_inputs(src, src_mask, tgt, tgt_mask)
    n, m = src.shape[-2], tgt.shape[-2]
    dist = torch.empty(src.shape[:-1], dtype=torch.float32, device=src.device)
    idx = torch.empty(src.shape[:-1], dtype=torch.int32, device=src.device)
    if n == 0:
        return NNResult(idx, dist)
    launch(src, src_mask, tgt, tgt_mask, 1, cached_plan(src.device, n, m, 1), dist, idx)
    launches += 1
    launches_by_shape[(batch, n, m, 1)] += 1
    return NNResult(idx, dist)
