"""K2: exact 1-NN on the card -- the port of the Pallas kernel
``mola_fe_lidar_tpu/ops/pallas_nn.py::_nn_kernel`` (wrapper
``pallas_nearest_neighbors``).

``nearest_neighbors`` launches the CUDA kernel in ``csrc/nn.cu`` (the k = 1
specialisation of ``csrc/knn_common.cuh``) for CUDA tensors and returns the
plain twin ``ops.matching.nearest_neighbors`` for CPU tensors; any other
device raises. On the main path it serves the paired-ratio quality (1024
sources against the 32k map layer), the final covariance pairing and the
scan-to-scan point-to-plane matcher.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .knn_kernel import check_inputs, splits_for
from .matching import NNResult, nearest_neighbors as nearest_neighbors_plain

#: launches of the CUDA kernel through :func:`nearest_neighbors` (plain-twin
#: calls on the CPU do not count)
launches = 0


def nearest_neighbors(src, src_mask, tgt, tgt_mask) -> NNResult:
    """Exact 1-NN, ``idx i32[N]`` / ``dist f32[N]`` (the
    ``pallas_nearest_neighbors`` contract; see ``ops/matching.py``)."""
    global launches
    if src.device.type == "cpu":
        return nearest_neighbors_plain(src, src_mask, tgt, tgt_mask)
    if src.device.type != "cuda":
        raise ValueError(f"nearest_neighbors: unsupported device {src.device}")
    check_inputs(src, src_mask, tgt, tgt_mask)
    n, m = src.shape[0], tgt.shape[0]
    dev = src.device
    dist = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return NNResult(idx, dist)
    splits = splits_for(dev, n, m)
    part_d2 = torch.empty((splits, n), dtype=torch.float32, device=dev)
    part_idx = torch.empty((splits, n), dtype=torch.int32, device=dev)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        code = lib.mola_nn_launch(
            src.data_ptr(), src_mask.data_ptr(), tgt.data_ptr(), tgt_mask.data_ptr(),
            n, m, splits, part_d2.data_ptr(), part_idx.data_ptr(),
            dist.data_ptr(), idx.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(code, "nearest_neighbors")
    launches += 1
    return NNResult(idx, dist)
