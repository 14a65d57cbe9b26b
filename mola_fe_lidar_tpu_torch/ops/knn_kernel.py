"""K1: exact k-NN on the card -- the port of the Pallas kernel
``mola_fe_lidar_tpu/ops/pallas_knn.py::_knn_kernel`` (wrapper
``pallas_knn``).

``knn`` launches the CUDA kernel in ``csrc/knn.cu`` (design and bounds in
``csrc/knn_common.cuh``) for CUDA tensors and returns the plain twin
``ops.matching.knn`` for CPU tensors; any other device raises. On the main
path it serves the candidate-cache refreshes (k = 4 for decimated -> planes
and k = 8 for edges -> edges) and the point-to-line matcher (k = 5).
"""

from __future__ import annotations

import torch

from . import cuda_build
from .matching import NNResult, knn as knn_plain

SUPPORTED_K = (1, 4, 5, 8, 16)

#: launches of the CUDA kernel through :func:`knn` (plain-twin calls on the
#: CPU do not count)
launches = 0


def check_inputs(src, src_mask, tgt, tgt_mask) -> None:
    """Shared argument checks of the K1/K2 wrappers."""
    dev = src.device
    for name, x, shape in (("src", src, (None, 3)), ("src_mask", src_mask, (src.shape[0],)),
                           ("tgt", tgt, (None, 3)), ("tgt_mask", tgt_mask, (tgt.shape[0],))):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, src on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, x.shape)):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, want {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tgt.shape[0] == 0:
        raise ValueError("empty target cloud")


def splits_for(device: torch.device, n: int, m: int) -> int:
    """Target-axis splits: enough blocks for two waves on the card's SMs,
    at least 1024 targets per split, at most 64 splits."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks_n = max(1, -(-n // 128))
    want = -(-2 * sms // blocks_n)
    return int(max(1, min(64, want, -(-m // 1024))))


def knn(src, src_mask, tgt, tgt_mask, k: int) -> NNResult:
    """Exact k-NN, ``idx i32[N,k]`` / ``dist f32[N,k]`` ascending (the
    ``pallas_knn`` contract; see ``ops/matching.py``)."""
    global launches
    if src.device.type == "cpu":
        return knn_plain(src, src_mask, tgt, tgt_mask, k)
    if src.device.type != "cuda":
        raise ValueError(f"knn: unsupported device {src.device}")
    if k not in SUPPORTED_K:
        raise ValueError(f"knn kernel supports k in {SUPPORTED_K}, got {k}")
    check_inputs(src, src_mask, tgt, tgt_mask)
    n, m = src.shape[0], tgt.shape[0]
    dev = src.device
    dist = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    if n == 0:
        return NNResult(idx, dist)
    splits = splits_for(dev, n, m)
    part_d2 = torch.empty((splits, n, k), dtype=torch.float32, device=dev)
    part_idx = torch.empty((splits, n, k), dtype=torch.int32, device=dev)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        code = lib.mola_knn_launch(
            src.data_ptr(), src_mask.data_ptr(), tgt.data_ptr(), tgt_mask.data_ptr(),
            n, m, k, splits, part_d2.data_ptr(), part_idx.data_ptr(),
            dist.data_ptr(), idx.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(code, "knn")
    launches += 1
    return NNResult(idx, dist)
