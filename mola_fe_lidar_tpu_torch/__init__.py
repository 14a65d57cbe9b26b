"""mola_fe_lidar_tpu_torch -- the LiDAR odometry front-end of
``mola_fe_lidar_tpu`` ported to PyTorch and CUDA for one NVIDIA H100.

The JAX package beside it is the reference: every module here mirrors the
module of the same name there and is tested against it. This package
imports ``torch`` and never ``jax``. Plain tensor code is PyTorch; the two
Pallas kernels of the main path are hand-written CUDA under ``csrc/``
(``ops/knn_kernel.py`` and ``ops/nn_kernel.py``), built with ``nvcc`` at
first use on a CUDA tensor. CPU tensors take each kernel's plain PyTorch
twin (``ops/matching.py``).

Every module of the JAX package has its counterpart here (``geometry``,
``cloud``, ``ops`` with the voxel-hash grid search, ``filters``, ``solve``,
``models``, ``parallel`` with the DP/TP device meshes, ``frontend``,
``obs``, and ``native``: the C++ pose graph and KITTI reader, built with
``g++`` at first use). The reference's TPU-only search units route to the
exact K1/K2 searches.
"""

import torch

# The JAX reference pins precision="highest" on every metric-space
# contraction; TF32 (about three decimal digits) would break the parity the
# tests hold this package to.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
