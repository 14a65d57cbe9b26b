"""mola_fe_lidar_tpu_torch -- the LiDAR odometry front-end of
``mola_fe_lidar_tpu`` ported to PyTorch and CUDA for one NVIDIA H100.

The JAX package beside it is the reference: every module here mirrors the
module of the same name there and is tested against it. This package
imports ``torch`` and never ``jax``. Plain tensor code is PyTorch; the two
Pallas kernels of the main path are hand-written CUDA under ``csrc/``
(``ops/knn_kernel.py`` and ``ops/nn_kernel.py``), built with ``nvcc`` at
first use on a CUDA tensor. CPU tensors take each kernel's plain PyTorch
twin (``ops/matching.py``).

Ported so far (the scan-to-local-map main path): ``geometry``, ``cloud``,
``ops``, ``filters`` (raw generator, deskew, edges/planes with prefix-sum
voxel stats), ``solve`` (Gauss-Newton, paired ratio), ``models`` (ICP with
the point-to-plane-normals and point-to-line matchers and the candidate
cache), ``frontend`` (``LidarOdometry``, the hash-built ``DeviceLocalMap``)
and ``obs.runner``. Settings outside that path raise ``NotImplementedError``.
"""

import torch

# The JAX reference pins precision="highest" on every metric-space
# contraction; TF32 (about three decimal digits) would break the parity the
# tests hold this package to.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
