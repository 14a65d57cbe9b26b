#!/usr/bin/env python3
"""Measure how many f32 warp instructions an SM sub-partition issues a clock
for FADD, FMUL, FFMA and FMNMX, on the CUDA card of this machine.

    python3 scripts/torch_fp32_issue_probe.py

The k-NN kernels (``mola_fe_lidar_tpu_torch/csrc/knn_common.cuh``) are bound
by the issue of un-fused f32 instructions; this probe gives the rate their
practical ceiling is computed from. One block of 512 threads per SM runs 8
independent chains per thread for a fixed count of iterations; ``clock64()``
around the loop gives cycles, so the rate does not depend on the SM clock.
The kernels are compiled with ``nvcc`` into a temporary directory.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

SOURCE = r"""
#define CHAINS 8
#define BODY(OP)                                                             \
  float a[CHAINS];                                                           \
  for (int c = 0; c < CHAINS; ++c) a[c] = threadIdx.x * 1e-3f + c;           \
  const float b = 1.0000001f;                                                \
  long long t0 = clock64();                                                  \
  for (int i = 0; i < iters; ++i) {                                          \
    _Pragma("unroll") for (int c = 0; c < CHAINS; ++c) a[c] = OP;           \
  }                                                                          \
  long long t1 = clock64();                                                  \
  float s = 0.f;                                                             \
  for (int c = 0; c < CHAINS; ++c) s += a[c];                                \
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;                            \
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;

extern "C" __global__ void p_fadd(float* out, long long* cycles, int iters) {
  BODY(__fadd_rn(a[c], b))
}
extern "C" __global__ void p_fmul(float* out, long long* cycles, int iters) {
  BODY(__fmul_rn(a[c], b))
}
extern "C" __global__ void p_ffma(float* out, long long* cycles, int iters) {
  BODY(__fmaf_rn(a[c], b, 1e-7f))
}
extern "C" __global__ void p_fmnmx(float* out, long long* cycles, int iters) {
  BODY(fminf(a[c], a[(c + 1) % CHAINS]))  // not foldable: the chains rotate
}

extern "C" int probe(int which, float* out, long long* cycles, int blocks,
                     int threads, int iters) {
  void (*kernels[4])(float*, long long*, int) = {p_fadd, p_fmul, p_ffma, p_fmnmx};
  kernels[which]<<<blocks, threads>>>(out, cycles, iters);
  cudaError_t e = cudaDeviceSynchronize();
  return static_cast<int>(e);
}
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_fp32_issue_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from mola_fe_lidar_tpu_torch.ops.cuda_build import _nvcc
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe.so")
        with open(cu, "w") as f:
            f.write(SOURCE)
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", so, cu], check=True)
        lib = ctypes.CDLL(so)
        lib.probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        threads, iters = 512, 1 << 16
        out = torch.empty(sms * threads, device="cuda")
        cycles = torch.zeros(sms, dtype=torch.int64, device="cuda")
        print(torch.cuda.get_device_name(0), f"{sms} SMs")
        for mode, which in enumerate(("fadd", "fmul", "ffma", "fmnmx")):
            for _ in range(2):  # the first run warms the clocks
                code = lib.probe(mode, out.data_ptr(), cycles.data_ptr(),
                                 sms, threads, iters)
                if code:
                    raise RuntimeError(f"probe {which} failed: {code}")
            cyc = float(cycles.double().median())
            warps_per_smsp = threads // 32 / 4
            rate = iters * 8 * warps_per_smsp / cyc
            print(f"{which}: {rate:.3f} warp instructions a clock per SM sub-partition "
                  f"({cyc:.0f} cycles for {iters * 8} a thread)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
