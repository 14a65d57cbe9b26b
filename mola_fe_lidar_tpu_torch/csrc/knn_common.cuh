// Exact brute-force k-nearest-neighbour search on Hopper.
//
// Replaces the Pallas kernels mola_fe_lidar_tpu/ops/pallas_knn.py::_knn_kernel
// (K1, k-NN) and mola_fe_lidar_tpu/ops/pallas_nn.py::_nn_kernel (K2, 1-NN).
// It computes their contract, not their TPU block layout:
//
//   * squared distances in difference form, sum_c (s_c - t_c)^2, in f32 with
//     every product and sum rounded separately (no FMA contraction), in the
//     order ((dx*dx + dy*dy) + dz*dz) -- bit-identical to the plain PyTorch
//     twin in ops/matching.py;
//   * masked targets are parked at 3e4 per axis and masked sources sit at the
//     origin; a neighbour farther than 1e4 m is reported at the 1e15 sentinel
//     with index 0; masked sources report the sentinel;
//   * each source's list is the K smallest (d2, index) pairs in lexicographic
//     order, ascending -- ties go to the lower target index.
//
// What bounds it: FP32 ALU and compare/select work, not bytes. A 32k-point
// target cloud is 384 KB and stays in L2; each (source, target) pair costs
// ~8 FP32 operations plus a compare. Design:
//
//   pass 1 (knn_partial): one thread per source point, 128 sources a block.
//     The target axis is split across blockIdx.y so that a small query
//     (1024 sources = 8 blocks) still spreads over the 132 SMs. A block
//     stages its split's targets through shared memory in tiles of 1024
//     (12 KB, read as broadcasts) and keeps a register-resident sorted
//     K-best list per thread, updated by strict '<' insertion in index
//     order.
//   pass 2 (knn_merge): one thread per source merges the per-split lists
//     (scanned in split order, so equal distances keep the lower index),
//     applies the sentinel rules and writes sqrt(d2).
//
// Both passes launch on the caller's stream, allocate nothing and leave
// error reporting to cudaGetLastError() in the C entry points. Everything
// here has internal linkage, so knn.cu and nn.cu may both instantiate K = 1
// in one shared library.
#pragma once

#include <cuda_runtime.h>

namespace mola {
namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;
constexpr int kMaxSplits = 64;
constexpr float kPark = 3e4f;
constexpr float kInvalidD2 = 1e8f;  // (1e4 m)^2
constexpr float kBig = 1e30f;

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_partial(const float* __restrict__ src, const float* __restrict__ src_mask,
            const float* __restrict__ tgt, const float* __restrict__ tgt_mask,
            int n, int m, int split_len,
            float* __restrict__ part_d2, int* __restrict__ part_idx) {
  __shared__ float tx[kTile];
  __shared__ float ty[kTile];
  __shared__ float tz[kTile];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int split = blockIdx.y;
  const int begin = split * split_len;
  const int end = min(m, begin + split_len);

  float sx = 0.f, sy = 0.f, sz = 0.f;
  if (i < n && src_mask[i] > 0.5f) {
    sx = src[3 * i];
    sy = src[3 * i + 1];
    sz = src[3 * i + 2];
  }

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = kBig;
    bi[s] = 0;
  }

  for (int base = begin; base < end; base += kTile) {
    const int len = min(kTile, end - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const int g = base + j;
      const bool ok = tgt_mask[g] > 0.5f;
      tx[j] = ok ? tgt[3 * g] : kPark;
      ty[j] = ok ? tgt[3 * g + 1] : kPark;
      tz[j] = ok ? tgt[3 * g + 2] : kPark;
    }
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      const float dx = __fsub_rn(sx, tx[j]);
      const float dy = __fsub_rn(sy, ty[j]);
      const float dz = __fsub_rn(sz, tz[j]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 < bd[K - 1]) {
        float cv = d2;
        int ci = base + j;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          const bool better = cv < bd[s];
          const float ov = bd[s];
          const int oi = bi[s];
          bd[s] = better ? cv : ov;
          bi[s] = better ? ci : oi;
          cv = better ? ov : cv;
          ci = better ? oi : ci;
        }
      }
    }
  }

  if (i < n) {
    const long long row = (static_cast<long long>(split) * n + i) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      part_d2[row + s] = bd[s];
      part_idx[row + s] = bi[s];
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_merge(const float* __restrict__ part_d2, const int* __restrict__ part_idx,
          const float* __restrict__ src_mask, int n, int m, int splits,
          float* __restrict__ out_dist, int* __restrict__ out_idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int head[kMaxSplits];
  for (int p = 0; p < splits; ++p) head[p] = 0;
  const bool src_ok = src_mask[i] > 0.5f;
  for (int s = 0; s < K; ++s) {
    float best = kBig;
    int best_idx = 0;
    int best_split = -1;
    for (int p = 0; p < splits; ++p) {
      if (head[p] >= K) continue;
      const long long at = (static_cast<long long>(p) * n + i) * K + head[p];
      const float v = part_d2[at];
      if (best_split < 0 || v < best) {
        best = v;
        best_idx = part_idx[at];
        best_split = p;
      }
    }
    head[best_split] += 1;
    float d2 = best;
    int idx = min(best_idx, m - 1);
    if (d2 > kInvalidD2) {
      d2 = kBig;
      idx = 0;
    }
    if (!src_ok) d2 = kBig;
    out_dist[static_cast<long long>(i) * K + s] = sqrtf(d2);
    out_idx[static_cast<long long>(i) * K + s] = idx;
  }
}

template <int K>
int launch_knn(const float* src, const float* src_mask, const float* tgt,
               const float* tgt_mask, int n, int m, int splits,
               float* part_d2, int* part_idx, float* out_dist, int* out_idx,
               cudaStream_t stream) {
  const int split_len = (m + splits - 1) / splits;
  const dim3 grid1((n + kThreads - 1) / kThreads, splits);
  knn_partial<K><<<grid1, kThreads, 0, stream>>>(
      src, src_mask, tgt, tgt_mask, n, m, split_len, part_d2, part_idx);
  const dim3 grid2((n + kThreads - 1) / kThreads);
  knn_merge<K><<<grid2, kThreads, 0, stream>>>(
      part_d2, part_idx, src_mask, n, m, splits, out_dist, out_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mola
