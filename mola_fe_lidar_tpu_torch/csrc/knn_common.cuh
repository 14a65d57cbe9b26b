// Exact brute-force k-nearest-neighbour search on Hopper: one launch per
// call, register-tiled over sources, merged inside a thread-block cluster.
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
// What bounds it: f32 issue. A call reads under 1 MB from device memory (a
// 32k-point target cloud is 384 KB) and does 8 f32 operations a (source,
// target) pair plus a compare. The contract forbids FMA, and un-fused f32
// instructions issue at half the FMA rate, so a bit-exact kernel reaches at
// most about half of the card's 67 TFLOP/s f32 peak. Every source tile
// stages the targets again from L2 (67 MB at 8192 x 32768), about a tenth
// of the kernel time.
//
// No tensor cores: a 3-D k-NN is a contraction of depth 3, and the norm
// expansion |s|^2 + |t|^2 - 2 s.t that a tensor core would compute loses up
// to ~1e-3 m to cancellation at 30 m scale; it would break both the
// bit-identical contract with the twin and the Pallas kernel's difference
// form.
//
// Design (plan chosen on the host by ops/knn_kernel.py::plan_launch):
//
//   * A block of kThreads threads owns a tile of 32 * R sources (lane l of
//     every warp holds sources l, l + 32, ...). Each thread keeps R sources
//     and their R sorted K-best lists in registers, so one shared-memory
//     load of a target serves R pairs, and the R independent distance
//     chains (times U targets a step) fill the f32 pipes without more warps.
//   * The scan keeps, per row, not the K best targets but the K best steps
//     of U targets, ranked by the step's minimum distance (U - 1 f32 mins a
//     step, then a branch-free insertion). The K nearest targets
//     always lie in those K steps, which are rescanned exactly at the end
//     of each chunk. Insertions into a list diverge across a warp's lanes,
//     and the compiler if-converts them into selects that every lane pays;
//     per step instead of per target, they cost a U-th as much.
//   * Targets are staged in shared memory as they lie in global memory,
//     (x, y, z) triples and masks, by asynchronous 4-byte copies (cp.async)
//     that are all in flight at once: a chunk costs one L2 round trip, not
//     one per few loads a thread as loads through registers would (PERF.md
//     has the staging share measured both ways). A pass
//     over shared memory then parks the masked targets and pads the tail
//     beyond m at 1e30 (its d2 overflows to +inf and never enters a list).
//     A step of U targets is 3U/4 broadcast 128-bit loads that feed every
//     lane; two register buffers keep one step's loads in flight while the
//     other step computes. A block stages its parts in chunks of at most
//     96 KB behind barriers, so that two blocks fit an SM and one scans
//     while the other stages (one chunk at the small main-path shapes,
//     three at 8192 x 32768; two buffers of half the size, each chunk's
//     copies in flight during the previous chunk's scan, measured slower:
//     twice the chunks, each with its exact rescan; PERF.md).
//   * The target axis is split into contiguous parts, one to each of the
//     kWarps warps of a block and across the blocks of a cluster
//     (grid.x = cluster size, grid.y = source tiles). Each warp's lists hold
//     its part's K nearest, sorted by (d2, index).
//   * A batch of independent searches is one launch: lane b of B runs on
//     grid.z = b with the plan of one lane. Each of the four operands
//     carries its own lane stride in floats, and a stride of 0 shares one
//     cloud (or mask) among all lanes, so a batch of poses against one
//     target never copies the target. Outputs are [B, n, K], contiguous.
//   * One launch: each warp leaves its lists in its block's shared memory;
//     after cluster.sync() every block merges a slice of the tile's sources,
//     reading all parts through distributed shared memory in ascending part
//     order with strict '<' insertion (equal distances keep the lower index),
//     applies the sentinel rules and writes sqrt(d2).
//
// Lists longer than kMaxRegisterK would spill from registers. For those
// (K1 at k = 32, 64, 128; ops/knn_kernel.py routes every other k <= 128 to
// the next compiled length and keeps its first k columns) knn_search_shared
// keeps each source's list in shared memory, in the merge layout, with the
// same parts, clusters, staging and tie order but R = 1 and no step scan:
// each lane computes every target of its warp's part and inserts the few
// that beat its K-th entry by shifting the list (insertions are rare after
// the list fills: about K (1 + ln(part / K)) per part for targets in random
// order). The merge is a K-way merge of the parts' sorted lists, heads in
// shared memory. It is the simple form, not a tuned one: a warp stalls on
// its lanes' insertions, and at K = 128 one block fills an SM's shared
// memory.
//
// The kernel launches on the caller's stream and allocates nothing; the C
// entry points return cudaGetLastError(). Everything here has internal
// linkage, so knn.cu and nn.cu may both instantiate K = 1 in one library.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace mola {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kMaxRegisterK = 16;  // longer lists live in shared memory
constexpr int kWarps = kThreads / 32;  // one target part a warp
constexpr int kStepAlign = 8;  // part and chunk lengths: multiples of every U
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;  // 227 KB: a Hopper block's dynamic maximum
constexpr float kPark = 3e4f;
constexpr float kPad = 1e30f;
constexpr float kInvalidD2 = 1e8f;  // (1e4 m)^2
constexpr float kBig = 1e30f;

// Timing builds only (scripts/torch_knn_sweep.py): 1 runs the merge alone,
// 2 the staging and the merge, 3 (the default) the whole search.
#ifndef MOLA_KNN_PHASES
#define MOLA_KNN_PHASES 3
#endif

// Insert (cv, ci) into a sorted list by shifting: `below[s]` (the new entry
// goes before slot s) is monotone over a sorted list, so each slot takes its
// predecessor's old entry, the new one, or keeps its own. The displaced
// entries are never compared again, so equal distances keep their order.
// Lex = false: strict '<' on d2, for entries fed in ascending index order;
// lex = true: (d2, index) order, for entries fed in any order.
template <int K, bool kLex>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float cv,
                                       int ci) {
  bool below[K];
#pragma unroll
  for (int s = 0; s < K; ++s)
    below[s] = kLex ? (cv < bd[s] || (cv == bd[s] && ci < bi[s])) : cv < bd[s];
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    bd[s] = below[s - 1] ? bd[s - 1] : (below[s] ? cv : bd[s]);
    bi[s] = below[s - 1] ? bi[s - 1] : (below[s] ? ci : bi[s]);
  }
  if (below[0]) {
    bd[0] = cv;
    bi[0] = ci;
  }
}

__device__ __forceinline__ float sq_dist(float sx, float sy, float sz,
                                         const float* t) {
  const float dx = __fsub_rn(sx, t[0]);
  const float dy = __fsub_rn(sy, t[1]);
  const float dz = __fsub_rn(sz, t[2]);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// A 4-byte asynchronous copy from global to shared memory, and the wait for
// all of this thread's copies.
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// targets a scan step covers: the step minimum costs (U-1)/U of an f32
// min a pair and the step list one insertion per U pairs (a step of 2U,
// one insertion per two register buffers, measured slower)
template <int K>
__host__ __device__ constexpr int step_len() {
  return K <= 5 ? 8 : 4;
}

__host__ __device__ constexpr int smem_bytes(int k, int rows, int chunk) {
  // staged targets (x, y, z and mask), and the lists: aliased over them
  // after the scan when they live in registers during it, beside them when
  // they live in shared memory
  return k > kMaxRegisterK ? kWarps * chunk * 16 + kThreads * rows * k * 8
         : kWarps * chunk * 16 > kThreads * rows * k * 8 ? kWarps * chunk * 16
                                                         : kThreads * rows * k * 8;
}

template <int K, int R>
__global__ void __launch_bounds__(kThreads)
knn_search(const float* __restrict__ src, const float* __restrict__ src_mask,
           const float* __restrict__ tgt, const float* __restrict__ tgt_mask,
           int n, int m, int part_len, int chunk, long long src_ls,
           long long src_mask_ls, long long tgt_ls, long long tgt_mask_ls,
           float* __restrict__ out_dist, int* __restrict__ out_idx) {
  extern __shared__ float4 smem[];
  // this block's lane of the batch
  const long long lane = blockIdx.z;
  src += lane * src_ls;
  src_mask += lane * src_mask_ls;
  tgt += lane * tgt_ls;
  tgt_mask += lane * tgt_mask_ls;
  out_dist += lane * n * K;
  out_idx += lane * n * K;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int w = threadIdx.x / 32;
  const int g = threadIdx.x % 32;
  const int tile_len = 32 * R;
  const int tile0 = blockIdx.y * tile_len;

  float sx[R], sy[R], sz[R];
  float bd[R][K];
  int bi[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = tile0 + r * 32 + g;
    sx[r] = sy[r] = sz[r] = 0.f;
    if (s < n && src_mask[s] > 0.5f) {
      sx[r] = src[3 * s];
      sy[r] = src[3 * s + 1];
      sz[r] = src[3 * s + 2];
    }
#pragma unroll
    for (int q = 0; q < K; ++q) {
      bd[r][q] = kBig;
      bi[r][q] = 0;
    }
  }

  constexpr int U = step_len<K>();
  // a chunk: each warp's part's triples, then each warp's part's masks
  float* const sxyz = reinterpret_cast<float*>(smem);
  float* const smask = sxyz + kWarps * 3 * chunk;
  for (int off = 0; off < part_len; off += chunk) {
    const int len = min(chunk, part_len - off);
    if (off > 0) __syncthreads();  // the previous chunk is no longer read
    for (int ww = 0; ww < kWarps && MOLA_KNN_PHASES >= 2; ++ww) {
      const int gbase = (rank * kWarps + ww) * part_len + off;
      const int have = max(0, min(len, m - gbase));  // targets before m
      for (int e = threadIdx.x; e < 3 * have; e += kThreads)
        copy_async4(sxyz + ww * 3 * chunk + e, tgt + 3ll * gbase + e);
      for (int e = threadIdx.x; e < have; e += kThreads)
        copy_async4(smask + ww * chunk + e, tgt_mask + gbase + e);
    }
    copy_async_wait();
    __syncthreads();
    // park the masked targets and pad past m, up to the last step the scan
    // reads (it stops at the first step that is all pad)
    for (int ww = 0; ww < kWarps && MOLA_KNN_PHASES >= 2; ++ww) {
      const int have = max(0, min(len, m - ((rank * kWarps + ww) * part_len + off)));
      const int live = min(len, (have + U - 1) / U * U);
      float* xyz = sxyz + ww * 3 * chunk;
      for (int j = threadIdx.x; j < live; j += kThreads) {
        const float v = j < have ? (smask[ww * chunk + j] > 0.5f ? 0.f : kPark) : kPad;
        if (v != 0.f) xyz[3 * j] = xyz[3 * j + 1] = xyz[3 * j + 2] = v;
      }
    }
    __syncthreads();
    if (MOLA_KNN_PHASES < 3) continue;
    const float* mine = sxyz + w * 3 * chunk;
    const int base = (rank * kWarps + w) * part_len + off;
    const int live = min(len, (max(0, min(len, m - base)) + U - 1) / U * U);

    // Scan: each row keeps the K best steps of U targets by (step minimum,
    // step) -- strict '<' in step order. The K nearest targets of the chunk
    // lie in those K steps: a step outside them has K steps before it, each
    // holding a target that comes before all of its own in (d2, index).
    float sd[R][K];
    int ss[R][K];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int q = 0; q < K; ++q) {
        sd[r][q] = kBig;
        ss[r][q] = 0;
      }
    }
    auto step = [&](const float(&t)[3 * U], int j) {
      // every row's step minimum first, in one basic block, so that the
      // compiler interleaves the rows' chains
      float dmin[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float d[U];
#pragma unroll
        for (int u = 0; u < U; ++u) d[u] = sq_dist(sx[r], sy[r], sz[r], t + 3 * u);
#pragma unroll
        for (int h = U / 2; h > 0; h /= 2) {
#pragma unroll
          for (int u = 0; u < h; ++u) d[u] = fminf(d[u], d[u + h]);
        }
        dmin[r] = d[0];
      }
      // Unguarded: a minimum no better than the K-th leaves the list as it
      // is, and straight-line selects measured faster than any guard (a
      // branch, or a warp vote that skips the steps no lane needs).
#pragma unroll
      for (int r = 0; r < R; ++r) insert<K, false>(sd[r], ss[r], dmin[r], j / U);
    };
    auto load = [&](float(&t)[3 * U], int j) {
      // 16-byte aligned: chunk and j are multiples of 4
      const float4* p = reinterpret_cast<const float4*>(mine + 3 * j);
#pragma unroll
      for (int q = 0; q < 3 * U / 4; ++q) {
        const float4 v = p[q];
        t[4 * q] = v.x;
        t[4 * q + 1] = v.y;
        t[4 * q + 2] = v.z;
        t[4 * q + 3] = v.w;
      }
    };
    // Two register buffers of U targets: the loads of one step are in
    // flight while the other step computes (2 warps a sub-partition do not
    // hide a shared load's latency on their own).
    float ta[3 * U], tb[3 * U];
    if (live > 0) load(ta, 0);
    int j = 0;
    for (; j + 2 * U <= live; j += 2 * U) {
      load(tb, j + U);
      step(ta, j);
      load(ta, min(j + 2 * U, live - U));  // the last one is not used
      step(tb, j + U);
    }
    if (j < live) step(ta, j);

    // Rescan the K best steps exactly into the running lists; (d2, index)
    // order makes the result independent of the order the steps come in.
    // The K step minima are K targets within the K-th step minimum, so a
    // target beyond it is not among the chunk's K nearest.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float reach = sd[r][K - 1];
#pragma unroll  // a runtime index would put the lists on the stack
      for (int q = 0; q < K; ++q) {
        if (sd[r][q] < kBig) {
          const int js = ss[r][q] * U;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float d2 = sq_dist(sx[r], sy[r], sz[r], mine + 3 * (js + u));
            if (d2 <= reach) insert<K, true>(bd[r], bi[r], d2, base + js + u);
          }
        }
      }
    }
  }

  // each warp's lists, [warp][slot][tile source], over the staged targets
  __syncthreads();
  float* part_d2 = reinterpret_cast<float*>(smem);
  int* part_idx = reinterpret_cast<int*>(part_d2 + kWarps * K * tile_len);
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int at = (w * K + q) * tile_len + r * 32 + g;
      part_d2[at] = bd[r][q];
      part_idx[at] = bi[r][q];
    }
  }
  cluster.sync();

  // merge: this block finishes its slice of the tile's sources
  const int per = (tile_len + csize - 1) / csize;
  const int hi = min(tile_len, (rank + 1) * per);
  for (int ls = rank * per + threadIdx.x; ls < hi; ls += kThreads) {
    const int s = tile0 + ls;
    if (s >= n) break;
    float md[K];
    int mi[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      md[q] = kBig;
      mi[q] = 0;
    }
    for (int c = 0; c < csize; ++c) {
      const float* rd = cluster.map_shared_rank(part_d2, c);
      const int* ri = cluster.map_shared_rank(part_idx, c);
      for (int ww = 0; ww < kWarps; ++ww) {
        // one round trip a part: its K entries are loaded together
        float pv[K];
        int pi[K];
#pragma unroll
        for (int q = 0; q < K; ++q) {
          pv[q] = rd[(ww * K + q) * tile_len + ls];
          pi[q] = ri[(ww * K + q) * tile_len + ls];
        }
#pragma unroll
        for (int q = 0; q < K; ++q) {
          if (pv[q] < md[K - 1]) insert<K, false>(md, mi, pv[q], pi[q]);
        }
      }
    }
    const bool src_ok = src_mask[s] > 0.5f;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      float d2 = md[q];
      int idx = min(mi[q], m - 1);
      if (d2 > kInvalidD2) {
        d2 = kBig;
        idx = 0;
      }
      if (!src_ok) d2 = kBig;
      out_dist[static_cast<long long>(s) * K + q] = sqrtf(d2);
      out_idx[static_cast<long long>(s) * K + q] = idx;
    }
  }
  cluster.sync();  // no block leaves while another still reads its lists
}

// The search with its lists in shared memory, for K > kMaxRegisterK and R = 1
// (the plan and the arguments are knn_search's).
template <int K>
__global__ void __launch_bounds__(kThreads)
knn_search_shared(const float* __restrict__ src, const float* __restrict__ src_mask,
                  const float* __restrict__ tgt, const float* __restrict__ tgt_mask,
                  int n, int m, int part_len, int chunk, long long src_ls,
                  long long src_mask_ls, long long tgt_ls, long long tgt_mask_ls,
                  float* __restrict__ out_dist, int* __restrict__ out_idx) {
  extern __shared__ float4 smem[];
  const long long lane = blockIdx.z;
  src += lane * src_ls;
  src_mask += lane * src_mask_ls;
  tgt += lane * tgt_ls;
  tgt_mask += lane * tgt_mask_ls;
  out_dist += lane * n * K;
  out_idx += lane * n * K;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int w = threadIdx.x / 32;
  const int g = threadIdx.x % 32;
  const int tile0 = blockIdx.y * 32;

  // each warp's lists, [warp][slot][tile source], then the staged chunk:
  // each warp's part's triples, then each warp's part's masks
  float* const part_d2 = reinterpret_cast<float*>(smem);
  int* const part_idx = reinterpret_cast<int*>(part_d2 + kWarps * K * 32);
  float* const sxyz = reinterpret_cast<float*>(part_idx + kWarps * K * 32);
  float* const smask = sxyz + kWarps * 3 * chunk;
  float* const ld = part_d2 + w * K * 32 + g;  // this lane's list: slot q at q * 32
  int* const li = part_idx + w * K * 32 + g;
  for (int q = 0; q < K; ++q) {
    ld[q * 32] = kBig;
    li[q * 32] = 0;
  }
  float sx = 0.f, sy = 0.f, sz = 0.f;
  if (tile0 + g < n && src_mask[tile0 + g] > 0.5f) {
    sx = src[3 * (tile0 + g)];
    sy = src[3 * (tile0 + g) + 1];
    sz = src[3 * (tile0 + g) + 2];
  }
  float reach = kBig;  // the list's K-th distance

  for (int off = 0; off < part_len; off += chunk) {
    const int len = min(chunk, part_len - off);
    if (off > 0) __syncthreads();  // the previous chunk is no longer read
    for (int ww = 0; ww < kWarps; ++ww) {
      const int gbase = (rank * kWarps + ww) * part_len + off;
      const int have = max(0, min(len, m - gbase));  // targets before m
      for (int e = threadIdx.x; e < 3 * have; e += kThreads)
        copy_async4(sxyz + ww * 3 * chunk + e, tgt + 3ll * gbase + e);
      for (int e = threadIdx.x; e < have; e += kThreads)
        copy_async4(smask + ww * chunk + e, tgt_mask + gbase + e);
    }
    copy_async_wait();
    __syncthreads();
    for (int ww = 0; ww < kWarps; ++ww) {  // park the masked targets
      const int have = max(0, min(len, m - ((rank * kWarps + ww) * part_len + off)));
      float* xyz = sxyz + ww * 3 * chunk;
      for (int j = threadIdx.x; j < have; j += kThreads) {
        if (!(smask[ww * chunk + j] > 0.5f))
          xyz[3 * j] = xyz[3 * j + 1] = xyz[3 * j + 2] = kPark;
      }
    }
    __syncthreads();
    const float* mine = sxyz + w * 3 * chunk;
    const int base = (rank * kWarps + w) * part_len + off;
    const int have = max(0, min(len, m - base));
    // targets in ascending index order: strict '<' against the K-th entry
    // and a shift that stops at an equal distance keep (d2, index) order
    for (int j = 0; j < have; ++j) {
      const float d2 = sq_dist(sx, sy, sz, mine + 3 * j);
      if (d2 < reach) {
        int p = K - 1;
        for (; p > 0; --p) {
          const float prev = ld[(p - 1) * 32];
          if (!(prev > d2)) break;
          ld[p * 32] = prev;
          li[p * 32] = li[(p - 1) * 32];
        }
        ld[p * 32] = d2;
        li[p * 32] = base + j;
        reach = ld[(K - 1) * 32];
      }
    }
  }
  cluster.sync();

  // merge: this block finishes its slice of the tile's sources, one thread
  // a source, by a K-way merge over the parts (cluster rank major, warp
  // minor: ascending index ranges, so strict '<' keeps the lower index on
  // equal distances). The heads, [part][slice source], take the staging's
  // place: parts * per = 128 ints, within the smallest staging (4 warps x
  // 8 targets x 16 B).
  int* const heads = reinterpret_cast<int*>(sxyz);
  const int parts = csize * kWarps;
  const int per = (32 + csize - 1) / csize;
  const int ls = rank * per + threadIdx.x;
  if (threadIdx.x < per && ls < 32 && tile0 + ls < n) {
    int* const hd = heads + threadIdx.x;
    for (int p = 0; p < parts; ++p) hd[p * per] = 0;
    const int s = tile0 + ls;
    const bool src_ok = src_mask[s] > 0.5f;
    for (int q = 0; q < K; ++q) {
      float best = kBig;
      int bp = -1, bh = 0;
      for (int p = 0; p < parts; ++p) {
        const int h = hd[p * per];
        if (h < K) {
          const float* rd = cluster.map_shared_rank(part_d2, p / kWarps);
          const float v = rd[((p % kWarps) * K + h) * 32 + ls];
          if (bp < 0 || v < best) {
            best = v;
            bp = p;
            bh = h;
          }
        }
      }
      const int* ri = cluster.map_shared_rank(part_idx, bp / kWarps);
      int idx = min(ri[((bp % kWarps) * K + bh) * 32 + ls], m - 1);
      hd[bp * per] = bh + 1;
      float d2 = best;
      if (d2 > kInvalidD2) {
        d2 = kBig;
        idx = 0;
      }
      if (!src_ok) d2 = kBig;
      out_dist[static_cast<long long>(s) * K + q] = sqrtf(d2);
      out_idx[static_cast<long long>(s) * K + q] = idx;
    }
  }
  cluster.sync();  // no block leaves while another still reads its lists
}

using SearchFn = void (*)(const float*, const float*, const float*, const float*, int, int,
                          int, int, long long, long long, long long, long long, float*, int*);

// The kernel of a compiled (K, R): the register lists up to kMaxRegisterK,
// the shared-memory lists beyond.
template <int K, int R>
SearchFn search_kernel() {
  if constexpr (K > kMaxRegisterK) {
    static_assert(R == 1, "shared-memory lists take R = 1");
    return knn_search_shared<K>;
  } else {
    return knn_search<K, R>;
  }
}

template <int K, int R>
cudaError_t configure() {
  // once per device: allow the dynamic shared memory above 48 KB
  static unsigned long long done = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && (done >> dev & 1ull)) return cudaSuccess;
  e = cudaFuncSetAttribute(search_kernel<K, R>(),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess && dev < 64) done |= 1ull << dev;
  return e;
}

bool plan_ok(int n, int m, int k, int batch, int rows, int cluster, int tiles,
             int part_len, int chunk, int smem) {
  return batch >= 1 && batch <= 65535 && cluster >= 1 &&
         cluster <= kMaxCluster && tiles >= 1 &&
         tiles <= 65535 && part_len >= kStepAlign &&
         part_len % kStepAlign == 0 && chunk >= kStepAlign &&
         chunk % kStepAlign == 0 && chunk <= part_len &&
         static_cast<long long>(tiles) * 32 * rows >= n &&
         static_cast<long long>(part_len) * cluster * kWarps >= m &&
         (k <= kMaxRegisterK || rows == 1) &&
         smem == smem_bytes(k, rows, chunk) && smem <= kMaxSmem;
}

template <int K, int R>
int launch_knn(const float* src, const float* src_mask, const float* tgt,
               const float* tgt_mask, int n, int m, int batch,
               long long src_ls, long long src_mask_ls, long long tgt_ls,
               long long tgt_mask_ls, int cluster, int tiles, int part_len,
               int chunk, int smem, float* out_dist, int* out_idx,
               cudaStream_t stream) {
  if (!plan_ok(n, m, K, batch, R, cluster, tiles, part_len, chunk, smem))
    return -1;
  cudaError_t e = configure<K, R>();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, tiles, batch);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, search_kernel<K, R>(), src, src_mask, tgt, tgt_mask,
                         n, m, part_len, chunk, src_ls, src_mask_ls, tgt_ls,
                         tgt_mask_ls, out_dist, out_idx);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of this size that the card holds at once (the occupancy the
// plan gets), or a negative cudaError_t.
template <int K, int R>
int max_active_clusters(int cluster, int smem) {
  cudaError_t e = configure<K, R>();
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, search_kernel<K, R>(), &cfg);
  return e == cudaSuccess ? count : -static_cast<int>(e);
}

}  // namespace
}  // namespace mola

// One dispatch case per compiled (K, R): the entry points expand
// MOLA_KNN_CASES(MOLA_LAUNCH_CASE) or MOLA_KNN_CASES(MOLA_OCC_CASE).
#define MOLA_LAUNCH_CASE(KK, RR)                                             \
  if (k == KK && rows == RR)                                                 \
    return mola::launch_knn<KK, RR>(                                         \
        src, src_mask, tgt, tgt_mask, n, m, batch, src_ls, src_mask_ls,      \
        tgt_ls, tgt_mask_ls, cluster, tiles, part_len, chunk, smem,          \
        out_dist, out_idx, static_cast<cudaStream_t>(stream));
#define MOLA_OCC_CASE(KK, RR) \
  if (k == KK && rows == RR) return mola::max_active_clusters<KK, RR>(cluster, smem);
