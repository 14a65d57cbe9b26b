// K2: exact 1-NN, the counterpart of mola_fe_lidar_tpu/ops/pallas_nn.py
// (_nn_kernel, wrapper pallas_nearest_neighbors). It is the K = 1
// specialisation of the search in knn_common.cuh (design notes there), with
// its own entry point so that ops/nn_kernel.py keeps its own launch count.
#include "knn_common.cuh"

#define MOLA_NN_CASES(X) X(1, 1) X(1, 2)

// Batched as mola_knn_launch (knn.cu): lane strides in floats, 0 = shared.
extern "C" int mola_nn_launch(const float* src, const float* src_mask,
                              const float* tgt, const float* tgt_mask, int n,
                              int m, int batch, long long src_ls,
                              long long src_mask_ls, long long tgt_ls,
                              long long tgt_mask_ls, int rows, int cluster,
                              int tiles, int part_len, int chunk, int smem,
                              float* out_dist, int* out_idx, void* stream) {
  const int k = 1;
  MOLA_NN_CASES(MOLA_LAUNCH_CASE)
  return -1;
}
