// K2: exact 1-NN, the counterpart of mola_fe_lidar_tpu/ops/pallas_nn.py
// (_nn_kernel, wrapper pallas_nearest_neighbors). It is the K = 1
// specialisation of the templated search in knn_common.cuh (design notes
// there), with its own entry point so that ops/nn_kernel.py keeps its own
// launch count.
#include "knn_common.cuh"

extern "C" int mola_nn_launch(const float* src, const float* src_mask,
                              const float* tgt, const float* tgt_mask, int n,
                              int m, int splits, float* part_d2, int* part_idx,
                              float* out_dist, int* out_idx, void* stream) {
  return mola::launch_knn<1>(src, src_mask, tgt, tgt_mask, n, m, splits,
                             part_d2, part_idx, out_dist, out_idx,
                             static_cast<cudaStream_t>(stream));
}
