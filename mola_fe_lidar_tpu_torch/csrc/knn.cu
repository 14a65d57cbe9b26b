// K1: exact k-NN, the counterpart of mola_fe_lidar_tpu/ops/pallas_knn.py
// (_knn_kernel, wrapper pallas_knn). The kernels and their design notes are
// in knn_common.cuh; this file holds the C entry point for k in
// {1, 4, 5, 8, 16}. Bound to Python by ops/knn_kernel.py through ctypes.
#include "knn_common.cuh"

extern "C" {

// Returns 0 on success, a cudaError_t value if a launch failed, or -1 for an
// unsupported k (the wrapper checks k first).
int mola_knn_launch(const float* src, const float* src_mask, const float* tgt,
                    const float* tgt_mask, int n, int m, int k, int splits,
                    float* part_d2, int* part_idx, float* out_dist,
                    int* out_idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1:
      return mola::launch_knn<1>(src, src_mask, tgt, tgt_mask, n, m, splits,
                                 part_d2, part_idx, out_dist, out_idx, s);
    case 4:
      return mola::launch_knn<4>(src, src_mask, tgt, tgt_mask, n, m, splits,
                                 part_d2, part_idx, out_dist, out_idx, s);
    case 5:
      return mola::launch_knn<5>(src, src_mask, tgt, tgt_mask, n, m, splits,
                                 part_d2, part_idx, out_dist, out_idx, s);
    case 8:
      return mola::launch_knn<8>(src, src_mask, tgt, tgt_mask, n, m, splits,
                                 part_d2, part_idx, out_dist, out_idx, s);
    case 16:
      return mola::launch_knn<16>(src, src_mask, tgt, tgt_mask, n, m, splits,
                                  part_d2, part_idx, out_dist, out_idx, s);
    default:
      return -1;
  }
}

const char* mola_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
