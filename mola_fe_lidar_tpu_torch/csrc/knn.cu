// K1: exact k-NN, the counterpart of mola_fe_lidar_tpu/ops/pallas_knn.py
// (_knn_kernel, wrapper pallas_knn). The kernels and their design notes are
// in knn_common.cuh; this file holds the C entry points for the list lengths
// k in {1, 4, 5, 6, 8, 10, 16} (lists in registers, each at the sources-per-
// thread counts R in ops/knn_kernel.py::ROWS) and {32, 64, 128} (lists in
// shared memory, R = 1). ops/knn_kernel.py runs every other k <= 128 at the
// next of these and binds them to Python through ctypes.
#include "knn_common.cuh"

#define MOLA_KNN_CASES(X) \
  X(1, 1) X(1, 2) X(4, 1) X(4, 2) X(5, 1) X(5, 2) X(6, 1) X(6, 2) X(8, 1) X(8, 2) \
  X(10, 1) X(10, 2) X(16, 1) X(16, 2) X(32, 1) X(64, 1) X(128, 1)

extern "C" {

// Returns 0 on success, a cudaError_t value if the launch failed, or -1 for
// an unsupported k / R or a plan that does not cover the shape (the wrapper
// checks k and builds the plan with plan_launch).
// A batch of `batch` lanes: each operand's lane stride is in floats, 0 when
// all lanes share it; the outputs are [batch, n, k].
int mola_knn_launch(const float* src, const float* src_mask, const float* tgt,
                    const float* tgt_mask, int n, int m, int k, int batch,
                    long long src_ls, long long src_mask_ls, long long tgt_ls,
                    long long tgt_mask_ls, int rows, int cluster, int tiles,
                    int part_len, int chunk, int smem, float* out_dist,
                    int* out_idx, void* stream) {
  MOLA_KNN_CASES(MOLA_LAUNCH_CASE)
  return -1;
}

// Clusters of `cluster` blocks with `smem` bytes each that the current card
// holds at once for list length k and R sources a thread; negative on error.
int mola_knn_max_active_clusters(int k, int rows, int cluster, int smem) {
  MOLA_KNN_CASES(MOLA_OCC_CASE)
  return -1;
}

const char* mola_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
