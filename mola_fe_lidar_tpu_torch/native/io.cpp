// Native dataset IO (data-loader runtime): fast KITTI velodyne .bin reader
// with optional stride decimation and range gating, done in one pass while
// the bytes are hot — feeding the host→device ingest without a Python loop.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Reads a KITTI .bin (float32 x,y,z,reflectance rows). Applies `stride`
// decimation and [min_range, max_range] gating (max_range<=0 = unlimited).
// Writes up to `cap` rows of xyz (float32[cap*3]) and intensity
// (float32[cap]). Returns rows written, or -1 on IO error.
int64_t kitti_read_bin(const char* path, int64_t stride, float min_range,
                       float max_range, int64_t cap, float* out_xyz,
                       float* out_intensity) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  int64_t n = size / (4 * sizeof(float));
  if (stride < 1) stride = 1;

  const int64_t CHUNK = 65536;
  float* buf = new float[CHUNK * 4];
  int64_t written = 0, row = 0;
  float min_sq = min_range > 0 ? min_range * min_range : 0.0f;
  float max_sq = max_range > 0 ? max_range * max_range : 0.0f;

  while (row < n && written < cap) {
    int64_t want = n - row < CHUNK ? n - row : CHUNK;
    size_t got = std::fread(buf, 4 * sizeof(float), (size_t)want, f);
    if (got == 0) break;
    for (int64_t i = 0; i < (int64_t)got && written < cap; ++i, ++row) {
      if (row % stride != 0) continue;
      float x = buf[i * 4 + 0], y = buf[i * 4 + 1], z = buf[i * 4 + 2];
      float r2 = x * x + y * y + z * z;
      if (r2 < min_sq) continue;
      if (max_sq > 0 && r2 > max_sq) continue;
      out_xyz[written * 3 + 0] = x;
      out_xyz[written * 3 + 1] = y;
      out_xyz[written * 3 + 2] = z;
      if (out_intensity) out_intensity[written] = buf[i * 4 + 3];
      ++written;
    }
  }
  delete[] buf;
  std::fclose(f);
  return written;
}

}  // extern "C"
