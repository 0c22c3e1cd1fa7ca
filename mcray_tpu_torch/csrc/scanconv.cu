// K4: bilinear polar -> Cartesian scan conversion (cv::remap, INTER_LINEAR,
// BORDER_CONSTANT).
//
// Replaces mcray_tpu/ops/pallas/scanconv.py:_scanconv_kernel and
// _scanconv_banded_kernel, which compute this gather as one-hot MXU
// matmuls on the TPU. One thread per B-mode pixel: it reads
// (r0, w_r0, w_r1, c0, w_c0, w_c1) from the packed (out_rows, 8, W_pad)
// table and sums the four taps in map_coordinates' order,
// (r0,c0), (r0,c0+1), (r0+1,c0), (r0+1,c0+1); a tap outside the RF image
// reads 0. Bound: gather latency; table and image sit in L2.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float tap(const float* __restrict__ rf, int rows, int cols, int r,
                                     int c) {
  return (r >= 0 && r < rows && c >= 0 && c < cols) ? rf[(size_t)r * cols + c] : 0.0f;
}

__global__ void scan_convert_kernel(const float* __restrict__ rf, int rows, int cols,
                                    const float* __restrict__ table, int out_cols, int w_pad,
                                    float* __restrict__ out) {
  const int i = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= out_cols) return;
  const float* t = table + (size_t)i * 8 * w_pad + j;
  const int r0 = (int)t[0 * w_pad];
  const float w_r0 = t[1 * w_pad], w_r1 = t[2 * w_pad];
  const int c0 = (int)t[3 * w_pad];
  const float w_c0 = t[4 * w_pad], w_c1 = t[5 * w_pad];
  out[(size_t)i * out_cols + j] = (w_r0 * w_c0) * tap(rf, rows, cols, r0, c0) +
                                  (w_r0 * w_c1) * tap(rf, rows, cols, r0, c0 + 1) +
                                  (w_r1 * w_c0) * tap(rf, rows, cols, r0 + 1, c0) +
                                  (w_r1 * w_c1) * tap(rf, rows, cols, r0 + 1, c0 + 1);
}

}  // namespace

extern "C" int mcray_scan_convert(const float* rf, int rows, int cols, const float* table,
                                  int out_rows, int out_cols, int w_pad, float* out,
                                  cudaStream_t stream) {
  if (out_rows > 0 && out_cols > 0) {
    const dim3 grid((out_cols + THREADS - 1) / THREADS, out_rows);
    scan_convert_kernel<<<grid, THREADS, 0, stream>>>(rf, rows, cols, table, out_cols, w_pad,
                                                      out);
  }
  return (int)cudaGetLastError();
}
