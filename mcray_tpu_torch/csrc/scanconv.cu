// K4: bilinear polar -> Cartesian scan conversion (cv::remap, INTER_LINEAR,
// BORDER_CONSTANT).
//
// Replaces mcray_tpu/ops/pallas/scanconv.py:_scanconv_kernel and
// _scanconv_banded_kernel, which compute this gather as one-hot MXU
// matmuls on the TPU.
//
// Bound: bytes. The function reads the RF image and the two f32 coordinate
// maps and writes the B-mode image, 8 bytes of maps per pixel; the kernel
// reads exactly those. Each pixel's floor, fraction and edge weights are
// computed here from (map_row, map_col) in the f32 operations and order of
// the host's pack_scan_maps (ops/cuda/scanconv.py), so the result is the
// packed table's bit for bit (-fmad=false keeps every product rounded):
//   r0 = floor(map_row), ar = map_row - r0,
//   w_r0 = (1 - ar) * [0 <= r0 <= rows-1], w_r1 = ar * [0 <= r0+1 <= rows-1],
//   the same for the column, r0 and c0 clipped to [-1, n-1],
// then the four taps in map_coordinates' order (r0,c0), (r0,c0+1),
// (r0+1,c0), (r0+1,c0+1); a tap outside the RF image reads 0.
//
// A thread per pixel, 128 to a block (1,563 blocks at SimConfig); a pixel
// whose four weights are all 0 (outside the fan) writes 0 and reads no RF
// value. The RF image (952 KB at SimConfig) stays in L2. Four pixels a
// thread with float4 loads of the maps ran no faster than the packed-table
// kernel on the card; one a thread runs ahead of grid_sample (PERF.md).
//
// Frames. A batch of F RF images (F, rows, cols) -> (F, n_pix) is one
// launch: blockIdx.y is the frame, and every frame reads the same maps.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float tap(const float* __restrict__ rf, int rows, int cols, int r,
                                     int c) {
  return (r >= 0 && r < rows && c >= 0 && c < cols) ? __ldg(rf + (size_t)r * cols + c) : 0.0f;
}

// One axis of pack_scan_maps: the clipped first index and the two weights.
__device__ __forceinline__ int axis(float m, int n, float& w0, float& w1) {
  const float i0 = floorf(m);
  const float frac = m - i0;
  w0 = (1.0f - frac) * ((i0 >= 0.f && i0 <= (float)(n - 1)) ? 1.0f : 0.0f);
  w1 = frac * ((i0 + 1.0f >= 0.f && i0 + 1.0f <= (float)(n - 1)) ? 1.0f : 0.0f);
  return (int)fminf(fmaxf(i0, -1.0f), (float)(n - 1));
}

__device__ __forceinline__ float pixel(const float* __restrict__ rf, int rows, int cols, float mr,
                                       float mc) {
  float w_r0, w_r1, w_c0, w_c1;
  const int r0 = axis(mr, rows, w_r0, w_r1);
  const int c0 = axis(mc, cols, w_c0, w_c1);
  const float w00 = w_r0 * w_c0, w01 = w_r0 * w_c1, w10 = w_r1 * w_c0, w11 = w_r1 * w_c1;
  if (w00 == 0.f && w01 == 0.f && w10 == 0.f && w11 == 0.f) return 0.0f;
  return w00 * tap(rf, rows, cols, r0, c0) + w01 * tap(rf, rows, cols, r0, c0 + 1) +
         w10 * tap(rf, rows, cols, r0 + 1, c0) + w11 * tap(rf, rows, cols, r0 + 1, c0 + 1);
}

// rf: (frames, rows, cols); coords: (2, n_pix) [map_row, map_col]; out: (frames, n_pix)
__global__ void __launch_bounds__(THREADS)
scan_convert_kernel(const float* __restrict__ rf, int rows, int cols,
                    const float* __restrict__ coords, int n_pix, float* __restrict__ out) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= n_pix) return;
  const size_t frame = blockIdx.y;
  out[frame * n_pix + p] = pixel(rf + frame * rows * cols, rows, cols, __ldg(coords + p),
                                 __ldg(coords + n_pix + p));
}

}  // namespace

// rf (frames, rows, cols); coords (2, n_pix) = the (map_row, map_col) of the
// n_pix = out_rows * out_cols output pixels; out (frames, n_pix). *blocks
// gets the grid.
extern "C" int mcray_scan_convert(const float* rf, int rows, int cols, int frames,
                                  const float* coords, int n_pix, float* out, int* blocks,
                                  cudaStream_t stream) {
  *blocks = 0;
  if (frames > 65535) return (int)cudaErrorInvalidValue;
  if (n_pix > 0 && frames > 0) {
    const dim3 grid((unsigned)((n_pix + (long long)THREADS - 1) / THREADS), frames);
    scan_convert_kernel<<<grid, THREADS, 0, stream>>>(rf, rows, cols, coords, n_pix, out);
    *blocks = (int)(grid.x * grid.y);
  }
  return (int)cudaGetLastError();
}
