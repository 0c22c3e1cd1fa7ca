// K9: backward of the scan conversion — the transposed bilinear remap.
//
// Replaces mcray_tpu/ops/pallas/scanconv.py:_scanconv_bwd_kernel and
// _scanconv_banded_bwd_kernel (transposed one-hot matrix products there).
// The maps are static, so the host transposes them once into CSR form
// (ops/cuda/scanconv.py:invert_scan_table): for each RF cell the output
// pixels that read it, ascending, with the weights w_r * w_c the forward
// applied. One thread per RF cell sums w * g[pixel] over its list: a
// gather with one writer per cell and one summation order, no atomics.
//
// Bound: bytes — each (pixel, weight) pair is read once (8 bytes per tap,
// ~4 taps per output pixel) against one multiply-add; neighbouring cells
// read neighbouring stretches of the lists, the cotangent stays in L2.
//
// Tried on an H100 and left out: a block per 16 x 16 RF tile walking the box
// of B-mode pixels whose taps land in it, the taps computed from the two
// coordinate maps and binned by cell in shared memory (the same order, bit
// for bit, at about the bytes of the bound). It ran 40-59% slower at
// SimConfig() and 27x slower on a 400 x 500 image over 64 RF columns
// (PERF.md).
//
// Frames. A batch of F cotangents (F, n_pix) -> (F, n_cells) is one launch:
// blockIdx.y is the frame, and every frame walks the same lists.

#include <cuda_runtime.h>

namespace {

__global__ void scanconv_bwd_kernel(const int* __restrict__ row_ptr,
                                    const int* __restrict__ pixel,
                                    const float* __restrict__ weight,
                                    const float* __restrict__ g, int n_cells, int n_pix,
                                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_cells) return;
  const size_t frame = blockIdx.y;
  g += frame * n_pix;
  float acc = 0.0f;
  const int end = row_ptr[i + 1];
  for (int p = row_ptr[i]; p < end; ++p) acc = acc + weight[p] * g[pixel[p]];
  out[frame * n_cells + i] = acc;
}

}  // namespace

// g (frames, n_pix) B-mode cotangents -> out (frames, n_cells) RF gradients
extern "C" int mcray_scan_convert_bwd(const int* row_ptr, const int* pixel, const float* weight,
                                      const float* g, int n_cells, int n_pix, int frames,
                                      float* out, int* blocks, cudaStream_t stream) {
  *blocks = 0;
  if (frames > 65535) return (int)cudaErrorInvalidValue;
  if (n_cells > 0 && frames > 0) {
    const int block = 256;
    const dim3 grid((n_cells + block - 1) / block, frames);
    scanconv_bwd_kernel<<<grid, block, 0, stream>>>(row_ptr, pixel, weight, g, n_cells, n_pix,
                                                    out);
    *blocks = (int)(grid.x * grid.y);
  }
  return (int)cudaGetLastError();
}
