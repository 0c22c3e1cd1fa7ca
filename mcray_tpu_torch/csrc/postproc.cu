// K3: reference PSF convolution fused with the peak-lerp envelope.
//
// Replaces mcray_tpu/ops/pallas/postproc.py:_postproc_kernel. One block per
// 32 columns (blockDim 32 x 8):
//   phase 1: all threads convolve their columns' cells in parallel into
//            `out` — inside the write window [A, R-A) x [L/2, C-L) the
//            forward-shifted separable sum (taps summed k = 0..A-1 axially,
//            then 0..L-1 laterally, the reference's order), outside it the
//            raw value;
//   phase 2: one thread per column walks the rows in order and rewrites
//            them with the envelope: a peak fires at row i when
//            x[i-1] < x[i] >= x[i+1]; rows between two peaks lerp between
//            |x| at them, rows before the first peak lerp from the raw x[0],
//            rows after the last peak keep their raw value.
// The walk writes only rows below the current peak, which it never reads
// again, so it works in place. Bound: the serial walk (R dependent steps
// per column); the convolution is spread over all 8 row lanes.

#include <cuda_runtime.h>

namespace {

constexpr int COLS = 32;
constexpr int ROW_LANES = 8;

__global__ void postproc_kernel(const float* __restrict__ rf, int rows, int cols,
                                const float* __restrict__ ax, int a,
                                const float* __restrict__ lat, int l, int do_conv,
                                float* __restrict__ out) {
  const int c = blockIdx.x * COLS + threadIdx.x;
  const bool col_ok = c < cols;

  // phase 1: convolution (or the raw value) of every cell of this column
  if (col_ok) {
    const bool col_in = do_conv && c >= l / 2 && c < cols - l;
    for (int r = threadIdx.y; r < rows; r += ROW_LANES) {
      float x = rf[(size_t)r * cols + c];
      if (col_in && r >= a && r < rows - a) {
        float acc = 0.0f;
        for (int k = 0; k < l; ++k) {
          float ax_sum = 0.0f;
          for (int j = 0; j < a; ++j) ax_sum = ax_sum + rf[(size_t)(r + j) * cols + c + k] * ax[j];
          acc = acc + ax_sum * lat[k];
        }
        x = acc;
      }
      out[(size_t)r * cols + c] = x;
    }
  }
  __syncthreads();

  // phase 2: the envelope walk, one thread per column
  if (!col_ok || threadIdx.y != 0 || rows < 3) return;
  float* x = out + c;
  int prev_pos = 0;
  float prev_val = x[0];  // before the first peak: the raw first row
  int start = 0;          // first row not rewritten yet
  float xm = x[0], xc = x[(size_t)cols];
  for (int i = 1; i <= rows - 2; ++i) {
    const float xn = x[(size_t)(i + 1) * cols];
    if (xm < xc && !(xc < xn)) {
      const float next_val = fabsf(xc);
      const float denom = (float)max(i - prev_pos, 1);
      for (int j = start; j < i; ++j) {
        const float alpha = (float)(j - prev_pos) / denom;
        x[(size_t)j * cols] = prev_val * (1.0f - alpha) + next_val * alpha;
      }
      prev_pos = i;
      prev_val = next_val;
      start = i;
    }
    xm = xc;
    xc = xn;
  }
}

}  // namespace

extern "C" int mcray_postproc(const float* rf, int rows, int cols, const float* ax, int a,
                              const float* lat, int l, int do_conv, float* out,
                              cudaStream_t stream) {
  if (rows > 0 && cols > 0) {
    const dim3 block(COLS, ROW_LANES);
    const dim3 grid((cols + COLS - 1) / COLS);
    postproc_kernel<<<grid, block, 0, stream>>>(rf, rows, cols, ax, a, lat, l, do_conv, out);
  }
  return (int)cudaGetLastError();
}
