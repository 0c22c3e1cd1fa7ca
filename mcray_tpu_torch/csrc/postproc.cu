// K3: reference PSF convolution fused with the peak-lerp envelope.
//
// Replaces mcray_tpu/ops/pallas/postproc.py:_postproc_kernel. The function:
// inside the write window [A, R-A) x [L/2, C-L) the forward-shifted
// separable sum (taps summed j = 0..A-1 axially, then k = 0..L-1 laterally,
// the reference's order), outside it the raw value; then per column the
// envelope: a peak fires at row i when x[i-1] < x[i] >= x[i+1] (on a plateau
// at its first row); rows between two peaks lerp between |x| at them, rows
// before the first peak lerp from the raw x[0], rows after the last peak
// keep their value.
//
// Bound on the card: by bytes, 2 x 4 x R x C over the memory rate (0.6 us
// at 465 x 512), so what is left is latency: the kernel has to be a few
// short parallel phases with the image touched once in device memory.
// A block owns a strip of STRIP whole columns (the envelope needs all R
// rows of a column) and works in shared memory, column-major with an odd
// pitch so that neighbouring rows and neighbouring columns fall on
// different banks:
//   1. load the strip and its L-1 columns of lateral halo, once, row-wise
//      from device memory;
//   2. axial sums of every cell of strip and halo (A products), then the
//      lateral sums of the strip's cells over them (L products): A + L
//      products per cell in the reference's order of additions, so the
//      convolved values equal the direct A x L sum's bit for bit;
//   3. the envelope as two scans, not a walk: a warp per column (the
//      block's first STRIP warps; all THREADS share phases 1, 2 and 4), each lane
//      a run of consecutive rows whose peaks it keeps as a bit mask; the
//      last peak before a lane's run is an inclusive max over the lower
//      lanes (__shfl_up_sync), the first peak after it a min over the
//      higher lanes (__shfl_down_sync); then every row finds its previous
//      and next peak with one clz / ffs and computes its lerp on its own,
//      in the expression and operand order of imaging.envelope;
//   4. one row-wise write of the strip.
// The convolved image never goes to device memory.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int STRIP = 4;       // columns per block: 128 blocks at 512 columns
constexpr int THREADS = 512;   // per block: loads in flight for phases 1, 2 and 4
constexpr int MAX_TAPS = 64;   // axial + lateral taps staged in shared memory
constexpr int MAX_RUN = 31;    // rows per lane: odd, and a run's peaks fit a 32-bit mask
constexpr int NO_PEAK = INT_MAX;

__global__ void __launch_bounds__(THREADS)
postproc_kernel(const float* __restrict__ rf, int rows, int cols, const float* __restrict__ ax,
                int a, const float* __restrict__ lat, int l, int do_conv,
                float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float taps[MAX_TAPS];  // [a] axial, then [l] lateral
  const int pitch = rows | 1;
  const int halo = do_conv ? STRIP + l - 1 : STRIP;  // columns loaded
  float* raw = smem;                                 // [halo][pitch]; later the strip's result
  float* axs = raw + (size_t)(STRIP + l - 1) * pitch;  // [halo][pitch] axial sums
  float* x = axs + (size_t)(STRIP + l - 1) * pitch;    // [STRIP][pitch] convolved strip
  const int c0 = blockIdx.x * STRIP;
  const int tid = threadIdx.x, n_thr = blockDim.x;

  // 1. the strip and its halo
  if (tid < a + l) taps[tid] = tid < a ? ax[tid] : lat[tid - a];
#pragma unroll 4
  for (int k = tid; k < rows * halo; k += n_thr) {
    const int r = k / halo, cc = k - r * halo;
    if (c0 + cc < cols) raw[cc * pitch + r] = rf[(size_t)r * cols + c0 + cc];
  }
  __syncthreads();

  // 2. axial sums for rows [a, rows - a), then the lateral sums over them
  if (do_conv) {
    const int nr = rows - 2 * a;
    for (int k = tid; k < nr * halo; k += n_thr) {
      const int cc = k / nr, r = a + (k - cc * nr);
      if (c0 + cc < cols) {
        float ax_sum = 0.0f;
        for (int j = 0; j < a; ++j) ax_sum = ax_sum + raw[cc * pitch + r + j] * taps[j];
        axs[cc * pitch + r] = ax_sum;
      }
    }
    __syncthreads();
  }
  for (int k = tid; k < rows * STRIP; k += n_thr) {
    const int cl = k / rows, r = k - cl * rows;
    const int c = c0 + cl;
    if (c >= cols) continue;
    float v = raw[cl * pitch + r];
    if (do_conv && c >= l / 2 && c < cols - l && r >= a && r < rows - a) {
      float acc = 0.0f;
      for (int kk = 0; kk < l; ++kk) acc = acc + axs[(cl + kk) * pitch + r] * taps[a + kk];
      v = acc;
    }
    x[cl * pitch + r] = v;
  }
  __syncthreads();

  // 3. the envelope: warp `cl` takes column c0 + cl, lane `lane` rows [lo, hi)
  const int cl = tid / 32, lane = tid % 32;
  if (cl < STRIP && c0 + cl < cols) {
    const float* col = x + cl * pitch;
    float* res = raw + cl * pitch;
    int run = (rows + 31) / 32;
    run |= 1;  // odd: the lanes' rows fall on different banks
    const int lo = min(lane * run, rows), hi = min(lo + run, rows);
    unsigned peaks = 0u;  // bit k: a peak at row lo + k
    for (int j = max(lo, 1); j < min(hi, rows - 1); ++j)
      if (col[j - 1] < col[j] && !(col[j] < col[j + 1])) peaks |= 1u << (j - lo);
    // last peak at or before the end of each lower lane's run; first peak in the higher lanes'
    int before = peaks ? lo + 31 - __clz(peaks) : -1;
    int after = peaks ? lo + __ffs(peaks) - 1 : NO_PEAK;
    for (int off = 1; off < 32; off <<= 1) {
      const int b = __shfl_up_sync(0xffffffffu, before, off);
      const int f = __shfl_down_sync(0xffffffffu, after, off);
      if (lane >= off) before = max(before, b);
      if (lane + off < 32) after = min(after, f);
    }
    before = __shfl_up_sync(0xffffffffu, before, 1);
    after = __shfl_down_sync(0xffffffffu, after, 1);
    if (lane == 0) before = -1;
    if (lane == 31) after = NO_PEAK;
    for (int j = lo; j < hi; ++j) {
      const unsigned upto = (2u << (j - lo)) - 1u;  // bits of rows lo..j
      const unsigned le = peaks & upto, gt = peaks & ~upto;
      const int prev = le ? lo + 31 - __clz(le) : before;  // last peak at or before j, or -1
      const int next = gt ? lo + __ffs(gt) - 1 : after;    // first peak after j
      float v = col[j];
      if (next != NO_PEAK) {
        const int prev_pos = max(prev, 0);
        const float prev_val = prev < 0 ? col[0] : fabsf(col[prev]);
        const float next_val = fabsf(col[next]);
        const float alpha = (float)(j - prev_pos) / (float)max(next - prev_pos, 1);
        v = prev_val * (1.0f - alpha) + next_val * alpha;
      }
      res[j] = v;
    }
  }
  __syncthreads();

  // 4. the strip, row-wise
  for (int k = tid; k < rows * STRIP; k += n_thr) {
    const int r = k / STRIP, cc = k % STRIP;
    if (c0 + cc < cols) out[(size_t)r * cols + c0 + cc] = raw[cc * pitch + r];
  }
}

}  // namespace

// rf, out (rows, cols); ax (a,), lat (l,) taps. rows <= 32 * MAX_RUN,
// a + l <= MAX_TAPS, and rows x (3 STRIP + 2 l - 2) floats of shared memory
// must fit a block. `blocks` (host memory) receives the grid that was
// launched.
extern "C" int mcray_postproc(const float* rf, int rows, int cols, const float* ax, int a,
                              const float* lat, int l, int do_conv, float* out, int* blocks,
                              cudaStream_t stream) {
  *blocks = 0;
  if (rows <= 0 || cols <= 0) return (int)cudaGetLastError();
  if (rows > 32 * MAX_RUN || a + l > MAX_TAPS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(3 * STRIP + 2 * (l - 1)) * (rows | 1) * sizeof(float);
  // the kernel's shared-memory allowance is raised where a launch needs more
  // than it has on the current device, not at every launch
  static int allowed_on = -1;
  static size_t allowed = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != allowed_on || smem > allowed) {
    err = cudaFuncSetAttribute(postproc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed_on = device;
    allowed = smem;
  }
  const int grid = (cols + STRIP - 1) / STRIP;
  postproc_kernel<<<grid, THREADS, smem, stream>>>(rf, rows, cols, ax, a, lat, l, do_conv, out);
  *blocks = grid;
  return (int)cudaGetLastError();
}
