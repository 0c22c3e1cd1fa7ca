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
//
// Frames. A batch of F images (F, R, C) is one launch: blockIdx.y is the
// frame, and a block reads, writes and (SLAB) keeps its buffers at its own
// frame's offset, so a strip's lateral halo never reaches into the next
// frame's columns and each frame's write window is its own.
//
// Any height. A lane's run of rows keeps its peaks in a 32-bit mask up to
// MAX_RUN rows, 32 x MAX_RUN = 992 rows a column. A taller column is a
// separate instance (TALL): a lane's run is longer, its first and last peak
// go into the same two scans, the next peak after each of its rows is
// written walking the run backward (into the spent axial sums) and the
// previous one carried walking it forward; every row's lerp is the same
// expression. Where the strip's buffers do not fit a block's shared memory
// (~1,600 rows at 13 lateral taps), a third instance (SLAB) keeps them in a
// slab of device memory per block that the wrapper allocates: slower, the
// same result. Each instance has one envelope path and no loop around its
// shuffles: a version that looped over 992-row chunks with the scans inside
// the loop faulted with an illegal address on the H100 at every launch, one
// chunk too, unless built with -G.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int STRIP = 4;       // columns per block: 128 blocks at 512 columns
constexpr int THREADS = 512;   // per block: loads in flight for phases 1, 2 and 4
constexpr int MAX_TAPS = 64;   // axial + lateral taps staged in shared memory
constexpr int MAX_RUN = 31;    // rows per lane: odd, and a run's peaks fit a 32-bit mask
constexpr int NO_PEAK = INT_MAX;
constexpr unsigned FULL = 0xffffffffu;

// floats of the strip's buffers: raw and axial sums over the strip and its
// halo, the convolved strip
__host__ __device__ inline size_t strip_floats(int rows, int l) {
  return (size_t)(3 * STRIP + 2 * (l - 1)) * (rows | 1);
}

// a peak fires at row j (1 <= j <= rows - 2) when col[j-1] < col[j] >= col[j+1]
__device__ __forceinline__ bool is_peak(const float* col, int j) {
  return col[j - 1] < col[j] && !(col[j] < col[j + 1]);
}

// `before` (a lane's last peak, or -1) becomes the last peak of the lower
// lanes' runs, `after` (its first, or NO_PEAK) the first of the higher lanes':
// an inclusive max / min scan over the warp, shifted by one lane
__device__ __forceinline__ void scan_neighbours(int lane, int& before, int& after) {
  for (int off = 1; off < 32; off <<= 1) {
    const int b = __shfl_up_sync(FULL, before, off);
    const int f = __shfl_down_sync(FULL, after, off);
    if (lane >= off) before = max(before, b);
    if (lane + off < 32) after = min(after, f);
  }
  before = __shfl_up_sync(FULL, before, 1);
  after = __shfl_down_sync(FULL, after, 1);
  if (lane == 0) before = -1;
  if (lane == 31) after = NO_PEAK;
}

// row j's envelope from its previous peak (or -1) and its next (or NO_PEAK),
// in the expression and operand order of imaging.envelope
__device__ __forceinline__ float lerp_row(const float* col, int j, int prev, int next) {
  if (next == NO_PEAK) return col[j];
  const int prev_pos = max(prev, 0);
  const float prev_val = prev < 0 ? col[0] : fabsf(col[prev]);
  const float next_val = fabsf(col[next]);
  const float alpha = (float)(j - prev_pos) / (float)max(next - prev_pos, 1);
  return prev_val * (1.0f - alpha) + next_val * alpha;
}

// TALL: more than MAX_RUN rows per lane. SLAB: the strip's buffers in
// `slab` (device memory, strip_floats floats per block) instead of shared
// memory. Separate instances: each carries one envelope path.
template <bool TALL, bool SLAB>
__global__ void __launch_bounds__(THREADS)
postproc_kernel(const float* __restrict__ rf, int rows, int cols, const float* __restrict__ ax,
                int a, const float* __restrict__ lat, int l, int do_conv,
                float* __restrict__ slab, float* __restrict__ out) {
  extern __shared__ float smem[];
  const size_t frame_off = (size_t)blockIdx.y * rows * cols;
  rf += frame_off;
  out += frame_off;
  __shared__ float taps[MAX_TAPS];  // [a] axial, then [l] lateral
  const int pitch = rows | 1;
  const int halo = do_conv ? STRIP + l - 1 : STRIP;  // columns loaded
  const size_t block = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  float* raw = SLAB ? slab + block * strip_floats(rows, l) : smem;  // [halo][pitch]; later the result
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
    if (!TALL) {
      unsigned peaks = 0u;  // bit k: a peak at row lo + k
      for (int j = max(lo, 1); j < min(hi, rows - 1); ++j)
        if (is_peak(col, j)) peaks |= 1u << (j - lo);
      // last peak at or before the end of each lower lane's run; first peak in the higher lanes'
      int before = peaks ? lo + 31 - __clz(peaks) : -1;
      int after = peaks ? lo + __ffs(peaks) - 1 : NO_PEAK;
      scan_neighbours(lane, before, after);
      for (int j = lo; j < hi; ++j) {
        const unsigned upto = (2u << (j - lo)) - 1u;  // bits of rows lo..j
        const unsigned le = peaks & upto, gt = peaks & ~upto;
        const int prev = le ? lo + 31 - __clz(le) : before;  // last peak at or before j, or -1
        const int next = gt ? lo + __ffs(gt) - 1 : after;    // first peak after j
        res[j] = lerp_row(col, j, prev, next);
      }
    } else {
      // a run's peaks no longer fit a mask: its first and last peak go into
      // the same scans, the next peak after each row is written walking the
      // run backward (into the spent axial sums), the previous one carried
      // walking it forward
      int* next_of = reinterpret_cast<int*>(axs + cl * pitch);
      int before = -1, after = NO_PEAK;
      for (int j = max(lo, 1); j < min(hi, rows - 1); ++j) {
        if (is_peak(col, j)) {
          after = min(after, j);
          before = j;
        }
      }
      scan_neighbours(lane, before, after);
      int next = after;
      for (int j = hi - 1; j >= lo; --j) {
        next_of[j] = next;
        if (j >= 1 && j < rows - 1 && is_peak(col, j)) next = j;
      }
      int prev = before;
      for (int j = lo; j < hi; ++j) {
        if (j >= 1 && j < rows - 1 && is_peak(col, j)) prev = j;
        res[j] = lerp_row(col, j, prev, next_of[j]);
      }
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

// Floats of device memory a launch over `frames` images needs for the
// strips' buffers: 0 where they fit a block's shared memory (max_shared
// bytes), else one slab per block of every frame.
extern "C" long long mcray_postproc_slab_floats(int rows, int cols, int frames, int l,
                                                int max_shared) {
  if (rows <= 0 || cols <= 0 || frames <= 0) return 0;
  const size_t floats = strip_floats(rows, l);
  if (floats * sizeof(float) + MAX_TAPS * sizeof(float) <= (size_t)max_shared) return 0;
  return (long long)(floats * ((cols + STRIP - 1) / STRIP) * frames);
}

// Raise the instance's dynamic shared-memory allowance where a launch needs
// more than it has on the current device, not at every launch.
template <bool TALL>
cudaError_t allow_shared(size_t smem) {
  static int allowed_on = -1;
  static size_t allowed = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != allowed_on || smem > allowed) {
    err = cudaFuncSetAttribute(postproc_kernel<TALL, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed_on = device;
    allowed = smem;
  }
  return cudaSuccess;
}

// rf, out (frames, rows, cols); ax (a,), lat (l,) taps, a + l <= MAX_TAPS.
// `slab`: mcray_postproc_slab_floats floats of device memory, or null where
// that is 0. `blocks` (host memory) receives the grid that was launched.
extern "C" int mcray_postproc(const float* rf, int rows, int cols, int frames, const float* ax,
                              int a, const float* lat, int l, int do_conv, float* slab,
                              float* out, int* blocks, cudaStream_t stream) {
  *blocks = 0;
  if (rows <= 0 || cols <= 0 || frames <= 0) return (int)cudaGetLastError();
  if (a + l > MAX_TAPS || frames > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + STRIP - 1) / STRIP, frames);
  const size_t smem = strip_floats(rows, l) * sizeof(float);
  const bool tall = rows > 32 * MAX_RUN;
  cudaError_t err = cudaSuccess;
  if (slab) {
    postproc_kernel<true, true><<<grid, THREADS, 0, stream>>>(rf, rows, cols, ax, a, lat, l,
                                                               do_conv, slab, out);
  } else if (tall) {
    if ((err = allow_shared<true>(smem)) != cudaSuccess) return (int)err;
    postproc_kernel<true, false><<<grid, THREADS, smem, stream>>>(rf, rows, cols, ax, a, lat, l,
                                                                  do_conv, nullptr, out);
  } else {
    if ((err = allow_shared<false>(smem)) != cudaSuccess) return (int)err;
    postproc_kernel<false, false><<<grid, THREADS, smem, stream>>>(rf, rows, cols, ax, a, lat,
                                                                   l, do_conv, nullptr, out);
  }
  *blocks = (int)(grid.x * grid.y);
  return (int)cudaGetLastError();
}
