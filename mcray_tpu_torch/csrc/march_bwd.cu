// K8: backward of the segment march — the RF cotangent (rf_rows, n_cols) to
// the gradient of the (SD, 16, C_pad) segment SoA.
//
// Replaces mcray_tpu/ops/pallas/march.py:_march_bwd_kernel. That kernel is
// output-stationary over (column tile, row tile) and accumulates into a
// revisited output block, which needs a sequential grid axis. Here the loop
// is segment-stationary: the gradient of segment sd in column c is a sum
// over that segment's own march steps k = 0 .. steps-1, each binned into
// its row floor(t_k / rdt) with the forward's guards (k < steps, t_k <
// window, 0 <= row < rf_rows, valid); the step reads the cotangent at (row,
// c), re-evaluates the scatterer with its partials (march_common.cuh) and
// adds to twelve sums (from x/y/z, dir x/y/z, ln_att, I0, mu0, mu1, sigma,
// b_val); t0, steps, b_row and valid get zero.
//
// The walk visits exactly the (segment, row) pairs the forward's
// _match_rows matches: rows are strictly increasing in k (dt > rdt), the
// forward verifies its candidate k with this same binning formula, and
// -fmad=false keeps t_k and the quotient separately rounded in both.
//
// Bound on the card: instruction issue (per step in trilinear mode sixteen
// hashes, the normals and the partials), and before this design latency:
// one thread per (segment, column) walked up to window/dt steps alone, 800
// warps on 132 SMs, and the longest segment of a warp set its time. Now a
// group of LANES threads (a warp) shares one (segment, column): lane j walks
// k = j, j + LANES, ..., so a segment's steps spread over the group, and a
// block holds THREADS / LANES neighbouring columns of one segment index
// (the same sample and bounce, so similar step counts). The group's twelve
// sums are reduced in one fixed order — each lane's own in ascending k,
// then an xor butterfly of shuffles, in which both partners of a pair add
// the same two values, so every lane ends with the same total — and one
// lane per column puts them in shared memory; the block writes each field
// as consecutive floats. One writer per output element, no atomics, no
// second pass. The per-field sums run in another order than before and
// than march_bwd_plain's row reduction: a tolerance, not bitwise.
// Chosen on an H100 from 8, 16 and 32 lanes per (segment, column): 32, a
// warp per segment and column (3,200 blocks of 256 threads at full width),
// was the fastest (8 lanes 1.5x, 16 lanes 1.1x its time).

#include "march_common.cuh"

namespace {

using namespace march;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;           // per block
constexpr int LANES = 32;              // per (segment, column); a power of two, <= 32
constexpr int COLS = THREADS / LANES;  // columns per block

template <bool TRILINEAR, bool SOFT, bool BOXMULLER, bool POW2>
__global__ void __launch_bounds__(THREADS)
march_bwd_kernel(const float* __restrict__ soa, const float* __restrict__ g, int sd, int c_pad,
                 int n_cols, int rf_rows, Texture tx, float rdt, float dt, float t_window,
                 float axres, float* __restrict__ gout) {
  __shared__ float sums[N_FIELDS][COLS];
  const int group = threadIdx.x / LANES, sub = threadIdx.x % LANES;
  const int i = blockIdx.y;
  const int c0 = blockIdx.x * COLS, c = c0 + group;
  const float* f = soa + (size_t)i * N_FIELDS * c_pad + c;

  float acc[N_FIELDS];
#pragma unroll
  for (int q = 0; q < N_FIELDS; ++q) acc[q] = 0.0f;

  if (c < n_cols && f[F_VALID * c_pad] > 0.5f) {
    const float t0 = f[F_T0 * c_pad];
    const float steps = f[F_STEPS * c_pad];
    const float fx = f[F_FROM_X * c_pad], fy = f[F_FROM_Y * c_pad], fz = f[F_FROM_Z * c_pad];
    const float dx = f[F_DIR_X * c_pad], dy = f[F_DIR_Y * c_pad], dz = f[F_DIR_Z * c_pad];
    const float lnatt = f[F_LN_ATT * c_pad], i0 = f[F_I0 * c_pad];
    const float mu0 = f[F_MU0 * c_pad], mu1 = f[F_MU1 * c_pad], sigma = f[F_SIGMA * c_pad];
    for (float k = (float)sub; k < steps; k += (float)LANES) {
      const float t_k = t0 + k * dt;
      if (!(t_k < t_window)) break;  // t_k grows with k: no later step is inside
      const float row_f = floorf(t_k / rdt);
      if (!(row_f >= 0.0f && row_f < (float)rf_rows)) continue;
      const float gm = g[(size_t)(int)row_f * n_cols + c];
      const float scale = k * axres;
      const Scat s = scat_eval<TRILINEAR, SOFT, BOXMULLER, POW2, true>(
          fx + scale * dx, fy + scale * dy, fz + scale * dz, mu0, mu1, sigma, tx);
      const float decay = expf(lnatt * k);
      const float gi = gm * (i0 * decay);
      acc[F_I0] += gm * decay * s.scat;
      acc[F_LN_ATT] += gi * k * s.scat;
      acc[F_MU0] += gi * s.d_mu0;
      acc[F_MU1] += gi * s.d_mu1;
      acc[F_SIGMA] += gi * s.d_sigma;
      const float gpx = gi * s.d_px, gpy = gi * s.d_py, gpz = gi * s.d_pz;
      acc[F_FROM_X] += gpx;
      acc[F_FROM_Y] += gpy;
      acc[F_FROM_Z] += gpz;
      acc[F_DIR_X] += gpx * scale;
      acc[F_DIR_Y] += gpy * scale;
      acc[F_DIR_Z] += gpz * scale;
    }
  }
  // the group's sums (LANES is a power of two and divides 32: xor stays in the group)
#pragma unroll
  for (int off = LANES >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < N_FIELDS; ++q) acc[q] += __shfl_xor_sync(FULL, acc[q], off);
  }
  if (sub == 0) {
    // the boundary echo adds b_val at row b_row (-1: none), valid or not
    acc[F_B_VAL] = 0.0f;
    if (c < n_cols) {
      const float b_row = f[F_B_ROW * c_pad];
      if (b_row >= 0.0f && b_row < (float)rf_rows && b_row == floorf(b_row))
        acc[F_B_VAL] = g[(size_t)(int)b_row * n_cols + c];
    }
#pragma unroll
    for (int q = 0; q < N_FIELDS; ++q) sums[q][group] = acc[q];
  }
  __syncthreads();
  float* go = gout + (size_t)i * N_FIELDS * c_pad + c0;
  for (int k = threadIdx.x; k < N_FIELDS * COLS; k += THREADS) {
    const int q = k / COLS, cc = k - q * COLS;
    go[(size_t)q * c_pad + cc] = sums[q][cc];
  }
}

}  // namespace

// soa, gout (sd, 16, c_pad), c_pad a multiple of COLS; g (rf_rows,
// n_cols). `blocks` (host memory) receives the grid launched.
extern "C" int mcray_march_bwd(const float* soa, const float* g, int sd, int c_pad, int n_cols,
                               int rf_rows, uint32_t seed0, uint32_t seed1, float rdt, float dt,
                               float t_window, float axres, float res, int size,
                               float bitsum_scale, int trilinear, int soft, int boxmuller,
                               float tau, float* gout, int* blocks, cudaStream_t stream) {
  *blocks = 0;
  if (sd <= 0 || c_pad <= 0) return (int)cudaGetLastError();
  if (c_pad % COLS || size < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(c_pad / COLS, sd);
  const Texture tx = {seed0, seed1, res, size, bitsum_scale, tau};
  const bool pow2 = (size & (size - 1)) == 0;
#define LAUNCH(TRI, SOFT, BM, POW2)                                                            \
  march_bwd_kernel<TRI, SOFT, BM, POW2><<<grid, THREADS, 0, stream>>>(                         \
      soa, g, sd, c_pad, n_cols, rf_rows, tx, rdt, dt, t_window, axres, gout)
  MARCH_DISPATCH_MODES(trilinear, soft, boxmuller, pow2, LAUNCH);
#undef LAUNCH
  *blocks = (int)(grid.x * grid.y);
  return (int)cudaGetLastError();
}
