// K8: backward of the segment march — the RF cotangent (rf_rows, n_cols) to
// the gradient of the (SD, 16, C_pad) segment SoA.
//
// Replaces mcray_tpu/ops/pallas/march.py:_march_bwd_kernel. That kernel is
// output-stationary over (column tile, row tile) and accumulates into a
// revisited output block, which needs a sequential grid axis. Here the loop
// is segment-stationary: the gradient of segment sd in column c is a sum
// over that segment's own march steps, so one thread per (sd, c) walks
// k = 0 .. steps-1, bins t_k = t0 + k*dt into its row floor(t_k / rdt) with
// the forward's guards (k < steps, t_k < window, 0 <= row < rf_rows, valid),
// reads the cotangent at (row, c), re-evaluates the scatterer with its
// partials (march_common.cuh) and keeps the twelve sums in registers
// (from x/y/z, dir x/y/z, ln_att, I0, mu0, mu1, sigma, b_val); t0, steps,
// b_row and valid get zero. One writer per output element: no atomics, no
// second pass, one summation order (ascending k, i.e. ascending row).
//
// The walk visits exactly the (segment, row) pairs the forward's
// _match_rows matches: rows are strictly increasing in k (dt > rdt), the
// forward verifies its candidate k with this same binning formula, and
// -fmad=false keeps t_k and the quotient separately rounded in both.
//
// Bound: instruction issue, as the forward; SD x C threads (25,600 at full
// size) each walk up to window/dt steps, so the card is under-filled and
// the longest segment of a warp sets its time.

#include "march_common.cuh"

namespace {

using namespace march;

template <bool TRILINEAR, bool SOFT>
__global__ void march_bwd_kernel(const float* __restrict__ soa, const float* __restrict__ g,
                                 int sd, int c_pad, int n_cols, int rf_rows, Texture tx,
                                 float rdt, float dt, float t_window, float axres,
                                 float* __restrict__ gout) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= sd * c_pad) return;
  const int c = idx % c_pad;
  const int i = idx / c_pad;
  const float* f = soa + (size_t)i * N_FIELDS * c_pad + c;
  float* go = gout + (size_t)i * N_FIELDS * c_pad + c;

  float acc[N_FIELDS];
#pragma unroll
  for (int q = 0; q < N_FIELDS; ++q) acc[q] = 0.0f;

  if (c < n_cols) {
    const float t0 = f[F_T0 * c_pad];
    const float steps = f[F_STEPS * c_pad];
    const bool valid = f[F_VALID * c_pad] > 0.5f;
    if (valid) {
      const float fx = f[F_FROM_X * c_pad], fy = f[F_FROM_Y * c_pad], fz = f[F_FROM_Z * c_pad];
      const float dx = f[F_DIR_X * c_pad], dy = f[F_DIR_Y * c_pad], dz = f[F_DIR_Z * c_pad];
      const float lnatt = f[F_LN_ATT * c_pad], i0 = f[F_I0 * c_pad];
      const float mu0 = f[F_MU0 * c_pad], mu1 = f[F_MU1 * c_pad], sigma = f[F_SIGMA * c_pad];
      for (float k = 0.0f; k < steps; k += 1.0f) {
        const float t_k = t0 + k * dt;
        if (!(t_k < t_window)) break;  // t_k grows with k: no later step is inside
        const float row_f = floorf(t_k / rdt);
        if (!(row_f >= 0.0f && row_f < (float)rf_rows)) continue;
        const float gm = g[(size_t)(int)row_f * n_cols + c];
        const float scale = k * axres;
        const Scat s = scat_eval<TRILINEAR, SOFT, true>(
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
    // the boundary echo adds b_val at row b_row (-1: none), valid or not
    const float b_row = f[F_B_ROW * c_pad];
    if (b_row >= 0.0f && b_row < (float)rf_rows && b_row == floorf(b_row))
      acc[F_B_VAL] = g[(size_t)(int)b_row * n_cols + c];
  }
#pragma unroll
  for (int q = 0; q < N_FIELDS; ++q) go[q * c_pad] = acc[q];
}

}  // namespace

extern "C" int mcray_march_bwd(const float* soa, const float* g, int sd, int c_pad, int n_cols,
                               int rf_rows, uint32_t seed0, uint32_t seed1, float rdt, float dt,
                               float t_window, float axres, float res, int size,
                               float bitsum_scale, int trilinear, int soft, float tau,
                               float* gout, cudaStream_t stream) {
  const int n = sd * c_pad;
  if (n > 0) {
    const int block = 128;
    const int grid = (n + block - 1) / block;
    const Texture tx = {seed0, seed1, res, size, bitsum_scale, tau};
#define LAUNCH(TRI, SOFT)                                                                  \
  march_bwd_kernel<TRI, SOFT><<<grid, block, 0, stream>>>(soa, g, sd, c_pad, n_cols, rf_rows, \
                                                          tx, rdt, dt, t_window, axres, gout)
    MARCH_DISPATCH_MODES(trilinear, soft, LAUNCH);
#undef LAUNCH
  }
  return (int)cudaGetLastError();
}
