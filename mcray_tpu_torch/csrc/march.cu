// K2: output-stationary segment march + RF accumulation, span-listed.
//
// Replaces mcray_tpu/ops/pallas/march.py:_march_kernel together with the
// per-tile segment lists it is given (_touch_tables). For every RF pixel
// (row r, column c) and every segment of column c in ascending order:
//   1. find the march step k whose row floor((t0 + k*dt)/rdt) is r, with
//      the reference's four-candidate check (_match_rows);
//   2. if one matches, evaluate the hashed scatterer field at that step
//      (march_common.cuh, every mode of _scat_eval) and add
//      I0 * exp(ln_att * k) * scat;
//   3. add the segment's boundary echo if its row is r.
//
// Bound on the card: instruction issue — per matched step two 32-bit
// hashes per voxel (eight voxels in trilinear mode), the normals and ~40 f32
// operations; the (SD, 16, C_pad) SoA is small and stays in L2. A segment
// covers ~47 of 465 rows, so matching every (pixel, segment) pair, as this
// kernel did before, spent ~90% of its work on pairs with no step. The
// design does in the kernel what _touch_tables does in jnp:
//   - A warp owns one column and 32 x ROWS_PER_LANE consecutive rows (lane
//     j rows j and j + 32), so the segments it visits are the same for every
//     lane and their fields are read once per warp (one address for all
//     lanes).
//   - The warp builds its list itself: 32 segments at a time, lane j tests
//     segment base + j with the conservative span of _touch_tables,
//     floor(t0/rdt) - 1 .. floor((t0 + steps*dt)/rdt) + 1 (valid segments
//     only), or its boundary-echo row (any segment, as the plain version
//     adds it), against the warp's rows; a ballot gives the mask, and the
//     warp visits its set bits in ascending order. No host prepass and no
//     second launch.
//   - A block is WARPS neighbouring columns; the rows of the block's tile
//     go out through shared memory, WARPS consecutive floats per row.
// Chosen on an H100 from a sweep of columns per block {4, 8, 16} x rows per
// lane {1, 2}: 4 x 2 (1,024 blocks of 128 threads on the sphere frame) was
// the fastest on the frame and in the fit's soft + trilinear mode; 16
// columns per block was up to 60% slower.
// Bitwise what the kernel gave before the lists, and what march_plain gives:
// the span holds every row a matched step can land in (k >= 0 and k <
// steps, rounding is monotone, so t0 <= t_k <= t0 + steps*dt and the
// quotients and floors keep that order), and a segment that is skipped
// would have added exactly +0.0. The accumulator starts at +0.0 and can
// never be -0.0 (a sum with a +0.0 start rounds an exact zero to +0.0), so
// adding +0.0 leaves it unchanged bit for bit; the segments that are
// visited add in the same ascending order as before.
// Compiled with -fmad=false so the row match equals the plain version's.

#include "march_common.cuh"

namespace {

using namespace march;

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;              // columns per block, a warp each
constexpr int ROWS_PER_LANE = 2;      // a warp's rows: 32 x ROWS_PER_LANE

template <bool TRILINEAR, bool SOFT, bool BOXMULLER, bool POW2>
__global__ void __launch_bounds__(32 * WARPS)
march_kernel(const float* __restrict__ soa, int sd, int c_pad, int n_cols, int rf_rows, Texture tx,
             float rdt, float dt, float inv_a, float t_window, float axres,
             float* __restrict__ out) {
  __shared__ float tile[32 * ROWS_PER_LANE][WARPS + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * WARPS, c = c0 + warp;
  constexpr int rows_per_warp = 32 * ROWS_PER_LANE;
  const int r_lo = blockIdx.y * rows_per_warp;
  const float lo_f = (float)r_lo, hi_f = (float)(min(r_lo + rows_per_warp, rf_rows) - 1);
  float acc[ROWS_PER_LANE];
#pragma unroll
  for (int q = 0; q < ROWS_PER_LANE; ++q) acc[q] = 0.0f;

  if (c < n_cols) {  // the same for the whole warp
    const float* col = soa + c;
    for (int base = 0; base < sd; base += 32) {
      bool touch = false;
      if (base + lane < sd) {
        const float* f = col + (size_t)(base + lane) * N_FIELDS * c_pad;
        const float t0 = f[F_T0 * c_pad], steps = f[F_STEPS * c_pad];
        const float b_row = f[F_B_ROW * c_pad];
        const float first = floorf(t0 / rdt) - 1.0f;
        const float last = floorf((t0 + steps * dt) / rdt) + 1.0f;
        touch = (f[F_VALID * c_pad] > 0.5f && last >= lo_f && first <= hi_f) ||
                (b_row >= lo_f && b_row <= hi_f);
      }
      for (unsigned mask = __ballot_sync(FULL, touch); mask; mask &= mask - 1) {
        const float* f = col + (size_t)(base + __ffs(mask) - 1) * N_FIELDS * c_pad;
        const float t0 = f[F_T0 * c_pad];
        const float steps = f[F_STEPS * c_pad];
        const bool valid = f[F_VALID * c_pad] > 0.5f;
        const float b_row = f[F_B_ROW * c_pad];
#pragma unroll
        for (int q = 0; q < ROWS_PER_LANE; ++q) {
          const int r = r_lo + lane + 32 * q;
          if (r >= rf_rows) continue;
          const float rows_f = (float)r;
          const float k_guess = floorf((rows_f - t0 / rdt) * inv_a);
          float k_sel = 0.0f;
          bool matched = false;
          for (int cand = -1; cand <= 2; ++cand) {
            const float k = k_guess + (float)cand;
            const float t_k = t0 + k * dt;
            if (floorf(t_k / rdt) == rows_f && k >= 0.0f && k < steps && t_k < t_window) {
              k_sel = k;
              matched = true;
            }
          }
          if (matched && valid) {
            const float scale = k_sel * axres;
            const float px = f[F_FROM_X * c_pad] + scale * f[F_DIR_X * c_pad];
            const float py = f[F_FROM_Y * c_pad] + scale * f[F_DIR_Y * c_pad];
            const float pz = f[F_FROM_Z * c_pad] + scale * f[F_DIR_Z * c_pad];
            const Scat s = scat_eval<TRILINEAR, SOFT, BOXMULLER, POW2, false>(
                px, py, pz, f[F_MU0 * c_pad], f[F_MU1 * c_pad], f[F_SIGMA * c_pad], tx);
            const float intens = f[F_I0 * c_pad] * expf(f[F_LN_ATT * c_pad] * k_sel);
            acc[q] = acc[q] + intens * s.scat;
          }
          if (rows_f == b_row) acc[q] = acc[q] + f[F_B_VAL * c_pad];
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < ROWS_PER_LANE; ++q) tile[lane + 32 * q][warp] = acc[q];
  __syncthreads();
  for (int k = threadIdx.x; k < rows_per_warp * WARPS; k += 32 * WARPS) {
    const int rr = k / WARPS, cc = k - rr * WARPS;
    const int r = r_lo + rr;
    if (r < rf_rows && c0 + cc < n_cols) out[(size_t)r * n_cols + c0 + cc] = tile[rr][cc];
  }
}

}  // namespace

// soa (sd, 16, c_pad); out (rf_rows, n_cols). `blocks` (host memory)
// receives the grid that was launched.
extern "C" int mcray_march(const float* soa, int sd, int c_pad, int n_cols, int rf_rows,
                           uint32_t seed0, uint32_t seed1, float rdt, float dt, float inv_a,
                           float t_window, float axres, float res, int size,
                           float bitsum_scale, int trilinear, int soft, int boxmuller, float tau,
                           float* out, int* blocks, cudaStream_t stream) {
  *blocks = 0;
  if (n_cols <= 0 || rf_rows <= 0) return (int)cudaGetLastError();
  if (size < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_cols + WARPS - 1) / WARPS,
                  (rf_rows + 32 * ROWS_PER_LANE - 1) / (32 * ROWS_PER_LANE));
  const Texture tx = {seed0, seed1, res, size, bitsum_scale, tau};
  const bool pow2 = (size & (size - 1)) == 0;
#define LAUNCH(TRI, SOFT, BM, POW2)                                                          \
  march_kernel<TRI, SOFT, BM, POW2><<<grid, 32 * WARPS, 0, stream>>>(                        \
      soa, sd, c_pad, n_cols, rf_rows, tx, rdt, dt, inv_a, t_window, axres, out)
  MARCH_DISPATCH_MODES(trilinear, soft, boxmuller, pow2, LAUNCH);
#undef LAUNCH
  *blocks = (int)(grid.x * grid.y);
  return (int)cudaGetLastError();
}
