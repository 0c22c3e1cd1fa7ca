// K2: output-stationary segment march + RF accumulation.
//
// Replaces mcray_tpu/ops/pallas/march.py:_march_kernel. One thread per RF
// pixel (row r, column c), with c fastest in a warp so that the reads of
// the (SD, 16, C_pad) segment SoA coalesce. Each thread visits its column's
// SD segments in ascending order and, per segment:
//   1. finds the march step k whose row floor((t0 + k*dt)/rdt) is r, with
//      the reference's four-candidate check (_match_rows);
//   2. if one matches, evaluates the hashed scatterer field at that step
//      (march_common.cuh: bitsum normals; nearest voxel or 8-corner
//      trilinear lookup, hard or soft-sigmoid gate — the four modes the
//      reference's kernel computes) and adds I0 * exp(ln_att * k) * scat;
//   3. adds the segment's boundary echo if its row is r.
// One fixed accumulation order per pixel, no atomics.
//
// Bound: instruction issue (two 32-bit hashes, popcounts and ~40 f32 ops
// per matched step in nearest mode, eight times the hashing in trilinear
// mode); the (SD, 16, C_pad) SoA is re-read by every row of pixels and is
// small enough to stay in L2.
// Compiled with -fmad=false so the row match equals the plain version's.

#include "march_common.cuh"

namespace {

using namespace march;

template <bool TRILINEAR, bool SOFT>
__global__ void march_kernel(const float* __restrict__ soa, int sd, int c_pad, int n_cols,
                             int rf_rows, Texture tx, float rdt, float dt, float inv_a,
                             float t_window, float axres, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (c >= n_cols || r >= rf_rows) return;
  const float rows_f = (float)r;
  float acc = 0.0f;

  for (int i = 0; i < sd; ++i) {
    const float* f = soa + (size_t)i * N_FIELDS * c_pad + c;
    const float t0 = f[F_T0 * c_pad];
    const float steps = f[F_STEPS * c_pad];
    const bool valid = f[F_VALID * c_pad] > 0.5f;

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
      const Scat s = scat_eval<TRILINEAR, SOFT, false>(
          px, py, pz, f[F_MU0 * c_pad], f[F_MU1 * c_pad], f[F_SIGMA * c_pad], tx);
      const float intens = f[F_I0 * c_pad] * expf(f[F_LN_ATT * c_pad] * k_sel);
      acc = acc + intens * s.scat;
    }
    if (rows_f == f[F_B_ROW * c_pad]) acc = acc + f[F_B_VAL * c_pad];
  }
  out[(size_t)r * n_cols + c] = acc;
}

}  // namespace

extern "C" int mcray_march(const float* soa, int sd, int c_pad, int n_cols, int rf_rows,
                           uint32_t seed0, uint32_t seed1, float rdt, float dt, float inv_a,
                           float t_window, float axres, float res, int size,
                           float bitsum_scale, int trilinear, int soft, float tau, float* out,
                           cudaStream_t stream) {
  if (n_cols > 0 && rf_rows > 0) {
    const dim3 block(32, 8);
    const dim3 grid((n_cols + block.x - 1) / block.x, (rf_rows + block.y - 1) / block.y);
    const Texture tx = {seed0, seed1, res, size, bitsum_scale, tau};
#define LAUNCH(TRI, SOFT)                                                               \
  march_kernel<TRI, SOFT><<<grid, block, 0, stream>>>(soa, sd, c_pad, n_cols, rf_rows, tx, \
                                                      rdt, dt, inv_a, t_window, axres, out)
    MARCH_DISPATCH_MODES(trilinear, soft, LAUNCH);
#undef LAUNCH
  }
  return (int)cudaGetLastError();
}
