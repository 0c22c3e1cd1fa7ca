// K2: output-stationary segment march + RF accumulation.
//
// Replaces mcray_tpu/ops/pallas/march.py:_march_kernel. One thread per RF
// pixel (row r, column c), with c fastest in a warp so that the reads of
// the (SD, 16, C_pad) segment SoA coalesce. Each thread visits its column's
// SD segments in ascending order and, per segment:
//   1. finds the march step k whose row floor((t0 + k*dt)/rdt) is r, with
//      the reference's four-candidate check (_match_rows);
//   2. if one matches, evaluates the hashed scatterer field at that step
//      (bitsum normals, nearest voxel, hard gate) and adds
//      I0 * exp(ln_att * k) * scat;
//   3. adds the segment's boundary echo if its row is r.
// One fixed accumulation order per pixel, no atomics.
//
// Bound: instruction issue (two 32-bit hashes, popcounts and ~40 f32 ops
// per matched step); the (SD, 16, C_pad) SoA is re-read by every row of
// pixels and is small enough to stay in L2.
// Compiled with -fmad=false so the row match equals the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Field {
  F_FROM_X, F_FROM_Y, F_FROM_Z, F_DIR_X, F_DIR_Y, F_DIR_Z, F_T0, F_STEPS,
  F_LN_ATT, F_I0, F_MU0, F_MU1, F_SIGMA, F_B_ROW, F_B_VAL, F_VALID, N_FIELDS
};

// lowbias32, bit-identical to mcray_tpu.ops.texture.hash_u32
__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// dithered binomial ~N(0,1): popcount of the high 16 bits + 16-bit dither
__device__ __forceinline__ float bitsum_normal(uint32_t bits, float scale) {
  const float pc = (float)__popc(bits >> 16);
  const float u = ((float)(bits & 0xFFFFu) + 0.5f) * (1.0f / 65536.0f);
  return (pc + u - 8.5f) * scale;
}

__device__ __forceinline__ uint32_t wrap_index(float x, float res, int size) {
  return (uint32_t)((int)truncf(x / res) & (size - 1));
}

__global__ void march_kernel(const float* __restrict__ soa, int sd, int c_pad, int n_cols,
                             int rf_rows, uint32_t seed0, uint32_t seed1, float rdt,
                             float dt, float inv_a, float t_window, float axres, float res,
                             int size, float bitsum_scale, float* __restrict__ out) {
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
      const uint32_t vid =
          (wrap_index(px, res, size) * (uint32_t)size + wrap_index(py, res, size)) *
              (uint32_t)size +
          wrap_index(pz, res, size);
      const float noise = bitsum_normal(hash_u32(vid ^ seed0), bitsum_scale);
      const float prob = bitsum_normal(hash_u32(vid ^ seed1), bitsum_scale);
      const float value = noise * f[F_SIGMA * c_pad] + f[F_MU0 * c_pad];
      const float scat = prob >= f[F_MU1 * c_pad] ? value : 0.0f;
      const float intens = f[F_I0 * c_pad] * expf(f[F_LN_ATT * c_pad] * k_sel);
      acc = acc + intens * scat;
    }
    if (rows_f == f[F_B_ROW * c_pad]) acc = acc + f[F_B_VAL * c_pad];
  }
  out[(size_t)r * n_cols + c] = acc;
}

}  // namespace

extern "C" int mcray_march(const float* soa, int sd, int c_pad, int n_cols, int rf_rows,
                           uint32_t seed0, uint32_t seed1, float rdt, float dt, float inv_a,
                           float t_window, float axres, float res, int size,
                           float bitsum_scale, float* out, cudaStream_t stream) {
  if (n_cols > 0 && rf_rows > 0) {
    const dim3 block(32, 8);
    const dim3 grid((n_cols + block.x - 1) / block.x, (rf_rows + block.y - 1) / block.y);
    march_kernel<<<grid, block, 0, stream>>>(soa, sd, c_pad, n_cols, rf_rows, seed0, seed1,
                                             rdt, dt, inv_a, t_window, axres, res, size,
                                             bitsum_scale, out);
  }
  return (int)cudaGetLastError();
}
