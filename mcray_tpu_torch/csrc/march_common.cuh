// Shared by the march kernels (march.cu forward, march_bwd.cu backward): the
// segment SoA layout, the hashed scatterer field and its evaluation with
// partial derivatives, formula for formula what
// mcray_tpu/ops/pallas/march.py:_scat_eval computes, in every mode it has:
// bitsum or Box–Muller normals (_voxel_fields); any volume size (one AND for
// a power of two, the double mod otherwise); nearest or 8-corner trilinear
// lookup; hard or soft-sigmoid gate. Each mode is a template flag, so a
// kernel instance carries only the arithmetic of its own mode.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace march {

enum Field {
  F_FROM_X, F_FROM_Y, F_FROM_Z, F_DIR_X, F_DIR_Y, F_DIR_Z, F_T0, F_STEPS,
  F_LN_ATT, F_I0, F_MU0, F_MU1, F_SIGMA, F_B_ROW, F_B_VAL, F_VALID, N_FIELDS
};

// what the field evaluation needs besides the point and the material
struct Texture {
  uint32_t seed0, seed1;
  float res;           // voxel pitch [mm]
  int size;            // volume side
  float bitsum_scale;
  float tau;           // soft gate temperature
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

// (bits >> 8 + 0.5) / 2^24: a uniform in the open interval (0, 1)
__device__ __forceinline__ float open_unit(uint32_t bits) {
  return ((float)(bits >> 8) + 0.5f) * (1.0f / 16777216.0f);
}

// (noise, prob) of one wrapped voxel. The product for vid wraps in uint32,
// as the reference's does. Box–Muller uses the library's full-precision
// logf / sqrtf / cosf / sinf (no fast-math flag is passed to nvcc); they
// round as the card's PyTorch does, not as the CPU's or XLA's.
template <bool BOXMULLER>
__device__ __forceinline__ void voxel_fields(uint32_t ix, uint32_t iy, uint32_t iz,
                                             const Texture& tx, float& noise, float& prob) {
  const uint32_t vid = (ix * (uint32_t)tx.size + iy) * (uint32_t)tx.size + iz;
  const uint32_t b1 = hash_u32(vid ^ tx.seed0), b2 = hash_u32(vid ^ tx.seed1);
  if (BOXMULLER) {
    const float r = sqrtf(-2.0f * logf(open_unit(b1)));
    const float theta = 6.28318530717958647692f * open_unit(b2);  // 2 pi rounded to f32
    noise = r * cosf(theta);
    prob = r * sinf(theta);
  } else {
    noise = bitsum_normal(b1, tx.bitsum_scale);
    prob = bitsum_normal(b2, tx.bitsum_scale);
  }
}

// The voxel index wrapped into [0, size): texture._wrap_mod. For a power of
// two, two's-complement AND. Otherwise ((q % size) + size) % size on int,
// which is jnp.mod(jnp.mod(q, size) + size, size) for every q: C's %
// truncates toward zero, so q % size lies in (-size, size) and is congruent
// to q; adding size gives a value in (0, 2 size), still congruent; % of a
// non-negative value is its residue in [0, size). jnp.mod floors, so its
// mod(q, size) already lies in [0, size) and the rest keeps it. Both are
// the unique r in [0, size) with r = q (mod size).
template <bool POW2>
__device__ __forceinline__ uint32_t wrap_index(int q, int size) {
  if (POW2) return (uint32_t)(q & (size - 1));
  return (uint32_t)(((q % size) + size) % size);
}

// scat and, if GRADS, its partials w.r.t. mu0, mu1, sigma and the point
struct Scat {
  float scat, d_mu0, d_mu1, d_sigma, d_px, d_py, d_pz;
};

template <bool TRILINEAR, bool SOFT, bool BOXMULLER, bool POW2, bool GRADS>
__device__ __forceinline__ Scat scat_eval(float px, float py, float pz, float mu0, float mu1,
                                          float sigma, const Texture& tx) {
  float noise = 0.0f, prob = 0.0f;
  float dn[3] = {0.0f, 0.0f, 0.0f}, dp[3] = {0.0f, 0.0f, 0.0f};
  if (TRILINEAR) {
    const float p[3] = {px, py, pz};
    int i0[3];
    float w[3];
    for (int a = 0; a < 3; ++a) {
      const float f = p[a] / tx.res - 0.5f;
      const float fl = floorf(f);
      i0[a] = (int)fl;
      w[a] = f - fl;
    }
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      const int ox = corner >> 2, oy = (corner >> 1) & 1, oz = corner & 1;
      float n_t, p_t;
      voxel_fields<BOXMULLER>(wrap_index<POW2>(i0[0] + ox, tx.size),
                              wrap_index<POW2>(i0[1] + oy, tx.size),
                              wrap_index<POW2>(i0[2] + oz, tx.size), tx, n_t, p_t);
      const float wfx = ox ? w[0] : 1.0f - w[0];
      const float wfy = oy ? w[1] : 1.0f - w[1];
      const float wfz = oz ? w[2] : 1.0f - w[2];
      const float wt = wfx * wfy * wfz;
      noise = noise + n_t * wt;
      prob = prob + p_t * wt;
      if (GRADS) {
        const float sx = ox ? 1.0f : -1.0f, sy = oy ? 1.0f : -1.0f, sz = oz ? 1.0f : -1.0f;
        dn[0] += n_t * sx * wfy * wfz;
        dn[1] += n_t * sy * wfx * wfz;
        dn[2] += n_t * sz * wfx * wfy;
        dp[0] += p_t * sx * wfy * wfz;
        dp[1] += p_t * sy * wfx * wfz;
        dp[2] += p_t * sz * wfx * wfy;
      }
    }
  } else {
    // C-style truncation of x / res, then the wrap (src/volume.h:52-54)
    voxel_fields<BOXMULLER>(wrap_index<POW2>((int)truncf(px / tx.res), tx.size),
                            wrap_index<POW2>((int)truncf(py / tx.res), tx.size),
                            wrap_index<POW2>((int)truncf(pz / tx.res), tx.size), tx, noise,
                            prob);
  }

  const float value = noise * sigma + mu0;
  float gate, dgate = 0.0f;
  if (SOFT) {
    gate = 1.0f / (1.0f + expf(-((prob - mu1) / tx.tau)));
    dgate = gate * (1.0f - gate) / tx.tau;
  } else {
    gate = prob >= mu1 ? 1.0f : 0.0f;
  }
  Scat s;
  s.scat = value * gate;
  s.d_mu0 = s.d_mu1 = s.d_sigma = s.d_px = s.d_py = s.d_pz = 0.0f;
  if (GRADS) {
    s.d_mu0 = gate;
    s.d_sigma = noise * gate;
    if (SOFT) s.d_mu1 = -value * dgate;
    if (TRILINEAR) {
      const float d_noise = sigma * gate;
      const float d_prob = value * dgate;
      float g[3];
      for (int a = 0; a < 3; ++a) {
        g[a] = d_noise * dn[a];
        if (SOFT) g[a] = g[a] + d_prob * dp[a];
        g[a] = g[a] / tx.res;
      }
      s.d_px = g[0];
      s.d_py = g[1];
      s.d_pz = g[2];
    }
  }
  return s;
}

// Run CALL(TRILINEAR, SOFT, BOXMULLER, POW2) with the instance the flags select.
#define MARCH_DISPATCH_MODES(trilinear, soft, boxmuller, pow2, CALL)                          \
  do {                                                                                        \
    switch (((trilinear) ? 8 : 0) | ((soft) ? 4 : 0) | ((boxmuller) ? 2 : 0) | ((pow2) ? 1 : 0)) { \
      case 0: CALL(false, false, false, false); break;                                         \
      case 1: CALL(false, false, false, true); break;                                          \
      case 2: CALL(false, false, true, false); break;                                          \
      case 3: CALL(false, false, true, true); break;                                           \
      case 4: CALL(false, true, false, false); break;                                          \
      case 5: CALL(false, true, false, true); break;                                           \
      case 6: CALL(false, true, true, false); break;                                           \
      case 7: CALL(false, true, true, true); break;                                            \
      case 8: CALL(true, false, false, false); break;                                          \
      case 9: CALL(true, false, false, true); break;                                           \
      case 10: CALL(true, false, true, false); break;                                          \
      case 11: CALL(true, false, true, true); break;                                           \
      case 12: CALL(true, true, false, false); break;                                          \
      case 13: CALL(true, true, false, true); break;                                           \
      case 14: CALL(true, true, true, false); break;                                           \
      default: CALL(true, true, true, true); break;                                            \
    }                                                                                         \
  } while (0)

}  // namespace march
