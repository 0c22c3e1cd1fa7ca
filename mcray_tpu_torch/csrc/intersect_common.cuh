// Device helpers shared by the cluster closest-hit kernels (K5, K6, K7, K10).
//
// The arithmetic is written in the order of the port's plain versions
// (ops/geometry.py:_moller_trumbore, ops/clusters.py:box_active), as K1's
// (intersect.cu) is, and the library is built with -fmad=false, so every
// t, slab bound and winner equals the plain PyTorch version's bit for bit.
// K1 keeps its own loop: moved onto these helpers it ran 2.7-10% slower on
// an H100 (runtime row stride and tile-load division).

#pragma once

#include <cuda_runtime.h>

namespace mcray {

constexpr float NO_HIT_T = 2.0f;
constexpr float DET_EPS = 1e-9f;

struct Ray {
  float ox, oy, oz, sx, sy, sz;
};

// rays: (6, n) rows [origin xyz, segment xyz]
__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int n, int i) {
  return Ray{rays[0 * n + i], rays[1 * n + i], rays[2 * n + i],
             rays[3 * n + i], rays[4 * n + i], rays[5 * n + i]};
}

// The slab test's inverse direction: 1/c, or 1e30 where |c| <= 1e-30.
__device__ __forceinline__ float inv_dir(float c) { return fabsf(c) > 1e-30f ? 1.0f / c : 1e30f; }

// Slab test of one ray against the box b = [min xyz, max xyz] (stride
// `step` between the six values): the box can hold a hit closer than the
// running t (and inside the segment).
__device__ __forceinline__ bool slab_active(const float* __restrict__ b, int step, const Ray& r,
                                            float ix, float iy, float iz, float t) {
  const float tx0 = (b[0 * step] - r.ox) * ix, tx1 = (b[3 * step] - r.ox) * ix;
  const float ty0 = (b[1 * step] - r.oy) * iy, ty1 = (b[4 * step] - r.oy) * iy;
  const float tz0 = (b[2 * step] - r.oz) * iz, tz1 = (b[5 * step] - r.oz) * iz;
  const float enter = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float leave = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return enter <= leave && leave > 0.f && enter < fminf(t, 1.f);
}

// Block-cooperative copy of rows 0-8 (v0, e1, e2) of a triangle tile of
// `count` columns (row stride `stride` in the source) into shared memory
// s[9][count].
__device__ __forceinline__ void load_tile(float* __restrict__ s, const float* __restrict__ src,
                                          int stride, int count) {
  for (int k = threadIdx.x; k < 9 * count; k += blockDim.x) {
    const int f = k / count, j = k - f * count;
    s[k] = src[(size_t)f * stride + j];
  }
}

// Möller–Trumbore of one ray against triangle j of a tile in shared memory
// s[9][stride]; strict `<`, so on equal t the running winner stays.
__device__ __forceinline__ void test_triangle(const float* __restrict__ s, int stride, int j,
                                              int base, const Ray& r, float& bt, int& bi) {
  const float v0x = s[0 * stride + j], v0y = s[1 * stride + j], v0z = s[2 * stride + j];
  const float e1x = s[3 * stride + j], e1y = s[4 * stride + j], e1z = s[5 * stride + j];
  const float e2x = s[6 * stride + j], e2y = s[7 * stride + j], e2z = s[8 * stride + j];
  // pvec = seg x e2
  const float px = r.sy * e2z - r.sz * e2y;
  const float py = r.sz * e2x - r.sx * e2z;
  const float pz = r.sx * e2y - r.sy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool det_ok = fabsf(det) > DET_EPS;
  const float inv_det = det_ok ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  // qvec = tvec x e1
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.sx * qx + r.sy * qy + r.sz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  const bool valid = det_ok && u >= 0.f && v >= 0.f && u + v <= 1.f && t > 0.f && t < 1.f;
  if (valid && t < bt) {
    bt = t;
    bi = base + j;
  }
}

// The same against triangles [j0, j1) in ascending order: within the range
// the lowest slot wins (jnp.argmin's rule).
__device__ __forceinline__ void closest_in_range(const float* __restrict__ s, int stride, int j0,
                                                 int j1, int base, const Ray& r, float& bt,
                                                 int& bi) {
  for (int j = j0; j < j1; ++j) test_triangle(s, stride, j, base, r, bt, bi);
}

// The same against triangles j0, j0 + step, ... below `count`, ascending:
// the share of one of `step` threads that split a tile between them (the
// threads of a warp then read neighbouring shared-memory banks).
__device__ __forceinline__ void closest_strided(const float* __restrict__ s, int count, int j0,
                                                int step, int base, const Ray& r, float& bt,
                                                int& bi) {
#pragma unroll 4
  for (int j = j0; j < count; j += step) test_triangle(s, count, j, base, r, bt, bi);
}

// The same over all `count` triangles of a tile s[9][count].
__device__ __forceinline__ void closest_in_tile(const float* __restrict__ s, int count, int base,
                                                const Ray& r, float& bt, int& bi) {
  closest_in_range(s, count, 0, count, base, r, bt, bi);
}

}  // namespace mcray
