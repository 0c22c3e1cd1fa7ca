// K1: brute-force closest-hit ray-triangle intersection.
//
// Replaces mcray_tpu/ops/pallas/intersect.py:_intersect_kernel. One thread
// per ray; the block stages TILE triangles of the (9, T) SoA
// [v0 xyz, e1 xyz, e2 xyz] in shared memory and every thread walks them in
// ascending order. The update is a strict `<`, so on equal t the lowest
// triangle index wins, as jnp.argmin does in the reference.
//
// Bound: f32 issue rate (~30 operations per ray-triangle pair, no device
// memory traffic inside the loop; the shared-memory reads are broadcasts).
// The arithmetic is written in the order of the reference's
// geometry._moller_trumbore and compiled with -fmad=false, so t, the hit
// test and the winning index equal the plain PyTorch version's.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;
constexpr int THREADS = 128;
constexpr float NO_HIT_T = 2.0f;
constexpr float DET_EPS = 1e-9f;

__global__ void intersect_closest_kernel(const float* __restrict__ rays, int n,
                                         const float* __restrict__ tris, int t_count,
                                         float* __restrict__ best_t,
                                         int* __restrict__ best_idx) {
  __shared__ float s[9][TILE];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  if (live) {
    ox = rays[0 * n + i];
    oy = rays[1 * n + i];
    oz = rays[2 * n + i];
    sx = rays[3 * n + i];
    sy = rays[4 * n + i];
    sz = rays[5 * n + i];
  }
  float bt = NO_HIT_T;
  int bi = 0;

  for (int base = 0; base < t_count; base += TILE) {
    const int count = min(TILE, t_count - base);
    for (int k = threadIdx.x; k < 9 * TILE; k += blockDim.x) {
      const int f = k / TILE, j = k % TILE;
      s[f][j] = j < count ? tris[(size_t)f * t_count + base + j] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < count; ++j) {
      const float v0x = s[0][j], v0y = s[1][j], v0z = s[2][j];
      const float e1x = s[3][j], e1y = s[4][j], e1z = s[5][j];
      const float e2x = s[6][j], e2y = s[7][j], e2z = s[8][j];
      // pvec = seg x e2
      const float px = sy * e2z - sz * e2y;
      const float py = sz * e2x - sx * e2z;
      const float pz = sx * e2y - sy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const bool det_ok = fabsf(det) > DET_EPS;
      const float inv_det = det_ok ? 1.0f / det : 0.0f;
      const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
      const float u = (tx * px + ty * py + tz * pz) * inv_det;
      // qvec = tvec x e1
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float v = (sx * qx + sy * qy + sz * qz) * inv_det;
      const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      const bool valid = det_ok && u >= 0.f && v >= 0.f && u + v <= 1.f && t > 0.f && t < 1.f;
      if (valid && t < bt) {
        bt = t;
        bi = base + j;
      }
    }
    __syncthreads();
  }
  if (live) {
    best_t[i] = bt;
    best_idx[i] = bi;
  }
}

}  // namespace

extern "C" int mcray_intersect_closest(const float* rays, int n, const float* tris,
                                       int t_count, float* best_t, int* best_idx,
                                       cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    intersect_closest_kernel<<<blocks, THREADS, 0, stream>>>(rays, n, tris, t_count,
                                                             best_t, best_idx);
  }
  return (int)cudaGetLastError();
}
