// K7: two-level staged closest hit: super boxes, then cluster boxes, then
// a cluster's triangles.
//
// Replaces mcray_tpu/ops/pallas/intersect.py:_intersect_staged_kernel
// (wrapper intersect_closest_staged). One block per packet of tile_r rays,
// one thread per ray. For each super-cluster in order, every ray
// slab-tests its box against min(its running t, 1); if some ray passes,
// the block does the same for each of the super's super_g clusters
// (aabb_cluster), and for a cluster some ray passes it stages that
// cluster's tile (rows 0-8 of hbm_tris) in shared memory and every ray runs
// Möller–Trumbore with a strict `<` (ties to the lowest slot). Padding
// clusters carry a far degenerate box and are never visited.
//
// Bound on the card: as K5 and K6, 5 blocks of 512 rays per bounce on
// 132 SMs, each walking its supers serially: latency of the walk, not
// memory or instruction throughput. Simple form first; splitting a
// packet's supers across blocks is the first change to make it fast.

#include "intersect_common.cuh"

namespace {

using mcray::Ray;

__global__ void __launch_bounds__(1024)
intersect_staged_kernel(const float* __restrict__ rays, int n_tot,
                        const float* __restrict__ aabb_super, int n_super, int super_g,
                        const float* __restrict__ aabb_cluster, const float* __restrict__ tiles,
                        int tile_t, float* __restrict__ best_t, int* __restrict__ best_idx) {
  extern __shared__ float s[];  // [9][tile_t]
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Ray r = mcray::load_ray(rays, n_tot, i);
  const float ix = mcray::inv_dir(r.sx), iy = mcray::inv_dir(r.sy), iz = mcray::inv_dir(r.sz);
  float bt = mcray::NO_HIT_T;
  int bi = 0;
  for (int sc = 0; sc < n_super; ++sc) {
    if (!__syncthreads_or(mcray::slab_active(aabb_super + 8 * sc, 1, r, ix, iy, iz, bt))) continue;
    for (int g = 0; g < super_g; ++g) {
      const int c = sc * super_g + g;
      if (!__syncthreads_or(mcray::slab_active(aabb_cluster + 8 * c, 1, r, ix, iy, iz, bt)))
        continue;
      mcray::load_tile(s, tiles + (size_t)c * 16 * tile_t, tile_t, tile_t);
      __syncthreads();
      mcray::closest_in_tile(s, tile_t, c * tile_t, r, bt, bi);
      __syncthreads();
    }
  }
  best_t[i] = bt;
  best_idx[i] = bi;
}

}  // namespace

// rays (6, n_tot), n_tot = packets * tile_r; aabb_super (n_super, 8);
// aabb_cluster (n_super * super_g, 8); tiles (n_super * super_g, 16,
// tile_t); best_t, best_idx (n_tot,).
extern "C" int mcray_intersect_staged(const float* rays, int n_tot, int tile_r,
                                      const float* aabb_super, int n_super, int super_g,
                                      const float* aabb_cluster, const float* tiles, int tile_t,
                                      float* best_t, int* best_idx, cudaStream_t stream) {
  if (n_tot > 0) {
    const size_t smem = 9 * (size_t)tile_t * sizeof(float);
    intersect_staged_kernel<<<n_tot / tile_r, tile_r, smem, stream>>>(
        rays, n_tot, aabb_super, n_super, super_g, aabb_cluster, tiles, tile_t, best_t, best_idx);
  }
  return (int)cudaGetLastError();
}
