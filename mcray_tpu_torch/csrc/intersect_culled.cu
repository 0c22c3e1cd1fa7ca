// K6: closest hit over all cluster tiles with a per-tile AABB early exit.
//
// Replaces mcray_tpu/ops/pallas/intersect.py:_intersect_culled_kernel
// (wrapper intersect_closest_culled). K1's loop, run over the tile_t-wide
// cluster tiles of the permuted (16, n_slots) SoA in cluster order: each
// tile carries its cluster's AABB in rows 9-14. One block per packet of
// tile_r rays, one thread per ray: every ray slab-tests the tile's box
// against min(its running t, 1); if no ray of the packet passes, the block
// skips the tile, else it stages rows 0-8 in shared memory and every ray
// runs Möller–Trumbore over it with a strict `<` (ties to the lowest slot).
//
// Bound on the card: as K5, a bounce of 2,560 rays in 512-ray packets is
// 5 blocks on 132 SMs; each block walks every cluster of the scene in
// order, so the launch is bound by that serial walk. The simple form
// comes first; splitting a packet's clusters across blocks is the first
// change to make it fast.

#include "intersect_common.cuh"

namespace {

using mcray::Ray;

__global__ void __launch_bounds__(1024)
intersect_culled_kernel(const float* __restrict__ rays, int n_tot, const float* __restrict__ soa,
                        int n_slots, int tile_t, float* __restrict__ best_t,
                        int* __restrict__ best_idx) {
  extern __shared__ float s[];  // [9][tile_t]
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Ray r = mcray::load_ray(rays, n_tot, i);
  const float ix = mcray::inv_dir(r.sx), iy = mcray::inv_dir(r.sy), iz = mcray::inv_dir(r.sz);
  float bt = mcray::NO_HIT_T;
  int bi = 0;
  for (int base = 0; base < n_slots; base += tile_t) {
    const float* box = soa + 9 * (size_t)n_slots + base;  // rows 9-14, this tile's column 0
    const bool active = mcray::slab_active(box, n_slots, r, ix, iy, iz, bt);
    if (__syncthreads_or(active)) {
      mcray::load_tile(s, soa + base, n_slots, tile_t);
      __syncthreads();
      mcray::closest_in_tile(s, tile_t, base, r, bt, bi);
      __syncthreads();
    }
  }
  best_t[i] = bt;
  best_idx[i] = bi;
}

}  // namespace

// rays (6, n_tot), n_tot = packets * tile_r; soa (16, n_slots), n_slots a
// multiple of tile_t; best_t, best_idx (n_tot,).
extern "C" int mcray_intersect_culled(const float* rays, int n_tot, int tile_r, const float* soa,
                                      int n_slots, int tile_t, float* best_t, int* best_idx,
                                      cudaStream_t stream) {
  if (n_tot > 0) {
    const size_t smem = 9 * (size_t)tile_t * sizeof(float);
    intersect_culled_kernel<<<n_tot / tile_r, tile_r, smem, stream>>>(rays, n_tot, soa, n_slots,
                                                                     tile_t, best_t, best_idx);
  }
  return (int)cudaGetLastError();
}
