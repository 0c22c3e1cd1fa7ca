// K5: list-driven closest hit over each ray packet's surviving clusters.
//
// Replaces mcray_tpu/ops/pallas/intersect.py:_intersect_listed_kernel
// (launched by _listed_call, wrapper intersect_closest_listed). The plain
// tensor prepass (ops/clusters.py:packet_cluster_lists) gives every packet
// of tile_r rays its list of clusters, front to back by a lower bound of
// the packet's entry t. One block per packet, one thread per ray; the
// block walks its list in order:
//   - it decides, from the running t before this cluster (as the reference
//     does, one cluster stale), whether the list goes on past this cluster:
//     it stops once the next key is >= the packet's worst running t. "Some
//     ray's t exceeds the key" is that test, taken by __syncthreads_or, so no
//     max reduction is needed;
//   - it re-checks each ray against the cluster's AABB (rows 9-14 of its
//     tile) with min(t, 1); only if some ray of the packet passes does the
//     block stage rows 0-8 of the tile in shared memory and run
//     Möller–Trumbore for every ray, with a strict `<`;
//   - t_init / idx_init seed the running best, so a pass composes with a
//     prior one (passes=2, and later the grouped kernel's residual pass).
// Inert lanes (padding and parked dead rays) come in at t = 0: they cannot
// update and cannot hold the early stop open.
//
// Bound on the card: at 2,560 rays per bounce and 512-ray packets a launch
// has only 5 blocks for 132 SMs, so it is bound by the latency of one
// block's serial walk (a cluster's tile load, then 128 dependent
// Möller–Trumbore steps per thread), not by device memory or instruction
// throughput. This kernel takes the simple form first; more blocks per
// packet (rays or clusters split across blocks) is the first change to
// make it fast.

#include "intersect_common.cuh"

namespace {

using mcray::Ray;

__global__ void __launch_bounds__(1024)
intersect_listed_kernel(const float* __restrict__ rays, int n_tot, const int* __restrict__ counts,
                        const int* __restrict__ ids, const float* __restrict__ keys, int n_c,
                        const float* __restrict__ t_init, const int* __restrict__ idx_init,
                        const float* __restrict__ tiles, int tile_t, float* __restrict__ best_t,
                        int* __restrict__ best_idx) {
  extern __shared__ float s[];  // [9][tile_t]
  const int p = blockIdx.x;
  const int i = p * blockDim.x + threadIdx.x;
  const Ray r = mcray::load_ray(rays, n_tot, i);
  const float ix = mcray::inv_dir(r.sx), iy = mcray::inv_dir(r.sy), iz = mcray::inv_dir(r.sz);
  float bt = t_init[i];
  int bi = idx_init[i];

  const int n = counts[p];
  const int* id_row = ids + (size_t)p * n_c;
  const float* key_row = keys + (size_t)p * n_c;
  const size_t tile_size = 16 * (size_t)tile_t;
  bool go = n > 0;
  for (int it = 0; go; ++it) {
    const bool has_next = it + 1 < n;
    const float key_next = has_next ? key_row[it + 1] : 0.f;
    const bool want_next = __syncthreads_or(has_next && key_next < bt) != 0;

    const int c = id_row[it];
    const float* tile = tiles + (size_t)c * tile_size;
    const bool active = mcray::slab_active(tile + 9 * tile_t, tile_t, r, ix, iy, iz, bt);
    if (__syncthreads_or(active)) {
      mcray::load_tile(s, tile, tile_t, tile_t);
      __syncthreads();
      mcray::closest_in_tile(s, tile_t, c * tile_t, r, bt, bi);
      __syncthreads();
    }
    go = want_next;
  }
  best_t[i] = bt;
  best_idx[i] = bi;
}

}  // namespace

// rays (6, n_tot), n_tot = packets * tile_r; counts (P,), ids and keys
// (P, n_c); t_init, idx_init, best_t, best_idx (n_tot,); tiles
// (clusters, 16, tile_t).
extern "C" int mcray_intersect_listed(const float* rays, int n_tot, int tile_r, const int* counts,
                                      const int* ids, const float* keys, int n_c,
                                      const float* t_init, const int* idx_init, const float* tiles,
                                      int tile_t, float* best_t, int* best_idx,
                                      cudaStream_t stream) {
  if (n_tot > 0) {
    const size_t smem = 9 * (size_t)tile_t * sizeof(float);
    intersect_listed_kernel<<<n_tot / tile_r, tile_r, smem, stream>>>(
        rays, n_tot, counts, ids, keys, n_c, t_init, idx_init, tiles, tile_t, best_t, best_idx);
  }
  return (int)cudaGetLastError();
}
