// K10: cluster-major ("grouped") closest hit.
//
// Replaces mcray_tpu/ops/pallas/intersect.py:_intersect_grouped_kernel
// (wrapper intersect_closest_grouped), the reference's closest hit for
// incoherent rays on large scenes. The plain tensor prepass
// (ops/clusters.py:cluster_ray_tables) gives every cluster the ids of at
// most G rays whose slab test reaches it. One block per cluster:
//   - a cluster with no ray returns at once;
//   - the block stages rows 0-8 (v0, e1, e2) of the cluster's tile in shared
//     memory, once;
//   - PARTS consecutive threads serve one ray slot: each fetches the slot's
//     ray by its id and walks its own quarter of the triangles in ascending
//     order with a strict `<`; the quarters are merged by shuffles, smaller t
//     first and on equal t the lower triangle slot, so the result is the
//     first triangle attaining the minimum (jnp.argmin's rule);
//   - a used slot with no hit reports (NO_HIT_T, cluster * tile_t), as the
//     reference's min/argmin over a row of NO_HIT_T does; an unused slot
//     (slot >= count) reports (NO_HIT_T, 0).
// The per-ray reduction over a ray's slots (ops/clusters.py:ray_winners) and
// the residual listed pass over the clusters that dropped rays (K5) follow
// in the wrapper. The reference batches B clusters per program to amortise
// a TPU grid step; a block per cluster needs no such batching.
//
// Bound on the card: at G = 32 a block has 128 threads and, on incoherent
// rays, a handful of used slots, so most of its lanes idle through the
// walk; a launch is bound by the latency of one 32-triangle walk and the
// tile loads, not by device memory or instruction throughput. The simple
// form comes first; packing several sparse clusters into one block is the
// first change to make it fast.

#include "intersect_common.cuh"

namespace {

using mcray::Ray;

constexpr int PARTS = 4;  // threads per ray slot; divides the warp size

__global__ void __launch_bounds__(1024)
intersect_grouped_kernel(const float* __restrict__ rays, int n_tot,
                         const int* __restrict__ ray_ids, const int* __restrict__ counts,
                         const float* __restrict__ tiles, int tile_t, float* __restrict__ out_t,
                         int* __restrict__ out_slot) {
  extern __shared__ float s[];  // [9][tile_t]
  const int c = blockIdx.x;
  const int slot = threadIdx.x / PARTS, part = threadIdx.x % PARTS;
  const int g = blockDim.x / PARTS;
  const size_t out = (size_t)c * g + slot;
  const int n = counts[c];
  if (n == 0) {  // the whole block leaves: no barrier follows
    if (part == 0) {
      out_t[out] = mcray::NO_HIT_T;
      out_slot[out] = 0;
    }
    return;
  }
  mcray::load_tile(s, tiles + (size_t)c * 16 * tile_t, tile_t, tile_t);
  __syncthreads();

  const bool used = slot < n;
  float bt = mcray::NO_HIT_T;
  int bi = c * tile_t;
  if (used) {
    const Ray r = mcray::load_ray(rays, n_tot, ray_ids[out]);
    const int span = tile_t / PARTS;
    mcray::closest_in_range(s, tile_t, part * span, (part + 1) * span, c * tile_t, r, bt, bi);
  }
  // merge the PARTS lanes of a slot (they share a warp; every lane shuffles)
  for (int off = 1; off < PARTS; off <<= 1) {
    const float ot = __shfl_xor_sync(0xffffffffu, bt, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ot < bt || (ot == bt && oi < bi)) {
      bt = ot;
      bi = oi;
    }
  }
  if (part == 0) {
    out_t[out] = used ? bt : mcray::NO_HIT_T;
    out_slot[out] = used ? bi : 0;
  }
}

}  // namespace

// rays (6, n_tot); ray_ids (n_clusters, group_g) ids into the rays; counts
// (n_clusters,) used slots per cluster; tiles (n_clusters, 16, tile_t);
// out_t, out_slot (n_clusters, group_g). group_g is a multiple of 8 up to
// 256, tile_t a multiple of PARTS.
extern "C" int mcray_intersect_grouped(const float* rays, int n_tot, const int* ray_ids,
                                       const int* counts, int n_clusters, int group_g,
                                       const float* tiles, int tile_t, float* out_t,
                                       int* out_slot, cudaStream_t stream) {
  if (n_clusters > 0) {
    const size_t smem = 9 * (size_t)tile_t * sizeof(float);
    intersect_grouped_kernel<<<n_clusters, group_g * PARTS, smem, stream>>>(
        rays, n_tot, ray_ids, counts, tiles, tile_t, out_t, out_slot);
  }
  return (int)cudaGetLastError();
}
