// K6: closest hit over all cluster tiles with a per-cluster AABB skip.
//
// Replaces mcray_tpu/ops/pallas/intersect.py:_intersect_culled_kernel
// (wrapper intersect_closest_culled). For each packet of tile_r rays the
// reference visits the tile_t-wide cluster tiles of the permuted SoA in
// slot order, skips a tile whose box (rows 9-14) no ray of the packet
// reaches before min(its running t, 1), and runs Möller–Trumbore over the
// others with a strict `<` (ties to the lowest slot). No sort and no stop.
//
// Bound on the card: latency, as K5. A bounce has 2,560 rays and each
// block's walk is a chain of dependent steps (box -> tile -> 256 tests ->
// running t -> next box). The design is K5's (intersect_listed.cu), with
// the machinery in intersect_common.cuh:
//   - A block per GROUP (4) rays, a warp per ray: 640 blocks of 128 threads
//     a bounce, where a block per 512-ray packet gave 5. tile_r no longer
//     shapes the launch; a partial last block takes zero rays.
//   - The group skips a cluster when none of its rays reaches the box,
//     where the reference asks the same of the packet. A cluster skipped for
//     a ray has a slab entry at or past that ray's running t, so none of its
//     triangles can win under a strict `<`, and a triangle that ties at the
//     final t in an earlier slot was visited or lies behind an earlier
//     winner: the winning (t, slot) is the lowest slot at the least t either
//     way, so the packet's.
//   - Boxes 32 at a time: lane e of each warp tests cluster base + e against
//     its ray, from the compact aabb_cluster (32 bytes a box; the same floats
//     as the SoA's rows 9-14, which lie n_slots apart), and the OR of the
//     block's ballots is the candidate mask. t only shrinks, so a cluster no
//     ray reaches now is reached by none later; each candidate is tested
//     again at its turn (walk_candidates).
//   - Tiles by bulk asynchronous copy into a two-stage ring: rows 0-8 of the
//     cluster-major hbm_tris tile, 9,216 contiguous bytes at tile_t 256; the
//     next candidate's tile, in this chunk of 32 or a later one, arrives
//     while the block tests the current one. Lane k tests triangles k,
//     k + 32, ...; the shares merge on (t, slot).
//   - Inert lanes (a zero segment: padding, parked dead paths) vote for no
//     box; in the tile tests a zero segment finds nothing. A block of inert
//     lanes only returns at once. Their outputs stay NO_HIT_T, slot 0.

#include "intersect_common.cuh"

namespace {

using mcray::GROUP;
using mcray::PARTS;
using mcray::Ray;

// A block's candidates in slot order: the clusters whose box some ray of
// the group reaches, found 32 boxes at a time.
struct CulledCandidates {
  const float* boxes;
  int n_c;
  mcray::BlockOr vote;
  int base;       // first cluster of the current chunk of 32
  unsigned mask;  // its candidates not yet returned

  __device__ __forceinline__ int next(const Ray& r, float ix, float iy, float iz, bool live,
                                      float t) {
    while (!mask) {
      base += 32;
      if (base >= n_c) return -1;
      const int c = base + threadIdx.x % 32;
      mask = (unsigned)vote(__ballot_sync(
          0xffffffffu, live && c < n_c && mcray::box_active(boxes, c, r, ix, iy, iz, t)));
    }
    const int e = __ffs(mask) - 1;
    mask &= mask - 1;
    return base + e;
  }
};

__global__ void __launch_bounds__(GROUP * PARTS)
intersect_culled_kernel(const float* __restrict__ rays, int n_tot, const float* __restrict__ tiles,
                        const float* __restrict__ boxes, int n_c, int tile_t,
                        float* __restrict__ best_t, int* __restrict__ best_idx) {
  extern __shared__ __align__(16) float s_tiles[];  // [2][9][tile_t]
  __shared__ __align__(8) uint64_t s_full[2];
  __shared__ uint64_t s_votes[2 * GROUP];

  const int lane = threadIdx.x % PARTS;
  const int i = blockIdx.x * GROUP + threadIdx.x / PARTS;
  const Ray r = mcray::load_ray_or_zero(rays, n_tot, i);
  const bool live = mcray::live_ray(r);
  const float ix = mcray::inv_dir(r.sx), iy = mcray::inv_dir(r.sy), iz = mcray::inv_dir(r.sz);
  float bt = mcray::NO_HIT_T;
  int bi = 0;
  mcray::TileRing ring{s_tiles, s_full, tiles, tile_t, 0};
  ring.init();
  if (__syncthreads_or(live)) {
    CulledCandidates cand{boxes, n_c, {s_votes, 0u}, -32, 0u};
    mcray::walk_candidates(cand, ring, boxes, r, ix, iy, iz, live, lane, bt, bi);
  }
  if (lane == 0 && i < n_tot) {
    best_t[i] = bt;
    best_idx[i] = bi;
  }
}

}  // namespace

// rays (6, n_tot); tiles (>= n_c clusters, 16, tile_t), 16-byte aligned,
// tile_t a multiple of 4; boxes (>= n_c, 8) [min xyz, max xyz, 0, 0], the
// tiles' rows 9-14, 16-byte aligned; n_c the real clusters (n_slots /
// tile_t); best_t, best_idx (n_tot,). `blocks` (host memory) receives the
// grid that was launched.
extern "C" int mcray_intersect_culled(const float* rays, int n_tot, const float* tiles,
                                      const float* boxes, int n_c, int tile_t, float* best_t,
                                      int* best_idx, int* blocks, cudaStream_t stream) {
  *blocks = 0;
  if (n_tot <= 0) return (int)cudaGetLastError();
  if (tile_t % 4) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * 9 * (size_t)tile_t * sizeof(float);
  const int grid = (n_tot + GROUP - 1) / GROUP;
  intersect_culled_kernel<<<grid, GROUP * PARTS, smem, stream>>>(rays, n_tot, tiles, boxes, n_c,
                                                                tile_t, best_t, best_idx);
  *blocks = grid;
  return (int)cudaGetLastError();
}

// Static shared bytes of the kernel, or -1 (mcray::static_shared_bytes).
extern "C" int mcray_intersect_culled_static_shared() {
  return mcray::static_shared_bytes(intersect_culled_kernel);
}
