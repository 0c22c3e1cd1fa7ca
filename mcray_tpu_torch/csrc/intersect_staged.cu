// K7: two-level staged closest hit: super boxes, then cluster boxes, then
// a cluster's triangles.
//
// Replaces mcray_tpu/ops/pallas/intersect.py:_intersect_staged_kernel
// (wrapper intersect_closest_staged). For each packet of tile_r rays the
// reference visits the super-clusters in order and skips one whose box no
// ray of the packet reaches before min(its running t, 1); in a super it
// reaches, it visits the super_g clusters in order and skips a cluster by
// the same test on aabb_cluster; a cluster's tile (rows 0-8 of hbm_tris)
// gets Möller–Trumbore with a strict `<` (ties to the lowest slot). Padding
// clusters carry a far degenerate box and are never visited. No sort and no
// stop.
//
// Bound on the card: latency, as K5 and K6, and the design is theirs
// (intersect_culled.cu has the argument that a group of 4 rays gives the
// packet's winning (t, slot)): a block per GROUP (4) rays with a warp per
// ray, 640 blocks of 128 threads a bounce instead of 5; the candidates in
// slot order, tiles by bulk asynchronous copy into a two-stage ring, the
// next candidate's tile in flight while the block tests the current one
// (walk_candidates, intersect_common.cuh). The two levels:
//   - Supers 32 at a time: lane e of each warp tests super base + e against
//     its ray, and the OR of the block's ballots is the mask of supers that
//     some ray may reach.
//   - At a super's turn the block tests its box again and, in the same
//     block round, the boxes of its clusters (32 at a time where super_g >
//     32): if some ray reaches the super, the clusters' ballot gives the
//     cluster candidates, each tested again at its own turn. The
//     super's turn comes while the previous candidate's tile is in flight,
//     so its box is tested against the t before that tile: at least the
//     reference's t. That admits no cluster the reference skips: a super box
//     is the union of its clusters' boxes (clusters.pack_tris_culled), and
//     the slab bounds are monotone in the box, so a ray that reaches a
//     cluster at the cluster's turn reached its super at the super's.
//   - Inert lanes (a zero segment: padding, parked dead paths) vote for no
//     box; in the tile tests a zero segment finds nothing. A block of inert
//     lanes only returns at once. Their outputs stay NO_HIT_T, slot 0.

#include "intersect_common.cuh"

namespace {

using mcray::GROUP;
using mcray::PARTS;
using mcray::Ray;

// A block's candidates in slot order: the clusters of the supers some ray
// of the group reaches whose own box some ray reaches.
struct StagedCandidates {
  const float* supers;
  const float* boxes;
  int n_super, super_g;
  mcray::BlockOr vote;
  int sbase;       // first super of the current chunk of 32
  unsigned smask;  // its supers not yet visited
  int sc;          // the super being visited
  int cbase;       // first of its clusters in the current chunk of 32 (super_g: none left)
  unsigned cmask;  // that chunk's candidates not yet returned

  // The block's ballot over the super's clusters cbase, cbase + 1, ...
  // (bits 0-31) and, in bit 32, whether some ray reaches the super's box.
  __device__ __forceinline__ uint64_t cluster_vote(const Ray& r, float ix, float iy, float iz,
                                                   bool live, float t) {
    const int g = cbase + threadIdx.x % 32;
    const unsigned clusters = __ballot_sync(
        0xffffffffu,
        live && g < super_g && mcray::box_active(boxes, sc * super_g + g, r, ix, iy, iz, t));
    const bool in_super = live && mcray::box_active(supers, sc, r, ix, iy, iz, t);
    return vote((uint64_t)in_super << 32 | clusters);
  }

  __device__ __forceinline__ int next(const Ray& r, float ix, float iy, float iz, bool live,
                                      float t) {
    for (;;) {
      if (cmask) {
        const int e = __ffs(cmask) - 1;
        cmask &= cmask - 1;
        return sc * super_g + cbase + e;
      }
      if (cbase + 32 < super_g) {  // the super's next 32 clusters
        cbase += 32;
        cmask = (unsigned)cluster_vote(r, ix, iy, iz, live, t);
        continue;
      }
      while (!smask) {
        sbase += 32;
        if (sbase >= n_super) return -1;
        const int q = sbase + threadIdx.x % 32;
        smask = (unsigned)vote(__ballot_sync(
            0xffffffffu, live && q < n_super && mcray::box_active(supers, q, r, ix, iy, iz, t)));
      }
      sc = sbase + __ffs(smask) - 1;
      smask &= smask - 1;
      // the super at its turn, and its first 32 clusters in the same round
      cbase = 0;
      const uint64_t v = cluster_vote(r, ix, iy, iz, live, t);
      if (v >> 32) {
        cmask = (unsigned)v;
      } else {
        cbase = super_g;  // skipped: none of its clusters
      }
    }
  }
};

__global__ void __launch_bounds__(GROUP * PARTS)
intersect_staged_kernel(const float* __restrict__ rays, int n_tot,
                        const float* __restrict__ aabb_super, int n_super, int super_g,
                        const float* __restrict__ aabb_cluster, const float* __restrict__ tiles,
                        int tile_t, float* __restrict__ best_t, int* __restrict__ best_idx) {
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
    StagedCandidates cand{aabb_super, aabb_cluster, n_super, super_g, {s_votes, 0u},
                          -32, 0u, 0, super_g, 0u};
    mcray::walk_candidates(cand, ring, aabb_cluster, r, ix, iy, iz, live, lane, bt, bi);
  }
  if (lane == 0 && i < n_tot) {
    best_t[i] = bt;
    best_idx[i] = bi;
  }
}

}  // namespace

// rays (6, n_tot); aabb_super (n_super, 8); aabb_cluster (n_super * super_g,
// 8), both [min xyz, max xyz, 0, 0] and 16-byte aligned; tiles (n_super *
// super_g, 16, tile_t), 16-byte aligned, tile_t a multiple of 4; best_t,
// best_idx (n_tot,). `blocks` (host memory) receives the grid that was
// launched.
extern "C" int mcray_intersect_staged(const float* rays, int n_tot, const float* aabb_super,
                                      int n_super, int super_g, const float* aabb_cluster,
                                      const float* tiles, int tile_t, float* best_t,
                                      int* best_idx, int* blocks, cudaStream_t stream) {
  *blocks = 0;
  if (n_tot <= 0) return (int)cudaGetLastError();
  if (tile_t % 4) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * 9 * (size_t)tile_t * sizeof(float);
  const int grid = (n_tot + GROUP - 1) / GROUP;
  intersect_staged_kernel<<<grid, GROUP * PARTS, smem, stream>>>(
      rays, n_tot, aabb_super, n_super, super_g, aabb_cluster, tiles, tile_t, best_t, best_idx);
  *blocks = grid;
  return (int)cudaGetLastError();
}

// Static shared bytes of the kernel, or -1 (mcray::static_shared_bytes).
extern "C" int mcray_intersect_staged_static_shared() {
  return mcray::static_shared_bytes(intersect_staged_kernel);
}
