// K5: list-driven closest hit over each ray packet's surviving clusters.
//
// Replaces mcray_tpu/ops/pallas/intersect.py:_intersect_listed_kernel
// (launched by _listed_call, wrapper intersect_closest_listed). The plain
// tensor prepass (ops/clusters.py:packet_cluster_lists) gives every packet
// of tile_r rays its list of clusters, front to back by a lower bound of
// the packet's entry t. The kernel visits, for every ray, the clusters the
// reference visits for its packet, or fewer, with a strict `<`: a cluster
// it leaves out could at best tie, so the winning (t, slot) is the plain
// version's bit for bit. t_init / idx_init seed the running best, so a pass
// composes with a prior one (passes=2, the grouped kernel's residual pass).
// Inert lanes (padding and parked dead rays) come in at t = 0: they cannot
// update and cannot hold a stop open.
//
// Bound on the card: latency, not device memory or arithmetic throughput.
// A bounce has 2,560 rays; the work of one ray is a chain of dependent
// steps (list entry -> box -> tile -> 128 Möller–Trumbore tests -> running
// t -> next entry), and the card has 132 SMs to hide it on. The design
// shortens the chain and widens the launch:
//   - A block per sub-packet, not per packet: GROUP rays walk their
//     packet's list with their own stop and their own box test. A list key
//     is the minimum entry t over the whole packet, so it bounds every
//     subset's entry too, and keys ascend: a group stops when the next key
//     is >= its own worst running t (one cluster stale, as the reference),
//     and a group of inert lanes returns at once, so a late bounce with 177
//     live rays no longer walks for 2,560.
//   - PARTS threads per ray: thread k tests triangles k, k + PARTS, ... of
//     a tile in ascending order, and the shares are merged by shuffles on
//     (t, slot), lower slot on equal t, then taken against the running best
//     with a strict `<` — the first triangle attaining the minimum,
//     jnp.argmin's rule. Interleaved shares put a warp's reads on
//     neighbouring shared-memory banks.
//   - The list is read CHUNK entries at a time: a thread per entry brings
//     its id, key and box (32 bytes of aabb_cluster, not six values a row
//     apart in the tile) into shared memory, and the PARTS threads of a ray
//     test different entries against the ray's running t. The boxes' OR over
//     the block is the chunk's candidate mask: t only shrinks, so a cluster
//     no ray reaches now is reached by none later, and a skipped entry costs
//     a bit, not a tile and two barriers. Each candidate is tested again at
//     its turn against the t of that moment, as the reference tests it.
//   - Tiles come by bulk asynchronous copy (cp.async.bulk, completion on an
//     mbarrier) into a two-stage ring: one thread asks for rows 0-8 of the
//     next candidate's tile (4,608 contiguous bytes at tile_t = 128) while
//     the block tests the current one. Loading the tile with float4 reads
//     by all threads at its turn instead was a quarter slower on large
//     scenes.
// Chosen on an H100: 4 rays per block with a warp each, 640 blocks of 128
// threads a bounce. Fewer threads per ray and more rays per block were
// slower on every ray set (32 rays x 4 threads: 2.4x on the sphere, 3-7x on
// the large scenes); 2 or 1 rays per block gained up to 40% on incoherent
// rays and lost 10-40% on the sphere and on a coherent fan. Staging 128 list
// entries at a time instead of 32 was slower on coherent rays (boxes staged
// past the stop). The launch shape (GROUP, PARTS), the tile ring and the
// lanes' merge are intersect_common.cuh's, shared with K6 and K7.

#include "intersect_common.cuh"

namespace {

using mcray::GROUP;
using mcray::PARTS;
using mcray::Ray;

constexpr int CHUNK = 32;  // list entries staged at a time: one bit each in the candidate mask

__global__ void __launch_bounds__(GROUP * PARTS)
intersect_listed_kernel(const float* __restrict__ rays, int n_tot, int tile_r,
                        const int* __restrict__ counts, const int* __restrict__ ids,
                        const float* __restrict__ keys, int n_c,
                        const float* __restrict__ t_init, const int* __restrict__ idx_init,
                        const float* __restrict__ tiles, const float* __restrict__ boxes,
                        int tile_t, float* __restrict__ best_t, int* __restrict__ best_idx) {
  extern __shared__ __align__(16) float s_tiles[];  // [2][9][tile_t]
  __shared__ __align__(16) float s_box[CHUNK][8];
  __shared__ int s_id[CHUNK];
  __shared__ float s_key[CHUNK];
  __shared__ unsigned s_mask[2];
  __shared__ __align__(8) uint64_t s_full[2];

  const int part = threadIdx.x % PARTS;
  const int first = blockIdx.x * GROUP;  // the block's first ray
  const int i = first + threadIdx.x / PARTS;
  const int p = first / tile_r;
  const Ray r = mcray::load_ray(rays, n_tot, i);
  const float ix = mcray::inv_dir(r.sx), iy = mcray::inv_dir(r.sy), iz = mcray::inv_dir(r.sz);
  float bt = t_init[i];
  int bi = idx_init[i];

  const int n = counts[p];
  // a group of inert lanes only (t = 0) can find nothing
  if (__syncthreads_or(bt > 0.f) && n > 0) {
    const int* id_row = ids + (size_t)p * n_c;
    const float* key_row = keys + (size_t)p * n_c;
    mcray::TileRing ring{s_tiles, s_full, tiles, tile_t, 0};
    ring.init();
    if (threadIdx.x == 0) s_mask[0] = s_mask[1] = 0u;
    float bt_old = bt;    // the running t before the last cluster tested
    int last = -2;        // list index of the last cluster tested
    bool ahead = false;   // the next candidate's copy is already on its way
    bool go = true;
    for (int base = 0, chunk = 0; go && base < n; base += CHUNK, ++chunk) {
      const int m = min(CHUNK, n - base);
      for (int e = threadIdx.x; e < m; e += blockDim.x) {
        const int c = id_row[base + e];
        s_id[e] = c;
        s_key[e] = key_row[base + e];
        const float4* box = reinterpret_cast<const float4*>(boxes + (size_t)c * 8);
        reinterpret_cast<float4*>(s_box[e])[0] = box[0];
        reinterpret_cast<float4*>(s_box[e])[1] = box[1];
      }
      if (threadIdx.x == 0) s_mask[(chunk + 1) & 1] = 0u;
      __syncthreads();
      // the list goes on into this chunk if its first key is below some
      // ray's t (keys ascend: if not, no later entry is reached either)
      if (base > 0 && !__syncthreads_or(s_key[0] < (base == last + 1 ? bt_old : bt))) break;
      // candidates: the entries whose box some ray of the group reaches now
      unsigned mine = 0u;
      for (int e = part; e < m; e += PARTS)
        if (mcray::slab_active(s_box[e], 1, r, ix, iy, iz, bt)) mine |= 1u << e;
      mine = __reduce_or_sync(0xffffffffu, mine);
      if ((threadIdx.x & 31) == 0 && mine) atomicOr(&s_mask[chunk & 1], mine);
      __syncthreads();
      unsigned cand = s_mask[chunk & 1];
      while (cand) {
        const int e = __ffs(cand) - 1;
        cand &= cand - 1;
        const int e_next = __ffs(cand) - 1;  // the chunk's next candidate, or -1
        const int at = base + e;
        const int c = s_id[e];
        if (!ahead) ring.request(ring.copies, c);
        // reached: the stop rule, on the t before the cluster just tested
        // where that was this entry's predecessor (one cluster stale)
        go = __syncthreads_or(at == 0 || s_key[e] < (at == last + 1 ? bt_old : bt));
        const bool active =
            go && __syncthreads_or(mcray::slab_active(s_box[e], 1, r, ix, iy, iz, bt));
        ahead = go && e_next >= 0;
        if (ahead) ring.request(ring.copies + 1, s_id[e_next]);  // into the other stage
        const float* tile = ring.wait();  // every copy is waited for
        if (!go) break;
        if (active) {
          bt_old = bt;
          last = at;
          mcray::warp_tile_update(tile, tile_t, part, c * tile_t, r, bt, bi);
        }
      }
    }
  }
  if (part == 0) {
    best_t[i] = bt;
    best_idx[i] = bi;
  }
}

}  // namespace

// rays (6, n_tot), n_tot = packets * tile_r, tile_r a multiple of GROUP;
// counts (P,), ids and keys (P, n_c); t_init, idx_init, best_t, best_idx
// (n_tot,); tiles (clusters, 16, tile_t), 16-byte aligned, tile_t a multiple
// of 4; boxes (clusters, 8) [min xyz, max xyz, 0, 0], the tiles' rows 9-14.
// `blocks` (host memory) receives the grid that was launched.
extern "C" int mcray_intersect_listed(const float* rays, int n_tot, int tile_r, const int* counts,
                                      const int* ids, const float* keys, int n_c,
                                      const float* t_init, const int* idx_init, const float* tiles,
                                      const float* boxes, int tile_t, float* best_t, int* best_idx,
                                      int* blocks, cudaStream_t stream) {
  *blocks = 0;
  if (n_tot <= 0) return (int)cudaGetLastError();
  if (tile_r % GROUP || n_tot % tile_r) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * 9 * (size_t)tile_t * sizeof(float);
  const int grid = n_tot / GROUP;
  intersect_listed_kernel<<<grid, GROUP * PARTS, smem, stream>>>(
      rays, n_tot, tile_r, counts, ids, keys, n_c, t_init, idx_init, tiles, boxes, tile_t, best_t,
      best_idx);
  *blocks = grid;
  return (int)cudaGetLastError();
}

// Static shared bytes of the kernel, or -1 (mcray::static_shared_bytes).
extern "C" int mcray_intersect_listed_static_shared() {
  return mcray::static_shared_bytes(intersect_listed_kernel);
}
