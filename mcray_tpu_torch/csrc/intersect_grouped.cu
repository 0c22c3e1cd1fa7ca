// K10: cluster-major ("grouped") closest hit, reduced per ray in the kernel.
//
// Replaces mcray_tpu/ops/pallas/intersect.py:_intersect_grouped_kernel
// (wrapper intersect_closest_grouped) together with the per-ray reduction
// that follows it there (the sort-based reduce). The plain tensor prepass
// (ops/clusters.py:cluster_ray_tables) gives every cluster the ids of at
// most G rays whose slab test reaches it (`counts` of them). The function:
// per ray, the least (t, slot) over every (cluster, slot) that holds it, t
// the least over the cluster's triangles and slot cluster * tile_t + the
// first triangle attaining it (jnp.argmin's rule); (NO_HIT_T, 0) for a ray
// that hits nothing.
//
// Bound on the card: latency, not device memory (~1 MB a mega bounce) or
// arithmetic. Most clusters hold no ray (93% on a coherent fan of the 200k
// scene), those that do hold a handful (7.9 of 32 slots on average on the
// isotropic set), and each slot is a walk of 128 triangles in which every
// Möller–Trumbore test is a chain of ~25 dependent operations (the IEEE
// reciprocal among them). The design:
//   - Warps, not blocks, own the work, and only clusters that hold a ray
//     cost anything. A work item is one of SPLITS = 4 contiguous triangle
//     ranges of a cluster (measured on an H100 against 1, 2 and 8: 1 and 2
//     leave a full cluster's 32 slots x 128 triangles on one warp, 8 adds
//     per-item copies and atomics and won only on some ray sets; PERF.md).
//     The grid is sized to the card (the
//     blocks that fit at once, or fewer); warp w takes items w, w + W, ...
//     (W warps in the grid), so a cluster's ranges land on neighbouring
//     warps. A warp reads the counts of 32 of its items at once and takes
//     the non-empty ones from the ballot. No host read, no compaction pass.
//   - Every lane works whatever the count. A batch of s used slots (s the
//     least power of two >= the slots left, at most 32) puts lane l on slot
//     l % s and triangle part l / s of 32 / s: one ray, 32 parts; 8 rays, 4
//     parts; 32 or more, a slot a lane, in batches of 32. Part p walks
//     triangles p, p + parts, ... of the range in ascending order with a
//     strict `<` (its first triangle at its least t); the parts are merged
//     by shuffles on (t, slot), lower slot on equal t, so the merge is exact
//     in any order (K1's rule).
//   - Each warp has its own two-stage ring in shared memory (RangeRing):
//     rows 0-8 of the next item's range arrive by bulk asynchronous copy
//     while the current one is walked.
//   - The per-ray reduction is a 64-bit integer atomicMin of
//     (bits(t) << 32) | slot into `keys` (one per ray, starting at
//     (bits(NO_HIT_T) << 32) | 0): a positive f32 orders as its bits, and an
//     integer minimum does not depend on the order of the updates, so the
//     result is ops/clusters.py:ray_winners over the (cluster, slot) tables
//     bit for bit, whatever the ranges. A range with no hit for a slot
//     issues no atomic: its key could not win against the start value. The
//     (clusters, G) tables are never written; the plain reduction they fed
//     (ray_winners' scatter_reduce, every unused slot on ray 0) took ~0.14
//     ms a bounce on the card.
// Tried on the card and left out: ranges sized by each cluster's ray count
// (range-major items), loading the next item's rays ahead of its walk, two
// slots a lane (two independent test chains, 72 registers), 8 warps a block
// (PERF.md). The residual listed pass over the clusters that dropped rays
// (K5) follows in the wrapper. The reference batches B clusters per program
// to amortise a TPU grid step; a warp per item needs no such batching.

#include "intersect_common.cuh"

namespace {

using mcray::Ray;

constexpr int WARPS = 4;   // warps per block, each with its own ring
constexpr int SPLITS = 4;  // triangle ranges a cluster is cut into: the work items
// dynamic shared memory a block may take (of the 227 KB, with room for the barriers)
constexpr long long MAX_DYNAMIC_SHARED = 226 * 1024;
constexpr long long DEFAULT_SHARED = 48 * 1024;  // without opting in
constexpr unsigned FULL = 0xffffffffu;

// Triangles per range: tile_t / SPLITS rounded up to a multiple of 4, so
// every range starts on a 16-byte boundary of its rows.
__host__ __device__ __forceinline__ int range_span(int tile_t) {
  return ((tile_t + 4 * SPLITS - 1) / (4 * SPLITS)) * 4;
}

// The least power of two >= n, at most 32: the slots of one batch.
__device__ __forceinline__ int batch_slots(int n) {
  int s = 1;
  while (s < n && s < 32) s <<= 1;
  return s;
}

// A warp's two-stage ring of triangle ranges in shared memory,
// s[2][9][span]: copy q brings rows 0-8 of one range (9 bulk copies of a
// row's stretch, one barrier) into stage q & 1 and completes the
// (q >> 1)-th phase of that stage's barrier. Lane 0 issues the copies; a
// copy may go into a stage only after every lane is done with it.
struct RangeRing {
  float* s;
  uint64_t* full;  // two mbarriers in shared memory
  int span;
  unsigned copies;  // copies waited for so far

  __device__ __forceinline__ void init(int lane) {
    copies = 0;
    if (lane == 0) {
      mcray::mbarrier_init(&full[0], 1);
      mcray::mbarrier_init(&full[1], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __device__ __forceinline__ float* stage(unsigned q) const {
    return s + (q & 1u) * 9 * (size_t)span;
  }
  // Copy q: triangles [j0, j0 + len) of the tile at `tile` (row stride
  // tile_t); len > 0 and a multiple of 4.
  __device__ __forceinline__ void request(unsigned q, const float* tile, int tile_t, int j0,
                                          int len, int lane) const {
    if (lane != 0) return;
    uint64_t* bar = &full[q & 1u];
    const uint32_t row = (uint32_t)len * sizeof(float);
    float* dst = stage(q);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     mcray::shared_addr(bar)),
                 "r"(9 * row)
                 : "memory");
    for (int f = 0; f < 9; ++f)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(mcray::shared_addr(dst + f * len)),
          "l"(tile + (size_t)f * tile_t + j0), "r"(row), "r"(mcray::shared_addr(bar))
          : "memory");
  }
  // Wait for copy `copies`; returns its stage.
  __device__ __forceinline__ const float* wait() {
    mcray::mbarrier_wait(&full[copies & 1u], (copies >> 1) & 1u);
    return stage(copies++);
  }
};

// The slots of one item (cluster c's n used slots against its triangles
// j0 .. j0 + len - 1, staged as s[9][len]), reduced into the per-ray keys.
__device__ __forceinline__ void walk_item(const float* __restrict__ s, int len, int j0, int c,
                                          int tile_t, int n, const int* __restrict__ ids,
                                          const float* __restrict__ rays, int n_tot, int lane,
                                          unsigned long long* __restrict__ keys) {
  for (int b0 = 0; b0 < n; b0 += 32) {
    const int slots = batch_slots(n - b0);
    const int parts = 32 / slots;
    const int slot = b0 + (lane & (slots - 1)), part = lane / slots;
    const bool used = slot < n;
    float bt = mcray::NO_HIT_T;
    int bi = INT_MAX;
    int id = 0;
    if (used) {
      id = ids[slot];
      const Ray r = mcray::load_ray(rays, n_tot, id);
#pragma unroll 4
      for (int j = part; j < len; j += parts)
        mcray::test_triangle(s, len, j, c * tile_t + j0, r, bt, bi);
    }
    for (int off = slots; off < 32; off <<= 1) {  // the lanes of one slot differ in these bits
      const float ot = __shfl_xor_sync(FULL, bt, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (ot < bt || (ot == bt && oi < bi)) {
        bt = ot;
        bi = oi;
      }
    }
    if (used && part == 0 && bt < mcray::NO_HIT_T)
      atomicMin(keys + id, ((unsigned long long)__float_as_uint(bt) << 32) | (unsigned)bi);
  }
}

__global__ void __launch_bounds__(WARPS * 32)
intersect_grouped_kernel(const float* __restrict__ rays, int n_tot,
                         const int* __restrict__ ray_ids, const int* __restrict__ counts,
                         int n_clusters, int group_g, const float* __restrict__ tiles, int tile_t,
                         unsigned long long* __restrict__ keys) {
  extern __shared__ __align__(16) float s_rings[];  // [WARPS][2][9][span]
  __shared__ __align__(8) uint64_t s_full[WARPS][2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int span = range_span(tile_t);
  RangeRing ring{s_rings + (size_t)warp * 2 * 9 * span, s_full[warp], span, 0};
  ring.init(lane);
  __syncthreads();  // the only block barrier: from here each warp goes its own way

  // item i: cluster i / SPLITS, its triangles [q * span, min((q + 1) * span, tile_t)), q = i % SPLITS
  const int n_items = n_clusters * SPLITS;
  const int stride = gridDim.x * WARPS;  // warps in the grid
  for (int first = blockIdx.x * WARPS + warp; first < n_items; first += 32 * stride) {
    // this round's 32 items: lane k reads the count of item first + k * stride
    const int mine = first + lane * stride;
    const int q_mine = mine % SPLITS;
    const int n_mine = mine < n_items && q_mine * span < tile_t ? counts[mine / SPLITS] : 0;
    unsigned pending = __ballot_sync(FULL, n_mine > 0);
    auto ask = [&](unsigned q, int k) {
      const int item = first + k * stride, c = item / SPLITS, j0 = (item % SPLITS) * span;
      ring.request(q, tiles + (size_t)c * 16 * tile_t, tile_t, j0, min(span, tile_t - j0), lane);
    };
    int k = pending ? __ffs(pending) - 1 : -1;
    if (k >= 0) ask(ring.copies, k);
    while (k >= 0) {
      pending &= pending - 1;
      const int k_next = pending ? __ffs(pending) - 1 : -1;
      if (k_next >= 0) ask(ring.copies + 1, k_next);  // into the other stage
      const float* s = ring.wait();
      const int item = first + k * stride, c = item / SPLITS, j0 = (item % SPLITS) * span;
      walk_item(s, min(span, tile_t - j0), j0, c, tile_t, __shfl_sync(FULL, n_mine, k),
                ray_ids + (size_t)c * group_g, rays, n_tot, lane, keys);
      __syncwarp();  // every lane is done with this stage before a copy may land in it
      k = k_next;
    }
  }
}

}  // namespace

// rays (6, n_tot); ray_ids (n_clusters, group_g) ids into the rays; counts
// (n_clusters,) used slots per cluster; tiles (n_clusters, 16, tile_t),
// 16-byte aligned; keys (n_tot,) int64, each (bits(NO_HIT_T) << 32) on entry,
// the ray's least (bits(t) << 32) | slot on exit. group_g is a multiple of 8
// up to 256, tile_t a multiple of 4 whose rings fit in shared memory (up to
// 3,200); anything else returns cudaErrorInvalidValue with no launch.
// *blocks gets the launch's grid.
extern "C" int mcray_intersect_grouped(const float* rays, int n_tot, const int* ray_ids,
                                       const int* counts, int n_clusters, int group_g,
                                       const float* tiles, int tile_t, unsigned long long* keys,
                                       int* blocks, cudaStream_t stream) {
  *blocks = 0;
  const size_t smem = (size_t)WARPS * 2 * 9 * range_span(tile_t) * 4;
  if (group_g < 8 || group_g > 256 || group_g % 8 || tile_t <= 0 || tile_t % 4 ||
      (long long)smem > MAX_DYNAMIC_SHARED)
    return (int)cudaErrorInvalidValue;
  if (n_clusters == 0) return (int)cudaGetLastError();
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if ((long long)smem > DEFAULT_SHARED) {  // opt in to more
    const cudaError_t attr = cudaFuncSetAttribute(
        intersect_grouped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, intersect_grouped_kernel, WARPS * 32,
                                                smem);
  const long long n_items = (long long)n_clusters * SPLITS;
  const long long want = (n_items + WARPS - 1) / WARPS;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(want < fit ? want : fit);
  intersect_grouped_kernel<<<grid, WARPS * 32, smem, stream>>>(
      rays, n_tot, ray_ids, counts, n_clusters, group_g, tiles, tile_t, keys);
  *blocks = grid;
  return (int)cudaGetLastError();
}
