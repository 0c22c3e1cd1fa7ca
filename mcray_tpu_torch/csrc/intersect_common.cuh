// Device helpers shared by the cluster closest-hit kernels (K5, K6, K7, K10).
//
// The arithmetic is written in the order of the port's plain versions
// (ops/geometry.py:_moller_trumbore, ops/clusters.py:box_active), as K1's
// (intersect.cu) is, and the library is built with -fmad=false, so every
// t, slab bound and winner equals the plain PyTorch version's bit for bit.
// K1 keeps its own loop: moved onto these helpers it ran 2.7-10% slower on
// an H100 (runtime row stride and tile-load division).
//
// K5, K6 and K7 share one launch shape (a block per GROUP rays, a warp per
// ray) and the machinery below it: tiles brought into a two-stage ring in
// shared memory by bulk asynchronous copies (TileRing), a warp's test of its
// ray against a tile with the lanes' shares merged on (t, slot)
// (warp_tile_update), and the OR of a warp-uniform mask over the block
// (BlockOr).

#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace mcray {

constexpr float NO_HIT_T = 2.0f;
constexpr float DET_EPS = 1e-9f;
constexpr int GROUP = 4;   // rays per block of K5, K6, K7
constexpr int PARTS = 32;  // threads per ray: a warp

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

// The same against triangles j0, j0 + step, ... below `count`, ascending:
// the share of one of `step` threads that split a tile between them (the
// threads of a warp then read neighbouring shared-memory banks).
__device__ __forceinline__ void closest_strided(const float* __restrict__ s, int count, int j0,
                                                int step, int base, const Ray& r, float& bt,
                                                int& bi) {
#pragma unroll 4
  for (int j = j0; j < count; j += step) test_triangle(s, count, j, base, r, bt, bi);
}

// Merge the (t, slot) shares of a warp's 32 lanes: the least t, the lower
// slot on equal t (jnp.argmin's rule, since each lane's share is the first
// of its triangles at its least t). Every lane ends with the result.
__device__ __forceinline__ void merge_lanes(float& ct, int& ci) {
  for (int off = 1; off < PARTS; off <<= 1) {
    const float ot = __shfl_xor_sync(0xffffffffu, ct, off);
    const int oi = __shfl_xor_sync(0xffffffffu, ci, off);
    if (ot < ct || (ot == ct && oi < ci)) {
      ct = ot;
      ci = oi;
    }
  }
}

// A warp's ray against the tile s[9][tile_t] (slots base, base + 1, ...):
// lane k tests triangles k, k + 32, ... in ascending order, the shares are
// merged, and the tile's winner replaces the running best only with a strict
// `<` -- the first triangle attaining the minimum, as the plain version's
// min over the tile then `<` against the running t.
__device__ __forceinline__ void warp_tile_update(const float* __restrict__ s, int tile_t, int lane,
                                                 int base, const Ray& r, float& bt, int& bi) {
  float ct = bt;
  int ci = INT_MAX;
  closest_strided(s, tile_t, lane, PARTS, base, r, ct, ci);
  merge_lanes(ct, ci);
  if (ct < bt) {
    bt = ct;
    bi = ci;
  }
}

// ---- bulk asynchronous copies into shared memory (Hopper) ----

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_addr(bar)), "r"(arrivals)
               : "memory");
}

// Wait until the barrier has completed the phase of this parity.
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread: copy `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory; the barrier's phase completes when
// they have arrived. The fence orders the block's earlier reads of `dst`
// before the copy's writes.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(shared_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// Rows 0-8 (v0, e1, e2) of cluster tiles, each 9 * tile_t contiguous floats
// of a cluster-major (clusters, 16, tile_t) array, brought into a two-stage
// ring s[2][9][tile_t] in shared memory: copy q goes to stage q & 1 and
// completes the (q >> 1)-th phase of that stage's barrier. The caller asks
// for copy `copies` (the next one to wait for) or `copies + 1` (the one after
// it, into the other stage: only once every thread has finished with that
// stage, i.e. after a block barrier), and waits for every copy it asked for.
struct TileRing {
  float* s;
  uint64_t* full;  // two mbarriers in shared memory
  const float* tiles;
  int tile_t;
  unsigned copies;  // copies waited for so far

  // Thread 0 sets up the barriers; a block barrier must follow before use.
  __device__ __forceinline__ void init() {
    copies = 0;
    if (threadIdx.x == 0) {
      mbarrier_init(&full[0], 1);
      mbarrier_init(&full[1], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __device__ __forceinline__ float* stage(unsigned q) const {
    return s + (q & 1u) * 9 * (size_t)tile_t;
  }
  // Copy q of cluster c's tile (thread 0 issues it).
  __device__ __forceinline__ void request(unsigned q, int c) const {
    if (threadIdx.x == 0)
      bulk_copy(stage(q), tiles + (size_t)c * 16 * tile_t, 9u * (uint32_t)tile_t * sizeof(float),
                &full[q & 1u]);
  }
  // Wait for copy `copies`; returns its stage.
  __device__ __forceinline__ const float* wait() {
    mbarrier_wait(&full[copies & 1u], (copies >> 1) & 1u);
    return stage(copies++);
  }
};

// The OR over the block's warps of a warp-uniform 64-bit mask, in one block
// barrier. Two vote buffers by round parity: round k + 2 rewrites round k's
// buffer only after round k + 1's barrier, which every thread reaches after
// reading round k's votes.
struct BlockOr {
  uint64_t* votes;  // [2][GROUP] in shared memory
  unsigned round;

  __device__ __forceinline__ uint64_t operator()(uint64_t mask) {
    uint64_t* v = votes + (round++ & 1u) * GROUP;
    if ((threadIdx.x & 31) == 0) v[threadIdx.x / 32] = mask;
    __syncthreads();
    uint64_t all = 0u;
#pragma unroll
    for (int w = 0; w < GROUP; ++w) all |= v[w];
    return all;
  }
};

// Ray i, or a zero ray past n_tot (the partial last block of a launch).
__device__ __forceinline__ Ray load_ray_or_zero(const float* __restrict__ rays, int n_tot, int i) {
  return i < n_tot ? load_ray(rays, n_tot, i) : Ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
}

// A ray with a zero segment (padding, a parked dead path) cannot hit anything.
__device__ __forceinline__ bool live_ray(const Ray& r) {
  return r.sx != 0.f || r.sy != 0.f || r.sz != 0.f;
}

// Slab test of a ray against box c of a (boxes, 8) array [min xyz, max xyz,
// 0, 0] (rows 16-byte aligned), read through the read-only cache.
__device__ __forceinline__ bool box_active(const float* __restrict__ boxes, int c, const Ray& r,
                                           float ix, float iy, float iz, float t) {
  const float4* p = reinterpret_cast<const float4*>(boxes + (size_t)c * 8);
  const float4 lo = __ldg(p), hi = __ldg(p + 1);
  const float b[6] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y};
  return slab_active(b, 1, r, ix, iy, iz, t);
}

// Walk a block's candidate clusters in slot order. `cand.next(r, ix, iy, iz,
// live, t)` (called by every thread alike, with its ray's running t) yields
// the next cluster some ray of the group may reach, or -1 at the end: a
// superset of those the reference tests, since a mask found with an earlier
// (larger) t keeps every box reached at a later one. At its turn a candidate
// is tested again against the t of that moment: if no ray of the group
// reaches its box, its tile is skipped, as the reference skips it; else the
// block tests its rays against it. The next candidate is found (it may take
// block-wide mask rounds) and its tile asked for before the current one is
// tested, so the copy runs under the tests; the block barrier at each turn
// frees the ring stage the copy lands in.
template <class Candidates>
__device__ __forceinline__ void walk_candidates(Candidates& cand, TileRing& ring,
                                                const float* __restrict__ boxes, const Ray& r,
                                                float ix, float iy, float iz, bool live, int lane,
                                                float& bt, int& bi) {
  int c = cand.next(r, ix, iy, iz, live, bt);
  if (c >= 0) ring.request(ring.copies, c);
  while (c >= 0) {
    const bool active = __syncthreads_or(live && box_active(boxes, c, r, ix, iy, iz, bt));
    const int c_next = cand.next(r, ix, iy, iz, live, bt);
    if (c_next >= 0) ring.request(ring.copies + 1, c_next);
    const float* tile = ring.wait();
    if (active) warp_tile_update(tile, ring.tile_t, lane, c * ring.tile_t, r, bt, bi);
    c = c_next;
  }
}

// Static shared bytes of `kernel` (beside the dynamic ring), as the runtime
// reports them, or -1 if it cannot: the wrappers check the sum against the
// 48 KB a block may take before a launch.
template <typename Kernel>
inline int static_shared_bytes(Kernel kernel) {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess ? (int)attr.sharedSizeBytes : -1;
}

}  // namespace mcray
