// K1: brute-force closest-hit ray-triangle intersection.
//
// Replaces mcray_tpu/ops/pallas/intersect.py:_intersect_kernel. Möller–
// Trumbore of every ray against every triangle of the (9, T) SoA
// [v0 xyz, e1 xyz, e2 xyz], in the arithmetic order of the reference's
// geometry._moller_trumbore, compiled with -fmad=false and an IEEE-rounded
// 1/det, so t and the hit test equal the plain PyTorch version's. The winner
// is the lexicographic minimum of (t, index) over valid hits (on equal t the
// lowest index, as jnp.argmin); a miss is (2.0, 0).
//
// Bound: f32 issue rate (~50 operations per ray-triangle test, nothing
// re-read from device memory). A thread per ray gave 20 blocks a bounce
// on 2,560 rays, on 20 of the card's 132 SMs. That minimum is exact in any
// order, so the triangle axis is split instead, and the partial winners
// merged:
//   - A block takes 32 rays, a lane each, and one slice of the triangles.
//     Its WARPS (8) warps split the slice into contiguous parts; a warp walks
//     its part in ascending order with a strict `<` (the first triangle at
//     its least t), reading each triangle from shared memory as a broadcast
//     (three 16-byte loads: the tile is stored 12 floats per triangle).
//   - A warp stages its part CHUNK (32) triangles at a time in its own two-stage
//     ring, by 4-byte cp.async (any T and any offset), so the next chunk
//     lands while the current one is tested; only __syncwarp orders them.
//   - The warps' winners merge on (t, index) in shared memory; a
//     thread-block cluster of up to MAX_SLICES blocks along the triangle axis
//     merges its blocks' winners through distributed shared memory, and its
//     first block writes each ray's (t, index) once: one launch, no atomics,
//     no scratch. 2,560 rays x 8 slices make 640 blocks.
//   - A cluster whose 32 rays all have a zero segment (padding, parked dead
//     paths: det is exactly 0 for them, so they always miss) skips the walk
//     and writes (2.0, 0).

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int RAYS = 32;        // rays per block: a lane each
constexpr int WARPS = 8;        // warps per block, each a part of the block's slice
constexpr int THREADS = RAYS * WARPS;
constexpr int CHUNK = 32;       // triangles per ring stage of a warp
constexpr int STRIDE = 12;      // floats per triangle in shared memory (9 used)
constexpr int MAX_SLICES = 8;   // blocks per cluster along the triangle axis (portable limit)
constexpr int MIN_PER_SLICE = WARPS * CHUNK;  // a slice is at least this many triangles
constexpr float NO_HIT_T = 2.0f;
constexpr float DET_EPS = 1e-9f;

struct Ray {
  float ox, oy, oz, sx, sy, sz;
};

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Triangles [base, base + count) of the SoA into one ring stage, 12 floats
// per triangle; one commit group per call (empty where count is 0).
__device__ __forceinline__ void stage_chunk(float* __restrict__ s, const float* __restrict__ tris,
                                            int t_count, int base, int count, int lane) {
  for (int k = lane; k < 9 * count; k += 32) {
    const int f = k / count, j = k - f * count;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(shared_addr(s + j * STRIDE + f)),
                 "l"(tris + (size_t)f * t_count + base + j)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Möller–Trumbore of the lane's ray against triangle `idx` at s[0..8];
// strict `<`, so on equal t the running winner stays.
__device__ __forceinline__ void test_triangle(const float* __restrict__ s, int idx, const Ray& r,
                                              float& bt, int& bi) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  const float4 b = *reinterpret_cast<const float4*>(s + 4);
  const float c = s[8];
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c;
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
    bi = idx;
  }
}

// (t, index) lexicographic minimum into (ct, ci).
__device__ __forceinline__ void take_min(float ot, int oi, float& ct, int& ci) {
  if (ot < ct || (ot == ct && oi < ci)) {
    ct = ot;
    ci = oi;
  }
}

// First triangle of part p of `parts` equal parts of [0, t_count).
__device__ __forceinline__ int part_start(int t_count, int p, int parts) {
  return (int)(((long long)t_count * p) / parts);
}

// grid.x = slices * ceil(n / RAYS), clusters of `slices` consecutive blocks:
// block rank k of a cluster takes slice k of the triangles for the cluster's
// 32 rays.
__global__ void __launch_bounds__(THREADS)
intersect_closest_kernel(const float* __restrict__ rays, int n, const float* __restrict__ tris,
                         int t_count, float* __restrict__ best_t, int* __restrict__ best_idx) {
  __shared__ __align__(16) float s_ring[WARPS][2][CHUNK * STRIDE];
  __shared__ float s_t[WARPS][RAYS];
  __shared__ int s_i[WARPS][RAYS];

  cg::cluster_group cluster = cg::this_cluster();
  const int slices = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i = (blockIdx.x / slices) * RAYS + lane;
  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (i < n)
    r = Ray{rays[0 * n + i], rays[1 * n + i], rays[2 * n + i],
            rays[3 * n + i], rays[4 * n + i], rays[5 * n + i]};
  // every warp of the cluster holds the same 32 rays: a uniform exit
  if (!__any_sync(0xffffffffu, r.sx != 0.f || r.sy != 0.f || r.sz != 0.f)) {
    if (rank == 0 && warp == 0 && i < n) {
      best_t[i] = NO_HIT_T;
      best_idx[i] = 0;
    }
    return;
  }

  // this warp's part of the triangles, walked CHUNK at a time through its ring
  const int part = rank * WARPS + warp, parts = slices * WARPS;
  const int lo = part_start(t_count, part, parts), hi = part_start(t_count, part + 1, parts);
  float bt = NO_HIT_T;
  int bi = 0;
  float* ring = &s_ring[warp][0][0];
  stage_chunk(ring, tris, t_count, lo, min(CHUNK, hi - lo), lane);
  for (int base = lo, q = 0; base < hi; base += CHUNK, ++q) {
    const int next = base + CHUNK;
    stage_chunk(ring + ((q + 1) & 1) * CHUNK * STRIDE, tris, t_count, next,
                max(0, min(CHUNK, hi - next)), lane);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();
    const float* s = ring + (q & 1) * CHUNK * STRIDE;
    const int count = min(CHUNK, hi - base);
#pragma unroll 4
    for (int j = 0; j < count; ++j) test_triangle(s + j * STRIDE, base + j, r, bt, bi);
    __syncwarp();  // every lane is done with this stage before it is refilled
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // the warps' winners, then the cluster's blocks' winners
  s_t[warp][lane] = bt;
  s_i[warp][lane] = bi;
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < WARPS; ++w) take_min(s_t[w][lane], s_i[w][lane], bt, bi);
    s_t[0][lane] = bt;
    s_i[0][lane] = bi;
  }
  cluster.sync();
  if (rank == 0 && warp == 0) {
    for (int k = 1; k < slices; ++k) {
      const float* ot = cluster.map_shared_rank(&s_t[0][0], k);
      const int* oi = cluster.map_shared_rank(&s_i[0][0], k);
      take_min(ot[lane], oi[lane], bt, bi);
    }
    if (i < n) {
      best_t[i] = bt;
      best_idx[i] = bi;
    }
  }
  cluster.sync();  // no block leaves while its winners may still be read
}

}  // namespace

// rays (6, n) [origin xyz, segment xyz], tris (9, t_count); best_t, best_idx
// (n,). *blocks gets the grid.
extern "C" int mcray_intersect_closest(const float* rays, int n, const float* tris, int t_count,
                                       float* best_t, int* best_idx, int* blocks,
                                       cudaStream_t stream) {
  *blocks = 0;
  if (n <= 0) return (int)cudaGetLastError();
  const int slices = t_count <= MIN_PER_SLICE
                         ? 1
                         : min(MAX_SLICES, (t_count + MIN_PER_SLICE - 1) / MIN_PER_SLICE);
  const int tiles = (n + RAYS - 1) / RAYS;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(slices * tiles));
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&config, intersect_closest_kernel, rays, n, tris, t_count, best_t, best_idx);
  if (err != cudaSuccess) return (int)err;
  *blocks = slices * tiles;
  return (int)cudaGetLastError();
}
