// K11: closest hit by traversal of a 4-wide BVH, four lanes a ray.
//
// No TPU kernel: the reference's traversal (mcray_tpu/ops/bvh.py:121-212) is
// a jnp while_loop that its TPU backend does not compile. The plain version
// is ops/bvh.py:bvh4_best_plain, which this kernel equals bitwise (t, winner,
// nodes visited, triangles tested): the same walk, the same slab test on the
// same padded boxes, and the Möller–Trumbore body of K1
// (csrc/intersect.cu:test_triangle) in its operation order, built with
// -fmad=false and an IEEE-rounded 1/det. The winner is the least (t, triangle
// index), as K1's, so the two agree bit for bit, and with the binary walk
// (ops/bvh.py:bvh_best_plain) too.
//
// What bounds it: not bytes nor operations (the tree fits in L2) but the
// chain of dependent L2 loads each ray walks, a node after a node. The design
// shortens and widens that chain:
// - the layout (ops/bvh.py:DeviceBVH): the binary tree collapsed to a 4-wide
//   one, each node a 128-byte record of its four children, child c at words
//   8c..8c+7 [padded box min xyz, max xyz as f32 bits, ref, count] (inner:
//   ref = node, count -1; leaf: ref = first triangle, count >= 1; empty:
//   count 0), so one node's four boxes are one line; triangles as three
//   float4s each in the BVH order (v0 + the scene index in w, e1, e2);
// - the walk: of a node's children, those the segment enters before
//   min(best t, 1) are kept; every kept leaf's triangles are tested; then the
//   nearest kept inner child whose entry t is still below min(best t, 1) is
//   visited and the others that still are are pushed with their entry t,
//   farthest first (ties by slot); a pop drops an entry whose entry t is no
//   longer below min(best t, 1) without loading its node. A dead ray (zero
//   segment) returns (2.0, 0) at once;
// - the latency: the kept leaves' triangles are loaded first, then the record
//   a ray visits next (the nearest kept inner child, else the top of its
//   stack) is fetched, and both loads are in flight during the ordering work
//   and the tests; the inner children still kept after the tests are a prefix
//   of the (entry t, slot) order, so the fetched one is the next to visit
//   whenever any is;
// - the lanes (bvh4_quad_kernel, 64-thread blocks, 16 rays a block): lane c
//   of a ray's quad loads child c (two 16-byte loads; the quad reads the line
//   at once) and slab-tests it; the kept leaves' triangles are tested one a
//   lane and the quad reduces the least (t, index) by shuffles, no atomics;
//   a warp's eight quads step through their walks together. (One thread a
//   ray on the same layout, in 32-thread blocks, walked the same nodes 1.2x
//   to 2x slower on every ray set of the frames and was left out, PERF.md.)
// The stack lives in shared memory, STACK entries a ray (ops/bvh.py:STACK4);
// the C entry refuses a layout whose walk can need more.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int QUAD_THREADS = 64;
constexpr int QUAD_RAYS = QUAD_THREADS / 4;
constexpr int STACK = 64;
constexpr float NO_HIT_T = 2.0f;
constexpr float DET_EPS = 1e-9f;

struct Ray {
  float ox, oy, oz, sx, sy, sz, ix, iy, iz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int n, int i) {
  Ray r;
  r.ox = rays[0 * n + i];
  r.oy = rays[1 * n + i];
  r.oz = rays[2 * n + i];
  r.sx = rays[3 * n + i];
  r.sy = rays[4 * n + i];
  r.sz = rays[5 * n + i];
  r.ix = fabsf(r.sx) > 1e-30f ? 1.0f / r.sx : 1e30f;
  r.iy = fabsf(r.sy) > 1e-30f ? 1.0f / r.sy : 1e30f;
  r.iz = fabsf(r.sz) > 1e-30f ? 1.0f / r.sz : 1e30f;
  return r;
}

// Child record (two int4: a = min xyz, max x; b = max yz, ref, count) against
// the ray: its entry t, and whether the box can hold a hit before lim.
__device__ __forceinline__ bool slab(const Ray& r, int4 a, int4 b, float lim, float& enter) {
  const float ax = (__int_as_float(a.x) - r.ox) * r.ix, bx = (__int_as_float(a.w) - r.ox) * r.ix;
  const float ay = (__int_as_float(a.y) - r.oy) * r.iy, by = (__int_as_float(b.x) - r.oy) * r.iy;
  const float az = (__int_as_float(a.z) - r.oz) * r.iz, bz = (__int_as_float(b.y) - r.oz) * r.iz;
  enter = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
  const float leave = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
  return b.w != 0 && enter <= leave && leave > 0.0f && enter < lim;
}

// Triangle j's three float4s (v0 + the scene index in w, e1, e2).
__device__ __forceinline__ void load_triangle(const float4* __restrict__ tris, int j, float4 (&p)[3]) {
  p[0] = __ldg(tris + 3 * j);
  p[1] = __ldg(tris + 3 * j + 1);
  p[2] = __ldg(tris + 3 * j + 2);
}

// Möller–Trumbore of the ray against a loaded triangle: K1's order. t and
// the scene index where the hit is valid, else (inf, INT_MAX).
__device__ __forceinline__ void test_triangle(const float4 (&p)[3], const Ray& r, float& t_out,
                                              int& idx_out) {
  const float v0x = p[0].x, v0y = p[0].y, v0z = p[0].z;
  const float e1x = p[1].x, e1y = p[1].y, e1z = p[1].z;
  const float e2x = p[2].x, e2y = p[2].y, e2z = p[2].z;
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
  t_out = valid ? t : CUDART_INF_F;
  idx_out = valid ? __float_as_int(p[0].w) : INT_MAX;
}

__device__ __forceinline__ void keep_least(float t, int idx, float& bt, int& bi) {
  if (t < bt || (t == bt && idx < bi)) {
    bt = t;
    bi = idx;
  }
}

__device__ __forceinline__ bool is_live(const Ray& r, int t_count) {
  return t_count > 0 && (r.sx != 0.0f || r.sy != 0.0f || r.sz != 0.0f);
}

// ---- four lanes a ray ----------------------------------------------------
//
// The warp's eight quads step together: each pass of the loop visits one node
// of every quad's ray that is still walking, and every shuffle and ballot is
// the whole warp's (a quad that is done, or past the last ray, joins them on an
// empty record). Shuffles of quads masked apart would each sync on their own.

constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned quad_bits(bool p, int base) {
  return (__ballot_sync(FULL, p) >> base) & 0xFu;
}

// My place in (entry t, slot) order among my quad's children in ``set``.
__device__ __forceinline__ int quad_rank(unsigned set, float enter, int lane, int base) {
  int rank = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float ej = __shfl_sync(FULL, enter, base + j);
    rank += ((set >> j) & 1u) && (ej < enter || (ej == enter && j < lane));
  }
  return rank;
}

__global__ void __launch_bounds__(QUAD_THREADS)
bvh4_quad_kernel(const float* __restrict__ rays, int n, const int4* __restrict__ nodes,
                 const float4* __restrict__ tris, int t_count, float* __restrict__ best_t,
                 int* __restrict__ best_idx, int* __restrict__ counts) {
  __shared__ int2 stack[STACK][QUAD_RAYS];
  const int lane = threadIdx.x & 3, q = threadIdx.x >> 2, base = threadIdx.x & 28;
  const int i = blockIdx.x * QUAD_RAYS + q;
  const Ray r = load_ray(rays, n, min(i, n - 1));
  bool walking = i < n && is_live(r, t_count);
  float bt = NO_HIT_T;
  int bi = 0, visited = 0, tested = 0, sp = 0;
  int4 a = make_int4(0, 0, 0, 0), b = a;  // an empty record: no child kept
  if (walking) {  // the root, child `lane`
    a = __ldg(nodes + 2 * lane);
    b = __ldg(nodes + 2 * lane + 1);
  }
  while (__any_sync(FULL, walking)) {
    visited += walking;
    float enter;
    const bool hit = slab(r, a, b, fminf(bt, 1.0f), enter);
    const int ref = b.z, count = b.w;
    // every kept leaf's triangles, one a lane: triangle `lane` of each leaf
    // loaded first, so that the loads overlap the ordering work below
    const unsigned leaf_warp = __ballot_sync(FULL, hit && count > 0);
    const unsigned leaves = (leaf_warp >> base) & 0xFu;
    int first[4], cnt[4];
    float4 p[4][3];
    if (leaf_warp) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        first[c] = __shfl_sync(FULL, ref, base + c);
        const int cc = __shfl_sync(FULL, count, base + c);
        cnt[c] = ((leaves >> c) & 1u) ? cc : 0;
        tested += cnt[c];
        if (lane < cnt[c]) load_triangle(tris, first[c] + lane, p[c]);
      }
    }
    // fetch the record visited next: the nearest inner child, else the stack's top
    const bool inner_hit = hit && count < 0;
    const unsigned inner_warp = __ballot_sync(FULL, inner_hit);
    const unsigned inner = (inner_warp >> base) & 0xFu;
    int my_rank = 0, next = sp > 0 ? stack[sp - 1][q].x : -1;
    if (inner_warp) {
      my_rank = quad_rank(inner, enter, lane, base);
      const unsigned nearest = quad_bits(inner_hit && my_rank == 0, base);
      const int nearest_ref = __shfl_sync(FULL, ref, base + (nearest ? __ffs(nearest) - 1 : 0));
      if (inner) next = nearest_ref;
    }
    int4 na = a, nb = b;
    if (next >= 0) {
      na = __ldg(nodes + (size_t)next * 8 + 2 * lane);
      nb = __ldg(nodes + (size_t)next * 8 + 2 * lane + 1);
    }
    if (leaf_warp) {  // test the loaded triangles; a leaf of more than four goes on by fours
      float t = CUDART_INF_F;
      int idx = INT_MAX;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (lane < cnt[c]) {
          float tk;
          int ik;
          test_triangle(p[c], r, tk, ik);
          keep_least(tk, ik, t, idx);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        for (int k = lane + 4; k < cnt[c]; k += 4) {
          float4 q4[3];
          float tk;
          int ik;
          load_triangle(tris, first[c] + k, q4);
          test_triangle(q4, r, tk, ik);
          keep_least(tk, ik, t, idx);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ot = __shfl_xor_sync(FULL, t, off);
        const int oi = __shfl_xor_sync(FULL, idx, off);
        keep_least(ot, oi, t, idx);
      }
      keep_least(t, idx, bt, bi);
    }
    // the inner children still kept: a prefix of the order, the fetched one first
    const bool keep = inner_hit && enter < fminf(bt, 1.0f);
    const int kept = __popc(quad_bits(keep, base));
    if (__any_sync(FULL, kept > 1)) {
      __syncwarp();
      if (keep && my_rank > 0)
        stack[sp + kept - 1 - my_rank][q] = make_int2(ref, __float_as_int(enter));
      __syncwarp();
    }
    if (kept) {
      sp += kept - 1;
      a = na;
      b = nb;
      continue;
    }
    bool found = false;
    while (sp > 0) {
      const int2 top = stack[--sp][q];
      if (__int_as_float(top.y) < fminf(bt, 1.0f)) {
        if (top.x == next) {
          a = na;
          b = nb;
        } else {
          a = __ldg(nodes + (size_t)top.x * 8 + 2 * lane);
          b = __ldg(nodes + (size_t)top.x * 8 + 2 * lane + 1);
        }
        found = true;
        break;
      }
    }
    if (!found) {
      walking = false;
      a = b = make_int4(0, 0, 0, 0);
    }
  }
  if (lane == 0 && i < n) {
    best_t[i] = bt;
    best_idx[i] = bi;
    if (counts != nullptr) {
      counts[i] = visited;
      counts[n + i] = tested;
    }
  }
}

}  // namespace

// rays (6, n) [origin xyz, segment xyz]; nodes (n_nodes, 4, 8) i32 and tris
// (t_count, 12) f32, both 16-byte aligned (ops/bvh.py:DeviceBVH); stack_need
// the most stack entries the layout's walk can hold (refused above STACK);
// best_t, best_idx (n,); counts (2, n) [nodes visited, triangles tested] or
// null. *blocks gets the grid.
extern "C" int mcray_bvh_intersect(const float* rays, int n, const int* nodes, const float* tris,
                                   int t_count, int stack_need, float* best_t, int* best_idx,
                                   int* counts, int* blocks, cudaStream_t stream) {
  *blocks = 0;
  if (n <= 0 || t_count < 0 || stack_need > STACK ||
      reinterpret_cast<uintptr_t>(nodes) % 16 || reinterpret_cast<uintptr_t>(tris) % 16)
    return (int)cudaErrorInvalidValue;
  const int grid = (n + QUAD_RAYS - 1) / QUAD_RAYS;
  bvh4_quad_kernel<<<grid, QUAD_THREADS, 0, stream>>>(
      rays, n, reinterpret_cast<const int4*>(nodes), reinterpret_cast<const float4*>(tris), t_count,
      best_t, best_idx, counts);
  *blocks = grid;
  return (int)cudaGetLastError();
}
