// K11: closest hit by stack traversal of the flat BVH, a thread per ray.
//
// No TPU kernel: the reference's traversal (mcray_tpu/ops/bvh.py:121-212) is
// a jnp while_loop that its TPU backend does not compile. The plain version
// is ops/bvh.py:bvh_best_plain, which this kernel equals bitwise (t and
// winner): the same walk, the same slab test on the same padded boxes, and
// the Möller–Trumbore body of K1 (csrc/intersect.cu:test_triangle) in its
// operation order, built with -fmad=false and an IEEE-rounded 1/det. K1
// keeps its own copy: a shared header cost it 3-10%. The winner is the least
// (t, triangle index), as K1's, so the two agree bit for bit.
//
// Layout (ops/bvh.py): nodes (N, 6) f32 [min xyz, max xyz]; meta (N, 2) i32,
// inner node -> (right child, -1), the left child is node + 1, leaf ->
// (first, count) into the BVH order; tris (9, T) f32 SoA [v0, e1, e2] in the
// BVH order and tri_order (T,) i32 each one's index in the scene. Each ray
// starts at the root with an empty STACK_DEPTH stack; a popped node whose box
// the segment enters before min(best t, 1) is a leaf whose triangles are
// tested, or an inner node whose right, then left child are pushed. Stack
// indices are clamped to the stack, as the plain version (and JAX) clamp them.
// A miss is (2.0, 0). The stack lives in the thread's local memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int STACK_DEPTH = 64;
constexpr int LEAF_SIZE = 4;
constexpr float NO_HIT_T = 2.0f;
constexpr float DET_EPS = 1e-9f;

struct Ray {
  float ox, oy, oz, sx, sy, sz;
};

// Möller–Trumbore of the ray against triangle j of the SoA (scene index idx):
// K1's order; kept on the least (t, idx).
__device__ __forceinline__ void test_triangle(const float* __restrict__ tris, int t_count, int j,
                                              int idx, const Ray& r, float& bt, int& bi) {
  const float v0x = __ldg(tris + 0 * t_count + j), v0y = __ldg(tris + 1 * t_count + j),
              v0z = __ldg(tris + 2 * t_count + j);
  const float e1x = __ldg(tris + 3 * t_count + j), e1y = __ldg(tris + 4 * t_count + j),
              e1z = __ldg(tris + 5 * t_count + j);
  const float e2x = __ldg(tris + 6 * t_count + j), e2y = __ldg(tris + 7 * t_count + j),
              e2z = __ldg(tris + 8 * t_count + j);
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
  if (valid && (t < bt || (t == bt && idx < bi))) {
    bt = t;
    bi = idx;
  }
}

__device__ __forceinline__ int clamp_slot(int sp) { return min(max(sp, 0), STACK_DEPTH - 1); }

__global__ void __launch_bounds__(THREADS)
bvh_intersect_kernel(const float* __restrict__ rays, int n, const float* __restrict__ tris,
                     const int* __restrict__ tri_order, int t_count,
                     const float* __restrict__ nodes, const int* __restrict__ meta,
                     float* __restrict__ best_t, int* __restrict__ best_idx,
                     int* __restrict__ counts) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const Ray r{rays[0 * n + i], rays[1 * n + i], rays[2 * n + i],
              rays[3 * n + i], rays[4 * n + i], rays[5 * n + i]};
  const float ix = fabsf(r.sx) > 1e-30f ? 1.0f / r.sx : 1e30f;
  const float iy = fabsf(r.sy) > 1e-30f ? 1.0f / r.sy : 1e30f;
  const float iz = fabsf(r.sz) > 1e-30f ? 1.0f / r.sz : 1e30f;
  float bt = NO_HIT_T;
  int bi = 0, popped = 0, tested = 0;
  int stack[STACK_DEPTH];
  stack[0] = 0;
  int sp = t_count > 0 ? 1 : 0;
  while (sp > 0) {
    sp -= 1;
    ++popped;
    const int node = stack[clamp_slot(sp)];
    const float* box = nodes + (size_t)node * 6;
    const float ax = (__ldg(box + 0) - r.ox) * ix, bx = (__ldg(box + 3) - r.ox) * ix;
    const float ay = (__ldg(box + 1) - r.oy) * iy, by = (__ldg(box + 4) - r.oy) * iy;
    const float az = (__ldg(box + 2) - r.oz) * iz, bz = (__ldg(box + 5) - r.oz) * iz;
    const float enter = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
    const float leave = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
    if (!(enter <= leave && leave > 0.0f && enter < fminf(bt, 1.0f))) continue;
    const int first = __ldg(meta + 2 * node), count = __ldg(meta + 2 * node + 1);
    if (count >= 0) {
      for (int k = 0; k < LEAF_SIZE; ++k) {
        if (k < count) {
          ++tested;
          const int j = min(first + k, t_count - 1);
          test_triangle(tris, t_count, j, __ldg(tri_order + j), r, bt, bi);
        }
      }
    } else {
      stack[clamp_slot(sp)] = first;  // the right child
      stack[clamp_slot(sp + 1)] = node + 1;
      sp += 2;
    }
  }
  best_t[i] = bt;
  best_idx[i] = bi;
  if (counts != nullptr) {
    counts[i] = popped;
    counts[n + i] = tested;
  }
}

}  // namespace

// rays (6, n) [origin xyz, segment xyz]; tris (9, t_count) in the BVH order,
// tri_order (t_count,) their scene indices; nodes (n_nodes, 6), meta
// (n_nodes, 2); best_t, best_idx (n,); counts (2, n) [nodes popped,
// triangles tested] or null. *blocks gets the grid.
extern "C" int mcray_bvh_intersect(const float* rays, int n, const float* tris,
                                   const int* tri_order, int t_count, const float* nodes,
                                   const int* meta, float* best_t, int* best_idx, int* counts,
                                   int* blocks, cudaStream_t stream) {
  *blocks = 0;
  if (n <= 0) return (int)cudaGetLastError();
  const int grid = (n + THREADS - 1) / THREADS;
  bvh_intersect_kernel<<<grid, THREADS, 0, stream>>>(rays, n, tris, tri_order, t_count, nodes,
                                                     meta, best_t, best_idx, counts);
  *blocks = grid;
  return (int)cudaGetLastError();
}
