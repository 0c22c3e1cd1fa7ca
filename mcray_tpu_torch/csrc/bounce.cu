// The bounce physics: one launch a bounce runs everything a path does between
// two closest hits.
//
// Replaces no TPU kernel: the reference traces in jnp (the bounce loop of
// mcray_tpu/models/simulator.py:trace_paths and ops/physics.py:hit_boundary),
// which XLA fuses. The port's plain version (ops/cuda/bounce.py:rays_plain and
// bounce_plain) runs it as ~300 small elementwise PyTorch launches a bounce,
// each reading and writing (N,) or (N, 3) tensors: a chained step of 8 frames
// (20,480 paths) spent ~3.8 ms of device time in ~2,400 of them.
//
// bounce_physics_kernel<false>, one thread a path, launched once a bounce d
// after its closest hit: the sub-surface fuzz and the inside point, the
// distance in mm and the travel attenuation, the boundary (the material
// transition, the power-cosine normal, Snell, Fresnel, total internal
// reflection, the Mattausch backscatter, the roulette), the end of segment d
// (its `to` and `reflected`), the path's next state with the time-window cull,
// and the next bounce's closest-hit query: its attenuation, reach, origin,
// far end and segment, written as row d + 1 of the record.
// bounce_physics_kernel<true> writes row 0 from the elements (each path at its
// element, in the starting material) and bounce 0's query: a trace of D
// bounces is D + 1 launches.
//
// The record is the trace's (D + 1, N, ...) buffers: a bounce's state is its
// row's `from`, `direction`, `initial`, `distance`, `media_id`, `valid`,
// `outside` and `attenuation` (the fields of the segment it starts, and the
// media outside a vessel), so a launch reads row d and writes row d + 1, and
// no stack of per-bounce tensors is made; `to` holds the query's far end
// until the bounce's hit replaces it, and `query` the ray the closest hit
// reads. Row D holds the state after the last bounce.
//
// Arithmetic: the plain version's, one rounding at a time (the library is
// built with -fmad=false, and every product and sum is its own expression),
// in its order: dot products summed left to right, divisions IEEE (the plain
// version divides tensor by tensor, never by a Python scalar), scalar
// operands rounded to f32 as PyTorch rounds them, material and mesh ids
// clamped as take_rows clamps them, the double `where` around the refraction's
// sqrt, clamps that pass a NaN through as torch.clamp does. sqrtf, expf, logf,
// powf, sinf and cosf are the functions PyTorch's CUDA kernels call for
// torch.sqrt, exp, log, pow, sin and cos, so the record is the plain
// version's bit for bit on the card.
//
// Bound: bytes, 179 a path-bounce (utils/roofline.py:BOUNCE_BYTES): the
// state row, the hit record and five draws read, the segment's end and the
// next row with its ray written; 3.67 MB a bounce of 20,480 paths, 1.09 us at
// 3.35 TB/s, and ~240 operations a path, far below. At that size the launch
// and the dependent chain of a path's transcendentals set the time, so the
// design keeps it to one launch a bounce: the (M, 8) material table and the
// per-mesh tables sit in shared memory (each thread gathers rows by the ids
// of its own path), and neighbouring threads read and write neighbouring
// elements of every (N,) and (N, 3) field, so each warp's accesses are
// whole contiguous spans. Blocks of 64 threads spread a bounce over 320
// blocks, more than two a multiprocessor.
//
// Backward: bounce_physics_bwd_kernel, one launch for each forward launch
// (each an autograd Function of the wrapper), in the forward's block shape and
// with its tables in shared memory. Each thread recomputes its path's bounce
// in registers by the forward's own code (boundary, query_of), then runs the
// hand-derived adjoint of that chain, op for op the plain twin
// (ops/cuda/bounce.py:bounce_adjoint_plain, start_adjoint_plain), which is
// autograd over the plain version lane for lane: it keeps its masks and
// wheres (the roulette, total internal reflection and the eps cut-offs carry
// no gradient, the reach is detached, the refracted angle's derivative is 0
// where refr_sq is not positive, the floored shininess has none). It reads
// the gradients of segment d's end and reflection and of row d + 1, and
// writes those of row d, of the hit's point and normal and of the material
// table. The table's gradient takes no atomics: each block sums its paths'
// five contributions (the next row's attenuation, the two impedances, the
// specularity, the thickness) path by path in shared memory, and a second
// pass (bounce_physics_bwd_sum_kernel, a block a table entry) adds the
// blocks' partial sums by a fixed tree, so a launch's gradient is the same
// bits on every run. Both sums run in double and round to f32 once: a path
// in the gel (attenuation 1e-8) reaches ~1e9 away, so a gradient on its far
// end puts terms of ~1e9 into the impedances, and an f32 sum of 20,480 such
// terms moves by up to ~6e-5 of itself with its order (autograd's, by the
// card's atomics); in double no order moves the f32 result but by a tie.
// Row 0's backward (the first mode) sums each element's paths in order into
// its position and direction. Bound: bytes, 254 a path-bounce
// (utils/roofline.py:BOUNCE_BWD_BYTES): the state row, the hit record and the
// draws read as the forward reads them, 88 bytes of incoming gradients read
// and 72 of outgoing ones written; 5.2 MB a bounce of 20,480 paths, 1.55 us.
// The block's table sums take about half of a launch's time.

#include <cuda_runtime.h>
#include <stdint.h>

// The arguments of one launch (ops/cuda/bounce.py:_Args mirrors this layout).
struct McrayBounceArgs {
  // row 0 (the launch with first != 0): the elements and the start
  const float* positions;   // (R, 3)
  const float* directions;  // (R, 3)
  int local_samples;        // paths an element: path i starts at element i / local_samples
  int starting_material;
  float initial_intensity;
  // bounce `depth`'s closest hit (the other launches)
  const uint8_t* hit;       // (N,) bool
  const float* point;       // (N, 3)
  const float* normal;      // (N, 3), oriented toward the segment's origin
  const int* mesh_id;       // (N,)
  // the trace's draws, five (D, N) fields
  const float* q_normal;
  const float* angle_u;
  const float* axis_u;
  const float* radius_u;
  const float* roulette_u;
  // the scene's tables
  const float* materials;   // (n_materials, 8)
  int n_materials;
  const int* mesh_inside;   // (n_mesh,)
  const int* mesh_outside;  // (n_mesh,)
  const uint8_t* mesh_vascular;  // (n_mesh,) bool
  int n_mesh;
  const float* spacing;     // (3,)
  // the record: (D + 1, N, ...) rows; reflected (D, N); query (D + 1, 2, N, 3):
  // a row's [origin; segment], (N, 3) each
  float* from;
  float* to;
  float* direction;
  float* reflected;
  float* initial;
  float* attenuation;
  float* distance;
  int* media_id;
  uint8_t* valid;
  int* outside;
  float* query;
  // the configuration, rounded to f32 as PyTorch rounds a Python scalar
  float eps;                // intensity_epsilon
  float eps_floor;          // intensity_epsilon * 1e-3
  float frequency;
  float ray_start_offset;
  float speed_of_sound;
  float max_travel_time_us;
  int bug_compat_material_transition;
  int cull_time_window;
  int n;                    // paths
  int depth;                // the bounce whose physics the launch runs (row depth + 1 follows)
  int first;                // 1: write row 0 from the elements instead
};

// The arguments of one backward launch (ops/cuda/bounce.py:_BwdArgs mirrors
// this layout): the forward launch's, then the gradients reaching its outputs
// (null: zero) and the gradients of its inputs (null: not asked for).
struct McrayBounceBwdArgs {
  McrayBounceArgs fwd;
  // segment `depth`'s end (N, 3) and reflection (N,); none in the first mode
  const float* g_to;
  const float* g_reflected;
  // the row the launch wrote (row depth + 1; row 0 in the first mode): its
  // GRADED_ROW fields, (N, 3) or (N,); its far end `to` as g_far; query (2, N, 3)
  const float* g_from;
  const float* g_direction;
  const float* g_initial;
  const float* g_distance;
  const float* g_attenuation;
  const float* g_far;
  const float* g_query;
  // row `depth`'s fields and the hits' point and normal, (N, 3) or (N,)
  float* d_from;
  float* d_direction;
  float* d_initial;
  float* d_distance;
  float* d_attenuation;
  float* d_to;
  float* d_point;
  float* d_normal;
  // the table's gradient (n_materials, 8) and its per-block partial sums in
  // double (blocks, n_materials, 4: the columns a path reaches); both or neither
  float* d_materials;
  double* partials;
  // the first mode: each path's gradient of its element's position and
  // direction (2, N, 3), then their sums by element, (n_elements, 3) each
  float* path_grads;
  float* d_positions;
  float* d_directions;
  int n_elements;
};

namespace {

constexpr int THREADS = 64;
// material table columns (ops/physics.py)
constexpr int IMPEDANCE = 0, ATTENUATION = 1, SPECULARITY = 5, SHININESS = 6, THICKNESS = 7;
constexpr int COLUMNS = 8;
constexpr float TWO_PI = 6.2831853071795864769f;  // 2 pi, rounded to f32 as PyTorch rounds it
constexpr float PARKED = 1e9f;                     // a dead path's origin

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, size_t i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* p, size_t i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// geometry.dot3: summed left to right
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// torch.clamp(x, min=lo): a NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// geometry.safe_norm: 0 where the squared norm is not positive
__device__ __forceinline__ float safe_norm(V3 v) {
  const float s = dot3(v, v);
  return s > 0.0f ? sqrtf(s) : 0.0f;
}

// geometry.normalize(v, eps=1e-20)
__device__ __forceinline__ V3 normalize(V3 v) {
  const float n = clamp_min(safe_norm(v), 1e-20f);
  return {v.x / n, v.y / n, v.z / n};
}

// physics.safe_pow: max(base, 0)^exponent with 0^e = 0
__device__ __forceinline__ float safe_pow(float base, float exponent) {
  return base > 0.0f ? powf(base, exponent) : 0.0f;
}

// take_rows' clamp of an id to [0, m - 1]
__device__ __forceinline__ int clamp_id(int id, int m) {
  return id < 0 ? 0 : (id > m - 1 ? m - 1 : id);
}

// A path's state at the start of a bounce.
struct State {
  V3 src, dir;
  float intensity, distance;
  int media, outside;
  bool alive;
};

// A row's closest-hit query (rays_plain): the medium's attenuation, the
// reach (the attenuation-bounded length over 100), the far end, and the ray
// as the closest hit takes it (origin parked and segment zero on a dead path).
struct Query {
  float att, reach;
  V3 dest, origin, seg;
};

__device__ __forceinline__ Query query_of(const McrayBounceArgs& a, const float* mat,
                                          const State& s) {
  Query q;
  q.att = mat[clamp_id(s.media, a.n_materials) * COLUMNS + ATTENUATION];
  // max_ray_length: 10 log(eps / I) / -att * frequency, I clamped
  const float r_length =
      10.0f * logf(a.eps / clamp_min(s.intensity, a.eps_floor)) / -q.att * a.frequency;
  q.reach = r_length / 100.0f;
  const V3 sp = {a.spacing[0], a.spacing[1], a.spacing[2]};
  q.origin = {s.src.x + a.ray_start_offset * s.dir.x, s.src.y + a.ray_start_offset * s.dir.y,
              s.src.z + a.ray_start_offset * s.dir.z};
  q.dest = {s.src.x + q.reach * sp.x * s.dir.x, s.src.y + q.reach * sp.y * s.dir.y,
            s.src.z + q.reach * sp.z * s.dir.z};
  const float live = s.alive ? 1.0f : 0.0f;
  q.seg = {(q.dest.x - q.origin.x) * live, (q.dest.y - q.origin.y) * live,
           (q.dest.z - q.origin.z) * live};
  if (!s.alive) q.origin = {PARKED, PARKED, PARKED};
  return q;
}

// Row `row` of the record: the state, then the bounce's closest-hit query.
__device__ void write_row(const McrayBounceArgs& a, const float* mat, int row, int i,
                          const State& s) {
  const size_t n = (size_t)a.n, r = (size_t)row * n + i;
  store3(a.from, r, s.src);
  store3(a.direction, r, s.dir);
  a.initial[r] = s.intensity;
  a.distance[r] = s.distance;
  a.media_id[r] = s.media;
  a.valid[r] = s.alive;
  a.outside[r] = s.outside;
  const Query q = query_of(a, mat, s);
  a.attenuation[r] = q.att;
  store3(a.to, r, q.dest);
  store3(a.query, (size_t)row * 2 * n + i, q.origin);
  store3(a.query, ((size_t)row * 2 + 1) * n + i, q.seg);
}

// physics.random_unit_vector_from_uniforms' intermediates
struct Disc {
  float px0, py0, p, vx, vy, vz, b0, b, x0, c, px, py, d;
  bool flag;
};

// physics.random_unit_vector_from_uniforms: the vector at polar angle
// arccos(cos_theta) around v
__device__ __forceinline__ V3 random_unit_vector(float u_a, float u_r, V3 v, float cos_theta,
                                                 Disc& k) {
  const float ang = u_a * TWO_PI;
  const float r = 0.5f * sqrtf(u_r);
  k.px0 = r * cosf(ang);
  k.py0 = r * sinf(ang);
  k.p = clamp_min(k.px0 * k.px0 + k.py0 * k.py0, 1e-12f);
  k.flag = fabsf(v.x) > fabsf(v.y);
  k.vx = k.flag ? v.y : v.x;
  k.vy = k.flag ? v.x : v.y;
  k.vz = v.z;
  k.b0 = 1.0f - k.vx * k.vx;
  k.b = clamp_min(k.b0, 1e-12f);
  k.x0 = (1.0f - cos_theta * cos_theta) / (k.p * k.b);
  k.c = sqrtf(clamp_min(k.x0, 1e-20f));
  k.px = k.px0 * k.c;
  k.py = k.py0 * k.c;
  k.d = cos_theta - k.vx * k.px;
  const float wx = k.vx * cos_theta - k.b * k.px;
  const float wy = k.vy * k.d + k.vz * k.py;
  const float wz = k.vz * k.d - k.vy * k.py;
  return {k.flag ? wy : wx, k.flag ? wx : wy, wz};
}

// What a live path does at its closest hit (ops/cuda/bounce.py:bounce_parts):
// the fuzz, the travel, the boundary and the next state, with the
// intermediates the backward reads.
struct Boundary {
  float thick, q, dist_mm, travel, intensity;
  V3 inside;
  int m_in, mat_after;
  float angle;
  Disc disc;
  V3 rn;
  float cos_in, incidence, z1, z2, ratio, refr_angle, k, twice;
  bool tir, refracts, reflect;
  V3 refr_vec, refr_dir, refl_vec, refl_dir;
  float i_refl, i_refr, spec, back;
  State next;
};

__device__ __forceinline__ void boundary(const McrayBounceArgs& a, const float* mat,
                                         const int* mesh_in, const int* mesh_out,
                                         const int* mesh_vasc, size_t r, int i, const State& s,
                                         Boundary& h) {
  const float eps = a.eps;
  const float att = a.attenuation[r];
  const V3 point = load3(a.point, i), normal = load3(a.normal, i);
  const int mesh = clamp_id(a.mesh_id[i], a.n_mesh);
  h.m_in = mesh_in[mesh];
  const int m_out = mesh_out[mesh];
  const bool vascular = mesh_vasc[mesh] != 0;

  // sub-surface fuzz: q = |N(0, thickness inside)|
  h.thick = mat[clamp_id(h.m_in, a.n_materials) * COLUMNS + THICKNESS];
  h.q = fabsf(a.q_normal[r] * h.thick);
  h.inside = {point.x + h.q * s.dir.x, point.y + h.q * s.dir.y, point.z + h.q * s.dir.z};
  // distance_in_mm, then the travel attenuation
  const V3 span = {fabsf(s.src.x - h.inside.x) * a.spacing[0],
                   fabsf(s.src.y - h.inside.y) * a.spacing[1],
                   fabsf(s.src.z - h.inside.z) * a.spacing[2]};
  h.dist_mm = safe_norm(span) * 10.0f;
  h.travel = expf(-att * h.dist_mm * 0.01f * a.frequency);
  h.intensity = s.intensity * h.travel;

  // hit_boundary: the material transition (physics.material_transition)
  const bool in_vessel = s.outside >= 0;
  const int o2 = s.outside == h.m_in ? m_out : h.m_in;
  const int m4 = a.bug_compat_material_transition ? h.m_in : (s.media == h.m_in ? m_out : h.m_in);
  h.mat_after = in_vessel ? (vascular ? s.outside : s.media) : (vascular ? h.m_in : m4);
  const int out_after = in_vessel ? (vascular ? -1 : o2) : (vascular ? s.media : -1);
  const float* row_media = mat + clamp_id(s.media, a.n_materials) * COLUMNS;
  const float* row_after = mat + clamp_id(h.mat_after, a.n_materials) * COLUMNS;
  // the power-cosine normal
  const float exponent = 1.0f / (floorf(row_after[SHININESS]) + 1.0f);
  h.angle = powf(a.angle_u[r], exponent);
  h.rn = random_unit_vector(a.axis_u[r], a.radius_u[r], normal, h.angle, h.disc);
  // Snell and Fresnel
  h.cos_in = dot3(s.dir, h.rn);
  h.incidence = fabsf(h.cos_in);
  h.z1 = row_media[IMPEDANCE];
  h.z2 = row_after[IMPEDANCE];
  h.ratio = h.z1 / h.z2;
  const float refr_sq = 1.0f - h.ratio * h.ratio * (1.0f - h.incidence * h.incidence);
  h.tir = refr_sq < 0.0f;
  h.refracts = refr_sq > 0.0f;
  h.refr_angle = h.refracts ? sqrtf(refr_sq) : 0.0f;
  h.k = h.ratio * h.incidence - h.refr_angle;
  h.refr_vec = {h.ratio * s.dir.x + h.k * h.rn.x, h.ratio * s.dir.y + h.k * h.rn.y,
                h.ratio * s.dir.z + h.k * h.rn.z};
  h.refr_dir = normalize(h.refr_vec);
  h.twice = 2.0f * h.incidence;
  h.refl_vec = {s.dir.x + h.twice * h.rn.x, s.dir.y + h.twice * h.rn.y,
                s.dir.z + h.twice * h.rn.z};
  h.refl_dir = normalize(h.refl_vec);
  h.i_refl = h.intensity;
  if (!h.tir) {
    const float num = h.z1 * h.incidence - h.z2 * h.refr_angle;
    const float den = h.z1 * h.incidence + h.z2 * h.refr_angle;
    const float ratio_r = num / den;
    h.i_refl = h.intensity * (ratio_r * ratio_r);
  }
  h.i_refr = h.intensity - h.i_refl;
  // the Mattausch backscatter; under TIR the refraction term is 0
  h.spec = row_after[SPECULARITY];
  const float refr_term = h.tir ? 0.0f : safe_pow(dot3(s.dir, h.refr_dir), h.spec);
  h.back = (refr_term + safe_pow(dot3(s.dir, h.refl_dir), h.spec)) * h.angle;
  // the roulette: go on with one of reflection and refraction
  h.reflect = h.i_refl / clamp_min(h.intensity, eps) > a.roulette_u[r];
  const float refl_int = h.i_refl > eps ? h.i_refl : 0.0f;
  const float refr_int = h.i_refr > eps ? h.i_refr : 0.0f;
  const float new_intensity = h.reflect ? refl_int : refr_int;

  bool alive = new_intensity > eps;
  const float distance = s.distance + h.dist_mm;
  if (a.cull_time_window) alive = alive && distance * 1000.0f / a.speed_of_sound < a.max_travel_time_us;
  h.next = {point, h.reflect ? h.refl_dir : h.refr_dir, new_intensity, distance,
            h.reflect ? s.media : h.mat_after, h.reflect ? s.outside : out_after, alive};
}

// The material table and (`meshes`) the per-mesh tables into shared memory.
__device__ __forceinline__ void load_tables(const McrayBounceArgs& a, float* mat, int* mesh_in,
                                            int* mesh_out, int* mesh_vasc, bool meshes) {
  for (int k = threadIdx.x; k < a.n_materials * COLUMNS; k += THREADS) mat[k] = a.materials[k];
  if (meshes) {
    for (int k = threadIdx.x; k < a.n_mesh; k += THREADS) {
      mesh_in[k] = a.mesh_inside[k];
      mesh_out[k] = a.mesh_outside[k];
      mesh_vasc[k] = a.mesh_vascular[k];
    }
  }
}

__device__ __forceinline__ State load_state(const McrayBounceArgs& a, size_t r) {
  return {load3(a.from, r), load3(a.direction, r), a.initial[r], a.distance[r], a.media_id[r],
          a.outside[r], a.valid[r] != 0};
}

template <bool kFirst>
__global__ void __launch_bounds__(THREADS) bounce_physics_kernel(const McrayBounceArgs a) {
  extern __shared__ float shared[];
  float* mat = shared;
  int* mesh_in = reinterpret_cast<int*>(shared + a.n_materials * COLUMNS);
  int* mesh_out = mesh_in + a.n_mesh;
  int* mesh_vasc = mesh_out + a.n_mesh;
  load_tables(a, mat, mesh_in, mesh_out, mesh_vasc, !kFirst);
  __syncthreads();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;

  if (kFirst) {
    const int e = i / a.local_samples;
    const State s = {load3(a.positions, e), load3(a.directions, e), a.initial_intensity, 0.0f,
                     a.starting_material, -1, true};
    write_row(a, mat, 0, i, s);
    return;
  }

  const size_t r = (size_t)a.depth * a.n + i;
  State s = load_state(a, r);
  float back = 0.0f;
  if (s.alive && a.hit[i] != 0) {
    Boundary h;
    boundary(a, mat, mesh_in, mesh_out, mesh_vasc, r, i, s, h);
    store3(a.to, r, h.inside);
    back = h.back;
    s = h.next;
  } else {
    s.alive = false;
  }
  a.reflected[r] = back;
  write_row(a, mat, a.depth + 1, i, s);
}

// ---------------------------------------------------------------------------
// The backward: the hand-derived adjoint of a launch, op for op its plain twin
// (ops/cuda/bounce.py: bounce_adjoint_plain for a bounce, start_adjoint_plain
// for row 0, the first mode).

__device__ __forceinline__ V3 add3(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale3(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 mul3(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
// torch.sign: 1, -1 or 0
__device__ __forceinline__ float sign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
// an incoming gradient; a null pointer is zero
__device__ __forceinline__ V3 grad3(const float* p, size_t i) {
  return p ? load3(p, i) : V3{0.0f, 0.0f, 0.0f};
}
__device__ __forceinline__ float grad1(const float* p, size_t i) { return p ? p[i] : 0.0f; }
// an output gradient; a null pointer was not asked for
__device__ __forceinline__ void out3(float* p, size_t i, V3 v) {
  if (p) store3(p, i, v);
}
__device__ __forceinline__ void out1(float* p, size_t i, float v) {
  if (p) p[i] = v;
}

// query_adjoint: a row's from, direction, to and query in its src and
// direction; `factor` is the reach times the spacing
__device__ __forceinline__ void query_adjoint(const McrayBounceBwdArgs& b, int i, bool alive,
                                              V3 factor, V3& g_src, V3& g_dir) {
  const size_t n = (size_t)b.fwd.n;
  const V3 g_origin_in = grad3(b.g_query, i), g_seg = grad3(b.g_query, n + i);
  const float live = alive ? 1.0f : 0.0f;
  const V3 g_dest = add3(grad3(b.g_far, i), scale3(g_seg, live));
  const V3 g_origin = sub3(alive ? g_origin_in : V3{0.0f, 0.0f, 0.0f}, scale3(g_seg, live));
  g_src = add3(add3(grad3(b.g_from, i), g_dest), g_origin);
  g_dir = add3(add3(grad3(b.g_direction, i), mul3(g_dest, factor)),
               scale3(g_origin, b.fwd.ray_start_offset));
}

// safe_pow's adjoint in its base and its exponent
__device__ __forceinline__ void safe_pow_adjoint(float base, float exponent, float g,
                                                 float& g_base, float& g_exponent) {
  const bool ok = base > 0.0f;
  const float bs = ok ? base : 1.0f;
  g_base = ok && exponent != 0.0f ? g * (exponent * powf(bs, exponent - 1.0f)) : 0.0f;
  g_exponent = ok ? g * (powf(bs, exponent) * logf(bs)) : 0.0f;
}

// geometry.normalize(v, eps=1e-20)'s adjoint in v
__device__ __forceinline__ V3 normalize_adjoint(V3 v, V3 g) {
  const float ss = dot3(v, v);
  const bool ok = ss > 0.0f;
  const float norm = ok ? sqrtf(ss) : 0.0f;
  const float n = clamp_min(norm, 1e-20f);
  // autograd's division backward: -g ((v / n) / n), summed over the axes
  const float g_n = -g.x * ((v.x / n) / n) + -g.y * ((v.y / n) / n) + -g.z * ((v.z / n) / n);
  const float g_ss = ok && norm >= 1e-20f ? g_n / (2.0f * norm) : 0.0f;
  const float g2 = 2.0f * g_ss;
  return {g.x / n + g2 * v.x, g.y / n + g2 * v.y, g.z / n + g2 * v.z};
}

// random_unit_vector's adjoint in the surface normal (the draws and the
// power-cosine angle carry none)
__device__ __forceinline__ V3 random_unit_vector_adjoint(const Disc& k, float cos_theta, V3 g) {
  const float g_wx = k.flag ? g.y : g.x;
  const float g_wy = k.flag ? g.x : g.y;
  const float g_wz = g.z;
  float g_vx = g_wx * cos_theta;
  float g_b = -(g_wx * k.px);
  float g_px = -(g_wx * k.b);
  const float g_vy = g_wy * k.d - g_wz * k.py;
  const float g_vz = g_wy * k.py + g_wz * k.d;
  const float g_d = g_wy * k.vy + g_wz * k.vz;
  const float g_py = g_wy * k.vz - g_wz * k.vy;
  g_vx = g_vx - g_d * k.px;
  g_px = g_px - g_d * k.vx;
  const float g_c = g_px * k.px0 + g_py * k.py0;
  const float g_x0 = k.x0 >= 1e-20f ? g_c / (2.0f * k.c) : 0.0f;
  g_b = g_b - g_x0 * (k.x0 / (k.p * k.b)) * k.p;
  g_vx = g_vx - (k.b0 >= 1e-12f ? 2.0f * (g_b * k.vx) : 0.0f);
  return {k.flag ? g_vy : g_vx, k.flag ? g_vx : g_vy, g_vz};
}

// a path's contributions to the table's gradient, its slots
// (ops/cuda/bounce.py:SLOT_COLUMNS): the next row's attenuation, the
// impedances of the medium and of the medium after the boundary, the
// specularity, the thickness
constexpr int SLOTS = 5;
// the table columns the slots reach, in the block's partial sums: the
// impedance (slots 1, 2), the attenuation (0), the specularity (3), the
// thickness (4)
constexpr int TABLE_COLUMNS = 4;

template <bool kFirst>
__global__ void __launch_bounds__(THREADS)
    bounce_physics_bwd_kernel(const __grid_constant__ McrayBounceBwdArgs b) {
  const McrayBounceArgs& a = b.fwd;
  extern __shared__ float shared[];
  __shared__ int slot_row[THREADS * SLOTS];
  __shared__ float slot_value[THREADS * SLOTS];
  float* mat = shared;
  int* mesh_in = reinterpret_cast<int*>(shared + a.n_materials * COLUMNS);
  int* mesh_out = mesh_in + a.n_mesh;
  int* mesh_vasc = mesh_out + a.n_mesh;
  load_tables(a, mat, mesh_in, mesh_out, mesh_vasc, !kFirst);
  int* rows = slot_row + threadIdx.x * SLOTS;
  float* values = slot_value + threadIdx.x * SLOTS;
  for (int s = 0; s < SLOTS; ++s) rows[s] = -1;
  __syncthreads();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const size_t n = (size_t)a.n;
  const int m = a.n_materials;
  const V3 sp = {a.spacing[0], a.spacing[1], a.spacing[2]};

  if (i < a.n && kFirst) {
    const int e = i / a.local_samples;
    const State s = {load3(a.positions, e), load3(a.directions, e), a.initial_intensity, 0.0f,
                     a.starting_material, -1, true};
    const Query q = query_of(a, mat, s);
    V3 g_src, g_dir;
    query_adjoint(b, i, s.alive, scale3(sp, q.reach), g_src, g_dir);
    out3(b.path_grads, i, g_src);
    out3(b.path_grads, n + i, g_dir);
    rows[0] = clamp_id(s.media, m);
    values[0] = grad1(b.g_attenuation, i);
  } else if (i < a.n) {
    const float eps = a.eps;
    const size_t r = (size_t)a.depth * n + i;
    const State s = load_state(a, r);
    const bool hit = s.alive && a.hit[i] != 0;
    Boundary h;
    State next = s;
    next.alive = false;
    if (hit) {
      boundary(a, mat, mesh_in, mesh_out, mesh_vasc, r, i, s, h);
      next = h.next;
    }
    // the next row's query, then the next state
    const Query nq = query_of(a, mat, next);
    V3 g_src_n, g_dir_n;
    query_adjoint(b, i, next.alive, scale3(sp, nq.reach), g_src_n, g_dir_n);
    rows[0] = clamp_id(next.media, m);
    values[0] = grad1(b.g_attenuation, i);
    const float g_initial_n = grad1(b.g_initial, i), g_distance_n = grad1(b.g_distance, i);
    const V3 g_to = grad3(b.g_to, i), zero = {0.0f, 0.0f, 0.0f};
    out1(b.d_distance, i, g_distance_n);
    if (!hit) {
      // the path passes its row through; its segment ends at the row's far end
      out3(b.d_from, i, g_src_n);
      out3(b.d_direction, i, g_dir_n);
      out1(b.d_initial, i, g_initial_n);
      out1(b.d_attenuation, i, 0.0f);
      out3(b.d_to, i, g_to);
      out3(b.d_point, i, zero);
      out3(b.d_normal, i, zero);
    } else {
      const V3 u = s.dir;
      float g_i_refl = h.reflect && h.i_refl > eps ? g_initial_n : 0.0f;
      const float g_i_refr = !h.reflect && h.i_refr > eps ? g_initial_n : 0.0f;
      V3 g_refl_dir = h.reflect ? g_dir_n : zero;
      V3 g_refr_dir = h.reflect ? zero : g_dir_n;

      // the backscatter
      const float g_term = grad1(b.g_reflected, i) * h.angle;
      float g_cos_refl, g_spec, g_cos_refr, g_spec_refr;
      safe_pow_adjoint(dot3(u, h.refl_dir), h.spec, g_term, g_cos_refl, g_spec);
      safe_pow_adjoint(dot3(u, h.refr_dir), h.spec, h.tir ? 0.0f : g_term, g_cos_refr,
                       g_spec_refr);
      g_spec = g_spec + g_spec_refr;
      V3 g_u = add3(scale3(h.refl_dir, g_cos_refl), scale3(h.refr_dir, g_cos_refr));
      g_refl_dir = add3(g_refl_dir, scale3(u, g_cos_refl));
      g_refr_dir = add3(g_refr_dir, scale3(u, g_cos_refr));

      // Fresnel
      g_i_refl = g_i_refl - g_i_refr;
      float g_travelled, g_z1 = 0.0f, g_z2 = 0.0f, g_inc = 0.0f, g_ca = 0.0f;
      if (h.tir) {
        g_travelled = g_i_refr + g_i_refl;
      } else {
        const float num = h.z1 * h.incidence - h.z2 * h.refr_angle;
        const float den = h.z1 * h.incidence + h.z2 * h.refr_angle;
        const float ratio_r = num / den;
        g_travelled = g_i_refr + g_i_refl * (ratio_r * ratio_r);
        const float g_ratio_r = g_i_refl * h.intensity * (2.0f * ratio_r);
        const float g_num = g_ratio_r / den;
        const float g_den = -g_ratio_r * (ratio_r / den);
        // each product on its own, the denominator's first (the twin says why)
        g_z1 = g_den * h.incidence + g_num * h.incidence;
        g_z2 = g_den * h.refr_angle - g_num * h.refr_angle;
        g_inc = g_den * h.z1 + g_num * h.z1;
        g_ca = g_den * h.z2 - g_num * h.z2;
      }

      // the two directions
      const V3 g_refr_v = normalize_adjoint(h.refr_vec, g_refr_dir);
      const V3 g_refl_v = normalize_adjoint(h.refl_vec, g_refl_dir);
      g_u = add3(add3(g_u, scale3(g_refr_v, h.ratio)), g_refl_v);
      const float g_k = dot3(g_refr_v, h.rn);
      V3 g_rn = add3(scale3(g_refr_v, h.k), scale3(g_refl_v, h.twice));
      float g_ratio = dot3(g_refr_v, u) + g_k * h.incidence;
      g_inc = g_inc + 2.0f * dot3(g_refl_v, h.rn) + g_k * h.ratio;
      g_ca = g_ca - g_k;

      // the refracted angle (derivative 0 where refr_sq is not positive),
      // the ratio of impedances
      const float g_refr_sq = h.refracts ? g_ca / (2.0f * h.refr_angle) : 0.0f;
      const float w = 1.0f - h.incidence * h.incidence;
      g_ratio = g_ratio - 2.0f * ((g_refr_sq * w) * h.ratio);
      g_inc = g_inc + 2.0f * ((g_refr_sq * (h.ratio * h.ratio)) * h.incidence);
      g_z1 = g_z1 + g_ratio / h.z2;
      g_z2 = g_z2 - g_ratio * (h.ratio / h.z2);

      // the incidence, then the power-cosine normal into the surface's
      const float g_cos_in = g_inc * sign(h.cos_in);
      g_u = add3(g_u, scale3(h.rn, g_cos_in));
      g_rn = add3(g_rn, scale3(u, g_cos_in));
      const V3 g_normal = random_unit_vector_adjoint(h.disc, h.angle, g_rn);

      // the travel
      const float att = a.attenuation[r];
      const float g_intensity = g_travelled * h.travel;
      const float g_e1 = g_travelled * s.intensity * h.travel * a.frequency * 0.01f;
      const float g_att = -(g_e1 * h.dist_mm);
      const float g_dist = g_e1 * -att + g_distance_n;
      // the distance, then the fuzz
      const V3 diff = sub3(s.src, h.inside);
      const V3 span = mul3({fabsf(diff.x), fabsf(diff.y), fabsf(diff.z)}, sp);
      const float ss = dot3(span, span);
      const float norm = ss > 0.0f ? sqrtf(ss) : 0.0f;
      const float g_ss = ss > 0.0f ? (g_dist * 10.0f) / (2.0f * norm) : 0.0f;
      const V3 g_diff = mul3(mul3(scale3(span, 2.0f * g_ss), sp),
                             {sign(diff.x), sign(diff.y), sign(diff.z)});
      const V3 g_inside = sub3(g_to, g_diff);
      g_u = add3(g_u, scale3(g_inside, h.q));
      const float qn = a.q_normal[r];
      const float g_thick = dot3(g_inside, u) * sign(qn * h.thick) * qn;

      out3(b.d_from, i, g_diff);
      out3(b.d_direction, i, g_u);
      out1(b.d_initial, i, g_intensity);
      out1(b.d_attenuation, i, g_att);
      out3(b.d_to, i, zero);
      out3(b.d_point, i, add3(g_inside, g_src_n));
      out3(b.d_normal, i, g_normal);
      rows[1] = clamp_id(s.media, m);
      values[1] = g_z1;
      rows[2] = clamp_id(h.mat_after, m);
      values[2] = g_z2;
      rows[3] = rows[2];
      values[3] = g_spec;
      rows[4] = clamp_id(h.m_in, m);
      values[4] = g_thick;
    }
  }

  // the block's partial sums of the table's gradient in double, path by
  // path and slot by slot: no atomics, the same order on every run
  if (!b.partials) return;
  __syncthreads();
  const int entries = m * TABLE_COLUMNS;
  for (int e = threadIdx.x; e < entries; e += THREADS) {
    const int row = e / TABLE_COLUMNS, c = e % TABLE_COLUMNS;
    const int first = c == 0 ? 1 : (c == 1 ? 0 : c + 1), last = c == 0 ? 3 : first + 1;
    double acc = 0.0;
    for (int t = 0; t < THREADS; ++t) {
      for (int s = first; s < last; ++s) {
        if (slot_row[t * SLOTS + s] == row) acc += slot_value[t * SLOTS + s];
      }
    }
    b.partials[(size_t)blockIdx.x * entries + e] = acc;
  }
}

constexpr int SUM_THREADS = 128;

// The second pass. Blocks [0, n_materials * 8) with a table: one a table
// entry, its blocks' partial sums added by a fixed tree in double, rounded to
// f32 once (0 in the columns no contribution reaches). The blocks after them
// in the first mode: a thread an element, its paths added in order.
__global__ void __launch_bounds__(SUM_THREADS)
    bounce_physics_bwd_sum_kernel(const __grid_constant__ McrayBounceBwdArgs b, int blocks) {
  __shared__ double sums[SUM_THREADS];
  const int entries = b.d_materials ? b.fwd.n_materials * COLUMNS : 0;
  if ((int)blockIdx.x < entries) {
    const int row = blockIdx.x / COLUMNS, col = blockIdx.x % COLUMNS;
    const int c = col == IMPEDANCE ? 0 : (col == ATTENUATION ? 1 : (col == SPECULARITY ? 2 : 3));
    if (col != IMPEDANCE && col != ATTENUATION && col != SPECULARITY && col != THICKNESS) {
      if (threadIdx.x == 0) b.d_materials[blockIdx.x] = 0.0f;
      return;
    }
    const int compact = b.fwd.n_materials * TABLE_COLUMNS, k = row * TABLE_COLUMNS + c;
    double acc = 0.0;
    for (int blk = threadIdx.x; blk < blocks; blk += SUM_THREADS)
      acc += b.partials[(size_t)blk * compact + k];
    sums[threadIdx.x] = acc;
    __syncthreads();
    for (int stride = SUM_THREADS / 2; stride > 0; stride /= 2) {
      if ((int)threadIdx.x < stride) sums[threadIdx.x] += sums[threadIdx.x + stride];
      __syncthreads();
    }
    if (threadIdx.x == 0) b.d_materials[blockIdx.x] = (float)sums[0];
    return;
  }
  const int e = (blockIdx.x - entries) * SUM_THREADS + threadIdx.x;
  if (!b.path_grads || e >= b.n_elements) return;
  const int ls = b.fwd.local_samples;
  const size_t n = (size_t)b.fwd.n, first = (size_t)e * ls;
  V3 g_pos = load3(b.path_grads, first), g_dir = load3(b.path_grads, n + first);
  for (int j = 1; j < ls; ++j) {
    g_pos = add3(g_pos, load3(b.path_grads, first + j));
    g_dir = add3(g_dir, load3(b.path_grads, n + first + j));
  }
  out3(b.d_positions, e, g_pos);
  out3(b.d_directions, e, g_dir);
}

int blocks_of(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// Shared bytes a launch takes: the material table and three per-mesh tables.
extern "C" int mcray_bounce_shared_bytes(int n_materials, int n_mesh) {
  return (n_materials * COLUMNS + 3 * n_mesh) * 4;
}

// One launch: row 0 of the record (a->first) or bounce a->depth's physics and
// row a->depth + 1.
extern "C" int mcray_bounce(const McrayBounceArgs* a, cudaStream_t stream) {
  if (a->n < 1 || a->n > INT32_MAX - THREADS || a->n_materials < 1 || a->n_mesh < 0 ||
      a->depth < 0 || (a->first && a->local_samples < 1))
    return (int)cudaErrorInvalidValue;
  const int shared = mcray_bounce_shared_bytes(a->n_materials, a->first ? 0 : a->n_mesh);
  if (shared > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (a->first)
    bounce_physics_kernel<true><<<blocks_of(a->n), THREADS, shared, stream>>>(*a);
  else
    bounce_physics_kernel<false><<<blocks_of(a->n), THREADS, shared, stream>>>(*a);
  return (int)cudaGetLastError();
}

// One backward launch: the adjoint of row 0 (b->fwd.first) or of bounce
// b->fwd.depth and row depth + 1, then (for the table, or the elements in the
// first mode) the second pass.
extern "C" int mcray_bounce_bwd(const McrayBounceBwdArgs* b, cudaStream_t stream) {
  const McrayBounceArgs* a = &b->fwd;
  if (a->n < 1 || a->n > INT32_MAX - THREADS || a->n_materials < 1 || a->n_mesh < 0 ||
      a->depth < 0 || (a->first && a->local_samples < 1) || (!b->partials != !b->d_materials) ||
      (b->path_grads && (!a->first || (long long)b->n_elements * a->local_samples != a->n)))
    return (int)cudaErrorInvalidValue;
  const int shared = mcray_bounce_shared_bytes(a->n_materials, a->first ? 0 : a->n_mesh);
  const int slots = THREADS * SLOTS * (int)(sizeof(int) + sizeof(float));
  if (shared + slots > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = blocks_of(a->n);
  if (a->first)
    bounce_physics_bwd_kernel<true><<<blocks, THREADS, shared, stream>>>(*b);
  else
    bounce_physics_bwd_kernel<false><<<blocks, THREADS, shared, stream>>>(*b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || (!b->d_materials && !b->path_grads)) return (int)err;
  const int grid = (b->d_materials ? a->n_materials * COLUMNS : 0) +
                   (b->path_grads ? (b->n_elements + SUM_THREADS - 1) / SUM_THREADS : 0);
  bounce_physics_bwd_sum_kernel<<<grid, SUM_THREADS, 0, stream>>>(*b, blocks);
  return (int)cudaGetLastError();
}
