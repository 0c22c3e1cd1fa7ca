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
// Backward: none in this file. Each launch is an autograd Function of the
// wrapper whose backward is autograd over the plain version, rerun on the
// record's row the launch started from, so a trace under autograd (the fits)
// takes this forward too.
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

// Row `row` of the record: the state, then the bounce's closest-hit query
// (rays_plain): attenuation, reach, origin, far end and segment.
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

  const float att = mat[clamp_id(s.media, a.n_materials) * COLUMNS + ATTENUATION];
  // max_ray_length: 10 log(eps / I) / -att * frequency, I clamped
  const float r_length =
      10.0f * logf(a.eps / clamp_min(s.intensity, a.eps_floor)) / -att * a.frequency;
  const float reach = r_length / 100.0f;
  const V3 sp = {a.spacing[0], a.spacing[1], a.spacing[2]};
  V3 origin = {s.src.x + a.ray_start_offset * s.dir.x, s.src.y + a.ray_start_offset * s.dir.y,
               s.src.z + a.ray_start_offset * s.dir.z};
  const V3 dest = {s.src.x + reach * sp.x * s.dir.x, s.src.y + reach * sp.y * s.dir.y,
                   s.src.z + reach * sp.z * s.dir.z};
  const float live = s.alive ? 1.0f : 0.0f;
  const V3 seg = {(dest.x - origin.x) * live, (dest.y - origin.y) * live,
                  (dest.z - origin.z) * live};
  if (!s.alive) origin = {PARKED, PARKED, PARKED};
  a.attenuation[r] = att;
  store3(a.to, r, dest);
  store3(a.query, (size_t)row * 2 * n + i, origin);
  store3(a.query, ((size_t)row * 2 + 1) * n + i, seg);
}

// physics.random_unit_vector_from_uniforms: the vector at polar angle
// arccos(cos_theta) around v
__device__ __forceinline__ V3 random_unit_vector(float u_a, float u_r, V3 v, float cos_theta) {
  const float ang = u_a * TWO_PI;
  const float r = 0.5f * sqrtf(u_r);
  float px = r * cosf(ang);
  float py = r * sinf(ang);
  const float p = clamp_min(px * px + py * py, 1e-12f);
  const bool flag = fabsf(v.x) > fabsf(v.y);
  const float vx = flag ? v.y : v.x, vy = flag ? v.x : v.y, vz = v.z;
  const float b = clamp_min(1.0f - vx * vx, 1e-12f);
  const float c = sqrtf(clamp_min((1.0f - cos_theta * cos_theta) / (p * b), 1e-20f));
  px = px * c;
  py = py * c;
  const float d = cos_theta - vx * px;
  const float wx = vx * cos_theta - b * px;
  const float wy = vy * d + vz * py;
  const float wz = vz * d - vy * py;
  return {flag ? wy : wx, flag ? wx : wy, wz};
}

template <bool kFirst>
__global__ void __launch_bounds__(THREADS) bounce_physics_kernel(const McrayBounceArgs a) {
  extern __shared__ float shared[];
  float* mat = shared;
  int* mesh_in = reinterpret_cast<int*>(shared + a.n_materials * COLUMNS);
  int* mesh_out = mesh_in + a.n_mesh;
  int* mesh_vasc = mesh_out + a.n_mesh;
  for (int k = threadIdx.x; k < a.n_materials * COLUMNS; k += THREADS) mat[k] = a.materials[k];
  if (!kFirst) {
    for (int k = threadIdx.x; k < a.n_mesh; k += THREADS) {
      mesh_in[k] = a.mesh_inside[k];
      mesh_out[k] = a.mesh_outside[k];
      mesh_vasc[k] = a.mesh_vascular[k];
    }
  }
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

  const size_t n = (size_t)a.n, r = (size_t)a.depth * n + i;
  State s = {load3(a.from, r), load3(a.direction, r), a.initial[r], a.distance[r],
             a.media_id[r], a.outside[r], a.valid[r] != 0};
  const bool hit = s.alive && a.hit[i] != 0;
  float back = 0.0f;
  if (hit) {
    const float eps = a.eps;
    const float att = a.attenuation[r];
    const V3 point = load3(a.point, i), normal = load3(a.normal, i);
    const int mesh = clamp_id(a.mesh_id[i], a.n_mesh);
    const int m_in = mesh_in[mesh], m_out = mesh_out[mesh];
    const bool vascular = mesh_vasc[mesh] != 0;

    // sub-surface fuzz: q = |N(0, thickness inside)|
    const float thick = mat[clamp_id(m_in, a.n_materials) * COLUMNS + THICKNESS];
    const float q = fabsf(a.q_normal[r] * thick);
    const V3 inside = {point.x + q * s.dir.x, point.y + q * s.dir.y, point.z + q * s.dir.z};
    // distance_in_mm, then the travel attenuation
    const V3 span = {fabsf(s.src.x - inside.x) * a.spacing[0],
                     fabsf(s.src.y - inside.y) * a.spacing[1],
                     fabsf(s.src.z - inside.z) * a.spacing[2]};
    const float dist_mm = safe_norm(span) * 10.0f;
    const float intensity = s.intensity * expf(-att * dist_mm * 0.01f * a.frequency);

    // hit_boundary: the material transition (physics.material_transition)
    const bool in_vessel = s.outside >= 0;
    const int o2 = s.outside == m_in ? m_out : m_in;
    const int m4 = a.bug_compat_material_transition ? m_in : (s.media == m_in ? m_out : m_in);
    const int mat_after = in_vessel ? (vascular ? s.outside : s.media) : (vascular ? m_in : m4);
    const int out_after = in_vessel ? (vascular ? -1 : o2) : (vascular ? s.media : -1);
    const float* row_media = mat + clamp_id(s.media, a.n_materials) * COLUMNS;
    const float* row_after = mat + clamp_id(mat_after, a.n_materials) * COLUMNS;
    // the power-cosine normal
    const float exponent = 1.0f / (floorf(row_after[SHININESS]) + 1.0f);
    const float random_angle = powf(a.angle_u[r], exponent);
    const V3 rn = random_unit_vector(a.axis_u[r], a.radius_u[r], normal, random_angle);
    // Snell and Fresnel
    const float incidence = fabsf(dot3(s.dir, rn));
    const float z1 = row_media[IMPEDANCE], z2 = row_after[IMPEDANCE];
    const float ratio = z1 / z2;
    const float refr_sq = 1.0f - ratio * ratio * (1.0f - incidence * incidence);
    const bool tir = refr_sq < 0.0f;
    const float refr_angle = refr_sq > 0.0f ? sqrtf(refr_sq) : 0.0f;
    const float k = ratio * incidence - refr_angle;
    const V3 refr_dir = normalize({ratio * s.dir.x + k * rn.x, ratio * s.dir.y + k * rn.y,
                                   ratio * s.dir.z + k * rn.z});
    const float twice = 2.0f * incidence;
    const V3 refl_dir = normalize({s.dir.x + twice * rn.x, s.dir.y + twice * rn.y,
                                   s.dir.z + twice * rn.z});
    float i_refl = intensity;
    if (!tir) {
      const float num = z1 * incidence - z2 * refr_angle;
      const float den = z1 * incidence + z2 * refr_angle;
      const float ratio_r = num / den;
      i_refl = intensity * (ratio_r * ratio_r);
    }
    const float i_refr = intensity - i_refl;
    // the Mattausch backscatter; under TIR the refraction term is 0
    const float spec = row_after[SPECULARITY];
    const float refr_term = tir ? 0.0f : safe_pow(dot3(s.dir, refr_dir), spec);
    back = (refr_term + safe_pow(dot3(s.dir, refl_dir), spec)) * random_angle;
    // the roulette: go on with one of reflection and refraction
    const bool reflect = i_refl / clamp_min(intensity, eps) > a.roulette_u[r];
    const float refl_int = i_refl > eps ? i_refl : 0.0f;
    const float refr_int = i_refr > eps ? i_refr : 0.0f;
    const float new_intensity = reflect ? refl_int : refr_int;

    store3(a.to, r, inside);
    bool alive = new_intensity > eps;
    const float distance = s.distance + dist_mm;
    if (a.cull_time_window) alive = alive && distance * 1000.0f / a.speed_of_sound < a.max_travel_time_us;
    s.src = point;
    s.dir = reflect ? refl_dir : refr_dir;
    s.media = reflect ? s.media : mat_after;
    s.outside = reflect ? s.outside : out_after;
    s.intensity = new_intensity;
    s.distance = distance;
    s.alive = alive;
  } else {
    s.alive = false;
  }
  a.reflected[r] = back;
  write_row(a, mat, a.depth + 1, i, s);
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
