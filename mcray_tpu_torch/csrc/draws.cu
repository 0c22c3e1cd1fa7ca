// The keyed draws: the threefry key chain of every path-bounce and its five
// draw fields in one kernel, and fold_in over a batch of keys.
//
// Replaces no TPU kernel: the reference draws with jax.random (threefry2x32
// in XLA's fused integer ops; mcray_tpu/ops/physics.py:160-190 for the
// chain). The port's plain version (utils/rng.py, ops/physics.py:
// draw_bounce_randoms) runs each cipher pass as ~146 elementwise int64 ops,
// each a launch that reads and writes tensors of up to a million keys; here
// every key lives in two uint32 registers and each rotation is one funnel
// shift.
//
// keyed_draws_kernel: one thread per (depth d, column b * P + p), thread
// index d * (B * P) + column, so neighbouring threads write neighbouring
// floats of each (D, B * P) field. A thread runs the whole chain of
// path_draws and draw_bounce_randoms, 14 cipher calls on counters (0, x):
//   fold_in(trace_key[b], path_ids[p]), fold_in(., d),
//   split(., 2) -> [normal key, rest], split(rest, 3) -> [power-cosine key,
//   unit-vector key, roulette key], split(unit-vector key, 2) -> the two disc
//   keys, and the five fields' bits out0 ^ out1 of each key at counter (0, 0);
// then the bits as a float in [0, 1) (rng.uniform), the power-cosine uniform
// clamped at 1e-12, and the normal sqrt(2) erfinv(max(lo, u * 2 + lo)) with
// every product and sum rounded on its own, as plain PyTorch rounds them, so
// the five fields are the plain path's bit for bit (erfinvf is the function
// ATen's CUDA erfinv calls).
//
// Bound: operations (utils/roofline.py:draws_cost). A step of the chained
// batch at SimConfig (8 frames x 2,560 paths x 10 bounces, 204,800 threads
// in 1,600 blocks of 128) is ~2.7 M cipher calls of 117 operations, ~324 M
// operations against 4.1 MB written: 4.8 us at 67 T f32 operations/s, but
// the work is integer adds, xors and shifts, whose rate is 64 lanes an SM a
// clock (~16.7 T/s at 1.98 GHz), so ~13 us. Each path's fold_in is repeated
// at every depth (one call in 14) to keep the threads independent: a thread
// per column would leave the card 160 blocks.
//
// keyed_draws_fold_in_kernel: keys (K or 1, 2) against data (K or 1) or one
// value, one thread a key: the chained step's frame keys and the frames'
// trace keys, one launch where rng.fold_in makes ~147.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr uint32_t PARITY = 0x1BD11BDAu;
constexpr float MINUS_ONE_OPEN = -0.99999994f;      // the f32 next above -1
constexpr uint32_t SQRT2_BITS = 0x3FB504F3u;         // sqrt(2) rounded to f32
constexpr uint32_t ONE_BITS = 0x3F800000u;           // 1.0f

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1, int a, int b, int c,
                                            int d) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, a) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, b) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, c) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, d) ^ x0;
}

// threefry2x32 (20 rounds) of the counter (0, x) under key k: fold_in(k, x)
// and split(k, n)[x] are both this; its out0 ^ out1 at x = 0 are the 32 bits
// of random_bits(k, ()).
__device__ __forceinline__ Key threefry(Key k, uint32_t x) {
  const uint32_t k2 = k.k0 ^ k.k1 ^ PARITY;
  uint32_t x0 = k.k0, x1 = x + k.k1;
  four_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k.k1; x1 += k2 + 1u;
  four_rounds(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k.k0 + 2u;
  four_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k.k0; x1 += k.k1 + 3u;
  four_rounds(x0, x1, 17, 29, 16, 24);
  x0 += k.k1; x1 += k2 + 4u;
  four_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k.k0 + 5u;
  return {x0, x1};
}

// rng.uniform of a key: 23 random bits under the exponent of 1.0, minus 1
__device__ __forceinline__ float uniform(Key k) {
  const Key o = threefry(k, 0u);
  return __fsub_rn(__uint_as_float(((o.k0 ^ o.k1) >> 9) | ONE_BITS), 1.0f);
}

__device__ __forceinline__ Key load_key(const int64_t* __restrict__ keys, int i) {
  return {(uint32_t)keys[2 * i], (uint32_t)keys[2 * i + 1]};
}

// out: (5, n_depth, n_cols) fields [q_normal, angle_u, axis_u, radius_u,
// roulette_u], n_cols = n_frames * n_paths, frame-major
__global__ void __launch_bounds__(THREADS)
keyed_draws_kernel(const int64_t* __restrict__ trace_key, const int64_t* __restrict__ path_ids,
                   int n_paths, int n_cols, int n_total, float* __restrict__ out) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_total) return;
  const int d = t / n_cols;
  const int col = t - d * n_cols;
  const int b = col / n_paths;
  const Key path = threefry(load_key(trace_key, b), (uint32_t)path_ids[col - b * n_paths]);
  const Key bounce = threefry(path, (uint32_t)d);
  const Key rest = threefry(bounce, 1u);
  const Key disc = threefry(rest, 1u);
  const float u_normal = uniform(threefry(bounce, 0u));
  const float u_angle = uniform(threefry(rest, 0u));
  const float u_axis = uniform(threefry(disc, 0u));
  const float u_radius = uniform(threefry(disc, 1u));
  const float u_roulette = uniform(threefry(rest, 2u));
  // normal_from_uniform: the scale 1 - lo rounds to exactly 2 in f32
  const float s = fmaxf(MINUS_ONE_OPEN, __fadd_rn(__fmul_rn(u_normal, 2.0f), MINUS_ONE_OPEN));
  out[t] = __fmul_rn(__uint_as_float(SQRT2_BITS), erfinvf(s));
  out += n_total;
  out[t] = fmaxf(u_angle, 1e-12f);
  out += n_total;
  out[t] = u_axis;
  out += n_total;
  out[t] = u_radius;
  out += n_total;
  out[t] = u_roulette;
}

// out[i] = fold_in(keys[i * key_step], data ? data[i * data_step] : value)
__global__ void __launch_bounds__(THREADS)
keyed_draws_fold_in_kernel(const int64_t* __restrict__ keys, int key_step,
                           const int64_t* __restrict__ data, int data_step, uint32_t value, int n,
                           int64_t* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const Key k = threefry(load_key(keys, i * key_step),
                         data != nullptr ? (uint32_t)data[i * data_step] : value);
  out[2 * i] = (int64_t)k.k0;
  out[2 * i + 1] = (int64_t)k.k1;
}

int blocks_of(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// The five (n_depth, n_frames * n_paths) draw fields of trace_key (n_frames,
// 2) and path_ids (n_paths,), int64 holding uint32 words, into out (5,
// n_depth, n_frames * n_paths) f32.
extern "C" int mcray_keyed_draws(const int64_t* trace_key, int n_frames, const int64_t* path_ids,
                                 int n_paths, int n_depth, float* out, cudaStream_t stream) {
  const long long n_cols = (long long)n_frames * n_paths, n_total = n_cols * n_depth;
  if (n_frames < 1 || n_paths < 1 || n_depth < 1 || n_total > INT32_MAX - THREADS)
    return (int)cudaErrorInvalidValue;
  keyed_draws_kernel<<<blocks_of((int)n_total), THREADS, 0, stream>>>(
      trace_key, path_ids, n_paths, (int)n_cols, (int)n_total, out);
  return (int)cudaGetLastError();
}

// fold_in of n keys: keys (n or 1, 2) (key_step 1 or 0), against data (n or
// 1) (data_step 1 or 0), or value where data is null; out (n, 2) int64.
extern "C" int mcray_fold_in(const int64_t* keys, int key_step, const int64_t* data,
                             int data_step, unsigned int value, int n, int64_t* out,
                             cudaStream_t stream) {
  if (n < 1 || n > INT32_MAX - THREADS || (key_step != 0 && key_step != 1) ||
      (data_step != 0 && data_step != 1))
    return (int)cudaErrorInvalidValue;
  keyed_draws_fold_in_kernel<<<blocks_of(n), THREADS, 0, stream>>>(keys, key_step, data,
                                                                   data_step, value, n, out);
  return (int)cudaGetLastError();
}
