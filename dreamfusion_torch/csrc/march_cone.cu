// Cone-stepping occupancy-grid march (dt_gamma > 0): kernel F.
//
// It has no Pallas counterpart. The JAX package writes this march as a
// lax.scan of max_steps steps, each holding a batched lax.while_loop for
// the empty-space skip (dreamfusion_tpu/ops/marching.py::march_rays,
// :248-307, with _mip_level at :210-218); the reference runs the same DDA
// as one CUDA thread per ray (raymarching.cu:312-490). Written as eager
// PyTorch, each outer step's inner loop ends on a device-wide any(), a
// host sync per sub-step. Here each thread marches one ray to its end.
//
// Contract (one thread per ray n, N rays; K sample slots):
//   rays_o, rays_d [N, 3] f32; t0 [N] f32 (near, already perturbed);
//   fars [N] f32; occ [C, H, H, H] u8 (0 / 1);
//   ts, dts [N, K] f32 and valid [N, K] u8: the ray's first K emitted
//   samples in order, zeros after them; counts [N] int64: every emit.
// For s in 0 .. max_steps-1, while t < far:
//   x  = clamp(o + t d, -bound, bound); dt = clamp(t g, dt_min, dt_max)
//   level (C > 1): max of the position's and dt's mip levels, each
//     floor(log2(max(m, 1e-30))) + 1 clamped to [0, C-1] (not frexpf,
//     which differs just below powers of two); mip = min(2^level, bound)
//   cell n = int(clamp(0.5 (x / mip + 1) H, 0, H-1)) per axis
//   occupied: emit (t, dt) and t += dt; else advance, re-clamping dt at
//     every sub-step (a do/while), up to the next voxel face along the ray.
// Once t >= far a ray can emit nothing more and t no longer moves, so the
// thread stops there.
//
// Every f32 operation is the plain version's (marching.py::
// march_rays_cone_plain), in its order, with __fmul_rn / __fadd_rn /
// __fdiv_rn wherever nvcc could contract or approximate, so the kernel and
// the plain version on the card give the same bits. g, dt_min, dt_max and
// 2 / H arrive rounded to f32 by the caller (marching.cone_constants).
//
// What bounds it on Hopper: latency. A ray's steps are serially dependent
// (each probe's cell follows from the previous step's t), up to max_steps
// dependent gathers from the occupancy grid, which at 128^3 (2 MB) stays in
// L2; the bytes moved (rays in, [N, K] samples out) take a few
// microseconds. One warp a block spreads a 4,096-ray train march over 128
// of the 132 SMs. Divergence is inherent: rays take different numbers of
// steps and sub-steps.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// floor(log2(max(m, 1e-30))) + 1, clamped to [0, C-1]
__device__ __forceinline__ int mip_of(float m, int C) {
  const int e = static_cast<int>(floorf(log2f(fmaxf(m, 1e-30f))) + 1.0f);
  return min(max(e, 0), C - 1);
}

__global__ void __launch_bounds__(kThreads)
march_cone_kernel(const float* __restrict__ rays_o,
                  const float* __restrict__ rays_d,
                  const float* __restrict__ t0s,
                  const float* __restrict__ fars,
                  const uint8_t* __restrict__ occ, float* __restrict__ ts,
                  float* __restrict__ dts, uint8_t* __restrict__ valid,
                  long long* __restrict__ counts, int N, int K,
                  int max_steps, int C, int H, float bound, float g,
                  float dt_min, float dt_max, float cell) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float o[3], d[3], inv[3], sg[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = rays_o[3 * n + a];
    d[a] = rays_d[3 * n + a];
    const float rd = fabsf(d[a]) < 1e-15f ? (d[a] >= 0.0f ? 1e-15f : -1e-15f)
                                          : d[a];
    inv[a] = __fdiv_rn(1.0f, rd);
    sg[a] = d[a] > 0.0f ? 1.0f : (d[a] < 0.0f ? -1.0f : 0.0f);
  }
  const float far = fars[n];
  const float Hf = static_cast<float>(H);
  const long long cells = static_cast<long long>(H) * H * H;
  float* ts_n = ts + static_cast<long long>(n) * K;
  float* dts_n = dts + static_cast<long long>(n) * K;
  uint8_t* valid_n = valid + static_cast<long long>(n) * K;
  float t = t0s[n];
  long long count = 0;
  for (int s = 0; s < max_steps && t < far; ++s) {
    float x[3];
    for (int a = 0; a < 3; ++a) {
      x[a] = clampf(__fadd_rn(o[a], __fmul_rn(t, d[a])), -bound, bound);
    }
    const float dt = clampf(__fmul_rn(t, g), dt_min, dt_max);
    int level = 0;
    if (C > 1) {
      const float m = fmaxf(fabsf(x[0]), fmaxf(fabsf(x[1]), fabsf(x[2])));
      level = max(mip_of(m, C), mip_of(__fmul_rn(__fmul_rn(dt, Hf), 0.5f), C));
    }
    const float mip = fminf(static_cast<float>(1 << level), bound);
    int cell_i[3];
    for (int a = 0; a < 3; ++a) {
      const float u = __fmul_rn(
          __fmul_rn(0.5f, __fadd_rn(__fdiv_rn(x[a], mip), 1.0f)), Hf);
      cell_i[a] = static_cast<int>(clampf(u, 0.0f, Hf - 1.0f));
    }
    const long long flat = static_cast<long long>(
        (cell_i[0] * H + cell_i[1]) * H + cell_i[2]) + level * cells;
    float target = t;
    if (occ[flat]) {
      if (count < K) {
        ts_n[count] = t;
        dts_n[count] = dt;
        valid_n[count] = 1;
      }
      ++count;
    } else {
      // the next voxel face along the ray
      float tmin = INFINITY;
      for (int a = 0; a < 3; ++a) {
        const float nb = __fadd_rn(
            __fmul_rn(__fadd_rn(__fadd_rn(static_cast<float>(cell_i[a]), 0.5f),
                                __fmul_rn(0.5f, sg[a])),
                      cell),
            -1.0f);
        tmin = fminf(tmin, __fmul_rn(__fadd_rn(__fmul_rn(nb, mip), -x[a]),
                                     inv[a]));
      }
      target = __fadd_rn(t, fmaxf(0.0f, tmin));
    }
    do {
      t = __fadd_rn(t, clampf(__fmul_rn(t, g), dt_min, dt_max));
    } while (t < target);
  }
  for (long long k = count; k < K; ++k) {
    ts_n[k] = 0.0f;
    dts_n[k] = 0.0f;
    valid_n[k] = 0;
  }
  counts[n] = count;
}

}  // namespace

extern "C" int march_cone(const void* rays_o, const void* rays_d,
                          const void* t0, const void* fars, const void* occ,
                          void* ts, void* dts, void* valid, void* counts,
                          int N, int K, int max_steps, int C, int H,
                          float bound, float g, float dt_min, float dt_max,
                          float cell, void* stream) {
  if (N < 0 || K <= 0 || max_steps < 0 || C <= 0 || C > 30 || H <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((N + kThreads - 1) / kThreads);
  march_cone_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
      static_cast<const float*>(t0), static_cast<const float*>(fars),
      static_cast<const uint8_t*>(occ), static_cast<float*>(ts),
      static_cast<float*>(dts), static_cast<uint8_t*>(valid),
      static_cast<long long*>(counts), N, K, max_steps, C, H, bound, g,
      dt_min, dt_max, cell);
  return static_cast<int>(cudaGetLastError());
}
